"""The port's DiT against the flax DiT and the JAX fused forward, with the
flax weights moved over by the weight bridge (export_torch_state_dict ->
load_reference_state_dict). Tolerance 1e-4: f32 on both sides, sums in
other orders, eight stacked blocks."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.nn.nnets import DiT as JaxDiT
from scldm_tpu.nn.nnets import build_cfg_segments as jax_segments
from scldm_tpu.ops.fused_dit import fused_dit_forward as jax_fused_forward
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.nn.nnets import DiT, build_cfg_segments
from scldm_torch.ops.fused_dit import fused_dit_forward
from scldm_torch.utils.weights import load_reference_state_dict

E, E_IN, N_LAYER, N_HEAD, SEQ, B = 64, 8, 2, 4, 16, 6
VOCAB = {"clusters": 5, "tissue": 3}
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def randomized_dit_params(jdit, x, t, cond, seed=0):
    """Flax init with the zero-init layers (adaLN, final linear) redrawn, so
    the comparison is not trivial."""
    params = jdit.init({"params": jax.random.PRNGKey(seed), "condition": jax.random.PRNGKey(seed)},
                       x, t, cond, train=True)
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(params["params"])
    flat = {
        k: (jnp.asarray(rng.normal(size=v.shape) * 0.1, jnp.float32)
            if ("adaln" in "/".join(k) or k[-2:] == ("linear", "kernel")
                or k[-2:] == ("linear", "bias")) else v)
        for k, v in flat.items()
    }
    return {"params": flax.traverse_util.unflatten_dict(flat)}


def make_pair(strategy="mutually_exclusive", vocab=VOCAB, seed=0):
    jdit = JaxDiT(n_embed=E, n_embed_input=E_IN, n_layer=N_LAYER, n_head=N_HEAD, seq_len=SEQ,
                  class_vocab_sizes=vocab, cfg_dropout_prob=0.8, condition_strategy=strategy)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, SEQ, E_IN)).astype(np.float32)
    t = rng.uniform(size=(B,)).astype(np.float32)
    cond = {n: rng.integers(0, v, B).astype(np.int32) for n, v in vocab.items()}
    params = randomized_dit_params(jdit, jnp.asarray(x), jnp.asarray(t),
                                   {k: jnp.asarray(v) for k, v in cond.items()}, seed)
    tdit = DiT(E, E_IN, N_LAYER, N_HEAD, SEQ, class_vocab_sizes=vocab, cfg_dropout_prob=0.8,
               condition_strategy=strategy).eval()
    load_reference_state_dict(tdit, export_torch_state_dict(params), strict=True)
    return jdit, params, tdit, (x, t, cond)


def _t(d):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in d.items()}


@pytest.mark.parametrize("strategy", ["mutually_exclusive", "joint"])
def test_forward_with_cfg_batched_matches_flax(strategy):
    jdit, params, tdit, (x, t, cond) = make_pair(strategy)
    scales = {"clusters": 1.5, "tissue": 0.7}
    want = jdit.apply(params, jnp.asarray(x), jnp.asarray(t),
                      {k: jnp.asarray(v) for k, v in cond.items()}, scales,
                      method="forward_with_cfg_batched")
    with torch.no_grad():
        got = tdit.forward_with_cfg_batched(torch.from_numpy(x), torch.from_numpy(t), _t(cond), scales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unguided_forward_matches_flax():
    """No guidance: every class rides as its null token."""
    jdit, params, tdit, (x, t, cond) = make_pair()
    want = jdit.apply(params, jnp.asarray(x), jnp.asarray(t),
                      {k: jnp.asarray(v) for k, v in cond.items()}, None,
                      method="forward_with_cfg_batched")
    with torch.no_grad():
        got = tdit.forward_with_cfg_batched(torch.from_numpy(x), torch.from_numpy(t), _t(cond), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_forward_matches_jax_fused_forward():
    """The sampler's row layout (R = 3B/2 + ... rows) through every block."""
    vocab = {"clusters": 5}
    jdit, params, tdit, (x, t, cond) = make_pair(vocab=vocab)
    scales = {"clusters": 1.0}
    jx, jt = jnp.asarray(x), jnp.asarray(t)
    seg_x, seg_t, seg_cond, _, _, _ = jax_segments(
        jx, jt, {k: jnp.asarray(v) for k, v in cond.items()}, scales, vocab, "mutually_exclusive")
    want = jax_fused_forward(params, seg_x, seg_t, seg_cond, n_layer=N_LAYER, n_head=N_HEAD,
                             n_embed=E, seq_len=SEQ, eps=1e-8, interpret=True)

    tx, tt, tc = torch.from_numpy(x), torch.from_numpy(t), _t(cond)
    sx, st, sc, _, _, _ = build_cfg_segments(tx, tt, tc, scales, vocab, "mutually_exclusive")
    assert sx.shape[0] == B + B // 2
    for n in vocab:
        np.testing.assert_array_equal(sc[n].numpy(), np.asarray(seg_cond[n]))
    with torch.no_grad():
        got = fused_dit_forward(tdit, sx, st, sc)
        module = tdit(sx, st, sc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(module.numpy(), np.asarray(want), **TOL)


def test_bridge_is_strict():
    jdit, params, tdit, _ = make_pair()
    sd = export_torch_state_dict(params)
    sd.pop("blocks.0.adaln_modulation.1.weight")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_state_dict(tdit, sd, strict=True)
    # Lightning prefixes are stripped
    full = {f"diffusion_model.{k}": v for k, v in export_torch_state_dict(params).items()}
    load_reference_state_dict(tdit, full, strict=True)


def test_guidance_needs_null_rows():
    tdit = DiT(E, E_IN, 1, N_HEAD, SEQ, class_vocab_sizes={"clusters": 5}, cfg_dropout_prob=0.0)
    x = torch.zeros(2, SEQ, E_IN)
    with pytest.raises(ValueError, match="cfg_dropout_prob"):
        tdit.forward_with_cfg_batched(x, torch.zeros(2), {"clusters": torch.zeros(2).long()},
                                      {"clusters": 1.0})
