"""The port's flash cross-attention (scldm_torch.ops.fused_cross) and its
dispatch gate (scldm_torch.ops.attention) against the JAX package, on the
same numpy inputs.

`flash_cross_reference`, the plain version of the CUDA kernel, against JAX's
Pallas `flash_cross_attention` in interpret mode, at a ragged gene axis and
an odd batch: within 1e-3 of the output's largest magnitude (both round the
same operands and the probabilities to bf16; the Pallas kernel sums each
head's scores over the block-diagonal operand, so a different order flips a
bf16 rounding of p now and then). The backward, plain f32 attention replayed
through autograd on both sides, within 1e-4 of each gradient's largest
magnitude. The CUDA kernel itself is compared with the plain version on the
card in test_torch_port_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.ops import attention as jattn
from scldm_tpu.ops import fused_cross as jfc
from scldm_torch.ops import attention
from scldm_torch.ops import fused_cross as fc

H, E, M = 2, 128, 64  # two heads of 64 columns over 64 keys, the kernel's head and key widths


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _inputs(G, B, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32) for s in ((G, E), (B, M, E), (B, M, E)))


def _near(got, want, share, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0, what
    assert np.abs(got - want).max() <= share * scale, (what, np.abs(got - want).max(), scale)


# ragged against the 128-gene tile given to JAX, an odd batch against its tile of 2
@pytest.mark.parametrize("G,B", [(300, 3), (77, 1)])
def test_reference_matches_pallas_interpret(G, B):
    qp, k, v = _inputs(G, B)
    want = jfc.flash_cross_attention(*map(jnp.asarray, (qp, k, v)), H, 128, 2, True)
    before = fc.FLASH_CROSS_LAUNCHES.count
    got = fc.flash_cross_attention(*map(torch.from_numpy, (qp, k, v)), H)
    assert fc.FLASH_CROSS_LAUNCHES.count == before  # CPU: the plain version
    assert got.shape == (B, G, E) and got.dtype == torch.float32
    _near(got.detach().numpy(), want, 1e-3, "y")
    _near(fc.flash_cross_reference(*map(torch.from_numpy, (qp, k, v)), H).numpy(), want, 1e-3,
          "flash_cross_reference")


def test_plain_attention_matches_jax():
    qp, k, v = _inputs(300, 3, seed=1)
    want = jfc._attn_reference(*map(jnp.asarray, (qp, k, v)), H)
    got = fc._attn_reference(*map(torch.from_numpy, (qp, k, v)), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_backward_matches_jax_custom_vjp():
    """JAX's custom VJP replays plain attention; so does the port's
    autograd Function: each gradient within 1e-4 of its largest magnitude."""
    qp, k, v = _inputs(300, 3, seed=2)
    dy = np.random.default_rng(3).normal(size=(3, 300, E)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jfc.flash_cross_attention(a, b, c, H, 128, 2, True),
                     *map(jnp.asarray, (qp, k, v)))
    want = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (qp, k, v)]
    fc.flash_cross_attention(*leaves, H).backward(torch.from_numpy(dy))
    for name, leaf, w in zip(("dqp", "dk", "dv"), leaves, want):
        _near(leaf.grad.numpy(), w, 1e-4, name)


def test_gate_constants_are_jax_s():
    assert (attention._FLASH_CROSS_MIN_Q, attention._FLASH_CROSS_MAX_KV,
            attention._FLASH_CROSS_MIN_E) == (jattn._FLASH_CROSS_MIN_Q, jattn._FLASH_CROSS_MAX_KV,
                                              jattn._FLASH_CROSS_MIN_E)
    assert attention._FLASH_CROSS_ENABLED == jattn._FLASH_CROSS_ENABLED


# q (M, H, hd) and k (B, S, H, hd) at the census decoder's cross block, then
# with each gate missed in turn
@pytest.mark.parametrize("q_shape,k_shape,ok", [
    ((36_601, 8, 64), (32, 64, 8, 64), True),
    ((4_096, 4, 64), (2, 128, 4, 64), True),
    ((4_095, 8, 64), (32, 64, 8, 64), False),
    ((36_601, 8, 64), (32, 129, 8, 64), False),
    ((36_601, 2, 64), (32, 64, 2, 64), False),
    ((36_601, 64, 4), (32, 64, 64, 4), False),
])
def test_gate_shapes(q_shape, k_shape, ok):
    q, k = torch.empty(q_shape, device="meta"), torch.empty(k_shape, device="meta")
    assert attention._flash_cross_shapes_ok(q, k) is ok


def test_gate_is_off_on_cpu_tensors(monkeypatch):
    """Even enabled, the gate passes only CUDA tensors (JAX: only on a TPU);
    on CPU tensors `sdpa_shared_q` is plain attention, and matches JAX's."""
    monkeypatch.setattr(attention, "_FLASH_CROSS_ENABLED", True)
    monkeypatch.setattr(attention, "_FLASH_CROSS_MIN_Q", 16)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(300, 4, 64)).astype(np.float32)
    k, v = (rng.normal(size=(3, 64, 4, 64)).astype(np.float32) for _ in range(2))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert attention._flash_cross_shapes_ok(tq, tk) and not attention._use_flash_cross(tq, tk)
    before = fc.FLASH_CROSS_LAUNCHES.count
    got = attention.sdpa_shared_q(tq, tk, tv)
    assert fc.FLASH_CROSS_LAUNCHES.count == before
    want = jattn.sdpa_shared_q(*map(jnp.asarray, (q, k, v)))
    assert not jattn._use_flash_cross(jnp.asarray(q), jnp.asarray(k))  # no TPU here
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case,match", [
    ("keys", "built for"),
    ("head width", "built for"),
    ("heads", "E % n_head"),
    ("v shape", "must be"),
    ("bf16", "float32"),
    ("strided", "contiguous"),
])
def test_operand_check_raises(case, match):
    """The kernel's operand check (device-free, so it runs here). On CUDA
    tensors the wrapper raises with it and never takes the plain version."""
    qp, k, v = (torch.zeros(10, E), torch.zeros(2, M, E), torch.zeros(2, M, E))
    n_head = H
    if case == "keys":
        k, v = torch.zeros(2, 32, E), torch.zeros(2, 32, E)
    elif case == "head width":
        n_head = 4
    elif case == "heads":
        n_head = 3
    elif case == "v shape":
        v = torch.zeros(2, M + 1, E)
    elif case == "bf16":
        qp = qp.bfloat16()
    else:
        qp = torch.zeros(E, 10).t()
    with pytest.raises(ValueError, match=match):
        fc._check(qp, k, v, n_head)


def test_other_devices_raise():
    qp, k, v = (torch.zeros(10, E, device="meta"), torch.zeros(2, M, E, device="meta"),
                torch.zeros(2, M, E, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fc.flash_cross_attention(qp, k, v, H)
