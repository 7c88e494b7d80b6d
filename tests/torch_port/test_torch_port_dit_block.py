"""The port's DiT block (scldm_torch.ops.fused_dit), forward and backward,
against the JAX Pallas kernels run in interpret mode, on the same numpy
inputs: at the dentate latent's T = 16 tokens (E = 64, 4 heads) and at the
census latent's T = 64 (E = 32, 4 heads).

The forward at rtol = atol = 1e-5; the backward's dx and dc at 1e-4, each
weight gradient within 1e-5 of its tensor's largest magnitude: both sides
compute in f32 and differ only in the order of their sums. At T = 64 every
output is held at 1e-4 (forward, dx and dc at rtol = atol = 1e-4, each weight
gradient within 1e-4 of its largest magnitude): sums over four times the
tokens. The CUDA kernels themselves are compared with the plain versions on
the card in test_torch_port_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.ops.fused_dit import fused_dit_block
from scldm_torch.ops import fused_dit as port

T, E, H = 16, 64, 4
HIDDEN = 172  # MLP(64) hidden: int(2 * 256 / 3) rounded up to a multiple of 4
EPS = 1e-8


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


# the census latent: T = 64 tokens, at a width the CPU takes in seconds;
# MLP(32) hidden: int(2 * 128 / 3) rounded up to a multiple of 4
T64 = dict(T=64, E=32, hidden=88)
H64 = 4


def _inputs(R, seed=0, T=T, E=E, hidden=HIDDEN):
    rng = np.random.default_rng(seed)
    shapes = {
        "wada": (E, 6 * E), "bada": (6 * E,), "wqkv": (E, 3 * E), "bqkv": (3 * E,),
        "wproj": (E, E), "bproj": (E,), "w1": (E, hidden), "w2": (E, hidden),
        "wmlp": (hidden, E),
    }
    # non-zero adaLN weights: adaLN-zero init would make the block the identity
    weights = {
        k: (rng.normal(size=s) / np.sqrt(s[0] if len(s) == 2 else 4)).astype(np.float32)
        for k, s in shapes.items()
    }
    x = rng.normal(size=(R, T, E)).astype(np.float32)
    c = rng.normal(size=(R, E)).astype(np.float32)
    return x, c, weights


def _jax(x, c, weights, n_head=H):
    kp = {k: jnp.asarray(v) for k, v in weights.items()}
    return np.asarray(fused_dit_block(jnp.asarray(x), jnp.asarray(c), kp, n_head=n_head, eps=EPS,
                                      interpret=True))


def _torch(fn, x, c, weights, n_head=H):
    w = {k: torch.from_numpy(v) for k, v in weights.items()}
    return fn(torch.from_numpy(x), torch.from_numpy(c), w, n_head, EPS).numpy()


@pytest.mark.parametrize("R", [12, 5])
@pytest.mark.parametrize("fn", ["dit_block_reference", "dit_block"])
def test_block_matches_pallas_interpret(R, fn):
    x, c, weights = _inputs(R)
    want = _jax(x, c, weights)
    before = port.DIT_BLOCK_LAUNCHES.count
    got = _torch(getattr(port, fn), x, c, weights)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert port.DIT_BLOCK_LAUNCHES.count == before


def test_block_is_not_identity():
    x, c, weights = _inputs(4)
    got = _torch(port.dit_block, x, c, weights)
    assert np.abs(got - x).max() > 1e-2


def test_block_params_from_module_match_pallas():
    """extract_block_params turns torch (out, in) Linear weights into the
    kernel's (in, out) matrices."""
    from scldm_torch.nn.layers import Block
    from scldm_torch.utils.weights import init_reference_

    block = Block(E, H, bias=True, use_adaln=True, elementwise_affine=False)
    init_reference_(block, torch.Generator().manual_seed(0), zero_init=False)
    kp = port.extract_block_params(block)
    x, c, _ = _inputs(3)
    want = _jax(x, c, {k: v.numpy() for k, v in kp.items()})
    with torch.no_grad():
        mod = block(torch.from_numpy(x), torch.from_numpy(c)[:, None, :]).numpy()
    np.testing.assert_allclose(mod, want, rtol=1e-5, atol=1e-5)


def _zero_weights(E, hidden):
    return {
        "wada": torch.zeros(E, 6 * E), "bada": torch.zeros(6 * E), "wqkv": torch.zeros(E, 3 * E),
        "bqkv": torch.zeros(3 * E), "wproj": torch.zeros(E, E), "bproj": torch.zeros(E),
        "w1": torch.zeros(E, hidden), "w2": torch.zeros(E, hidden), "wmlp": torch.zeros(hidden, E),
    }


def test_smem_need_and_limit():
    """The forward has one design at every T: its kernels' shared memory is
    a token tile's, not a row's, so the dentate T = 16, the census T = 64 and
    the long-latent T = 1,024 all fit one CTA with the same need; the design
    names of the backward are refused for the forward. The backward still
    raises at T = 1,024 with the byte count: one head's scores and their
    cotangents outgrow a CTA."""
    w = _zero_weights(256, 684)
    need = {T: port.dit_block_smem_bytes(T, 256, 8, 684) for T in (16, 64, 1024)}
    assert need[16] == need[64] == need[1024]
    assert set(need[16]) == {"gemm", "attention"}
    # three stages of 64 x 32 tokens (pitch 36) and 32 x 64 weights (pitch 72);
    # the attention's queries and two k / v stages, 64 rows of hd + 4 each
    assert need[16] == {"gemm": 4 * 3 * (64 * 36 + 32 * 72), "attention": 4 * 5 * 64 * 36}
    assert max(need[16].values()) <= port.MAX_SMEM_BYTES
    assert port.dit_block_smem_bytes(64, 64, 4, 172)["attention"] == 4 * 5 * 64 * 20  # hd 16
    for T in (16, 64, 1024):
        assert port.pick_design(T, 256, 8, 684) == "tiled"
        assert port._check_shapes(torch.zeros(2, T, 256), torch.zeros(2, 256), w, 8) == "tiled"
    for design in ("row", "split"):
        with pytest.raises(ValueError, match="forward's design is 'tiled'"):
            port._check_shapes(torch.zeros(2, 16, 256), torch.zeros(2, 256), w, 8, design=design)
    with pytest.raises(ValueError, match=r"dit_block_bwd needs \d+ bytes of shared memory .* "
                                         r"attention_bwd"):
        port._check_shapes(torch.zeros(2, 1024, 256), torch.zeros(2, 256), w, 8, backward=True)
    # the head width the attention takes: a multiple of 4 up to 64
    with pytest.raises(ValueError, match="head width"):
        port._check_shapes(torch.zeros(2, 16, 256), torch.zeros(2, 256), w, 2)


def test_other_devices_raise():
    x, c, weights = _inputs(2)
    w = {k: torch.from_numpy(v).to("meta") for k, v in weights.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.dit_block(torch.from_numpy(x).to("meta"), torch.from_numpy(c).to("meta"), w, H, EPS)


# -- the backward --------------------------------------------------------------------

def _jax_grads(x, c, weights, dy):
    """dx, dc and the weight gradients of the JAX fused block, its Pallas
    backward kernel in interpret mode."""
    from scldm_tpu.ops.fused_dit import fused_dit_block_trainable

    kp = {k: jnp.asarray(v) for k, v in weights.items()}

    def f(x, c, kp):
        out = fused_dit_block_trainable(x, c, kp, H, EPS, None, None, True)
        return (out * jnp.asarray(dy)).sum()

    gx, gc, gp = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(c), kp)
    return np.asarray(gx), np.asarray(gc), {k: np.asarray(v) for k, v in gp.items()}


def _torch_trainable_grads(x, c, weights, dy):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, c, *weights.values())]
    w = dict(zip(weights, leaves[2:]))
    out = port.dit_block_trainable(leaves[0], leaves[1], w, H, EPS)
    out.backward(torch.from_numpy(dy))
    return leaves[0].grad, leaves[1].grad, {k: t.grad for k, t in w.items()}


def _torch_reference_grads(x, c, weights, dy):
    w = {k: torch.from_numpy(v) for k, v in weights.items()}
    return port.dit_block_backward_reference(torch.from_numpy(x), torch.from_numpy(c), w,
                                             torch.from_numpy(dy), H, EPS)


@pytest.mark.parametrize("R", [12, 5])
@pytest.mark.parametrize("fn", ["trainable", "reference"])
def test_block_gradients_match_pallas_interpret(R, fn):
    """dx and dc within rtol = atol = 1e-4; each weight gradient within 1e-5
    of its tensor's largest magnitude: f32 on both sides, the weight
    gradients summed over R*T tokens in other orders."""
    x, c, weights = _inputs(R)
    dy = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    want_x, want_c, want_w = _jax_grads(x, c, weights, dy)
    before = port.DIT_BLOCK_BWD_LAUNCHES.count
    grads = {"trainable": _torch_trainable_grads, "reference": _torch_reference_grads}[fn]
    got_x, got_c, got_w = grads(x, c, weights, dy)
    assert port.DIT_BLOCK_BWD_LAUNCHES.count == before  # CPU: the plain version
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-4, atol=1e-4)
    assert set(got_w) == set(port.WEIGHT_NAMES)
    for name, want in want_w.items():
        scale = np.abs(want).max()
        assert scale > 1e-3, name  # non-zero adaLN weights: every gradient is live
        assert np.abs(got_w[name].numpy() - want).max() <= 1e-5 * scale, name


def test_block_weights_carry_gradients_to_the_module():
    """block_weights are views of the Linear parameters: gradients through
    dit_block_trainable land in each weight (out, in) and bias, and match
    autograd through the module's Block."""
    from scldm_torch.nn.layers import Block
    from scldm_torch.utils.weights import init_reference_

    block = Block(E, H, bias=True, use_adaln=True, elementwise_affine=False)
    init_reference_(block, torch.Generator().manual_seed(1), zero_init=False)
    x, c, _ = _inputs(4)
    dy = torch.from_numpy(np.random.default_rng(3).normal(size=x.shape).astype(np.float32))
    tx, tc = torch.from_numpy(x), torch.from_numpy(c)
    port.dit_block_trainable(tx, tc, port.block_weights(block), H, EPS).backward(dy)
    got = {n: p.grad.clone() for n, p in block.named_parameters()}
    block.zero_grad()
    block(tx, tc[:, None, :]).backward(dy)
    assert len(got) == 9
    for n, p in block.named_parameters():
        torch.testing.assert_close(got[n], p.grad, rtol=1e-4, atol=1e-4 * p.grad.abs().max().item())
    # sampling keeps detached copies
    assert not any(t.requires_grad for t in port.extract_block_params(block).values())


def test_backward_shapes_and_limits():
    """The backward's row design fits one CTA at the dentate training shape
    (T = 16) and its split design at the census one (T = 64); the workspace
    is the per-token slots, the per-row ones and a partial of dmod per row
    and token tile."""
    assert port.dit_block_bwd_row_smem_bytes(16, 256, 8, 684) <= port.MAX_SMEM_BYTES
    assert port.dit_block_bwd_row_smem_bytes(64, 256, 8, 684) == 604_160
    assert [port.pick_design(T, 256, 8, 684, backward=True) for T in (16, 64)] == ["row", "split"]
    for T in (16, 64):
        assert max(port.dit_block_bwd_smem_bytes(T, 256, 8, 684).values()) <= port.MAX_SMEM_BYTES
    assert port.dit_block_bwd_workspace_floats(128, 16, 256, 684) == (
        2048 * (9 * 256 + 3 * 684) + 128 * 1792 + 128 * 1 * 1536)
    assert port.dit_block_bwd_workspace_floats(16, 64, 256, 684) == (
        1024 * (9 * 256 + 3 * 684) + 16 * 1792 + 16 * 4 * 1536)
    # the forward's: mod per row; qkv, h / the attention output, x1 and the hidden per token
    assert port.dit_block_workspace_floats(48, 64, 256, 684) == (
        48 * 1536 + 48 * 64 * (5 * 256 + 684))
    assert port.dit_block_workspace_floats(12, 1024, 256, 684) == 12 * 1536 + 12288 * 1964
    # a census row in one CTA would need the scores and their cotangents,
    # 262 KB; at T = 160 one head's pair alone outgrows a CTA
    with pytest.raises(ValueError, match="dit_block_bwd needs .* shared memory .* attention_bwd"):
        port._check_shapes(torch.zeros(2, 160, 256), torch.zeros(2, 256), _zero_weights(256, 684),
                           8, backward=True)
    xs, cs, ws = _inputs(2)
    meta = {k: torch.from_numpy(v).to("meta") for k, v in ws.items()}
    xm = torch.from_numpy(xs).to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.dit_block_bwd(xm, torch.from_numpy(cs).to("meta"), meta, xm, H, EPS)


# -- the census latent, T = 64 ---------------------------------------------------------

@pytest.mark.parametrize("R", [3, 2])
@pytest.mark.parametrize("fn", ["dit_block_reference", "dit_block"])
def test_block_at_t64_matches_pallas_interpret(R, fn):
    x, c, weights = _inputs(R, seed=R, **T64)
    want = _jax(x, c, weights, H64)
    before = port.DIT_BLOCK_LAUNCHES.count
    got = _torch(getattr(port, fn), x, c, weights, H64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(got - x).max() > 1e-2
    assert port.DIT_BLOCK_LAUNCHES.count == before  # CPU: the plain version


@pytest.mark.parametrize("fn", ["trainable", "reference"])
def test_block_gradients_at_t64_match_pallas_interpret(fn):
    """dx and dc within rtol = atol = 1e-4, each weight gradient within 1e-4
    of its largest magnitude, against JAX's Pallas backward in interpret
    mode (its row block of 256 // T = 4 rows, so R = 3 is one ragged block)."""
    x, c, weights = _inputs(3, seed=11, **T64)
    dy = np.random.default_rng(12).normal(size=x.shape).astype(np.float32)
    kp = {k: jnp.asarray(v) for k, v in weights.items()}

    def f(x, c, kp):
        from scldm_tpu.ops.fused_dit import fused_dit_block_trainable

        out = fused_dit_block_trainable(x, c, kp, H64, EPS, None, None, True)
        return (out * jnp.asarray(dy)).sum()

    want_x, want_c, want_w = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(c), kp)
    before = port.DIT_BLOCK_BWD_LAUNCHES.count
    if fn == "trainable":
        leaves = [torch.from_numpy(a).requires_grad_() for a in (x, c, *weights.values())]
        w = dict(zip(weights, leaves[2:]))
        port.dit_block_trainable(leaves[0], leaves[1], w, H64, EPS).backward(torch.from_numpy(dy))
        got_x, got_c, got_w = leaves[0].grad, leaves[1].grad, {k: t.grad for k, t in w.items()}
    else:
        w = {k: torch.from_numpy(v) for k, v in weights.items()}
        got_x, got_c, got_w = port.dit_block_backward_reference(
            torch.from_numpy(x), torch.from_numpy(c), w, torch.from_numpy(dy), H64, EPS)
    assert port.DIT_BLOCK_BWD_LAUNCHES.count == before
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-4, atol=1e-4)
    for name, want in want_w.items():
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 1e-3, name
        assert np.abs(got_w[name].numpy() - want).max() <= 1e-4 * scale, name
