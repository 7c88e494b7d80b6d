"""The port's `fused_swiglu_gate` (scldm_torch.ops.fused_swiglu) against the
JAX package's Pallas `fused_swiglu_gate` in interpret mode, forward and VJP,
on the same numpy inputs, at tests/test_fused_swiglu.py's shapes: exact
tiles, a row count and a hidden width off JAX's 128 tiles, and tiles larger
than the arrays. Tolerances are JAX's own there: 1e-5 forward, 2e-4 for the
gradients (f32 both; the port's plain version on CPU tensors, JAX's kernel
with its padded tiles). Then the dispatch: a CPU tensor takes the plain
version with no launch counted, another device raises, and the checks the
CUDA wrapper runs refuse what the kernels do not take. The kernels
themselves are held to the plain version on the card in
test_torch_port_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.ops.fused_swiglu import fused_swiglu_gate as jax_fused_swiglu_gate
from scldm_torch.ops import fused_swiglu as fs


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def make(R, E, H, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(R, E)) * 0.5).astype(np.float32)
    w1 = (rng.normal(size=(E, H)) * E**-0.5).astype(np.float32)
    w2 = (rng.normal(size=(E, H)) * E**-0.5).astype(np.float32)
    dg = rng.normal(size=(R, H)).astype(np.float32)
    return x, w1, w2, dg


def counts():
    return fs.SWIGLU_GATE_FWD_LAUNCHES.count, fs.SWIGLU_GATE_BWD_LAUNCHES.count


@pytest.mark.parametrize("R,E,H,br,bh", [
    (256, 128, 256, 128, 128),  # exact tiling
    (200, 128, 192, 128, 128),  # row and hidden padding
    (64, 128, 128, 512, 512),  # blocks clamp to the arrays
])
def test_forward_matches_pallas_interpret(R, E, H, br, bh):
    x, w1, w2, _ = make(R, E, H)
    want = np.asarray(jax_fused_swiglu_gate(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), br,
                                            bh, True))
    before = counts()
    with torch.no_grad():
        got = fs.fused_swiglu_gate(*map(torch.from_numpy, (x, w1, w2))).numpy()
    assert counts() == before  # a CPU tensor takes the plain version
    assert got.shape == want.shape == (R, H)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("R,E,H", [(256, 128, 256), (200, 128, 192)])
def test_vjp_matches_pallas_interpret(R, E, H):
    x, w1, w2, dg = make(R, E, H, seed=1)
    jdg = jnp.asarray(dg)
    want = jax.grad(lambda *a: jnp.sum(jax_fused_swiglu_gate(*a, 128, 128, True) * jdg),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (x, w1, w2)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, w1, w2)]
    before = counts()
    fs.fused_swiglu_gate(*leaves).backward(torch.from_numpy(dg))
    assert counts() == before
    for t, w, name in zip(leaves, want, ("dx", "dw1", "dw2")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_function_matches_reference_autograd():
    """On CPU tensors the autograd Function (a recompute VJP) and the plain
    version's own autograd agree."""
    x, w1, w2, dg = map(torch.from_numpy, make(37, 24, 40, seed=2))
    grads = []
    for fn in (fs.swiglu_reference, fs.fused_swiglu_gate):
        leaves = [t.clone().requires_grad_() for t in (x, w1, w2)]
        fn(*leaves).backward(dg)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for a, b in zip(fs.swiglu_gate_backward_reference(x, w1, w2, dg), grads[0]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_other_devices_and_operands_raise():
    x, w1, w2, dg = map(torch.from_numpy, make(8, 16, 12))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fs.fused_swiglu_gate(x.to("meta"), w1.to("meta"), w2.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fs.swiglu_gate_bwd(x.to("meta"), w1.to("meta"), w2.to("meta"), dg.to("meta"))
    # what the CUDA wrapper checks before a launch
    assert fs._check_gate(x, w1, w2, dg) == (8, 16, 12)
    with pytest.raises(ValueError, match="float32"):
        fs._check_gate(x.bfloat16(), w1.bfloat16(), w2.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        fs._check_gate(x.t().contiguous().t(), w1, w2)
    with pytest.raises(ValueError, match="w2 must be"):
        fs._check_gate(x, w1, w2[:, :5].contiguous())
    with pytest.raises(ValueError, match="dg must be"):
        fs._check_gate(x, w1, w2, dg[:4].contiguous())
    with pytest.raises(ValueError, match="E >= 1 and H >= 1"):
        fs._check_gate(x[:, :0], w1[:0], w2[:0])
