"""The port's long-axis flash attention (scldm_torch.ops.flash_attention)
and `sdpa`'s gate (scldm_torch.ops.attention) against the JAX package, on
the same numpy inputs.

`flash_attention_reference` and the port's `flash_attention` (on CPU
tensors, the plain version: the launch counter stays still) against JAX's
Pallas `flash_attention` in interpret mode, at JAX's own shapes
(tests/test_pallas.py) and tolerances: rtol = atol = 2e-4 in f32 (streaming
against materialized softmax, sums in other orders) and 2e-2 with bf16
operands (the plain version rounds the probabilities to bf16, the kernels
do not). The gate's pieces on CPU tensors; the op raising wherever autograd
records a graph through it (JAX's kernel has no backward either); and the
gradient of `sdpa` at M = S = 1,024 against JAX's `jax.grad` of `sdpa` with
its gate forced open, where JAX's kernel fails to trace and its `try` takes
plain attention: each gradient within 1e-4 of its largest magnitude. The
CUDA kernel itself is held to the plain version on the card in
test_torch_port_cuda.py; here, the precision its f32 path rests on: an
emulation of its arithmetic (both products as TF32 tensor-core passes with
f32 sums, the streaming softmax over 64-key tiles in base 2) holds 2e-4 of
the output's largest magnitude against `sdpa_plain` with three passes a
product, and misses it with one."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.ops import attention as jattn
from scldm_tpu.ops import flash_attention as jfa
from scldm_torch.ops import attention
from scldm_torch.ops import flash_attention as fa


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _qkv(B, M, S, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((B, M, H, D), (B, S, H, D), (B, S, H, D)))


def _port(f, arrays, dtype=torch.float32):
    return f(*(torch.from_numpy(a).to(dtype) for a in arrays))


@pytest.mark.parametrize("B,M,S,H,D", [
    (2, 256, 1024, 4, 8),    # long keys, a tiny head
    (1, 1024, 1024, 2, 64),  # square
    (2, 300, 700, 2, 16),    # lengths off the tiles (padding and the key mask)
])
def test_matches_pallas_interpret(B, M, S, H, D):
    arrays = _qkv(B, M, S, H, D)
    want = np.asarray(jfa.flash_attention(*map(jnp.asarray, arrays), block_q=128, block_kv=256,
                                          interpret=True))
    before = fa.FLASH_ATTENTION_LAUNCHES.count
    got = _port(fa.flash_attention, arrays)
    assert fa.FLASH_ATTENTION_LAUNCHES.count == before  # CPU: the plain version
    assert got.shape == (B, M, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_port(fa.flash_attention_reference, arrays).numpy(), want,
                               rtol=2e-4, atol=2e-4)


def test_bf16_operands_match_pallas_interpret():
    arrays = _qkv(1, 128, 512, 2, 32, seed=1)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    want = np.asarray(jfa.flash_attention(jq, jk, jv, block_q=128, block_kv=256, interpret=True),
                      np.float32)
    before = fa.FLASH_ATTENTION_LAUNCHES.count
    got = _port(fa.flash_attention, arrays, torch.bfloat16)
    assert fa.FLASH_ATTENTION_LAUNCHES.count == before
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_reference_is_sdpas_plain_path():
    """One plain function serves both: the op's plain version is `sdpa`'s
    plain path, JAX `sdpa_xla`."""
    assert fa.flash_attention_reference is attention.sdpa_plain
    arrays = _qkv(2, 40, 70, 2, 16, seed=2)
    want = np.asarray(jattn.sdpa_xla(*map(jnp.asarray, arrays)))
    np.testing.assert_allclose(_port(attention.sdpa_plain, arrays).numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_gate_pieces_on_cpu_tensors():
    """The length test at JAX's 1,024 on both axes, the gradient test, and
    the CUDA test: CPU tensors never take the kernel."""
    assert attention._FLASH_MIN_SEQ == jattn._FLASH_MIN_SEQ == 1024

    def t(n, grad=False):
        return torch.zeros(1, n, 1, 4, requires_grad=grad)

    assert attention._flash_lengths_ok(t(1024), t(1024))
    assert not attention._flash_lengths_ok(t(1023), t(4096))
    assert not attention._flash_lengths_ok(t(4096), t(1023))
    for grad_in in range(3):
        qkv = [t(1024, grad=i == grad_in) for i in range(3)]
        assert attention.records_graph(*qkv)
        with torch.no_grad():
            assert not attention.records_graph(*qkv)
        with torch.inference_mode():
            assert not attention.records_graph(*qkv)
    assert not attention.records_graph(t(1024), t(1024), t(1024))
    assert not attention._use_flash(t(1024), t(1024), t(1024))  # not CUDA
    before = fa.FLASH_ATTENTION_LAUNCHES.count
    arrays = _qkv(1, 1024, 1024, 1, 4, seed=3)
    torch.testing.assert_close(_port(attention.sdpa, arrays), _port(attention.sdpa_plain, arrays),
                               rtol=0, atol=0)
    assert fa.FLASH_ATTENTION_LAUNCHES.count == before


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("grad_in", [0, 1, 2])
def test_op_raises_under_a_recording_graph(device, grad_in):
    """No backward, as in JAX: the op refuses a graph through q, k or v on
    any device, and runs where none is recorded."""
    qkv = [torch.zeros(1, 8, 2, 4, device=device, requires_grad=i == grad_in) for i in range(3)]
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(*qkv)
    if device == "cpu":
        with torch.no_grad():
            assert fa.flash_attention(*qkv).shape == (1, 8, 2, 4)
    else:
        with torch.no_grad(), pytest.raises(ValueError, match="cuda or cpu"):
            fa.flash_attention(*qkv)


def test_sdpa_gradient_matches_jax_fallback(monkeypatch):
    """At M = S = 1,024 with JAX's gate forced open, `jax.grad` of `sdpa`
    cannot trace the kernel and takes `sdpa_xla` inside its `try`; the port's
    gate sends a gradient to the plain path without trying. Each gradient of
    sum(sdpa(q, k, v) * w) within 1e-4 of its largest magnitude. Without a
    gradient the same forced gate runs JAX's kernel."""
    arrays = _qkv(1, 1024, 1024, 2, 16, seed=4)
    w = np.random.default_rng(5).normal(size=arrays[0].shape).astype(np.float32)
    raised = []
    kernel = functools.partial(jfa.flash_attention, interpret=True)

    def counted(q, k, v):
        try:
            return kernel(q, k, v)
        except Exception as e:  # what JAX's sdpa catches: recorded, raised on
            raised.append(e)
            raise

    monkeypatch.setattr(jattn, "_use_flash", lambda q, k: True)
    monkeypatch.setattr(jfa, "flash_attention", counted)
    want = jax.grad(lambda q, k, v: jnp.sum(jattn.sdpa(q, k, v) * w), argnums=(0, 1, 2))(
        *map(jnp.asarray, arrays))
    # JAX's sdpa tried its kernel, which cannot trace under a gradient
    assert raised and not any(isinstance(e, RecursionError) for e in raised), raised
    jq, jk, jv = map(jnp.asarray, arrays)
    n_raised = len(raised)
    np.testing.assert_allclose(np.asarray(jattn.sdpa(jq, jk, jv)),
                               np.asarray(jattn.sdpa_xla(jq, jk, jv)), rtol=2e-4, atol=2e-4)
    assert len(raised) == n_raised
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    before = fa.FLASH_ATTENTION_LAUNCHES.count
    (attention.sdpa(*leaves) * torch.from_numpy(w)).sum().backward()
    assert fa.FLASH_ATTENTION_LAUNCHES.count == before
    for name, leaf, g in zip(("dq", "dk", "dv"), leaves, want):
        g = np.asarray(g)
        err = np.abs(leaf.grad.numpy() - g).max()
        assert err <= 1e-4 * np.abs(g).max(), (name, err, np.abs(g).max())


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 as `cvt.rna.tf32.f32` does: to the nearest value
    with 10 mantissa bits, ties away from zero (the low 13 bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """The kernel's tensor-core product: one pass hi_a.hi_b, or three,
    lo_a.hi_b + hi_a.lo_b + hi_a.hi_b with hi = tf32(x), lo = tf32(x - hi).
    Products of TF32 values are exact in f32; the sums are f32."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def _kernel_arithmetic(q, k, v, passes: int, tile: int = 64) -> torch.Tensor:
    """flash_attention.cu's f32 path in plain PyTorch: per tile of 64 keys the
    scores as `passes` TF32 products, scaled by log2(e) / sqrt(D), the online
    softmax in base 2, then p v as `passes` TF32 products. -> (B, M, H, D)."""
    B, M, H, D = q.shape
    scale = math.log2(math.e) / math.sqrt(D)
    m = torch.full((B, H, M), -math.inf)
    l = torch.zeros(B, H, M)
    acc = torch.zeros(B, H, M, D)
    for n0 in range(0, k.shape[1], tile):
        s = _tf32_product("bmhd,bshd->bhms", q, k[:, n0:n0 + tile], passes) * scale
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _tf32_product("bhms,bshd->bhmd", p, v[:, n0:n0 + tile],
                                                     passes)
        m = m_new
    return (acc / l[..., None]).permute(0, 2, 1, 3)


def test_tf32_rounding_matches_cvt_rna():
    """The emulation's rounding: 10 mantissa bits kept, the nearest value
    taken, a tie away from zero, whatever the sign."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2), 3.0e-3])
    got = _tf32(x)
    torch.testing.assert_close(got[:5], torch.tensor([1.0, 1 + ulp, 1.0, 1 + ulp, -(1 + ulp)]),
                               rtol=0, atol=0)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2.0 ** -11


# (passes, holds): the shape on which the design was chosen; one pass rounds
# each operand to 11 significant bits and lands 3x past the bound there
@pytest.mark.parametrize("passes,holds", [(3, True), (1, False)])
def test_kernel_f32_arithmetic_against_the_plain_path(passes, holds):
    """Three TF32 passes a product keep the kernel within the 2e-4 of the
    output's largest magnitude that phase 1i and the `cuda` tests hold it to;
    one pass does not."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 512, 2048, 2, 64))
    want = attention.sdpa_plain(q, k, v)
    err = ((_kernel_arithmetic(q, k, v, passes) - want).abs().max() / want.abs().max()).item()
    assert (err <= 2e-4) == holds, err
    if holds:
        assert err <= 2e-5, err  # a tenth of the bound: f32 accuracy, not a near miss
