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
test_torch_port_cuda.py."""

import functools

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
