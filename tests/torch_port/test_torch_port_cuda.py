"""The CUDA kernels on the card against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and nvcc, and skips without one. The
file imports no jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -m cuda tests/torch_port/test_torch_port_cuda.py

The DiT block: rtol = atol = 1e-4, both sides compute in f32 and differ in
the order of their sums. The decoder tail: both sides round the same
operands to bf16 and accumulate in f32, so a different summation order
flips a bf16 rounding now and then, which moves an entry by up to about 1%
of its tensor's largest magnitude: the logits and each gradient are held
within 1e-2 of that magnitude everywhere, and within 1e-4 of it on all but
5% of the entries (chip_smoke.py's phase 1b holds the same bounds)."""

import numpy as np
import pytest
import torch

from scldm_torch.ops import fused_decoder as tail
from scldm_torch.ops import fused_dit as port

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU and nvcc"),
]

T, E, H, HIDDEN, EPS = 16, 256, 8, 684, 1e-8  # one DiT block of the dentate-gyrus sampler


def _inputs(R, device, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {
        "wada": (E, 6 * E), "bada": (6 * E,), "wqkv": (E, 3 * E), "bqkv": (3 * E,),
        "wproj": (E, E), "bproj": (E,), "w1": (E, HIDDEN), "w2": (E, HIDDEN),
        "wmlp": (HIDDEN, E),
    }
    # non-zero adaLN weights: adaLN-zero init would make the block the identity
    weights = {
        k: torch.from_numpy((rng.normal(size=s) / np.sqrt(s[0] if len(s) == 2 else 4))
                            .astype(np.float32)).to(device)
        for k, s in shapes.items()
    }
    x = torch.from_numpy(rng.normal(size=(R, T, E)).astype(np.float32)).to(device)
    c = torch.from_numpy(rng.normal(size=(R, E)).astype(np.float32)).to(device)
    return x, c, weights


@pytest.fixture(autouse=True)
def _f32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    yield


@pytest.mark.parametrize("R", [384, 5])  # the sampler's 3B rows at batch 128, and a ragged R
def test_kernel_matches_reference_on_gpu(R):
    x, c, w = _inputs(R, "cuda")
    before = port.DIT_BLOCK_LAUNCHES.count
    got = port.dit_block(x, c, w, H, EPS)
    torch.cuda.synchronize()
    assert port.DIT_BLOCK_LAUNCHES.count == before + 1
    want = port.dit_block_reference(x, c, w, H, EPS)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert (got - x).abs().max() > 1e-2


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two GPUs")
def test_kernel_on_a_device_other_than_the_current():
    """A tensor on cuda:1 while cuda:0 is current: the launch and its shared
    memory attribute go to the tensor's device, after a launch on cuda:0."""
    x0, c0, w0 = _inputs(3, "cuda:0")
    port.dit_block(x0, c0, w0, H, EPS)
    torch.cuda.synchronize(0)
    assert torch.cuda.current_device() == 0
    x, c, w = _inputs(384, "cuda:1", seed=1)
    got = port.dit_block(x, c, w, H, EPS)
    torch.cuda.synchronize(1)
    assert got.device == x.device and torch.cuda.current_device() == 0
    torch.testing.assert_close(got, port.dit_block_reference(x, c, w, H, EPS),
                               rtol=1e-4, atol=1e-4)


TAIL_RAW = ("ln2g", "ln2b", "w1", "w2", "wmlp", "wmu", "bmu")
TAIL_E, TAIL_H, TAIL_M, TAIL_HD = 32, 4, 16, 88  # the dentate-gyrus decoder


def _tail_inputs(G, B, device, seed=0):
    rng = np.random.default_rng(seed)
    E, Hd = TAIL_E, TAIL_HD

    def f(*s):
        return torch.from_numpy((rng.normal(size=s) * 0.3).astype(np.float32)).to(device)

    return dict(qp=f(G, E), q=f(G, E), k=f(B, TAIL_M, E), v=f(B, TAIL_M, E), wproj=f(E, E),
                ln2g=f(E) + 1.0, ln2b=f(E), w1=f(E, Hd), w2=f(E, Hd), wmlp=f(Hd, E),
                wmu=f(E, 1), bmu=f(1))


def tail_outputs_and_grads(fn, x):
    """Logits of `fn` (decoder_tail or decoder_tail_reference) and the
    gradients of a tanh loss for qp, q, k, v, wproj and the raw weights."""
    x = {k: t.detach().clone().requires_grad_() for k, t in x.items()}
    w = tail.pack_weights(*(x[n] for n in TAIL_RAW))
    kf, vp = tail.build_attention_operands(x["k"], x["v"], x["wproj"], TAIL_H)
    out = fn(x["qp"], x["q"], kf, vp, w, TAIL_H, 1e-8)
    (out * 0.1).tanh().sum().backward()
    return out.detach(), {k: t.grad for k, t in x.items()}


def assert_tail_close(got, want):
    (out_g, grads_g), (out_w, grads_w) = got, want
    for k, g, w in [("logits", out_g, out_w), *((k, grads_g[k], w) for k, w in grads_w.items())]:
        scale = w.abs().max()
        d = (g - w).abs()
        assert scale > 0, k
        assert d.max() <= 1e-2 * scale, k
        assert (d > 1e-4 * scale).float().mean() <= 5e-2, k


@pytest.mark.parametrize("G,B", [(300, 19), (17002, 128)])  # ragged, and the training step's
def test_decoder_tail_matches_reference_on_gpu(G, B):
    x = _tail_inputs(G, B, "cuda")
    fwd, bwd = tail.DECODER_TAIL_FWD_LAUNCHES.count, tail.DECODER_TAIL_BWD_LAUNCHES.count
    got = tail_outputs_and_grads(tail.decoder_tail, x)
    torch.cuda.synchronize()
    assert tail.DECODER_TAIL_FWD_LAUNCHES.count == fwd + 1
    assert tail.DECODER_TAIL_BWD_LAUNCHES.count == bwd + 1
    assert_tail_close(got, tail_outputs_and_grads(tail.decoder_tail_reference, x))


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two GPUs")
def test_decoder_tail_on_a_device_other_than_the_current():
    tail_outputs_and_grads(tail.decoder_tail, _tail_inputs(40, 3, "cuda:0"))
    torch.cuda.synchronize(0)
    x = _tail_inputs(300, 19, "cuda:1", seed=1)
    got = tail_outputs_and_grads(tail.decoder_tail, x)
    torch.cuda.synchronize(1)
    assert got[0].device == x["qp"].device and torch.cuda.current_device() == 0
    assert_tail_close(got, tail_outputs_and_grads(tail.decoder_tail_reference, x))
