"""The CUDA kernels on the card against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and nvcc, and skips without one. The
file imports no jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -m cuda tests/torch_port/test_torch_port_cuda.py

The DiT block: rtol = atol = 1e-4, both sides compute in f32 and differ in
the order of their sums; its backward holds dx and dc at the same bound and
each weight gradient within 1e-4 of its tensor's largest magnitude (sums
over every token in other orders). The decoder tail: both sides round the same
operands to bf16 and accumulate in f32, so a different summation order
flips a bf16 rounding now and then, which moves an entry by up to about 1%
of its tensor's largest magnitude: the logits and each gradient are held
within 1e-2 of that magnitude everywhere, and within 1e-4 of it on all but
5% of the entries (chip_smoke.py's phase 1b holds the same bounds). The
encoder pools round the same operands as their plain versions and sum in
another order too (the backward's with atomics): the tail's bounds for den,
m and every gradient, and for num within 3e-4 rather than 1e-4 on all but 5%
of the entries (see `assert_pool_close`; chip_smoke.py's phase 1d)."""

import numpy as np
import pytest
import torch

from scldm_torch.ops import fused_decoder as tail
from scldm_torch.ops import fused_dit as port
from scldm_torch.ops import fused_encoder as fe

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


def assert_bwd_close(got, want):
    (dx, dc, dw), (rx, rc, rw) = got, want
    torch.testing.assert_close(dx, rx, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dc, rc, rtol=1e-4, atol=1e-4)
    for k in port.WEIGHT_NAMES:
        scale = rw[k].abs().max()
        assert scale > 0, k
        assert (dw[k] - rw[k]).abs().max() <= 1e-4 * scale, k


@pytest.mark.parametrize("R", [128, 5])  # the LDM training step's rows at batch 128, a ragged R
def test_backward_kernel_matches_reference_on_gpu(R):
    x, c, w = _inputs(R, "cuda")
    dy = torch.randn(x.shape, generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    before = port.DIT_BLOCK_BWD_LAUNCHES.count
    got = port.dit_block_bwd(x, c, w, dy, H, EPS)
    torch.cuda.synchronize()
    assert port.DIT_BLOCK_BWD_LAUNCHES.count == before + 1
    assert_bwd_close(got, port.dit_block_backward_reference(x, c, w, dy, H, EPS))


def test_trainable_block_gradients_reach_the_module_on_gpu():
    """dit_block_trainable over a Block's weight views: one launch each way,
    and the module's gradients as autograd through the Block gives them."""
    from scldm_torch.nn.layers import Block
    from scldm_torch.utils.weights import init_reference_

    block = Block(E, H, bias=True, use_adaln=True, elementwise_affine=False)
    init_reference_(block, torch.Generator().manual_seed(0), zero_init=False)
    block = block.cuda()
    x, c, _ = _inputs(128, "cuda")
    dy = torch.randn(x.shape, generator=torch.Generator("cuda").manual_seed(2), device="cuda")
    fwd, bwd = port.DIT_BLOCK_LAUNCHES.count, port.DIT_BLOCK_BWD_LAUNCHES.count
    port.dit_block_trainable(x, c, port.block_weights(block), H, EPS).backward(dy)
    torch.cuda.synchronize()
    assert (port.DIT_BLOCK_LAUNCHES.count, port.DIT_BLOCK_BWD_LAUNCHES.count) == (fwd + 1, bwd + 1)
    got = {n: p.grad.clone() for n, p in block.named_parameters()}
    block.zero_grad()
    block(x, c[:, None, :]).backward(dy)
    for n, p in block.named_parameters():
        assert (got[n] - p.grad).abs().max() <= 1e-4 * p.grad.abs().max(), n


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two GPUs")
def test_backward_kernel_on_a_device_other_than_the_current():
    x0, c0, w0 = _inputs(3, "cuda:0")
    port.dit_block_bwd(x0, c0, w0, x0, H, EPS)
    torch.cuda.synchronize(0)
    x, c, w = _inputs(128, "cuda:1", seed=1)
    dy = torch.randn(x.shape, generator=torch.Generator("cuda:1").manual_seed(3), device="cuda:1")
    got = port.dit_block_bwd(x, c, w, dy, H, EPS)
    torch.cuda.synchronize(1)
    assert got[0].device == x.device and torch.cuda.current_device() == 0
    assert_bwd_close(got, port.dit_block_backward_reference(x, c, w, dy, H, EPS))


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


POOL_E, POOL_H, POOL_Q = 32, 4, 16  # the reference encoder's MCAB


def _pool_inputs(variant, B, N, device, seed=0):
    """Counts and a table (dense) or an embedding window, the MCAB's query
    and weights, and the cotangents of num and den."""
    rng = np.random.default_rng(seed)
    E, Q = POOL_E, POOL_Q

    def f(*s, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + shift).astype(np.float32)).to(device)

    x = dict(src=f(N, E) if variant == "dense" else f(B, N, E), q=f(Q, E),
             ln1g=f(1, E, scale=0.3, shift=1.0), ln1b=f(1, E, scale=0.3),
             wk=f(E, E, scale=E**-0.5), wv=f(E, E, scale=E**-0.5))
    counts = None
    if variant == "dense":
        counts = torch.from_numpy((rng.poisson(3.0, (B, N)) * (rng.random((B, N)) < 0.6))
                                  .astype(np.float32)).to(device)
    return counts, x, (f(B, Q, E), f(B, Q * POOL_H))


def pool_outputs_and_grads(fn, counts, x, cot):
    """(num, den, m) of `fn` (a pool or its plain version) and the gradients
    of the source, the query and the weights for the cotangents `cot`."""
    leaves = {k: t.detach().clone().requires_grad_() for k, t in x.items()}
    qfull = fe.build_query_operand(leaves["q"], POOL_H)
    args = (leaves["src"],) if counts is None else (counts, leaves["src"])
    num, den, m = fn(*args, qfull, [leaves[k] for k in fe.WEIGHT_NAMES], POOL_H, 1e-8)
    torch.autograd.backward((num, den), cot)
    return {"num": num.detach(), "den": den.detach(), "m": m,
            **{f"d{k}": t.grad for k, t in leaves.items()}}


def assert_pool_close(got, want):
    """The tail's bounds: the pools round the same operands to bf16 as their
    plain versions and sum in another order (atomics in the backward). num
    is held to 3e-4 where the rest is held to 1e-4: the forward rounds each
    exponential against its tile's running max and the plain version
    against the final max, and the dense pool's identical zero-count rows
    move num together (chip_smoke.POOL_NUM_NEAR)."""
    for k, w in want.items():
        scale = w.abs().max()
        d = (got[k] - w).abs()
        assert scale > 0, k
        assert d.max() <= 1e-2 * scale, k
        assert (d > (3e-4 if k == "num" else 1e-4) * scale).float().mean() <= 5e-2, k


# ragged: B not a multiple of the backward's 16 cells, N of its 128 tokens
# or the forward's 256
@pytest.mark.parametrize("variant,B,N", [("dense", 19, 300), ("window", 19, 250)])
def test_encoder_pools_match_reference_on_gpu(variant, B, N):
    counts, x, cot = _pool_inputs(variant, B, N, "cuda")
    pool, reference = ((fe.encoder_pool, fe.encoder_pool_reference) if variant == "dense"
                       else (fe.window_pool, fe.window_pool_reference))
    counters = ((fe.ENCODER_POOL_FWD_LAUNCHES, fe.ENCODER_POOL_BWD_LAUNCHES) if variant == "dense"
                else (fe.WINDOW_POOL_FWD_LAUNCHES, fe.WINDOW_POOL_BWD_LAUNCHES))
    before = [c.count for c in counters]
    got = pool_outputs_and_grads(pool, counts, x, cot)
    torch.cuda.synchronize()
    assert [c.count for c in counters] == [n + 1 for n in before]
    assert_pool_close(got, pool_outputs_and_grads(reference, counts, x, cot))


def test_encoder_pool_width_outside_kernel_shapes_raises_on_gpu():
    """E=64 with 4 heads passes the JAX gate (E <= 128) but has no kernel:
    on CUDA tensors it raises instead of taking the plain version."""
    E, Q = 64, POOL_Q
    emb = torch.randn(2, 10, E, device="cuda")
    qfull = fe.build_query_operand(torch.randn(Q, E, device="cuda"), POOL_H)
    weights = [torch.ones(1, E, device="cuda"), torch.zeros(1, E, device="cuda"),
               torch.randn(E, E, device="cuda"), torch.randn(E, E, device="cuda")]
    with pytest.raises(ValueError, match="built for"):
        fe.window_pool(emb, qfull, weights, POOL_H)
    with pytest.raises(ValueError, match="built for"):
        fe.encoder_pool(torch.ones(2, 10, device="cuda"), emb[0].contiguous(), qfull, weights,
                        POOL_H)


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two GPUs")
@pytest.mark.parametrize("variant", ["dense", "window"])
def test_encoder_pools_on_a_device_other_than_the_current(variant):
    pool, reference = ((fe.encoder_pool, fe.encoder_pool_reference) if variant == "dense"
                       else (fe.window_pool, fe.window_pool_reference))
    pool_outputs_and_grads(pool, *_pool_inputs(variant, 3, 40, "cuda:0"))
    torch.cuda.synchronize(0)
    counts, x, cot = _pool_inputs(variant, 19, 300, "cuda:1", seed=1)
    got = pool_outputs_and_grads(pool, counts, x, cot)
    torch.cuda.synchronize(1)
    assert got["num"].device == x["src"].device and torch.cuda.current_device() == 0
    assert_pool_close(got, pool_outputs_and_grads(reference, counts, x, cot))
