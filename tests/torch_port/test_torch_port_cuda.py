"""The CUDA kernels on the card against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and nvcc, and skips without one. The
file imports no jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -m cuda tests/torch_port/test_torch_port_cuda.py

The DiT block: rtol = atol = 1e-4, both sides compute in f32 (the kernel's
three TF32 tensor-core passes a product keep f32 accuracy) and differ in
the order of their sums, which the kernel takes in a fixed order (the same
bits every run); its backward holds dx and dc at the same bound and
each weight gradient within 1e-4 of its tensor's largest magnitude (sums
over every token in other orders). The decoder tail: both sides round the same
operands to bf16 and accumulate in f32, so a different summation order
flips a bf16 rounding now and then, which moves an entry by up to about 1%
of its tensor's largest magnitude: the logits and each gradient are held
within 1e-2 of that magnitude everywhere, and within 1e-4 of it on all but
5% of the entries (chip_smoke.py's phase 1b holds the same bounds); its
backward sums in a fixed order and repeats its bits. The
encoder pools round the same operands as their plain versions and sum in
another order too (the backward's with atomics): the tail's bounds for den,
m and every gradient, and for num within 3e-4 rather than 1e-4 on all but 5%
of the entries (see `assert_pool_close`; chip_smoke.py's phase 1d); the wide
window pool (E = 256 and 512) at the same bounds, and its backward, which
sums in a fixed order, repeats its bits. The swiglu_vec and
fused_swiglu_gate kernels compute in f32 like their plain versions (TF32
off) and sum in another, fixed order: each output and gradient within 1e-4
of its tensor's largest magnitude (chip_smoke.py's phases 1e and 1h). The flash
cross-attention kernel rounds the same operands to bf16 as its plain version
and sums in another order: the tail's bounds (chip_smoke.py's phase 1f). The
census-like LDM step and generation: the kernel path against the module
path, f32 both, at JAX's bounds between its two paths (loss 1e-4 relative,
gradient norm 1e-3) and at 1e-3 for generation's latents and mu. The
whole-trunk kernels compute in f32 like their plain versions and sum in
other, fixed orders: out, xs, dx and every weight gradient within 1e-4 of
its tensor's largest magnitude (chip_smoke.py's phase 1g); a small VAE's
loss through them against the module trunks within 1e-5 relative and its
gradient norm within 1e-4 (both sides take the decoder tail, whose bf16
roundings of operands made from the trunk's output now and then flip). The
flash attention kernel keeps f32 accuracy with f32 operands (three TF32
tensor-core passes a product) and sums in another, fixed order than its
plain version (sdpa's plain path): within 2e-4 of the output's largest
magnitude with f32 operands and 2e-2 with bf16 (JAX's tests/test_pallas.py;
both round the probabilities to bf16, the kernel before normalising them),
the same bits every run."""

import numpy as np
import pytest
import torch

from scldm_torch.ops import attention
from scldm_torch.ops import flash_attention as fa
from scldm_torch.ops import fused_cross as fc
from scldm_torch.ops import fused_decoder as tail
from scldm_torch.ops import fused_dit as port
from scldm_torch.ops import fused_encoder as fe
from scldm_torch.ops import fused_swiglu as fs
from scldm_torch.ops import fused_trunk as ft

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU and nvcc"),
]

T, E, H, HIDDEN, EPS = 16, 256, 8, 684, 1e-8  # one DiT block of the dentate-gyrus sampler


def _inputs(R, device, seed=0, T=T):
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


# the census DiT's T = 64 latent tokens: the training step's R = 16 rows, the
# sampler's 3B = 48 at a generation batch of 16, and a ragged R
@pytest.mark.parametrize("R", [16, 48, 5])
def test_kernel_at_t64_matches_reference_on_gpu(R):
    x, c, w = _inputs(R, "cuda", T=64)
    before = port.DIT_BLOCK_LAUNCHES.count
    got = port.dit_block(x, c, w, H, EPS)
    torch.cuda.synchronize()
    assert port.DIT_BLOCK_LAUNCHES.count == before + 1
    torch.testing.assert_close(got, port.dit_block_reference(x, c, w, H, EPS), rtol=1e-4, atol=1e-4)
    assert (got - x).abs().max() > 1e-2


# the long-latent pair's T = 1,024 (the 3 x 4 rows of a generation batch of
# 4), where the earlier designs raised: the keys stream through the CTA
@pytest.mark.parametrize("R", [12])
def test_kernel_at_t1024_matches_reference_on_gpu(R):
    x, c, w = _inputs(R, "cuda", seed=5, T=1024)
    before = port.DIT_BLOCK_LAUNCHES.count
    got = port.dit_block(x, c, w, H, EPS)
    torch.cuda.synchronize()
    assert port.DIT_BLOCK_LAUNCHES.count == before + 1
    torch.testing.assert_close(got, port.dit_block_reference(x, c, w, H, EPS), rtol=1e-4, atol=1e-4)
    assert (got - x).abs().max() > 1e-2


# no atomics: every sum in a fixed order, the same bits every run
@pytest.mark.parametrize("T,R", [(16, 384), (64, 48)])
def test_kernel_repeats_its_bits_on_gpu(T, R):
    x, c, w = _inputs(R, "cuda", seed=7, T=T)
    assert torch.equal(port.dit_block(x, c, w, H, EPS), port.dit_block(x, c, w, H, EPS))


@pytest.mark.parametrize("R", [384, 5])
def test_split_design_at_t16_matches_reference_on_gpu(R):
    """The backward's split design where its row design runs by default (T =
    16), after the forward's one design there: the same function both ways."""
    x, c, w = _inputs(R, "cuda", seed=2)
    dy = torch.randn(x.shape, generator=torch.Generator("cuda").manual_seed(6), device="cuda")
    assert port.pick_design(16, E, H, HIDDEN) == "tiled"
    assert port.pick_design(16, E, H, HIDDEN, backward=True) == "row"
    got = port.dit_block(x, c, w, H, EPS)
    grads = port.dit_block_bwd(x, c, w, dy, H, EPS, design="split")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, port.dit_block_reference(x, c, w, H, EPS), rtol=1e-4, atol=1e-4)
    assert_bwd_close(grads, port.dit_block_backward_reference(x, c, w, dy, H, EPS))


# other widths: T = 20 leaves a ragged token tile (and, split, two tiles of
# dmod partials per row) and, forward, token tiles across rows that T does
# not divide; E = 64 with 4 heads of 16 and hidden 172. `design` is the
# backward's; the forward has one.
@pytest.mark.parametrize("design", ["row", "split"])
@pytest.mark.parametrize("T,E_,H_,Hd_", [(20, 256, 8, 684), (64, 64, 4, 172)])
def test_both_designs_at_other_widths_on_gpu(design, T, E_, H_, Hd_):
    rng = np.random.default_rng(T)

    def f(*s, scale=1.0):
        return torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32)).cuda()

    w = {"wada": f(E_, 6 * E_, scale=E_**-0.5), "bada": f(6 * E_, scale=0.1),
         "wqkv": f(E_, 3 * E_, scale=E_**-0.5), "bqkv": f(3 * E_, scale=0.1),
         "wproj": f(E_, E_, scale=E_**-0.5), "bproj": f(E_, scale=0.1),
         "w1": f(E_, Hd_, scale=E_**-0.5), "w2": f(E_, Hd_, scale=E_**-0.5),
         "wmlp": f(Hd_, E_, scale=Hd_**-0.5)}
    x, dy, c = f(3, T, E_), f(3, T, E_), f(3, E_)
    if design == "row" and port.pick_design(T, E_, H_, Hd_, backward=True) != "row":
        pytest.skip("a row does not fit one CTA at this width")
    got = port.dit_block(x, c, w, H_, EPS)
    grads = port.dit_block_bwd(x, c, w, dy, H_, EPS, design=design)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, port.dit_block_reference(x, c, w, H_, EPS), rtol=1e-4,
                               atol=1e-4)
    assert_bwd_close(grads, port.dit_block_backward_reference(x, c, w, dy, H_, EPS))


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


@pytest.mark.parametrize("R", [16, 5])  # the census LDM step's rows, a ragged R
def test_backward_kernel_at_t64_matches_reference_on_gpu(R):
    x, c, w = _inputs(R, "cuda", T=64)
    dy = torch.randn(x.shape, generator=torch.Generator("cuda").manual_seed(4), device="cuda")
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


def test_decoder_tail_backward_repeats_its_bits_on_gpu():
    """The backward writes per-CTA partials and sums them in a fixed order
    (no atomics): the same bits on two runs at the training step's shape."""
    x = _tail_inputs(17_002, 128, "cuda", seed=2)
    w = [t.contiguous() for t in tail.pack_weights(*(x[n] for n in TAIL_RAW))]
    kf, vp = tail.build_attention_operands(x["k"], x["v"], x["wproj"], TAIL_H)
    dy = torch.randn(128, 17_002, generator=torch.Generator("cuda").manual_seed(5), device="cuda")
    runs = [tail.decoder_tail_bwd(x["qp"], x["q"], kf, vp, w, dy, TAIL_H, 1e-8) for _ in range(2)]
    flat = [[*r[:4], *r[4]] for r in runs]
    assert all(torch.equal(a, b) for a, b in zip(*flat))


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


def pool_outputs_and_grads(fn, counts, x, cot, n_head=POOL_H):
    """(num, den, m) of `fn` (a pool or its plain version) and the gradients
    of the source, the query and the weights for the cotangents `cot`."""
    leaves = {k: t.detach().clone().requires_grad_() for k, t in x.items()}
    qfull = fe.build_query_operand(leaves["q"], n_head)
    args = (leaves["src"],) if counts is None else (counts, leaves["src"])
    num, den, m = fn(*args, qfull, [leaves[k] for k in fe.WEIGHT_NAMES], n_head, 1e-8)
    torch.autograd.backward((num, den), cot)
    return {"num": num.detach(), "den": den.detach(), "m": m,
            **{f"d{k}": t.grad for k, t in leaves.items()}}


def assert_pool_close(got, want, ln_gain_near=1e-4):
    """The tail's bounds: the pools round the same operands to bf16 as their
    plain versions and sum in another order (atomics in the backward). num
    is held to 3e-4 where the rest is held to 1e-4: the forward rounds each
    exponential against its tile's running max and the plain version
    against the final max, and the dense pool's identical zero-count rows
    move num together (chip_smoke.POOL_NUM_NEAR). The wide design's dln1g
    is held to `ln_gain_near` = 1e-3: a sum over every token of terms that
    mostly cancel, it carries the upstream rounding flips most
    (chip_smoke.POOL_LN_GAIN_NEAR)."""
    near = {"num": 3e-4, "dln1g": ln_gain_near}
    for k, w in want.items():
        scale = w.abs().max()
        d = (got[k] - w).abs()
        assert scale > 0, k
        assert d.max() <= 1e-2 * scale, k
        assert (d > near.get(k, 1e-4) * scale).float().mean() <= 5e-2, k


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
    """E=64 with 4 heads passes the JAX gate (E <= 128) but has no kernel,
    nor do E=512 with 4 heads (a head width of 128) or 256 with 64
    queries; the dense pool has no wide design (JAX gates it at E <= 128).
    On CUDA tensors each raises instead of taking the plain version."""
    before = [c.count for c in (fe.WINDOW_POOL_FWD_LAUNCHES, fe.WINDOW_POOL_WIDE_FWD_LAUNCHES,
                                fe.ENCODER_POOL_FWD_LAUNCHES)]
    for E, H, Q, dense in ((64, POOL_H, POOL_Q, True), (512, 4, 16, False), (256, 4, 64, False),
                           (512, 8, 64, True)):
        emb = torch.randn(2, 10, E, device="cuda")
        qfull = fe.build_query_operand(torch.randn(Q, E, device="cuda"), H)
        weights = [torch.ones(1, E, device="cuda"), torch.zeros(1, E, device="cuda"),
                   torch.randn(E, E, device="cuda"), torch.randn(E, E, device="cuda")]
        if (E, H, Q) not in fe.KERNEL_SHAPES:
            with pytest.raises(ValueError, match="built for"):
                fe.window_pool(emb, qfull, weights, H)
        if dense:
            with pytest.raises(ValueError, match="built for"):
                fe.encoder_pool(torch.ones(2, 10, device="cuda"), emb[0].contiguous(), qfull,
                                weights, H)
    assert [c.count for c in (fe.WINDOW_POOL_FWD_LAUNCHES, fe.WINDOW_POOL_WIDE_FWD_LAUNCHES,
                              fe.ENCODER_POOL_FWD_LAUNCHES)] == before


def _wide_pool_inputs(B, N, E, H, Q, device, seed=0):
    """A (B, N, E) window, the MCAB's query and weights at a wide width, and
    the cotangents of num and den."""
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + shift).astype(np.float32)).to(device)

    x = dict(src=f(B, N, E), q=f(Q, E), ln1g=f(1, E, scale=0.3, shift=1.0), ln1b=f(1, E, scale=0.3),
             wk=f(E, E, scale=E**-0.5), wv=f(E, E, scale=E**-0.5))
    return x, (f(B, Q, E), f(B, Q * H))


# the census width at a ragged B and S (splits of 512 tokens, chunks of 256,
# tiles of 64 and 128), E=256 with 16 queries, and a window of one tile; the
# gradients are sums over every token, so each case has over a thousand (at
# B=2, S=64 the 128 tokens' rounding flips put more than 5% of a gradient's
# entries beyond its bound on an H100)
@pytest.mark.parametrize("B,N,E,H,Q", [(3, 1030, 512, 8, 64), (4, 600, 256, 4, 16),
                                       (19, 64, 512, 8, 64)])
def test_wide_window_pool_matches_reference_on_gpu(B, N, E, H, Q):
    x, cot = _wide_pool_inputs(B, N, E, H, Q, "cuda")
    counters = (fe.WINDOW_POOL_WIDE_FWD_LAUNCHES, fe.WINDOW_POOL_WIDE_BWD_LAUNCHES,
                fe.WINDOW_POOL_FWD_LAUNCHES, fe.WINDOW_POOL_BWD_LAUNCHES)
    before = [c.count for c in counters]
    got = pool_outputs_and_grads(fe.window_pool, None, x, cot, H)
    torch.cuda.synchronize()
    assert [c.count for c in counters] == [before[0] + 1, before[1] + 1, *before[2:]]
    assert_pool_close(got, pool_outputs_and_grads(fe.window_pool_reference, None, x, cot, H),
                      ln_gain_near=1e-3)


def test_wide_window_pool_repeats_its_bits_on_gpu():
    """The wide backward sums every gradient in a fixed order, without
    atomics: the same inputs give the same bits."""
    x, cot = _wide_pool_inputs(3, 700, 512, 8, 64, "cuda", seed=2)
    a = pool_outputs_and_grads(fe.window_pool, None, x, cot, 8)
    b = pool_outputs_and_grads(fe.window_pool, None, x, cot, 8)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_vae_task_fused_pool_step_on_gpu():
    """`VAETask(fused_pool=True, algebraic_tail=False)` on a census-like VAE
    (E=256, 4 cross heads, 16 inducing points): one step launches the wide
    pool once each way, and its loss and gradient norm agree with the module
    MCAB's at JAX's bounds (loss 5e-3 relative, grad norm 2%)."""
    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.training.metrics import global_norm
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.utils.weights import init_reference_

    G, S, B = 300, 280, 4
    vae = init_reference_(build_transformer_vae(n_genes=G, n_embed=256, n_embed_latent=32,
                                                n_layer=1, n_inducing_points=16, n_head=8),
                          torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    gs, cs = np.zeros((B, S), np.uint16), np.zeros((B, S), np.uint16)
    for i in range(B):
        nnz = int(rng.integers(5, S))
        gs[i, :nnz] = np.sort(rng.choice(G, nnz, replace=False)) + 1
        cs[i, :nnz] = rng.poisson(3.0, nnz) + 1
    batch = {"genes_subset": torch.from_numpy(gs).cuda(),
             "counts_subset": torch.from_numpy(cs).cuda(),
             "library_size": torch.from_numpy(cs.astype(np.float32).sum(1, keepdims=True)).cuda()}
    runs = []
    for fused in (True, False):
        task = VAETask(vae, num_training_steps=10, fused_pool=fused, algebraic_tail=False)
        before = (fe.WINDOW_POOL_WIDE_FWD_LAUNCHES.count, fe.WINDOW_POOL_WIDE_BWD_LAUNCHES.count)
        vae.zero_grad(set_to_none=True)
        loss, _ = task.loss(batch)
        loss.backward()
        torch.cuda.synchronize()
        launches = (fe.WINDOW_POOL_WIDE_FWD_LAUNCHES.count - before[0],
                    fe.WINDOW_POOL_WIDE_BWD_LAUNCHES.count - before[1])
        assert launches == ((1, 1) if fused else (0, 0))
        runs.append((loss.item(), global_norm([p.grad for p in vae.parameters()
                                               if p.grad is not None]).item()))
    (lp, gp), (lm, gm) = runs
    assert abs(lp - lm) < 5e-3 * abs(lm) and abs(gp - gm) < 0.02 * gm, runs


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


def _swiglu_inputs(R, E, Hd, device, seed=0):
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0):
        return torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32)).to(device)

    return f(R, E), f(E, 2 * Hd, scale=E**-0.5), f(Hd, 1, scale=Hd**-0.5), f(R, 1)


def swiglu_outputs_and_grads(fn, x, w12, wv, ds):
    leaves = [t.detach().clone().requires_grad_() for t in (x, w12, wv)]
    out = fn(*leaves)
    out.backward(ds)
    return {"out": out.detach(), **{k: t.grad for k, t in zip(("dx", "dw12", "dwv"), leaves)}}


def assert_swiglu_close(got, want):
    for k, w in want.items():
        scale = w.abs().max()
        assert scale > 0, k
        assert (got[k] - w).abs().max() <= 1e-4 * scale, k


# ragged rows against the 128-row tile; E and Hd off the 16-deep slice and the
# 64-column hidden tile; more rows than one backward workspace chunk (32,768)
@pytest.mark.parametrize("R,E,Hd", [(1001, 512, 1408), (300, 200, 100), (40_000, 64, 100)])
def test_swiglu_vec_matches_reference_on_gpu(R, E, Hd):
    inputs = _swiglu_inputs(R, E, Hd, "cuda")
    before = (fs.SWIGLU_VEC_FWD_LAUNCHES.count, fs.SWIGLU_VEC_BWD_LAUNCHES.count)
    got = swiglu_outputs_and_grads(fs.swiglu_vec, *inputs)
    torch.cuda.synchronize()
    assert (fs.SWIGLU_VEC_FWD_LAUNCHES.count, fs.SWIGLU_VEC_BWD_LAUNCHES.count) == (
        before[0] + 1, before[1] + 1)
    assert_swiglu_close(got, swiglu_outputs_and_grads(fs.swiglu_vec_reference, *inputs))


def test_swiglu_vec_operands_it_does_not_take_raise_on_gpu():
    """bf16, a strided x or a CPU weight beside a CUDA x: the wrapper raises
    and never takes the plain version."""
    x, w12, wv, _ = _swiglu_inputs(64, 32, 48, "cuda")
    for args in ((x.bfloat16(), w12.bfloat16(), wv.bfloat16()), (x.t().contiguous().t(), w12, wv),
                 (x, w12.cpu(), wv)):
        before = fs.SWIGLU_VEC_FWD_LAUNCHES.count
        with pytest.raises(ValueError):
            fs.swiglu_vec(*args)
        assert fs.SWIGLU_VEC_FWD_LAUNCHES.count == before


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two GPUs")
def test_wide_window_pool_on_a_device_other_than_the_current():
    pool_outputs_and_grads(fe.window_pool, None, *_wide_pool_inputs(2, 64, 512, 8, 64, "cuda:0"), 8)
    torch.cuda.synchronize(0)
    x, cot = _wide_pool_inputs(3, 1030, 512, 8, 64, "cuda:1", seed=1)
    got = pool_outputs_and_grads(fe.window_pool, None, x, cot, 8)
    torch.cuda.synchronize(1)
    assert got["num"].device == x["src"].device and torch.cuda.current_device() == 0
    assert_pool_close(got, pool_outputs_and_grads(fe.window_pool_reference, None, x, cot, 8),
                      ln_gain_near=1e-3)


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two GPUs")
def test_swiglu_vec_on_a_device_other_than_the_current():
    swiglu_outputs_and_grads(fs.swiglu_vec, *_swiglu_inputs(5, 32, 48, "cuda:0"))
    torch.cuda.synchronize(0)
    inputs = _swiglu_inputs(1001, 512, 1408, "cuda:1", seed=1)
    got = swiglu_outputs_and_grads(fs.swiglu_vec, *inputs)
    torch.cuda.synchronize(1)
    assert got["out"].device == inputs[0].device and torch.cuda.current_device() == 0
    assert_swiglu_close(got, swiglu_outputs_and_grads(fs.swiglu_vec_reference, *inputs))


def _gate_inputs(R, E, H, device, seed=0):
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0):
        return torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32)).to(device)

    return f(R, E), f(E, H, scale=E**-0.5), f(E, H, scale=E**-0.5), f(R, H)


def gate_outputs_and_grads(fn, x, w1, w2, dg):
    leaves = [t.detach().clone().requires_grad_() for t in (x, w1, w2)]
    out = fn(*leaves)
    out.backward(dg)
    return {"out": out.detach(), **{k: t.grad for k, t in zip(("dx", "dw1", "dw2"), leaves)}}


# ragged rows against the 128-row tile; E and H off the 16-deep slice and the
# 64-column hidden tile; more rows than one backward workspace chunk (32,768)
@pytest.mark.parametrize("R,E,H", [(1001, 512, 1408), (300, 200, 100), (40_000, 64, 100)])
def test_swiglu_gate_matches_reference_on_gpu(R, E, H):
    inputs = _gate_inputs(R, E, H, "cuda")
    before = (fs.SWIGLU_GATE_FWD_LAUNCHES.count, fs.SWIGLU_GATE_BWD_LAUNCHES.count)
    got = gate_outputs_and_grads(fs.fused_swiglu_gate, *inputs)
    torch.cuda.synchronize()
    assert (fs.SWIGLU_GATE_FWD_LAUNCHES.count, fs.SWIGLU_GATE_BWD_LAUNCHES.count) == (
        before[0] + 1, before[1] + 1)
    assert_swiglu_close(got, gate_outputs_and_grads(fs.swiglu_reference, *inputs))


def test_swiglu_gate_operands_it_does_not_take_raise_on_gpu():
    """bf16, a strided x or a CPU weight beside a CUDA x: the wrapper raises
    and never takes the plain version."""
    x, w1, w2, _ = _gate_inputs(64, 32, 48, "cuda")
    for args in ((x.bfloat16(), w1.bfloat16(), w2.bfloat16()), (x.t().contiguous().t(), w1, w2),
                 (x, w1.cpu(), w2)):
        before = fs.SWIGLU_GATE_FWD_LAUNCHES.count
        with pytest.raises(ValueError):
            fs.fused_swiglu_gate(*args)
        assert fs.SWIGLU_GATE_FWD_LAUNCHES.count == before


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two GPUs")
def test_swiglu_gate_on_a_device_other_than_the_current():
    gate_outputs_and_grads(fs.fused_swiglu_gate, *_gate_inputs(5, 32, 48, "cuda:0"))
    torch.cuda.synchronize(0)
    inputs = _gate_inputs(1001, 512, 1408, "cuda:1", seed=1)
    got = gate_outputs_and_grads(fs.fused_swiglu_gate, *inputs)
    torch.cuda.synchronize(1)
    assert got["out"].device == inputs[0].device and torch.cuda.current_device() == 0
    assert_swiglu_close(got, gate_outputs_and_grads(fs.swiglu_reference, *inputs))


CROSS_E, CROSS_H, CROSS_M = 512, 8, 64  # the census decoder's cross block


def _cross_inputs(G, B, device, seed=0):
    rng = np.random.default_rng(seed)

    def f(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)

    return f(G, CROSS_E), f(B, CROSS_M, CROSS_E), f(B, CROSS_M, CROSS_E)


def assert_bf16_close(got, want, what):
    """The tail's bounds: within 1e-2 of the reference's largest magnitude
    everywhere, within 1e-4 of it on all but 5% of the entries."""
    scale = want.abs().max()
    d = (got - want).abs()
    assert scale > 0, what
    assert d.max() <= 1e-2 * scale, what
    assert (d > 1e-4 * scale).float().mean() <= 5e-2, what


# ragged: G off the 256-gene tile and B off the 8-cell tile (one gene tile
# of 77 and a lone cell too; one gene past a tile with a lone cell; an odd B
# over two cell tiles); then the census sampler's 2B = 32 over part of the
# gene axis, and the whole axis
@pytest.mark.parametrize("G,B", [(300, 3), (77, 1), (257, 1), (700, 9), (5000, 32), (36_601, 2)])
def test_flash_cross_matches_reference_on_gpu(G, B):
    qp, k, v = _cross_inputs(G, B, "cuda")
    before = fc.FLASH_CROSS_LAUNCHES.count
    got = fc.flash_cross_attention(qp, k, v, CROSS_H)
    torch.cuda.synchronize()
    assert fc.FLASH_CROSS_LAUNCHES.count == before + 1
    assert got.shape == (B, G, CROSS_E) and got.dtype == torch.float32
    assert_bf16_close(got, fc.flash_cross_reference(qp, k, v, CROSS_H), f"y at G={G}, B={B}")


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two GPUs")
def test_flash_cross_on_a_device_other_than_the_current():
    """Tensors on cuda:1 while cuda:0 is current, after a launch on cuda:0:
    the launch and its shared memory attribute go to the tensors' device."""
    fc.flash_cross_attention(*_cross_inputs(77, 1, "cuda:0"), CROSS_H)
    torch.cuda.synchronize(0)
    qp, k, v = _cross_inputs(5000, 32, "cuda:1", seed=1)
    got = fc.flash_cross_attention(qp, k, v, CROSS_H)
    torch.cuda.synchronize(1)
    assert got.device == qp.device and torch.cuda.current_device() == 0
    assert_bf16_close(got, fc.flash_cross_reference(qp, k, v, CROSS_H), "y on cuda:1")


def test_flash_cross_backward_replays_plain_attention_on_gpu():
    """The backward is autograd through plain f32 attention (JAX `_flash_bwd`)."""
    qp, k, v = _cross_inputs(300, 3, "cuda", seed=1)
    dy = torch.randn(3, 300, CROSS_E, generator=torch.Generator("cuda").manual_seed(5),
                     device="cuda")
    leaves = [t.clone().requires_grad_() for t in (qp, k, v)]
    fc.flash_cross_attention(*leaves, CROSS_H).backward(dy)
    ref = [t.clone().requires_grad_() for t in (qp, k, v)]
    fc._attn_reference(*ref, CROSS_H).backward(dy)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


def test_sdpa_shared_q_takes_flash_cross_under_the_gate_on_gpu(monkeypatch):
    """SCLDM_FLASH_CROSS on: the census-like shape launches the kernel; off,
    or with fewer queries than the gate asks, the plain path runs."""
    G, B, hd = 4096, 2, CROSS_E // CROSS_H
    qp, k, v = _cross_inputs(G, B, "cuda", seed=2)
    q4 = qp.reshape(G, CROSS_H, hd)
    k4, v4 = (t.reshape(B, CROSS_M, CROSS_H, hd) for t in (k, v))
    for enabled, rows, launches in ((True, G, 1), (False, G, 0), (True, G - 1, 0)):
        monkeypatch.setattr(attention, "_FLASH_CROSS_ENABLED", enabled)
        before = fc.FLASH_CROSS_LAUNCHES.count
        got = attention.sdpa_shared_q(q4[:rows], k4, v4)
        torch.cuda.synchronize()
        assert fc.FLASH_CROSS_LAUNCHES.count == before + launches
        want = (fc.flash_cross_reference(qp[:rows].contiguous(), k, v, CROSS_H) if launches
                else fc._attn_reference(qp[:rows].contiguous(), k, v, CROSS_H))
        assert_bf16_close(got.reshape(B, rows, CROSS_E), want, f"sdpa_shared_q {enabled} {rows}")


def test_flash_cross_operands_it_does_not_take_raise_on_gpu():
    qp, k, v = _cross_inputs(300, 3, "cuda")
    for args in ((qp, k[:, :32].contiguous(), v[:, :32].contiguous()),  # M = 32: no kernel
                 (qp.bfloat16(), k.bfloat16(), v.bfloat16()), (qp, k.transpose(0, 1).contiguous()
                                                               .transpose(0, 1), v)):
        before = fc.FLASH_CROSS_LAUNCHES.count
        with pytest.raises(ValueError):
            fc.flash_cross_attention(*args, CROSS_H)
        assert fc.FLASH_CROSS_LAUNCHES.count == before


def _census_like_ldm():
    """A census-like pair cut to seconds: the VAE at E = 256 (so the
    algebraic decode resolves on), 64 inducing points and a 64-wide latent;
    the DiT at T = 64 with non-zero adaLN."""
    from scldm_torch.nn.nnets import DiT
    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.training.ldm_task import LDMTask
    from scldm_torch.transport import create_transport
    from scldm_torch.utils.weights import init_reference_

    vae = init_reference_(build_transformer_vae(n_genes=300, n_embed=256, n_embed_latent=64,
                                                n_layer=1, n_inducing_points=64, n_head=8,
                                                n_head_cross=8, multiple_of=64, device="cuda"),
                          torch.Generator("cuda").manual_seed(0)).eval()
    dit = init_reference_(DiT(n_embed=256, n_embed_input=64, n_layer=2, n_head=8, seq_len=64,
                              class_vocab_sizes={"clusters": 3}, cfg_dropout_prob=0.8),
                          torch.Generator().manual_seed(1), zero_init=False).cuda()
    return vae, dit, LDMTask, create_transport


def test_census_like_ldm_step_and_generation_on_gpu():
    from scldm_torch.ops.transforms import canonical_gene_ids
    from scldm_torch.training.metrics import global_norm

    vae, dit, LDMTask, create_transport = _census_like_ldm()
    task = LDMTask(vae, dit, create_transport())
    assert task.algebraic_decode and task.algebraic_vw_fold
    rng = np.random.default_rng(0)
    B, S = 4, 64
    genes = np.zeros((B, S), np.int64)
    counts = np.zeros((B, S), np.float32)
    for i in range(B):
        genes[i] = np.sort(rng.choice(300, S, replace=False)) + 1
        counts[i] = rng.poisson(3.0, S) + 1
    batch = {"genes_subset": torch.from_numpy(genes).cuda(),
             "counts_subset": torch.from_numpy(counts).cuda(),
             "library_size": torch.from_numpy(counts.sum(1, keepdims=True)).cuda(),
             "clusters": torch.tensor([0, 1, 2, 0], device="cuda")}
    g = torch.Generator("cuda").manual_seed(3)
    noise = {"t": torch.rand(B, generator=g, device="cuda"),
             "x0": torch.randn(B, 64, 64, generator=g, device="cuda"),
             "drop_mask": torch.tensor([False, True, False, False], device="cuda")}
    runs = []
    for t in (task, LDMTask(vae, dit, create_transport(), fused_training=False)):
        before = (port.DIT_BLOCK_LAUNCHES.count, port.DIT_BLOCK_BWD_LAUNCHES.count)
        dit.zero_grad(set_to_none=True)
        loss = t.loss(batch, g, noise)
        loss.backward()
        torch.cuda.synchronize()
        launched = (port.DIT_BLOCK_LAUNCHES.count - before[0],
                    port.DIT_BLOCK_BWD_LAUNCHES.count - before[1])
        runs.append((loss.item(), global_norm([p.grad for p in dit.parameters()]).item(), launched))
    (lk, nk, launched_k), (lm, nm, launched_m) = runs
    assert launched_k == (2, 2) and launched_m == (0, 0)
    assert abs(lk - lm) <= 1e-4 * abs(lm) and abs(nk - nm) <= 1e-3 * nm

    z0 = torch.randn(2, 64, 64, generator=g, device="cuda")
    log_sf = torch.full((2,), 6.0, device="cuda")
    cond = {"clusters": torch.tensor([1, 2], device="cuda")}
    kw = dict(guidance_weight={"clusters": 1.0}, sampling_method="euler", num_steps=4)
    outs = []
    for fused in (True, False):
        before = port.DIT_BLOCK_LAUNCHES.count
        z, out, evals = task.generate_from_noise(z0, log_sf, canonical_gene_ids(300, device="cuda"),
                                                 cond, fused_blocks=fused, **kw)
        torch.cuda.synchronize()
        assert port.DIT_BLOCK_LAUNCHES.count - before == (2 * evals if fused else 0)
        outs.append((z, out["mu"]))
    (zk, mk), (zm, mm) = outs
    torch.testing.assert_close(zk, zm, rtol=1e-3, atol=1e-3)
    assert (mk - mm).abs().max() <= 1e-3 * mm.abs().max()


# -- the whole trunk (rows 9-11) ---------------------------------------------------

TRUNK_T = 16  # the VAE's latent tokens


def _trunk_inputs(R, E, Hh, Hd, L, device, seed=0):
    """x, dy and one trunk's weights (per name a list of L tensors, matrices
    (out, in)), from numpy; LayerNorm affines near 1 and 0."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    shapes = {"wqkv": (3 * E, E), "wproj": (E, E), "w1": (Hd, E), "w2": (Hd, E), "wmlp": (E, Hd)}
    w = {k: [t(rng.normal(size=s) / np.sqrt(s[1])) for _ in range(L)] for k, s in shapes.items()}
    for k, base in (("g1", 1.0), ("b1", 0.0), ("g2", 1.0), ("b2", 0.0)):
        w[k] = [t(base + 0.1 * rng.normal(size=E)) for _ in range(L)]
    x, dy = (t(rng.normal(size=(R, TRUNK_T, E))) for _ in range(2))
    return x, dy, w


def assert_trunk_close(got, want, what=""):
    """f32 both, sums in other orders: within 1e-4 of the reference's largest."""
    assert (got - want).abs().max() <= 1e-4 * want.abs().max(), what


def check_trunk(R, E, Hh, Hd, L, device="cuda", seed=0):
    """Rows 9, 10 and 11 against the plain versions; returns the launches of each."""
    x, dy, w = _trunk_inputs(R, E, Hh, Hd, L, device, seed)
    counters = (ft.TRUNK_FWD_LAUNCHES, ft.TRUNK_FWD_SAVING_LAUNCHES, ft.TRUNK_BWD_LAUNCHES)
    before = [c.count for c in counters]
    y = ft.fused_trunk_blocks(x, w, Hh, EPS)
    y10, xs = ft.fused_trunk_fwd_saving(x, w, Hh, EPS)
    dx, dw = ft.fused_trunk_bwd(xs, w, dy, Hh, EPS)
    torch.cuda.synchronize()
    assert [c.count - b for c, b in zip(counters, before)] == [1, 1, 1]
    want, want_xs = ft.fused_trunk_saving_reference(x, w, Hh, EPS)
    rdx, rdw = ft.fused_trunk_backward_reference(x, w, dy, Hh, EPS)
    assert (want - x).abs().max() > 1e-2  # the trunk is not the identity
    for what, got, ref in (("out", y, want), ("out saving", y10, want), ("xs", xs, want_xs),
                           ("dx", dx, rdx)):
        assert got.device == x.device
        assert_trunk_close(got, ref, what)
    for k in ft.TRUNK_WEIGHT_NAMES:
        for layer in range(L):
            assert dw[k][layer].shape == w[k][layer].shape
            assert_trunk_close(dw[k][layer], rdw[k][layer], f"d{k}[{layer}]")
    return xs, dy, w, dx, dw


@pytest.mark.parametrize("R", [128, 5])  # the VAE step's rows, a ragged R
def test_fused_trunk_matches_reference_on_gpu(R):
    check_trunk(R, 32, 8, 88, 8)


@pytest.mark.parametrize("E,Hh,Hd,L", [(64, 4, 172, 3), (128, 8, 344, 2), (32, 8, 88, 10)])
def test_fused_trunk_at_other_widths_on_gpu(E, Hh, Hd, L):
    """Other widths under the JAX gate (E <= 128), and L = 10: two launches
    of eight and two layers each way."""
    check_trunk(19, E, Hh, Hd, L)


def test_fused_trunk_backward_repeats_its_bits_on_gpu():
    """No atomics: the same inputs give the same dx and weight gradients."""
    xs, dy, w, dx, dw = check_trunk(128, 32, 8, 88, 8)
    dx2, dw2 = ft.fused_trunk_bwd(xs, w, dy, 8, EPS)
    assert torch.equal(dx2, dx)
    assert all(torch.equal(a, b) for k in ft.TRUNK_WEIGHT_NAMES for a, b in zip(dw2[k], dw[k]))


def test_fused_trunk_widths_it_does_not_take_raise_on_gpu():
    """E = 30 (hidden 80, 6 heads) passes the JAX gate (E <= 128) but the
    kernels need E % 4 == 0, T = 400 needs more shared memory than a CTA
    has, and the kernels take float32 only: on CUDA tensors each raises
    instead of taking the plain version."""
    x, dy, w = _trunk_inputs(3, 30, 6, 80, 2, "cuda")
    with pytest.raises(ValueError, match="take E % 4 == 0"):
        ft.fused_trunk_blocks(x, w, 6, EPS)
    x, dy, w = _trunk_inputs(3, 32, 8, 88, 1, "cuda")
    long = torch.randn(2, 400, 32, device="cuda")
    with pytest.raises(ValueError, match="bytes of shared memory"):
        ft.fused_trunk_blocks(long, w, 8, EPS)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ft.fused_trunk_blocks(x.double(), w, 8, EPS)


def test_trainable_trunk_gradients_reach_the_module_on_gpu():
    """`VAETask(fused_trunk=True)` on a small CUDA VAE: one loss through the
    trunk kernels (one saving forward and one backward per trunk) against
    the module trunks, the same decoder-tail kernels on both sides."""
    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.training.metrics import global_norm
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.utils.weights import init_reference_

    G, B, S = 300, 6, 40
    vae = init_reference_(build_transformer_vae(n_genes=G, n_layer=3, device="cuda"),
                          torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    genes = np.zeros((B, S), np.int64)
    counts = np.zeros((B, S), np.float32)
    for i in range(B):
        nnz = int(rng.integers(10, S))
        genes[i, :nnz] = np.sort(rng.choice(G, nnz, replace=False)) + 1
        counts[i, :nnz] = rng.poisson(3.0, nnz) + 1
    batch = {"genes_subset": torch.from_numpy(genes).cuda(),
             "counts_subset": torch.from_numpy(counts).cuda(),
             "library_size": torch.from_numpy(counts.sum(1, keepdims=True)).cuda()}
    runs = []
    for on in (True, False):
        task = VAETask(vae, fused_trunk=on)
        before = (ft.TRUNK_FWD_SAVING_LAUNCHES.count, ft.TRUNK_BWD_LAUNCHES.count)
        vae.zero_grad(set_to_none=True)
        loss, _ = task.loss(batch)
        loss.backward()
        torch.cuda.synchronize()
        launched = (ft.TRUNK_FWD_SAVING_LAUNCHES.count - before[0],
                    ft.TRUNK_BWD_LAUNCHES.count - before[1])
        grads = [p.grad for p in vae.parameters() if p.grad is not None]
        runs.append((loss.item(), global_norm(grads).item(), launched))
    (lk, nk, launched_k), (lm, nm, launched_m) = runs
    assert launched_k == (2, 2) and launched_m == (0, 0)
    assert abs(lk - lm) <= 1e-5 * abs(lm) and abs(nk - nm) <= 1e-4 * nm


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two GPUs")
def test_fused_trunk_on_a_device_other_than_the_current():
    """Tensors on cuda:1 while cuda:0 is current, after a launch on cuda:0:
    every launch and its shared memory attribute go to the tensors' device."""
    check_trunk(3, 32, 8, 88, 2, "cuda:0")
    torch.cuda.synchronize(0)
    check_trunk(128, 128, 8, 344, 2, "cuda:1", seed=1)
    assert torch.cuda.current_device() == 0


def _flash_inputs(B, M, S, H, D, device, dtype=torch.float32, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(B, M, H, D, generator=g, device=device).to(dtype),
            *(torch.randn(B, S, H, D, generator=g, device=device).to(dtype) for _ in range(2)))


def assert_flash_close(got, want, rel, what):
    scale = want.float().abs().max()
    assert scale > 0, what
    assert (got.float() - want.float()).abs().max() <= rel * scale, what


# ragged (M off the 64- and 128-query tiles, S off the 64-key tiles, D off
# the compiled widths), keys shorter than one tile with narrow heads, a lone
# query, the DiT's heads, heads of 8, 24, 96 and 128, a grid wide enough for
# 128-query tiles with M and S off them, keys fewer than one tile of the
# ring, bf16 operands, and a long key axis (each tile's p v summed apart:
# summed into the running output on the tensor cores, the error grew with S
# past the bound)
@pytest.mark.parametrize("B,M,S,H,D,dtype", [
    (3, 1030, 1500, 2, 40, torch.float32), (2, 70, 100, 3, 4, torch.float32),
    (1, 1, 33, 1, 16, torch.float32), (4, 300, 1024, 8, 32, torch.float32),
    (2, 200, 300, 2, 128, torch.float32), (3, 1030, 1500, 2, 64, torch.bfloat16),
    (2, 130, 200, 2, 8, torch.float32), (2, 130, 200, 2, 24, torch.float32),
    (2, 200, 300, 2, 96, torch.float32), (16, 1030, 1100, 8, 64, torch.float32),
    (3, 50, 5, 2, 64, torch.float32), (2, 70, 40, 3, 32, torch.bfloat16),
    (1, 64, 32768, 1, 64, torch.float32),
])
def test_flash_attention_matches_reference_on_gpu(B, M, S, H, D, dtype):
    q, k, v = _flash_inputs(B, M, S, H, D, "cuda", dtype)
    before = fa.FLASH_ATTENTION_LAUNCHES.count
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.FLASH_ATTENTION_LAUNCHES.count == before + 1
    assert got.shape == (B, M, H, D) and got.dtype == dtype
    assert_flash_close(got, fa.flash_attention_reference(q, k, v),
                       2e-4 if dtype == torch.float32 else 2e-2, f"out at {B, M, S, H, D}")


def test_flash_attention_takes_strided_views_on_gpu():
    """The fused qkv projection's chunk views (token stride 3E) need no copy."""
    B, S, H, D = 2, 1100, 4, 32
    qkv = torch.randn(B, S, 3 * H * D, generator=torch.Generator("cuda").manual_seed(1),
                      device="cuda")
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.chunk(3, dim=-1))
    assert q.stride(1) == 3 * H * D and not q.is_contiguous()
    assert_flash_close(fa.flash_attention(q, k, v),
                       fa.flash_attention_reference(q, k, v), 2e-4, "chunk views")


# token strides of 3*H*D bf16: 72 bytes (8-byte copies) and 90 bytes (2-byte
# loads), neither a multiple of 16
@pytest.mark.parametrize("H,D", [(3, 4), (3, 5)])
def test_flash_attention_takes_bf16_chunk_views_on_gpu(H, D):
    B, S = 2, 1100
    qkv = torch.randn(B, S, 3 * H * D, generator=torch.Generator("cuda").manual_seed(4),
                      device="cuda").bfloat16()
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.chunk(3, dim=-1))
    assert (q.stride(1) * 2) % 16 and not q.is_contiguous()
    assert_flash_close(fa.flash_attention(q, k, v),
                       fa.flash_attention_reference(q, k, v), 2e-2, f"bf16 chunk views {H, D}")


def test_flash_attention_repeats_its_bits_on_gpu():
    q, k, v = _flash_inputs(2, 1024, 2048, 4, 64, "cuda", seed=2)
    first = fa.flash_attention(q, k, v)
    assert torch.equal(first, fa.flash_attention(q, k, v))


def test_sdpa_takes_flash_attention_only_without_a_gradient_on_gpu():
    """Under no_grad (and inference_mode) sdpa launches the kernel at 1,024
    tokens on both axes; under a gradient, or with an axis of 1,023, it takes
    the plain path, and the gradient matches plain attention's."""
    q, k, v = _flash_inputs(2, 1024, 1024, 4, 64, "cuda", seed=3)
    want = attention.sdpa_plain(q, k, v)
    for ctx in (torch.no_grad, torch.inference_mode):
        before = fa.FLASH_ATTENTION_LAUNCHES.count
        with ctx():
            got = attention.sdpa(q, k, v)
        torch.cuda.synchronize()
        assert fa.FLASH_ATTENTION_LAUNCHES.count == before + 1
        assert_flash_close(got, want, 2e-4, f"sdpa under {ctx.__name__}")
    before = fa.FLASH_ATTENTION_LAUNCHES.count
    with torch.no_grad():
        attention.sdpa(q[:, :1023], k, v)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = attention.sdpa(*leaves)
    dy = torch.randn_like(got)
    got.backward(dy)
    torch.cuda.synchronize()
    assert fa.FLASH_ATTENTION_LAUNCHES.count == before
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    attention.sdpa_plain(*ref).backward(dy)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def test_flash_attention_operands_it_does_not_take_raise_on_gpu():
    q, k, v = _flash_inputs(1, 64, 64, 2, 129, "cuda")
    for args, err in (((q, k, v), ValueError),  # D = 129 > 128
                      ((q[..., :64].half(), k[..., :64].half(), v[..., :64].half()), ValueError),
                      ((q[..., :64], k[..., :64].bfloat16(), v[..., :64]), ValueError),
                      ((q[..., :64].transpose(1, 3).contiguous().transpose(1, 3), k[..., :64],
                        v[..., :64]), ValueError),  # the head width strided
                      ((q[..., :64].requires_grad_(), k[..., :64], v[..., :64]), RuntimeError)):
        before = fa.FLASH_ATTENTION_LAUNCHES.count
        with pytest.raises(err):
            fa.flash_attention(*args)
        assert fa.FLASH_ATTENTION_LAUNCHES.count == before


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two GPUs")
def test_flash_attention_on_a_device_other_than_the_current():
    """Tensors on cuda:1 while cuda:0 is current, after a launch on cuda:0:
    the launch and its shared memory attribute go to the tensors' device."""
    fa.flash_attention(*_flash_inputs(1, 70, 100, 2, 64, "cuda:0"))
    torch.cuda.synchronize(0)
    q, k, v = _flash_inputs(2, 1030, 1500, 2, 64, "cuda:1", seed=1)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize(1)
    assert got.device == q.device and torch.cuda.current_device() == 0
    assert_flash_close(got, fa.flash_attention_reference(q, k, v), 2e-4, "cuda:1")
