#!/usr/bin/env python3
"""Smoke run of the PyTorch port (scldm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--batch B]

Phase 0 prints the card's name and power limit and builds the CUDA kernels from
`scldm_torch/kernels/csrc`. Phase 1 holds the DiT block forward kernels
against their plain PyTorch version on the card at the dentate generation
path's shape (T = 16 latent tokens), at the census sampler's and training
step's (T = 64), at ragged ones and at the long-latent pair's (T = 1,024),
with a bitwise repeat at the sampler shapes, timing each beside its bound, and
phase 1b the decoder-tail kernels (forward and backward) against theirs at the
VAE training step's shape and a ragged one, with a bitwise repeat of the
backward, timing both. Phase 2 runs CFG generation
(`LDMTask.make_sample_fn`) at the dentate-gyrus configuration with random
weights made from the seed, with dopri5 and with euler-50, checks the outputs,
checks that every DiT block went through the kernel, and holds one DiT
evaluation of the sampler (the kernel path) against the plain module path
(`DiT.forward_with_cfg_batched`) on the same inputs. Phase 1c holds the DiT
block backward kernels against their plain version at the dentate and census
LDM training steps' shapes and ragged ones, timing both. Phase 1d holds the
encoder-pool kernels (dense and window, forward and backward) against theirs at
the VAE steps' shapes and ragged ones, timing both, and the dense pool's pooled
tokens against the module MCAB where the zero-row correction is not 0; then the
wide window-pool kernels (the census encoder's design) against their plain
version at the census window (B = 16 cells of S = 4,096 tokens, E = 512, 8
heads, 64 inducing points), a ragged one and at E = 256, timing both. Phase 3
trains the dentate-gyrus VAE (`VAETask.train_step`) on lean wire batches made
like bench.py's for a warm-up step and TRAIN_STEPS timed steps, checks the
losses and that each tail kernel ran once per step, and holds one step's loss
and gradients on the kernel path against the module path. Phase 4 trains the
dentate-gyrus DiT on the frozen VAE's latents (`LDMTask.train_step`) the same
way, checks that every block ran its forward and backward kernels once per step
and that the EMA ticked once per step, holds one step's loss and gradients on
the kernel path against the module path, holds one frozen encode through the
window pool (`LDMTask(fused_encode=True)`) against the module encode, timing
both, and generates from the trained state's EMA weights. Phase 5 trains the
parse1m / replogle VAE (G = S = 2,000) the same way, each step through the
dense encoder pool and the tail kernels once each way, holds one step against
the module path, then takes a few steps of `VAETask(fused_pool=True,
fused_decoder=False)` through the window pool and holds one against the module
path. Phase 1e holds the swiglu_vec kernels (forward and backward) against
their plain version at the census decoder's shape (R = 16 x 36,601 rows, E =
512, Hd = 1,408) and two ragged ones, timing both, with TF32 off. Phase 6
trains the census VAE (configs/model/vae_census.yaml: E = 512, 16 layers, 64
inducing points, G = 36,601 genes, a 4,096-token window, B = 16) through the
algebraic tail with `VAETask(algebraic_fused_gate=True)`, checks that each step
launched the swiglu_vec kernels once each way and that the loss falls, holds
one step against the plain algebraic path and times both paths with their peak
memory. Phase 6b trains the same census VAE on the module path with its MCAB
pooling as the wide window pool (`VAETask(fused_pool=True,
algebraic_tail=False)`), checks that each step launched the pool once each way,
times it against the module MCAB in turns with each arm's peak memory, and
holds one step against the module MCAB. Phase 1f holds the flash cross-
attention kernel against its plain version at the census sampler's cross block
(2B = 32 cells, G = 36,601 genes into 64 latent tokens) and a ragged shape,
timing both and `scaled_dot_product_attention` as a yardstick. Phase 7 trains
the census DiT (T = 64, E = 256, 8 layers) on the frozen census VAE's latents
(B = 16) through the DiT kernels (the backward's split design), prints the step's segment
split, holds one step against the module path, holds the frozen encode through
the wide window pool (`LDMTask(fused_encode=True)`) against the module encode,
timing both in turns, trains the same steps through it with their segment
split, generates euler-50 at a generation batch of 16 through the algebraic
decode, holds the kernel denoiser against the module one on the same noise, and
holds the module decode with the flash-cross gate (`SCLDM_FLASH_CROSS`) on
against off. Phase 1g holds the whole-trunk kernels (the forward, the saving
forward and the backward of all eight blocks of a VAE trunk) against their
plain versions at the VAE step's trunk (R = 128 rows of T = 16 tokens, E = 32)
and a ragged R, timing each, and checks that the backward repeats its bits.
Phase 8 trains the dentate and the parse1m VAEs through them
(`VAETask(fused_trunk=True)`), checks that each step launched the saving
forward and the backward twice (encoder and decoder), times the step with the
trunk kernels and with the module trunks in turns, holds one step against the
module trunks, and runs one no-grad `fused_nb_apply(use_trunk=True)`, which
launches the forward that saves nothing. Phase 1h holds `fused_swiglu_gate`
(its own entry point, forward and backward) against its plain version at the
census cross block's MLP (R = 16 x 36,601 rows, E = 512, H = 1,408) and two
ragged shapes, with TF32 off, timing both. Phase 1i holds the long-axis flash
attention kernel against its plain version (sdpa's plain path) at JAX's
standalone shape, the long-latent MCAB (16 cells, 1,024 queries over 4,096
tokens), its self-attention, the DiT's rows, ragged and short shapes and bf16
operands, checks that it repeats its bits, and times it beside the plain
version and `scaled_dot_product_attention`. Phase 9 runs the census pair at
1,024 latent tokens (the VAE's inducing points and the DiT's seq_len), where
every sdpa call without a gradient takes that kernel: the frozen encode (17
launches, held against the plain gate and timed against it in turns with peak
memory), LDM training with the module DiT under a gradient (17 launches a
step, all from the encode), and euler-10 generation at a generation batch of 4
through the DiT block kernel (72 of its launches, none of row 12's counted in
the DiT, 16 in the decode), its NB means held against the module DiT and,
through it, against the plain gate. The line before the last is a JSON
summary of the kernels, each with its time beside the least time the card could
take for the same work; the last is {"ok": true, "device": {...}}. Any failure
raises, so the script exits non-zero and prints no result; so does a machine
without CUDA, or a directory without the port's sources.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the dentate-gyrus pair (configs/model/vae_base.yaml, ldm_base.yaml)
N_GENES = 17_002
N_CLUSTERS = 14
DIT = dict(n_embed=256, n_embed_input=16, n_layer=8, n_head=8, seq_len=16,
           class_vocab_sizes={"clusters": N_CLUSTERS}, cfg_dropout_prob=0.8)
GUIDANCE = {"clusters": 1.0}
TOL = dict(rtol=1e-4, atol=1e-4)  # kernel vs plain: f32 both, sums in other orders
# bench.py's VAE training step: B=128 cells, a window of S=6,147 expressed tokens
WINDOW = 6_147
TRAIN_STEPS = 10  # timed steps, after one warm-up step
# parse1m / replogle (configs/datamodule/default.yaml:87-121): G = S = 2,000
PARSE_GENES = 2_000
POOL_STEPS = 3  # VAETask(fused_pool=True) steps, after one warm-up step
# the census VAE (configs/model/vae_census.yaml; benchmarks/bench_census.py's
# batch): f32 and no remat, the port's two cuts of the config
CENSUS = dict(n_genes=36_601, n_embed=512, n_embed_latent=64, n_layer=16, n_inducing_points=64,
              n_head=8, n_head_cross=8, multiple_of=64)
CENSUS_BATCH, CENSUS_WINDOW, CENSUS_HIDDEN = 16, 4_096, 1_408
CENSUS_STEPS = 10  # timed steps, after one warm-up step; 3 if the warm-up step takes over 2 s
# the census DiT under that VAE (benchmarks/bench_ldm.py:61-85: configs/model/ldm_base.yaml at
# seq_len = the VAE's 64 inducing points and a 64-wide input); bench_ldm.py:64's batch, also
# the generation batch (2B = 32 cells a call)
CENSUS_DIT = dict(DIT, n_embed_input=64, seq_len=64)
CENSUS_LDM_BATCH = 16
EPS = 1e-8  # the DiT's LayerNorm eps
# the H100 SXM's published peaks (NVIDIA's data sheet, dense), at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # f32 outside the tensor cores
TF32_FLOPS = 495e12  # TF32 tensor cores
BF16_FLOPS = 989e12  # bf16 tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


HIDDEN = 684  # the DiT's SwiGLU hidden width at n_embed 256


def random_block_weights(g) -> dict:
    """One DiT block's kernel weights, (in, out), drawn from `g` on the card;
    non-zero adaLN weights: adaLN-zero init would make the block the identity
    and most of its weight gradients 0."""
    import torch

    E = DIT["n_embed"]

    def rnd(*shape, scale):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    return {"wada": rnd(E, 6 * E, scale=E**-0.5), "bada": rnd(6 * E, scale=0.1),
            "wqkv": rnd(E, 3 * E, scale=E**-0.5), "bqkv": rnd(3 * E, scale=0.1),
            "wproj": rnd(E, E, scale=E**-0.5), "bproj": rnd(E, scale=0.1),
            "w1": rnd(E, HIDDEN, scale=E**-0.5), "w2": rnd(E, HIDDEN, scale=E**-0.5),
            "wmlp": rnd(HIDDEN, E, scale=HIDDEN**-0.5)}


def bound(n_bytes: float, flops: float, peak: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over `peak`."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def dit_block_bound(R: int, backward: bool, T: int = DIT["seq_len"]) -> dict:
    """One DiT block at R rows of T tokens, f32. Operations: two per multiply-add of its
    products (per row the adaLN product 6E^2; per token qkv 3E^2, scores and
    probabilities times values 2TE, the projection E^2, the SwiGLU 3E*Hd);
    the forward runs each product as three TF32 tensor-core passes, so three
    times its operations against the TF32 peak (`f32_bound_ms`: once against
    the f32 FMA peak, the yardstick before the forward used the tensor
    cores); the backward, which recomputes the forward in f32 FMA, three
    times the forward's operations against the f32 peak. The elementwise work
    is left out. Bytes: each input read once and each output written once
    (backward: x, c, dy and the weights in; dx, dc and the weight gradients
    out)."""
    E = DIT["n_embed"]
    weights = 10 * E * E + 10 * E + 3 * E * HIDDEN
    flops = 2 * R * (6 * E * E + T * (4 * E * E + 2 * T * E + 3 * E * HIDDEN))
    if backward:
        return bound(4 * (3 * R * T * E + 2 * R * E + 2 * weights), 3 * flops, F32_FLOPS)
    n_bytes = 4 * (2 * R * T * E + R * E + weights)
    return {**bound(n_bytes, 3 * flops, TF32_FLOPS),
            "f32_bound_ms": bound(n_bytes, flops, F32_FLOPS)["bound_ms"]}


def decoder_tail_bound(B: int, G: int, backward: bool) -> dict:
    """The decoder tail at B cells and G genes (E=32, 4 heads, 16 latent
    tokens, hidden 88). Its products take bf16 operands, so the bf16 tensor-
    core peak: per (cell, gene) pair, scores over the head blocks M*E,
    probabilities times values H*M*E, the up projection 2E*Hd, and the wv and
    wmu dots, two operations per multiply-add (`function_bound_ms` for the
    backward: three times that). The backward's bound counts its products as
    its kernel runs them on the tensor cores: per pair the scores one k16
    step a head block (H*M*2HD), y (H*M*E), the up projection (2E*Hd), and
    in two bf16 passes (an f32 cotangent split hi + lo) d(hn) (2E*Hd), dp
    (E*H*M), dqp (H*M*HD), dw12 (2E*Hd), dvproj (H*M*E) and dkfull's head
    blocks (H*M*HD). Bytes: qp, q (G, E), kfull, vproj (B, H*M, E) and the
    weights in, the (B, G) logits out; the backward reads dy and writes a
    gradient of each input."""
    E, H, M, Hd = 32, 4, 16, 88
    HM, HD = H * M, E // H
    weights = 3 * E + 2 * E * Hd + Hd + 1
    inputs = 2 * G * E + 2 * B * H * M * E + weights
    flops = 2 * B * G * (M * E + H * M * E + 2 * E * Hd + Hd + E)
    if backward:
        n_bytes = 4 * (2 * inputs + B * G)
        as_run = 2 * B * G * (HM * 2 * HD + HM * E + 2 * E * Hd
                              + 2 * (2 * E * Hd + E * HM + HM * HD + 2 * E * Hd + HM * E + HM * HD))
        return {**bound(n_bytes, as_run, BF16_FLOPS),
                "function_bound_ms": bound(n_bytes, 3 * flops, BF16_FLOPS)["bound_ms"]}
    return bound(4 * (inputs + B * G), flops, BF16_FLOPS)


def time_in_turns(kernel, plain, reps: int) -> tuple:
    """(kernel ms, plain ms), each the mean of two CUDA-event timings of
    `reps` calls taken in turns (plain, kernel, kernel, plain) after a
    warm-up."""
    for f in (kernel, plain):
        cuda_ms(f, 2)
    turns = [cuda_ms(f, reps) for f in (plain, kernel, kernel, plain)]
    return (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2


# (T, R) of phase 1: the dentate sampler's rows (T = 16, R = 3B = 384) and a
# ragged R, the census DiT's (T = 64): the sampler's 3B rows at a generation
# batch of 16, the training step's B = 16, twice that, and a ragged R; and
# the long-latent pair's (T = 1,024: 3 x LONG_GEN_BATCH rows)
DIT_FWD_CASES = ((16, 384), (16, 5), (64, 3 * CENSUS_LDM_BATCH), (64, CENSUS_LDM_BATCH),
                 (64, 2 * CENSUS_LDM_BATCH), (64, 5), (1024, 12))
# the shapes whose forward is run twice and held to the same bits
DIT_FWD_REPEAT = ((16, 384), (64, 3 * CENSUS_LDM_BATCH))
# (T, R, design) of phase 1c: the dentate shapes first (T = 16, the row
# design the wrapper picks there), then the split design at the same shape
# for comparison, then the census DiT's (T = 64, the split design)
DIT_BWD_CASES = ((16, 128, None), (16, 5, None), (16, 128, "split"),
                 (64, CENSUS_LDM_BATCH, None), (64, 2 * CENSUS_LDM_BATCH, None), (64, 5, None))


def phase1_dit_block(seed: int) -> dict:
    """dit_block vs dit_block_reference (rtol = atol = 1e-4, f32 both, sums
    in other orders; the kernel's three TF32 passes a product keep f32
    accuracy) at DIT_FWD_CASES: the dentate sampler's rows (R = 3B = 384 of
    T = 16), the census sampler's (R = 48 of T = 64 at a generation batch of
    16) and training step's (R = 16, and 32), ragged Rs and the long-latent
    pair's (R = 12 of T = 1,024); the same bits on a second run at
    DIT_FWD_REPEAT; kernel and plain timed in turns. Returns {(T, R):
    {max_abs_err, ms, plain_ms}}."""
    import torch

    from scldm_torch.ops import fused_dit

    E, H = DIT["n_embed"], DIT["n_head"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = random_block_weights(g)
    out = {}
    for T, R in DIT_FWD_CASES:
        x = torch.randn(R, T, E, generator=g, device="cuda")
        c = torch.randn(R, E, generator=g, device="cuda")
        got = fused_dit.dit_block(x, c, w, H, EPS)
        torch.cuda.synchronize()
        want = fused_dit.dit_block_reference(x, c, w, H, EPS)
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **TOL)
        if (got - x).abs().max().item() < 1e-2:
            raise AssertionError("dit_block returned its input: the check would prove nothing")
        if (T, R) in DIT_FWD_REPEAT and not torch.equal(got, fused_dit.dit_block(x, c, w, H, EPS)):
            raise AssertionError(f"dit_block at T={T}, R={R}: a second run gave other bits")
        ms, plain_ms = time_in_turns(lambda: fused_dit.dit_block(x, c, w, H, EPS),
                                     lambda: fused_dit.dit_block_reference(x, c, w, H, EPS), 20)
        out[(T, R)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        b = dit_block_bound(R, backward=False, T=T)
        share = err / want.abs().max().item()
        log(f"phase1 dit_block T={T} R={R}: max_abs_err {err:.3e} ({share:.1e} of max)  kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}, three TF32 passes; {b['f32_bound_ms']:.4f} ms in f32 FMA)"
            + ("  same bits twice" if (T, R) in DIT_FWD_REPEAT else ""))
    return out


def encoder_pool_bound(B: int, N: int, backward: bool, dense: bool, E: int = 32, H: int = 4,
                       Q: int = 16) -> dict:
    """The encoder pool over B cells of N tokens (by default the reference
    encoder: E=32, 4 heads, 16 inducing queries; the census encoder: E=512, 8
    heads, 64). Its products take bf16 operands, so the bf16 tensor-core peak:
    per token the k and v projections (2E^2) and, per head, the scores and
    the pooled values against that head's block (Q*E each), two operations
    per multiply-add, three times that for the backward, which recomputes the
    forward; the LayerNorm and the exponentials are left out. Bytes: the
    counts (B, N) and the table (N, E) (dense) or the embeddings (B, N, E)
    (window), the query blocks and the weights in; num (B, Q, E), den and m
    (B, Q*H) out. The backward reads the same inputs with m, dnum and dden
    and writes a gradient of each input but the counts."""
    weights = Q * E + 2 * E + 2 * E * E
    table = N * E if dense else B * N * E
    src = table + (B * N if dense else 0)
    stats = B * Q * E + 2 * B * Q * H
    flops = 2 * B * N * (2 * E * E + 2 * Q * E)
    if backward:
        return bound(4 * (src + weights + stats + table + weights), 3 * flops, BF16_FLOPS)
    return bound(4 * (src + weights + stats), flops, BF16_FLOPS)


def held_bf16(what: str, got, want, near: float = 1e-4) -> tuple:
    """(max abs error, its share of the reference's largest magnitude, share
    of entries beyond `near` of it, `near`) of a kernel that rounds the same
    operands to bf16 as its plain version and sums in another order: such an
    order flips a bf16 rounding now and then, which moves an entry by up to
    about 1% of its tensor's largest magnitude. Raises beyond 1e-2 of that
    magnitude, or with more than 5% of the entries beyond `near` of it."""
    scale = want.abs().max().item()
    d = (got - want).abs()
    err, beyond = d.max().item(), (d > near * scale).float().mean().item()
    if scale == 0 or err > 1e-2 * scale or beyond > 5e-2:
        raise AssertionError(f"{what}: max abs err {err:.3e}, max |ref| {scale:.3e}, share beyond "
                             f"{near:g} of it {beyond:.2e}")
    return err, err / scale, beyond, near


def report_bf16(worst: dict) -> str:
    return ", ".join(f"{k} {e:.2e} ({r:.1e} of max, {b:.1e} beyond {n:g})"
                     for k, (e, r, b, n) in worst.items())


def phase1b_decoder_tail(seed: int) -> tuple[dict, dict]:
    """decoder_tail (forward and backward kernels) vs decoder_tail_reference
    with autograd, at the training step's shape and a ragged one.

    Both round the same operands to bf16 and accumulate in f32; a different
    summation order flips a bf16 rounding now and then, and a flip moves a
    logit or a gradient entry by up to about 1% of its tensor's largest
    magnitude. Held: every entry within 1e-2 of its tensor's largest
    magnitude, and at most 5% of the entries beyond 1e-4 of it (up to 1% seen,
    for the keys' gradient). The backward, which sums in a fixed order, is
    run twice at the training step's shape and held to the same bits."""
    import torch

    from scldm_torch.ops import fused_decoder as fd

    E, H, M, Hd = 32, 4, 16, 88
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=0.3, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    def run(fn, x):
        leaves = {k: t.detach().clone().requires_grad_() for k, t in x.items()}
        kf, vp = fd.build_attention_operands(leaves["k"], leaves["v"], leaves["wproj"], H)
        w = [leaves[n] for n in fd.WEIGHT_NAMES]
        out = fn(leaves["qp"], leaves["q"], kf, vp, w, H, 1e-8)
        (out * 0.1).tanh().sum().backward()
        return {"logits": out.detach(), **{k: t.grad for k, t in leaves.items()}}

    errs, timing = {}, {}
    for G, B in ((N_GENES, 128), (300, 19)):  # the training step's shape, and a ragged one
        raw = [rnd(E, shift=1.0), rnd(E), rnd(E, Hd), rnd(E, Hd), rnd(Hd, E), rnd(E, 1), rnd(1)]
        x = dict(qp=rnd(G, E), q=rnd(G, E), k=rnd(B, M, E), v=rnd(B, M, E), wproj=rnd(E, E),
                 **dict(zip(fd.WEIGHT_NAMES, (w.detach() for w in fd.pack_weights(*raw)))))
        got, want = run(fd.decoder_tail, x), run(fd.decoder_tail_reference, x)
        torch.cuda.synchronize()
        worst = {k: held_bf16(f"decoder_tail {k} at G={G}, B={B}", got[k], w)
                 for k, w in want.items()}
        for name, (err, *_) in worst.items():
            errs.setdefault("fwd" if name == "logits" else "bwd", []).append(err)
        log(f"phase1b decoder_tail G={G} B={B}: " + report_bf16(worst))

        kf, vp = fd.build_attention_operands(x["k"], x["v"], x["wproj"], H)
        w = [x[n] for n in fd.WEIGHT_NAMES]
        dy = rnd(B, G, scale=1.0)
        args = (x["qp"], x["q"], kf, vp, w)
        if G == N_GENES:  # no atomics: the backward repeats its bits
            runs = [fd.decoder_tail_bwd(*args, dy, H, 1e-8) for _ in range(2)]
            flat = [[*r[:4], *r[4]] for r in runs]
            if not all(torch.equal(a, b) for a, b in zip(*flat)):
                raise AssertionError(f"decoder_tail_bwd at G={G}, B={B}: a second run gave "
                                     "other bits")
            log(f"phase1b decoder_tail_bwd G={G} B={B}: the same bits twice")
            del runs, flat
        leaves = [t.detach().clone().requires_grad_() for t in (*args[:4], *w)]
        graph = fd.decoder_tail_reference(*leaves[:4], leaves[4:], H, 1e-8)
        fns = {
            "fwd": (lambda: fd.decoder_tail_fwd(*args, H, 1e-8),
                    lambda: fd.decoder_tail_reference(*args, H, 1e-8)),
            "bwd": (lambda: fd.decoder_tail_bwd(*args, dy, H, 1e-8),
                    lambda: torch.autograd.grad(graph, leaves, dy, retain_graph=True)),
        }
        for part, (kernel, plain) in fns.items():
            for f in (kernel, plain):
                cuda_ms(f, 2)  # warm-up
            turns = [cuda_ms(f, 10) for f in (plain, kernel, kernel, plain)]
            timing[(part, G)] = ((turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2)
            log(f"phase1b decoder_tail_{part} G={G} B={B}: kernel {timing[(part, G)][0]:.4f} ms  "
                f"plain {timing[(part, G)][1]:.4f} ms")
        del graph
    return tuple(
        {"max_abs_err": max(errs[part]), "ms": timing[(part, N_GENES)][0],
         "plain_ms": timing[(part, N_GENES)][1]}
        for part in ("fwd", "bwd")
    )


def phase1c_dit_block_bwd(seed: int) -> dict:
    """dit_block_bwd vs dit_block_backward_reference (autograd through the
    plain block) at the dentate LDM step's shape (R = 128 rows of T = 16,
    the row design), the census step's (R = 16 of T = 64, the split
    design, and 32), ragged Rs, and the split design at the dentate shape. dx
    and dc at rtol = atol = 1e-4; each weight gradient within 1e-4 of its
    tensor's largest magnitude: f32 both, the weight gradients summed over
    R*T tokens in other orders. Returns {(T, R, design): {max_abs_err, ms, plain_ms}}."""
    import torch

    from scldm_torch.ops import fused_dit

    E, H = DIT["n_embed"], DIT["n_head"]
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    w = random_block_weights(g)
    out = {}
    for T, R, design in DIT_BWD_CASES:
        x, dy = (torch.randn(R, T, E, generator=g, device="cuda") for _ in range(2))
        c = torch.randn(R, E, generator=g, device="cuda")
        dx, dc, dw = fused_dit.dit_block_bwd(x, c, w, dy, H, EPS, design=design)
        torch.cuda.synchronize()
        rx, rc, rw = fused_dit.dit_block_backward_reference(x, c, w, dy, H, EPS)
        torch.testing.assert_close(dx, rx, **TOL)
        torch.testing.assert_close(dc, rc, **TOL)
        worst, report = 0.0, []
        for name, got, want in [("dx", dx, rx), ("dc", dc, rc),
                                *((k, dw[k], rw[k]) for k in fused_dit.WEIGHT_NAMES)]:
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            if name not in ("dx", "dc") and (scale == 0 or err > 1e-4 * scale):
                raise AssertionError(f"dit_block_bwd {name} at T={T}, R={R}: max abs err "
                                     f"{err:.3e}, max |ref| {scale:.3e}")
            worst = max(worst, err)
            report.append(f"{name} {err:.2e} (max {scale:.2e})")
        used = design or fused_dit.pick_design(T, E, H, HIDDEN, backward=True)
        ms, plain_ms = time_in_turns(
            lambda: fused_dit.dit_block_bwd(x, c, w, dy, H, EPS, design=design),
            lambda: fused_dit.dit_block_backward_reference(x, c, w, dy, H, EPS), 10)
        out[(T, R, design)] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}
        b = dit_block_bound(R, backward=True, T=T)
        log(f"phase1c dit_block_bwd T={T} R={R} ({used} design): " + ", ".join(report))
        log(f"phase1c dit_block_bwd T={T} R={R} ({used} design): kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return out


# The forward rounds each exponential to bf16 against its tile's running max,
# the plain version against the final max; the dense pool's zero-count genes
# are identical rows whose roundings then move num together, not at random:
# up to 1.5e-3 of its largest magnitude, 8.8% of the entries beyond 1e-4 of
# it and 1.1% beyond 3e-4 at parse1m (chip run on an H100). So num is held
# to 3e-4 where the other outputs are held to 1e-4.
POOL_NUM_NEAR = 3e-4
# The wide window pool's LayerNorm-gain gradient sums dx2 * xhat over every
# token, terms of both signs that mostly cancel, so each bf16 rounding that
# another summation order flips upstream (x2, k, the scores' cotangents, dk,
# dv, dx2) weighs more in it than in any other output: its largest gap was
# 1.8e-4 to 3.6e-4 of its largest magnitude, but 5% to 52% of its entries
# were beyond 1e-4 of it, the more the fewer the tokens (chip run on an H100;
# host emulation of the kernels: 7.4% beyond 1e-4, none beyond 1e-3). So it
# is held to 1e-3 where the other gradients are held to 1e-4.
POOL_LN_GAIN_NEAR = 1e-3


def pool_outputs_and_grads(fn, counts, x, cot, H: int) -> dict:
    """(num, den, m) of the pool `fn` (its kernels or its plain version;
    dense with `counts`, else the window) and the gradients of the table or
    embeddings, the raw queries and the weights for the cotangents `cot` of
    num and den, through `build_query_operand` as the MCAB takes them."""
    import torch

    from scldm_torch.ops import fused_encoder as fe

    leaves = {k: t.detach().clone().requires_grad_() for k, t in x.items()}
    qfull = fe.build_query_operand(leaves["q"], H)
    args = (leaves["src"],) if counts is None else (counts, leaves["src"])
    num, den, m = fn(*args, qfull, [leaves[k] for k in fe.WEIGHT_NAMES], H, EPS)
    torch.autograd.backward((num, den), cot)
    return {"fwd": {"num": num.detach(), "den": den.detach(), "m": m},
            "bwd": {f"d{k}": t.grad for k, t in leaves.items()}}


def phase1d_encoder_pool(seed: int) -> dict:
    """The encoder-pool kernels, dense and window, forward and backward,
    against their plain versions with autograd, at the VAE steps' shapes
    (dense: B=128 over the parse1m / replogle G=2,000 genes; window: B=128
    over the dentate S=6,147-token window) and ragged ones, timing both;
    then the dense pool's pooled tokens against the module MCAB at a ragged
    shape where the zero-row correction is not 0 (G=300 genes, an S=250
    window). The kernels and the plain versions round the same operands to
    bf16: `held_bf16`'s bounds, with `POOL_NUM_NEAR` for num."""
    import numpy as np
    import torch

    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.ops import fused_encoder as fe
    from scldm_torch.ops.transforms import densify_expressed, widen_lean
    from scldm_torch.training.vae_task import fused_encoder_pooling
    from scldm_torch.utils.weights import init_reference_

    E, H, Q = 32, 4, 16
    g = torch.Generator(device="cuda").manual_seed(seed + 4)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    out = {}
    for variant, B, N in (("dense", 128, PARSE_GENES), ("dense", 19, 300),
                          ("window", 128, WINDOW), ("window", 19, 250)):
        dense = variant == "dense"
        x = dict(src=rnd(N, E) if dense else rnd(B, N, E), q=rnd(Q, E),
                 ln1g=rnd(1, E, scale=0.3, shift=1.0), ln1b=rnd(1, E, scale=0.3),
                 wk=rnd(E, E, scale=E**-0.5), wv=rnd(E, E, scale=E**-0.5))
        # about 60% of the genes expressed, Poisson(3) counts
        counts = (torch.poisson(torch.full((B, N), 3.0, device="cuda"), generator=g)
                  * (torch.rand(B, N, generator=g, device="cuda") < 0.6)) if dense else None
        cot = (rnd(B, Q, E), rnd(B, Q * H))
        pool, reference = ((fe.encoder_pool, fe.encoder_pool_reference) if dense
                           else (fe.window_pool, fe.window_pool_reference))
        got, want = (pool_outputs_and_grads(fn, counts, x, cot, H) for fn in (pool, reference))
        torch.cuda.synchronize()
        worst = {part: {k: held_bf16(f"{variant} pool {k} at B={B}, N={N}", got[part][k], w,
                                     POOL_NUM_NEAR if k == "num" else 1e-4)
                        for k, w in want[part].items()} for part in want}
        log(f"phase1d {variant}_pool B={B} N={N}: " + report_bf16({**worst["fwd"], **worst["bwd"]}))

        pre = (counts,) if dense else ()
        qfull = fe.build_query_operand(x["q"], H)
        w = [x[k] for k in fe.WEIGHT_NAMES]
        fwd, bwd, fwd_ref, bwd_ref = (
            (fe.encoder_pool_fwd, fe.encoder_pool_bwd, fe.encoder_pool_reference,
             fe.encoder_pool_backward_reference) if dense else
            (fe.window_pool_fwd, fe.window_pool_bwd, fe.window_pool_reference,
             fe.window_pool_backward_reference))
        stats = (want["fwd"]["m"], *cot)
        fns = {
            "fwd": (lambda: fwd(*pre, x["src"], qfull, w, H, EPS),
                    lambda: fwd_ref(*pre, x["src"], qfull, w, H, EPS)),
            "bwd": (lambda: bwd(*pre, x["src"], qfull, w, *stats, H, EPS),
                    lambda: bwd_ref(*pre, x["src"], qfull, w, *stats, H, EPS)),
        }
        for part, (kernel, plain) in fns.items():
            for f in (kernel, plain):
                cuda_ms(f, 2)  # warm-up
            turns = [cuda_ms(f, 10) for f in (plain, kernel, kernel, plain)]
            ms = ((turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2)
            log(f"phase1d {variant}_pool_{part} B={B} N={N}: kernel {ms[0]:.4f} ms  "
                f"plain {ms[1]:.4f} ms")
            if B == 128:
                out[f"{variant}_{part}"] = {"max_abs_err": max(e for e, *_ in worst[part].values()),
                                            "ms": ms[0], "plain_ms": ms[1]}

    # the pooled tokens with G - S = 50 zero rows taken out, on MCAB weights
    # with non-zero LayerNorm biases, against the module on the window
    G, S, B = 300, 250, 19
    vae = init_reference_(build_transformer_vae(n_genes=G, n_layer=1, device="cuda"),
                          torch.Generator(device="cuda").manual_seed(seed))
    with torch.no_grad():
        for p in vae.encoder.ca_layer.parameters():
            p.add_(rnd(*p.shape, scale=0.2))
        lean = widen_lean({k: torch.from_numpy(v).to("cuda") for k, v in
                           lean_batch(np.random.default_rng(seed), B, G, S, (5, S)).items()})
        c_sub, g_sub = lean["counts_subset"], lean["genes_subset"]
        before = fe.ENCODER_POOL_FWD_LAUNCHES.count
        got = fused_encoder_pooling(vae, densify_expressed(g_sub, c_sub, G), S)
        want = vae.encoder.ca_layer(vae.input_layer(c_sub, g_sub))
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    if fe.ENCODER_POOL_FWD_LAUNCHES.count != before + 1 or not err < 0.02 * scale:
        raise AssertionError(f"dense pooling at G={G}, S={S}: max abs err {err:.3e} against the "
                             f"module, max |ref| {scale:.3e}")
    log(f"phase1d dense pooling G={G} S={S} B={B} ({G - S} zero rows taken out): kernel vs module "
        f"MCAB max abs err {err:.3e} ({err / scale:.1e} of max)")
    return out


# (B, S, E, H, Q) of phase 1d's wide window pool: the census encoder's window
# (configs/model/vae_census.yaml, bench_census.py's batch), a ragged B and S at
# that width, and the E = 256 encoder of tests/test_fused_encoder.py:227-254
WIDE_POOL_CASES = ((CENSUS_BATCH, CENSUS_WINDOW, 512, 8, 64), (3, 1_030, 512, 8, 64),
                   (4, 600, 256, 4, 16))


def phase1d_wide_window_pool(seed: int) -> dict:
    """The wide window-pool kernels (forward and backward,
    `window_pool_wide.cu`) against their plain version with autograd at
    WIDE_POOL_CASES, `held_bf16`'s bounds with `POOL_NUM_NEAR` for num, as
    the narrow design, and `POOL_LN_GAIN_NEAR` for dln1g; kernel and plain
    timed in turns at the census shape.
    Returns {"fwd", "bwd"}: {max_abs_err, ms, plain_ms} at that shape."""
    import torch

    from scldm_torch.ops import fused_encoder as fe

    g = torch.Generator(device="cuda").manual_seed(seed + 8)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    out = {}
    for B, N, E, H, Q in WIDE_POOL_CASES:
        x = dict(src=rnd(B, N, E), q=rnd(Q, E), ln1g=rnd(1, E, scale=0.3, shift=1.0),
                 ln1b=rnd(1, E, scale=0.3), wk=rnd(E, E, scale=E**-0.5),
                 wv=rnd(E, E, scale=E**-0.5))
        cot = (rnd(B, Q, E), rnd(B, Q * H))
        got = pool_outputs_and_grads(fe.window_pool, None, x, cot, H)
        torch.cuda.synchronize()
        want = pool_outputs_and_grads(fe.window_pool_reference, None, x, cot, H)
        near = {"num": POOL_NUM_NEAR, "dln1g": POOL_LN_GAIN_NEAR}
        worst = {part: {k: held_bf16(f"wide window pool {k} at B={B}, S={N}, E={E}", got[part][k],
                                     w, near.get(k, 1e-4))
                        for k, w in want[part].items()} for part in want}
        log(f"phase1d wide window_pool B={B} S={N} E={E} H={H} Q={Q}: "
            + report_bf16({**worst["fwd"], **worst["bwd"]}))
        del got, want
        if (B, N) != (CENSUS_BATCH, CENSUS_WINDOW):
            continue
        qfull = fe.build_query_operand(x["q"], H)
        w = [x[k] for k in fe.WEIGHT_NAMES]
        m = fe.window_pool_reference(x["src"], qfull, w, H, EPS)[2]
        fns = {"fwd": (lambda: fe.window_pool_fwd(x["src"], qfull, w, H, EPS),
                       lambda: fe.window_pool_reference(x["src"], qfull, w, H, EPS)),
               "bwd": (lambda: fe.window_pool_bwd(x["src"], qfull, w, m, *cot, H, EPS),
                       lambda: fe.window_pool_backward_reference(x["src"], qfull, w, m, *cot, H,
                                                                 EPS))}
        for part, (kernel, plain) in fns.items():
            ms, plain_ms = time_in_turns(kernel, plain, 10)
            b = encoder_pool_bound(B, N, part == "bwd", False, E, H, Q)
            out[part] = {"max_abs_err": max(e for e, *_ in worst[part].values()), "ms": ms,
                         "plain_ms": plain_ms}
            log(f"phase1d wide window_pool_{part} B={B} S={N} E={E}: kernel {ms:.4f} ms  plain "
                f"{plain_ms:.4f} ms  bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        del x, cot, fns
        torch.cuda.empty_cache()
    return out


def swiglu_vec_bound(R: int, E: int, Hd: int, backward: bool) -> dict:
    """swiglu_vec over R rows, exact f32, so the f32 peak: the up projection
    2*R*E*2Hd plus the wv contraction 2*R*Hd operations, three times that for
    the backward; the gate is left out. Bytes: x, w12 and wv in and out (R)
    out; the backward reads ds (R) too and writes dx (R, E), dw12 and dwv."""
    flops = 2 * R * E * 2 * Hd + 2 * R * Hd
    weights = E * 2 * Hd + Hd
    if backward:
        return bound(4 * (R * E + R + weights + R * E + weights), 3 * flops, F32_FLOPS)
    return bound(4 * (R * E + weights + R), flops, F32_FLOPS)


def check_f32_matmuls() -> None:
    """The plain versions are the f32 yardstick: no TF32 in their products."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on: the plain f32 versions would not be exact f32")


def phase1e_swiglu_vec(seed: int) -> tuple[dict, dict]:
    """swiglu_vec (forward and backward kernels) against its plain version
    with autograd at the census decoder's rows (R = 16 x 36,601, E = 512, Hd =
    1,408), a ragged R and a hidden width off the kernel's 64-column tile;
    out, dx, dw12 and dwv each within 1e-4 of its tensor's largest magnitude
    (f32 both, sums in another order); kernel and plain timed in turns."""
    import torch

    from scldm_torch.ops import fused_swiglu as fs

    check_f32_matmuls()
    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    census = (CENSUS_BATCH * CENSUS["n_genes"], CENSUS["n_embed"], CENSUS_HIDDEN)
    errs, timing = {}, {}
    for R, E, Hd in (census, (1_001, 512, 1_408), (1_001, 512, 1_400)):
        x = torch.randn(R, E, generator=g, device="cuda")
        w12 = torch.randn(E, 2 * Hd, generator=g, device="cuda") * E**-0.5
        wv = torch.randn(Hd, 1, generator=g, device="cuda") * Hd**-0.5
        ds = torch.randn(R, 1, generator=g, device="cuda")
        got = {"out": fs.swiglu_vec_fwd(x, w12, wv),
               **dict(zip(("dx", "dw12", "dwv"), fs.swiglu_vec_bwd(x, w12, wv, ds)))}
        torch.cuda.synchronize()
        want = {"out": fs.swiglu_vec_reference(x, w12, wv), **dict(zip(
            ("dx", "dw12", "dwv"), fs.swiglu_vec_backward_reference(x, w12, wv, ds)))}
        report = []
        for k, w in want.items():
            err, scale = (got[k] - w).abs().max().item(), w.abs().max().item()
            if scale == 0 or err > 1e-4 * scale:
                raise AssertionError(f"swiglu_vec {k} at R={R}, E={E}, Hd={Hd}: max abs err "
                                     f"{err:.3e}, max |ref| {scale:.3e}")
            part = "fwd" if k == "out" else "bwd"
            errs[part] = max(errs.get(part, 0.0), err)
            report.append(f"{k} {err:.2e} ({err / scale:.1e} of max)")
        log(f"phase1e swiglu_vec R={R} E={E} Hd={Hd}: " + ", ".join(report))
        del got, want
        if (R, E, Hd) != census:
            continue
        fns = {"fwd": (lambda: fs.swiglu_vec_fwd(x, w12, wv),
                       lambda: fs.swiglu_vec_reference(x, w12, wv)),
               "bwd": (lambda: fs.swiglu_vec_bwd(x, w12, wv, ds),
                       lambda: fs.swiglu_vec_backward_reference(x, w12, wv, ds))}
        for part, (kernel, plain) in fns.items():
            for f in (kernel, plain):
                cuda_ms(f, 1)  # warm-up
            turns = [cuda_ms(f, 2) for f in (plain, kernel, kernel, plain)]
            timing[part] = ((turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2)
            log(f"phase1e swiglu_vec_{part} R={R} E={E} Hd={Hd}: kernel {timing[part][0]:.4f} ms  "
                f"plain {timing[part][1]:.4f} ms")
        del x, w12, wv, ds, fns
        torch.cuda.empty_cache()
    return tuple({"max_abs_err": errs[part], "ms": timing[part][0], "plain_ms": timing[part][1]}
                 for part in ("fwd", "bwd"))


def flash_cross_bound(B: int, G: int, E: int = 512, M: int = 64) -> dict:
    """Flash cross-attention of B batch elements over G genes into M keys, E
    columns. Its products take bf16 operands, so the bf16 tensor-core peak:
    the scores and the probabilities times the values, B*G*M*E multiply-adds
    each, two operations per multiply-add. Bytes: qp (G, E), k and v (B, M,
    E) in and y (B, G, E) out, f32."""
    return bound(4 * (G * E + 2 * B * M * E + B * G * E), 4 * B * G * M * E, BF16_FLOPS)


def phase1f_flash_cross(seed: int) -> dict:
    """flash_cross_attention's forward kernel against flash_cross_reference
    at the census sampler's cross block (2B = 32 cells, G = 36,601 genes, E =
    512, 8 heads, M = 64 latent tokens) and a ragged shape (G = 300 off the
    256-gene tile, B = 3 off the 8-cell tile), held by `held_bf16`'s
    rule (both round the same operands and the probabilities to bf16, and sum
    in other orders); kernel and plain timed in turns, and, as the library
    yardstick, `F.scaled_dot_product_attention` on the same operands in bf16
    with the queries expanded over the batch (timed here; the port never
    calls it)."""
    import torch
    import torch.nn.functional as F

    from scldm_torch.ops import fused_cross as fc

    E, H, M = CENSUS["n_embed"], CENSUS["n_head_cross"], CENSUS["n_inducing_points"]
    hd = E // H
    g = torch.Generator(device="cuda").manual_seed(seed + 8)
    out = {}
    for B, G in ((2 * CENSUS_LDM_BATCH, CENSUS["n_genes"]), (3, 300)):
        qp = torch.randn(G, E, generator=g, device="cuda")
        k, v = (torch.randn(B, M, E, generator=g, device="cuda") for _ in range(2))
        got = fc.flash_cross_fwd(qp, k, v, H)
        torch.cuda.synchronize()
        want = fc.flash_cross_reference(qp, k, v, H)
        worst = held_bf16(f"flash_cross at B={B}, G={G}", got, want)
        log(f"phase1f flash_cross B={B} G={G} E={E} H={H} M={M}: " + report_bf16({"y": worst}))
        del got, want
        if G != CENSUS["n_genes"]:
            continue
        ms, plain_ms = time_in_turns(lambda: fc.flash_cross_fwd(qp, k, v, H),
                                     lambda: fc.flash_cross_reference(qp, k, v, H), 5)
        qb = qp.reshape(G, H, hd).transpose(0, 1).bfloat16()[None].expand(B, H, G, hd).contiguous()
        kb, vb = (t.reshape(B, M, H, hd).transpose(1, 2).bfloat16().contiguous() for t in (k, v))
        library = lambda: F.scaled_dot_product_attention(qb, kb, vb)  # noqa: E731
        cuda_ms(library, 2)
        library_ms = (cuda_ms(library, 5) + cuda_ms(library, 5)) / 2
        b = flash_cross_bound(B, G, E, M)
        out = {"max_abs_err": worst[0], "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms}
        log(f"phase1f flash_cross B={B} G={G}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"library (scaled_dot_product_attention, bf16) {library_ms:.4f} ms  bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        del qb, kb, vb
    torch.cuda.empty_cache()
    return out


# the VAE's trunks (configs/model/vae_base.yaml): E = 32, 8 heads, hidden 88,
# 8 layers, over its T = 16 latent tokens; the step's B = 128 rows, and a ragged R
TRUNK = dict(T=16, E=32, H=8, hidden=88, L=8)
TRUNK_ROWS = (128, 5)


def fused_trunk_bound(R: int, T: int, E: int, hidden: int, L: int, backward: bool,
                      save: bool = False) -> dict:
    """The whole trunk at R rows of T tokens, f32. Operations: two per
    multiply-add of its products (per token and layer qkv 3E^2, the
    projection E^2, scores and probabilities times values 2TE, the SwiGLU
    3E*hidden), three times that for the backward, which recomputes the
    forward; the elementwise work is left out. Bytes: each input read once
    and each output written once (forward x, the weights and out, with
    `save` also xs (L, R, T, E); backward xs, dy and the weights in, dx and
    the weight gradients out)."""
    weights = L * (4 * E + 4 * E * E + 3 * E * hidden)
    flops = 2 * R * T * L * (4 * E * E + 2 * T * E + 3 * E * hidden)
    act = R * T * E
    if backward:
        return bound(4 * (L * act + 2 * act + 2 * weights), 3 * flops, F32_FLOPS)
    return bound(4 * (2 * act + weights + (L * act if save else 0)), flops, F32_FLOPS)


def random_trunk_weights(g) -> dict:
    """One trunk's kernel weights, drawn from `g` on the card: per name a
    list of L tensors, matrices (out, in); LayerNorm affines near 1 and 0."""
    import torch

    E, Hd = TRUNK["E"], TRUNK["hidden"]

    def rnd(*shape, scale, offset=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + offset

    shapes = {"wqkv": (3 * E, E), "wproj": (E, E), "w1": (Hd, E), "w2": (Hd, E), "wmlp": (E, Hd)}
    w = {k: [rnd(*s, scale=s[1] ** -0.5) for _ in range(TRUNK["L"])] for k, s in shapes.items()}
    for k in ("g1", "g2"):
        w[k] = [rnd(E, scale=0.1, offset=1.0) for _ in range(TRUNK["L"])]
    for k in ("b1", "b2"):
        w[k] = [rnd(E, scale=0.1) for _ in range(TRUNK["L"])]
    return w


def held_f32(what: str, got, want, rel: float = 1e-4) -> float:
    """The largest error of `got` as a share of `want`'s largest magnitude;
    raises beyond `rel` of it (f32 both, sums in other orders)."""
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if scale == 0 or err > rel * scale:
        raise AssertionError(f"{what}: max abs err {err:.3e}, max |ref| {scale:.3e}")
    return err


def phase1g_fused_trunk(seed: int) -> dict:
    """The whole-trunk kernels against their plain versions at the VAE
    step's trunk (R = 128 rows of T = 16 tokens, E = 32, 8 heads, hidden 88,
    L = 8) and a ragged R = 5: the forward (row 9) and the saving forward
    (row 10, out and xs) against `fused_trunk_reference` and its layer
    inputs, the backward (row 11: dx and the nine weight gradients of every
    layer, from the kernel's xs) against autograd through the plain trunk;
    each tensor within 1e-4 of its largest magnitude (f32 both, sums in
    other orders), its error reported as a share of that. Kernel and plain
    timed in turns at R = 128. Returns {"fwd" | "fwd_saving" | "bwd":
    {max_abs_err, ms, plain_ms}}."""
    import torch

    from scldm_torch.ops import fused_trunk as ft

    T, E, H, Hd, L = (TRUNK[k] for k in ("T", "E", "H", "hidden", "L"))
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    w = random_trunk_weights(g)
    out = {}
    for R in TRUNK_ROWS:
        x, dy = (torch.randn(R, T, E, generator=g, device="cuda") for _ in range(2))
        y9 = ft.fused_trunk_blocks(x, w, H, EPS)
        y10, xs = ft.fused_trunk_fwd_saving(x, w, H, EPS)
        dx, dw = ft.fused_trunk_bwd(xs, w, dy, H, EPS)
        torch.cuda.synchronize()
        want, want_xs = ft.fused_trunk_saving_reference(x, w, H, EPS)
        rdx, rdw = ft.fused_trunk_backward_reference(x, w, dy, H, EPS)
        if (want - x).abs().max().item() < 1e-2:
            raise AssertionError("the trunk returned its input: the check would prove nothing")
        checks = [("fwd", "out", y9, want), ("fwd_saving", "out", y10, want),
                  ("fwd_saving", "xs", xs, want_xs), ("bwd", "dx", dx, rdx)]
        checks += [("bwd", f"d{k}", dw[k][layer], rdw[k][layer])
                   for k in ft.TRUNK_WEIGHT_NAMES for layer in range(L)]
        errs, rel = {}, {}
        for part, what, got, ref in checks:
            e = held_f32(f"fused_trunk {part} {what} R={R}", got, ref)
            errs[part] = max(errs.get(part, 0.0), e)
            rel[what] = max(rel.get(what, 0.0), e / ref.abs().max().item())
        log(f"phase1g fused_trunk R={R} T={T} E={E} H={H} hidden={Hd} L={L}: errors as a share "
            "of each tensor's largest: " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
        if R != TRUNK_ROWS[0]:
            continue
        timed = {
            "fwd": (lambda: ft.fused_trunk_blocks(x, w, H, EPS),
                    lambda: ft.fused_trunk_reference(x, w, H, EPS), 20),
            "fwd_saving": (lambda: ft.fused_trunk_fwd_saving(x, w, H, EPS),
                           lambda: ft.fused_trunk_saving_reference(x, w, H, EPS), 20),
            "bwd": (lambda: ft.fused_trunk_bwd(xs, w, dy, H, EPS),
                    lambda: ft.fused_trunk_backward_reference(x, w, dy, H, EPS), 10),
        }
        for part, (kernel, plain, reps) in timed.items():
            ms, plain_ms = time_in_turns(kernel, plain, reps)
            out[part] = {"max_abs_err": errs[part], "ms": ms, "plain_ms": plain_ms}
            b = fused_trunk_bound(R, T, E, Hd, L, part == "bwd", part == "fwd_saving")
            log(f"phase1g fused_trunk_{part} R={R}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    # the backward sums its weight gradients in a fixed order: the same bits twice
    again = ft.fused_trunk_bwd(xs, w, dy, H, EPS)
    if not (torch.equal(again[0], dx) and all(torch.equal(a, b) for k in ft.TRUNK_WEIGHT_NAMES
                                               for a, b in zip(again[1][k], dw[k]))):
        raise AssertionError("fused_trunk_bwd gave other bits on the same inputs")
    return out


def swiglu_gate_bound(R: int, E: int, H: int, backward: bool) -> dict:
    """fused_swiglu_gate over R rows, exact f32, so the f32 peak: the up
    projection 2*R*E*2H operations, three times that for the backward; the
    gate is left out. Bytes: x, w1 and w2 in and g (R, H) out; the backward
    reads dg (R, H) too and writes dx (R, E), dw1 and dw2."""
    flops = 2 * R * E * 2 * H
    weights = 2 * E * H
    if backward:
        return bound(4 * (R * E + weights + R * H + R * E + weights), 3 * flops, F32_FLOPS)
    return bound(4 * (R * E + weights + R * H), flops, F32_FLOPS)


def phase1h_swiglu_gate(seed: int) -> tuple[dict, dict, tuple]:
    """fused_swiglu_gate, its own public entry point (no task dispatches it,
    in JAX or here), at the census cross block's MLP (JAX's
    benchmarks/bench_swiglu.py: R = 16 x 36,601 rows, E = 512, H = 1,408) and
    two ragged shapes: one differentiable call (the path, its launches
    counted from 0), its output and gradients each within 1e-4 of its
    tensor's largest magnitude from the plain version with autograd (f32
    both, TF32 off, sums in another order); kernel and plain timed in turns
    at the census shape. Returns (fwd, bwd, the path's launches)."""
    import torch

    from scldm_torch.ops import fused_swiglu as fs

    check_f32_matmuls()
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    census = (CENSUS_BATCH * CENSUS["n_genes"], CENSUS["n_embed"], CENSUS_HIDDEN)
    errs, timing, launches = {}, {}, None
    for R, E, H in (census, (1_001, 512, 1_408), (1_001, 512, 1_400)):
        x = torch.randn(R, E, generator=g, device="cuda")
        w1 = torch.randn(E, H, generator=g, device="cuda") * E**-0.5
        w2 = torch.randn(E, H, generator=g, device="cuda") * E**-0.5
        dg = torch.randn(R, H, generator=g, device="cuda")
        leaves = [t.clone().requires_grad_() for t in (x, w1, w2)]
        if (R, E, H) == census:
            fs.SWIGLU_GATE_FWD_LAUNCHES.reset()
            fs.SWIGLU_GATE_BWD_LAUNCHES.reset()
        out = fs.fused_swiglu_gate(*leaves)
        out.backward(dg)
        torch.cuda.synchronize()
        if (R, E, H) == census:
            launches = (fs.SWIGLU_GATE_FWD_LAUNCHES.count, fs.SWIGLU_GATE_BWD_LAUNCHES.count)
            if launches != (1, 1):
                raise AssertionError(f"fused_swiglu_gate launches {launches} in one call")
        got = {"out": out.detach(), **dict(zip(("dx", "dw1", "dw2"), (t.grad for t in leaves)))}
        del out, leaves
        want = {"out": fs.swiglu_reference(x, w1, w2), **dict(zip(
            ("dx", "dw1", "dw2"), fs.swiglu_gate_backward_reference(x, w1, w2, dg)))}
        report = []
        for k, w in want.items():
            err, scale = (got[k] - w).abs().max().item(), w.abs().max().item()
            if scale == 0 or err > 1e-4 * scale:
                raise AssertionError(f"fused_swiglu_gate {k} at R={R}, E={E}, H={H}: max abs err "
                                     f"{err:.3e}, max |ref| {scale:.3e}")
            part = "fwd" if k == "out" else "bwd"
            errs[part] = max(errs.get(part, 0.0), err)
            report.append(f"{k} {err:.2e} ({err / scale:.1e} of max)")
        log(f"phase1h fused_swiglu_gate R={R} E={E} H={H}: " + ", ".join(report))
        del got, want
        if (R, E, H) == census:
            fns = {"fwd": (lambda: fs.swiglu_gate_fwd(x, w1, w2),
                           lambda: fs.swiglu_reference(x, w1, w2)),
                   "bwd": (lambda: fs.swiglu_gate_bwd(x, w1, w2, dg),
                           lambda: fs.swiglu_gate_backward_reference(x, w1, w2, dg))}
            for part, (kernel, plain) in fns.items():
                for f in (kernel, plain):
                    cuda_ms(f, 1)  # warm-up
                turns = [cuda_ms(f, 2) for f in (plain, kernel, kernel, plain)]
                timing[part] = ((turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2)
                b = swiglu_gate_bound(R, E, H, part == "bwd")
                log(f"phase1h fused_swiglu_gate_{part} R={R} E={E} H={H}: kernel "
                    f"{timing[part][0]:.4f} ms  plain {timing[part][1]:.4f} ms  bound "
                    f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
            del fns
        del x, w1, w2, dg
        torch.cuda.empty_cache()
    return (*({"max_abs_err": errs[part], "ms": timing[part][0], "plain_ms": timing[part][1]}
              for part in ("fwd", "bwd")), launches)


def flash_attention_bound(B: int, M: int, S: int, H: int, D: int, elem: int = 4) -> dict:
    """Flash attention of q (B, M, H, D) over k and v (B, S, H, D), operands
    of `elem` bytes. Operations: the scores and the probabilities times the
    values, B*H*M*S*D multiply-adds each, two operations per multiply-add, as
    the kernel runs them on the tensor cores: with f32 operands three TF32
    passes a product at the TF32 peak, with bf16 operands one pass at the
    bf16 peak. Bytes: q, k and v in and the output out."""
    flops = 4 * B * H * M * S * D
    ops, peak = (3 * flops, TF32_FLOPS) if elem == 4 else (flops, BF16_FLOPS)
    return bound(elem * (2 * B * M * H * D + 2 * B * S * H * D), ops, peak)


# (B, M, S, H, D, dtype) of phase 1i: JAX's standalone shape
# (benchmarks/check_flash_compiled.py), the long-latent MCAB (16 cells, 1,024
# inducing points over the 4,096-token window, 8 heads of 64), its encoder
# and decoder self-attention, the DiT's rows (a generation batch of 4: 12
# rows, 8 heads of 32), a ragged shape, short keys with narrow heads, bf16
FLASH_CASES = ((2, 2_048, 4_096, 4, 64, "float32"), (16, 1_024, 4_096, 8, 64, "float32"),
               (16, 1_024, 1_024, 8, 64, "float32"), (12, 1_024, 1_024, 8, 32, "float32"),
               (3, 1_030, 1_500, 2, 40, "float32"), (2, 70, 100, 3, 4, "float32"),
               (3, 1_030, 1_500, 2, 64, "bfloat16"))
FLASH_TIMED = FLASH_CASES[:4]
FLASH_ROW = FLASH_CASES[1]  # the kernels line's shape: the main path's largest launch


def sdpa_kernel_names(fn) -> str:
    """The device kernels one call of `fn` launches, from the profiler: which
    backend `scaled_dot_product_attention` picked."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    return ", ".join(names) or "none recorded"


def phase1i_flash_attention(seed: int) -> dict:
    """The flash attention kernel against flash_attention_reference (sdpa's
    plain path) at FLASH_CASES: within 2e-4 of the output's largest magnitude
    in f32 and 2e-2 with bf16 operands (JAX's tests/test_pallas.py; streaming
    against materialized softmax, and the plain version rounds bf16
    probabilities), and the same bits on a second run. At FLASH_TIMED the
    kernel and the plain version timed in turns, and, as the library
    yardstick, `F.scaled_dot_product_attention` on the same f32 operands
    with TF32 off (timed here; the port never calls it), with the kernels it
    launched. Returns FLASH_ROW's figures."""
    import torch
    import torch.nn.functional as F

    from scldm_torch.ops import flash_attention as fa

    check_f32_matmuls()
    g = torch.Generator(device="cuda").manual_seed(seed + 10)
    out = {}
    for case in FLASH_CASES:
        B, M, S, H, D, dtype = case
        dt = getattr(torch, dtype)
        q = torch.randn(B, M, H, D, generator=g, device="cuda").to(dt)
        k, v = (torch.randn(B, S, H, D, generator=g, device="cuda").to(dt) for _ in range(2))
        got = fa.flash_attention(q, k, v)
        again = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = fa.flash_attention_reference(q, k, v)
        rel = 2e-4 if dt == torch.float32 else 2e-2
        err = held_f32(f"flash_attention at {case}", got.float(), want.float(), rel)
        if not torch.equal(got, again):
            raise AssertionError(f"flash_attention at {case}: two runs gave different bits")
        scale = want.float().abs().max().item()
        log(f"phase1i flash_attention B={B} M={M} S={S} H={H} D={D} {dtype}: max abs err "
            f"{err:.3e} ({err / scale:.1e} of max), the same bits twice")
        del got, again, want
        if case in FLASH_TIMED:
            ms, plain_ms = time_in_turns(lambda: fa.flash_attention(q, k, v),
                                         lambda: fa.flash_attention_reference(q, k, v), 3)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
            cuda_ms(library, 2)
            library_ms = (cuda_ms(library, 3) + cuda_ms(library, 3)) / 2
            b = flash_attention_bound(B, M, S, H, D)
            log(f"phase1i flash_attention B={B} M={M} S={S} H={H} D={D}: kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  library (scaled_dot_product_attention, f32) "
                f"{library_ms:.4f} ms [{sdpa_kernel_names(library)}]  bound {b['bound_ms']:.4f} "
                f"ms ({b['bound_by']})")
            if case == FLASH_ROW:
                out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms}
        del q, k, v
        torch.cuda.empty_cache()
    return out


def build_models(seed: int):
    import torch

    from scldm_torch.nn.nnets import DiT
    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.utils.weights import init_reference_

    vae = init_reference_(build_transformer_vae(n_genes=N_GENES, device="cuda"),
                          torch.Generator(device="cuda").manual_seed(seed))
    # the zero-init layers (adaLN, final linear) drawn too: a zero DiT is the identity
    dit = init_reference_(DiT(**DIT), torch.Generator().manual_seed(seed), zero_init=False)
    return vae.eval(), dit.to("cuda").eval()


def phase2_generation(seed: int, batch: int) -> int:
    """CFG generation through the kernels; returns the main path's launches."""
    import torch

    from scldm_torch.ops import fused_dit
    from scldm_torch.ops.transforms import canonical_gene_ids
    from scldm_torch.sampling.size_factors import SizeFactorSampler, constant_stats
    from scldm_torch.training.ldm_task import LDMTask
    from scldm_torch.transport import create_transport

    vae, dit = build_models(seed)
    task = LDMTask(vae, dit, create_transport())
    sfs = SizeFactorSampler(constant_stats({"clusters": N_CLUSTERS}, mu=8.6, sd=0.3))
    genes = canonical_gene_ids(N_GENES, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    cond = {"clusters": torch.randint(0, N_CLUSTERS, (batch,), generator=g, device="cuda")}

    launches = 0
    for method, steps in (("dopri5", 50), ("euler", 50)):
        fn = task.make_sample_fn(sfs, guidance_weight=GUIDANCE, sampling_method=method,
                                 num_steps=steps)
        fn(g, genes, cond)  # warm-up: library load, cuBLAS handles, allocator
        torch.cuda.synchronize()
        fused_dit.DIT_BLOCK_LAUNCHES.reset()
        t0 = time.perf_counter()
        counts, z = fn(g, genes, cond)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = fused_dit.DIT_BLOCK_LAUNCHES.count
        launches += n
        if counts.shape != (2 * batch, N_GENES) or z.shape != (2 * batch, DIT["seq_len"], 16):
            raise AssertionError(f"shapes counts {tuple(counts.shape)} z {tuple(z.shape)}")
        if not (torch.isfinite(counts).all() and torch.isfinite(z).all()):
            raise AssertionError("non-finite output")
        if not ((counts >= 0).all() and (counts == counts.round()).all()):
            raise AssertionError("counts are not non-negative integers")
        if fn.drift_evals <= 0 or n != dit.n_layer * fn.drift_evals:
            raise AssertionError(f"{n} dit_block launches for {fn.drift_evals} DiT evaluations")
        steps_note = f"dopri5 steps {fn.drift_evals // 7}, " if method == "dopri5" else ""
        log(f"phase2 {method}-{steps}: {2 * batch / dt:.1f} cells/s ({dt:.3f} s for "
            f"{2 * batch} cells), {steps_note}DiT evals {fn.drift_evals}, dit_block launches {n}, "
            f"counts {tuple(counts.shape)} mean {counts.mean().item():.4f}, z {tuple(z.shape)}")
    return launches


def phase2_reference(seed: int, batch: int) -> float:
    """One DiT evaluation of the sampler at its shape: the kernel path
    (`fused_dit_forward` on the CFG segments) against the plain module path
    (`DiT.forward_with_cfg_batched`, every block an `nn.layers.Block`)."""
    import torch

    from scldm_torch.nn.nnets import build_cfg_segments, combine_cfg_segments
    from scldm_torch.ops.fused_dit import fused_dit_forward

    _, dit = build_models(seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randn(2 * batch, DIT["seq_len"], 16, generator=g, device="cuda")
    t = torch.rand(2 * batch, generator=g, device="cuda")
    half = torch.randint(0, N_CLUSTERS, (batch,), generator=g, device="cuda")
    cond = {"clusters": torch.cat([half, half])}
    with torch.inference_mode():
        seg_x, seg_t, seg_cond, scale_segments, b, h = build_cfg_segments(
            x, t, cond, GUIDANCE, dit.class_vocab_sizes, dit.condition_strategy)
        got = combine_cfg_segments(fused_dit_forward(dit, seg_x, seg_t, seg_cond),
                                   scale_segments, b, h)
        want = dit.forward_with_cfg_batched(x, t, cond, GUIDANCE)
    err = (got - want).abs().max().item()
    # eight blocks chained, each f32 with its sums in another order
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    log(f"phase2 reference: one DiT evaluation at {2 * batch} cells ({seg_x.shape[0]} rows), "
        f"kernel path vs module path: max abs err {err:.3e}, max |out| "
        f"{want.abs().max().item():.3e}")
    return err


def lean_batch(rng, batch: int, n_genes: int = N_GENES, window: int = WINDOW,
               nnz_range: tuple = (1500, 4000)) -> dict:
    """bench.py's lean wire batch: the expressed genes (about 1.5k to 4k per
    cell at dentate width) and their counts, uint16, zero-padded to the
    window."""
    import numpy as np

    genes = np.zeros((batch, window), np.uint16)
    counts = np.zeros((batch, window), np.uint16)
    for i in range(batch):
        nnz = int(rng.integers(*nnz_range))
        genes[i, :nnz] = np.sort(rng.choice(n_genes, size=nnz, replace=False)) + 1
        counts[i, :nnz] = rng.poisson(3.0, size=nnz) + 1
    return {"genes_subset": genes, "counts_subset": counts,
            "library_size": counts.astype(np.float32).sum(1, keepdims=True)}


def phase3_training(seed: int, batch: int) -> tuple[int, int]:
    """VAE training steps through the tail kernels; returns the main path's
    (forward, backward) launches."""
    import numpy as np
    import torch

    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.ops import fused_decoder as fd
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.utils.weights import init_reference_

    vae = init_reference_(build_transformer_vae(n_genes=N_GENES, device="cuda"),
                          torch.Generator(device="cuda").manual_seed(seed))
    task = VAETask(vae, num_training_steps=10_000)
    state = task.init_state(torch.Generator(device="cuda").manual_seed(seed))
    rng = np.random.default_rng(seed)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in lean_batch(rng, batch).items()}
               for _ in range(TRAIN_STEPS + 1)]
    if not task._use_fused(batches[0]):
        raise AssertionError("the lean CUDA batch did not select the kernel path")

    state, mets = task.train_step(state, batches[0])  # warm-up: library load, allocator
    torch.cuda.synchronize()
    fd.DECODER_TAIL_FWD_LAUNCHES.reset()
    fd.DECODER_TAIL_BWD_LAUNCHES.reset()
    losses = []
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, mets = task.train_step(state, b)
        losses.append(mets["train_loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd, bwd = fd.DECODER_TAIL_FWD_LAUNCHES.count, fd.DECODER_TAIL_BWD_LAUNCHES.count
    losses = torch.stack(losses)
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses.tolist()}")
    n = TRAIN_STEPS
    if fwd != n or bwd != n:
        raise AssertionError(f"{fwd} forward and {bwd} backward tail launches in {n} steps")
    log(f"phase3 VAE training B={batch} G={N_GENES} S={WINDOW}: {batch * n / dt:.1f} train "
        f"cells/s, {dt / n * 1e3:.2f} ms/step over {n} steps; losses "
        f"{losses[0].item():.2f} -> {losses[-1].item():.2f}, grad_norm "
        f"{mets['grad_norm'].item():.3f}, lr_mult {mets['lr_mult'].item():.5f}; tail launches "
        f"fwd {fwd} bwd {bwd}")

    compare_vae_paths("phase3", task, VAETask(vae, fused_decoder=False), batches[-1])
    return fwd, bwd


def vae_loss_and_grads(task, batch) -> tuple:
    """One step's loss and gradients of `task` on its module's parameters."""
    vae = task.vae
    vae.zero_grad(set_to_none=True)
    loss, _ = task.loss(batch)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in vae.named_parameters() if p.grad is not None}
    vae.zero_grad(set_to_none=True)
    return loss.item(), grads


def compare_vae_paths(phase: str, task, module_task, batch) -> None:
    """One step's loss and gradients, kernel path vs module path, same
    parameters and batch; JAX's own bounds between the two
    (tests/test_fused_decoder.py, tests/test_fused_encoder.py:109-130): loss
    within 1%, each gradient within 0.08 of its largest magnitude."""
    (lk, gk), (lm, gm) = vae_loss_and_grads(task, batch), vae_loss_and_grads(module_task, batch)
    if abs(lk - lm) > 0.01 * abs(lm):
        raise AssertionError(f"loss: kernel path {lk} vs module path {lm}")
    worst = (0.0, "")
    for name, want in gm.items():
        if name == "decoder_head.params.bias":
            continue  # softmax-invariant: its true gradient is 0, both are noise
        rel = (gk[name] - want).abs().max().item() / (want.abs().max().item() + 1e-12)
        if rel > 0.08:
            raise AssertionError(f"gradient {name}: kernel vs module path {rel:.3e} of its max")
        worst = max(worst, (rel, name))
    log(f"{phase} reference: one step, kernel path vs module path: loss {lk:.4f} vs {lm:.4f} "
        f"({abs(lk - lm) / abs(lm):.2e} relative), {len(gm)} gradients, largest gap "
        f"{worst[0]:.3e} of its max ({worst[1]})")


def phase5_parse1m_training(seed: int, batch: int) -> dict:
    """VAE training at parse1m / replogle width through the dense encoder
    pool and the tail kernels, then through the window pool
    (`VAETask(fused_pool=True)`); returns the main path's launches of each
    pool and tail kernel."""
    import numpy as np
    import torch

    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.ops import fused_decoder as fd
    from scldm_torch.ops import fused_encoder as fe
    from scldm_torch.training.metrics import global_norm
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.utils.weights import init_reference_

    vae = init_reference_(build_transformer_vae(n_genes=PARSE_GENES, device="cuda"),
                          torch.Generator(device="cuda").manual_seed(seed))
    task = VAETask(vae, num_training_steps=10_000)
    state = task.init_state(torch.Generator(device="cuda").manual_seed(seed))
    rng = np.random.default_rng(seed)
    # 500 to 1,999 expressed genes a cell (benchmarks/bench_batch_scaling.py:25)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in
                lean_batch(rng, batch, PARSE_GENES, PARSE_GENES, (500, PARSE_GENES)).items()}
               for _ in range(TRAIN_STEPS + 1)]
    counters = {"encoder_pool_fwd": fe.ENCODER_POOL_FWD_LAUNCHES,
                "encoder_pool_bwd": fe.ENCODER_POOL_BWD_LAUNCHES,
                "decoder_tail_fwd": fd.DECODER_TAIL_FWD_LAUNCHES,
                "decoder_tail_bwd": fd.DECODER_TAIL_BWD_LAUNCHES}

    state, mets = task.train_step(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    losses = []
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, mets = task.train_step(state, b)
        losses.append(mets["train_loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    losses = torch.stack(losses)
    n = TRAIN_STEPS
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses.tolist()}")
    if any(v != n for v in launches.values()):
        raise AssertionError(f"launches in {n} steps: {launches}")
    log(f"phase5 VAE training B={batch} G={PARSE_GENES} S={PARSE_GENES}: {batch * n / dt:.1f} "
        f"train cells/s, {dt / n * 1e3:.2f} ms/step over {n} steps; losses "
        f"{losses[0].item():.2f} -> {losses[-1].item():.2f}, grad_norm "
        f"{mets['grad_norm'].item():.3f}; launches {launches}")
    compare_vae_paths("phase5", task, VAETask(vae, fused_decoder=False), batches[-1])

    # the window pool: VAETask(fused_pool=True) on the module path
    pool_task = VAETask(vae, num_training_steps=10_000, fused_pool=True, fused_decoder=False)
    pool_state = pool_task.init_state(torch.Generator(device="cuda").manual_seed(seed + 1))
    pool_task.train_step(pool_state, batches[0])  # warm-up
    torch.cuda.synchronize()
    fe.WINDOW_POOL_FWD_LAUNCHES.reset()
    fe.WINDOW_POOL_BWD_LAUNCHES.reset()
    t0 = time.perf_counter()
    for b in batches[1:1 + POOL_STEPS]:
        pool_state, mets = pool_task.train_step(pool_state, b)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches["window_pool_fwd"] = fe.WINDOW_POOL_FWD_LAUNCHES.count
    launches["window_pool_bwd"] = fe.WINDOW_POOL_BWD_LAUNCHES.count
    if launches["window_pool_fwd"] != POOL_STEPS or launches["window_pool_bwd"] != POOL_STEPS:
        raise AssertionError(f"{launches} in {POOL_STEPS} fused_pool steps")
    if not torch.isfinite(mets["train_loss"]):
        raise AssertionError(f"fused_pool step: loss {mets['train_loss'].item()}")
    log(f"phase5 VAETask(fused_pool=True, fused_decoder=False): {dt / POOL_STEPS * 1e3:.2f} "
        f"ms/step over {POOL_STEPS} steps, loss {mets['train_loss'].item():.2f}, window pool "
        f"launches fwd {launches['window_pool_fwd']} bwd {launches['window_pool_bwd']}")
    # JAX's bounds between the window pool and the module path
    # (tests/test_fused_encoder.py:227-254): loss 5e-3 relative, grad norm 2%
    (lp, gp), (lm, gm) = (vae_loss_and_grads(t, batches[-1])
                          for t in (pool_task, VAETask(vae, fused_decoder=False)))
    norm_p, norm_m = global_norm(gp.values()).item(), global_norm(gm.values()).item()
    if abs(lp - lm) > 5e-3 * abs(lm) or abs(norm_p - norm_m) > 0.02 * norm_m:
        raise AssertionError(f"fused_pool loss {lp}, grad norm {norm_p}; module path {lm}, "
                             f"{norm_m}")
    log(f"phase5 reference: one step, window pool vs module path: loss {lp:.4f} vs {lm:.4f} "
        f"({abs(lp - lm) / abs(lm):.2e} relative), grad norm {norm_p:.4f} vs {norm_m:.4f} "
        f"({abs(norm_p - norm_m) / norm_m:.2e})")
    return launches


def phase6_census_training(seed: int) -> tuple[int, int]:
    """VAE training at census width through the algebraic tail and the
    swiglu_vec kernels, then the plain algebraic path for comparison; returns
    the main path's (forward, backward) swiglu_vec launches."""
    import numpy as np
    import torch

    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.ops import fused_swiglu as fs
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.utils.weights import init_reference_

    check_f32_matmuls()
    vae = init_reference_(build_transformer_vae(**CENSUS, device="cuda"),
                          torch.Generator(device="cuda").manual_seed(seed))
    opt = dict(learning_rate=3e-4, betas=(0.9, 0.95))  # vae_census.yaml's optimizer
    task = VAETask(vae, **opt, algebraic_fused_gate=True)
    rng = np.random.default_rng(seed)
    G, B, S = CENSUS["n_genes"], CENSUS_BATCH, CENSUS_WINDOW
    # benchmarks/bench_census.py's synth_batch: 2,048 to 4,095 expressed genes a cell
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in
                lean_batch(rng, B, G, S, (S // 2, S)).items()} for _ in range(CENSUS_STEPS + 1)]
    if not (task._use_algebraic(batches[0]) and task.algebraic_fused_gate
            and not task._use_fused(batches[0])):
        raise AssertionError("the census batch did not select the algebraic tail with the gate")

    def run(t, label: str) -> dict:
        state = t.init_state(torch.Generator(device="cuda").manual_seed(seed))
        t0 = time.perf_counter()
        state, first = t.train_step(state, batches[0])  # warm-up: library load, allocator
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        n = CENSUS_STEPS if warm <= 2.0 else 3
        fs.SWIGLU_VEC_FWD_LAUNCHES.reset()
        fs.SWIGLU_VEC_BWD_LAUNCHES.reset()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        t0 = time.perf_counter()
        for b in batches[1:1 + n]:
            state, mets = t.train_step(state, b)
            losses.append(mets["train_loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = (fs.SWIGLU_VEC_FWD_LAUNCHES.count, fs.SWIGLU_VEC_BWD_LAUNCHES.count)
        losses = torch.stack(losses)
        with torch.no_grad():
            again = t.loss(batches[0])[0].item()  # the warm-up batch after the steps
        if not torch.isfinite(losses).all() or not again < first["train_loss"].item():
            raise AssertionError(f"{label}: losses {losses.tolist()}, warm-up batch "
                                 f"{first['train_loss'].item()} -> {again}")
        note = "" if n == CENSUS_STEPS else f" (warm-up step {warm:.2f} s > 2 s: {n} steps)"
        log(f"phase6 census VAE {label} B={B} G={G} S={S}: {B * n / dt:.1f} train cells/s, "
            f"{dt / n * 1e3:.2f} ms/step over {n} steps{note}; losses {losses[0].item():.2f} -> "
            f"{losses[-1].item():.2f}, warm-up batch {first['train_loss'].item():.2f} -> "
            f"{again:.2f}; peak memory {peak / 2**30:.2f} GiB; swiglu_vec launches fwd "
            f"{launches[0]} bwd {launches[1]}")
        del state
        return {"n": n, "launches": launches}

    fused = run(task, "fused gate")
    if fused["launches"] != (fused["n"], fused["n"]):
        raise AssertionError(f"swiglu_vec launches {fused['launches']} in {fused['n']} steps")
    plain_task = VAETask(vae, **opt)
    torch.cuda.empty_cache()
    plain = run(plain_task, "plain algebraic")
    if plain["launches"] != (0, 0):
        raise AssertionError(f"the plain algebraic path launched swiglu_vec {plain['launches']}")

    # one step, fused gate against the plain algebraic path: loss within 1e-5
    # relative, each gradient within 1e-3 of its largest magnitude (f32 both;
    # the head's bias is softmax-invariant, its true gradient 0, both noise)
    (lk, gk), (lp, gp) = vae_loss_and_grads(task, batches[-1]), vae_loss_and_grads(plain_task,
                                                                                  batches[-1])
    if abs(lk - lp) > 1e-5 * abs(lp):
        raise AssertionError(f"census loss: fused gate {lk} vs plain algebraic path {lp}")
    worst = (0.0, "")
    for name, want in gp.items():
        if name == "decoder_head.params.bias":
            continue
        rel = (gk[name] - want).abs().max().item() / (want.abs().max().item() + 1e-30)
        if rel > 1e-3:
            raise AssertionError(f"census gradient {name}: fused gate vs plain path {rel:.3e} "
                                 f"of its max")
        worst = max(worst, (rel, name))
    log(f"phase6 reference: one step, fused gate vs plain algebraic path: loss {lk:.4f} vs "
        f"{lp:.4f} ({abs(lk - lp) / abs(lp):.2e} relative), {len(gp)} gradients, largest gap "
        f"{worst[0]:.3e} of its max ({worst[1]})")
    return fused["launches"]


CENSUS_POOL_STEPS = 3  # timed VAETask(fused_pool=True) census steps, after one warm-up step
CENSUS_POOL_TURN = 2  # steps a turn of the fused pool / module MCAB comparison


def phase6b_census_fused_pool(seed: int) -> tuple[int, int]:
    """The census VAE on the module path with the MCAB pooling as the wide
    window pool (`VAETask(fused_pool=True, algebraic_tail=False)`, JAX's
    opt-in, which bench_census.py pairs with --no-algebraic-tail): a warm-up
    step and CENSUS_POOL_STEPS timed steps, each launching the wide pool once
    each way; the step against the module MCAB (`fused_pool=False`) in turns
    with each arm's peak memory; one step's loss and gradients held against
    the module MCAB. Returns the path's (forward, backward) launches."""
    import numpy as np
    import torch

    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.ops import fused_encoder as fe
    from scldm_torch.training.metrics import global_norm
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.utils.weights import init_reference_

    check_f32_matmuls()
    vae = init_reference_(build_transformer_vae(**CENSUS, device="cuda"),
                          torch.Generator(device="cuda").manual_seed(seed))
    opt = dict(learning_rate=3e-4, betas=(0.9, 0.95))  # vae_census.yaml's optimizer
    task = VAETask(vae, **opt, fused_pool=True, algebraic_tail=False)
    module = VAETask(vae, **opt, algebraic_tail=False)
    G, B, S = CENSUS["n_genes"], CENSUS_BATCH, CENSUS_WINDOW
    rng = np.random.default_rng(seed + 1)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in
                lean_batch(rng, B, G, S, (S // 2, S)).items()}
               for _ in range(CENSUS_POOL_STEPS + 1)]
    if not (task.fused_pool and not task._use_algebraic(batches[0])
            and not task._use_fused(batches[0])):
        raise AssertionError("VAETask(fused_pool=True, algebraic_tail=False) did not take the "
                             "module path with the window pool")
    state = task.init_state(torch.Generator(device="cuda").manual_seed(seed))
    state, first = task.train_step(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    fe.WINDOW_POOL_WIDE_FWD_LAUNCHES.reset()
    fe.WINDOW_POOL_WIDE_BWD_LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, mets = task.train_step(state, b)
        losses.append(mets["train_loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = CENSUS_POOL_STEPS
    launches = (fe.WINDOW_POOL_WIDE_FWD_LAUNCHES.count, fe.WINDOW_POOL_WIDE_BWD_LAUNCHES.count)
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses)
    if launches != (n, n):
        raise AssertionError(f"wide window pool launches {launches} in {n} fused_pool steps")
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite census fused_pool loss: {losses.tolist()}")
    log(f"phase6b census VAE VAETask(fused_pool=True, algebraic_tail=False) B={B} G={G} S={S}: "
        f"{B * n / dt:.1f} train cells/s, {dt / n * 1e3:.2f} ms/step over {n} steps; losses "
        f"{first['train_loss'].item():.2f} (warm-up) -> {losses[-1].item():.2f}; peak memory "
        f"{peak / 2**30:.2f} GiB; wide window pool launches fwd {launches[0]} bwd {launches[1]}")

    module_state = module.init_state(torch.Generator(device="cuda").manual_seed(seed))
    module.train_step(module_state, batches[0])  # warm-up
    torch.cuda.synchronize()

    def turn(t, st) -> tuple:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for b in batches[1:1 + CENSUS_POOL_TURN]:
            t.train_step(st, b)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) / CENSUS_POOL_TURN * 1e3,
                torch.cuda.max_memory_allocated() / 2**30)

    turns = [turn(*arm) for arm in ((module, module_state), (task, state), (task, state),
                                    (module, module_state))]
    on, off = (turns[1][0] + turns[2][0]) / 2, (turns[0][0] + turns[3][0]) / 2
    log(f"phase6b in turns (module MCAB, window pool, window pool, module MCAB; "
        f"{CENSUS_POOL_TURN} steps a turn): window pool {on:.2f} ms/step ({B * 1e3 / on:.1f} "
        f"cells/s, peak {turns[1][1]:.2f} GiB), module MCAB {off:.2f} ms/step "
        f"({B * 1e3 / off:.1f} cells/s, peak {turns[0][1]:.2f} GiB), on / off {on / off:.3f}; "
        f"turns ms {[round(t, 2) for t, _ in turns]}")
    del state, module_state
    torch.cuda.empty_cache()

    # JAX's bounds between the window pool and the module path
    # (tests/test_fused_encoder.py:227-254): loss 5e-3 relative, grad norm 2%
    (lp, gp), (lm, gm) = (vae_loss_and_grads(t, batches[-1]) for t in (task, module))
    norm_p, norm_m = global_norm(gp.values()).item(), global_norm(gm.values()).item()
    if abs(lp - lm) > 5e-3 * abs(lm) or abs(norm_p - norm_m) > 0.02 * norm_m:
        raise AssertionError(f"census fused_pool loss {lp}, grad norm {norm_p}; module MCAB {lm}, "
                             f"{norm_m}")
    worst = max(((gp[k] - w).abs().max().item() / (w.abs().max().item() + 1e-12), k)
                for k, w in gm.items() if k != "decoder_head.params.bias")
    log(f"phase6b reference: one step, window pool vs module MCAB: loss {lp:.6f} vs {lm:.6f} "
        f"({abs(lp - lm) / abs(lm):.2e} relative), grad norm {norm_p:.4f} vs {norm_m:.4f} "
        f"({abs(norm_p - norm_m) / norm_m:.2e}), {len(gm)} gradients, largest gap {worst[0]:.3e} "
        f"of its max ({worst[1]})")
    del vae, task, module, gp, gm
    torch.cuda.empty_cache()
    return launches


def compare_ldm_paths(phase: str, task, module_task, batch, g) -> None:
    """One step's loss and gradients, kernel path vs module path, same
    parameters, batch and draws (from `g`); JAX's bounds between its two
    paths (tests/test_fused_dit.py): loss 1e-4 relative, grad norm 1e-3."""
    import torch

    from scldm_torch.training.metrics import global_norm

    dit = task.dit
    B, T, E_in = len(batch["clusters"]), dit.seq_len, dit.n_embed_input
    noise = {"t": torch.rand(B, generator=g, device="cuda"),
             "x0": torch.randn(B, T, E_in, generator=g, device="cuda"),
             "drop_mask": torch.rand(B, generator=g, device="cuda") < dit.cfg_dropout_prob}
    runs = []
    for t in (task, module_task):
        dit.zero_grad(set_to_none=True)
        loss = t.loss(batch, g, noise)
        loss.backward()
        grads = {k: p.grad.clone() for k, p in dit.named_parameters()}
        runs.append((loss.item(), global_norm(grads.values()).item(), grads))
    dit.zero_grad(set_to_none=True)
    (lk, nk, gk), (lm, nm, gm) = runs
    if abs(lk - lm) > 1e-4 * abs(lm) or abs(nk - nm) > 1e-3 * nm:
        raise AssertionError(f"{phase}: kernel path loss {lk}, grad norm {nk}; module path {lm}, "
                             f"{nm}")
    worst = max(((gk[k] - w).abs().max().item() / (w.abs().max().item() + 1e-12), k)
                for k, w in gm.items())
    log(f"{phase} reference: one step, kernel path vs module path: loss {lk:.6f} vs {lm:.6f} "
        f"({abs(lk - lm) / abs(lm):.2e} relative), grad norm {nk:.6f} vs {nm:.6f} "
        f"({abs(nk - nm) / nm:.2e}), {len(gm)} gradients, largest gap {worst[0]:.3e} of its "
        f"max ({worst[1]})")


def ldm_step_segments(task, state, batches, n: int = 3) -> dict:
    """The segments of `n` LDM training steps on the host clock, each ending
    in a synchronize: the frozen encode alone, the loss (which encodes
    again), the backward, and the clip, optimizer and EMA
    (`LDMTask.apply_gradients`, the step's own code); ms per step."""
    import torch

    seg = {"encode": [], "loss": [], "backward": [], "apply_gradients": []}
    for i in range(n):
        b = batches[i % len(batches)]
        state.optimizer.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        task._encode(b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = task.loss(b, state.generator)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        task.apply_gradients(state)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, dt in zip(seg, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            seg[k].append(round(dt * 1e3, 2))
    return seg


def ldm_batches(rng, batch: int, n: int) -> list:
    """n lean wire batches on the card, each with `clusters` labels drawn
    from 0..N_CLUSTERS-1: the LDM training step's input."""
    import torch

    return [{**{k: torch.from_numpy(v).to("cuda") for k, v in lean_batch(rng, batch).items()},
             "clusters": torch.from_numpy(rng.integers(0, N_CLUSTERS, batch)).to("cuda")}
            for _ in range(n)]


def phase4_ldm_training(seed: int, batch: int) -> tuple[int, int, int]:
    """LDM training steps through the DiT block kernels, then a generation
    call from the trained state's EMA weights; returns the main path's
    (dit_block launches in training, dit_block_bwd launches, dit_block
    launches in generation)."""
    import numpy as np
    import torch

    from scldm_torch.ops import fused_dit
    from scldm_torch.ops import fused_encoder as fe
    from scldm_torch.ops.transforms import canonical_gene_ids
    from scldm_torch.sampling.size_factors import SizeFactorSampler, constant_stats
    from scldm_torch.training.ldm_task import LDMTask
    from scldm_torch.transport import create_transport

    vae, dit = build_models(seed)
    task = LDMTask(vae, dit, create_transport())
    state = task.init_state(torch.Generator(device="cuda").manual_seed(seed))
    rng = np.random.default_rng(seed)
    batches = ldm_batches(rng, batch, TRAIN_STEPS + 1)

    state, mets = task.train_step(state, batches[0])  # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()
    fused_dit.DIT_BLOCK_LAUNCHES.reset()
    fused_dit.DIT_BLOCK_BWD_LAUNCHES.reset()
    losses = []
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, mets = task.train_step(state, b)
        losses.append(mets["train_loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd, bwd = fused_dit.DIT_BLOCK_LAUNCHES.count, fused_dit.DIT_BLOCK_BWD_LAUNCHES.count
    losses = torch.stack(losses)
    n, L = TRAIN_STEPS, dit.n_layer
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite LDM training loss: {losses.tolist()}")
    if fwd != L * n or bwd != L * n:
        raise AssertionError(f"{fwd} dit_block and {bwd} dit_block_bwd launches in {n} steps "
                             f"of {L} blocks")
    if state.ema.step != n + 1 or state.step != n + 1:
        raise AssertionError(f"EMA step {state.ema.step}, train step {state.step} after {n + 1}")
    log(f"phase4 LDM training B={batch}: {batch * n / dt:.1f} train cells/s, "
        f"{dt / n * 1e3:.2f} ms/step over {n} steps; losses {losses[0].item():.4f} -> "
        f"{losses[-1].item():.4f}, grad_norm {mets['grad_norm'].item():.4f}, lr_mult "
        f"{mets['lr_mult'].item():.5f}; launches dit_block {fwd} dit_block_bwd {bwd}, EMA step "
        f"{state.ema.step}")

    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    compare_ldm_paths("phase4", task, LDMTask(vae, dit, create_transport(), fused_training=False),
                      batches[-1], g)

    # the frozen encode through the window pool (LDMTask(fused_encode=True))
    # against the module encode on the same batch; JAX's bound between the two
    # (tests/test_fused_encoder.py:279-308): 0.02 of the largest latent
    fe_task = LDMTask(vae, dit, create_transport(), fused_encode=True)
    fe.WINDOW_POOL_FWD_LAUNCHES.reset()
    z_k = fe_task._encode(batches[-1])
    torch.cuda.synchronize()
    encode_launches = fe.WINDOW_POOL_FWD_LAUNCHES.count
    z_m = task._encode(batches[-1])
    err, scale = (z_k - z_m).abs().max().item(), z_m.abs().max().item()
    if encode_launches != 1 or not err < 0.02 * scale:
        raise AssertionError(f"fused encode: {encode_launches} window pool launches, max abs err "
                             f"{err:.3e} against the module encode, max |z| {scale:.3e}")
    walls = {}
    for t in (task, fe_task, fe_task, task):  # in turns, each timed over 5 encodes
        t0 = time.perf_counter()
        for _ in range(5):
            t._encode(batches[-1])
        torch.cuda.synchronize()
        walls.setdefault(t.fused_encode, []).append(round((time.perf_counter() - t0) / 5 * 1e3, 3))
    log(f"phase4 fused_encode: latents vs the module encode max abs err {err:.3e} "
        f"({err / scale:.1e} of max); encode ms, window pool {walls[True]} vs module "
        f"{walls[False]}")

    # generation from the trained state's EMA weights
    fn = task.make_sample_fn(SizeFactorSampler(constant_stats({"clusters": N_CLUSTERS}, mu=8.6,
                                                              sd=0.3)),
                             guidance_weight=GUIDANCE, sampling_method="dopri5", num_steps=50)
    genes = canonical_gene_ids(N_GENES, device="cuda")
    cond = {"clusters": batches[-1]["clusters"]}
    fused_dit.DIT_BLOCK_LAUNCHES.reset()
    counts, z = fn(g, genes, cond, state=state)
    torch.cuda.synchronize()
    gen = fused_dit.DIT_BLOCK_LAUNCHES.count
    if counts.shape != (2 * batch, N_GENES) or not torch.isfinite(z).all():
        raise AssertionError(f"EMA generation: counts {tuple(counts.shape)}, z finite "
                             f"{bool(torch.isfinite(z).all())}")
    if not ((counts >= 0).all() and (counts == counts.round()).all()):
        raise AssertionError("EMA generation: counts are not non-negative integers")
    if fn.drift_evals <= 0 or gen != L * fn.drift_evals:
        raise AssertionError(f"{gen} dit_block launches for {fn.drift_evals} DiT evaluations")
    log(f"phase4 generation from the EMA weights (dopri5): counts {tuple(counts.shape)} mean "
        f"{counts.mean().item():.4f}, DiT evals {fn.drift_evals}, dit_block launches {gen}")
    return fwd, bwd, gen, encode_launches


def build_census_ldm_models(seed: int):
    """The census VAE (frozen, eval) and the census DiT on the card, random
    weights from CUDA generators, the DiT's adaLN and final layers non-zero."""
    import torch

    from scldm_torch.nn.nnets import DiT
    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.utils.weights import init_reference_

    vae = init_reference_(build_transformer_vae(**CENSUS, device="cuda"),
                          torch.Generator(device="cuda").manual_seed(seed)).eval()
    dit = init_reference_(DiT(**CENSUS_DIT).to("cuda"),
                          torch.Generator(device="cuda").manual_seed(seed + 1), zero_init=False)
    return vae, dit


def census_ldm_batches(rng, n: int) -> list:
    """n census LDM batches on the card: benchmarks/bench_census.py's
    synth_batch cells (2,048 to 4,095 expressed genes over a 4,096-token
    window) with `clusters` labels from 0..N_CLUSTERS-1."""
    import torch

    G, B, S = CENSUS["n_genes"], CENSUS_LDM_BATCH, CENSUS_WINDOW
    return [{**{k: torch.from_numpy(v).to("cuda") for k, v in
                lean_batch(rng, B, G, S, (S // 2, S)).items()},
             "clusters": torch.from_numpy(rng.integers(0, N_CLUSTERS, B)).to("cuda")}
            for _ in range(n)]


def phase7_census_ldm(seed: int) -> dict:
    """Census LDM training and generation: the census VAE, frozen, under the
    census DiT (T = 64 latent tokens), random weights from CUDA generators
    with non-zero adaLN. Trains CENSUS_STEPS steps of B = 16 through the DiT
    block kernels (the backward's split design) and prints the segment split of three
    synchronised steps; holds one step against the module path; generates
    euler-50 at a generation batch of 16 through the algebraic decode;
    holds generate_from_noise with `fused_blocks` against the module
    denoiser on the same noise (latents and mu within 1e-3); holds the module
    decode with the flash-cross gate on against off (mu by `held_bf16`'s
    rule). Returns the main path's launches of dit_block, dit_block_bwd and
    flash_cross."""
    import numpy as np
    import torch

    from scldm_torch.ops import attention
    from scldm_torch.ops import fused_cross as fc
    from scldm_torch.ops import fused_dit
    from scldm_torch.ops import fused_encoder as fe
    from scldm_torch.ops.transforms import canonical_gene_ids
    from scldm_torch.sampling.size_factors import SizeFactorSampler, constant_stats
    from scldm_torch.training.ldm_task import LDMTask
    from scldm_torch.transport import create_transport

    vae, dit = build_census_ldm_models(seed)
    task = LDMTask(vae, dit, create_transport())
    if not (task.algebraic_decode and task.algebraic_vw_fold and not task.algebraic_fused_gate):
        raise AssertionError("the census LDMTask did not take the algebraic decode with the fold")
    G, B, S, L = CENSUS["n_genes"], CENSUS_LDM_BATCH, CENSUS_WINDOW, dit.n_layer
    batches = census_ldm_batches(np.random.default_rng(seed), CENSUS_STEPS + 1)

    # -- training
    state = task.init_state(torch.Generator(device="cuda").manual_seed(seed))
    state, mets = task.train_step(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    fused_dit.DIT_BLOCK_LAUNCHES.reset()
    fused_dit.DIT_BLOCK_BWD_LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, mets = task.train_step(state, b)
        losses.append(mets["train_loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = CENSUS_STEPS
    launches = {"dit_block": fused_dit.DIT_BLOCK_LAUNCHES.count,
                "dit_block_bwd": fused_dit.DIT_BLOCK_BWD_LAUNCHES.count}
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses)
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite census LDM loss: {losses.tolist()}")
    if launches != {"dit_block": L * n, "dit_block_bwd": L * n} or state.ema.step != n + 1:
        raise AssertionError(f"{launches} in {n} steps of {L} blocks, EMA step {state.ema.step}")
    log(f"phase7 census LDM training B={B} G={G} S={S} T={dit.seq_len}: {B * n / dt:.1f} train "
        f"cells/s, {dt / n * 1e3:.2f} ms/step over {n} steps; losses {losses[0].item():.4f} -> "
        f"{losses[-1].item():.4f}, grad_norm {mets['grad_norm'].item():.4f}; launches {launches}; "
        f"peak memory {peak / 2**30:.2f} GiB")
    seg = ldm_step_segments(task, state, batches[1:4])
    log(f"phase7 segments ms (3 steps, each synchronised; the loss encodes again): {seg}")
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    compare_ldm_paths("phase7", task, LDMTask(vae, dit, create_transport(), fused_training=False),
                      batches[-1], g)

    # -- the frozen encode through the wide window pool (LDMTask(fused_encode=True)),
    #    held against the module encode (JAX's bound, tests/test_fused_encoder.py:279-308:
    #    0.02 of the largest latent) and timed against it in turns; then the timed
    #    steps and the segment split through it
    fe_task = LDMTask(vae, dit, create_transport(), fused_encode=True)
    fe.WINDOW_POOL_WIDE_FWD_LAUNCHES.reset()
    z_k = fe_task._encode(batches[-1])
    torch.cuda.synchronize()
    encode_launches = fe.WINDOW_POOL_WIDE_FWD_LAUNCHES.count
    z_m = task._encode(batches[-1])
    err, scale = (z_k - z_m).abs().max().item(), z_m.abs().max().item()
    if encode_launches != 1 or not err < 0.02 * scale:
        raise AssertionError(f"census fused encode: {encode_launches} wide window pool launches, "
                             f"max abs err {err:.3e} against the module encode, max |z| "
                             f"{scale:.3e}")
    walls = {}
    for t in (task, fe_task, fe_task, task):  # in turns, each timed over 5 encodes
        t0 = time.perf_counter()
        for _ in range(5):
            t._encode(batches[-1])
        torch.cuda.synchronize()
        walls.setdefault(t.fused_encode, []).append(round((time.perf_counter() - t0) / 5 * 1e3, 3))
    log(f"phase7 fused_encode: latents vs the module encode max abs err {err:.3e} "
        f"({err / scale:.1e} of max); encode ms in turns, window pool {walls[True]} vs module "
        f"{walls[False]}")
    fe.WINDOW_POOL_WIDE_FWD_LAUNCHES.reset()
    fe.WINDOW_POOL_WIDE_BWD_LAUNCHES.reset()
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, mets = fe_task.train_step(state, b)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_launches = fe.WINDOW_POOL_WIDE_FWD_LAUNCHES.count
    if step_launches != n or fe.WINDOW_POOL_WIDE_BWD_LAUNCHES.count != 0:
        raise AssertionError(f"{step_launches} wide window pool launches in {n} fused_encode steps "
                             f"({fe.WINDOW_POOL_WIDE_BWD_LAUNCHES.count} backward)")
    if not torch.isfinite(mets["train_loss"]):
        raise AssertionError(f"census fused_encode step: loss {mets['train_loss'].item()}")
    log(f"phase7 census LDM training through fused_encode B={B}: {B * n / dt:.1f} train cells/s, "
        f"{dt / n * 1e3:.2f} ms/step over {n} steps; loss {mets['train_loss'].item():.4f}; wide "
        f"window pool launches {step_launches}")
    seg = ldm_step_segments(fe_task, state, batches[1:4])
    log(f"phase7 fused_encode segments ms (3 steps, each synchronised; the loss encodes again): "
        f"{seg}")
    launches["window_pool_wide_fwd"] = encode_launches + step_launches
    del z_k, z_m

    # -- generation: euler-50 through the algebraic decode
    sfs = SizeFactorSampler(constant_stats({"clusters": N_CLUSTERS}, mu=8.6, sd=0.3))
    genes = canonical_gene_ids(G, device="cuda")
    cond = {"clusters": batches[-1]["clusters"]}
    fn = task.make_sample_fn(sfs, guidance_weight=GUIDANCE, sampling_method="euler", num_steps=50)
    fn(g, genes, cond)  # warm-up
    torch.cuda.synchronize()
    fused_dit.DIT_BLOCK_LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    counts, z = fn(g, genes, cond)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    gen = fused_dit.DIT_BLOCK_LAUNCHES.count
    peak = torch.cuda.max_memory_allocated()
    if counts.shape != (2 * B, G) or z.shape != (2 * B, dit.seq_len, dit.n_embed_input):
        raise AssertionError(f"census generation: counts {tuple(counts.shape)}, z {tuple(z.shape)}")
    if not (torch.isfinite(z).all() and (counts >= 0).all() and (counts == counts.round()).all()):
        raise AssertionError("census generation: non-finite latents or counts not integers")
    if fn.drift_evals <= 0 or gen != L * fn.drift_evals:
        raise AssertionError(f"{gen} dit_block launches for {fn.drift_evals} DiT evaluations")
    launches["dit_block"] += gen
    log(f"phase7 census generation euler-50 (algebraic decode, vw fold): {2 * B / dt:.1f} cells/s "
        f"({dt:.3f} s for {2 * B} cells), DiT evals {fn.drift_evals}, dit_block launches {gen}, "
        f"counts {tuple(counts.shape)} mean {counts.mean().item():.4f}; peak memory "
        f"{peak / 2**30:.2f} GiB")

    # -- the kernel denoiser against the module one, the same noise
    z0 = torch.randn(B, dit.seq_len, dit.n_embed_input, generator=g, device="cuda")
    log_sf = torch.full((B,), 8.6, device="cuda")
    kw = dict(guidance_weight=GUIDANCE, sampling_method="euler", num_steps=50)
    (zk, ok, _), (zm, om, _) = (task.generate_from_noise(z0, log_sf, genes, cond,
                                                         fused_blocks=fused, **kw)
                                for fused in (True, False))
    z_err = (zk - zm).abs().max().item()
    mu_err, mu_max = (ok["mu"] - om["mu"]).abs().max().item(), om["mu"].abs().max().item()
    torch.testing.assert_close(zk, zm, rtol=1e-3, atol=1e-3)
    if not mu_err <= 1e-3 * mu_max:
        raise AssertionError(f"fused_blocks mu: max abs err {mu_err:.3e}, max |mu| {mu_max:.3e}")
    log(f"phase7 reference: generate_from_noise euler-50, fused_blocks=True vs False: latents max "
        f"abs err {z_err:.3e}, mu {mu_err:.3e} ({mu_err / mu_max:.1e} of max)")
    del ok, om

    # -- the module decode with the flash-cross gate on and off, the same noise
    module_task = LDMTask(vae, dit, create_transport(), algebraic_decode=False)
    kw["num_steps"] = 10
    outs, walls = {}, {}
    try:
        for enabled in (True, False):
            attention._FLASH_CROSS_ENABLED = enabled
            fc.FLASH_CROSS_LAUNCHES.reset()
            t0 = time.perf_counter()
            outs[enabled] = module_task.generate_from_noise(z0, log_sf, genes, cond, **kw)[1]["mu"]
            torch.cuda.synchronize()
            walls[enabled] = time.perf_counter() - t0
            if enabled:
                launches["flash_cross"] = fc.FLASH_CROSS_LAUNCHES.count
    finally:
        attention._FLASH_CROSS_ENABLED = False
    if launches["flash_cross"] != 1 or fc.FLASH_CROSS_LAUNCHES.count != 0:
        raise AssertionError(f"flash_cross launches: {launches['flash_cross']} with the gate, "
                             f"{fc.FLASH_CROSS_LAUNCHES.count} without")
    worst = held_bf16("module decode mu, flash cross vs plain attention", outs[True], outs[False])
    log(f"phase7 module decode (algebraic_decode=False), euler-10, SCLDM_FLASH_CROSS on vs off: "
        f"{report_bf16({'mu': worst})}; flash_cross launches {launches['flash_cross']}; "
        f"generation wall {walls[True]:.3f} s vs {walls[False]:.3f} s")
    return launches


TRUNK_TURNS = 5  # steps a turn of phase 8's trunk on / off comparison


def compare_trunk_paths(phase: str, task, plain_task, batch) -> None:
    """One step's loss and gradients with the trunk kernels against the
    module trunks, same parameters and batch. Both take the decoder tail,
    which rounds operands made from the trunk's output to bf16, so a change
    of 1e-6 in that output flips a rounding now and then (the CPU tests saw
    gradients move by up to 3e-3 of their largest): the loss is held within
    1e-5 relative, the gradient norm within 1e-4, each gradient within 1e-2
    of its largest magnitude."""
    from scldm_torch.training.metrics import global_norm

    (lk, gk), (lm, gm) = vae_loss_and_grads(task, batch), vae_loss_and_grads(plain_task, batch)
    nk, nm = global_norm(gk.values()).item(), global_norm(gm.values()).item()
    if abs(lk - lm) > 1e-5 * abs(lm) or abs(nk - nm) > 1e-4 * nm:
        raise AssertionError(f"{phase}: trunk kernels loss {lk}, grad norm {nk}; module trunks "
                             f"{lm}, {nm}")
    worst, beyond = (0.0, ""), 0.0
    for name, want in gm.items():
        if name == "decoder_head.params.bias":
            continue  # softmax-invariant: its true gradient is 0, both are noise
        scale = want.abs().max().item() + 1e-12
        d = (gk[name] - want).abs()
        if d.max().item() > 1e-2 * scale:
            raise AssertionError(f"{phase}: gradient {name}, trunk kernels vs module trunks "
                                 f"{d.max().item() / scale:.3e} of its max")
        worst = max(worst, (d.max().item() / scale, name))
        beyond = max(beyond, (d > 1e-4 * scale).float().mean().item())
    log(f"{phase} reference: one step, trunk kernels vs module trunks: loss {lk:.6f} vs {lm:.6f} "
        f"({abs(lk - lm) / abs(lm):.2e} relative), grad norm {nk:.6f} vs {nm:.6f} "
        f"({abs(nk - nm) / nm:.2e}), {len(gm)} gradients, largest gap {worst[0]:.3e} of its max "
        f"({worst[1]}), at most {beyond:.2e} of a tensor's entries beyond 1e-4 of its max")


def phase8_trunk_training(seed: int, batch: int) -> dict:
    """VAE training through the whole-trunk kernels (`VAETask(fused_trunk=
    True)`) at dentate width (phase 3's batches) and at parse1m width (phase
    5's): TRAIN_STEPS steps each, with two saving-forward (row 10) and two
    backward (row 11) launches a step; the step with the trunk kernels and
    with the module trunks (`fused_trunk=False`) timed in turns; one step
    held against the module trunks on the same weights and batch; and one
    `fused_nb_apply(..., use_trunk=True)` under `torch.no_grad()`, which
    launches the forward that saves nothing (row 9) once per trunk, held
    against the module trunks. Returns the main path's launches of the three
    kernels."""
    import numpy as np
    import torch

    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.ops import fused_trunk as ft
    from scldm_torch.training.vae_task import VAETask, fused_nb_apply
    from scldm_torch.utils.weights import init_reference_

    counters = {"fwd": ft.TRUNK_FWD_LAUNCHES, "fwd_saving": ft.TRUNK_FWD_SAVING_LAUNCHES,
                "bwd": ft.TRUNK_BWD_LAUNCHES}
    launches = dict.fromkeys(counters, 0)
    n = TRAIN_STEPS
    for name, G, S, nnz in (("dentate", N_GENES, WINDOW, (1500, 4000)),
                            ("parse1m", PARSE_GENES, PARSE_GENES, (500, PARSE_GENES))):
        vae = init_reference_(build_transformer_vae(n_genes=G, device="cuda"),
                              torch.Generator(device="cuda").manual_seed(seed))
        task = VAETask(vae, num_training_steps=10_000, fused_trunk=True)
        plain = VAETask(vae, num_training_steps=10_000, fused_trunk=False)
        if not task.fused_trunk:
            raise AssertionError("VAETask(fused_trunk=True) did not take the trunk kernels")
        state = task.init_state(torch.Generator(device="cuda").manual_seed(seed))
        plain_state = plain.init_state(torch.Generator(device="cuda").manual_seed(seed))
        rng = np.random.default_rng(seed)
        batches = [{k: torch.from_numpy(v).to("cuda")
                    for k, v in lean_batch(rng, batch, G, S, nnz).items()} for _ in range(n + 1)]
        task.train_step(state, batches[0])  # warm-up
        plain.train_step(plain_state, batches[0])
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        losses = []
        t0 = time.perf_counter()
        for b in batches[1:]:
            state, mets = task.train_step(state, b)
            losses.append(mets["train_loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {k: c.count for k, c in counters.items()}
        if got != {"fwd": 0, "fwd_saving": 2 * n, "bwd": 2 * n}:
            raise AssertionError(f"trunk launches in {n} {name} steps: {got}")
        for k in ("fwd_saving", "bwd"):
            launches[k] += got[k]
        losses = torch.stack(losses)
        if not torch.isfinite(losses).all():
            raise AssertionError(f"non-finite training loss: {losses.tolist()}")
        log(f"phase8 VAE training with the trunk kernels, {name} B={batch} G={G} S={S}: "
            f"{batch * n / dt:.1f} train cells/s, {dt / n * 1e3:.2f} ms/step over {n} steps; "
            f"losses {losses[0].item():.2f} -> {losses[-1].item():.2f}; trunk launches {got}")

        def steps_ms(t, st) -> float:
            t0 = time.perf_counter()
            for b in batches[1:1 + TRUNK_TURNS]:
                t.train_step(st, b)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / TRUNK_TURNS * 1e3

        turns = [steps_ms(*arm) for arm in ((plain, plain_state), (task, state), (task, state),
                                            (plain, plain_state))]
        on, off = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        log(f"phase8 {name} in turns (off, on, on, off; {TRUNK_TURNS} steps a turn): trunk kernels "
            f"{on:.2f} ms/step ({batch * 1e3 / on:.1f} cells/s), module trunks {off:.2f} ms/step "
            f"({batch * 1e3 / off:.1f} cells/s); turns {[round(t, 2) for t in turns]}")
        compare_trunk_paths(f"phase8 {name}", task, plain, batches[-1])

        mb = task._materialize(batches[-1])
        with torch.no_grad():
            for c in counters.values():
                c.reset()
            out_k, z_k = fused_nb_apply(vae, mb, use_trunk=True)
            torch.cuda.synchronize()
            got = {k: c.count for k, c in counters.items()}
            out_m, z_m = fused_nb_apply(vae, mb)
        if got != {"fwd": 2, "fwd_saving": 0, "bwd": 0}:
            raise AssertionError(f"trunk launches of one no-grad fused_nb_apply: {got}")
        launches["fwd"] += got["fwd"]
        z_err = held_f32(f"phase8 {name} no-grad h_z", z_k, z_m) / z_m.abs().max().item()
        mu = held_bf16(f"phase8 {name} no-grad mu", out_k["mu"], out_m["mu"])
        log(f"phase8 {name}: no-grad fused_nb_apply, trunk kernels vs module trunks: h_z "
            f"{z_err:.2e} of its max, " + report_bf16({"mu": mu}))
        del vae, task, plain, state, plain_state, batches
    torch.cuda.empty_cache()
    return launches


# phase 9: the census pair at 1,024 latent tokens, the smallest latent that
# sdpa's gate (_FLASH_MIN_SEQ) sends through the flash attention kernel
LONG_LATENT = 1_024  # the VAE's n_inducing_points and the DiT's seq_len
LONG_LDM_STEPS = 5  # timed LDM steps, after one warm-up step
LONG_GEN_BATCH = 4  # generation batch: 8 cells, 12 DiT rows under batched CFG
LONG_EULER_STEPS = 10  # euler-10: 9 DiT evaluations


@contextlib.contextmanager
def plain_attention_gate():
    """sdpa's length gate lifted past every axis, for a reference run of the
    plain path; the package has no switch for it."""
    from scldm_torch.ops import attention

    saved = attention._FLASH_MIN_SEQ
    attention._FLASH_MIN_SEQ = 1 << 62
    try:
        yield
    finally:
        attention._FLASH_MIN_SEQ = saved


def phase9_long_latent(seed: int) -> int:
    """The census pair at 1,024 latent tokens (the census VAE and DiT with
    n_inducing_points = seq_len = 1,024; random weights from CUDA generators,
    f32). Every sdpa call of the path where no gradient flows takes the flash
    attention kernel: the frozen encode (the MCAB, 1,024 queries over the
    4,096-token window, and 16 encoder blocks: 17 launches), held against the
    same encode through the plain gate within 1e-4 of the largest latent and
    timed against it in turns with each arm's peak memory; LDM_STEPS training
    steps with `LDMTask(fused_training=False)` (the DiT backward kernels
    refuse T = 1,024: one head's scores and their cotangents outgrow a CTA),
    whose DiT runs under a gradient on the plain path (17 launches a step,
    all from the encode); one euler-10 generation call at a generation batch
    of 4 through `make_sample_fn(fused_blocks=True)`: 9 DiT evaluations of 8
    blocks, 72 DiT block kernel launches and none of the flash attention
    kernel in the DiT, 16 of those from the decoder trunk of the algebraic
    decode. The NB means of the same noise through `generate_from_noise`
    with fused_blocks=True are held against fused_blocks=False, and those
    (whose DiT takes sdpa, so the flash attention kernel) against the plain
    gate, each within 1e-3 of their largest. Returns (the flash attention
    kernel's launches, the DiT block kernel's) in the counted runs."""
    import numpy as np
    import torch

    from scldm_torch.nn.nnets import DiT
    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.ops import flash_attention as fa
    from scldm_torch.ops import fused_dit
    from scldm_torch.ops.transforms import canonical_gene_ids
    from scldm_torch.sampling.size_factors import SizeFactorSampler, constant_stats
    from scldm_torch.training.ldm_task import LDMTask
    from scldm_torch.transport import create_transport
    from scldm_torch.utils.weights import init_reference_

    torch.cuda.empty_cache()
    vae = init_reference_(build_transformer_vae(**{**CENSUS, "n_inducing_points": LONG_LATENT},
                                                device="cuda"),
                          torch.Generator(device="cuda").manual_seed(seed)).eval()
    dit = init_reference_(DiT(**{**CENSUS_DIT, "seq_len": LONG_LATENT}).to("cuda"),
                          torch.Generator(device="cuda").manual_seed(seed + 1), zero_init=False)
    task = LDMTask(vae, dit, create_transport(), fused_training=False)
    G, B, L = CENSUS["n_genes"], CENSUS_LDM_BATCH, CENSUS["n_layer"]
    per_encode = 1 + L  # the MCAB and the encoder blocks
    batches = census_ldm_batches(np.random.default_rng(seed + 9), LONG_LDM_STEPS + 1)
    counter = fa.FLASH_ATTENTION_LAUNCHES

    # -- the frozen encode, the kernel against the plain gate
    counter.reset()
    z = task._encode(batches[0])
    torch.cuda.synchronize()
    launches = counter.count
    if launches != per_encode or z.shape != (B, LONG_LATENT, CENSUS["n_embed_latent"]):
        raise AssertionError(f"phase9 encode: {launches} flash_attention launches (want "
                             f"{per_encode}), latents {tuple(z.shape)}")
    with plain_attention_gate():
        z_plain = task._encode(batches[0])
    torch.cuda.synchronize()
    if counter.count != launches:
        raise AssertionError("phase9: the plain gate launched the kernel")
    err = held_f32("phase9 frozen encode, kernel vs plain gate", z, z_plain)
    scale = z_plain.abs().max().item()
    del z, z_plain
    walls, peaks = {}, {}
    for arm in ("plain", "kernel", "kernel", "plain"):  # in turns, 3 encodes each
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with plain_attention_gate() if arm == "plain" else contextlib.nullcontext():
            for _ in range(3):
                task._encode(batches[0])
        torch.cuda.synchronize()
        walls.setdefault(arm, []).append(round((time.perf_counter() - t0) / 3 * 1e3, 2))
        peaks[arm] = max(peaks.get(arm, 0.0), torch.cuda.max_memory_allocated() / 2**30)
    log(f"phase9 frozen encode B={B} S={CENSUS_WINDOW} at {LONG_LATENT} latent tokens: "
        f"{launches} flash_attention launches; latents vs the plain gate max abs err {err:.3e} "
        f"({err / scale:.1e} of max); ms per encode in turns, kernel {walls['kernel']} vs plain "
        f"{walls['plain']}; peak memory kernel {peaks['kernel']:.2f} GiB, plain "
        f"{peaks['plain']:.2f} GiB")

    # -- LDM training: the DiT under a gradient takes the plain path
    state = task.init_state(torch.Generator(device="cuda").manual_seed(seed))
    state, mets = task.train_step(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    counter.reset()
    fused_dit.DIT_BLOCK_LAUNCHES.reset()
    fused_dit.DIT_BLOCK_BWD_LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, mets = task.train_step(state, b)
        losses.append(mets["train_loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = LONG_LDM_STEPS
    steps = counter.count
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(losses)
    if steps != per_encode * n or fused_dit.DIT_BLOCK_LAUNCHES.count + \
            fused_dit.DIT_BLOCK_BWD_LAUNCHES.count != 0:
        raise AssertionError(f"phase9 training: {steps} flash_attention launches in {n} steps "
                             f"(want {per_encode * n}, all from the encode)")
    if not torch.isfinite(losses).all():
        raise AssertionError(f"phase9: non-finite LDM loss {losses.tolist()}")
    launches += steps
    log(f"phase9 LDM training B={B} T={LONG_LATENT} (fused_training=False): {B * n / dt:.1f} "
        f"train cells/s, {dt / n * 1e3:.2f} ms/step over {n} steps; losses "
        f"{losses[0].item():.4f} -> {losses[-1].item():.4f}; flash_attention launches {steps} "
        f"({steps // n} a step, none from the DiT); peak memory {peak:.2f} GiB")
    del state, mets

    # -- generation: euler-10 through the module DiT and the algebraic decode
    sfs = SizeFactorSampler(constant_stats({"clusters": N_CLUSTERS}, mu=8.6, sd=0.3))
    genes = canonical_gene_ids(G, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    GB = LONG_GEN_BATCH
    cond = {"clusters": batches[-1]["clusters"][:GB]}
    fn = task.make_sample_fn(sfs, guidance_weight=GUIDANCE, sampling_method="euler",
                             num_steps=LONG_EULER_STEPS, fused_blocks=True)
    trunk, decoded = vae.decoder.trunk, []

    def counted_trunk(x):  # the decoder trunk's launches, apart from the DiT's
        before = counter.count
        y = trunk(x)
        decoded.append(counter.count - before)
        return y

    vae.decoder.trunk = counted_trunk
    try:
        fn(g, genes, cond)  # warm-up
        torch.cuda.synchronize()
        counter.reset()
        fused_dit.DIT_BLOCK_LAUNCHES.reset()
        decoded.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        counts, z = fn(g, genes, cond)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        del vae.decoder.trunk
    gen = counter.count
    dit_launches = fused_dit.DIT_BLOCK_LAUNCHES.count
    peak = torch.cuda.max_memory_allocated() / 2**30
    if counts.shape != (2 * GB, G) or z.shape != (2 * GB, LONG_LATENT, CENSUS_DIT["n_embed_input"]):
        raise AssertionError(f"phase9 generation: counts {tuple(counts.shape)}, z {tuple(z.shape)}")
    if not (torch.isfinite(z).all() and (counts >= 0).all() and (counts == counts.round()).all()):
        raise AssertionError("phase9 generation: non-finite latents or counts not integers")
    if (fn.drift_evals != LONG_EULER_STEPS - 1 or dit_launches != dit.n_layer * fn.drift_evals
            or decoded != [L] or gen != L):
        raise AssertionError(f"phase9 generation: {dit_launches} DiT block launches for "
                             f"{fn.drift_evals} evaluations of {dit.n_layer} blocks, flash "
                             f"attention launches {gen - sum(decoded)} in the DiT (want 0) and "
                             f"{decoded} in the decoder")
    launches += gen
    log(f"phase9 generation euler-{LONG_EULER_STEPS} (fused_blocks=True, algebraic decode), batch "
        f"{GB}: {2 * GB / dt:.1f} cells/s ({dt:.3f} s for {2 * GB} cells), DiT evals "
        f"{fn.drift_evals}, dit_block launches {dit_launches} ({dit.n_layer} an evaluation), "
        f"flash_attention launches {decoded[0]} in the decode and none in the DiT; counts "
        f"{tuple(counts.shape)} mean {counts.mean().item():.4f}; peak memory {peak:.2f} GiB")
    del counts, z

    # -- the NB means of the same noise: the DiT kernel against the module DiT,
    # and the module DiT through the flash attention kernel against the plain gate
    z0 = torch.randn(GB, LONG_LATENT, CENSUS_DIT["n_embed_input"], generator=g, device="cuda")
    log_sf = torch.full((GB,), 8.6, device="cuda")
    kw = dict(guidance_weight=GUIDANCE, sampling_method="euler", num_steps=LONG_EULER_STEPS)
    before = fused_dit.DIT_BLOCK_LAUNCHES.count
    mu_fused = task.generate_from_noise(z0, log_sf, genes, cond, fused_blocks=True, **kw)[1]["mu"]
    if fused_dit.DIT_BLOCK_LAUNCHES.count - before != dit.n_layer * (LONG_EULER_STEPS - 1):
        raise AssertionError("phase9: generate_from_noise(fused_blocks=True) skipped the kernel")
    mu = task.generate_from_noise(z0, log_sf, genes, cond, fused_blocks=False, **kw)[1]["mu"]
    with plain_attention_gate():
        mu_plain = task.generate_from_noise(z0, log_sf, genes, cond, fused_blocks=False,
                                            **kw)[1]["mu"]
    err_fused = held_f32("phase9 generation mu, fused_blocks True vs False", mu_fused, mu, 1e-3)
    err = held_f32("phase9 generation mu, flash attention vs plain gate", mu, mu_plain, 1e-3)
    scale = mu_plain.abs().max().item()
    log(f"phase9 reference: generate_from_noise euler-{LONG_EULER_STEPS}: mu with the DiT "
        f"kernel vs the module DiT max abs err {err_fused:.3e} ({err_fused / scale:.1e} of max); "
        f"the module DiT through the flash attention kernel vs the plain gate {err:.3e} "
        f"({err / scale:.1e} of max)")
    del vae, dit, task
    torch.cuda.empty_cache()
    return launches, dit_launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=128,
                   help="cells per CFG half, and cells per training step")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    if not (ROOT / "scldm_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no scldm_torch sources beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # -- phase 0: the card and the build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    from scldm_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build()
    log(f"phase0 built {path.name} in {time.perf_counter() - t0:.1f} s; ptxas report:")
    log(build.report_path(path).read_text().strip())

    # -- phase 1: each kernel against its plain version -------------------------
    dit_block = phase1_dit_block(args.seed)
    tail_fwd, tail_bwd = phase1b_decoder_tail(args.seed)
    dit_block_bwd = phase1c_dit_block_bwd(args.seed)
    pools = phase1d_encoder_pool(args.seed)
    wide_pool = phase1d_wide_window_pool(args.seed)
    swiglu_fwd, swiglu_bwd = phase1e_swiglu_vec(args.seed)
    flash_cross = phase1f_flash_cross(args.seed)
    trunk_timing = phase1g_fused_trunk(args.seed)
    gate_fwd, gate_bwd, gate_launches = phase1h_swiglu_gate(args.seed)
    flash = phase1i_flash_attention(args.seed)

    # -- phase 2: the generation path -------------------------------------------
    launches = phase2_generation(args.seed, args.batch)
    phase2_reference(args.seed, args.batch)

    # -- phase 3: the VAE training path -------------------------------------------
    fwd_launches, bwd_launches = phase3_training(args.seed, args.batch)

    # -- phase 4: the LDM training path -----------------------------------------
    ldm_fwd, ldm_bwd, ldm_gen, encode_launches = phase4_ldm_training(args.seed, args.batch)

    # -- phase 5: VAE training at parse1m / replogle width ----------------------
    parse = phase5_parse1m_training(args.seed, args.batch)

    # -- phase 6: VAE training at census width --------------------------------
    census_fwd, census_bwd = phase6_census_training(args.seed)
    census_pool = phase6b_census_fused_pool(args.seed)

    # -- phase 7: census LDM training and generation ----------------------------
    census_ldm = phase7_census_ldm(args.seed)

    # -- phase 8: VAE training through the whole-trunk kernels ------------------
    trunk = phase8_trunk_training(args.seed, args.batch)

    # -- phase 9: the census pair at 1,024 latent tokens --------------------------
    long_latent, long_dit = phase9_long_latent(args.seed)

    tail_src = "scldm_torch/kernels/csrc/decoder_tail.cu"
    pool_src = "scldm_torch/kernels/csrc/encoder_pool.cu"
    pool_launches = {"dense_fwd": parse["encoder_pool_fwd"], "dense_bwd": parse["encoder_pool_bwd"],
                     "window_fwd": parse["window_pool_fwd"] + encode_launches,
                     "window_bwd": parse["window_pool_bwd"]}
    pool_replaces = {"dense_fwd": 217, "dense_bwd": 263, "window_fwd": 409, "window_bwd": 452}
    # no single PyTorch call computes any of these functions but flash_cross
    # and flash_attention (scaled_dot_product_attention): library_ms is null
    # for the rest, the whole trunk (L blocks) included
    dit_src = "scldm_torch/kernels/csrc/dit_block.cu"
    dit_bwd_src = "scldm_torch/kernels/csrc/dit_block_bwd.cu"
    census_rows = (3 * CENSUS_LDM_BATCH, CENSUS_LDM_BATCH)  # the census sampler's and step's rows
    kernels = [
        # the forward at each T it runs at: the dentate sampler's rows (T = 16),
        # the census sampler's (T = 64) and the long-latent pair's (T = 1,024)
        {"name": "dit_block", "route": "cuda", "source": dit_src,
         "replaces": "scldm_tpu/ops/fused_dit.py:155",
         "launches": launches + ldm_fwd + ldm_gen, **dit_block[(16, 384)],
         **dit_block_bound(3 * args.batch, backward=False), "library_ms": None},
        {"name": "dit_block_bwd", "route": "cuda", "source": dit_bwd_src,
         "replaces": "scldm_tpu/ops/fused_dit.py:205", "launches": ldm_bwd,
         **dit_block_bwd[(16, 128, None)], **dit_block_bound(128, backward=True),
         "library_ms": None},
        {"name": "dit_block_t64", "route": "cuda", "source": dit_src,
         "replaces": "scldm_tpu/ops/fused_dit.py:155", "launches": census_ldm["dit_block"],
         **dit_block[(64, census_rows[0])],
         **dit_block_bound(census_rows[0], backward=False, T=64), "library_ms": None},
        {"name": "dit_block_bwd_split", "route": "cuda", "source": dit_bwd_src,
         "replaces": "scldm_tpu/ops/fused_dit.py:205", "launches": census_ldm["dit_block_bwd"],
         **dit_block_bwd[(64, census_rows[1], None)],
         **dit_block_bound(census_rows[1], backward=True, T=64), "library_ms": None},
        {"name": "dit_block_t1024", "route": "cuda", "source": dit_src,
         "replaces": "scldm_tpu/ops/fused_dit.py:155", "launches": long_dit,
         **dit_block[(1024, 3 * LONG_GEN_BATCH)],
         **dit_block_bound(3 * LONG_GEN_BATCH, backward=False, T=1024), "library_ms": None},
        {"name": "decoder_tail_fwd", "route": "cuda", "source": tail_src,
         "replaces": "scldm_tpu/ops/fused_decoder.py:262",
         "launches": fwd_launches + parse["decoder_tail_fwd"], **tail_fwd,
         **decoder_tail_bound(128, N_GENES, backward=False), "library_ms": None},
        {"name": "decoder_tail_bwd", "route": "cuda", "source": tail_src,
         "replaces": "scldm_tpu/ops/fused_decoder.py:294",
         "launches": bwd_launches + parse["decoder_tail_bwd"], **tail_bwd,
         **decoder_tail_bound(128, N_GENES, backward=True), "library_ms": None},
    ] + [
        # dense at parse1m (B=128, G=2,000), window at the dentate window (B=128, S=6,147)
        {"name": f"{'encoder' if v == 'dense' else 'window'}_pool_{part}", "route": "cuda",
         "source": pool_src,
         "replaces": f"scldm_tpu/ops/fused_encoder.py:{pool_replaces[f'{v}_{part}']}",
         "launches": pool_launches[f"{v}_{part}"], **pools[f"{v}_{part}"],
         **encoder_pool_bound(128, PARSE_GENES if v == "dense" else WINDOW, part == "bwd",
                              v == "dense"), "library_ms": None}
        for v in ("dense", "window") for part in ("fwd", "bwd")
    ] + [
        # the census decoder's rows: B=16 cells x G=36,601 genes
        {"name": f"swiglu_vec_{part}", "route": "cuda",
         "source": "scldm_torch/kernels/csrc/swiglu_vec.cu",
         "replaces": f"scldm_tpu/ops/fused_swiglu.py:{line}", "launches": launches_, **timed,
         **swiglu_vec_bound(CENSUS_BATCH * CENSUS["n_genes"], CENSUS["n_embed"], CENSUS_HIDDEN,
                            part == "bwd"), "library_ms": None}
        for part, line, launches_, timed in (("fwd", 256, census_fwd, swiglu_fwd),
                                             ("bwd", 280, census_bwd, swiglu_bwd))
    ] + [
        # the census sampler's cross block: 2B = 32 cells, G = 36,601 genes
        {"name": "flash_cross", "route": "cuda",
         "source": "scldm_torch/kernels/csrc/flash_cross.cu",
         "replaces": "scldm_tpu/ops/fused_cross.py:133", "launches": census_ldm["flash_cross"],
         **flash_cross,
         **flash_cross_bound(2 * CENSUS_LDM_BATCH, CENSUS["n_genes"], CENSUS["n_embed"],
                             CENSUS["n_inducing_points"])},
    ] + [
        # the VAE's trunks: R = 128 rows of T = 16 tokens, E = 32, hidden 88, L = 8
        {"name": f"fused_trunk_{part}", "route": "cuda",
         "source": "scldm_torch/kernels/csrc/fused_trunk.cu",
         "replaces": f"scldm_tpu/ops/fused_trunk.py:{line}", "launches": trunk[part],
         **trunk_timing[part],
         **fused_trunk_bound(TRUNK_ROWS[0], TRUNK["T"], TRUNK["E"], TRUNK["hidden"], TRUNK["L"],
                             part == "bwd", part == "fwd_saving"), "library_ms": None}
        for part, line in (("fwd", 181), ("fwd_saving", 215), ("bwd", 249))
    ] + [
        # the census encoder's window: B=16 cells of S=4,096 tokens, E=512, 8 heads, 64 queries
        {"name": f"window_pool_wide_{part}", "route": "cuda",
         "source": "scldm_torch/kernels/csrc/window_pool_wide.cu",
         "replaces": f"scldm_tpu/ops/fused_encoder.py:{line}", "launches": launches_,
         **wide_pool[part],
         **encoder_pool_bound(CENSUS_BATCH, CENSUS_WINDOW, part == "bwd", False, CENSUS["n_embed"],
                              CENSUS["n_head_cross"], CENSUS["n_inducing_points"]),
         "library_ms": None}
        for part, line, launches_ in (
            ("fwd", 409, census_pool[0] + census_ldm["window_pool_wide_fwd"]),
            ("bwd", 452, census_pool[1]))
    ] + [
        # its own entry point at the census cross block's MLP: R = 16 x 36,601, E = 512, H = 1,408
        {"name": f"swiglu_gate_{part}", "route": "cuda",
         "source": "scldm_torch/kernels/csrc/swiglu_vec.cu",
         "replaces": f"scldm_tpu/ops/fused_swiglu.py:{line}", "launches": launches_, **timed,
         **swiglu_gate_bound(CENSUS_BATCH * CENSUS["n_genes"], CENSUS["n_embed"], CENSUS_HIDDEN,
                             part == "bwd"), "library_ms": None}
        for part, line, launches_, timed in (("fwd", 103, gate_launches[0], gate_fwd),
                                             ("bwd", 131, gate_launches[1], gate_bwd))
    ] + [
        # the long-latent MCAB: 16 cells, 1,024 queries over 4,096 tokens, 8 heads of 64
        {"name": "flash_attention", "route": "cuda",
         "source": "scldm_torch/kernels/csrc/flash_attention.cu",
         "replaces": "scldm_tpu/ops/flash_attention.py:74", "launches": long_latent, **flash,
         **flash_attention_bound(*FLASH_ROW[:5])},
    ]
    for k in kernels:
        log(f"{k['name']}: {k['ms']:.4f} ms against a bound of {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}), plain {k['plain_ms']:.4f} ms")
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
