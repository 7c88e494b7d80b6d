#!/usr/bin/env python3
"""Smoke run of the PyTorch port (scldm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--batch B]

Phase 0 prints the card's name and power limit and builds the CUDA kernels
from `scldm_torch/kernels/csrc`. Phase 1 holds the DiT block kernel against
its plain PyTorch version on the card at the generation path's shapes, and
phase 1b the decoder-tail kernels (forward and backward) against theirs at
the VAE training step's shape and a ragged one, timing both. Phase 2 runs
CFG generation (`LDMTask.make_sample_fn`) at the dentate-gyrus configuration
with random weights made from the seed, with dopri5 and with euler-50,
checks the outputs, checks that every DiT block went through the kernel, and
holds one DiT evaluation of the sampler (the kernel path) against the plain
module path (`DiT.forward_with_cfg_batched`) on the same inputs. Phase 1c
holds the DiT block backward kernels against their plain version at the LDM
training step's shape and a ragged one, timing both. Phase 1d holds the
encoder-pool kernels (dense and window, forward and backward) against theirs
at the VAE steps' shapes and ragged ones, timing both, and the dense pool's
pooled tokens against the module MCAB where the zero-row correction is not
0. Phase 3 trains the dentate-gyrus VAE (`VAETask.train_step`) on lean wire
batches made like bench.py's for a warm-up step and TRAIN_STEPS timed steps,
checks the losses and that each tail kernel ran once per step, and holds one
step's loss and gradients on the kernel path against the module path. Phase
4 trains the dentate-gyrus DiT on the frozen VAE's latents
(`LDMTask.train_step`) the same way, checks that every block ran its forward
and backward kernels once per step and that the EMA ticked once per step,
holds one step's loss and gradients on the kernel path against the module
path, holds one frozen encode through the window pool
(`LDMTask(fused_encode=True)`) against the module encode, timing both, and
generates from the trained state's EMA weights. Phase 5 trains the parse1m /
replogle VAE (G = S = 2,000) the same way, each step through the dense
encoder pool and the tail kernels once each way, holds one step against the
module path, then takes a few steps of `VAETask(fused_pool=True,
fused_decoder=False)` through the window pool and holds one against the
module path. The line before the last is a JSON summary of the kernels, each
with its time beside the least time the card could take for the same work;
the last is {"ok": true, "device": {...}}. Any failure raises, so the script
exits non-zero and prints no result; so does a machine without CUDA, or a
directory without the port's sources.
"""

from __future__ import annotations

import argparse
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
EPS = 1e-8  # the DiT's LayerNorm eps
# the H100 SXM's published peaks (NVIDIA's data sheet, dense), at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # f32 outside the tensor cores
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


def dit_block_bound(R: int, backward: bool) -> dict:
    """One DiT block at R rows, f32. Operations: two per multiply-add of its
    products (per row the adaLN product 6E^2; per token qkv 3E^2, scores and
    probabilities times values 2TE, the projection E^2, the SwiGLU 3E*Hd),
    three times that for the backward, which recomputes the forward; the
    elementwise work is left out. Bytes: each input read once and each output
    written once (backward: x, c, dy and the weights in; dx, dc and the
    weight gradients out)."""
    T, E = DIT["seq_len"], DIT["n_embed"]
    weights = 10 * E * E + 10 * E + 3 * E * HIDDEN
    flops = 2 * R * (6 * E * E + T * (4 * E * E + 2 * T * E + 3 * E * HIDDEN))
    if backward:
        return bound(4 * (3 * R * T * E + 2 * R * E + 2 * weights), 3 * flops, F32_FLOPS)
    return bound(4 * (2 * R * T * E + R * E + weights), flops, F32_FLOPS)


def decoder_tail_bound(B: int, G: int, backward: bool) -> dict:
    """The decoder tail at B cells and G genes (E=32, 4 heads, 16 latent
    tokens, hidden 88). Its products take bf16 operands, so the bf16 tensor-
    core peak: per (cell, gene) pair, scores over the head blocks M*E,
    probabilities times values H*M*E, the up projection 2E*Hd, and the wv and
    wmu dots, two operations per multiply-add; three times that for the
    backward. Bytes: qp, q (G, E), kfull, vproj (B, H*M, E) and the weights in,
    the (B, G) logits out; the backward reads dy and writes a gradient of
    each input."""
    E, H, M, Hd = 32, 4, 16, 88
    weights = 3 * E + 2 * E * Hd + Hd + 1
    inputs = 2 * G * E + 2 * B * H * M * E + weights
    flops = 2 * B * G * (M * E + H * M * E + 2 * E * Hd + Hd + E)
    if backward:
        return bound(4 * (2 * inputs + B * G), 3 * flops, BF16_FLOPS)
    return bound(4 * (inputs + B * G), flops, BF16_FLOPS)


def phase1_dit_block(seed: int) -> dict:
    """dit_block vs dit_block_reference at the sampler's shape and a ragged R."""
    import torch

    from scldm_torch.ops import fused_dit

    E, H, T = DIT["n_embed"], DIT["n_head"], DIT["seq_len"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = random_block_weights(g)
    eps = EPS
    max_err = 0.0
    timing = {}
    for R in (3 * 128, 5):  # R = 3B rows at batch 128, and a ragged small R
        x = torch.randn(R, T, E, generator=g, device="cuda")
        c = torch.randn(R, E, generator=g, device="cuda")
        got = fused_dit.dit_block(x, c, w, H, eps)
        torch.cuda.synchronize()
        want = fused_dit.dit_block_reference(x, c, w, H, eps)
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **TOL)
        if (got - x).abs().max().item() < 1e-2:
            raise AssertionError("dit_block returned its input: the check would prove nothing")
        max_err = max(max_err, err)
        kernel = lambda: fused_dit.dit_block(x, c, w, H, eps)  # noqa: E731
        plain = lambda: fused_dit.dit_block_reference(x, c, w, H, eps)  # noqa: E731
        for f in (kernel, plain):
            cuda_ms(f, 3)  # warm-up
        turns = [cuda_ms(f, 20) for f in (plain, kernel, kernel, plain)]
        timing[R] = ((turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2)
        log(f"phase1 dit_block R={R}: max_abs_err {err:.3e}  kernel {timing[R][0]:.4f} ms  "
            f"plain {timing[R][1]:.4f} ms")
    return {"max_abs_err": max_err, "ms": timing[384][0], "plain_ms": timing[384][1]}


def encoder_pool_bound(B: int, N: int, backward: bool, dense: bool) -> dict:
    """The encoder pool over B cells of N tokens (E=32, 4 heads, 16 inducing
    queries). Its products take bf16 operands, so the bf16 tensor-core peak:
    per token the k and v projections (2E^2) and, per head, the scores and
    the pooled values against that head's block (Q*E each), two operations
    per multiply-add, three times that for the backward, which recomputes the
    forward; the LayerNorm and the exponentials are left out. Bytes: the
    counts (B, N) and the table (N, E) (dense) or the embeddings (B, N, E)
    (window), the query blocks and the weights in; num (B, Q, E), den and m
    (B, Q*H) out. The backward reads the same inputs with m, dnum and dden
    and writes a gradient of each input but the counts."""
    E, H, Q = 32, 4, 16
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
    for the keys' gradient)."""
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
    plain block) at the LDM training step's shape, R = 128 rows (one per
    cell), and a ragged R. dx and dc at rtol = atol = 1e-4; each weight
    gradient within 1e-4 of its tensor's largest magnitude: f32 both, the
    weight gradients summed over R*T tokens in other orders."""
    import torch

    from scldm_torch.ops import fused_dit

    E, H, T = DIT["n_embed"], DIT["n_head"], DIT["seq_len"]
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    w = random_block_weights(g)
    worst, timing = 0.0, {}
    for R in (128, 5):
        x, dy = (torch.randn(R, T, E, generator=g, device="cuda") for _ in range(2))
        c = torch.randn(R, E, generator=g, device="cuda")
        dx, dc, dw = fused_dit.dit_block_bwd(x, c, w, dy, H, EPS)
        torch.cuda.synchronize()
        rx, rc, rw = fused_dit.dit_block_backward_reference(x, c, w, dy, H, EPS)
        torch.testing.assert_close(dx, rx, **TOL)
        torch.testing.assert_close(dc, rc, **TOL)
        report = []
        for name, got, want in [("dx", dx, rx), ("dc", dc, rc),
                                *((k, dw[k], rw[k]) for k in fused_dit.WEIGHT_NAMES)]:
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            if name not in ("dx", "dc") and (scale == 0 or err > 1e-4 * scale):
                raise AssertionError(f"dit_block_bwd {name} at R={R}: max abs err {err:.3e}, "
                                     f"max |ref| {scale:.3e}")
            worst = max(worst, err)
            report.append(f"{name} {err:.2e} (max {scale:.2e})")
        kernel = lambda: fused_dit.dit_block_bwd(x, c, w, dy, H, EPS)  # noqa: E731
        plain = lambda: fused_dit.dit_block_backward_reference(x, c, w, dy, H, EPS)  # noqa: E731
        for f in (kernel, plain):
            cuda_ms(f, 3)  # warm-up
        turns = [cuda_ms(f, 10) for f in (plain, kernel, kernel, plain)]
        timing[R] = ((turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2)
        log(f"phase1c dit_block_bwd R={R}: " + ", ".join(report))
        log(f"phase1c dit_block_bwd R={R}: kernel {timing[R][0]:.4f} ms  plain {timing[R][1]:.4f} ms")
    return {"max_abs_err": worst, "ms": timing[128][0], "plain_ms": timing[128][1]}


# The forward rounds each exponential to bf16 against its tile's running max,
# the plain version against the final max; the dense pool's zero-count genes
# are identical rows whose roundings then move num together, not at random:
# up to 1.5e-3 of its largest magnitude, 8.8% of the entries beyond 1e-4 of
# it and 1.1% beyond 3e-4 at parse1m (chip run on an H100). So num is held
# to 3e-4 where the other outputs are held to 1e-4.
POOL_NUM_NEAR = 3e-4


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

    def run(fn, counts, x, cot):
        leaves = {k: t.detach().clone().requires_grad_() for k, t in x.items()}
        qfull = fe.build_query_operand(leaves["q"], H)
        args = (leaves["src"],) if counts is None else (counts, leaves["src"])
        num, den, m = fn(*args, qfull, [leaves[k] for k in fe.WEIGHT_NAMES], H, EPS)
        torch.autograd.backward((num, den), cot)
        return {"fwd": {"num": num.detach(), "den": den.detach(), "m": m},
                "bwd": {f"d{k}": t.grad for k, t in leaves.items()}}

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
        got, want = run(pool, counts, x, cot), run(reference, counts, x, cot)
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
    vae = init_reference_(build_transformer_vae(n_genes=G, n_layer=1),
                          torch.Generator().manual_seed(seed)).to("cuda")
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


def build_models(seed: int):
    import torch

    from scldm_torch.nn.nnets import DiT
    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.utils.weights import init_reference_

    g = torch.Generator().manual_seed(seed)
    vae = init_reference_(build_transformer_vae(n_genes=N_GENES), g)
    # the zero-init layers (adaLN, final linear) drawn too: a zero DiT is the identity
    dit = init_reference_(DiT(**DIT), g, zero_init=False)
    return vae.to("cuda").eval(), dit.to("cuda").eval()


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

    vae = init_reference_(build_transformer_vae(n_genes=N_GENES), torch.Generator().manual_seed(seed))
    task = VAETask(vae.to("cuda"), num_training_steps=10_000)
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

    vae = init_reference_(build_transformer_vae(n_genes=PARSE_GENES),
                          torch.Generator().manual_seed(seed)).to("cuda")
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
    from scldm_torch.training.metrics import global_norm
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

    # one step's loss and gradients, kernel path vs module path, same
    # parameters, batch and draws; JAX's bounds between its two paths
    # (tests/test_fused_dit.py)
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    noise = {"t": torch.rand(batch, generator=g, device="cuda"),
             "x0": torch.randn(batch, DIT["seq_len"], DIT["n_embed_input"], generator=g,
                               device="cuda"),
             "drop_mask": torch.rand(batch, generator=g, device="cuda") < DIT["cfg_dropout_prob"]}
    runs = []
    for t in (task, LDMTask(vae, dit, create_transport(), fused_training=False)):
        dit.zero_grad(set_to_none=True)
        loss = t.loss(batches[-1], g, noise)
        loss.backward()
        grads = {k: p.grad.clone() for k, p in dit.named_parameters()}
        runs.append((loss.item(), global_norm(grads.values()).item(), grads))
    dit.zero_grad(set_to_none=True)
    (lk, nk, gk), (lm, nm, gm) = runs
    if abs(lk - lm) > 1e-4 * abs(lm) or abs(nk - nm) > 1e-3 * nm:
        raise AssertionError(f"kernel path loss {lk}, grad norm {nk}; module path {lm}, {nm}")
    worst = max(((gk[k] - w).abs().max().item() / (w.abs().max().item() + 1e-12), k)
                for k, w in gm.items())
    log(f"phase4 reference: one step, kernel path vs module path: loss {lk:.6f} vs {lm:.6f} "
        f"({abs(lk - lm) / abs(lm):.2e} relative), grad norm {nk:.6f} vs {nm:.6f} "
        f"({abs(nk - nm) / nm:.2e}), {len(gm)} gradients, largest gap {worst[0]:.3e} of its "
        f"max ({worst[1]})")

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

    # -- phase 2: the generation path -------------------------------------------
    launches = phase2_generation(args.seed, args.batch)
    phase2_reference(args.seed, args.batch)

    # -- phase 3: the VAE training path -------------------------------------------
    fwd_launches, bwd_launches = phase3_training(args.seed, args.batch)

    # -- phase 4: the LDM training path -----------------------------------------
    ldm_fwd, ldm_bwd, ldm_gen, encode_launches = phase4_ldm_training(args.seed, args.batch)

    # -- phase 5: VAE training at parse1m / replogle width ----------------------
    parse = phase5_parse1m_training(args.seed, args.batch)

    tail_src = "scldm_torch/kernels/csrc/decoder_tail.cu"
    pool_src = "scldm_torch/kernels/csrc/encoder_pool.cu"
    pool_launches = {"dense_fwd": parse["encoder_pool_fwd"], "dense_bwd": parse["encoder_pool_bwd"],
                     "window_fwd": parse["window_pool_fwd"] + encode_launches,
                     "window_bwd": parse["window_pool_bwd"]}
    pool_replaces = {"dense_fwd": 217, "dense_bwd": 263, "window_fwd": 409, "window_bwd": 452}
    # no single PyTorch call computes any of these functions: library_ms is null
    kernels = [
        {"name": "dit_block", "route": "cuda", "source": "scldm_torch/kernels/csrc/dit_block.cu",
         "replaces": "scldm_tpu/ops/fused_dit.py:155",
         "launches": launches + ldm_fwd + ldm_gen, **dit_block,
         **dit_block_bound(3 * args.batch, backward=False), "library_ms": None},
        {"name": "dit_block_bwd", "route": "cuda",
         "source": "scldm_torch/kernels/csrc/dit_block_bwd.cu",
         "replaces": "scldm_tpu/ops/fused_dit.py:205", "launches": ldm_bwd, **dit_block_bwd,
         **dit_block_bound(128, backward=True), "library_ms": None},
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
