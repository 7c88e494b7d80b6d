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
block backward kernels against their plain version at the dentate, census
and long-latent LDM training steps' shapes (T = 16, 64 and 1,024) and ragged
ones, with a bitwise repeat at the dentate and census shapes, timing both. Phase 1d holds the
encoder-pool kernels (dense and window, forward and backward) against theirs at
the VAE steps' shapes and ragged ones, each repeating its bits, timing both,
and the dense pool's pooled tokens against the module MCAB where the zero-row
correction is not 0; then the
wide window-pool kernels (the census encoder's design) against their plain
version at the census window (B = 16 cells of S = 4,096 tokens, E = 512, 8
heads, 64 inducing points), a ragged one, at E = 256, at the long-latent
encoder's 1,024 inducing points, at a ragged 40 and at E = 768 (against the
plain version evaluated in f64), with a bitwise repeat of both at the census
window and at 1,024 queries, timing both at the census window (a call and on
the device). Phase 3
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
512, Hd = 1,408) and ragged ones, in f32 (three TF32 passes) and in bf16 (one
bf16 wgmma pass, against the bf16 plain version with JAX's rounding points,
by `held_bf16`'s bounds), checks that each repeats its bits, and times both
(a call through the entry point, and the kernels' device time), with TF32
off. Phase 6
trains the census VAE as configs/model/vae_census.yaml ships it (bf16 compute
over f32 weights, remat; E = 512, 16 layers, 64 inducing points, G = 36,601
genes, a 4,096-token window, B = 16) through the algebraic tail with
`VAETask(algebraic_fused_gate=True)` (the bf16 swiglu_vec kernels) and through
the plain algebraic path in turns, checks that each fused step launched the
kernels once each way and that the loss falls, prints each path's cells/s and
peak memory beside the f32 cut's (no remat; the f32 kernels), holds one
bf16 step against the plain path and against the f32 step
(`CENSUS_BF16_BOUNDS`), and one f32 step of the fused gate against the f32
plain path (loss 1e-5, each gradient 1e-3 of its largest). Phase 6b trains
the census VAE (f32) on the module path with its MCAB
pooling as the wide window pool (`VAETask(fused_pool=True,
algebraic_tail=False)`), checks that each step launched the pool once each way,
times it against the module MCAB in turns with each arm's peak memory, and
holds one step against the module MCAB. Phase 1f holds the flash cross-
attention kernel against its plain version at the census sampler's cross block
(2B = 32 cells, G = 36,601 genes into 64 latent tokens) and a ragged shape,
timing both and `scaled_dot_product_attention` as a yardstick. Phase 7 trains
the census DiT (T = 64, E = 256, 8 layers) on the frozen census VAE's latents
(B = 16) at ldm_base.yaml's bf16 compute through the DiT kernels (f32 inside,
as JAX's kernel path), prints the step's segment split, holds one step of the
kernels against the module path on the DiT's f32 twin at JAX's bounds, and the
timed bf16 task's loss and gradients against its function on modules (the
twin's trunk on the bf16 conditioning) at JAX's bounds, holds the frozen encode through
the wide window pool (`LDMTask(fused_encode=True)`) against the f32 twin VAE's
module encode at JAX's bound, timing it against the bf16 module encode in
turns, trains the same steps through it with their segment split, generates
euler-50 at a generation batch of 16 through the algebraic decode, holds the
kernel denoiser against the f32 twin's module one on the same noise (mu
through the f32 twin's decode; prints the bf16 module denoiser's and the
bf16 decode's distances), and holds the module decode with the flash-cross
gate (`SCLDM_FLASH_CROSS`) on against off (the kernel takes the bf16 decoder's
operands). Phase 1g holds the whole-trunk kernels (the forward, the saving
forward and the backward of all eight blocks of a VAE trunk) against their
plain versions at the VAE step's trunk (R = 128 rows of T = 16 tokens, E = 32)
and a ragged R, timing each, and checks that the forward, the saving forward
and the backward repeat their bits.
Phase 8 trains the dentate and the parse1m VAEs through them
(`VAETask(fused_trunk=True)`), checks that each step launched the saving
forward and the backward twice (encoder and decoder), times the step with the
trunk kernels and with the module trunks in turns, holds one step against the
module trunks, and runs one no-grad `fused_nb_apply(use_trunk=True)`, which
launches the forward that saves nothing. Phase 1h holds `fused_swiglu_gate`
(its own entry point, forward and backward) against its plain version at the
census cross block's MLP (R = 16 x 36,601 rows, E = 512, H = 1,408) and two
ragged shapes, with TF32 off, checks that it repeats its bits, and times
both. Phase 1i holds the long-axis flash
attention kernel against its plain version (sdpa's plain path) at JAX's
standalone shape, the long-latent MCAB (16 cells, 1,024 queries over 4,096
tokens), its self-attention, the DiT's rows, ragged and short shapes and bf16
operands, checks that it repeats its bits, and times it beside the plain
version and `scaled_dot_product_attention`. Phase 9 runs the census pair at
1,024 latent tokens (the VAE's inducing points and the DiT's seq_len), where
every sdpa call without a gradient takes that kernel: the frozen encode (17
launches, held against the plain gate and timed against it in turns with peak
memory), LDM training through the DiT block kernels
(`LDMTask(fused_training=None)`: 17 flash attention launches a step, all from
the encode, and 8 DiT block launches each way), held against and timed in
turns with the module DiT (`fused_training=False`) with each arm's peak
memory, and euler-10 generation at a generation batch of 4
through the DiT block kernel (72 of its launches, none of row 12's counted in
the DiT, 16 in the decode), its NB means held against the module DiT and,
through it, against the plain gate. Phase 10 runs the joint pair
(parse1m's {cell_type 18, cytokine 91} and replogle's {cell_line 4, gene
2,024}, condition_strategy joint) through the port's host data layer: a
`VocabularyEncoder` from the dataset's metadata JSON with synthetic joint
size-factor statistics (a JSON file in the reference's format covering about
85% of the label pairs), 4,096 synthetic CSR cells packed into B = 128
batches by `expressed_batch_from_csr` (lean, and one dense batch held
against the lean one densified on the card) with their label columns from
`encode_metadata`; it trains the joint DiT over the frozen parse1m VAE
through the DiT block kernels (8 launches each way a step), holds one step
against the module DiT, holds a `fused_encode` encode against the module
encode, checks on the card that label pairs without statistics sample
exactly 0, and generates dopri5 through `SizeFactorSampler(encoder,
"joint")` with guidance on both labels, where the log of each conditional
cell's library must correlate with its pair's mu at 0.7 or more; the
requested label columns must decode back to their categories (the
encoder's round trip). It loads neither h5py nor pandas. Phase 11 runs the
user entry points as a user would, `main(argv)` of `scldm_torch.cli.train`,
`train_ldm` and `inference` with `--config` on the repo's YAML files as
shipped (bf16 compute), at full dentate width (G = 17,002, a window of
6,147, B = 128) on 2,560 synthetic CSR cells (1,500 to 3,999 expressed genes,
a `clusters` column; 18 train steps an epoch) and a 256-cell test file, with
JSON size-factor statistics; the port's DataModule, native CSR packer,
prefetch thread, fit loop and checkpoints all run as shipped, with two
stand-ins for the card machine's missing h5py, named in the log: an
in-memory CSR shard for `H5ADFile` and a capturing writer for the h5ad
writer. `train` takes SIGTERM after its first dispatch (the guard's handler
checked first), checkpoints at step 8 and returns; the same command resumes
at step 8 and ends at 24, and must train the same steps, learning rates and
batches as an uninterrupted run, with weights within CLI_RESUME_ATOL (the
largest difference printed); each VAE step launches the tail once each way.
`train_ldm` then trains 24 steps on that checkpoint (eight DiT block
launches each way a step) and checkpoints the EMA; `inference` generates
dopri5 from configs/generation.yaml (both halves, the labels decoding to the
test cells' categories), encodes and reconstructs from configs/
inference.yaml, and runs `vae_only`; `train` at `datamodule.dataset=parse1m`
takes 8 steps through the dense pool and the tail; `train` with
`model=vae_census` (composed into vae_training.yaml's defaults, bf16 and
remat as shipped) takes 4 steps of 16 cells on metadata/census_genes.json's
36,130 genes (`datamodule.dataset=homo_sapiens`). Every batch must be
packed by the native packer, each CLI's wall time, the train cells/s of
`metrics.csv` and each checkpoint's size and save time are printed, and the
phase fails if yaml, h5py, pandas or jax was loaded. Phase 12 runs
`scldm_torch.cli.train_scvi` from configs/vae_scvi_training.yaml as shipped
at dentate width on 2,560 synthetic CSR cells: a run sent SIGTERM in its
first dispatch, resumed, and held bit for bit to an uninterrupted one
(parameters, BatchNorm buffers, optimizer state, generator), and one step on
the card held to the same step on the CPU at 1e-4; then `train` for a VAE
checkpoint and `train_ldm` with `model.eval_generation` on (freq 1, no
warmup, sample_size 1,024, dopri5 at 50 steps) over 1,024 validation cells
(`val_as_test`): generation_eval.csv must hold finite metrics, the card's
metrics are held to the CPU's on the first 128 cells of the same two
matrices (MMD 1e-4, Sinkhorn 1e-3 relative, the same iteration count), a
real-versus-real split must read near zero, and the eval's seconds and peak
memory are printed. Phases 1b and 1d also hold the any-width designs
(decoder_tail_gen.cu, encoder_pool_gen.cu) at the corners of the widths the
JAX gate sends them (E 16 and 128, head widths 8 to 64, 1 and 64 latent
tokens or inducing points, the MLP rule's smallest and largest hidden
widths; the tail also at 65, 128 and 256 latent tokens) and at phase 13's
two shapes against their plain versions, by
`held_bf16`'s bounds with the plain version's own distance in another
summation order as a floor, each backward (and each pool forward) run twice
to the same bits, and time both directions at phase 13's shapes beside
their bounds. Phase 13 runs `scldm_torch.cli.train` on
configs/vae_training.yaml as shipped (bf16) at two other widths through the
in-memory shard: dentate (G = 17,002, its window) with model.vae.n_embed=64,
n_head_cross=4, n_inducing_points=32 (the module encoder and the tail), and
parse1m (G = 2,000) with n_embed=128, n_head_cross=8, n_inducing_points=64
(the dense pool and the tail), and dentate again with 128 inducing points
(the tail over two 64-key tiles, its loss falling over a row a step), 8
steps of B = 128 each with one launch of each kernel a step, printing train
cells/s and peak memory; it holds one
kernel-path step of an f32 VAE at each width against the module path at
phase 3's bounds and times the two paths in turns with their peak memory,
and at the dentate width takes three
`VAETask(fused_pool=True)` steps through the window pool at E = 64, one held
against the module MCAB at phase 5's bounds. Phase 14 runs the model variants
JAX's builders take through `cli.train` as shipped (bf16), a metrics.csv row a
step whose loss must fall: dentate under `agg_func=softbin` (the tail a step
each way), parse1m under `agg_func=sqrt` (the tail, no dense pool: JAX's gate
needs log1p; then three `VAETask(fused_pool=True)` steps through the window
pool, one held against the module MCAB; then `VAETask(fused_trunk=True)` at
dentate under softbin through the trunk kernels), dentate with dropout, no positional
table, its own decoder embedding and per-token theta, and dentate under the
Gaussian head (no kernel at all: JAX's gates close), the census VAE at B = 32
on the module decoder with and without `remat_cross` + `cross_chunks=8` (step
times and peak memory), and `train_ldm` over the softbin VAE with a dopri5
generation at DiT dropout 0.1 (no DiT kernel) and 0 (the DiT kernels). Phase 15
runs the rest of the transport family, joint finetuning and the lean loss at
full dentate width: four LDM steps under GVP/velocity, VP/noise/likelihood
and Linear/score/velocity through the DiT block kernels (the first step held
to the module DiT), dopri5 CFG generation of the score-trained DiT through
the forward kernel, `sample_sde` Euler (250 steps, Mean) and Heun (100,
Tweedie) through `fused_dit_forward` held to the module DiT on the same
normals, the likelihood ODE (euler, 50 steps) on the module DiT, `train_ldm`
with `model.vae_as_tokenizer.train=true` (no DiT kernel launch, JAX's gates;
the checkpoint's encoder moved, its decoder did not) and `inference`
generation that decodes with the finetuned VAE, and `VAETask(lean_loss=True)`
against the dense loss at dentate (the tail kernels) and at census as shipped
(the bf16 `swiglu_vec`), each with ms per step and peak memory in turns.
Phase 16 runs the parallel layouts on the one card in child processes of
this script under torchrun's environment, the kernels already built: (a) one
rank over NCCL, where the dentate VAE step (rows 3-4) and LDM step (rows
1-2) through the data-parallel all-reduce of a one-rank mesh repeat the
steps without a process group bit for bit, timed against them in turns,
then `cli.train` with `training.fsdp=true` at world 1; (b) two ranks sharing
the card over gloo, after a probe of the collectives gloo takes on CUDA
tensors (an arm whose collective it refuses is left out and named): data
parallelism at B / 2 a rank against one process at B on the dentate VAE
(rows 3-4 on both ranks: the loss at 1e-4, each gradient within 1e-2 of its
largest, within 1e-6 of the mean of one process's gradients at each half)
and LDM (rows 1-2: loss and gradients at 1e-4), FSDP on the census VAE as
shipped through the fused gate (rows 16-17 in bf16 on the gathered weights,
once each way a step; 8 cells a rank against 16 in one process at phase 6's
bf16 bound, each rank's parameter, AdamW and peak bytes), and gene-SP census generation
at n_model=2 (batch 16, euler-50, the draws injected) against one process
at `held_bf16`'s bound with each rank's peak memory. Phase 17 runs the
"model" axis's Megatron and GPipe layouts the same way: (b) two gloo ranks
sharing the card, (c) on a machine with two or four cards NCCL a card a
rank: the census DiT as GPipe stages (B = 16 in 4 microbatches, rows 1-2 on
each stage's blocks, held to the one-process fused step at 1e-4) and
euler-50 generation from the pipeline task (row 1 on each rank, the decode
gene-parallel; latents and mu against one process), the census VAE as
shipped at n_model = W (rows 16-17 in bf16 on each rank's hidden slice,
loss and gathered gradients at phase 6's bf16 bound, each rank's parameter,
AdamW and peak bytes), one f32 Megatron census LDM step and euler-50
generation from its state at 1e-4, beside a probe of gloo's point-to-point
send of a CUDA tensor (its answer printed). The
line before the last is a JSON summary of the kernels, each with its time
beside the least time the card could take for the same work; the last is
{"ok": true, "device": {...}}. Any failure
raises, so the script exits non-zero and prints no result; so does a machine
without CUDA, or a directory without the port's sources.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# batch); phase 6 builds it as shipped (bf16, remat) and, beside it, the f32 cut
# without remat that phases 1e, 6b and 9 and the earlier PRs use
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
    probabilities times values 2TE, the projection E^2, the SwiGLU 3E*Hd).
    The backward needs the forward's products again, then the token products
    and the adaLN product once more for the cotangents and once more for the
    weight gradients, and the attention's four T x T products dp, dq, dk and
    dv: 6TE a token with the forward's two. Both kernels run each product as
    three TF32 tensor-core passes, the least that keeps f32 accuracy on the
    tensor cores, so `bound_ms` is three times the function's operations
    against the TF32 peak; `f32_bound_ms` is them once against the f32 FMA
    peak, the yardstick before the kernels used the tensor cores. The
    backward kernel recomputes the scores and dp in both its attention
    kernels (over query tiles and over key tiles, which keeps it free of
    atomics): 9TE a token where the function needs 6TE, its operations as
    run in `as_run_bound_ms`. The elementwise work is left out. Bytes: each
    input read once and each output written once (backward: x, c, dy and the
    weights in; dx, dc and the weight gradients out)."""
    E = DIT["n_embed"]
    weights = 10 * E * E + 10 * E + 3 * E * HIDDEN
    if backward:
        n_bytes = 4 * (3 * R * T * E + 2 * R * E + 2 * weights)

        def flops(attention):
            return 2 * R * (3 * 6 * E * E
                            + T * (3 * (4 * E * E + 3 * E * HIDDEN) + attention * T * E))

        return {**bound(n_bytes, 3 * flops(6), TF32_FLOPS),
                "as_run_bound_ms": bound(n_bytes, 3 * flops(9), TF32_FLOPS)["bound_ms"],
                "f32_bound_ms": bound(n_bytes, flops(6), F32_FLOPS)["bound_ms"]}
    flops = 2 * R * (6 * E * E + T * (4 * E * E + 2 * T * E + 3 * E * HIDDEN))
    n_bytes = 4 * (2 * R * T * E + R * E + weights)
    return {**bound(n_bytes, 3 * flops, TF32_FLOPS),
            "f32_bound_ms": bound(n_bytes, flops, F32_FLOPS)["bound_ms"]}


def decoder_tail_bound(B: int, G: int, backward: bool) -> dict:
    """The decoder tail at B cells and G genes (E=32, 4 heads, 16 latent
    tokens, hidden 88). Its products take bf16 operands, so the bf16 tensor-
    core peak: per (cell, gene) pair, scores over the head blocks M*E,
    probabilities times values H*M*E, the up projection 2E*Hd, and the wv and
    wmu dots, two operations per multiply-add. The forward's bound counts
    these; `as_run_bound_ms` counts the
    scores as the kernel runs them, one k16 step a head block (H*M*2HD, the
    head width 8 zero-padded to 16). The backward's bound counts its products
    as the kernel runs them on the tensor cores (`function_bound_ms`: three
    times the forward's operations): the forward's, with the padded scores,
    and, in two bf16 passes (an f32 cotangent split hi + lo) d(hn) (2E*Hd),
    dp (E*H*M), dqp (H*M*HD), dw12 (2E*Hd), dvproj (H*M*E) and dkfull's head
    blocks (H*M*HD). Bytes: qp, q (G, E), kfull, vproj (B, H*M, E) and the
    weights in, the (B, G) logits out; the backward reads dy and writes a
    gradient of each input."""
    E, H, M, Hd = 32, 4, 16, 88
    HM, HD = H * M, E // H
    weights = 3 * E + 2 * E * Hd + Hd + 1
    inputs = 2 * G * E + 2 * B * H * M * E + weights
    flops = 2 * B * G * (M * E + H * M * E + 2 * E * Hd + Hd + E)
    fwd_as_run = 2 * B * G * (HM * 2 * HD + HM * E + 2 * E * Hd + Hd + E)
    if backward:
        n_bytes = 4 * (2 * inputs + B * G)
        as_run = 2 * B * G * (HM * 2 * HD + HM * E + 2 * E * Hd
                              + 2 * (2 * E * Hd + E * HM + HM * HD + 2 * E * Hd + HM * E + HM * HD))
        return {**bound(n_bytes, as_run, BF16_FLOPS),
                "function_bound_ms": bound(n_bytes, 3 * flops, BF16_FLOPS)["bound_ms"]}
    n_bytes = 4 * (inputs + B * G)
    return {**bound(n_bytes, flops, BF16_FLOPS),
            "as_run_bound_ms": bound(n_bytes, fwd_as_run, BF16_FLOPS)["bound_ms"]}


def time_in_turns(kernel, plain, reps: int) -> tuple:
    """(kernel ms, plain ms), each the mean of two CUDA-event timings of
    `reps` calls taken in turns (plain, kernel, kernel, plain) after a
    warm-up."""
    for f in (kernel, plain):
        cuda_ms(f, 2)
    turns = [cuda_ms(f, reps) for f in (plain, kernel, kernel, plain)]
    return (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2


P17_MICRO = 4  # pipeline microbatches of the census DiT step (B = 16: 4 rows each)
# (T, R) of phase 1: the dentate sampler's rows (T = 16, R = 3B = 384) and a
# ragged R, the census DiT's (T = 64): the sampler's 3B rows at a generation
# batch of 16, the training step's B = 16, twice that, a pipeline stage's
# microbatch of it (phase 17) and a ragged R; and the long-latent pair's
# (T = 1,024: 3 x LONG_GEN_BATCH rows)
DIT_FWD_CASES = ((16, 384), (16, 5), (64, 3 * CENSUS_LDM_BATCH), (64, CENSUS_LDM_BATCH),
                 (64, 2 * CENSUS_LDM_BATCH), (64, CENSUS_LDM_BATCH // P17_MICRO), (64, 5),
                 (1024, 12))
# the shapes whose forward is run twice and held to the same bits
DIT_FWD_REPEAT = ((16, 384), (64, 3 * CENSUS_LDM_BATCH))
# (T, R) of phase 1c: the dentate LDM step's rows (T = 16, R = B = 128) and a
# ragged R, the census step's (T = 64: B = 16, twice that, a pipeline stage's
# microbatch of it, a ragged R) and the long-latent pair's (T = 1,024: B = 16,
# and a ragged R = 3)
DIT_BWD_CASES = ((16, 128), (16, 5), (64, CENSUS_LDM_BATCH), (64, 2 * CENSUS_LDM_BATCH),
                 (64, CENSUS_LDM_BATCH // P17_MICRO), (64, 5), (1024, CENSUS_LDM_BATCH),
                 (1024, 3))
# the shapes whose backward is run twice and held to the same bits
DIT_BWD_REPEAT = ((16, 128), (64, CENSUS_LDM_BATCH))
# from this T on the kernel is held against the plain version on f64 inputs
DIT_BWD_F64_MIN_T = 1024


def phase1_dit_block(seed: int) -> dict:
    """dit_block vs dit_block_reference (rtol = atol = 1e-4, f32 both, sums
    in other orders; the kernel's three TF32 passes a product keep f32
    accuracy) at DIT_FWD_CASES: the dentate sampler's rows (R = 3B = 384 of
    T = 16), the census sampler's (R = 48 of T = 64 at a generation batch of
    16) and training step's (R = 16, and 32, and a pipeline stage's
    microbatch of 4), ragged Rs and the long-latent
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


def narrow_pool_bwd_bound(B: int, N: int, dense: bool) -> dict:
    """`encoder_pool_bound`'s bound of the narrow backward (the function), and
    `as_run_bound_ms`, the backward as `encoder_pool.cu` runs it: per token
    the k/v recompute, dx2 and the weight gradients (6E^2 multiply-adds) and
    the scores (Q*E) in one bf16 pass each, v . dnum, dv, dk and dqfull (Q*E
    each) in three, over the bf16 peak; its bytes add the workspace of
    partial sums, written once and read once (the library's
    `scldm_encoder_pool_workspace_floats`)."""
    from scldm_torch.kernels import build

    E, H, Q = 32, 4, 16
    f = encoder_pool_bound(B, N, True, dense)
    weights = Q * E + 2 * E + 2 * E * E
    table = N * E if dense else B * N * E
    inputs = table + (B * N if dense else 0) + weights + B * Q * E + 2 * B * Q * H
    ws = build.load().scldm_encoder_pool_workspace_floats(B, N, int(dense))
    as_run = bound(4 * (inputs + table + weights + 2 * ws),
                   2 * B * N * (6 * E * E + 13 * Q * E), BF16_FLOPS)
    return {**f, "as_run_bound_ms": as_run["bound_ms"], "as_run_bound_by": as_run["bound_by"]}


def narrow_pool_fwd_bound(B: int, N: int, dense: bool) -> dict:
    """`encoder_pool_bound`'s bound of the narrow forward (the function), and
    `as_run_bound_ms`, the forward as `encoder_pool.cu` runs it: two passes
    over each cell's tokens, pass 1 k and the scores, pass 2 k, v, the scores
    and the pooled values (3E^2 + 3Q*E multiply-adds a token, one bf16 pass
    each) over the bf16 peak; its bytes add the rows it reads again (the
    library's `scldm_encoder_pool_forward_rows`: the candidates of each row's
    max, and in pass 2 the rows past the warps' bf(x2) caches), with their
    counts (dense)."""
    from scldm_torch.kernels import build

    E, H, Q = 32, 4, 16
    f = encoder_pool_bound(B, N, False, dense)
    weights = Q * E + 2 * E + 2 * E * E
    src = N * E + B * N if dense else B * N * E
    again = B * (build.load().scldm_encoder_pool_forward_rows(N) - N) * (E + (1 if dense else 0))
    as_run = bound(4 * (src + again + weights + B * Q * E + 2 * B * Q * H),
                   2 * B * N * (3 * E * E + 3 * Q * E), BF16_FLOPS)
    return {**f, "as_run_bound_ms": as_run["bound_ms"], "as_run_bound_by": as_run["bound_by"]}


def bf16_distance(got, want, near: float = 1e-4) -> tuple:
    """(max abs error, the reference's largest magnitude, share of entries
    beyond `near` of it) of `got` against `want`."""
    scale = want.abs().max().item()
    d = (got - want).abs()
    return d.max().item(), scale, (d > near * scale).float().mean().item()


def held_bf16(what: str, got, want, near: float = 1e-4) -> tuple:
    """(max abs error, its share of the reference's largest magnitude, share
    of entries beyond `near` of it, `near`) of a kernel that rounds the same
    operands to bf16 as its plain version and sums in another order: such an
    order flips a bf16 rounding now and then, which moves an entry by up to
    about 1% of its tensor's largest magnitude. Raises beyond 1e-2 of that
    magnitude, or with more than 5% of the entries beyond `near` of it."""
    err, scale, beyond = bf16_distance(got, want, near)
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
    plain block) at DIT_BWD_CASES: the dentate LDM step's shape (R = 128 rows
    of T = 16), the census step's (R = 16 of T = 64, 32, and a pipeline
    stage's microbatch of 4), the long-latent
    pair's (R = 16 of T = 1,024) and ragged Rs. dx and dc at rtol = atol =
    1e-4; each weight gradient within 1e-4 of its tensor's largest magnitude:
    f32 both, the weight gradients summed over R*T tokens in other orders.
    At T = 1,024 the f32 plain version itself misses those bounds for dc
    (sums over 1,024 tokens: |dc| reaches a few hundred), so there the
    kernel is held against the plain version on the same inputs in f64 at
    the same bounds, and the f32 plain version's distance to that and the
    kernel's to the f32 plain version are printed. The same bits on a second
    run at DIT_BWD_REPEAT. Returns {(T, R): {max_abs_err, ms, plain_ms}}."""
    import torch

    from scldm_torch.ops import fused_dit

    E, H = DIT["n_embed"], DIT["n_head"]
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    w = random_block_weights(g)
    out = {}
    for T, R in DIT_BWD_CASES:
        x, dy = (torch.randn(R, T, E, generator=g, device="cuda") for _ in range(2))
        c = torch.randn(R, E, generator=g, device="cuda")
        dx, dc, dw = fused_dit.dit_block_bwd(x, c, w, dy, H, EPS)
        torch.cuda.synchronize()
        plain = fused_dit.dit_block_backward_reference(x, c, w, dy, H, EPS)
        f64 = T >= DIT_BWD_F64_MIN_T
        rx, rc, rw = fused_dit.dit_block_backward_reference(
            x.double(), c.double(), {k: v.double() for k, v in w.items()}, dy.double(), H,
            EPS) if f64 else plain
        worst, report = 0.0, []
        for name, got, want in [("dx", dx, rx), ("dc", dc, rc),
                                *((k, dw[k], rw[k]) for k in fused_dit.WEIGHT_NAMES)]:
            got = got.to(want.dtype)
            if name in ("dx", "dc"):
                torch.testing.assert_close(got, want, **TOL)
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            if name not in ("dx", "dc") and (scale == 0 or err > 1e-4 * scale):
                raise AssertionError(f"dit_block_bwd {name} at T={T}, R={R}: max abs err "
                                     f"{err:.3e}, max |ref| {scale:.3e}")
            worst = max(worst, err)
            report.append(f"{name} {err:.2e} (max {scale:.2e})")
        if f64:  # printed: the f32 plain version's own distance, and the kernel's to it
            report.append(f"held against the plain version in f64; the f32 one's dc is "
                          f"{(plain[1].double() - rc).abs().max().item():.2e} off it; kernel to "
                          f"the f32 plain version dx {(dx - plain[0]).abs().max().item():.2e}, dc "
                          f"{(dc - plain[1]).abs().max().item():.2e}")
        del plain, rx, rc, rw
        if (T, R) in DIT_BWD_REPEAT:
            ax, ac, aw = fused_dit.dit_block_bwd(x, c, w, dy, H, EPS)
            if not (torch.equal(dx, ax) and torch.equal(dc, ac)
                    and all(torch.equal(dw[k], aw[k]) for k in fused_dit.WEIGHT_NAMES)):
                raise AssertionError(f"dit_block_bwd at T={T}, R={R}: a second run gave other "
                                     "bits")
            report.append("same bits twice")
        ms, plain_ms = time_in_turns(
            lambda: fused_dit.dit_block_bwd(x, c, w, dy, H, EPS),
            lambda: fused_dit.dit_block_backward_reference(x, c, w, dy, H, EPS), 10)
        out[(T, R)] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}
        b = dit_block_bound(R, backward=True, T=T)
        log(f"phase1c dit_block_bwd T={T} R={R}: " + ", ".join(report))
        log(f"phase1c dit_block_bwd T={T} R={R}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, three TF32 passes; "
            f"{b['as_run_bound_ms']:.4f} ms as run; {b['f32_bound_ms']:.4f} ms in f32 FMA)")
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


# the kernels behind the narrow pools' entry points
NARROW_POOL_KERNELS = {"fwd": ("pool_fwd_mma",), "bwd": ("pool_bwd_kernel", "pool_bwd_sum")}


def phase1d_encoder_pool(seed: int) -> dict:
    """The encoder-pool kernels, dense and window, forward and backward,
    against their plain versions with autograd, at the VAE steps' shapes
    (dense: B=128 over the parse1m / replogle G=2,000 genes; window: B=128
    over the dentate S=6,147-token window) and ragged ones, timing both;
    then the dense pool's pooled tokens against the module MCAB at a ragged
    shape where the zero-row correction is not 0 (G=300 genes, an S=250
    window). The kernels and the plain versions round the same operands to
    bf16: `held_bf16`'s bounds, with `POOL_NUM_NEAR` for num. All four sum
    in a fixed order: at every shape each runs twice and repeats its bits.
    At B=128 each is timed in turns with its plain version a call through
    its entry point (`ms`) and on the device (`device_ms`: the profiler,
    every kernel of the call), beside its bound as run."""
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
        for part, flat in (("fwd", lambda r: r), ("bwd", lambda r: (r[0], r[1], *r[2]))):
            first, second = (flat(fns[part][0]()) for _ in range(2))
            if not all(torch.equal(a, c) for a, c in zip(first, second)):
                raise AssertionError(f"{variant} pool {part} at B={B}, N={N}: a second run gave "
                                     "other bits")
            log(f"phase1d {variant}_pool_{part} B={B} N={N}: repeats its bits")
        del first, second
        for part, (kernel, plain) in fns.items():
            for f in (kernel, plain):
                cuda_ms(f, 2)  # warm-up
            turns = [cuda_ms(f, 10) for f in (plain, kernel, kernel, plain)]
            ms = ((turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2)
            dev = device_ms(kernel, 3, NARROW_POOL_KERNELS[part]) if B == 128 else None
            log(f"phase1d {variant}_pool_{part} B={B} N={N}: kernel {ms[0]:.4f} ms"
                + (f" ({dev:.4f} ms on the device)" if dev is not None else "")
                + f"  plain {ms[1]:.4f} ms")
            if B == 128:
                out[f"{variant}_{part}"] = {"max_abs_err": max(e for e, *_ in worst[part].values()),
                                            "ms": ms[0], "plain_ms": ms[1], "device_ms": dev}
                b = (narrow_pool_bwd_bound if part == "bwd" else narrow_pool_fwd_bound)(B, N,
                                                                                        dense)
                log(f"phase1d {variant}_pool_{part} B={B} N={N}: bound {b['bound_ms']:.4f} ms "
                    f"({b['bound_by']}; as run {b['as_run_bound_ms']:.4f}, "
                    f"{b['as_run_bound_by']})")

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


# -- phases 1b and 1d at the other widths, and phase 13 ----------------------------

# phase 13's widths: configs/model/vae_base.yaml with model.vae.n_embed,
# n_head_cross and n_inducing_points overridden; Hd is the MLP rule's hidden width
# at the shipped multiple_of 4. The third trains at dentate genes over 128 latent
# tokens (two 64-key tiles of the tail); the fourth at parse1m genes over 128
# inducing points (the dense pool's two 64-query tiles, and the tail's two key tiles)
WIDTHS = {"dentate": dict(E=64, H=4, M=32, Hd=172), "parse1m": dict(E=128, H=8, M=64, Hd=344),
          "dentate_m128": dict(E=64, H=4, M=128, Hd=172),
          "parse1m_q128": dict(E=128, H=8, M=128, Hd=344)}
# (E, n_head, M, Hd, B, G) of phase 1b's grid: its corners (E 16 and 128; head
# widths 8 and 16 at E = 16, 8 and 64 at E = 128; 1 and 64 latent tokens; the MLP
# rule's hidden widths at multiple_of 1 and 64), more latent tokens than one
# 64-key tile (65, 128 and 256) and phase 13's two training shapes
TAIL_GRID = ((16, 2, 1, 42, 32, 2_000), (16, 1, 64, 64, 32, 2_000),
             (128, 16, 64, 341, 16, 2_000), (128, 2, 1, 384, 32, 2_000),
             (128, 16, 1, 384, 32, 2_000), (128, 2, 64, 341, 16, 2_000),
             (32, 4, 65, 88, 16, 2_000), (64, 4, 128, 172, 16, 2_000),
             (128, 8, 256, 344, 16, 2_000),
             (64, 4, 32, 172, 128, N_GENES), (128, 8, 64, 344, 128, PARSE_GENES))
# (variant, E, n_head, Q, B, N) of phase 1d's grid: the same corners, each variant,
# more inducing points than one 64-query tile (65, 128 and 256, at E = 64 and 128,
# both variants), and phase 13's two shapes: the window pool at the dentate window
# (VAETask(fused_pool=True) at E = 64), the dense pool at parse1m (E = 128)
POOL_GRID = (("window", 16, 2, 1, 16, 2_000), ("dense", 16, 2, 64, 16, 2_000),
             ("dense", 16, 1, 1, 16, 2_000), ("window", 16, 1, 64, 16, 2_000),
             ("window", 128, 16, 64, 16, 2_000), ("dense", 128, 16, 1, 16, 2_000),
             ("dense", 128, 2, 64, 16, 2_000), ("window", 128, 2, 1, 16, 2_000),
             ("window", 64, 4, 65, 16, 2_000), ("dense", 64, 4, 65, 16, 2_000),
             ("window", 128, 8, 128, 16, 2_000), ("dense", 128, 8, 128, 16, 2_000),
             ("dense", 64, 4, 256, 16, 2_000), ("window", 128, 8, 256, 16, 2_000),
             ("window", 64, 4, 32, 128, WINDOW), ("dense", 128, 8, 64, 128, PARSE_GENES))
# the kernels behind the any-width designs' entry points (the packers and the
# fixed-order sum included)
GEN_TAIL_KERNELS = {"fwd": ("tailw_",), "bwd": ("tailw_",)}
GEN_POOL_KERNELS = {"fwd": ("poolw_",), "bwd": ("poolw_",)}


def held_bf16_or_order(what: str, got, want, again, near: float = 1e-4) -> tuple:
    """`held_bf16`, with the plain version's own sensitivity to its summation
    order as a floor: `again` is the plain version evaluated in another
    order of every sum (`order_flips`). Where the operands' bf16 roundings
    cascade over long sums (a thousand keys a cell, a sum over every token
    of terms that cancel), two f32 orders of the plain version alone flip
    enough of them to pass `held_bf16`'s 5%: there the kernel is held to
    twice the plain version's own distance. Returns held_bf16's tuple and
    the plain version's own share beyond `near`."""
    err, scale, beyond = bf16_distance(got, want, near)
    own_err, _, own_beyond = bf16_distance(again, want, near)
    if scale == 0 or err > max(1e-2 * scale, 2 * own_err) or beyond > max(5e-2, 2 * own_beyond):
        raise AssertionError(f"{what}: max abs err {err:.3e}, max |ref| {scale:.3e}, share beyond "
                             f"{near:g} of it {beyond:.2e}; the plain version in another order: "
                             f"{own_err:.3e}, {own_beyond:.2e}")
    return (err, err / scale, beyond, near), own_beyond


def order_flips(n: int):
    """A permutation of n indices that reverses them: another summation order."""
    import torch

    return torch.arange(n - 1, -1, -1, device="cuda")


def tail_plain_reordered(qp, q, kf, vp, w, dy, H: int, M: int):
    """The plain tail's logits and gradients (as `decoder_tail_bwd` returns
    them, dkfull in full) with every sum taken in another order: the genes,
    each head's columns of E and keys, and the hidden columns reversed, then
    put back in place."""
    import torch

    from scldm_torch.ops import fused_decoder as fd

    G, E = qp.shape
    Hd, hd = w[2].shape[1] // 2, E // H
    pe = torch.cat([h * hd + order_flips(hd) for h in range(H)])
    pm = torch.cat([h * M + order_flips(M) for h in range(H)])
    ph, pg = order_flips(Hd), order_flips(G)
    ln2g, ln2b, w12, wv, wmu, bmu = w
    w12p = torch.cat([w12[:, :Hd][pe][:, ph], w12[:, Hd:][pe][:, ph]], 1)
    ins = [qp[pg][:, pe], q[pg][:, pe], kf[:, pm][:, :, pe], vp[:, pm][:, :, pe],
           ln2g[:, pe], ln2b[:, pe], w12p, wv[:, ph], wmu[:, pe], bmu]
    leaves = [t.contiguous().requires_grad_() for t in ins]
    ref = fd.decoder_tail_reference(*leaves[:4], leaves[4:], H, EPS)
    g = torch.autograd.grad(ref, leaves, dy[:, pg].contiguous())
    ie, im, ih, ig = (torch.argsort(p) for p in (pe, pm, ph, pg))
    dw = g[6]
    return [ref.detach()[:, ig], g[0][ig][:, ie], g[1][ig][:, ie], g[2][:, im][:, :, ie],
            g[3][:, im][:, :, ie], g[4][:, ie], g[5][:, ie],
            torch.cat([dw[:, :Hd][ie][:, ih], dw[:, Hd:][ie][:, ih]], 1), g[7][:, ih],
            g[8][:, ie], g[9]]


def pool_plain_reordered(reference, counts, x, cot, H: int) -> dict:
    """`pool_outputs_and_grads` of the plain pool with every sum taken in
    another order: the tokens and each head's columns of E reversed, then put
    back in place."""
    import torch

    E = x["wk"].shape[0]
    hd = E // H
    pe = torch.cat([h * hd + order_flips(hd) for h in range(H)])
    dense = counts is not None
    N = x["src"].shape[0] if dense else x["src"].shape[1]
    pn = order_flips(N)
    src = x["src"][pn][:, pe] if dense else x["src"][:, pn][:, :, pe]
    xp = dict(src=src.contiguous(), q=x["q"][:, pe].contiguous(), ln1g=x["ln1g"][:, pe],
              ln1b=x["ln1b"][:, pe], wk=x["wk"][pe][:, pe].contiguous(),
              wv=x["wv"][pe][:, pe].contiguous())
    cp = counts[:, pn].contiguous() if dense else None
    r = pool_outputs_and_grads(reference, cp, xp, (cot[0][:, :, pe].contiguous(), cot[1]), H)
    ie, iN = torch.argsort(pe), torch.argsort(pn)
    fwd, bwd = r["fwd"], r["bwd"]
    return {"fwd": {"num": fwd["num"][:, :, ie], "den": fwd["den"], "m": fwd["m"]},
            "bwd": {"dsrc": bwd["dsrc"][iN][:, ie] if dense else bwd["dsrc"][:, iN][:, :, ie],
                    "dq": bwd["dq"][:, ie], "dln1g": bwd["dln1g"][:, ie],
                    "dln1b": bwd["dln1b"][:, ie], "dwk": bwd["dwk"][ie][:, ie],
                    "dwv": bwd["dwv"][ie][:, ie]}}


def tail_function_bound(B: int, G: int, E: int, H: int, M: int, Hd: int,
                        backward: bool) -> dict:
    """The decoder tail's function at any width: per pair the scores over the
    head blocks (M*E), the probabilities times values (H*M*E), the up
    projection (2E*Hd) and the wv and wmu dots, two operations per
    multiply-add at the bf16 tensor-core peak; the backward three times the
    forward's operations (the least a recompute VJP takes). Bytes: qp, q,
    kfull, vproj and the weights in, the logits out; backward also dy in and
    a gradient of each input out."""
    weights = 3 * E + 2 * E * Hd + Hd + 1
    inputs = 2 * G * E + 2 * B * H * M * E + weights
    flops = 2 * B * G * (M * E + H * M * E + 2 * E * Hd + Hd + E)
    if backward:
        return bound(4 * (2 * inputs + B * G), 3 * flops, BF16_FLOPS)
    return bound(4 * (inputs + B * G), flops, BF16_FLOPS)


def phase1b_decoder_tail_grid(seed: int) -> dict:
    """The decoder-tail kernels at the other widths the JAX gate sends them
    (TAIL_GRID: the any-width design, decoder_tail_gen.cu), forward and
    backward, against the plain version on the same operands: the logits,
    and the backward's gradients for one fixed cotangent (the plain
    version's autograd, its dkfull on the head blocks the kernels write), by
    `held_bf16`'s bounds with the plain version's own distance in another
    summation order as a floor (`held_bf16_or_order`,
    `tail_plain_reordered`). Each backward runs twice and repeats its bits; one
    launch each way is counted a call. At phase 13's two shapes each
    direction is timed in turns with its plain version (a call through the
    entry point and on the device) beside the function's bound. Returns
    {(part, E): row of the kernels line}."""
    import torch

    from scldm_torch.ops import fused_decoder as fd

    g = torch.Generator(device="cuda").manual_seed(seed + 13)

    def rnd(*shape, scale=0.3, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    out = {}
    for E, H, M, Hd, B, G in TAIL_GRID:
        raw = [rnd(E, shift=1.0), rnd(E), rnd(E, Hd), rnd(E, Hd), rnd(Hd, E), rnd(E, 1), rnd(1)]
        w = [t.contiguous() for t in fd.pack_weights(*raw)]
        kf, vp = fd.build_attention_operands(rnd(B, M, E), rnd(B, M, E), rnd(E, E), H)
        qp, q, dy = rnd(G, E), rnd(G, E), rnd(B, G, scale=1.0)
        args = (qp, q, kf, vp, w)
        counts = (fd.DECODER_TAIL_FWD_LAUNCHES.count, fd.DECODER_TAIL_BWD_LAUNCHES.count)
        logits = fd.decoder_tail_fwd(*args, H, EPS)
        grads = fd.decoder_tail_bwd(*args, dy, H, EPS)
        again = fd.decoder_tail_bwd(*args, dy, H, EPS)
        torch.cuda.synchronize()
        if (fd.DECODER_TAIL_FWD_LAUNCHES.count - counts[0],
                fd.DECODER_TAIL_BWD_LAUNCHES.count - counts[1]) != (1, 2):
            raise AssertionError(f"decoder_tail at {(E, H, M, Hd)}: launches not counted")
        if fd.specialised(E, H, M, Hd, True):
            raise AssertionError(f"{(E, H, M, Hd)} is the specialised design's shape")
        flat = lambda r: [*r[:4], *r[4]]  # noqa: E731
        if not all(torch.equal(a, b) for a, b in zip(flat(grads), flat(again))):
            raise AssertionError(f"decoder_tail_bwd at {(E, H, M, Hd, B, G)}: a second run "
                                 "gave other bits")
        del again
        leaves = [t.detach().clone().requires_grad_() for t in (*args[:4], *w)]
        ref = fd.decoder_tail_reference(*leaves[:4], leaves[4:], H, EPS)
        want = torch.autograd.grad(ref, leaves, dy)
        hd = E // H
        block = torch.zeros(H * M, E, device="cuda")
        for h in range(H):
            block[h * M:(h + 1) * M, h * hd:(h + 1) * hd] = 1
        names = ("dqp", "dq", "dkfull", "dvproj", *(f"d{n}" for n in fd.WEIGHT_NAMES))
        wants = [ref.detach(), *want[:2], want[2] * block, *want[3:]]
        again = tail_plain_reordered(qp, q, kf, vp, w, dy, H, M)
        again[3] = again[3] * block
        worst, own = {}, {}
        for name, got, w_, a_ in zip(("logits", *names), [logits, *flat(grads)], wants, again):
            if M == 1 and name in ("dqp", "dkfull"):
                # one key: p = 1 whatever the scores, so these are exactly 0 both ways
                if w_.abs().max() != 0 or got.abs().max() != 0:
                    raise AssertionError(f"decoder_tail_bwd at {(E, H, M, Hd)} {name}: not 0")
                worst[name], own[name] = (0.0, 0.0, 0.0, 1e-4), 0.0
                continue
            worst[name], own[name] = held_bf16_or_order(
                f"decoder_tail at {(E, H, M, Hd)} {name}", got, w_.reshape(got.shape),
                a_.reshape(got.shape))
        log(f"phase1b grid decoder_tail E={E} H={H} M={M} Hd={Hd} B={B} G={G}: "
            + report_bf16(worst) + "; the plain version in another order, share beyond: "
            + ", ".join(f"{k} {v:.1e}" for k, v in own.items() if v)
            + "; the backward repeats its bits")
        del again
        del ref, want, grads
        if B != 128:
            continue
        graph = fd.decoder_tail_reference(*leaves[:4], leaves[4:], H, EPS)
        fns = {"fwd": (lambda: fd.decoder_tail_fwd(*args, H, EPS),
                       lambda: fd.decoder_tail_reference(*args, H, EPS)),
               "bwd": (lambda: fd.decoder_tail_bwd(*args, dy, H, EPS),
                       lambda: torch.autograd.grad(graph, leaves, dy, retain_graph=True))}
        for part, (kernel, plain) in fns.items():
            ms, plain_ms = time_in_turns(kernel, plain, 5 if part == "fwd" else 3)
            dev = device_ms(kernel, 2, GEN_TAIL_KERNELS[part])
            b = tail_function_bound(B, G, E, H, M, Hd, part == "bwd")
            err = max(e for k, (e, *_) in worst.items() if (k == "logits") == (part == "fwd"))
            out[(part, E)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "device_ms": dev, **b}
            log(f"phase1b grid decoder_tail_{part} E={E} H={H} M={M} Hd={Hd} B={B} G={G}: "
                f"kernel {ms:.4f} ms ({dev:.4f} ms on the device), plain {plain_ms:.4f} ms, "
                f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); workspace "
                + (f"{4 * fd.decoder_tail_bwd_workspace_floats(B, G, Hd, E, H, M) / 1e6:.1f} MB"
                   if part == "bwd" else
                   f"{4 * fd.decoder_tail_fwd_workspace_floats(B, G, Hd, E, H, M) / 1e6:.1f} MB"))
        del graph
    return out


def phase1d_encoder_pool_grid(seed: int) -> dict:
    """The narrow encoder pools at the other widths the JAX gates send them
    (POOL_GRID: the any-width design, encoder_pool_gen.cu), dense and window,
    forward and backward, against their plain versions with autograd as
    phase 1d holds them (`pool_outputs_and_grads`: each its own m), by
    `held_bf16`'s bounds (num at POOL_NUM_NEAR) with the plain version's own
    distance in another summation order as a floor (`held_bf16_or_order`,
    `pool_plain_reordered`). Each direction runs twice and
    repeats its bits. At phase 13's two shapes each direction is timed in
    turns with its plain version (a call and on the device) beside its
    bound. Returns {(variant, part): row of the kernels line}."""
    import torch

    from scldm_torch.kernels import build
    from scldm_torch.ops import fused_encoder as fe

    g = torch.Generator(device="cuda").manual_seed(seed + 14)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    lib = build.load()
    out = {}
    for variant, E, H, Q, B, N in POOL_GRID:
        dense = variant == "dense"
        x = dict(src=rnd(N, E) if dense else rnd(B, N, E), q=rnd(Q, E),
                 ln1g=rnd(1, E, scale=0.3, shift=1.0), ln1b=rnd(1, E, scale=0.3),
                 wk=rnd(E, E, scale=E**-0.5), wv=rnd(E, E, scale=E**-0.5))
        counts = (torch.poisson(torch.full((B, N), 3.0, device="cuda"), generator=g)
                  * (torch.rand(B, N, generator=g, device="cuda") < 0.6)) if dense else None
        cot = (rnd(B, Q, E), rnd(B, Q * H))
        pool, reference = ((fe.encoder_pool, fe.encoder_pool_reference) if dense
                           else (fe.window_pool, fe.window_pool_reference))
        counters = ((fe.ENCODER_POOL_FWD_LAUNCHES, fe.ENCODER_POOL_BWD_LAUNCHES) if dense
                    else (fe.WINDOW_POOL_FWD_LAUNCHES, fe.WINDOW_POOL_BWD_LAUNCHES))
        before = [c.count for c in counters]
        got = pool_outputs_and_grads(pool, counts, x, cot, H)
        again = pool_outputs_and_grads(pool, counts, x, cot, H)
        torch.cuda.synchronize()
        if [c.count - n for c, n in zip(counters, before)] != [2, 2]:
            raise AssertionError(f"{variant} pool at {(E, H, Q)}: launches not counted")
        if not all(torch.equal(got[p][k], again[p][k]) for p in got for k in got[p]):
            raise AssertionError(f"{variant} pool at {(E, H, Q, B, N)}: a second run gave other "
                                 "bits")
        del again
        want = pool_outputs_and_grads(reference, counts, x, cot, H)
        again = pool_plain_reordered(reference, counts, x, cot, H)
        worst, own = {}, {}
        for p in want:
            worst[p] = {}
            for k, w in want[p].items():
                worst[p][k], own[k] = held_bf16_or_order(
                    f"{variant} pool at {(E, H, Q)} {k}", got[p][k], w, again[p][k],
                    POOL_NUM_NEAR if k == "num" else 1e-4)
        log(f"phase1d grid {variant}_pool E={E} H={H} Q={Q} B={B} N={N}: "
            + report_bf16({**worst["fwd"], **worst["bwd"]})
            + "; the plain version in another order, share beyond: "
            + ", ".join(f"{k} {v:.1e}" for k, v in own.items() if v)
            + "; both ways repeat their bits")
        del again
        if B != 128:
            continue
        pre = (counts,) if dense else ()
        qfull = fe.build_query_operand(x["q"], H)
        w = [x[k] for k in fe.WEIGHT_NAMES]
        fwd, bwd, fwd_ref, bwd_ref = (
            (fe.encoder_pool_fwd, fe.encoder_pool_bwd, fe.encoder_pool_reference,
             fe.encoder_pool_backward_reference) if dense else
            (fe.window_pool_fwd, fe.window_pool_bwd, fe.window_pool_reference,
             fe.window_pool_backward_reference))
        stats = (want["fwd"]["m"], *cot)
        fns = {"fwd": (lambda: fwd(*pre, x["src"], qfull, w, H, EPS),
                       lambda: fwd_ref(*pre, x["src"], qfull, w, H, EPS)),
               "bwd": (lambda: bwd(*pre, x["src"], qfull, w, *stats, H, EPS),
                       lambda: bwd_ref(*pre, x["src"], qfull, w, *stats, H, EPS))}
        for part, (kernel, plain) in fns.items():
            ms, plain_ms = time_in_turns(kernel, plain, 5)
            dev = device_ms(kernel, 3, GEN_POOL_KERNELS[part])
            b = encoder_pool_bound(B, N, part == "bwd", dense, E, H, Q)
            ws = lib.scldm_encoder_pool_gen_workspace_floats(B, N, E, H, Q, int(dense),
                                                             int(part == "bwd"))
            out[(variant, part)] = {"max_abs_err": max(e for e, *_ in worst[part].values()),
                                    "ms": ms, "plain_ms": plain_ms, "device_ms": dev, **b}
            log(f"phase1d grid {variant}_pool_{part} E={E} H={H} Q={Q} B={B} N={N}: kernel "
                f"{ms:.4f} ms ({dev:.4f} ms on the device), plain {plain_ms:.4f} ms, bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']}); workspace {4 * ws / 1e6:.1f} MB")
    return out


# (B, S, E, H, Q) of phase 1d's wide window pool: the census encoder's window
# (configs/model/vae_census.yaml, bench_census.py's batch), a ragged B and S at
# that width, the E = 256 encoder of tests/test_fused_encoder.py:227-254, the
# long-latent encoder's 1,024 inducing points (ragged S), a ragged query count
# and E = 768 (12 heads)
WIDE_POOL_CASES = ((CENSUS_BATCH, CENSUS_WINDOW, 512, 8, 64), (3, 1_030, 512, 8, 64),
                   (4, 600, 256, 4, 16), (2, 1_030, 512, 8, 1_024), (3, 700, 512, 8, 40),
                   (2, 300, 768, 12, 64))


# the shapes whose forward and backward run twice and repeat their bits: the
# census window and the long-latent encoder's 1,024 inducing points
WIDE_POOL_REPEAT = (WIDE_POOL_CASES[0], WIDE_POOL_CASES[3])
# the kernels behind the wide window pool's entry points
WIDE_POOL_KERNELS = ("gemm_bf16", "attn_fwd", "attn_merge", "exact_max", "attn_dkdv", "attn_dq",
                     "prep_", "ln_rows", "ln_bwd", "sum_dq", "sum_parts_kernel")
# The wide kernels are held against the plain version evaluated in f64 on
# the same inputs (as row 2 from DIT_BWD_F64_MIN_T): they compute the
# LayerNorm and each row max in f64, and two f32 summation orders of the
# LayerNorm and of k alone flip enough bf16 roundings at row maxima, each
# moving a row's m and with it the row's gradients, to bring demb's share
# beyond 1e-4 of its largest to `held_bf16`'s 5% (at 1,024 queries; at E =
# 768 too)


def wide_pool_bound(B: int, N: int, backward: bool, E: int, H: int, Q: int) -> dict:
    """The wide window pool over B cells of N tokens: `encoder_pool_bound`'s
    bound of the function (bf16 operands, the bf16 peak), and
    `as_run_bound_ms`, the products as the kernels run them: the queries
    padded to tiles of 64 (Qp); the backward recomputes the projection (2E^2
    multiply-adds a token) and the scores, runs dv, de and dk in its dk / dv
    kernel and de and dq in its dq kernel with the f32 operand (dnum or ds) in
    three bf16 passes, and recomputes the scores there too (17 Qp*E a token
    where the function's backward has 6 Q*E), then dx2 and dW (4E^2)."""
    qp = -(-Q // 64) * 64
    macs = (6 * E * E + 17 * qp * E) if backward else (2 * E * E + 2 * qp * E)
    table, weights = B * N * E, Q * E + 2 * E + 2 * E * E
    inputs = table + weights + B * Q * E + 2 * B * Q * H
    n_bytes = 4 * (inputs + table + weights if backward else inputs)
    return {**encoder_pool_bound(B, N, backward, False, E, H, Q),
            "as_run_bound_ms": bound(n_bytes, 2 * B * N * macs, BF16_FLOPS)["bound_ms"]}


def phase1d_wide_window_pool(seed: int) -> dict:
    """The wide window-pool kernels (forward and backward,
    `window_pool_wide.cu`) against their plain version with autograd at
    WIDE_POOL_CASES (the census window, ragged B and S, E = 256, the
    long-latent encoder's 1,024 inducing points, a ragged query count and E =
    768), `held_bf16`'s bounds with `POOL_NUM_NEAR` for num, as the narrow
    design, and `POOL_LN_GAIN_NEAR` for dln1g, against the plain version
    evaluated in f64 on the same inputs, printing the f32 plain version's
    share beyond the bounds to it and the kernel's to the f32 one; at
    WIDE_POOL_REPEAT both run
    twice and repeat their bits (no atomics, no race in the rings); kernel and
    plain timed in turns at the census shape, each a call through its entry
    point (`ms`), and the kernels' own device time a call under the profiler
    (`device_ms`). Returns {"fwd", "bwd"}: {max_abs_err, ms, plain_ms,
    device_ms} at that shape."""
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
        plain = pool_outputs_and_grads(fe.window_pool_reference, None, x, cot, H)
        want = pool_outputs_and_grads(
            fe.window_pool_reference, None, {k: t.double() for k, t in x.items()},
            tuple(t.double() for t in cot), H)
        near = {"num": POOL_NUM_NEAR, "dln1g": POOL_LN_GAIN_NEAR}
        worst = {part: {k: held_bf16(f"wide window pool {k} at B={B}, S={N}, E={E}, Q={Q}",
                                     got[part][k], w, near.get(k, 1e-4))
                        for k, w in want[part].items()} for part in want}
        log(f"phase1d wide window_pool B={B} S={N} E={E} H={H} Q={Q}: "
            + report_bf16({**worst["fwd"], **worst["bwd"]}))
        # printed: the shares beyond `near` of the f32 plain version to the f64
        # one, and of the kernel to the f32 one
        shares = {who: {k: bf16_distance(a[part][k], want[part][k] if who == "f32 plain"
                                         else plain[part][k], near.get(k, 1e-4))[2]
                        for part in want for k in want[part]}
                  for who, a in (("f32 plain", plain), ("kernel", got))}
        log(f"phase1d wide window_pool B={B} S={N} E={E} H={H} Q={Q}: share beyond of the f32 "
            "plain version to the f64 one " + ", ".join(
                f"{k} {v:.1e}" for k, v in shares["f32 plain"].items())
            + "; of the kernel to the f32 one "
            + ", ".join(f"{k} {v:.1e}" for k, v in shares["kernel"].items()))
        del got, want, plain
        qfull = fe.build_query_operand(x["q"], H)
        w = [x[k] for k in fe.WEIGHT_NAMES]
        if (B, N, E, H, Q) in WIDE_POOL_REPEAT:
            f1, f2 = (fe.window_pool_fwd(x["src"], qfull, w, H, EPS) for _ in range(2))
            b1, b2 = ((lambda r: [r[0], r[1], *r[2]])(
                fe.window_pool_bwd(x["src"], qfull, w, f1[2], *cot, H, EPS)) for _ in range(2))
            if not all(torch.equal(a, c) for a, c in (*zip(f1, f2), *zip(b1, b2))):
                raise AssertionError(f"wide window pool at B={B}, S={N}, E={E}, Q={Q}: a second "
                                     "run gave other bits")
            log(f"phase1d wide window_pool B={B} S={N} E={E} H={H} Q={Q}: forward and backward "
                "repeat their bits")
            del f1, f2, b1, b2
        if (B, N) != (CENSUS_BATCH, CENSUS_WINDOW):
            continue
        m = fe.window_pool_reference(x["src"], qfull, w, H, EPS)[2]
        fns = {"fwd": (lambda: fe.window_pool_fwd(x["src"], qfull, w, H, EPS),
                       lambda: fe.window_pool_reference(x["src"], qfull, w, H, EPS)),
               "bwd": (lambda: fe.window_pool_bwd(x["src"], qfull, w, m, *cot, H, EPS),
                       lambda: fe.window_pool_backward_reference(x["src"], qfull, w, m, *cot, H,
                                                                 EPS))}
        for part, (kernel, plain) in fns.items():
            ms, plain_ms = time_in_turns(kernel, plain, 10)
            dev = device_ms(kernel, 3, WIDE_POOL_KERNELS)
            b = wide_pool_bound(B, N, part == "bwd", E, H, Q)
            out[part] = {"max_abs_err": max(e for e, *_ in worst[part].values()), "ms": ms,
                         "plain_ms": plain_ms, "device_ms": dev}
            log(f"phase1d wide window_pool_{part} B={B} S={N} E={E}: kernel {ms:.4f} ms a call "
                f"({dev:.4f} ms on the device)  plain {plain_ms:.4f} ms  bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']}; as run {b['as_run_bound_ms']:.4f})")
        del x, cot, fns
        torch.cuda.empty_cache()
    return out


def swiglu_vec_bound(R: int, E: int, Hd: int, backward: bool) -> dict:
    """swiglu_vec over R rows, f32. Operations: the up projection 2*R*E*2Hd
    plus the wv contraction 2*R*Hd, three times that for the backward; the
    gate is left out. The kernels run every product as three TF32
    tensor-core passes, the least that keeps f32 accuracy on the tensor
    cores, so `bound_ms` is three times the operations against the TF32
    peak; `f32_bound_ms` is them once against the f32 FMA peak, the yardstick
    of the scalar kernels they replaced. Bytes: x, w12 and wv in and out (R)
    out; the backward reads ds (R) too and writes dx (R, E), dw12 and dwv."""
    flops = (2 * R * E * 2 * Hd + 2 * R * Hd) * (3 if backward else 1)
    weights = E * 2 * Hd + Hd
    if backward:
        n_bytes = 4 * (R * E + R + weights + R * E + weights)
    else:
        n_bytes = 4 * (R * E + weights + R)
    return {**bound(n_bytes, 3 * flops, TF32_FLOPS),
            "f32_bound_ms": bound(n_bytes, flops, F32_FLOPS)["bound_ms"]}


def swiglu_vec_bf16_bound(R: int, E: int, Hd: int, backward: bool) -> dict:
    """swiglu_vec over R rows of bf16 operands: the same operations as the
    f32 bound, once over the bf16 peak (one tensor-core pass a product);
    bytes: x, w12 and wv in bf16 and s out in f32, the backward's ds in and
    dx out as its operands (bf16) and dw12 and dwv."""
    flops = (2 * R * E * 2 * Hd + 2 * R * Hd) * (3 if backward else 1)
    weights = 2 * (E * 2 * Hd + Hd)
    n_bytes = (2 * R * E + weights + 4 * R) + ((4 * R + 2 * R * E + weights) if backward else 0)
    return bound(n_bytes, flops, BF16_FLOPS)


# the kernels behind the swiglu_vec and fused_swiglu_gate entry points
SWIGLU_KERNELS = ("swiglu_tc", "swiglu_sum_parts")


def check_f32_matmuls() -> None:
    """The plain versions are the f32 yardstick: no TF32 in their products."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on: the plain f32 versions would not be exact f32")


def phase1e_swiglu_vec(seed: int) -> dict:
    """swiglu_vec (forward and backward kernels) against its plain version
    at the census decoder's rows (R = 16 x 36,601, E = 512, Hd = 1,408) and
    ragged shapes, in both of the kernels' dtypes. f32: three ragged shapes
    (a ragged R, a hidden width off the 128-column tile, and E = 30, Hd = 70,
    whose row pitches are not multiples of 16 bytes), out, dx, dw12 and dwv
    each within 1e-4 of its tensor's largest magnitude (f32 both, sums in
    another order). bf16 (the census decoder under the configs' bf16
    compute): the census rows at a Megatron rank's half of the hidden width
    (Hd = 704, phase 17), a ragged R and E = 30, Hd = 70, against the bf16
    plain version (the same roundings: g to bf16 before `@ wv`, du to bf16) by
    `held_bf16`'s bounds, dx in bf16, dw12 and dwv rounded to bf16 after
    their f32 sums. Every shape runs twice and repeats its bits, backward
    included (no atomics, no race in the kernels' rings). At the census
    shape kernel and plain are timed in turns, each a call through its entry
    point (`ms`), and the kernels' own device time a call under the profiler
    (`device_ms`). Returns the timings by (dtype, part)."""
    import torch

    from scldm_torch.ops import fused_swiglu as fs

    check_f32_matmuls()
    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    census = (CENSUS_BATCH * CENSUS["n_genes"], CENSUS["n_embed"], CENSUS_HIDDEN)
    shapes = {"f32": (census, (1_001, 512, 1_408), (1_001, 512, 1_400), (777, 30, 70)),
              "bf16": (census, census[:2] + (CENSUS_HIDDEN // 2,), (1_001, 512, 1_408),
                       (777, 30, 70))}
    out = {}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        errs, timing = {}, {}
        for R, E, Hd in shapes[tag]:
            x = torch.randn(R, E, generator=g, device="cuda").to(dtype)
            w12 = (torch.randn(E, 2 * Hd, generator=g, device="cuda") * E**-0.5).to(dtype)
            wv = (torch.randn(Hd, 1, generator=g, device="cuda") * Hd**-0.5).to(dtype)
            ds = torch.randn(R, 1, generator=g, device="cuda")

            def run():
                return {"out": fs.swiglu_vec_fwd(x, w12, wv),
                        **dict(zip(("dx", "dw12", "dwv"), fs.swiglu_vec_bwd(x, w12, wv, ds)))}

            got = run()
            torch.cuda.synchronize()
            want = {"out": fs.swiglu_vec_reference(x, w12, wv), **dict(zip(
                ("dx", "dw12", "dwv"), fs.swiglu_vec_backward_reference(x, w12, wv, ds)))}
            report = []
            for k, w in want.items():
                what = f"swiglu_vec {tag} {k} at R={R}, E={E}, Hd={Hd}"
                if got[k].dtype != w.dtype:
                    raise AssertionError(f"{what}: {got[k].dtype}, the plain version {w.dtype}")
                part = "fwd" if k == "out" else "bwd"
                if tag == "f32":
                    err = held_f32(what, got[k], w)
                    report.append(f"{k} {err:.2e} ({err / w.abs().max().item():.1e} of max)")
                else:
                    e, r, b, n = held_bf16(what, got[k].float(), w.float())
                    err = e
                    report.append(f"{k} {e:.2e} ({r:.1e} of max, {b:.1e} beyond {n:g})")
                errs[part] = max(errs.get(part, 0.0), err)
            del want
            again = run()
            if not all(torch.equal(again[k], got[k]) for k in got):
                raise AssertionError(f"swiglu_vec {tag} gave other bits on the same inputs at "
                                     f"R={R}, E={E}, Hd={Hd}")
            log(f"phase1e swiglu_vec {tag} R={R} E={E} Hd={Hd}: " + ", ".join(report) +
                "; forward and backward repeat their bits")
            del got, again
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
                dev = device_ms(kernel, 2, SWIGLU_KERNELS)
                timing[part] = ((turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2, dev)
                if tag == "f32":
                    b = swiglu_vec_bound(R, E, Hd, part == "bwd")
                    yardstick = f"TF32 x3; f32 {b['f32_bound_ms']:.4f} ms"
                else:
                    b = swiglu_vec_bf16_bound(R, E, Hd, part == "bwd")
                    yardstick = "one bf16 pass"
                log(f"phase1e swiglu_vec {tag}_{part} R={R} E={E} Hd={Hd}: kernel "
                    f"{timing[part][0]:.4f} ms a call ({dev:.4f} ms on the device)  plain "
                    f"{timing[part][1]:.4f} ms  bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
                    f"{yardstick})")
            del x, w12, wv, ds, fns
            torch.cuda.empty_cache()
        for part in ("fwd", "bwd"):
            out[(tag, part)] = {"max_abs_err": errs[part], "ms": timing[part][0],
                                "plain_ms": timing[part][1], "device_ms": timing[part][2]}
    return out


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
    forward; the elementwise work is left out. The kernels run every product
    as three TF32 tensor-core passes, the least that keeps f32 accuracy on
    the tensor cores, so `bound_ms` is three times the function's operations
    against the TF32 peak; `f32_bound_ms` is them once against the f32 FMA
    peak, the yardstick of the scalar kernels they replaced. Bytes: each
    input read once and each output written once (forward x, the weights and
    out, with `save` also xs (L, R, T, E); backward xs, dy and the weights in,
    dx and the weight gradients out)."""
    weights = L * (4 * E + 4 * E * E + 3 * E * hidden)
    flops = 2 * R * T * L * (4 * E * E + 2 * T * E + 3 * E * hidden) * (3 if backward else 1)
    act = R * T * E
    if backward:
        n_bytes = 4 * (L * act + 2 * act + 2 * weights)
    else:
        n_bytes = 4 * (2 * act + weights + (L * act if save else 0))
    return {**bound(n_bytes, 3 * flops, TF32_FLOPS),
            "f32_bound_ms": bound(n_bytes, flops, F32_FLOPS)["bound_ms"]}


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


DEVICE_MS_TRACES = 3  # profiler sessions before a trace without the kernels fails


def device_ms(fn, reps: int, names: tuple) -> float:
    """The device time of one call of `fn`: the time of the kernels whose
    names hold one of `names`, summed over `reps` calls under the profiler
    after a warm-up call, over `reps`. The CUPTI trace now and then comes
    back without the device's events; such a trace is taken again, up to
    DEVICE_MS_TRACES sessions in all, and each retake is logged."""
    import torch

    fn()
    torch.cuda.synchronize()
    for trace in range(DEVICE_MS_TRACES):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.device_time_total for e in prof.key_averages()
                       if any(n in e.key for n in names))
        if total_us > 0:
            return total_us / reps / 1e3
        log(f"device_ms: trace {trace + 1} of {DEVICE_MS_TRACES} held no kernel named {names}")
    raise AssertionError(f"the profiler saw no kernel named {names} in {DEVICE_MS_TRACES} traces")


# the kernels behind each whole-trunk entry point
TRUNK_KERNELS = {"fwd": ("trunk_forward_mma",), "fwd_saving": ("trunk_forward_mma",),
                 "bwd": ("trunk_backward_mma", "grad_gemm", "grad_reduce")}


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
    other orders), its error reported as a share of that. At R = 128 kernel
    and plain are timed in turns, each a call through its entry point (the
    kernel's `ms`, as every row's), and the kernels' own device time a call
    is taken under the profiler beside it (`device_ms`: the wrappers' host
    time, checking L x 9 weights and handing over their pointers, can exceed
    it). At R = 128 the forward and the saving forward run twice and the
    backward twice, each held to the same bits (no atomics, no race in the
    kernels' shared memory). Returns {"fwd" | "fwd_saving" | "bwd":
    {max_abs_err, ms, plain_ms, device_ms}}."""
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
            dev_ms = device_ms(kernel, reps, TRUNK_KERNELS[part])
            out[part] = {"max_abs_err": errs[part], "ms": ms, "plain_ms": plain_ms,
                         "device_ms": dev_ms}
            b = fused_trunk_bound(R, T, E, Hd, L, part == "bwd", part == "fwd_saving")
            log(f"phase1g fused_trunk_{part} R={R}: kernel {ms:.4f} ms a call ({dev_ms:.4f} ms "
                f"on the device)  plain {plain_ms:.4f} ms  bound {b['bound_ms']:.4f} ms "
                f"({b['bound_by']}, TF32 x3; f32 {b['f32_bound_ms']:.4f} ms)")
        # no atomics and no race in shared memory: the same bits twice, each kernel
        y9b = ft.fused_trunk_blocks(x, w, H, EPS)
        y10b, xsb = ft.fused_trunk_fwd_saving(x, w, H, EPS)
        if not (torch.equal(y9b, y9) and torch.equal(y10b, y10) and torch.equal(xsb, xs)):
            raise AssertionError("the trunk forward gave other bits on the same inputs")
        again = ft.fused_trunk_bwd(xs, w, dy, H, EPS)
        if not (torch.equal(again[0], dx) and all(torch.equal(a, b)
                                                   for k in ft.TRUNK_WEIGHT_NAMES
                                                   for a, b in zip(again[1][k], dw[k]))):
            raise AssertionError("fused_trunk_bwd gave other bits on the same inputs")
        log(f"phase1g fused_trunk R={R}: forward, saving forward and backward repeat their bits")
    return out


def swiglu_gate_bound(R: int, E: int, H: int, backward: bool) -> dict:
    """fused_swiglu_gate over R rows, f32: the up projection 2*R*E*2H
    operations, three times that for the backward; the gate is left out.
    `bound_ms` is three times them against the TF32 peak (the kernels' three
    TF32 passes a product), `f32_bound_ms` them once against the f32 FMA
    peak. Bytes: x, w1 and w2 in and g (R, H) out; the backward reads dg (R,
    H) too and writes dx (R, E), dw1 and dw2."""
    flops = 2 * R * E * 2 * H * (3 if backward else 1)
    weights = 2 * E * H
    if backward:
        n_bytes = 4 * (R * E + weights + R * H + R * E + weights)
    else:
        n_bytes = 4 * (R * E + weights + R * H)
    return {**bound(n_bytes, 3 * flops, TF32_FLOPS),
            "f32_bound_ms": bound(n_bytes, flops, F32_FLOPS)["bound_ms"]}


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
        # no atomics, no race in the kernels' rings: the same bits again
        again = {"out": fs.swiglu_gate_fwd(x, w1, w2),
                 **dict(zip(("dx", "dw1", "dw2"), fs.swiglu_gate_bwd(x, w1, w2, dg)))}
        if not all(torch.equal(again[k], got[k]) for k in got):
            raise AssertionError(f"fused_swiglu_gate gave other bits on the same inputs at R={R}, "
                                 f"E={E}, H={H}")
        del again
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
        log(f"phase1h fused_swiglu_gate R={R} E={E} H={H}: " + ", ".join(report) +
            "; forward and backward repeat their bits")
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
                dev = device_ms(kernel, 2, SWIGLU_KERNELS)
                timing[part] = ((turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2, dev)
                b = swiglu_gate_bound(R, E, H, part == "bwd")
                log(f"phase1h fused_swiglu_gate_{part} R={R} E={E} H={H}: kernel "
                    f"{timing[part][0]:.4f} ms a call ({dev:.4f} ms on the device)  plain "
                    f"{timing[part][1]:.4f} ms  bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
                    f"TF32 x3; f32 {b['f32_bound_ms']:.4f} ms)")
            del fns
        del x, w1, w2, dg
        torch.cuda.empty_cache()
    return (*({"max_abs_err": errs[part], "ms": timing[part][0], "plain_ms": timing[part][1],
               "device_ms": timing[part][2]} for part in ("fwd", "bwd")), launches)


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
    (`VAETask(fused_pool=True)`), each with its steps' peak device memory;
    returns the main path's launches of each pool and tail kernel."""
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
    torch.cuda.reset_peak_memory_stats()
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
        f"{mets['grad_norm'].item():.3f}; launches {launches}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    compare_vae_paths("phase5", task, VAETask(vae, fused_decoder=False), batches[-1])

    # the window pool: VAETask(fused_pool=True) on the module path
    pool_task = VAETask(vae, num_training_steps=10_000, fused_pool=True, fused_decoder=False)
    pool_state = pool_task.init_state(torch.Generator(device="cuda").manual_seed(seed + 1))
    pool_task.train_step(pool_state, batches[0])  # warm-up
    torch.cuda.synchronize()
    fe.WINDOW_POOL_FWD_LAUNCHES.reset()
    fe.WINDOW_POOL_BWD_LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
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
        f"launches fwd {launches['window_pool_fwd']} bwd {launches['window_pool_bwd']}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
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


# phase 6's bounds on one bf16 step of the census VAE through the fused gate, by
# reference: (the loss's gap relative to the reference's, each gradient's largest
# gap relative to the reference gradient's largest magnitude). About twice the
# largest readings; benchmarks_torch/census_bounds_faults.py shows what they catch
CENSUS_BF16_BOUNDS = {"bf16 plain": (1e-4, 1.5e-2), "f32": (1e-4, 5e-2)}


def census_training_setup(seed: int) -> tuple:
    """Phase 6's census VAE as vae_census.yaml ships it (bf16 compute, remat,
    random weights from seed), its f32 twin (no remat, the same weights), the
    config's optimizer settings and CENSUS_STEPS + 1 lean batches of B = 16
    (benchmarks/bench_census.py's synth_batch: 2,048 to 4,095 expressed genes
    a cell)."""
    import numpy as np
    import torch

    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.utils.weights import init_reference_

    vae = init_reference_(build_transformer_vae(**CENSUS, dtype=torch.bfloat16, remat=True,
                                                device="cuda"),
                          torch.Generator(device="cuda").manual_seed(seed))
    vae32 = build_transformer_vae(**CENSUS, device="cuda")
    vae32.load_state_dict(vae.state_dict())
    opt = dict(learning_rate=3e-4, betas=(0.9, 0.95))  # vae_census.yaml's optimizer
    rng = np.random.default_rng(seed)
    G, B, S = CENSUS["n_genes"], CENSUS_BATCH, CENSUS_WINDOW
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in
                lean_batch(rng, B, G, S, (S // 2, S)).items()} for _ in range(CENSUS_STEPS + 1)]
    return vae, vae32, opt, batches


def census_step_gaps(lk: float, gk: dict, refs: dict) -> dict:
    """One step's gaps from each reference (name -> (loss, gradients)):
    name -> (the loss's gap relative to the reference's, (each gradient's
    largest gap over the reference gradient's largest magnitude, at its
    largest, the gradient's name)). The head's bias is left out: it is
    softmax-invariant, its true gradient 0, every path's noise."""
    out = {}
    for ref, (lr, grads) in refs.items():
        worst = (0.0, "")
        for name, want in grads.items():
            if name == "decoder_head.params.bias":
                continue
            rel = (gk[name] - want).abs().max().item() / (want.abs().max().item() + 1e-30)
            worst = max(worst, (rel, name))
        out[ref] = (abs(lk - lr) / abs(lr), worst)
    return out


def phase6_census_training(seed: int) -> dict:
    """VAE training at census width as configs/model/vae_census.yaml ships
    it (bf16 compute over f32 weights, remat), B = 16, through the algebraic
    tail with the fused gate (the bf16 swiglu_vec kernels) and through the
    plain algebraic path, in turns (gate, plain, plain, gate), each with its
    peak memory; then the f32 cut of earlier PRs (f32, no remat, the same
    weights) through the fused gate (the f32 kernels) beside them. Holds one
    step of the bf16 fused gate against the bf16 plain path and against the
    f32 step, and one f32 step of the fused gate against the f32 plain path.
    Returns the swiglu_vec launches by (dtype, part) of the main path's runs."""
    import torch

    from scldm_torch.ops import fused_swiglu as fs
    from scldm_torch.training.vae_task import VAETask

    check_f32_matmuls()
    vae, vae32, opt, batches = census_training_setup(seed)
    task = VAETask(vae, **opt, algebraic_fused_gate=True)
    plain_task = VAETask(vae, **opt)
    task32 = VAETask(vae32, **opt, algebraic_fused_gate=True)
    G, B, S = CENSUS["n_genes"], CENSUS_BATCH, CENSUS_WINDOW
    for t in (task, task32):
        if not (t._use_algebraic(batches[0]) and t.algebraic_fused_gate
                and not t._use_fused(batches[0])):
            raise AssertionError("the census batch did not select the algebraic tail with the gate")

    def run(t, label: str, steps: int) -> dict:
        """A warm-up step, then `steps` timed ones from a fresh optimizer state
        on the same weights (the state's module is shared: it is restored after)."""
        saved = {k: v.clone() for k, v in t.vae.state_dict().items()}
        state = t.init_state(torch.Generator(device="cuda").manual_seed(seed))
        t0 = time.perf_counter()
        state, first = t.train_step(state, batches[0])  # warm-up: library load, allocator
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        n = steps if warm <= 2.0 else min(steps, 3)
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
        note = "" if n == steps else f" (warm-up step {warm:.2f} s > 2 s: {n} steps)"
        log(f"phase6 census VAE {label} B={B} G={G} S={S}: {B * n / dt:.1f} train cells/s, "
            f"{dt / n * 1e3:.2f} ms/step over {n} steps{note}; losses {losses[0].item():.2f} -> "
            f"{losses[-1].item():.2f}, warm-up batch {first['train_loss'].item():.2f} -> "
            f"{again:.2f}; peak memory {peak / 2**30:.2f} GiB; swiglu_vec launches fwd "
            f"{launches[0]} bwd {launches[1]}")
        del state
        with torch.no_grad():
            t.vae.load_state_dict(saved)
        return {"n": n, "launches": launches, "cells_per_s": B * n / dt, "peak": peak}

    turn = CENSUS_STEPS // 2
    runs = []
    for t, label in ((task, "bf16 remat fused gate"), (plain_task, "bf16 remat plain algebraic"),
                     (plain_task, "bf16 remat plain algebraic"), (task, "bf16 remat fused gate")):
        runs.append((label, run(t, label, turn)))
        torch.cuda.empty_cache()
    f32 = run(task32, "f32 fused gate (the earlier cut)", turn)
    for label, r in runs:
        want = (r["n"], r["n"]) if "fused" in label else (0, 0)
        if r["launches"] != want:
            raise AssertionError(f"{label}: swiglu_vec launches {r['launches']} in {r['n']} steps")
    if f32["launches"] != (f32["n"], f32["n"]):
        raise AssertionError(f"f32 fused gate: swiglu_vec launches {f32['launches']}")
    gate = [r for label, r in runs if "fused" in label]
    plain = [r for label, r in runs if "plain" in label]
    log(f"phase6 census VAE as shipped (bf16, remat) in turns: fused gate "
        f"{[round(r['cells_per_s'], 1) for r in gate]} train cells/s at "
        f"{max(r['peak'] for r in gate) / 2**30:.2f} GiB, plain algebraic "
        f"{[round(r['cells_per_s'], 1) for r in plain]} at "
        f"{max(r['peak'] for r in plain) / 2**30:.2f}"
        f" GiB; beside them f32 without remat (the fused gate) {f32['cells_per_s']:.1f} at "
        f"{f32['peak'] / 2**30:.2f} GiB")

    # one step of the f32 cut, fused gate against the f32 plain algebraic path:
    # loss within 1e-5 relative, each gradient within 1e-3 of its largest
    # magnitude (f32 both; the head's bias is softmax-invariant, its true
    # gradient 0, both noise)
    plain32 = VAETask(vae32, **opt)
    l32, g32 = vae_loss_and_grads(task32, batches[-1])
    gap32 = census_step_gaps(l32, g32, {"f32 plain": vae_loss_and_grads(plain32, batches[-1])})
    loss_gap, (rel, name) = gap32["f32 plain"]
    if loss_gap > 1e-5 or rel > 1e-3:
        raise AssertionError(f"census f32 step: fused gate vs plain algebraic path: loss "
                             f"{loss_gap:.3e} relative, gradient {name} {rel:.3e} of its max")
    log(f"phase6 reference: one step, f32 fused gate vs f32 plain algebraic path: loss "
        f"{l32:.4f} ({loss_gap:.2e} relative), {len(g32)} gradients, largest gap {rel:.3e} of its "
        f"max ({name})")
    del plain32

    # one step of the shipped config, bf16 fused gate against the bf16 plain
    # path and against the f32 step on the same weights, by CENSUS_BF16_BOUNDS.
    # The two bf16 paths round at other points (the gate rounds g from f32
    # products, the plain path a and b before the gate): two bf16 evaluations
    # of one function, as the f32 step is a third
    lk, gk = vae_loss_and_grads(task, batches[-1])
    bad = [name for name, g in gk.items() if g.dtype != torch.float32]
    if bad:
        raise AssertionError(f"census gradients not f32: {bad}")
    gaps = census_step_gaps(lk, gk, {"bf16 plain": vae_loss_and_grads(plain_task, batches[-1]),
                                     "f32": (l32, g32)})
    for ref, (loss_gap, (rel, name)) in gaps.items():
        loss_bound, grad_bound = CENSUS_BF16_BOUNDS[ref]
        if loss_gap > loss_bound or rel > grad_bound:
            raise AssertionError(f"census bf16 step: fused gate vs {ref}: loss {loss_gap:.3e} "
                                 f"relative, gradient {name} {rel:.3e} of its max")
    log(f"phase6 reference: one step, bf16 fused gate (loss {lk:.4f}) vs " + "; vs ".join(
        f"{ref}: loss {lg:.2e} relative (bound {CENSUS_BF16_BOUNDS[ref][0]:g}), largest gradient "
        f"gap {rel:.3e} of its max ({name}; bound {CENSUS_BF16_BOUNDS[ref][1]:g})"
        for ref, (lg, (rel, name)) in gaps.items()) + f"; {len(gk)} gradients, all f32")
    return {("bf16", "fwd"): sum(r["launches"][0] for r in gate),
            ("bf16", "bwd"): sum(r["launches"][1] for r in gate),
            ("f32", "fwd"): f32["launches"][0], ("f32", "bwd"): f32["launches"][1]}


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


def ldm_loss_and_grads(task, batch, g, noise: dict) -> tuple:
    """One step's loss and its DiT's gradients (by name; the parameters the
    step reached) on the given draws."""
    task.dit.zero_grad(set_to_none=True)
    loss = task.loss(batch, g, noise)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in task.dit.named_parameters() if p.grad is not None}
    task.dit.zero_grad(set_to_none=True)
    return loss.item(), grads


def compare_ldm_paths(phase: str, task, module_task, batch, g) -> None:
    """One step's loss and gradients, kernel path vs module path, same
    parameters, batch and draws (from `g`); JAX's bounds between its two
    paths (tests/test_fused_dit.py): loss 1e-4 relative, grad norm 1e-3."""
    import torch

    from scldm_torch.training.metrics import global_norm

    dit = task.dit
    B, T, E_in = batch["library_size"].shape[0], dit.seq_len, dit.n_embed_input
    noise = {"t": torch.rand(B, generator=g, device="cuda"),
             "x0": torch.randn(B, T, E_in, generator=g, device="cuda"),
             "drop_mask": torch.rand(B, generator=g, device="cuda") < dit.cfg_dropout_prob}
    runs = []
    for t in (task, module_task):  # each its own DiT's gradients (one module, or its f32 twin)
        loss, grads = ldm_loss_and_grads(t, batch, g, noise)
        runs.append((loss, global_norm(grads.values()).item(), grads))
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


def build_census_ldm_models(seed: int, dtype=None):
    """The census VAE (frozen, eval) and the census DiT on the card, random
    weights from CUDA generators, the DiT's adaLN and final layers non-zero,
    both computing in `dtype` (default f32)."""
    import torch

    from scldm_torch.nn.nnets import DiT
    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.utils.weights import init_reference_

    dtype = dtype or torch.float32
    vae = init_reference_(build_transformer_vae(**CENSUS, dtype=dtype, device="cuda"),
                          torch.Generator(device="cuda").manual_seed(seed)).eval()
    dit = init_reference_(DiT(**CENSUS_DIT, dtype=dtype).to("cuda"),
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
    """Census LDM training and generation at ldm_base.yaml's bf16 compute:
    the census VAE, frozen, under the census DiT (T = 64 latent tokens), both
    bf16 over f32 weights, random weights from CUDA generators with non-zero
    adaLN. Trains CENSUS_STEPS steps of B = 16 through the DiT block kernels
    (f32 whatever the DiT's dtype, as JAX's kernel path) and prints the
    segment split of three synchronised steps; holds one step of the kernel
    path against the module path on the DiT's f32 twin (the same weights)
    at JAX's bounds, and one step of the timed bf16 task (loss and every
    gradient) against its function on modules (the twin's trunk on the bf16
    module's conditioning) at JAX's bounds, the conditioning's gradients at
    `held_bf16`'s 1e-2; holds the fused encode against
    the f32 twin VAE's module encode at JAX's bound; generates euler-50 at a
    generation batch of 16 through the algebraic decode; holds
    generate_from_noise with `fused_blocks` against the f32 twin's module
    denoiser on the same noise (latents within 1e-3, and mu within 1e-3
    through the f32 twin's decode), and prints the bf16 module denoiser's
    and the bf16 decode's distances; holds the module decode with the
    flash-cross gate on against off (mu by `held_bf16`'s rule; the kernel
    takes the bf16 decoder's q, k and v). Returns the main path's launches
    of dit_block, dit_block_bwd and flash_cross."""
    import numpy as np
    import torch

    from scldm_torch.ops import attention
    from scldm_torch.ops import fused_cross as fc
    from scldm_torch.ops import fused_dit
    from scldm_torch.ops import fused_encoder as fe
    from scldm_torch.ops.transforms import canonical_gene_ids
    from scldm_torch.sampling.size_factors import SizeFactorSampler, constant_stats
    from scldm_torch.training import ldm_task
    from scldm_torch.training.ldm_task import LDMTask
    from scldm_torch.training.metrics import global_norm
    from scldm_torch.transport import create_transport

    from scldm_torch.nn.nnets import DiT
    from scldm_torch.nn.vae import build_transformer_vae

    vae, dit = build_census_ldm_models(seed, torch.bfloat16)
    dit32 = DiT(**CENSUS_DIT).to("cuda")  # the f32 twin: the kernel path's function as modules
    dit32.load_state_dict(dit.state_dict())
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
    # the kernels against the modules on the f32 twin: the same function at JAX's bounds (the
    # bf16 DiT's kernel path differs from it only in its conditioning, rounded to bf16)
    dit32.load_state_dict(dit.state_dict())
    compare_ldm_paths("phase7", LDMTask(vae, dit32, create_transport()),
                      LDMTask(vae, dit32, create_transport(), fused_training=False),
                      batches[-1], g)
    # the timed task itself: one step of the bf16 DiT through the f32 kernels (its conditioning
    # computed by the bf16 module, as JAX's) against the same function on modules, the f32
    # twin's trunk on that conditioning, the same draws: JAX's bounds (loss 1e-4 relative, grad
    # norm 1e-3), each trunk gradient within 1e-3 of its largest magnitude, and each gradient
    # of the conditioning within 1e-2 of its: the trunk's f32 cotangent of the conditioning is
    # rounded to bf16 on its way back into the bf16 module, and two sum orders flip a rounding
    # now and then (`held_bf16`'s bound)
    bs = batches[-1]["library_size"].shape[0]
    noise = {"t": torch.rand(bs, generator=g, device="cuda"),
             "x0": torch.randn(bs, dit.seq_len, dit.n_embed_input, generator=g, device="cuda"),
             "drop_mask": torch.rand(bs, generator=g, device="cuda") < dit.cfg_dropout_prob}
    lk, gk = ldm_loss_and_grads(task, batches[-1], g, noise)
    kernel_fn = ldm_task.fused_dit_train_apply
    ldm_task.fused_dit_train_apply = lambda d, xt, t_emb: dit32.trunk(xt.float(), t_emb.float())
    try:
        dit32.zero_grad(set_to_none=True)
        lm, gm = ldm_loss_and_grads(task, batches[-1], g, noise)  # the conditioning's gradients
        gm.update({k: p.grad.clone() for k, p in dit32.named_parameters() if p.grad is not None})
        dit32.zero_grad(set_to_none=True)
    finally:
        ldm_task.fused_dit_train_apply = kernel_fn
    if set(gk) != set(gm) or any(v.dtype != torch.float32 for v in gk.values()):
        raise AssertionError(f"phase7: the kernel path's gradients {sorted(gk)} (dtypes "
                             f"{sorted({str(v.dtype) for v in gk.values()})}), the modules' "
                             f"{sorted(gm)}")
    nk, nm = global_norm(gk.values()).item(), global_norm(gm.values()).item()
    worst = {"trunk": (0.0, ""), "conditioning": (0.0, "")}
    for k, w in gm.items():
        part = "conditioning" if k.startswith(("t_embedder.", "class_embeddings.")) else "trunk"
        worst[part] = max(worst[part], ((gk[k] - w).abs().max().item() / (w.abs().max().item()
                                                                         + 1e-30), k))
    if (abs(lk - lm) > 1e-4 * abs(lm) or abs(nk - nm) > 1e-3 * nm
            or worst["trunk"][0] > 1e-3 or worst["conditioning"][0] > 1e-2):
        raise AssertionError(f"phase7: the timed bf16 kernel path loss {lk}, grad norm {nk}; on "
                             f"modules {lm}, {nm}; largest gradient gaps of their max {worst}")
    bf16_task = LDMTask(vae, dit, create_transport(), fused_training=False)
    with torch.no_grad():
        lb = bf16_task.loss(batches[-1], g, noise).item()
    log(f"phase7 reference: one step of the timed bf16 task, kernel path vs its function on "
        f"modules (the f32 twin's trunk on the bf16 conditioning): loss {lk:.6f} vs {lm:.6f} "
        f"({abs(lk - lm) / abs(lm):.2e} relative), grad norm {nk:.6f} vs {nm:.6f} "
        f"({abs(nk - nm) / nm:.2e}), {len(gm)} gradients, all f32, largest gap of its max in the "
        f"trunk {worst['trunk'][0]:.3e} ({worst['trunk'][1]}), in the conditioning "
        f"{worst['conditioning'][0]:.3e} ({worst['conditioning'][1]}); the bf16 module DiT's loss "
        f"on the same draws {lb:.6f}")
    del gk, gm

    # -- the frozen encode through the wide window pool (LDMTask(fused_encode=True)),
    #    held against the module encode of the f32 twin VAE (the same weights) at JAX's
    #    bound (tests/test_fused_encoder.py:279-308: 0.02 of the largest latent) and timed
    #    against the bf16 module encode in turns; then the timed steps and the segment split
    #    through it. The bf16 module encode is not the reference: it rounds at other points
    #    (the pool's MCAB runs in f32, the module's in bf16); its distances are printed
    fe_task = LDMTask(vae, dit, create_transport(), fused_encode=True)
    fe.WINDOW_POOL_WIDE_FWD_LAUNCHES.reset()
    z_k = fe_task._encode(batches[-1])
    torch.cuda.synchronize()
    encode_launches = fe.WINDOW_POOL_WIDE_FWD_LAUNCHES.count
    z_m = task._encode(batches[-1])

    def f32_twin():
        """An LDMTask of the f32 twins of the VAE and the DiT (the same weights)."""
        vae32 = build_transformer_vae(**CENSUS, device="cuda").eval()
        vae32.load_state_dict(vae.state_dict())
        return LDMTask(vae32, dit32, create_transport())

    task32 = f32_twin()
    z_32 = task32._encode(batches[-1])
    del task32  # not held through the timed runs below
    err, scale = (z_k.float() - z_32).abs().max().item(), z_32.abs().max().item()
    if encode_launches != 1 or not err <= 0.02 * scale:
        raise AssertionError(f"census fused encode: {encode_launches} wide window pool launches, "
                             f"max abs err {err:.3e} against the f32 twin's module encode, max "
                             f"|z| {scale:.3e}")
    log(f"phase7 fused_encode at bf16: latents vs the f32 twin's module encode {err:.3e} "
        f"({err / scale:.1e} of max |z| {scale:.3e}; held to 0.02); the bf16 module encode vs "
        f"the f32 twin's {(z_m.float() - z_32).abs().max().item():.3e}, vs the fused encode "
        f"{(z_k - z_m).abs().max().item():.3e}")
    walls = {}
    for t in (task, fe_task, fe_task, task):  # in turns, each timed over 5 encodes
        t0 = time.perf_counter()
        for _ in range(5):
            t._encode(batches[-1])
        torch.cuda.synchronize()
        walls.setdefault(t.fused_encode, []).append(round((time.perf_counter() - t0) / 5 * 1e3, 3))
    log(f"phase7 fused_encode: encode ms in turns, window pool {walls[True]} vs module "
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
    del z_k, z_m, z_32

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

    # -- the kernel denoiser against the f32 twin's module one, the same noise: the latents
    #    within 1e-3 (f32 denoisers, sums in other orders), and mu within 1e-3 of its largest
    #    through the f32 twin's decode of each; the bf16 decode's distance from it is printed
    z0 = torch.randn(B, dit.seq_len, dit.n_embed_input, generator=g, device="cuda")
    log_sf = torch.full((B,), 8.6, device="cuda")
    kw = dict(guidance_weight=GUIDANCE, sampling_method="euler", num_steps=50)
    dit32.load_state_dict(dit.state_dict())  # the twin of the trained DiT
    task32 = f32_twin()
    zk, ok, _ = task.generate_from_noise(z0, log_sf, genes, cond, fused_blocks=True, **kw)
    (zk32, ok32, _), (zm, om, _) = (task32.generate_from_noise(z0, log_sf, genes, cond,
                                                               fused_blocks=fused, dit=d, **kw)
                                    for fused, d in ((True, dit), (False, dit32)))
    zb, ob, _ = task.generate_from_noise(z0, log_sf, genes, cond, fused_blocks=False, **kw)
    if not (torch.isfinite(zb).all() and torch.isfinite(ob["mu"]).all()):
        raise AssertionError("phase7: the bf16 module denoiser's latents or mu are not finite")
    log(f"phase7 generate_from_noise euler-50, the bf16 module denoiser against the kernel one: "
        f"latents max abs diff {(zb - zk).abs().max().item():.3e} (max |z| "
        f"{zk.abs().max().item():.3e}), mu {(ob['mu'] - ok['mu']).abs().max().item():.3e}")
    del zb, ob
    z_err = (zk - zm).abs().max().item()
    mu_err, mu_max = (ok32["mu"] - om["mu"]).abs().max().item(), om["mu"].abs().max().item()
    torch.testing.assert_close(zk, zm, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(zk32, zm, rtol=1e-3, atol=1e-3)
    if not mu_err <= 1e-3 * mu_max:
        raise AssertionError(f"fused_blocks mu (f32 decode): max abs err {mu_err:.3e}, max |mu| "
                             f"{mu_max:.3e}")
    bf16_err, bf16_scale, bf16_beyond = bf16_distance(ok["mu"], ok32["mu"])
    log(f"phase7 reference: generate_from_noise euler-50, fused_blocks=True vs the f32 twin's "
        f"module denoiser: latents max abs err {z_err:.3e}, mu through the f32 decode "
        f"{mu_err:.3e} ({mu_err / mu_max:.1e} of max); the bf16 decode of the kernel latents vs "
        f"its f32 decode {bf16_err:.3e} ({bf16_err / bf16_scale:.1e} of max, {bf16_beyond:.1e} "
        f"of the entries beyond 1e-4 of it)")
    del ok, om, ok32, zk32, task32
    torch.cuda.empty_cache()

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
    timed against it in turns with each arm's peak memory; one step's loss and
    gradients through the DiT block kernels (`LDMTask(fused_training=None)`)
    held against the module DiT (`fused_training=False`, whose attention
    under a gradient takes the plain path); LDM_STEPS training steps through
    the kernels (17 flash attention launches a step, all from the encode,
    and 8 DiT block launches each way: the forward launches row 12 from C,
    uncounted), then the two paths timed in turns with each arm's peak
    memory; one euler-10 generation call at a generation batch
    of 4 through `make_sample_fn(fused_blocks=True)`: 9 DiT evaluations of 8
    blocks, 72 DiT block kernel launches and none of the flash attention
    kernel in the DiT, 16 of those from the decoder trunk of the algebraic
    decode. The NB means of the same noise through `generate_from_noise`
    with fused_blocks=True are held against fused_blocks=False, and those
    (whose DiT takes sdpa, so the flash attention kernel) against the plain
    gate, each within 1e-3 of their largest. Returns (the flash attention
    kernel's launches, the DiT block forward's, its backward's) in the
    counted runs."""
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
    task = LDMTask(vae, dit, create_transport())  # fused_training=None: the kernels on CUDA
    module_task = LDMTask(vae, dit, create_transport(), fused_training=False)
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

    # -- LDM training through the DiT block kernels, held against the module DiT
    compare_ldm_paths("phase9", task, module_task, batches[0],
                      torch.Generator(device="cuda").manual_seed(seed + 5))
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
    bwd_launches = fused_dit.DIT_BLOCK_BWD_LAUNCHES.count
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(losses)
    if (steps != per_encode * n or fused_dit.DIT_BLOCK_LAUNCHES.count != dit.n_layer * n
            or bwd_launches != dit.n_layer * n):
        raise AssertionError(f"phase9 training: {steps} flash_attention launches in {n} steps "
                             f"(want {per_encode * n}, all from the encode), DiT block launches "
                             f"{fused_dit.DIT_BLOCK_LAUNCHES.count} forward and {bwd_launches} "
                             f"backward (want {dit.n_layer * n} each)")
    if not torch.isfinite(losses).all():
        raise AssertionError(f"phase9: non-finite LDM loss {losses.tolist()}")
    launches += steps
    log(f"phase9 LDM training B={B} T={LONG_LATENT} (fused_training=None, the DiT block "
        f"kernels): {B * n / dt:.1f} train cells/s, {dt / n * 1e3:.2f} ms/step over {n} steps; "
        f"losses {losses[0].item():.4f} -> {losses[-1].item():.4f}; flash_attention launches "
        f"{steps} ({steps // n} a step, none from the DiT), dit_block_bwd launches "
        f"{bwd_launches} ({bwd_launches // n} a step); peak memory {peak:.2f} GiB")
    walls, peaks = {}, {}
    for arm in ("module", "kernel", "kernel", "module"):  # in turns, 2 steps each
        t = task if arm == "kernel" else module_task
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for b in batches[1:3]:
            state, mets = t.train_step(state, b)
        torch.cuda.synchronize()
        walls.setdefault(arm, []).append(round((time.perf_counter() - t0) / 2 * 1e3, 2))
        peaks[arm] = max(peaks.get(arm, 0.0), torch.cuda.max_memory_allocated() / 2**30)
    log(f"phase9 LDM step in turns, ms per step: kernels {walls['kernel']} vs module DiT "
        f"{walls['module']}; peak memory kernels {peaks['kernel']:.2f} GiB, module DiT "
        f"{peaks['module']:.2f} GiB")
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
    del vae, dit, task, module_task
    torch.cuda.empty_cache()
    return launches, dit_launches, bwd_launches


# phase 10: the joint pair (configs/datamodule/default.yaml:87-121: parse1m and
# replogle, condition_strategy joint) on their real label vocabularies, with
# synthetic joint size-factor statistics (the reference's .pkl files are not in
# the repository)
JOINT = {"parse1m": ("metadata/parse1m_train.json", {"cell_type": 18, "cytokine": 91}),
         "replogle": ("metadata/replogle_train.json", {"cell_line": 4, "gene": 2_024})}
JOINT_CELLS = 4_096  # synthetic cells a dataset, as CSR arrays
JOINT_COVER = 0.85  # share of label pairs with statistics; the rest sample 0
JOINT_SD = 0.05


def joint_statistics(rng, labels: dict, vocab: dict, directory: Path) -> tuple:
    """mu / sd JSON files in the reference's joint format ({"c1_c2":
    {"<cat1>_<cat2>": value}}) for about JOINT_COVER of the pairs, mu spread
    uniformly over [6, 9]; returns their paths."""
    c1, c2 = vocab
    mu, sd = {}, {}
    for a in labels[c1]:
        for b in labels[c2]:
            if rng.random() < JOINT_COVER:
                mu[f"{a}_{b}"] = float(rng.uniform(6.0, 9.0))
                sd[f"{a}_{b}"] = JOINT_SD
    paths = directory / "mu.json", directory / "sd.json"
    for path, table in zip(paths, (mu, sd)):
        path.write_text(json.dumps({f"{c1}_{c2}": table}))
    return tuple(str(p) for p in paths)


def joint_cells(rng, n_cells: int, n_genes: int) -> tuple:
    """CSR arrays (data f32, indices i32 sorted within each row, indptr i64)
    of `n_cells` cells with 500 to 1,999 expressed genes each
    (benchmarks/bench_batch_scaling.py:25), counts 1 + Poisson(3)."""
    import numpy as np

    nnz = rng.integers(500, n_genes, n_cells)
    indptr = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    indices = np.concatenate([np.sort(rng.choice(n_genes, k, replace=False)) for k in nnz])
    data = (rng.poisson(3.0, int(indptr[-1])) + 1).astype(np.float32)
    return data, indices.astype(np.int32), indptr


def phase10_joint(seed: int, batch: int, smi: str) -> dict:
    """LDM training and dopri5 generation under joint conditioning at
    parse1m's and replogle's label vocabularies, fed by the port's host data
    layer (`data.encoder.VocabularyEncoder`, `data.fastpath.
    expressed_batch_from_csr`) and sampled through the joint size-factor
    table (`SizeFactorSampler(encoder, "joint")`); returns the main path's
    dit_block, dit_block_bwd and window pool forward launches."""
    import tempfile

    import numpy as np
    import torch

    from scldm_torch.data.encoder import VocabularyEncoder
    from scldm_torch.data.fastpath import expressed_batch_from_csr
    from scldm_torch.nn.nnets import DiT
    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.ops import fused_dit
    from scldm_torch.ops import fused_encoder as fe
    from scldm_torch.ops.transforms import canonical_gene_ids, densify_expressed
    from scldm_torch.sampling.size_factors import SizeFactorSampler
    from scldm_torch.training.ldm_task import LDMTask
    from scldm_torch.transport import create_transport
    from scldm_torch.utils.weights import init_reference_

    host_modules = set(sys.modules)
    phase_t0 = time.perf_counter()
    total = {"dit_block": 0, "dit_block_bwd": 0, "window_pool_fwd": 0}
    # the parse1m VAE of phase 5 (frozen), the same for both datasets (G = 2,000)
    vae = init_reference_(build_transformer_vae(n_genes=PARSE_GENES, device="cuda"),
                          torch.Generator(device="cuda").manual_seed(seed)).eval()
    for name, (meta, vocab) in JOINT.items():
        rng = np.random.default_rng(seed)
        labels = json.loads((ROOT / meta).read_text())["labels"]
        with tempfile.TemporaryDirectory() as tmp:
            mu_path, sd_path = joint_statistics(rng, labels, vocab, Path(tmp))
            enc = VocabularyEncoder(metadata_json=str(ROOT / meta), class_vocab_sizes=vocab,
                                    condition_strategy="joint", mu_size_factor=mu_path,
                                    sd_size_factor=sd_path)
        c1, c2 = vocab
        sizes = {c: len(enc.labels[c]) for c in vocab}
        if enc.n_genes != PARSE_GENES or sizes != vocab:
            raise AssertionError(f"{name}: {enc.n_genes} genes, labels {sizes}")
        sfs = SizeFactorSampler(enc, "joint")
        mu_t, sd_t = sfs.joint_table
        if tuple(mu_t.shape) != (vocab[c1], vocab[c2]) or sfs.joint_components != [c1, c2]:
            raise AssertionError(f"{name}: joint table {tuple(mu_t.shape)}, components "
                                 f"{sfs.joint_components}")

        # -- the host data layer: CSR cells -> batches with label columns
        data, indices, indptr = joint_cells(rng, JOINT_CELLS, PARSE_GENES)
        cats = {c: np.asarray(enc.labels[c])[rng.integers(0, vocab[c], JOINT_CELLS)]
                for c in vocab}
        t0 = time.perf_counter()
        gene_row = enc.encode_genes(enc.genes)
        n_steps = TRAIN_STEPS
        batches = []
        for lo in range(0, (n_steps + 1) * batch, batch):
            hi = lo + batch
            span = slice(int(indptr[lo]), int(indptr[hi]))
            b = expressed_batch_from_csr(data[span], indices[span], indptr[lo:hi + 1] - indptr[lo],
                                         gene_row, PARSE_GENES, build_dense=False)
            b.update({c: enc.encode_metadata(cats[c][lo:hi], c) for c in vocab})
            batches.append({k: torch.from_numpy(v).to("cuda") for k, v in b.items()})
        host_s = time.perf_counter() - t0
        dense = expressed_batch_from_csr(data[:indptr[batch]], indices[:indptr[batch]],
                                         indptr[:batch + 1], gene_row, PARSE_GENES)
        lean = batches[0]
        if not (torch.equal(densify_expressed(lean["genes_subset"], lean["counts_subset"],
                                              PARSE_GENES).cpu(), torch.from_numpy(dense["counts"]))
                and np.array_equal(dense["library_size"], lean["library_size"].cpu().numpy())):
            raise AssertionError(f"{name}: the dense batch is not the lean batch densified")

        # -- LDM training through the DiT block kernels
        dit = init_reference_(DiT(**dict(DIT, class_vocab_sizes=enc.class_vocab_sizes,
                                         condition_strategy="joint")),
                              torch.Generator().manual_seed(seed), zero_init=False)
        dit = dit.to("cuda")
        task = LDMTask(vae, dit, create_transport())
        state = task.init_state(torch.Generator(device="cuda").manual_seed(seed))
        state, _ = task.train_step(state, batches[0])  # warm-up
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
        L = dit.n_layer
        if not torch.isfinite(losses).all():
            raise AssertionError(f"{name}: non-finite LDM training loss {losses.tolist()}")
        if fwd != L * n_steps or bwd != L * n_steps:
            raise AssertionError(f"{name}: {fwd} dit_block and {bwd} dit_block_bwd launches in "
                                 f"{n_steps} steps of {L} blocks")
        log(f"phase10 {name} joint {vocab}: host data layer {host_s:.3f} s for "
            f"{(n_steps + 1) * batch} of {JOINT_CELLS} CSR cells ({int(indptr[-1])} nonzeros)")
        log(f"phase10 {name} LDM training B={batch}: {batch * n_steps / dt:.1f} train cells/s, "
            f"{dt / n_steps * 1e3:.2f} ms/step over {n_steps} steps ({smi}); losses "
            f"{losses[0].item():.4f} -> {losses[-1].item():.4f}; launches dit_block {fwd} "
            f"dit_block_bwd {bwd}")
        total["dit_block"] += fwd
        total["dit_block_bwd"] += bwd
        seg = ldm_step_segments(task, state, batches[1:4])
        log(f"phase10 {name} segments ms (3 steps, each synchronised; the loss encodes again): "
            f"{seg}")
        g = torch.Generator(device="cuda").manual_seed(seed + 3)
        compare_ldm_paths(f"phase10 {name}", task,
                          LDMTask(vae, dit, create_transport(), fused_training=False),
                          batches[-1], g)

        # -- the frozen encode through the narrow window pool (fused_encode)
        fe.WINDOW_POOL_FWD_LAUNCHES.reset()
        z_k = LDMTask(vae, dit, create_transport(), fused_encode=True)._encode(batches[-1])
        torch.cuda.synchronize()
        encodes = fe.WINDOW_POOL_FWD_LAUNCHES.count
        z_m = task._encode(batches[-1])
        err, scale = (z_k - z_m).abs().max().item(), z_m.abs().max().item()
        # JAX's bound between the two (tests/test_fused_encoder.py:279-308)
        if encodes != 1 or not err < 0.02 * scale:
            raise AssertionError(f"{name} fused encode: {encodes} window pool launches, max abs "
                                 f"err {err:.3e} against the module encode, max |z| {scale:.3e}")
        total["window_pool_fwd"] += encodes

        # -- the joint table on the card: pairs without statistics sample exactly 0
        have = (mu_t > 0).numpy()
        miss1, miss2 = np.nonzero(~have)
        covered1, covered2 = np.nonzero(have)
        if not (0 < len(miss1) < have.size):
            raise AssertionError(f"{name}: {len(miss1)} of {have.size} pairs without statistics")
        probe = {c1: torch.from_numpy(miss1).to("cuda"), c2: torch.from_numpy(miss2).to("cuda")}
        zeros = sfs.sample(g, probe, len(miss1), "cuda")
        if zeros.device.type != "cuda" or not torch.equal(zeros, torch.zeros_like(zeros)):
            raise AssertionError(f"{name}: pairs without statistics sampled "
                                 f"{zeros.abs().max().item()}")

        # -- dopri5 generation under joint CFG, the condition pairs among those with statistics
        pick = rng.integers(0, len(covered1), batch)
        want_cats = {c1: np.asarray(enc.labels[c1])[covered1[pick]],
                     c2: np.asarray(enc.labels[c2])[covered2[pick]]}
        cond = {c: torch.from_numpy(enc.encode_metadata(v, c)).to("cuda")
                for c, v in want_cats.items()}
        fn = task.make_sample_fn(sfs, guidance_weight={c1: 1.0, c2: 1.0},
                                 sampling_method="dopri5", num_steps=50)
        genes = canonical_gene_ids(PARSE_GENES, device="cuda")
        fn(g, genes, cond)  # warm-up: the joint embedding tables' first use
        torch.cuda.synchronize()
        fused_dit.DIT_BLOCK_LAUNCHES.reset()
        t0 = time.perf_counter()
        counts, z = fn(g, genes, cond, state=state)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        gen = fused_dit.DIT_BLOCK_LAUNCHES.count
        if counts.shape != (2 * batch, PARSE_GENES) or z.shape != (2 * batch, DIT["seq_len"], 16):
            raise AssertionError(f"{name}: counts {tuple(counts.shape)} z {tuple(z.shape)}")
        if not (torch.isfinite(counts).all() and torch.isfinite(z).all()):
            raise AssertionError(f"{name}: non-finite generation output")
        if not ((counts >= 0).all() and (counts == counts.round()).all()):
            raise AssertionError(f"{name}: counts are not non-negative integers")
        if fn.drift_evals <= 0 or gen != L * fn.drift_evals:
            raise AssertionError(f"{name}: {gen} dit_block launches for {fn.drift_evals} DiT "
                                 f"evaluations")
        # JAX's criterion (tests/test_joint_conditioning.py:84-87): the conditional
        # libraries track the table's mu for their pairs
        lib = torch.log(counts[batch:].sum(1) + 1e-6).cpu().numpy()
        want_mu = mu_t.numpy()[covered1[pick], covered2[pick]]
        corr = float(np.corrcoef(lib, want_mu)[0, 1])
        if not corr >= 0.7:
            raise AssertionError(f"{name}: conditional log library vs the table's mu: corr {corr}")
        # the encoder's round trip of the requested labels (encode_metadata, then
        # decode_metadata of the condition the generation call was given)
        for c, v in want_cats.items():
            back = enc.decode_metadata(cond[c].cpu().numpy(), c)
            if list(back) != list(v):
                raise AssertionError(f"{name}: {c} labels do not decode to the requested ones")
        total["dit_block"] += gen
        log(f"phase10 {name} generation dopri5 (fused_blocks=True, guidance {{{c1}: 1.0, "
            f"{c2}: 1.0}}) from the EMA weights: {2 * batch / dt:.1f} cells/s ({dt:.3f} s for "
            f"{2 * batch} cells; {smi}), DiT evals {fn.drift_evals}, dit_block launches {gen}; "
            f"conditional log library vs the joint table's mu: corr {corr:.4f}; "
            f"{len(miss1)} of {have.size} pairs without statistics sample 0; the encoder "
            f"round-trips the requested labels; "
            f"fused encode {encodes} window pool launch, max abs err {err:.3e} ({err / scale:.1e} "
            f"of max)")
    loaded = sorted(m for m in set(sys.modules) - host_modules if m.split(".")[0] in
                    ("h5py", "pandas"))
    if loaded:
        raise AssertionError(f"phase10 loaded {loaded}")
    log(f"phase10 took {time.perf_counter() - phase_t0:.1f} s; launches {total}")
    return total


# phase 11: the user entry points (scldm_torch.cli.train / train_ldm / inference)
# on the repo's YAML configs at full dentate width, fed by the port's DataModule
CLI_CELLS = 2_560  # the train file: the 10% validation split leaves 2,304 cells, 18 steps
CLI_TEST_CELLS = 256  # the test file, which the predict stream reads
CLI_PARSE_CELLS = 1_280  # parse1m's train file: 1,152 train cells, 9 steps of 128
CLI_STEPS = 24
CLI_PARSE_STEPS = 8
# the census VAE's train file (metadata/census_genes.json: 36,130 genes): B = 16,
# 144 train cells after the validation split, of which CLI_CENSUS_STEPS steps run
CLI_CENSUS_CELLS = 160
CLI_CENSUS_STEPS = 4
# resumed against uninterrupted: the embedding backward and the index adds sum
# with atomics on the card, so the weights may part in the last bits, which the
# optimizer carries on; each parameter is held to this absolute difference
CLI_RESUME_ATOL = 1e-2


class InMemoryShard:
    """Stands in for `data.h5ad.H5ADFile`: one CSR shard in host memory with
    the methods the DataModule calls (the card's machine has no h5py)."""

    def __init__(self, data, indices, indptr, var_names, obs: dict):
        self.data, self.indices, self.indptr = data, indices, indptr
        self.var_names = list(var_names)
        self.n_vars = len(self.var_names)
        self.obs = obs  # label -> (codes int32, categories)

    def shape(self, attr: str = "X", key=None) -> tuple:
        return (len(self.indptr) - 1, self.n_vars)

    def is_csr(self, attr: str = "X", key=None) -> bool:
        return True

    def csr_block(self, lo: int, hi: int, attr: str = "X", key=None):
        span = slice(int(self.indptr[lo]), int(self.indptr[hi]))
        return self.data[span], self.indices[span], self.indptr[lo:hi + 1] - self.indptr[lo]

    def obs_columns(self) -> list:
        return list(self.obs)

    def obs_codes(self, name: str):
        return self.obs[name]

    def obs_column(self, name: str):
        import numpy as np

        codes, cats = self.obs[name]
        return np.asarray(cats, dtype=object)[codes]

    def rows(self, *args, **kwargs):
        raise AssertionError("the smoke's shards are read as CSR blocks only")


def cli_shard(rng, n_cells: int, genes: list, labels: dict):
    """`n_cells` synthetic CSR cells over `genes` with 1,500 to 3,999 expressed
    genes each (up to all of them), counts 1 + Poisson(3), and each label
    column drawn uniformly over its categories."""
    import numpy as np

    g = len(genes)
    nnz = rng.integers(min(1_500, g - 1), min(4_000, g), n_cells)
    indptr = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    indices = np.concatenate([np.sort(rng.choice(g, k, replace=False)) for k in nnz])
    data = (rng.poisson(3.0, int(indptr[-1])) + 1).astype(np.float32)
    obs = {c: (rng.integers(0, len(cats), n_cells).astype(np.int32), list(cats))
           for c, cats in labels.items()}
    return InMemoryShard(data, indices.astype(np.int32), indptr, genes, obs)


def phase11_cli(seed: int, smi: str) -> dict:
    """The three CLIs at full dentate width from the repo's YAML files as
    shipped (bf16 compute): `train` preempted by SIGTERM after its first
    dispatch and resumed, against an uninterrupted run; `train_ldm` on its
    checkpoint; `inference` for generation, for latents and reconstruction
    and with `vae_only`; then `train` at parse1m, and `train` with
    `model=vae_census` (bf16, remat) on the homo_sapiens vocabulary. Two
    stand-ins, for the card machine's missing h5py:
    the in-memory shard for `H5ADFile` and a capturing writer for the h5ad
    writer. Returns the launches of rows 1-6."""
    import hashlib
    import os
    import signal
    import tempfile

    import numpy as np
    import torch

    from scldm_torch.cli._common import parse_config
    from scldm_torch.cli import inference as cli_inference
    from scldm_torch.cli import train as cli_train
    from scldm_torch.cli import train_ldm as cli_train_ldm
    from scldm_torch.data import datamodule as dm_module
    from scldm_torch.config.build import build_datamodule
    from scldm_torch.data import fastpath
    from scldm_torch.ops import fused_decoder as fd
    from scldm_torch.ops import fused_dit
    from scldm_torch.ops import fused_encoder as fe
    from scldm_torch.training import checkpoint as ckpt_module
    from scldm_torch.training.preemption import PreemptionGuard
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.utils import output as output_module

    phase_t0 = time.perf_counter()
    counters = {"dit_block": fused_dit.DIT_BLOCK_LAUNCHES,
                "dit_block_bwd": fused_dit.DIT_BLOCK_BWD_LAUNCHES,
                "decoder_tail_fwd": fd.DECODER_TAIL_FWD_LAUNCHES,
                "decoder_tail_bwd": fd.DECODER_TAIL_BWD_LAUNCHES,
                "encoder_pool_fwd": fe.ENCODER_POOL_FWD_LAUNCHES,
                "encoder_pool_bwd": fe.ENCODER_POOL_BWD_LAUNCHES}
    total = {k: 0 for k in counters}
    packs = {"native": fastpath.NATIVE_PACKS, "numpy": fastpath.NUMPY_PACKS}

    def run(name: str, fn, argv: list) -> dict:
        """One CLI call, its counts set to 0 just before and read just after."""
        for c in (*counters.values(), *packs.values()):
            c.reset()
        t0 = time.perf_counter()
        rc = fn(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: c.count for k, c in counters.items()}
        packed = {k: c.count for k, c in packs.items()}
        if rc != 0:
            raise AssertionError(f"phase11 {name} returned {rc}")
        if packed["numpy"] or not packed["native"]:
            raise AssertionError(f"phase11 {name}: batches packed {packed}; every batch must go "
                                 "through the native packer")
        for k in total:
            total[k] += got[k]
        log(f"phase11 {name}: {wall:.2f} s wall ({smi}); launches "
            f"{ {k: v for k, v in got.items() if v} }; batches packed natively {packed['native']}")
        return got

    # -- the data: synthetic shards on the real vocabularies, statistics as JSON
    rng = np.random.default_rng(seed)
    dentate = json.loads((ROOT / "metadata/dentategyrus_train.json").read_text())
    parse = json.loads((ROOT / "metadata/parse1m_train.json").read_text())
    census = json.loads((ROOT / "metadata/census_genes.json").read_text())
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="scldm_phase11_"))
    shards = {
        str(tmp / "train.h5ad"): cli_shard(rng, CLI_CELLS, dentate["genes"], dentate["labels"]),
        str(tmp / "test.h5ad"): cli_shard(rng, CLI_TEST_CELLS, dentate["genes"],
                                          dentate["labels"]),
        str(tmp / "parse_train.h5ad"): cli_shard(
            rng, CLI_PARSE_CELLS, parse["genes"],
            {c: parse["labels"][c] for c in ("cell_type", "cytokine")}),
        str(tmp / "census_train.h5ad"): cli_shard(rng, CLI_CENSUS_CELLS, census["genes"], {}),
    }
    mu = {"clusters": {c: float(rng.uniform(6.0, 9.0)) for c in dentate["labels"]["clusters"]}}
    sd = {"clusters": {c: 0.05 for c in dentate["labels"]["clusters"]}}
    (tmp / "mu.json").write_text(json.dumps(mu))
    (tmp / "sd.json").write_text(json.dumps(sd))
    nnz = int(shards[str(tmp / "train.h5ad")].indptr[-1])
    log(f"phase11 data: {CLI_CELLS} + {CLI_TEST_CELLS} dentate cells ({nnz} nonzeros in the "
        f"train file), {CLI_PARSE_CELLS} parse1m cells, {CLI_CENSUS_CELLS} census cells, made "
        f"in {time.perf_counter() - t0:.2f} s")

    # -- the two stand-ins, named in the log
    written = []

    def capture_h5ad(path, X, obs=None, var_names=None, obsm=None, **kwargs):
        written.append({"path": Path(path).name, "X": np.asarray(X), "obs": dict(obs or {}),
                        "var_names": list(var_names), "obsm": dict(obsm or {})})

    saves = []
    real_save = ckpt_module.CheckpointManager.save

    def timed_save(self, step, state, metrics=None):
        t = time.perf_counter()
        done = real_save(self, step, state, metrics)
        if done:
            self.wait_until_finished()
            saves.append((f"{self.directory.parent.parent.name}/{self.directory.name}", step,
                          time.perf_counter() - t,
                          (self.directory / str(step) / ckpt_module.STATE_FILE).stat().st_size))
        return done

    real_h5ad, real_writer = dm_module.H5ADFile, output_module.write_h5ad
    dm_module.H5ADFile = lambda path: shards[str(path)]
    output_module.write_h5ad = capture_h5ad
    ckpt_module.CheckpointManager.save = timed_save
    log("phase11 stand-ins: data.datamodule.H5ADFile -> an in-memory CSR shard, "
        "utils.output.write_h5ad -> a capturing writer; everything between them runs as "
        "shipped")

    # what each optimizer step trained on: its step, learning rate and batch
    # (VAETask.train_steps takes its steps through train_step)
    trained = []
    real_step, real_steps = VAETask.train_step, VAETask.train_steps

    def digest(batch):
        parts = [batch[k].cpu().numpy().tobytes() for k in ("genes_subset", "counts_subset")]
        return hashlib.sha1(b"".join(parts)).hexdigest()[:16]

    def record_step(self, state, batch):
        trained.append((state.step, self.schedule(state.step), digest(batch)))
        return real_step(self, state, batch)

    preempt = {"armed": False, "seen": None}

    def record_steps(self, state, stacked):  # its steps are recorded by train_step
        out = real_steps(self, state, stacked)
        if preempt["armed"]:
            preempt["armed"] = False
            handler = signal.getsignal(signal.SIGTERM)
            preempt["seen"] = type(getattr(handler, "__self__", None)).__name__
            if not isinstance(getattr(handler, "__self__", None), PreemptionGuard):
                raise AssertionError(f"phase11: SIGTERM's handler is {handler!r}, not the guard's")
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    VAETask.train_step, VAETask.train_steps = record_step, record_steps
    dentate_args = [
        f"datamodule.datamodule.train_adata_path={tmp / 'train.h5ad'}",
        f"datamodule.datamodule.test_adata_path={tmp / 'test.h5ad'}",
        f"datamodule.dataset_params.dentate_gyrus.mu_size_factor={tmp / 'mu.json'}",
        f"datamodule.dataset_params.dentate_gyrus.sd_size_factor={tmp / 'sd.json'}",
        f"training.max_steps={CLI_STEPS}", "epochs=2", "training.log_every_steps=8",
    ]

    def outputs(name):
        return [f"paths.output_path={tmp / name}", f"paths.inference_path={tmp / name / 'inference'}"]

    config = lambda name: ["--config", str(ROOT / "configs" / name)]  # noqa: E731
    try:
        # -- the host pipeline alone: the DataModule's read, pack and uint16 wire
        dm = build_datamodule(parse_config(config("vae_training.yaml") + dentate_args
                                           + ["datamodule.datamodule.prefetch=0"], None, ""))
        dm.setup("fit")
        batches = dm.train_batches(0)
        next(batches)  # the packer's first use builds it
        t0 = time.perf_counter()
        n = sum(1 for _ in batches)
        log(f"phase11 host pipeline: {(time.perf_counter() - t0) / n * 1e3:.2f} ms a packed lean "
            f"batch of 128 cells (prefetch off, {n} batches: the CSR block read, the native "
            "pack, the uint16 wire)")

        # -- train: preempted after its first dispatch, resumed, and uninterrupted
        argv = config("vae_training.yaml") + dentate_args + outputs("run")
        preempt["armed"] = True
        cut = run("train (SIGTERM after the first dispatch)", cli_train.main, argv)
        ck = tmp / "run" / "checkpoints" / "vae_dentate_gyrus"
        steps = sorted(int(p.name) for p in ck.iterdir() if p.name.isdigit())
        if preempt["seen"] != "PreemptionGuard" or steps != [8] or len(trained) != 8:
            raise AssertionError(f"phase11: the preempted run saved {steps} after {len(trained)} "
                                 f"steps (handler {preempt['seen']})")
        resumed = run("train (resumed)", cli_train.main, argv)
        cut_and_resumed, trained[:] = list(trained), []
        full = run("train (uninterrupted)", cli_train.main,
                   config("vae_training.yaml") + dentate_args + outputs("full"))
        if cut_and_resumed != trained or [t[0] for t in trained] != list(range(CLI_STEPS)):
            raise AssertionError("phase11: the resumed run trained other steps, learning rates or "
                                 "batches than the uninterrupted one")
        for name, got in (("preempted + resumed", {k: cut[k] + resumed[k] for k in cut}),
                          ("uninterrupted", full)):
            if got["decoder_tail_fwd"] != CLI_STEPS or got["decoder_tail_bwd"] != CLI_STEPS:
                raise AssertionError(f"phase11 train {name}: {got} launches in {CLI_STEPS} steps")
        a = ckpt_module.read_payload(ck / str(CLI_STEPS))
        b = ckpt_module.read_payload(tmp / "full" / "checkpoints" / "vae_dentate_gyrus"
                                     / str(CLI_STEPS))
        diff = max((a["module"][k] - b["module"][k]).abs().max().item() for k in a["module"])
        if a["step"] != b["step"] or not diff <= CLI_RESUME_ATOL:
            raise AssertionError(f"phase11: resumed vs uninterrupted weights differ by {diff:.3e}")
        rows = [r for r in csv.DictReader((tmp / "full" / "checkpoints" / "vae_dentate_gyrus"
                                            / "metrics.csv").open()) if r.get("cells_per_sec")]
        log(f"phase11 train: resumed at step 8 (skipping 8 batches of epoch 0) and ended at "
            f"{CLI_STEPS}; the same steps, learning rates and batches as the uninterrupted run; "
            f"weights {'bitwise equal' if diff == 0 else f'max abs diff {diff:.3e}'} (held to "
            f"{CLI_RESUME_ATOL}); train cells/s from metrics.csv (uninterrupted, {smi}): "
            + ", ".join(f"step {int(float(r['step']))}: {float(r['cells_per_sec']):.1f}"
                        for r in rows))

        # -- train_ldm on that checkpoint, then the three inference modes
        ldm_args = dentate_args + outputs("run")
        got = run("train_ldm", cli_train_ldm.main, config("ldm_training.yaml") + ldm_args)
        L = 8
        if got["dit_block"] != L * CLI_STEPS or got["dit_block_bwd"] != L * CLI_STEPS:
            raise AssertionError(f"phase11 train_ldm: {got} launches in {CLI_STEPS} steps")
        payload = ckpt_module.read_payload(tmp / "run" / "checkpoints" / "ldm_dentate_gyrus"
                                           / str(CLI_STEPS))
        if payload["ema"] is None or payload["ema"]["step"] != CLI_STEPS:
            raise AssertionError("phase11 train_ldm: no EMA in the final checkpoint")
        rows = [r for r in csv.DictReader((tmp / "run" / "checkpoints" / "ldm_dentate_gyrus"
                                            / "metrics.csv").open()) if r.get("cells_per_sec")]
        log("phase11 train_ldm train cells/s from metrics.csv: " + ", ".join(
            f"step {int(float(r['step']))}: {float(r['cells_per_sec']):.1f}" for r in rows))

        written.clear()
        got = run("inference (configs/generation.yaml, dopri5)", cli_inference.main,
                  config("generation.yaml") + ldm_args + ["generation_args.n_batches=1"])
        (gen,) = written
        batch = 128
        X = gen["X"]
        test = shards[str(tmp / "test.h5ad")]
        want = list(test.obs_column("clusters")[:batch])
        if X.shape != (2 * batch, N_GENES) or not (np.isfinite(X).all() and (X >= 0).all()):
            raise AssertionError(f"phase11 generation: counts {X.shape}")
        if list(gen["obs"]["generation_type"]) != ["unconditional"] * batch + ["conditional"] * batch:
            raise AssertionError("phase11 generation: the halves are not in order")
        if list(gen["obs"]["clusters"]) != want + want:
            raise AssertionError("phase11 generation: the condition labels do not decode to the "
                                 "test cells' categories")
        if gen["obsm"]["z"].shape != (2 * batch, 16 * 16) or got["dit_block"] <= 0 \
                or got["dit_block"] % L:
            raise AssertionError(f"phase11 generation: z {gen['obsm']['z'].shape}, launches {got}")
        log(f"phase11 generation: counts {X.shape}, mean {X.mean():.3f}, "
            f"both halves, labels decode to the test cells' categories, "
            f"{got['dit_block'] // L} DiT evaluations")

        written.clear()
        run("inference (configs/inference.yaml)", cli_inference.main,
            config("inference.yaml") + ldm_args)
        written_vae = list(written)
        written.clear()
        run("inference (vae_only=true)", cli_inference.main,
            config("inference.yaml") + ldm_args + ["vae_only=true"])
        for name, files in (("inference", written_vae), ("vae_only", written)):
            shapes = [(f["X"].shape, f["obsm"]["z"].shape) for f in files]
            if shapes != [((batch, N_GENES), (batch, 16 * 16))] * 2 or not all(
                    np.isfinite(f["X"]).all() and np.isfinite(f["obsm"]["z"]).all()
                    for f in files):
                raise AssertionError(f"phase11 {name}: outputs {shapes}")
        log(f"phase11 inference and vae_only: {len(written_vae)} + {len(written)} files of "
            f"{batch} cells, reconstructions and latents finite")

        # -- train at parse1m: the dense pool and the tail, once each way a step
        got = run("train (datamodule.dataset=parse1m)", cli_train.main,
                  config("vae_training.yaml") + outputs("run") + [
                      "datamodule.dataset=parse1m",
                      f"datamodule.datamodule.train_adata_path={tmp / 'parse_train.h5ad'}",
                      f"training.max_steps={CLI_PARSE_STEPS}", "epochs=1"])
        if any(got[k] != CLI_PARSE_STEPS for k in ("encoder_pool_fwd", "encoder_pool_bwd",
                                                   "decoder_tail_fwd", "decoder_tail_bwd")):
            raise AssertionError(f"phase11 parse1m: {got} launches in {CLI_PARSE_STEPS} steps")

        # -- train the census VAE as configs/model/vae_census.yaml ships it (bf16, remat) on the
        #    homo_sapiens vocabulary (metadata/census_genes.json): `model=vae_census` composed
        #    into vae_training.yaml's defaults as Hydra would, its groups linked from configs/
        census_cfg = tmp / "census_cfg"
        census_cfg.mkdir()
        for group in ("paths", "model", "training", "datamodule"):
            (census_cfg / group).symlink_to(ROOT / "configs" / group, target_is_directory=True)
        training_yaml = (ROOT / "configs" / "vae_training.yaml").read_text()
        if "model: vae_base" not in training_yaml:
            raise AssertionError("phase11: vae_training.yaml no longer composes model: vae_base")
        (census_cfg / "vae_census_training.yaml").write_text(
            training_yaml.replace("model: vae_base", "model: vae_census"))
        run("train (model=vae_census, datamodule.dataset=homo_sapiens)", cli_train.main,
            ["--config", str(census_cfg / "vae_census_training.yaml")] + outputs("run") + [
                "datamodule.dataset=homo_sapiens",
                f"datamodule.datamodule.train_adata_path={tmp / 'census_train.h5ad'}",
                f"training.max_steps={CLI_CENSUS_STEPS}", "epochs=1",
                "training.log_every_steps=2"])
        ck = tmp / "run" / "checkpoints" / "vae_homo_sapiens"
        snap = json.loads((ck / "config.json").read_text())
        payload = ckpt_module.read_payload(ck / str(CLI_CENSUS_STEPS))
        m = snap["model"]
        if (m["compute_dtype"], m["remat"], m["vae"]["n_embed"], m["vae"]["n_genes"]) != (
                "bfloat16", True, 512, len(census["genes"])) or payload["step"] != CLI_CENSUS_STEPS:
            raise AssertionError(f"phase11 census: config {m['compute_dtype']}, remat {m['remat']}, "
                                 f"E {m['vae']['n_embed']}, G {m['vae']['n_genes']}; step "
                                 f"{payload['step']}")
        rows = [r for r in csv.DictReader((ck / "metrics.csv").open()) if r.get("train_loss")]
        if not rows or not all(np.isfinite(float(r["train_loss"])) for r in rows):
            raise AssertionError(f"phase11 census: train losses {[r['train_loss'] for r in rows]}")
        log(f"phase11 census train (bf16, remat, G = {m['vae']['n_genes']}, a window of "
            f"{snap['datamodule']['datamodule']['genes_seq_len']}, B = {m['batch_size']}): "
            f"{CLI_CENSUS_STEPS} steps, train loss "
            + ", ".join(f"{float(r['train_loss']):.2f}" for r in rows) + "; cells/s "
            + ", ".join(f"{float(r['cells_per_sec']):.1f}" for r in rows if r.get("cells_per_sec")))
    finally:
        dm_module.H5ADFile, output_module.write_h5ad = real_h5ad, real_writer
        ckpt_module.CheckpointManager.save = real_save
        VAETask.train_step, VAETask.train_steps = real_step, real_steps
        shutil.rmtree(tmp, ignore_errors=True)

    for name, step, seconds, size in saves:
        log(f"phase11 checkpoint {name} step {step}: {size / 2**20:.1f} MiB written in "
            f"{seconds * 1e3:.1f} ms")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("yaml", "h5py", "pandas", "jax"))
    if loaded:
        raise AssertionError(f"phase11: {loaded} loaded")
    log(f"phase11 took {time.perf_counter() - phase_t0:.1f} s; launches {total}")
    return total


# phase 12: the scVI baseline (scldm_torch.cli.train_scvi) and the generation evals
# inside train_ldm, at full dentate width on synthetic CSR cells
SCVI_CELLS = 2_560  # 2,304 train cells after the validation split: 18 steps of 128
SCVI_STEPS = 24
# the LDM's train file and its test file (val_as_test): 8 batches of 128 each, so
# the eval generates and compares eval_generation.sample_size = 1,024 cells
EVAL_CELLS = 1_024
EVAL_STEPS = 16  # 8 steps an epoch: the eval runs after epoch 1's validation
# the rows of each eval matrix that the CPU recomputes the metrics on: at 256 the
# CPU took 77.7 s (Sinkhorn's 10,000 iterations and the pairwise kernels)
EVAL_CPU_CELLS = 128
# the biases of the scVI dense layers that feed a BatchNorm: their gradient is
# zero but for rounding (the batch mean is subtracted)
SCVI_BN_INVARIANT = ("encoder.dense_0.bias", "decoder.dense_0.bias")


def phase12_scvi_and_evals(seed: int, smi: str) -> dict:
    """(a) `train_scvi.main` on configs/vae_scvi_training.yaml as shipped
    (17,002 genes, B = 128, 128 hidden, 10 latent, dropout 0.1): a run sent
    SIGTERM in its first dispatch (the guard checkpoints at the dispatch's
    end) and resumed, held bit for bit to an uninterrupted run (parameters,
    BatchNorm buffers, optimizer state, generator); one step on the card
    held to the same step on the CPU (the same weights, batch and draws) at
    1e-4; train cells/s from metrics.csv. (b) `train` for a VAE checkpoint,
    then `train_ldm` with `model.eval_generation` on (freq 1, no warmup, the
    shipped sample_size 1,024, dopri5 at 50 steps) on 1,024 validation cells:
    generation_eval.csv must hold finite metrics; the card's metrics are held
    to the CPU's on the first EVAL_CPU_CELLS rows of the same two count
    matrices (MMD 1e-4 relative, Sinkhorn 1e-3 with the same iteration
    count), a real-versus-real split must read near zero, and the eval's
    seconds (MMD, Sinkhorn iterations and time) and peak memory are printed.
    Returns the DiT block launches of (b)."""
    import os
    import signal
    import tempfile

    import numpy as np
    import torch

    from scldm_torch.cli import train as cli_train
    from scldm_torch.cli import train_ldm as cli_train_ldm
    from scldm_torch.cli import train_scvi as cli_train_scvi
    from scldm_torch.cli._common import parse_config
    from scldm_torch.config.build import build_datamodule, build_scvi_task
    from scldm_torch.data import datamodule as dm_module
    from scldm_torch.evals import generation_eval as ge
    from scldm_torch.evals.mmd import MMD_METRICS
    from scldm_torch.ops import fused_dit
    from scldm_torch.training import checkpoint as ckpt_module
    from scldm_torch.training.loop import to_device
    from scldm_torch.training.scvi_task import ScviTask

    phase_t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 12)
    dentate = json.loads((ROOT / "metadata/dentategyrus_train.json").read_text())
    tmp = Path(tempfile.mkdtemp(prefix="scldm_phase12_"))
    names = {"scvi": SCVI_CELLS, "ldm_train": EVAL_CELLS, "ldm_test": EVAL_CELLS}
    shards = {str(tmp / f"{k}.h5ad"): cli_shard(rng, n, dentate["genes"], dentate["labels"])
              for k, n in names.items()}
    mu = {"clusters": {c: float(rng.uniform(6.0, 9.0)) for c in dentate["labels"]["clusters"]}}
    (tmp / "mu.json").write_text(json.dumps(mu))
    (tmp / "sd.json").write_text(json.dumps(
        {"clusters": {c: 0.05 for c in dentate["labels"]["clusters"]}}))
    counters = {"dit_block": fused_dit.DIT_BLOCK_LAUNCHES,
                "dit_block_bwd": fused_dit.DIT_BLOCK_BWD_LAUNCHES}
    config = lambda name: ["--config", str(ROOT / "configs" / name)]  # noqa: E731
    outputs = lambda name: [f"paths.output_path={tmp / name}"]  # noqa: E731
    d = "datamodule.dataset_params.dentate_gyrus"
    stats = [f"{d}.mu_size_factor={tmp / 'mu.json'}", f"{d}.sd_size_factor={tmp / 'sd.json'}"]

    def run(name: str, fn, argv: list) -> float:
        t0 = time.perf_counter()
        rc = fn(argv)
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"phase12 {name} returned {rc}")
        wall = time.perf_counter() - t0
        log(f"phase12 {name}: {wall:.2f} s wall ({smi})")
        return wall

    real_h5ad, real_step = dm_module.H5ADFile, ScviTask.train_step
    real_metrics = ge.distribution_metrics
    dm_module.H5ADFile = lambda path: shards[str(path)]
    try:
        # -- (a) the scVI baseline: preempted and resumed, against uninterrupted
        args = config("vae_scvi_training.yaml") + [
            f"datamodule.datamodule.train_adata_path={tmp / 'scvi.h5ad'}",
            f"training.max_steps={SCVI_STEPS}", "epochs=2", "training.log_every_steps=8"]
        sent = {"at": None}

        def preempting(self, state, batch, noise=None):
            out = real_step(self, state, batch, noise)
            if sent["at"] is None and state.step == 3:
                sent["at"] = state.step
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        ScviTask.train_step = preempting
        run("train_scvi (SIGTERM at step 3)", cli_train_scvi.main, args + outputs("cut"))
        ScviTask.train_step = real_step
        ck = tmp / "cut" / "checkpoints" / "scvi_dentate_gyrus"
        cut_at = max(int(p.name) for p in ck.iterdir() if p.name.isdigit())
        if sent["at"] != 3 or not 3 <= cut_at < SCVI_STEPS:
            raise AssertionError(f"phase12: the preempted scVI run saved step {cut_at}")
        run(f"train_scvi (resumed at step {cut_at})", cli_train_scvi.main, args + outputs("cut"))
        run("train_scvi (uninterrupted)", cli_train_scvi.main, args + outputs("full"))
        full = tmp / "full" / "checkpoints" / "scvi_dentate_gyrus"
        a = ckpt_module.read_payload(ck / str(SCVI_STEPS))
        b = ckpt_module.read_payload(full / str(SCVI_STEPS))
        sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
        same = (a["step"] == b["step"] == SCVI_STEPS
                and a["module"].keys() == b["module"].keys()
                and all(torch.equal(a["module"][k], b["module"][k]) for k in a["module"])
                and torch.equal(a["generator"], b["generator"]) and sa.keys() == sb.keys()
                and all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i]
                        if torch.is_tensor(sa[i][k])))
        n_buffers = sum("running_" in k for k in a["module"])
        if not same or n_buffers != 4:
            raise AssertionError("phase12: the resumed scVI run is not bitwise the uninterrupted one")
        rows = [r for r in csv.DictReader((full / "metrics.csv").open()) if r.get("cells_per_sec")]
        val = [r for r in csv.DictReader((full / "metrics.csv").open()) if r.get("val_loss")]
        if not val or not all(np.isfinite(float(r[k])) for r in rows + val for k in r if r[k]):
            raise AssertionError("phase12: non-finite scVI metrics")
        log(f"phase12 scVI: cut at step {cut_at}, resumed to {SCVI_STEPS}: parameters, "
            f"{n_buffers} BatchNorm buffers, optimizer state and generator bitwise equal to "
            f"the uninterrupted run; train cells/s from metrics.csv ({smi}): "
            + ", ".join(f"step {int(float(r['step']))}: {float(r['cells_per_sec']):.1f}"
                        for r in rows)
            + f"; val_loss {float(val[-1]['val_loss']):.2f}, val_pcc "
            f"{float(val[-1]['val_pcc']):.4f}")

        # -- one step on the card against the same step on the CPU
        cfg = parse_config(args + outputs("step"), None, "")
        task = build_scvi_task(cfg, SCVI_STEPS)
        cpu_task = build_scvi_task(parse_config(args + outputs("step") + ["device=cpu"], None, ""),
                                   SCVI_STEPS)
        cpu_task.vae.load_state_dict({k: v.cpu() for k, v in task.vae.state_dict().items()})
        dm = build_datamodule(cfg)
        dm.setup("fit")
        batch = next(iter(dm.train_batches(0)))
        g = torch.Generator().manual_seed(seed)
        hidden, latent = cfg["model"]["scvi"]["n_hidden"], cfg["model"]["scvi"]["n_latent"]
        rows_b = batch["library_size"].shape[0]
        noise = {"eps": torch.randn((rows_b, latent), generator=g),
                 "keep": {k: [torch.rand((rows_b, hidden), generator=g) < 0.9]
                          for k in ("encoder", "decoder")}}
        cuda_noise = {"eps": noise["eps"].cuda(),
                      "keep": {k: [m.cuda() for m in v] for k, v in noise["keep"].items()}}
        gstate = task.init_state(torch.Generator("cuda").manual_seed(0))
        cstate = cpu_task.init_state(torch.Generator().manual_seed(0))
        gstate, gm = task.train_step(gstate, to_device(batch, torch.device("cuda")), cuda_noise)
        cstate, cm = cpu_task.train_step(cstate, to_device(batch, torch.device("cpu")), noise)
        for k in cm:
            if not abs(float(gm[k]) - float(cm[k])) <= 1e-4 * max(abs(float(cm[k])), 1.0):
                raise AssertionError(f"phase12 scVI step {k}: card {float(gm[k])} vs CPU "
                                     f"{float(cm[k])}")
        worst = {}
        cparams = dict(cstate.module.named_parameters())
        gscale = max(float(p.grad.abs().max()) for p in cparams.values())
        for name, p in gstate.module.named_parameters():
            c = cparams[name]
            dg = float((p.grad.cpu() - c.grad).abs().max())
            bound = 1e-4 * (gscale if name in SCVI_BN_INVARIANT else float(c.grad.abs().max()))
            dp = float((p.detach().cpu() - c.detach()).abs().max())
            worst[name] = (dg, dp)
            if not dg <= bound or (name not in SCVI_BN_INVARIANT and not dp <= 1e-4):
                raise AssertionError(f"phase12 scVI step {name}: gradient {dg:.3e} (bound "
                                     f"{bound:.3e}), parameter {dp:.3e}")
        for name, buf in gstate.module.named_buffers():
            db = float((buf.cpu() - dict(cstate.module.named_buffers())[name]).abs().max())
            if not db <= 1e-4 * max(1.0, float(buf.abs().max())):
                raise AssertionError(f"phase12 scVI step buffer {name}: {db:.3e}")
        log(f"phase12 scVI step, card vs CPU (same weights, batch and draws): loss "
            f"{float(gm['train_loss']):.4f} vs {float(cm['train_loss']):.4f}; largest gradient "
            f"difference {max(v[0] for v in worst.values()):.3e}, parameter "
            f"{max(v[1] for v in worst.values()):.3e}, buffers within 1e-4")

        # -- (b) the generation eval inside train_ldm, on a VAE `train` writes
        eval_args = [f"datamodule.datamodule.train_adata_path={tmp / 'ldm_train.h5ad'}",
                     f"datamodule.datamodule.test_adata_path={tmp / 'ldm_test.h5ad'}",
                     "datamodule.datamodule.val_as_test=true", "epochs=2",
                     "training.log_every_steps=8"] + stats + outputs("eval")
        run("train (the VAE for train_ldm)", cli_train.main,
            config("vae_training.yaml") + eval_args + ["training.max_steps=8"])
        captured = {}

        def capturing(counts_real, counts_gen, library, timings=None):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            timings = {} if timings is None else timings
            out = real_metrics(counts_real, counts_gen, library, timings)
            captured.update(real=counts_real, gen=counts_gen, lib=library, timings=timings,
                            peak=torch.cuda.max_memory_allocated() - base)
            return out

        ge.distribution_metrics = capturing
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        wall = run("train_ldm (model.eval_generation.enabled=true)", cli_train_ldm.main,
                   config("ldm_training.yaml") + eval_args + [
                       f"training.max_steps={EVAL_STEPS}", "model.eval_generation.enabled=true",
                       "model.eval_generation.freq=1", "model.eval_generation.warmup_epochs=0"])
        launches = {k: c.count for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        ge.distribution_metrics = real_metrics
        L = 8
        if launches["dit_block_bwd"] != L * EVAL_STEPS or launches["dit_block"] <= L * EVAL_STEPS:
            raise AssertionError(f"phase12 train_ldm: launches {launches} in {EVAL_STEPS} steps")
        ck = tmp / "eval" / "checkpoints" / "ldm_dentate_gyrus"
        gen_rows = list(csv.DictReader((ck / "generation_eval.csv").open()))
        metric_names = [k for k in gen_rows[0] if k.startswith("generation_eval/")] if gen_rows else []
        if (len(gen_rows) != 1 or float(gen_rows[0]["epoch"]) != 1.0 or len(metric_names) != 9
                or not all(np.isfinite(float(gen_rows[0][k])) for k in metric_names)
                or float(gen_rows[0]["generation_eval/total_samples"]) != EVAL_CELLS):
            raise AssertionError(f"phase12: generation_eval.csv holds {gen_rows}")
        real, gen, lib = captured["real"], captured["gen"], captured["lib"]
        if real.shape != (EVAL_CELLS, N_GENES) or gen.shape != real.shape or not real.is_cuda:
            raise AssertionError(f"phase12: the eval's matrices {real.shape}, {gen.shape}")
        tm = captured["timings"]
        log(f"phase12 generation eval (epoch 1; {smi}): "
            + ", ".join(f"{k.split('/')[-1]} {float(gen_rows[0][k]):.6g}" for k in metric_names)
            + f"; MMD (four kernels, {EVAL_CELLS} x {EVAL_CELLS} cells of {N_GENES} genes) "
            f"{tm['mmd_s']:.2f} s, Sinkhorn W1 and W2 {tm['sinkhorn_s']:.2f} s "
            f"({tm['sinkhorn_iters'][1]} and {tm['sinkhorn_iters'][2]} iterations); the "
            f"metrics' peak memory {captured['peak'] / 2**30:.2f} GiB above the "
            f"{(peak - captured['peak']) / 2**30:.2f} GiB around them; train_ldm {wall:.1f} s "
            f"wall, its peak {peak / 2**30:.2f} GiB; DiT block launches {launches}")

        # -- the card's metrics against the CPU's on the same rows of the same matrices
        n = EVAL_CPU_CELLS
        card_t, cpu_t = {}, {}
        t0 = time.perf_counter()
        card = real_metrics(real[:n], gen[:n], lib[:n], card_t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cpu = real_metrics(real[:n].cpu(), gen[:n].cpu(), lib[:n].cpu(), cpu_t)
        t2 = time.perf_counter()
        for k, v in cpu.items():
            tol = 1e-3 if "sinkhorn" in k else 1e-4
            if not abs(card[k] - v) <= tol * max(abs(v), 1e-6):
                raise AssertionError(f"phase12 {k}: card {card[k]:.8g} vs CPU {v:.8g}")
        if card_t["sinkhorn_iters"] != cpu_t["sinkhorn_iters"]:
            raise AssertionError(f"phase12 Sinkhorn iterations: card {card_t['sinkhorn_iters']}, "
                                 f"CPU {cpu_t['sinkhorn_iters']}")
        log(f"phase12 eval metrics on the first {n} cells of both matrices, card vs CPU (MMD "
            f"1e-4, Sinkhorn 1e-3 relative): "
            + ", ".join(f"{k.split('/')[-1]} {card[k]:.6g} / {cpu[k]:.6g}" for k in cpu
                        if k != "generation_eval/total_samples")
            + f"; Sinkhorn iterations {card_t['sinkhorn_iters']} on both; card {t1 - t0:.2f} s, "
            f"CPU {t2 - t1:.2f} s")

        # -- a real-versus-real split reads near zero
        half = EVAL_CELLS // 2
        scaled = torch.log1p(real / lib * 10_000.0)
        rr = {name: float(fn(scaled[:half], scaled[half:]) if "counts" in name
                          else fn(real[:half], real[half:]))
              for name, fn in MMD_METRICS.items()}
        gen_mmd = {name: float(gen_rows[0][f"generation_eval/{name}"]) for name in MMD_METRICS}
        if not all(abs(v) <= 0.05 and abs(v) < 0.25 * abs(gen_mmd[k]) for k, v in rr.items()):
            raise AssertionError(f"phase12 real vs real: {rr} against generated {gen_mmd}")
        log("phase12 real vs real (two halves of the validation cells): "
            + ", ".join(f"{k} {v:.3e} (generated {gen_mmd[k]:.3e})" for k, v in rr.items()))
    finally:
        dm_module.H5ADFile = real_h5ad
        ScviTask.train_step = real_step
        ge.distribution_metrics = real_metrics
        shutil.rmtree(tmp, ignore_errors=True)

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("yaml", "h5py", "pandas", "jax"))
    if loaded:
        raise AssertionError(f"phase12: {loaded} loaded")
    log(f"phase12 took {time.perf_counter() - phase_t0:.1f} s; launches {launches}")
    return launches


# phase 13: the default VAE step (`cli.train`, vae_training.yaml as shipped, bf16) at
# two widths off the dentate decoder's, through the any-width kernels
WIDTH_CELLS = 1_280  # the train file: 1,152 train cells after the 10% validation split, 9 steps
WIDTH_STEPS = 8
WIDTH_POOL_STEPS = 3  # VAETask(fused_pool=True) steps at the dentate width, after a warm-up step
WIDTH_TURN = 3  # steps a turn of the kernel path against the module path


def phase13_widths(seed: int, smi: str) -> dict:
    """`scldm_torch.cli.train`'s `main(argv)` on configs/vae_training.yaml as
    shipped (bf16) at two widths the JAX gate sends the fused path but the
    dentate decoder's kernels are not tuned for, each on synthetic CSR cells
    through the in-memory shard phase 11 uses: (a) dentate (G = 17,002, the
    6,147-token window, so the module encoder and the tail) with
    `model.vae.n_embed=64 n_head_cross=4 n_inducing_points=32` (head width 16,
    hidden 172); (b) `datamodule.dataset=parse1m` (G = S = 2,000: the dense
    pool and the tail) with `n_embed=128 n_head_cross=8 n_inducing_points=64`
    (head width 16, hidden 344); (c) dentate as (a) with
    `n_inducing_points=128` (the tail's keys in two 64-key tiles) and (d)
    parse1m as (b) with `n_inducing_points=128` (the dense pool past one
    64-query tile), each one step a dispatch and a metrics.csv row a step,
    whose train loss must fall. Each trains WIDTH_STEPS steps of B = 128 and
    must launch each tail kernel (and at (b) and (d) each dense pool kernel)
    once a step; its train cells/s
    (metrics.csv) and peak memory are printed. Then,
    on an f32 VAE of the same width and G, one kernel-path step is held
    against the module path (`VAETask(fused_decoder=False)`) at phase 3's
    bounds and the two paths' steps are timed in turns with each arm's peak
    memory, and at (a) three `VAETask(fused_pool=True)` steps run the narrow
    window pool at E = 64 and one is held against the module MCAB at phase
    5's bounds. Returns the launches of each kernel in the CLI runs and the
    fused_pool steps: {"dentate": ..., "parse1m": ..., "dentate_m128": ...,
    "parse1m_q128": ..., "fused_pool": ...}."""
    import tempfile

    import numpy as np
    import torch

    from scldm_torch.cli import train as cli_train
    from scldm_torch.data import datamodule as dm_module
    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.ops import fused_decoder as fd
    from scldm_torch.ops import fused_encoder as fe
    from scldm_torch.training.metrics import global_norm
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.utils.weights import init_reference_

    phase_t0 = time.perf_counter()
    counters = {"decoder_tail_fwd": fd.DECODER_TAIL_FWD_LAUNCHES,
                "decoder_tail_bwd": fd.DECODER_TAIL_BWD_LAUNCHES,
                "encoder_pool_fwd": fe.ENCODER_POOL_FWD_LAUNCHES,
                "encoder_pool_bwd": fe.ENCODER_POOL_BWD_LAUNCHES,
                "window_pool_fwd": fe.WINDOW_POOL_FWD_LAUNCHES,
                "window_pool_bwd": fe.WINDOW_POOL_BWD_LAUNCHES}
    total = {k: 0 for k in counters}
    launches = {}  # per width, and the fused_pool steps'
    rng = np.random.default_rng(seed + 13)
    dentate = json.loads((ROOT / "metadata/dentategyrus_train.json").read_text())
    parse = json.loads((ROOT / "metadata/parse1m_train.json").read_text())
    tmp = Path(tempfile.mkdtemp(prefix="scldm_phase13_"))
    shards = {
        str(tmp / "train.h5ad"): cli_shard(rng, WIDTH_CELLS, dentate["genes"], dentate["labels"]),
        str(tmp / "test.h5ad"): cli_shard(rng, 256, dentate["genes"], dentate["labels"]),
        str(tmp / "parse_train.h5ad"): cli_shard(
            rng, WIDTH_CELLS, parse["genes"],
            {c: parse["labels"][c] for c in ("cell_type", "cytokine")}),
    }
    mu = {"clusters": {c: float(rng.uniform(6.0, 9.0)) for c in dentate["labels"]["clusters"]}}
    sd = {"clusters": {c: 0.05 for c in dentate["labels"]["clusters"]}}
    (tmp / "mu.json").write_text(json.dumps(mu))
    (tmp / "sd.json").write_text(json.dumps(sd))
    config = ["--config", str(ROOT / "configs" / "vae_training.yaml")]
    runs = {
        "dentate": [f"datamodule.datamodule.train_adata_path={tmp / 'train.h5ad'}",
                    f"datamodule.datamodule.test_adata_path={tmp / 'test.h5ad'}",
                    f"datamodule.dataset_params.dentate_gyrus.mu_size_factor={tmp / 'mu.json'}",
                    f"datamodule.dataset_params.dentate_gyrus.sd_size_factor={tmp / 'sd.json'}"],
        "parse1m": ["datamodule.dataset=parse1m",
                    f"datamodule.datamodule.train_adata_path={tmp / 'parse_train.h5ad'}"],
    }
    runs["dentate_m128"] = runs["dentate"]
    runs["parse1m_q128"] = runs["parse1m"]
    genes = {"dentate": N_GENES, "parse1m": PARSE_GENES}
    real_h5ad = dm_module.H5ADFile
    dm_module.H5ADFile = lambda path: shards[str(path)]
    log("phase13 stand-in: data.datamodule.H5ADFile -> an in-memory CSR shard (phase 11's)")
    try:
        for name, args in runs.items():
            w = WIDTHS[name]
            widths = [f"model.vae.n_embed={w['E']}", f"model.vae.n_head_cross={w['H']}",
                      f"model.vae.n_inducing_points={w['M']}"]
            argv = config + args + widths + [
                f"paths.output_path={tmp / name}", f"paths.inference_path={tmp / name / 'inf'}",
                f"training.max_steps={WIDTH_STEPS}", "epochs=1", "training.log_every_steps=4"]
            if name in ("dentate_m128", "parse1m_q128"):  # a row a step: the loss falls
                argv += ["training.steps_per_dispatch=1", "training.log_every_steps=1"]
            for c in counters.values():
                c.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if cli_train.main(argv) != 0:
                raise AssertionError(f"phase13 train at {name}: non-zero return")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: c.count for k, c in counters.items()}
            for k in total:
                total[k] += got[k]
            launches[name] = got
            want = ["decoder_tail_fwd", "decoder_tail_bwd"] + (
                ["encoder_pool_fwd", "encoder_pool_bwd"] if name.startswith("parse1m") else [])
            if any(got[k] != WIDTH_STEPS for k in want):
                raise AssertionError(f"phase13 train at {name}: {got} launches in {WIDTH_STEPS} "
                                     "steps")
            ck = next((tmp / name / "checkpoints").iterdir())
            snap = json.loads((ck / "config.json").read_text())
            v = snap["model"]["vae"]
            if (v["n_embed"], v["n_head_cross"], v["n_inducing_points"],
                    snap["model"]["compute_dtype"]) != (w["E"], w["H"], w["M"], "bfloat16"):
                raise AssertionError(f"phase13 {name}: the run's config is {v}")
            rows = [r for r in csv.DictReader((ck / "metrics.csv").open())
                    if r.get("cells_per_sec")]
            losses = [float(r["train_loss"]) for r in rows if r.get("train_loss")]
            if not losses or not all(np.isfinite(losses)):
                raise AssertionError(f"phase13 {name}: train losses {losses}")
            if name in ("dentate_m128", "parse1m_q128") and not (
                    len(losses) >= 2 and losses[-1] < losses[0]):
                raise AssertionError(f"phase13 {name}: the train loss did not fall: {losses}")
            log(f"phase13 train at {name} (E={w['E']}, n_head_cross={w['H']}, "
                f"n_inducing_points={w['M']}, hidden {w['Hd']}; bf16 as shipped): "
                f"{WIDTH_STEPS} steps of B=128 in {wall:.2f} s wall; launches "
                f"{ {k: v_ for k, v_ in got.items() if v_} } (one a step each); train cells/s "
                f"from metrics.csv ({smi}): "
                + ", ".join(f"step {int(float(r['step']))}: {float(r['cells_per_sec']):.1f}"
                            for r in rows)
                + f"; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; train loss "
                + ", ".join(f"{x:.2f}" for x in losses))
    finally:
        dm_module.H5ADFile = real_h5ad
        shutil.rmtree(tmp, ignore_errors=True)

    # one step of each path on an f32 VAE of each width: kernel vs module
    for name in ("dentate", "parse1m"):
        w, G = WIDTHS[name], genes[name]
        vae = init_reference_(build_transformer_vae(n_genes=G, n_embed=w["E"],
                                                    n_head_cross=w["H"],
                                                    n_inducing_points=w["M"], device="cuda"),
                              torch.Generator(device="cuda").manual_seed(seed + 13))
        window = WINDOW if name == "dentate" else PARSE_GENES
        nnz = (1500, 4000) if name == "dentate" else (500, PARSE_GENES)
        batches = [{k: torch.from_numpy(a).to("cuda") for k, a in
                    lean_batch(rng, 128, G, window, nnz).items()} for _ in range(2)]
        task = VAETask(vae, num_training_steps=10_000)
        if not task._use_fused(batches[0]):
            raise AssertionError(f"phase13 {name}: the lean CUDA batch did not take the kernels")
        module_task = VAETask(vae, num_training_steps=10_000, fused_decoder=False)
        compare_vae_paths(f"phase13 {name}", task, module_task, batches[-1])
        # the step through the kernels against the module path, in turns, each arm's peak
        arms = {"kernels": task, "modules": module_task}
        states = {k: t.init_state(torch.Generator(device="cuda").manual_seed(seed))
                  for k, t in arms.items()}
        times = {k: [] for k in arms}
        peaks = {k: 0.0 for k in arms}
        for k in ("modules", "kernels", "kernels", "modules"):
            states[k], _ = arms[k].train_step(states[k], batches[0])  # its warm-up / turn start
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(WIDTH_TURN):
                states[k], _ = arms[k].train_step(states[k], batches[1])
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) / WIDTH_TURN * 1e3)
            peaks[k] = max(peaks[k], torch.cuda.max_memory_allocated() / 2**30)
        log(f"phase13 {name} f32 step in turns (modules, kernels, kernels, modules; "
            f"{WIDTH_TURN} steps a turn, {smi}): kernel path "
            + ", ".join(f"{t:.2f}" for t in times["kernels"]) + " ms, module path "
            + ", ".join(f"{t:.2f}" for t in times["modules"]) + f" ms; peak "
            f"{peaks['kernels']:.3f} against {peaks['modules']:.3f} GiB")
        del states
        if name != "dentate":
            continue
        # the narrow window pool at E = 64: VAETask(fused_pool=True) on the module path
        pool_task = VAETask(vae, num_training_steps=10_000, fused_pool=True, fused_decoder=False)
        state = pool_task.init_state(torch.Generator(device="cuda").manual_seed(seed + 14))
        state, _ = pool_task.train_step(state, batches[0])  # warm-up
        torch.cuda.synchronize()
        fe.WINDOW_POOL_FWD_LAUNCHES.reset()
        fe.WINDOW_POOL_BWD_LAUNCHES.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(WIDTH_POOL_STEPS):
            state, mets = pool_task.train_step(state, batches[1])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        pool = (fe.WINDOW_POOL_FWD_LAUNCHES.count, fe.WINDOW_POOL_BWD_LAUNCHES.count)
        if pool != (WIDTH_POOL_STEPS, WIDTH_POOL_STEPS) or not torch.isfinite(mets["train_loss"]):
            raise AssertionError(f"phase13 fused_pool at E=64: launches {pool}, loss "
                                 f"{mets['train_loss'].item()}")
        total["window_pool_fwd"] += pool[0]
        total["window_pool_bwd"] += pool[1]
        launches["fused_pool"] = {"window_pool_fwd": pool[0], "window_pool_bwd": pool[1]}
        (lp, gp), (lm, gm) = (vae_loss_and_grads(t, batches[-1])
                              for t in (pool_task, VAETask(vae, fused_decoder=False)))
        norm_p, norm_m = global_norm(gp.values()).item(), global_norm(gm.values()).item()
        if abs(lp - lm) > 5e-3 * abs(lm) or abs(norm_p - norm_m) > 0.02 * norm_m:
            raise AssertionError(f"phase13 fused_pool loss {lp}, grad norm {norm_p}; module "
                                 f"path {lm}, {norm_m}")
        log(f"phase13 VAETask(fused_pool=True, fused_decoder=False) at E=64: "
            f"{dt / WIDTH_POOL_STEPS * 1e3:.2f} ms/step over {WIDTH_POOL_STEPS} steps, window "
            f"pool launches {pool}, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
            f"one step against the module path: loss {lp:.4f} vs {lm:.4f} "
            f"({abs(lp - lm) / abs(lm):.2e} relative), grad norm {norm_p:.4f} vs {norm_m:.4f} "
            f"({abs(norm_p - norm_m) / norm_m:.2e})")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("yaml", "h5py", "pandas", "jax"))
    if loaded:
        raise AssertionError(f"phase13: {loaded} loaded")
    log(f"phase13 took {time.perf_counter() - phase_t0:.1f} s; launches {total}")
    return launches


# phase 14: the model variants JAX's builders take (`cli.train` on vae_training.yaml as
# shipped, bf16, over phase 11's synthetic CSR shards; a metrics.csv row a step)
VARIANT_CELLS = 1_280  # each train file: 1,152 train cells after the 10% validation split
VARIANT_STEPS = 8
# VAETask(fused_pool=True) steps at parse1m under sqrt, and VAETask(fused_trunk=True) steps at
# dentate under softbin, each after a warm-up step
VARIANT_POOL_STEPS = 3
VARIANTS = {  # arm: (dataset, overrides)
    "a_softbin": ("dentate", ["model.vae.agg_func=softbin"]),
    "b_sqrt": ("parse1m", ["model.vae.agg_func=sqrt"]),
    "c_modules": ("dentate", ["model.vae.dropout=0.1", "model.vae.positional_encoding=false",
                              "model.vae.shared_embedding=false",
                              "model.decoder_name=negative_binomial_unshared_theta"]),
    "d_gaussian": ("dentate", ["model.decoder_name=gaussian"]),
}
# the tail kernels a step each way under (a) and (b), as JAX's gate reads only the
# decoder and the head; nothing else (the dense pool needs log1p; (c) and (d) close
# every gate)
VARIANT_TAIL = ("decoder_tail_fwd", "decoder_tail_bwd")
# (e): vae_census.yaml's B = 32 against its comment's remat_cross + cross_chunks = 8, on
# the module decoder (training.algebraic_tail=false)
KNOB_BATCH, KNOB_STEPS, KNOB_CELLS = 32, 3, 160
KNOBS = ["model.remat_cross=true", "model.cross_chunks=8"]
LDM_VARIANT_STEPS = 8


def variant_counters() -> dict:
    """Every kernel's launch counter, by its kernels-line name."""
    from scldm_torch.ops import flash_attention, fused_cross, fused_dit, fused_swiglu, fused_trunk
    from scldm_torch.ops import fused_decoder as fd
    from scldm_torch.ops import fused_encoder as fe

    return {"dit_block": fused_dit.DIT_BLOCK_LAUNCHES,
            "dit_block_bwd": fused_dit.DIT_BLOCK_BWD_LAUNCHES,
            "decoder_tail_fwd": fd.DECODER_TAIL_FWD_LAUNCHES,
            "decoder_tail_bwd": fd.DECODER_TAIL_BWD_LAUNCHES,
            "encoder_pool_fwd": fe.ENCODER_POOL_FWD_LAUNCHES,
            "encoder_pool_bwd": fe.ENCODER_POOL_BWD_LAUNCHES,
            "window_pool_fwd": fe.WINDOW_POOL_FWD_LAUNCHES,
            "window_pool_bwd": fe.WINDOW_POOL_BWD_LAUNCHES,
            "window_pool_wide_fwd": fe.WINDOW_POOL_WIDE_FWD_LAUNCHES,
            "window_pool_wide_bwd": fe.WINDOW_POOL_WIDE_BWD_LAUNCHES,
            "swiglu_vec_fwd": fused_swiglu.SWIGLU_VEC_FWD_LAUNCHES,
            "swiglu_vec_bwd": fused_swiglu.SWIGLU_VEC_BWD_LAUNCHES,
            "swiglu_gate_fwd": fused_swiglu.SWIGLU_GATE_FWD_LAUNCHES,
            "swiglu_gate_bwd": fused_swiglu.SWIGLU_GATE_BWD_LAUNCHES,
            "flash_cross": fused_cross.FLASH_CROSS_LAUNCHES,
            "flash_attention": flash_attention.FLASH_ATTENTION_LAUNCHES,
            "fused_trunk_fwd": fused_trunk.TRUNK_FWD_LAUNCHES,
            "fused_trunk_fwd_saving": fused_trunk.TRUNK_FWD_SAVING_LAUNCHES,
            "fused_trunk_bwd": fused_trunk.TRUNK_BWD_LAUNCHES}


def phase14_variants(seed: int, smi: str) -> dict:
    """The transformer-VAE and DiT variants JAX's builders take, each through
    `scldm_torch.cli.train`'s `main(argv)` on configs/vae_training.yaml as
    shipped (bf16) over phase 11's in-memory CSR shards, VARIANT_STEPS steps of
    B = 128, a metrics.csv row a step, whose train loss must fall: (a)
    dentate under `agg_func=softbin`, the tail kernels once a step each way;
    (b) parse1m under `agg_func=sqrt`, the tail a step each way and the dense
    pool not at all (JAX's gate needs log1p), then three
    `VAETask(fused_pool=True)` steps on an f32 VAE of that shape through the
    window pool, one held against the module MCAB at phase 5's bounds, and
    three `VAETask(fused_trunk=True)` steps on an f32 softbin VAE at dentate
    width through the trunk kernels and the tail, one held against the
    module trunks at phase 8's bounds; (c)
    dentate with dropout 0.1, no positional table, the decoder's own gene
    embedding and the per-token theta head, and (d) dentate under the
    Gaussian head, both with every kernel counter at 0 (JAX's gates close);
    (e) `model=vae_census training.algebraic_tail=false` at B = 32 for three
    steps, with and then without `remat_cross` + `cross_chunks=8`, each arm's
    step times (metrics.csv) and peak memory, or its out-of-memory error;
    (f) `train_ldm` over (a)'s VAE at DiT dropout 0.1 for LDM_VARIANT_STEPS
    steps and a dopri5 generation call (`inference`, generation.yaml), every
    DiT counter at 0, then the same at dropout 0, where the DiT kernels
    launch as in phase 11. Each run's counts are set to 0 just before it and
    read just after. Returns the launches of the kernels that ran."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from scldm_torch.cli import inference as cli_inference
    from scldm_torch.cli import train as cli_train
    from scldm_torch.cli import train_ldm as cli_train_ldm
    from scldm_torch.data import datamodule as dm_module
    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.training.metrics import global_norm
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.utils import output as output_module
    from scldm_torch.utils.weights import init_reference_

    phase_t0 = time.perf_counter()
    counters = variant_counters()
    total = {k: 0 for k in counters}
    rng = np.random.default_rng(seed + 14)
    dentate = json.loads((ROOT / "metadata/dentategyrus_train.json").read_text())
    parse = json.loads((ROOT / "metadata/parse1m_train.json").read_text())
    census = json.loads((ROOT / "metadata/census_genes.json").read_text())
    tmp = Path(tempfile.mkdtemp(prefix="scldm_phase14_"))
    shards = {
        str(tmp / "train.h5ad"): cli_shard(rng, VARIANT_CELLS, dentate["genes"],
                                           dentate["labels"]),
        str(tmp / "test.h5ad"): cli_shard(rng, 256, dentate["genes"], dentate["labels"]),
        str(tmp / "parse_train.h5ad"): cli_shard(
            rng, VARIANT_CELLS, parse["genes"],
            {c: parse["labels"][c] for c in ("cell_type", "cytokine")}),
        str(tmp / "census_train.h5ad"): cli_shard(rng, KNOB_CELLS, census["genes"], {}),
    }
    mu = {"clusters": {c: float(rng.uniform(6.0, 9.0)) for c in dentate["labels"]["clusters"]}}
    sd = {"clusters": {c: 0.05 for c in dentate["labels"]["clusters"]}}
    (tmp / "mu.json").write_text(json.dumps(mu))
    (tmp / "sd.json").write_text(json.dumps(sd))
    data = {
        "dentate": [f"datamodule.datamodule.train_adata_path={tmp / 'train.h5ad'}",
                    f"datamodule.datamodule.test_adata_path={tmp / 'test.h5ad'}",
                    f"datamodule.dataset_params.dentate_gyrus.mu_size_factor={tmp / 'mu.json'}",
                    f"datamodule.dataset_params.dentate_gyrus.sd_size_factor={tmp / 'sd.json'}"],
        "parse1m": ["datamodule.dataset=parse1m",
                    f"datamodule.datamodule.train_adata_path={tmp / 'parse_train.h5ad'}"],
    }
    per_step = ["epochs=1", "training.steps_per_dispatch=1", "training.log_every_steps=1"]

    def outputs(name):
        return [f"paths.output_path={tmp / name}", f"paths.inference_path={tmp / name / 'inf'}"]

    def config(name):
        return ["--config", str(ROOT / "configs" / name)]

    def run(name: str, fn, argv: list) -> tuple:
        """One CLI call, every count set to 0 just before it and read just
        after: (launches, wall seconds, peak GiB)."""
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if fn(argv) != 0:
            raise AssertionError(f"phase14 {name}: non-zero return")
        torch.cuda.synchronize()
        got = {k: c.count for k, c in counters.items()}
        for k in total:
            total[k] += got[k]
        return got, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30

    def metrics(ck: Path) -> tuple:
        rows = [r for r in csv.DictReader((ck / "metrics.csv").open()) if r.get("cells_per_sec")]
        losses = [float(r["train_loss"]) for r in rows if r.get("train_loss")]
        if not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"phase14 {ck}: train losses {losses}")
        return rows, losses

    def cells_per_s(rows) -> str:
        return ", ".join(f"step {int(float(r['step']))}: {float(r['cells_per_sec']):.1f}"
                         for r in rows)

    written = []

    def capture_h5ad(path, X, obs=None, var_names=None, obsm=None, **kwargs):
        written.append({"path": Path(path).name, "X": np.asarray(X)})

    real_h5ad, real_writer = dm_module.H5ADFile, output_module.write_h5ad
    dm_module.H5ADFile = lambda path: shards[str(path)]
    output_module.write_h5ad = capture_h5ad
    log("phase14 stand-ins: data.datamodule.H5ADFile -> an in-memory CSR shard (phase 11's), "
        "utils.output.write_h5ad -> a capturing writer")
    try:
        # -- (a) to (d): the VAE variants through cli.train
        for arm, (dataset, variant) in VARIANTS.items():
            argv = (config("vae_training.yaml") + data[dataset] + outputs(arm) + variant
                    + per_step + [f"training.max_steps={VARIANT_STEPS}"])
            got, wall, peak = run(f"train {arm}", cli_train.main, argv)
            want = {k: VARIANT_STEPS if k in VARIANT_TAIL and arm in ("a_softbin", "b_sqrt")
                    else 0 for k in counters}
            if got != want:
                raise AssertionError(f"phase14 train {arm}: launches "
                                     f"{ {k: v for k, v in got.items() if v} }, expected "
                                     f"{ {k: v for k, v in want.items() if v} }")
            ck = next((tmp / arm / "checkpoints").iterdir())
            snap = json.loads((ck / "config.json").read_text())
            if snap["model"]["compute_dtype"] != "bfloat16":
                raise AssertionError(f"phase14 {arm}: the run's config is {snap['model']}")
            rows, losses = metrics(ck)
            if not (len(losses) >= 2 and losses[-1] < losses[0]):
                raise AssertionError(f"phase14 {arm}: the train loss did not fall: {losses}")
            log(f"phase14 train {arm} ({dataset}, {' '.join(variant)}; bf16 as shipped): "
                f"{VARIANT_STEPS} steps of B=128 in {wall:.2f} s wall; launches "
                f"{ {k: v for k, v in got.items() if v} }; train cells/s from metrics.csv "
                f"({smi}): {cells_per_s(rows)}; peak {peak:.3f} GiB; train loss "
                + ", ".join(f"{x:.2f}" for x in losses))

        # -- (b) continued: the window pool under sqrt, VAETask(fused_pool=True), f32
        vae = init_reference_(build_transformer_vae(n_genes=PARSE_GENES, agg_func="sqrt",
                                                    device="cuda"),
                              torch.Generator(device="cuda").manual_seed(seed + 14))
        batches = [{k: torch.from_numpy(a).to("cuda") for k, a in
                    lean_batch(rng, 128, PARSE_GENES, PARSE_GENES, (500, PARSE_GENES)).items()}
                   for _ in range(2)]
        pool_task = VAETask(vae, num_training_steps=10_000, fused_pool=True, fused_decoder=False)
        state = pool_task.init_state(torch.Generator(device="cuda").manual_seed(seed))
        state, _ = pool_task.train_step(state, batches[0])  # warm-up
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(VARIANT_POOL_STEPS):
            state, mets = pool_task.train_step(state, batches[1])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / VARIANT_POOL_STEPS
        pool = {k: c.count for k, c in counters.items() if c.count}
        want = {"window_pool_fwd": VARIANT_POOL_STEPS, "window_pool_bwd": VARIANT_POOL_STEPS}
        if pool != want or not torch.isfinite(mets["train_loss"]):
            raise AssertionError(f"phase14 fused_pool under sqrt: launches {pool}, loss "
                                 f"{mets['train_loss'].item()}")
        for k, v in pool.items():
            total[k] += v
        (lp, gp), (lm, gm) = (vae_loss_and_grads(t, batches[-1])
                              for t in (pool_task, VAETask(vae, fused_decoder=False)))
        norm_p, norm_m = global_norm(gp.values()).item(), global_norm(gm.values()).item()
        if abs(lp - lm) > 5e-3 * abs(lm) or abs(norm_p - norm_m) > 0.02 * norm_m:
            raise AssertionError(f"phase14 fused_pool under sqrt: loss {lp}, grad norm {norm_p}; "
                                 f"module path {lm}, {norm_m}")
        log(f"phase14 VAETask(fused_pool=True, fused_decoder=False) at parse1m under "
            f"agg_func=sqrt (f32): {dt * 1e3:.2f} ms/step over {VARIANT_POOL_STEPS} steps "
            f"({smi}), window pool launches {pool}, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; one step against the module "
            f"MCAB: loss {lp:.4f} vs {lm:.4f} ({abs(lp - lm) / abs(lm):.2e} relative), grad norm "
            f"{norm_p:.4f} vs {norm_m:.4f} ({abs(norm_p - norm_m) / norm_m:.2e})")
        del vae, pool_task, state, batches

        # -- (a) continued: the whole trunk under softbin, VAETask(fused_trunk=True), f32: two
        #    saving forwards and two backwards a step (rows 10-11), the tail once each way
        vae = init_reference_(build_transformer_vae(n_genes=N_GENES, agg_func="softbin",
                                                    device="cuda"),
                              torch.Generator(device="cuda").manual_seed(seed + 15))
        batches = [{k: torch.from_numpy(a).to("cuda") for k, a in lean_batch(rng, 128).items()}
                   for _ in range(2)]
        trunk_task = VAETask(vae, num_training_steps=10_000, fused_trunk=True)
        state = trunk_task.init_state(torch.Generator(device="cuda").manual_seed(seed))
        state, _ = trunk_task.train_step(state, batches[0])  # warm-up
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        for _ in range(VARIANT_POOL_STEPS):
            state, mets = trunk_task.train_step(state, batches[1])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / VARIANT_POOL_STEPS
        trunk = {k: c.count for k, c in counters.items() if c.count}
        n = VARIANT_POOL_STEPS
        want = {"fused_trunk_fwd_saving": 2 * n, "fused_trunk_bwd": 2 * n,
                "decoder_tail_fwd": n, "decoder_tail_bwd": n}
        if trunk != want or not torch.isfinite(mets["train_loss"]):
            raise AssertionError(f"phase14 fused_trunk under softbin: launches {trunk}, loss "
                                 f"{mets['train_loss'].item()}")
        for k, v in trunk.items():
            total[k] += v
        compare_trunk_paths("phase14 fused_trunk under softbin", trunk_task,
                            VAETask(vae, num_training_steps=10_000), batches[-1])
        log(f"phase14 VAETask(fused_trunk=True) at dentate under agg_func=softbin (f32): "
            f"{dt * 1e3:.2f} ms/step over {n} steps ({smi}), launches {trunk}")
        del vae, trunk_task, state, batches

        # -- (e) the census VAE at B = 32 on the module decoder, with and without the knobs
        census_cfg = tmp / "census_cfg"
        census_cfg.mkdir()
        for group in ("paths", "model", "training", "datamodule"):
            (census_cfg / group).symlink_to(ROOT / "configs" / group, target_is_directory=True)
        training_yaml = (ROOT / "configs" / "vae_training.yaml").read_text()
        (census_cfg / "vae_census_training.yaml").write_text(
            training_yaml.replace("model: vae_base", "model: vae_census"))
        for arm, knobs in (("e_knobs", KNOBS), ("e_plain", [])):
            argv = (["--config", str(census_cfg / "vae_census_training.yaml")] + outputs(arm)
                    + ["datamodule.dataset=homo_sapiens",
                       f"datamodule.datamodule.train_adata_path={tmp / 'census_train.h5ad'}",
                       f"model.batch_size={KNOB_BATCH}", "training.algebraic_tail=false",
                       f"training.max_steps={KNOB_STEPS}"] + per_step + knobs)
            gc.collect()
            torch.cuda.empty_cache()
            try:
                got, wall, peak = run(f"train {arm}", cli_train.main, argv)
            except torch.OutOfMemoryError as e:
                torch.cuda.synchronize()
                log(f"phase14 census B={KNOB_BATCH} {arm} ({' '.join(knobs) or 'no knobs'}): does "
                    f"not fit on the card ({smi}): {str(e).splitlines()[0]}; peak "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB when it failed")
                continue
            ck = next((tmp / arm / "checkpoints").iterdir())
            snap = json.loads((ck / "config.json").read_text())
            m = snap["model"]
            if (m["batch_size"], m.get("remat_cross", False), m.get("cross_chunks", 1),
                    snap["training"]["algebraic_tail"]) != (
                    KNOB_BATCH, bool(knobs), 8 if knobs else 1, False):
                raise AssertionError(f"phase14 {arm}: the run's config is {m}")
            if any(got.values()):
                raise AssertionError(f"phase14 {arm}: launches {got} on the module decoder")
            rows, losses = metrics(ck)
            log(f"phase14 census B={KNOB_BATCH} {arm} ({' '.join(knobs) or 'no knobs'}; bf16, "
                f"remat, G = {m['vae']['n_genes']}, the module decoder): {KNOB_STEPS} steps in "
                f"{wall:.2f} s wall; step time from metrics.csv ({smi}): "
                + ", ".join(f"step {int(float(r['step']))}: "
                            f"{KNOB_BATCH / float(r['cells_per_sec']) * 1e3:.1f} ms" for r in rows)
                + f"; peak {peak:.3f} GiB; train loss " + ", ".join(f"{x:.2f}" for x in losses))

        # -- (f) train_ldm over (a)'s VAE at DiT dropout 0.1, then 0; a dopri5 generation each
        vae_dir = tmp / "a_softbin" / "checkpoints" / "vae_dentate_gyrus"
        for arm, dropout in (("f_dropout", 0.1), ("f_plain", 0.0)):
            args = (data["dentate"] + outputs(arm)
                    + [f"vae_checkpoint_dir={vae_dir}", f"model.diffusion_model.dropout={dropout}"])
            got, wall, peak = run(f"train_ldm {arm}", cli_train_ldm.main,
                                  config("ldm_training.yaml") + args + per_step
                                  + [f"training.max_steps={LDM_VARIANT_STEPS}"])
            L = 8
            want = 0 if dropout else L * LDM_VARIANT_STEPS
            dit = {k: got[k] for k in ("dit_block", "dit_block_bwd")}
            if dit != {"dit_block": want, "dit_block_bwd": want} or any(
                    v for k, v in got.items() if k not in dit):
                raise AssertionError(f"phase14 train_ldm {arm}: launches {got}")
            rows, losses = metrics(tmp / arm / "checkpoints" / "ldm_dentate_gyrus")
            written.clear()
            gen, gen_wall, _ = run(f"generation {arm}", cli_inference.main,
                                   config("generation.yaml") + args
                                   + ["generation_args.n_batches=1"])
            (out,) = written
            if not np.isfinite(out["X"]).all() or out["X"].shape[1] != N_GENES:
                raise AssertionError(f"phase14 generation {arm}: counts {out['X'].shape}")
            if bool(gen["dit_block"]) == bool(dropout) or gen["dit_block_bwd"] or any(
                    v for k, v in gen.items() if k not in dit):
                raise AssertionError(f"phase14 generation {arm}: launches {gen}")
            log(f"phase14 train_ldm {arm} over (a)'s softbin VAE (DiT dropout {dropout}): "
                f"{LDM_VARIANT_STEPS} steps in {wall:.2f} s wall, launches "
                f"{ {k: v for k, v in got.items() if v} }; train cells/s from metrics.csv "
                f"({smi}): {cells_per_s(rows)}; peak {peak:.3f} GiB; train loss "
                + ", ".join(f"{x:.4f}" for x in losses)
                + f"; dopri5 generation of {out['X'].shape[0]} cells in {gen_wall:.2f} s, DiT "
                f"block launches {gen['dit_block']}")
    finally:
        dm_module.H5ADFile, output_module.write_h5ad = real_h5ad, real_writer
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("yaml", "h5py", "pandas", "jax"))
    if loaded:
        raise AssertionError(f"phase14: {loaded} loaded")
    log(f"phase14 took {time.perf_counter() - phase_t0:.1f} s; launches "
        f"{ {k: v for k, v in total.items() if v} }")
    return total


P15_STEPS = 4  # LDM steps a transport, on one batch and one set of draws
P15_TRANSPORTS = (("GVP", "velocity", None), ("VP", "noise", "likelihood"),
                  ("Linear", "score", "velocity"))
P15_SDE = (("Euler", 250, "Mean"), ("Heun", 100, "Tweedie"))  # method, steps, last step
P15_SDE_BATCH = 16
P15_SDE_NEAR = 1e-3  # SDE states, kernel vs module DiT, as a share of the largest |x|
P15_LIKELIHOOD_BATCH = 16
P15_LIKELIHOOD_STEPS = 50
P15_CLI_VAE_STEPS = 2
P15_CLI_LDM_STEPS = 4
P15_LEAN_TURN = 2  # steps a turn of the lean / dense loss comparison
P15_CLI_EXTRA: list = []  # overrides a rehearsal at small shapes adds to the CLI calls


def phase15_transports_joint_lean(seed: int, batch: int, smi: str) -> dict:
    """The transports, joint finetuning and the lean loss at
    full dentate width (B = 128, G = 17,002, the VAE at E = 32 with 16 latent
    tokens of 16, the DiT at E = 256, 8 layers, 8 heads):

    (a) P15_STEPS LDM steps under GVP/velocity, VP/noise/likelihood and
    Linear/score/velocity through the DiT block kernels (8 launches each way
    a step), on one batch and one set of the transport's draws so that the
    loss must fall; the first step's loss and gradient norm held to the
    module DiT's at JAX's bounds between its two paths (1e-4, 1e-3).
    (b) dopri5 CFG generation of the score-trained DiT through the forward
    kernel, then `Sampler.sample_sde` Euler (250 steps, last step Mean) and
    Heun (100 steps, Tweedie) with `fused_dit_forward` as the model, held
    against the module DiT on the same Brownian normals within
    P15_SDE_NEAR of the largest |x|.
    (c) `sample_ode_likelihood` (euler, 50 steps) on the module DiT of the
    GVP/velocity task at a batch of 16: finite log-likelihoods.
    (d) `cli.train` (P15_CLI_VAE_STEPS steps), then `cli.train_ldm` from
    ldm_training.yaml as shipped with `model.vae_as_tokenizer.train=true`
    (P15_CLI_LDM_STEPS steps: no DiT kernel launch, JAX's gates), whose
    checkpoint must carry a VAE whose encoder moved and whose decoder did
    not; then `cli.inference` generation from it through the forward kernel,
    decoding with that finetuned VAE (checked weight for weight). Phase 11's
    stand-ins for h5py.
    (e) `VAETask(lean_loss=True)` against the dense loss at dentate (the
    tail kernels, f32) and at census as vae_census.yaml ships it (bf16,
    remat, the fused gate's `swiglu_vec`): one step's loss within 1e-6
    relative, its gradients by `held_bf16` at dentate (the tail rounds to
    bf16, and the two losses' d(mu) differ in last bits) and by
    `CENSUS_BF16_BOUNDS`' bound between two bf16 evaluations of one function
    at census, the lean gradients twice to the same bits, then P15_LEAN_TURN
    steps a turn in turns (lean, dense, dense, lean) with each arm's ms per
    step and peak memory.

    Each counted run's counts are set to 0 just before it and read just
    after. Returns the launches by kernels-line name."""
    import copy
    import gc
    import tempfile

    import numpy as np
    import torch

    from scldm_torch.cli import inference as cli_inference
    from scldm_torch.cli import train as cli_train
    from scldm_torch.cli import train_ldm as cli_train_ldm
    from scldm_torch.data import datamodule as dm_module
    from scldm_torch.nn.nnets import build_cfg_segments
    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.ops.fused_dit import extract_block_params, fused_dit_forward
    from scldm_torch.ops.transforms import canonical_gene_ids
    from scldm_torch.sampling.size_factors import SizeFactorSampler, constant_stats
    from scldm_torch.training.checkpoint import read_payload
    from scldm_torch.training.ldm_task import LDMTask
    from scldm_torch.training.metrics import global_norm
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.transport import Sampler, create_transport
    from scldm_torch.utils import output as output_module
    from scldm_torch.utils.weights import init_reference_

    phase_t0 = time.perf_counter()
    counters = variant_counters()
    total = {k: 0 for k in counters}

    def reset():
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()

    def read(add: bool = True) -> dict:
        torch.cuda.synchronize()
        got = {k: c.count for k, c in counters.items() if c.count}
        if add:
            for k, v in got.items():
                total[k] += v
        return got

    rng = np.random.default_rng(seed + 150)
    vae, dit0 = build_models(seed)
    L = dit0.n_layer
    (b,) = ldm_batches(rng, batch, 1)

    # -- (a) training under each transport
    trained = {}
    for path, pred, weight in P15_TRANSPORTS:
        name = f"{path}/{pred}/{weight or 'none'}"
        transport = create_transport(path, pred, weight)
        dit = copy.deepcopy(dit0)
        task = LDMTask(vae, dit, transport, num_training_steps=10_000, num_warmup_steps=1)
        module_task = LDMTask(vae, dit, transport, fused_training=False)
        g = torch.Generator(device="cuda").manual_seed(seed + 151)
        z = task._encode(b)
        t, x0, _ = transport.sample(g, z)
        noise = {"t": t, "x0": x0,
                 "drop_mask": torch.rand(batch, generator=g, device="cuda") < dit.cfg_dropout_prob}
        runs = []
        for tk in (task, module_task):
            loss, grads = ldm_loss_and_grads(tk, b, g, noise)
            runs.append((loss, global_norm(grads.values()).item()))
        (lk, nk), (lm, nm) = runs
        if not (abs(lk - lm) <= 1e-4 * abs(lm) and abs(nk - nm) <= 1e-3 * nm):
            raise AssertionError(f"phase15 {name}: kernel path loss {lk}, grad norm {nk}; module "
                                 f"path {lm}, {nm}")
        state = task.init_state(torch.Generator(device="cuda").manual_seed(seed))
        reset()
        t0 = time.perf_counter()
        losses = []
        for _ in range(P15_STEPS):
            state, mets = task.train_step(state, b, noise)
            losses.append(mets["train_loss"])
        got = read()
        dt = (time.perf_counter() - t0) / P15_STEPS
        losses = torch.stack(losses).tolist()
        if got != {"dit_block": L * P15_STEPS, "dit_block_bwd": L * P15_STEPS}:
            raise AssertionError(f"phase15 {name}: launches {got} in {P15_STEPS} steps")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"phase15 {name}: losses {losses}")
        log(f"phase15 (a) LDM training under {name} (t on {transport.check_interval()}), "
            f"B={batch}: one step kernel vs module path loss {lk:.6f} vs {lm:.6f} "
            f"({abs(lk - lm) / abs(lm):.2e}), grad norm {nk:.5f} vs {nm:.5f} "
            f"({abs(nk - nm) / nm:.2e}); {P15_STEPS} steps on one batch and one set of draws, "
            f"{dt * 1e3:.2f} ms/step ({smi}), losses " + ", ".join(f"{x:.5f}" for x in losses)
            + f"; launches {got}")
        trained[pred] = (task, state)

    # -- (b) generation of the score-trained DiT: dopri5 with CFG, then the SDE samplers
    task, state = trained["score"]
    dit = task.dit
    fn = task.make_sample_fn(SizeFactorSampler(constant_stats({"clusters": N_CLUSTERS}, mu=8.6,
                                                              sd=0.3)),
                             guidance_weight=GUIDANCE, sampling_method="dopri5", num_steps=50,
                             use_ema=False)
    genes = canonical_gene_ids(N_GENES, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 152)
    reset()
    t0 = time.perf_counter()
    counts, zs = fn(g, genes, {"clusters": b["clusters"]}, state=state)
    gen = read()
    dt = time.perf_counter() - t0
    if counts.shape != (2 * batch, N_GENES) or not torch.isfinite(zs).all():
        raise AssertionError(f"phase15 score generation: counts {tuple(counts.shape)}")
    if fn.drift_evals <= 0 or gen != {"dit_block": L * fn.drift_evals}:
        raise AssertionError(f"phase15 score generation: {gen} for {fn.drift_evals} evaluations")
    log(f"phase15 (b) dopri5 CFG generation of the Linear/score DiT ({2 * batch} cells, t on "
        f"{task.transport.check_interval(eval=True)}): {dt:.3f} s ({smi}), DiT evals "
        f"{fn.drift_evals}, launches {gen}; z max |z| {zs.abs().max().item():.3f}")

    cond = {"clusters": b["clusters"][:P15_SDE_BATCH]}
    block_params = [extract_block_params(blk) for blk in dit.blocks]

    def kernel_model(x, t):
        return fused_dit_forward(dit, x, t, cond, block_params)

    def module_model(x, t):
        return dit(x, t, cond)

    sampler = Sampler(task.transport)
    x_init = torch.randn(P15_SDE_BATCH, dit.seq_len, dit.n_embed_input, generator=g,
                         device="cuda")
    for method, steps, last in P15_SDE:
        normals = torch.randn((steps - 1, *x_init.shape), generator=g, device="cuda")
        sde = sampler.sample_sde(sampling_method=method, num_steps=steps, last_step=last)
        with torch.inference_mode():
            reset()
            t0 = time.perf_counter()
            xk = sde(normals, x_init, kernel_model)
            got = read()
            dt = time.perf_counter() - t0
            xm = sde(normals, x_init, module_model)
            torch.cuda.synchronize()
        per_step = 2 if method == "Euler" else 4  # model calls a step: drift and score
        evals = per_step * (steps - 1) + (2 if last == "Mean" else 1)
        if got != {"dit_block": L * evals}:
            raise AssertionError(f"phase15 SDE {method}: launches {got}, expected {L * evals}")
        err, scale = (xk - xm).abs().max().item(), xm.abs().max().item()
        if not (torch.isfinite(xk).all() and err <= P15_SDE_NEAR * scale):
            raise AssertionError(f"phase15 SDE {method}: kernel vs module max abs err {err:.3e}, "
                                 f"max |x| {scale:.3e}")
        log(f"phase15 (b) sample_sde {method} {steps} steps, last step {last}, "
            f"{P15_SDE_BATCH} cells through fused_dit_forward: {dt:.3f} s ({smi}), launches "
            f"{got}; against the module DiT at the same normals: max abs err {err:.3e} "
            f"({err / scale:.2e} of max |x| {scale:.3f})")

    # -- (c) the likelihood ODE on the module DiT of the GVP/velocity task (VP under noise
    #    prediction divides by sigma_t = 0 at the reverse interval's start, in JAX as here)
    task, _ = trained["velocity"]
    lk_cond = {"clusters": b["clusters"][:P15_LIKELIHOOD_BATCH]}
    x_data = task._encode({k: v[:P15_LIKELIHOOD_BATCH] for k, v in b.items()}).float()
    like = Sampler(task.transport).sample_ode_likelihood(sampling_method="euler",
                                                         num_steps=P15_LIKELIHOOD_STEPS)
    reset()
    t0 = time.perf_counter()
    logp, z0 = like(g, x_data, lambda x, t: task.dit(x, t, lk_cond))
    got = read(add=False)
    dt = time.perf_counter() - t0
    if got or logp.shape != (P15_LIKELIHOOD_BATCH,) or not (
            torch.isfinite(logp).all() and torch.isfinite(z0).all()):
        raise AssertionError(f"phase15 likelihood: launches {got}, logp {logp.tolist()}")
    log(f"phase15 (c) sample_ode_likelihood (euler, {P15_LIKELIHOOD_STEPS} steps, Hutchinson by "
        f"one vector-Jacobian product a step) on the GVP/velocity module DiT, "
        f"{P15_LIKELIHOOD_BATCH} cells: {dt:.3f} s ({smi}); logp mean {logp.mean().item():.2f}, range "
        f"[{logp.min().item():.2f}, {logp.max().item():.2f}] nats per cell")
    del trained, task, state, dit, fn, counts, zs
    gc.collect()
    torch.cuda.empty_cache()

    # -- (d) joint finetuning through the CLIs
    dentate = json.loads((ROOT / "metadata/dentategyrus_train.json").read_text())
    tmp = Path(tempfile.mkdtemp(prefix="scldm_phase15_"))
    shards = {str(tmp / "train.h5ad"): cli_shard(rng, VARIANT_CELLS, dentate["genes"],
                                                 dentate["labels"]),
              str(tmp / "test.h5ad"): cli_shard(rng, 256, dentate["genes"], dentate["labels"])}
    mu = {"clusters": {c: float(rng.uniform(6.0, 9.0)) for c in dentate["labels"]["clusters"]}}
    sd = {"clusters": {c: 0.05 for c in dentate["labels"]["clusters"]}}
    (tmp / "mu.json").write_text(json.dumps(mu))
    (tmp / "sd.json").write_text(json.dumps(sd))
    args = [f"datamodule.datamodule.train_adata_path={tmp / 'train.h5ad'}",
            f"datamodule.datamodule.test_adata_path={tmp / 'test.h5ad'}",
            f"datamodule.dataset_params.dentate_gyrus.mu_size_factor={tmp / 'mu.json'}",
            f"datamodule.dataset_params.dentate_gyrus.sd_size_factor={tmp / 'sd.json'}",
            f"paths.output_path={tmp / 'out'}", f"paths.inference_path={tmp / 'out' / 'inf'}",
            "epochs=1", "training.steps_per_dispatch=1", "training.log_every_steps=1",
            *P15_CLI_EXTRA]
    joint = ["model.vae_as_tokenizer.train=true"]

    def config(name):
        return ["--config", str(ROOT / "configs" / name)]

    written, seen = [], {}

    def capture_h5ad(path, X, obs=None, var_names=None, obsm=None, **kwargs):
        written.append(np.asarray(X))

    real_gen = LDMTask.generate_from_noise

    def generate_from_noise(self, *a, **kw):
        seen["vae"] = {k: v.detach().clone() for k, v in self.vae.state_dict().items()}
        return real_gen(self, *a, **kw)

    real_h5ad, real_writer = dm_module.H5ADFile, output_module.write_h5ad
    dm_module.H5ADFile = lambda path: shards[str(path)]
    output_module.write_h5ad = capture_h5ad
    LDMTask.generate_from_noise = generate_from_noise
    log("phase15 stand-ins: data.datamodule.H5ADFile -> an in-memory CSR shard (phase 11's), "
        "utils.output.write_h5ad -> a capturing writer")
    try:
        if cli_train.main(config("vae_training.yaml") + args
                          + [f"training.max_steps={P15_CLI_VAE_STEPS}"]) != 0:
            raise AssertionError("phase15 train: non-zero return")
        reset()
        t0 = time.perf_counter()
        if cli_train_ldm.main(config("ldm_training.yaml") + args + joint
                              + [f"training.max_steps={P15_CLI_LDM_STEPS}"]) != 0:
            raise AssertionError("phase15 train_ldm: non-zero return")
        got = read()
        wall = time.perf_counter() - t0
        if got:
            raise AssertionError(f"phase15 train_ldm with train_vae: launches {got} (JAX's gates "
                                 "are closed under train_vae)")
        ckpts = tmp / "out" / "checkpoints"

        def latest(d):
            return read_payload(max((ckpts / d).glob("[0-9]*"), key=lambda p: int(p.name)))

        vae_ck = latest("vae_dentate_gyrus")["module"]
        ldm = latest("ldm_dentate_gyrus")
        tuned = {k[4:]: v for k, v in ldm["module"].items() if k.startswith("vae.")}
        enc = [k for k in tuned if k.startswith("encoder.") and k != "encoder.pos_embed"]
        dec = [k for k in tuned if k.startswith("decoder")]
        moved = sum(not torch.equal(tuned[k], vae_ck[k]) for k in enc)
        if set(tuned) != set(vae_ck) or not moved or any(
                not torch.equal(tuned[k], vae_ck[k]) for k in dec):
            raise AssertionError(f"phase15 train_vae checkpoint: {moved} of {len(enc)} encoder "
                                 f"tensors moved; decoder unchanged "
                                 f"{all(torch.equal(tuned[k], vae_ck[k]) for k in dec)}")
        if ldm["step"] != P15_CLI_LDM_STEPS:
            raise AssertionError(f"phase15 train_ldm: checkpoint at step {ldm['step']}")
        log(f"phase15 (d) train_ldm with model.vae_as_tokenizer.train=true (bf16 as shipped, "
            f"B=128): {P15_CLI_LDM_STEPS} steps in {wall:.2f} s wall ({smi}), no kernel launch "
            f"(JAX's gates under train_vae); the checkpoint's VAE: {moved} of {len(enc)} encoder "
            f"tensors moved, {len(dec)} decoder and head tensors unchanged (weight decay 0)")
        reset()
        t0 = time.perf_counter()
        if cli_inference.main(config("generation.yaml") + args + joint
                              + ["generation_args.n_batches=1"]) != 0:
            raise AssertionError("phase15 inference: non-zero return")
        gen = read()
        wall = time.perf_counter() - t0
        (counts,) = written
        if not gen.get("dit_block") or set(gen) != {"dit_block"}:
            raise AssertionError(f"phase15 inference: launches {gen}")
        if not np.isfinite(counts).all() or counts.shape[1] != len(dentate["genes"]):
            raise AssertionError(f"phase15 inference: counts {counts.shape}")
        if set(seen["vae"]) != set(tuned) or any(
                not torch.equal(seen["vae"][k].cpu(), tuned[k]) for k in tuned):
            raise AssertionError("phase15 inference: generation did not decode with the "
                                 "finetuned VAE")
        log(f"phase15 (d) inference generation (dopri5, generation.yaml) from that checkpoint: "
            f"{counts.shape[0]} cells in {wall:.2f} s ({smi}), launches {gen}; decoded with the "
            f"checkpoint's finetuned VAE, weight for weight")
    finally:
        dm_module.H5ADFile, output_module.write_h5ad = real_h5ad, real_writer
        LDMTask.generate_from_noise = real_gen
        shutil.rmtree(tmp, ignore_errors=True)

    # -- (e) the lean loss against the dense loss
    def lean_arm(name, make_task, batches, expect, bf16: bool):
        """One step's loss and gradients of both tasks on batches[0], the
        lean one twice, then the steps in turns. The gradients of the f32
        VAE are held by `held_bf16` (the tail kernels round to bf16); those
        of the bf16 VAE by `CENSUS_BF16_BOUNDS`' two bf16 evaluations of one
        function (a last-bit change of d(mu) moves bf16 roundings of every
        cotangent upstream)."""
        lean, dense = make_task(True), make_task(False)
        reset()
        runs = [vae_loss_and_grads(t, batches[0]) for t in (lean, lean, dense)]
        read()
        (l1, g1), (l2, g2), (ld, gd) = runs
        if not abs(l1 - ld) <= 1e-6 * abs(ld):
            raise AssertionError(f"phase15 lean {name}: loss {l1} vs dense {ld}")
        if l1 != l2 or any(not torch.equal(g1[k], g2[k]) for k in g1):
            raise AssertionError(f"phase15 lean {name}: two runs differ")
        if bf16:
            (_, (gap, worst_name)), = census_step_gaps(l1, g1, {"dense": (ld, gd)}).values()
            if gap > CENSUS_BF16_BOUNDS["bf16 plain"][1]:
                raise AssertionError(f"phase15 lean {name}: gradient {worst_name} {gap:.3e} of "
                                     "its max from the dense loss's")
            held = (f"{len(gd)} gradients by CENSUS_BF16_BOUNDS' bf16 bound "
                    f"({CENSUS_BF16_BOUNDS['bf16 plain'][1]:g}), the largest gap {gap:.2e} of its "
                    f"max ({worst_name})")
        else:
            worst = {}
            for k, want in gd.items():
                if k != "decoder_head.params.bias":  # softmax-invariant: its gradient is noise
                    worst[k] = held_bf16(f"phase15 lean {name} {k}", g1[k], want)
            top = max(worst.items(), key=lambda kv: kv[1][1])
            held = (f"{len(worst)} gradients by held_bf16, the largest gap {top[1][1]:.2e} of its "
                    f"max ({top[0]})")
        states = {arm: t.init_state(torch.Generator(device="cuda").manual_seed(seed))
                  for arm, t in (("lean", lean), ("dense", dense))}
        for arm, t in (("lean", lean), ("dense", dense)):  # warm-up
            states[arm], _ = t.train_step(states[arm], batches[1])
        ms, peak = {"lean": [], "dense": []}, {}
        for arm in ("lean", "dense", "dense", "lean"):
            t = lean if arm == "lean" else dense
            torch.cuda.reset_peak_memory_stats()
            reset()
            t0 = time.perf_counter()
            for i in range(P15_LEAN_TURN):
                states[arm], mets = t.train_step(states[arm], batches[1 + i % (len(batches) - 1)])
            got = read()
            ms[arm].append(round((time.perf_counter() - t0) / P15_LEAN_TURN * 1e3, 2))
            peak[arm] = max(peak.get(arm, 0.0), torch.cuda.max_memory_allocated() / 2**30)
            if got != {k: P15_LEAN_TURN for k in expect} or not torch.isfinite(mets["train_loss"]):
                raise AssertionError(f"phase15 lean {name} {arm}: launches {got}")
        log(f"phase15 (e) lean loss at {name}: one step against the dense loss, loss {l1:.4f} vs "
            f"{ld:.4f} ({abs(l1 - ld) / abs(ld):.2e} relative), {held}; the lean "
            f"gradients repeat their bits; ms/step in turns ({smi}): lean {ms['lean']}, dense "
            f"{ms['dense']}; peak GiB lean {peak['lean']:.3f}, dense {peak['dense']:.3f}")

    dentate_vae = init_reference_(build_transformer_vae(n_genes=N_GENES, device="cuda"),
                                  torch.Generator(device="cuda").manual_seed(seed + 153))
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in lean_batch(rng, batch).items()}
               for _ in range(3)]
    lean_arm(f"dentate (B={batch}, f32, the tail kernels)",
             lambda on: VAETask(dentate_vae, num_training_steps=10_000, lean_loss=on), batches,
             ("decoder_tail_fwd", "decoder_tail_bwd"), bf16=False)
    del dentate_vae, batches
    gc.collect()
    torch.cuda.empty_cache()
    census = init_reference_(build_transformer_vae(**CENSUS, dtype=torch.bfloat16, remat=True,
                                                   device="cuda"),
                             torch.Generator(device="cuda").manual_seed(seed + 154))
    G, S = CENSUS["n_genes"], CENSUS_WINDOW
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in
                lean_batch(rng, CENSUS_BATCH, G, S, (S // 2, S)).items()} for _ in range(3)]
    lean_arm(f"census (B={CENSUS_BATCH}, bf16 and remat as shipped, the fused gate)",
             lambda on: VAETask(census, num_training_steps=10_000, learning_rate=3e-4,
                                betas=(0.9, 0.95), algebraic_fused_gate=True, lean_loss=on),
             batches, ("swiglu_vec_fwd", "swiglu_vec_bwd"), bf16=True)
    del census, batches
    gc.collect()
    torch.cuda.empty_cache()

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("yaml", "h5py", "pandas", "jax"))
    if loaded:
        raise AssertionError(f"phase15: {loaded} loaded")
    log(f"phase15 took {time.perf_counter() - phase_t0:.1f} s; launches "
        f"{ {k: v for k, v in total.items() if v} }")
    return total


P16_STEPS = 3  # DP steps a turn in arm (a), after a warm-up pair
P16_TURNS = 3  # turns of the DP step against the step without a process group
P16_CLI_STEPS = 2  # cli.train steps at world 1 with training.fsdp=true
P16_TIMEOUT = 300  # seconds a child may take
P16_NEAR = 1e-4  # arm (b)'s DP losses and gradients, as a share of each tensor's largest
P16_GEN_STEPS = 50  # euler steps of the gene-SP census generation


def p16_result(**out) -> None:
    """A child's result, as the last line of its output."""
    print("P16 " + json.dumps(out), flush=True)


def p16_children(arm: str, world: int, seed: int, batch: int) -> list:
    """Run `world` children of this script for phase 16's `arm`, each under
    torchrun's environment; returns each rank's result. A failing or late
    child stops them all."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        # the gloo ranks share the one card (both bind LOCAL_RANK 0); NCCL's each its own
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r) if arm == "nccl2" else "0",
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--phase16", arm, "--seed", str(seed),
             "--batch", str(batch)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=P16_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = out.rstrip().splitlines()
        found = [line[4:] for line in lines if line.startswith("P16 ")]
        for line in lines:
            if not line.startswith("P16 "):
                log(f"phase16 [{arm} rank {r}] {line}")
        if p.returncode != 0 or len(found) != 1:
            raise AssertionError(f"phase16 {arm} rank {r}: exit {p.returncode}, "
                                 f"{len(found)} results")
        results.append(json.loads(found[0]))
    return results


def p16_twins(build, n: int) -> list:
    """n modules from `build()`, each holding the first one's weights."""
    mods = [build() for _ in range(n)]
    for m in mods[1:]:
        m.load_state_dict(mods[0].state_dict())
    return mods


def p16_nccl_world1(seed: int, batch: int) -> None:
    """Arm (a), one rank over NCCL: the dentate VAE step (rows 3-4) and the
    dentate LDM step (rows 1-2) through the data-parallel all-reduce against
    the same steps without a process group, bit for bit, timed in turns;
    then `cli.train` with `training.fsdp=true` at world 1."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.ops import fused_decoder as fd
    from scldm_torch.ops import fused_dit
    from scldm_torch.parallel import make_mesh
    from scldm_torch.training.ldm_task import LDMTask
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.transport import create_transport
    from scldm_torch.utils.weights import init_reference_

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="env://", world_size=1, rank=0)
    mesh = make_mesh(n_data=1)
    rng = np.random.default_rng(seed)
    out = {}

    def same_bits(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                     b.state_dict().values()))

    def turns(steps: dict, counters) -> dict:
        """Each arm's ms a step over P16_TURNS turns of P16_STEPS steps, and
        the mesh arm's launches (the counters reset before each of its turns)."""
        ms, launches = {k: [] for k in steps}, [0] * len(counters)
        for _ in range(P16_TURNS):
            for k, step in steps.items():
                for c in counters:
                    c.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(P16_STEPS):
                    step()
                torch.cuda.synchronize()
                ms[k].append(round((time.perf_counter() - t0) / P16_STEPS * 1e3, 3))
                if k == "mesh":
                    launches = [n + c.count for n, c in zip(launches, counters)]
        return {"ms": ms, "launches": launches}

    # -- the dentate VAE step through rows 3-4
    def vae():
        return init_reference_(build_transformer_vae(n_genes=N_GENES, device="cuda"),
                               torch.Generator(device="cuda").manual_seed(seed))

    vae_mesh, vae_one = p16_twins(vae, 2)
    tasks = {"mesh": VAETask(vae_mesh, num_training_steps=10_000, mesh=mesh),
             "one": VAETask(vae_one, num_training_steps=10_000)}
    states = {k: t.init_state(torch.Generator(device="cuda").manual_seed(seed))
              for k, t in tasks.items()}
    b = {k: torch.from_numpy(v).to("cuda") for k, v in lean_batch(rng, batch).items()}
    mets = {k: {n: v.item() for n, v in tasks[k].train_step(states[k], b)[1].items()}
            for k in tasks}
    out["vae_first_step_metrics_equal"] = mets["mesh"] == mets["one"]
    out["vae_first_step_bits"] = same_bits(vae_mesh, vae_one)
    run = turns({k: (lambda k=k: tasks[k].train_step(states[k], b)) for k in tasks},
                (fd.DECODER_TAIL_FWD_LAUNCHES, fd.DECODER_TAIL_BWD_LAUNCHES))
    out["vae"] = {**run, "bits": same_bits(vae_mesh, vae_one), "loss": mets["mesh"]["train_loss"]}
    del tasks, states, vae_mesh, vae_one

    # -- the dentate LDM step through rows 1-2, the draws from one seed each
    vae_f, _ = build_models(seed)
    dit_mesh, dit_one = p16_twins(lambda: build_models(seed)[1], 2)
    tasks = {"mesh": LDMTask(vae_f, dit_mesh, create_transport(), mesh=mesh),
             "one": LDMTask(vae_f, dit_one, create_transport())}
    states = {k: t.init_state(torch.Generator(device="cuda").manual_seed(seed))
              for k, t in tasks.items()}
    lb = ldm_batches(rng, batch, 1)[0]
    for k in tasks:
        tasks[k].train_step(states[k], lb)
    out["ldm_first_step_bits"] = same_bits(dit_mesh, dit_one)
    run = turns({k: (lambda k=k: tasks[k].train_step(states[k], lb)) for k in tasks},
                (fused_dit.DIT_BLOCK_LAUNCHES, fused_dit.DIT_BLOCK_BWD_LAUNCHES))
    out["ldm"] = {**run, "bits": same_bits(dit_mesh, dit_one)
                  and all(torch.equal(states["mesh"].ema.params[n], states["one"].ema.params[n])
                          for n in states["one"].ema.params)}
    del tasks, states, dit_mesh, dit_one, vae_f
    torch.cuda.empty_cache()

    # -- cli.train with training.fsdp=true at world 1: no mesh, nothing sharded (JAX's meaning)
    from scldm_torch.cli import train as cli_train
    from scldm_torch.data import datamodule as dm_module

    dentate = json.loads((ROOT / "metadata/dentategyrus_train.json").read_text())
    tmp = Path(tempfile.mkdtemp(prefix="scldm_phase16_"))
    shards = {str(tmp / "train.h5ad"): cli_shard(rng, VARIANT_CELLS, dentate["genes"],
                                                 dentate["labels"])}
    real_h5ad = dm_module.H5ADFile
    dm_module.H5ADFile = lambda path: shards[str(path)]
    try:
        t0 = time.perf_counter()
        rc = cli_train.main(["--config", str(ROOT / "configs/vae_training.yaml"),
                             f"datamodule.datamodule.train_adata_path={tmp / 'train.h5ad'}",
                             f"paths.output_path={tmp / 'out'}", "epochs=1",
                             f"training.max_steps={P16_CLI_STEPS}", "training.fsdp=true",
                             "training.steps_per_dispatch=1", "training.log_every_steps=1",
                             *P15_CLI_EXTRA])
        wall = time.perf_counter() - t0
    finally:
        dm_module.H5ADFile = real_h5ad
    ckpt = tmp / "out" / "checkpoints" / "vae_dentate_gyrus"
    steps = sorted(int(p.name) for p in ckpt.iterdir() if p.name.isdigit())
    out["cli_fsdp_world1"] = {"rc": rc, "steps": steps, "wall_s": round(wall, 3)}
    shutil.rmtree(tmp, ignore_errors=True)
    dist.destroy_process_group()
    p16_result(**out)


def p16_probe(device) -> dict:
    """Which collectives the installed gloo takes on CUDA tensors: each op
    once on a small tensor; an op gloo refuses raises on every rank alike."""
    import torch
    import torch.distributed as dist

    x = torch.arange(8, dtype=torch.float32, device=device) + dist.get_rank()
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_reduce_max": lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            x.new_empty(8 * dist.get_world_size()), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            x.new_empty(8 // dist.get_world_size()), x),
    }
    out = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 (the probe's answer)
            out[name] = f"{type(e).__name__}: {str(e)[:160]}"
    return out


def p16_rel_gap(got: dict, want: dict) -> tuple:
    """The largest gap of any gradient over its reference's largest
    magnitude, and its name; the NB head's bias left out (softmax-invariant:
    its true gradient is 0, every path's noise)."""
    worst = (0.0, "")
    for name, w in want.items():
        if name == "decoder_head.params.bias" or w is None:
            continue
        worst = max(worst, ((got[name] - w).abs().max().item()
                            / (w.abs().max().item() + 1e-30), name))
    return worst


def p16_two_ranks(seed: int, batch: int, backend: str) -> None:
    """Arm (b), two ranks sharing the card over gloo (or, where the machine
    has two cards, arm (c): two ranks over NCCL, a card each): the probe,
    then data parallelism on the dentate VAE (rows 3-4) and LDM (rows 1-2)
    at B / 2 a rank against one process at B, with the VAE step's ms in
    turns, FSDP on the census VAE as shipped through the fused gate (rows
    16-17) at 8 cells a rank against 16 in one process with each rank's
    parameter, AdamW and peak bytes, and
    gene-SP census generation at n_model=2 against one process. An arm
    whose collective the backend does not take is left out."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.ops import fused_decoder as fd
    from scldm_torch.ops import fused_dit
    from scldm_torch.ops.transforms import canonical_gene_ids
    from scldm_torch.parallel import make_mesh, rank, shard_batch
    from scldm_torch.training.ldm_task import LDMTask
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.transport import create_transport
    from scldm_torch.utils.weights import init_reference_

    # the launch environment's group over `backend` (gloo may share one card; the
    # program's own start, `maybe_initialize_distributed`, takes NCCL on the card)
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(backend, init_method="env://")
    dev = torch.device("cuda", torch.cuda.current_device())
    probe = p16_probe(dev)
    out = {"probe": probe, "rank": rank(), "left_out": []}
    took = {k for k, v in probe.items() if v == "ok"}
    dp_ok = {"all_reduce", "broadcast"} <= took
    mesh = make_mesh(n_data=2) if dp_ok else None
    rng = np.random.default_rng(seed)
    g32 = torch.Generator(device="cuda")

    # -- DP on the dentate VAE: B / 2 a rank against B in one process. The gradients
    #    before the clip: each rank's loss and backward, then the step's reduction
    #    (`Layout.sync`, the averaging all-reduce), against one process's at B and at
    #    each half of B (the same shapes as the ranks')
    if dp_ok:
        def vae():
            return init_reference_(build_transformer_vae(n_genes=N_GENES, device="cuda"),
                                   torch.Generator(device="cuda").manual_seed(seed))

        def synced(task, state, loss):
            loss.backward()
            task.layout.sync(state, {})
            return {n: p.grad.clone() for n, p in state.module.named_parameters()
                    if p.grad is not None}

        vae_dp, vae_one = p16_twins(vae, 2)
        b = {k: torch.from_numpy(v).to("cuda") for k, v in lean_batch(rng, batch).items()}
        one = VAETask(vae_one, num_training_steps=10_000)
        l_one, g_one = vae_loss_and_grads(one, b)
        halves = [vae_loss_and_grads(one, {k: v[i * batch // 2:(i + 1) * batch // 2]
                                           for k, v in b.items()})[1] for i in range(2)]
        dp = VAETask(vae_dp, num_training_steps=10_000, mesh=mesh)
        state = dp.init_state(g32.manual_seed(seed))
        fd.DECODER_TAIL_FWD_LAUNCHES.reset()
        fd.DECODER_TAIL_BWD_LAUNCHES.reset()
        loss, _ = dp.loss(shard_batch(b, mesh))
        g_dp = synced(dp, state, loss)
        l_dp = dp.layout.sync(state, {"loss": loss.detach()})["loss"].item()
        launches = [fd.DECODER_TAIL_FWD_LAUNCHES.count, fd.DECODER_TAIL_BWD_LAUNCHES.count]
        # rows 3-4 round their operands to bf16: a batch of 64 moves the f32 sums under
        # them (cuBLAS's products at 64 rows against 128) and flips roundings of operands
        # that a cell's every gene shares, so against B in one process each gradient is
        # held to `held_bf16`'s 1e-2 of its largest (the share beyond 1e-4 is printed, not
        # bounded: the flips cascade, as the tail's own plain version shows in another
        # summation order); against the halves' mean, the same shapes, to 1e-6
        skip = "decoder_head.params.bias"  # softmax-invariant: its true gradient is 0
        gap_b = max((bf16_distance(g_dp[n], w)[0] / (w.abs().max().item() + 1e-30), n)
                    for n, w in g_one.items() if n != skip)
        beyond = max(bf16_distance(g_dp[n], w)[2] for n, w in g_one.items() if n != skip)
        gap_h = max(((g_dp[n] - (halves[0][n] + halves[1][n]) / 2).abs().max().item()
                     / (w.abs().max().item() + 1e-30), n) for n, w in g_one.items() if n != skip)
        if gap_b[0] > 1e-2 or gap_h[0] > 1e-6:
            raise AssertionError(f"phase16 DP VAE: gradient {gap_b[1]} {gap_b[0]:.3e} of its "
                                 f"largest from B={batch}; {gap_h[1]} {gap_h[0]:.3e} from the "
                                 "halves' mean")
        # the steps' ms in turns: the DP step at B / 2 a rank, one process at B
        one_state = one.init_state(g32.manual_seed(seed))
        ms = {"dp": [], "one": []}
        for _ in range(P16_TURNS):
            for arm, step in (("dp", lambda: dp.train_step(state, shard_batch(b, mesh))),
                              ("one", lambda: one.train_step(one_state, b))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(P16_STEPS):
                    step()
                torch.cuda.synchronize()
                ms[arm].append(round((time.perf_counter() - t0) / P16_STEPS * 1e3, 3))
        out["dp_vae"] = {"loss": [l_dp, l_one], "grad_gap": list(gap_b), "grad_beyond": beyond,
                         "halves_gap": list(gap_h), "launches": launches, "ms": ms}
        del vae_dp, vae_one, one, dp, state, one_state, g_one, g_dp, halves

        # -- DP on the dentate LDM: the global draws, each rank its rows; rows 1-2 in f32
        vae_f, _ = build_models(seed)
        dit_dp, dit_one = p16_twins(lambda: build_models(seed)[1], 2)
        lb = ldm_batches(rng, batch, 1)[0]
        g = torch.Generator(device="cuda").manual_seed(seed + 5)
        noise = {"t": torch.rand(batch, generator=g, device="cuda"),
                 "x0": torch.randn(batch, dit_one.seq_len, dit_one.n_embed_input, generator=g,
                                   device="cuda"),
                 "drop_mask": torch.rand(batch, generator=g, device="cuda")
                 < dit_one.cfg_dropout_prob}
        one = LDMTask(vae_f, dit_one, create_transport())
        l_one, g_one = ldm_loss_and_grads(one, lb, g, noise)
        dp = LDMTask(vae_f, dit_dp, create_transport(), mesh=mesh)
        state = dp.init_state(g32.manual_seed(seed))
        fused_dit.DIT_BLOCK_LAUNCHES.reset()
        fused_dit.DIT_BLOCK_BWD_LAUNCHES.reset()
        loss = dp.loss(shard_batch(lb, mesh), g, shard_batch(noise, mesh))
        g_dp = synced(dp, state, loss)
        # the loss is this rank's mean: the global one is the ranks' mean
        l_dp = dp.layout.sync(state, {"loss": loss.detach()})["loss"].item()
        gap = max(((g_dp[n] - w).abs().max().item() / (w.abs().max().item() + 1e-30), n)
                  for n, w in g_one.items())
        out["dp_ldm"] = {"loss": [l_dp, l_one], "grad_gap": list(gap),
                         "launches": [fused_dit.DIT_BLOCK_LAUNCHES.count,
                                      fused_dit.DIT_BLOCK_BWD_LAUNCHES.count]}
        del vae_f, dit_dp, dit_one, one, dp, state
        torch.cuda.empty_cache()
    else:
        out["left_out"] += ["dp_vae", "dp_ldm"]

    # -- FSDP on the census VAE as shipped (bf16, remat) through the fused gate (rows
    #    16-17 in bf16, on the gathered weights): 8 cells a rank against 16
    if dp_ok and {"all_gather_into_tensor", "reduce_scatter_tensor"} <= took:
        from scldm_torch.ops import fused_swiglu as fs

        def census():
            return init_reference_(build_transformer_vae(**CENSUS, dtype=torch.bfloat16,
                                                         remat=True, device="cuda"),
                                   torch.Generator(device="cuda").manual_seed(seed))

        cb = {k: torch.from_numpy(v).to("cuda") for k, v in lean_batch(
            rng, CENSUS_BATCH, CENSUS["n_genes"], CENSUS_WINDOW,
            (CENSUS_WINDOW // 2, CENSUS_WINDOW)).items()}
        opt = dict(learning_rate=3e-4, betas=(0.9, 0.95),  # vae_census.yaml's
                   algebraic_fused_gate=True)

        def bytes_of(ts):
            return sum(t.numel() * t.element_size() for t in ts)

        arms, slices = {}, {}
        for arm in ("fsdp", "one"):
            m = census()
            task = (VAETask(m, mesh=mesh, fsdp=True, **opt) if arm == "fsdp"
                    else VAETask(m, **opt))
            state = task.init_state(g32.manual_seed(seed))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fs.SWIGLU_VEC_FWD_LAUNCHES.reset()
            fs.SWIGLU_VEC_BWD_LAUNCHES.reset()
            _, mets = task.train_step(state, shard_batch(cb, mesh) if arm == "fsdp" else cb)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            launches = [fs.SWIGLU_VEC_FWD_LAUNCHES.count, fs.SWIGLU_VEC_BWD_LAUNCHES.count]
            params = [p for p in m.parameters()] + (
                [s for _, _, s, _ in state.shards.entries] if state.shards else [])
            moments = [v for st in state.optimizer.state.values() for v in st.values()
                       if torch.is_tensor(v) and v.ndim]
            grads = {}
            for name, p in m.named_parameters():
                q = state.shards.shard_of(p) if state.shards else p
                if q.grad is None:
                    continue
                flat = q.grad.reshape(-1)
                if arm == "one" and name in slices:  # the reference's part of this rank's slice
                    k, r = slices[name]
                    flat = flat[r * k:(r + 1) * k]
                grads[name] = flat.clone()
            if arm == "fsdp":
                slices = {n: (s.numel(), state.shards.rank) for n, _, s, _ in state.shards.entries}
            arms[arm] = {"loss": mets["train_loss"].item(), "peak": peak,
                         "param_bytes": bytes_of(params), "adamw_bytes": bytes_of(moments),
                         "grads": grads, "launches": launches,
                         "gates": [task.fused_decoder, task.algebraic_fused_gate]}
            del m, task, state, mets
            torch.cuda.empty_cache()
        worst = p16_rel_gap(arms["fsdp"].pop("grads"), arms["one"].pop("grads"))
        out["fsdp_census"] = {**arms, "grad_gap": worst}
    else:
        out["left_out"].append("fsdp_census")

    # -- gene-SP census generation at n_model=2, batch 16, the draws injected
    if {"all_reduce", "all_reduce_max", "broadcast", "all_gather_into_tensor"} <= took:
        mesh12 = make_mesh(n_data=1, n_model=2)
        vae_c, dit_c = build_census_ldm_models(seed, torch.bfloat16)
        B, G = CENSUS_LDM_BATCH, CENSUS["n_genes"]
        g = torch.Generator(device="cuda").manual_seed(seed + 7)
        z0 = torch.randn(B, dit_c.seq_len, dit_c.n_embed_input, generator=g, device="cuda")
        log_sf = torch.full((B,), 8.6, device="cuda")
        cond = {"clusters": torch.randint(0, N_CLUSTERS, (B,), generator=g, device="cuda")}
        genes = canonical_gene_ids(G, device="cuda")
        kw = dict(guidance_weight=GUIDANCE, sampling_method="euler", num_steps=P16_GEN_STEPS)
        res = {}
        for arm in ("gene_sp", "one"):
            task = (LDMTask(vae_c, dit_c, create_transport(), mesh=mesh12, gene_sp=True)
                    if arm == "gene_sp" else LDMTask(vae_c, dit_c, create_transport()))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            z, dec, _ = task.generate_from_noise(z0, log_sf, genes, cond, fused_blocks=False, **kw)
            torch.cuda.synchronize()
            res[arm] = {"z": z, "mu": dec["mu"], "s": time.perf_counter() - t0,
                        "peak": torch.cuda.max_memory_allocated(), "sp": task._sp}
            del task, dec
            torch.cuda.empty_cache()
        sp = res["gene_sp"].pop("sp")
        err, rel, beyond, near = held_bf16("phase16 gene-SP mu", res["gene_sp"]["mu"],
                                           res["one"]["mu"])
        out["gene_sp_generation"] = {
            "z_gap": (res["gene_sp"]["z"] - res["one"]["z"]).abs().max().item(),
            "mu_bf16": [err, rel, beyond, near], "genes": [sp.lo, sp.hi],
            "peak": [res["gene_sp"]["peak"], res["one"]["peak"]],
            "s": [round(res["gene_sp"]["s"], 3), round(res["one"]["s"], 3)]}
        del res, vae_c, dit_c
    else:
        out["left_out"].append("gene_sp_generation")
    dist.destroy_process_group()
    p16_result(**out)


def p16_check_ranks(tag: str, ranks: list, batch: int, smi: str, launches: dict) -> None:
    """Hold and print a two-rank arm's results (`p16_two_ranks`), adding its
    DP steps' and its FSDP step's launches to `launches`."""
    probe = ranks[0]["probe"]
    log(f"phase16 {tag} collectives on CUDA tensors: {probe}; left out: "
        f"{ranks[0]['left_out'] or 'none'}")
    for r, res in enumerate(ranks):
        for part, names in (("dp_vae", ("decoder_tail_fwd", "decoder_tail_bwd")),
                            ("dp_ldm", ("dit_block", "dit_block_bwd"))):
            if part not in res:
                continue
            (lg, lo), (gap, name) = res[part]["loss"], res[part]["grad_gap"]
            # the LDM's rows 1-2 compute in f32: each gradient within P16_NEAR of its
            # largest; the VAE's bf16 tail was held on the rank (see there)
            if abs(lg - lo) > P16_NEAR * abs(lo) or (part == "dp_ldm" and gap > P16_NEAR):
                raise AssertionError(f"phase16 {tag} {part} rank {r}: loss {lg} vs {lo}, gradient "
                                     f"{name} {gap:.3e} of its largest")
            beyond = ""
            if part == "dp_vae":
                hg, hn = res[part]["halves_gap"]
                beyond = (f" ({res[part]['grad_beyond']:.1e} of a tensor's entries beyond 1e-4 "
                          f"of it at most); from the mean of one process's gradients at each "
                          f"half (B={batch // 2}) {hg:.3e} ({hn})")
            if min(res[part]["launches"]) <= 0:
                raise AssertionError(f"phase16 {tag} {part} rank {r}: launches "
                                     f"{res[part]['launches']}")
            for n, k in zip(names, res[part]["launches"]):
                launches[n] += k
            log(f"phase16 {tag} {part} rank {r}: B={batch // 2} a rank vs B={batch} in one "
                f"process: loss {lg:.6f} vs {lo:.6f}, largest gradient gap {gap:.3e} of its max "
                f"({name}){beyond}; launches {res[part]['launches']}")
        if "fsdp_census" in res:
            f, o = res["fsdp_census"]["fsdp"], res["fsdp_census"]["one"]
            (gap, name) = res["fsdp_census"]["grad_gap"]
            loss_near, grad_near = CENSUS_BF16_BOUNDS["bf16 plain"]
            if abs(f["loss"] - o["loss"]) > loss_near * abs(o["loss"]) or gap > grad_near:
                raise AssertionError(f"phase16 {tag} FSDP census rank {r}: loss {f['loss']} vs "
                                     f"{o['loss']}, gradient {name} {gap:.3e} of its largest")
            # the gates stay as on one card under FSDP: the fused gate's rows 16-17 on
            # the gathered weights, once each way a step
            if f["gates"] != o["gates"] or f["launches"] != [1, 1]:
                raise AssertionError(f"phase16 {tag} FSDP census rank {r}: gates {f['gates']} "
                                     f"vs {o['gates']}, launches {f['launches']}")
            for n, k in zip(("swiglu_vec_fwd", "swiglu_vec_bwd"), f["launches"]):
                launches[n] += k
            log(f"phase16 {tag} FSDP census VAE (bf16, remat, the fused gate) rank {r}: launches "
                f"{f['launches']}; 8 cells vs 16 in one "
                f"process: loss {f['loss']:.4f} vs {o['loss']:.4f}, gradient slices' largest gap "
                f"{gap:.3e} of its max ({name}); parameter bytes {f['param_bytes'] / 2**30:.3f} "
                f"vs {o['param_bytes'] / 2**30:.3f} GiB, AdamW {f['adamw_bytes'] / 2**30:.3f} vs "
                f"{o['adamw_bytes'] / 2**30:.3f} GiB, peak {f['peak'] / 2**30:.3f} vs "
                f"{o['peak'] / 2**30:.3f} GiB ({smi})")
        if "gene_sp_generation" in res:
            gsp = res["gene_sp_generation"]
            err, rel, beyond, near = gsp["mu_bf16"]
            log(f"phase16 {tag} gene-SP census generation rank {r} (genes {gsp['genes']}), batch "
                f"{CENSUS_LDM_BATCH}, euler-{P16_GEN_STEPS}: latents max gap {gsp['z_gap']:.3e}, "
                f"mu {err:.2e} ({rel:.1e} of max, {beyond:.1e} beyond {near:g}); peak "
                f"{gsp['peak'][0] / 2**30:.3f} vs {gsp['peak'][1] / 2**30:.3f} GiB one process; "
                f"{gsp['s'][0]} s vs {gsp['s'][1]} s ({smi})")
    if "dp_vae" in ranks[0]:
        ms = ranks[0]["dp_vae"]["ms"]
        log(f"phase16 {tag} dentate VAE ms a step in turns: DP at B={batch // 2} a rank "
            f"{ms['dp']} vs one process at B={batch} {ms['one']} ({smi})")


def phase16_parallel(seed: int, batch: int, smi: str) -> dict:
    """Phase 16, the parallel layouts on the one card (the kernels already
    built here, so that no child builds them): (a) one rank over NCCL, the
    DP steps against the steps without a process group, bit for bit; (b) two
    ranks sharing the card over gloo, DP, FSDP and gene-SP against one
    process; (c) on a machine with two cards or more, (b) over NCCL, a card
    a rank. Returns the DP steps' and the FSDP steps' launches (every arm,
    every rank) for the kernels line."""
    phase_t0 = time.perf_counter()
    (a,) = p16_children("nccl1", 1, seed, batch)
    for part in ("vae", "ldm"):
        r = a[part]
        if not (r["bits"] and a[f"{part}_first_step_bits"]):
            raise AssertionError(f"phase16 (a) {part}: the DP step's bits differ from the step "
                                 "without a process group")
        if min(r["launches"]) <= 0:
            raise AssertionError(f"phase16 (a) {part}: launches {r['launches']}")
        log(f"phase16 (a) NCCL at world 1, dentate {part.upper()} B={batch}: the DP step "
            f"(the all-reduce of a 1-rank mesh) repeats the step without a process group bit for "
            f"bit over {1 + P16_TURNS * P16_STEPS} steps; ms a step in turns, DP "
            f"{r['ms']['mesh']} vs none {r['ms']['one']}; launches {r['launches']} ({smi})")
    cli = a["cli_fsdp_world1"]
    if cli["rc"] != 0 or cli["steps"] != [P16_CLI_STEPS]:
        raise AssertionError(f"phase16 (a) cli.train training.fsdp=true: {cli}")
    log(f"phase16 (a) cli.train with training.fsdp=true at world 1: rc 0, checkpoint at step "
        f"{cli['steps']}, {cli['wall_s']} s")

    # the main path's launches: (a)'s DP steps, then (b)'s on each rank
    launches = dict(zip(("decoder_tail_fwd", "decoder_tail_bwd"), a["vae"]["launches"]))
    launches.update(zip(("dit_block", "dit_block_bwd"), a["ldm"]["launches"]))
    launches.update(swiglu_vec_fwd=0, swiglu_vec_bwd=0)  # (b)'s FSDP arm
    p16_check_ranks("(b) gloo, two ranks on one card",
                    p16_children("gloo2", 2, seed, batch), batch, smi, launches)
    import torch

    if torch.cuda.device_count() >= 2:  # a machine with two cards: NCCL across them
        p16_check_ranks("(c) NCCL, two cards", p16_children("nccl2", 2, seed, batch), batch,
                        smi, launches)
    log(f"phase16 took {time.perf_counter() - phase_t0:.1f} s ({smi})")
    return launches


def phase16_child(arm: str, seed: int, batch: int) -> int:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if arm == "nccl1":
        p16_nccl_world1(seed, batch)
    else:
        p16_two_ranks(seed, batch, {"gloo2": "gloo", "nccl2": "nccl"}[arm])
    return 0


P17_GEN_STEPS = 50  # euler steps of each census generation
P17_TIMEOUT = 420  # seconds a child may take
P17_PROBE_TIMEOUT = 60  # seconds the point-to-point probe's pair may take


def p17_result(**out) -> None:
    """A child's result, as the last line of its output."""
    print("P17 " + json.dumps(out), flush=True)


def p17_start(arm: str, world: int, seed: int) -> list:
    """Start `world` children of this script for phase 17's `arm` under
    torchrun's environment; the gloo ranks share the one card, NCCL's take a
    card each."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--phase17", arm, "--seed", str(seed)],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                 LOCAL_RANK=str(r) if arm == "nccl" else "0", LOCAL_WORLD_SIZE=str(world),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]


def p17_collect(arm: str, procs: list, timeout: float, strict: bool = True) -> list:
    """Each child's output and result (None for a child that failed, where
    not `strict`); a late child is killed, and with `strict` a failing or
    late child fails the phase."""
    outs, late = [], False
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                late = True
                p.kill()
                outs.append(p.communicate()[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = (out or "").rstrip().splitlines()
        found = [line[4:] for line in lines if line.startswith("P17 ")]
        for line in lines:
            if not line.startswith("P17 ") and (strict or p.returncode != 0):
                log(f"phase17 [{arm} rank {r}] {line}")
        ok = p.returncode == 0 and len(found) == 1 and not late
        if strict and not ok:
            raise AssertionError(f"phase17 {arm} rank {r}: exit {p.returncode}, "
                                 f"{len(found)} results{', late' if late else ''}")
        results.append(json.loads(found[0]) if ok else
                       {"exit": p.returncode, "late": late})
    return results


def p17_probe() -> None:
    """gloo's point-to-point send and recv of a CUDA tensor between the two
    ranks sharing the card; the answer is printed. The pipeline's hop is a
    broadcast on a two-rank group under every backend, which gloo takes on
    CUDA tensors."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    x = torch.arange(8.0, device="cuda") + 1
    try:
        if dist.get_rank() == 0:
            dist.send(x, 1)
            got = "sent"
        else:
            y = torch.zeros(8, device="cuda")
            dist.recv(y, 0)
            torch.cuda.synchronize()
            got = "received the values" if torch.equal(y, x) else "received other values"
    except Exception as e:  # noqa: BLE001 (the probe's answer)
        got = f"{type(e).__name__}: {str(e)[:160]}"
    p17_result(p2p=got)


def p17_grads(module, mt) -> dict:
    """Every gradient of `module` whole (Megatron slices gathered: every rank
    takes part), by name."""
    out = {}
    for name, p in module.named_parameters():
        if p.grad is None:
            continue
        g = p.grad
        if mt is not None and id(p) in mt.by_id:
            g = mt.whole(mt.by_id[id(p)], g)
        out[name] = g.detach().clone()
    return out


def p17_ranks(seed: int, backend: str) -> None:
    """Phase 17's arm on every rank (world W): the GPipe census DiT step over
    W stages and generation from the pipeline task, the Megatron census VAE
    as shipped at n_model = W, and one Megatron census LDM step and
    generation. Each is held against one process on rank 0, the Megatron
    gradients gathered whole."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.ops import fused_dit
    from scldm_torch.ops import fused_swiglu as fs
    from scldm_torch.ops.transforms import canonical_gene_ids
    from scldm_torch.parallel import make_mesh
    from scldm_torch.parallel.tensor_parallel import megatron_of
    from scldm_torch.training.ldm_task import LDMTask
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.transport import create_transport
    from scldm_torch.utils.weights import init_reference_, load_reference_state_dict

    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=P17_TIMEOUT))
    W, first = dist.get_world_size(), dist.get_rank() == 0
    mesh = make_mesh(n_data=1, n_model=W)
    rng = np.random.default_rng(seed)
    g32 = torch.Generator(device="cuda")
    B, G = CENSUS_LDM_BATCH, CENSUS["n_genes"]
    lb = census_ldm_batches(rng, 1)[0]
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    noise = {"t": torch.rand(B, generator=g, device="cuda"),
             "x0": torch.randn(B, CENSUS_DIT["seq_len"], CENSUS_DIT["n_embed_input"], generator=g,
                               device="cuda"),
             "drop_mask": torch.rand(B, generator=g, device="cuda") < CENSUS_DIT["cfg_dropout_prob"]}
    z0 = torch.randn(B, CENSUS_DIT["seq_len"], CENSUS_DIT["n_embed_input"], generator=g,
                     device="cuda")
    log_sf = torch.full((B,), 8.6, device="cuda")
    cond = {"clusters": torch.randint(0, N_CLUSTERS, (B,), generator=g, device="cuda")}
    genes = canonical_gene_ids(G, device="cuda")
    gen_kw = dict(guidance_weight=GUIDANCE, sampling_method="euler", num_steps=P17_GEN_STEPS)
    out = {"world": W}

    def bytes_of(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def measured(fn):
        """fn()'s result, seconds and peak bytes."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    def counters(*cs):
        for c in cs:
            c.reset()
        return cs

    def ldm_step(task, state):
        _, m = task.train_step(state, lb, noise)
        return m["train_loss"].item()

    def held_step(part, loss, grads, ref_loss, ref_grads, near):
        gap = p16_rel_gap(grads, ref_grads)
        if abs(loss - ref_loss) > near[0] * abs(ref_loss) or gap[0] > near[1]:
            raise AssertionError(f"phase17 {part}: loss {loss} vs {ref_loss}, gradient "
                                 f"{gap[1]} {gap[0]:.3e} of its largest")
        return {"loss": [loss, ref_loss], "grad_gap": list(gap)}

    # -- the GPipe census DiT over W stages: one step (rows 1-2 at T = 64, once a block
    #    a microbatch on each stage), then euler-50 generation from the pipeline task
    #    (row 1 on every rank, the decode gene-parallel), against one process
    vae_c, dit_c = build_census_ldm_models(seed, torch.bfloat16)
    task = LDMTask(vae_c, dit_c, create_transport(), mesh=mesh, pipeline_microbatches=P17_MICRO)
    state = task.init_state(g32.manual_seed(seed))
    fwd, bwd = counters(fused_dit.DIT_BLOCK_LAUNCHES, fused_dit.DIT_BLOCK_BWD_LAUNCHES)
    loss, step_s, step_peak = measured(lambda: ldm_step(task, state))
    step_launches = [fwd.count, bwd.count]
    grads = p17_grads(dit_c, None)
    fwd.reset()
    (z, dec, _), gen_s, gen_peak = measured(lambda: task.generate_from_noise(
        z0, log_sf, genes, cond, **gen_kw))
    pp = {"stage": task._hops.stage, "blocks": list(range(
        task._hops.stage * CENSUS_DIT["n_layer"] // W,
        (task._hops.stage + 1) * CENSUS_DIT["n_layer"] // W)),
        "step_launches": step_launches, "gen_launches": fwd.count, "s": [step_s, gen_s],
        "peak": [step_peak, gen_peak], "genes": [task._sp.lo, task._sp.hi]}
    if first:  # the one-process references: the same draws, the same weights
        one = LDMTask(vae_c, dit_c, create_transport())
        (z1, dec1, _), gen1_s, gen1_peak = measured(lambda: one.generate_from_noise(
            z0, log_sf, genes, cond, **gen_kw))
        ref_vae, ref_dit = build_census_ldm_models(seed, torch.bfloat16)
        ref = LDMTask(ref_vae, ref_dit, create_transport(), fused_training=True)
        ref_loss, ref_s, ref_peak = measured(lambda: ldm_step(ref, ref.init_state(
            g32.manual_seed(seed))))
        pp.update(held_step("pipeline step", loss, grads, ref_loss, p17_grads(ref_dit, None),
                            (P16_NEAR, P16_NEAR)))
        err, rel, beyond, near = held_bf16("phase17 pipeline generation mu", dec["mu"],
                                           dec1["mu"])
        pp.update(z_gap=(z - z1).abs().max().item(), mu_bf16=[err, rel, beyond, near],
                  one_s=[ref_s, gen1_s], one_peak=[ref_peak, gen1_peak])
        del one, ref, ref_vae, ref_dit, z1, dec1
    out["pipeline"] = pp
    del task, state, vae_c, dit_c, grads, z, dec
    torch.cuda.empty_cache()

    # -- Megatron: the census VAE as shipped (bf16, remat, the fused gate: rows 16-17 in
    #    bf16 on each rank's hidden slice, Hd = 1,408 / W), 16 cells on every rank
    cb = {k: torch.from_numpy(v).to("cuda") for k, v in lean_batch(
        rng, CENSUS_BATCH, G, CENSUS_WINDOW, (CENSUS_WINDOW // 2, CENSUS_WINDOW)).items()}
    opt = dict(learning_rate=3e-4, betas=(0.9, 0.95), algebraic_fused_gate=True)

    def census():
        return init_reference_(build_transformer_vae(**CENSUS, dtype=torch.bfloat16, remat=True,
                                                     device="cuda"),
                               torch.Generator(device="cuda").manual_seed(seed))

    def vae_step(task, state):
        return task.train_step(state, cb)[1]["train_loss"].item()

    def state_bytes(state):
        moments = [v for st in state.optimizer.state.values() for v in st.values()
                   if torch.is_tensor(v) and v.ndim]
        return bytes_of(list(state.module.parameters())), bytes_of(moments)

    vae = census()
    task = VAETask(vae, mesh=mesh, **opt)
    state = task.init_state(g32.manual_seed(seed))
    vf, vb = counters(fs.SWIGLU_VEC_FWD_LAUNCHES, fs.SWIGLU_VEC_BWD_LAUNCHES)
    loss, step_s, peak = measured(lambda: vae_step(task, state))
    mt_vae = {"launches": [vf.count, vb.count], "hidden": vae.decoder.decoder_cross_attention
              .mlp.w1.weight.shape[0], "gates": [task.megatron, task.fused_decoder,
                                                 task.algebraic_fused_gate],
              "bytes": state_bytes(state), "peak": peak, "s": step_s}
    grads = p17_grads(vae, megatron_of(vae))
    del task, state, vae
    torch.cuda.empty_cache()
    if first:
        vae = census()
        ref = VAETask(vae, **opt)
        ref_state = ref.init_state(g32.manual_seed(seed))
        ref_loss, ref_s, ref_peak = measured(lambda: vae_step(ref, ref_state))
        mt_vae.update(held_step("Megatron census VAE", loss, grads, ref_loss,
                                p17_grads(vae, None), CENSUS_BF16_BOUNDS["bf16 plain"]),
                      one_bytes=state_bytes(ref_state), one_peak=ref_peak, one_s=ref_s)
        del vae, ref, ref_state
    out["megatron_vae"] = mt_vae
    del grads
    torch.cuda.empty_cache()

    # -- Megatron: one census LDM step (the frozen encode through the Megatron VAE, the
    #    DiT on its modules) and euler-50 generation from its state, in f32: a Megatron
    #    rank sums its row-parallel products in another order than one process, so the
    #    f32 pair is held at P16_NEAR (a bf16 pair would differ by the flips it rounds)
    vae_c, dit_c = build_census_ldm_models(seed)
    task = LDMTask(vae_c, dit_c, create_transport(), mesh=mesh)
    state = task.init_state(g32.manual_seed(seed))
    loss, step_s, step_peak = measured(lambda: ldm_step(task, state))
    mt = megatron_of(dit_c)
    grads = p17_grads(dit_c, mt)
    (z, dec, _), gen_s, gen_peak = measured(lambda: task.generate_from_noise(
        z0, log_sf, genes, cond, fused_blocks=False, **gen_kw))
    stepped = mt.whole_state_dict(dit_c.state_dict())
    mt_ldm = {"s": [step_s, gen_s], "peak": [step_peak, gen_peak],
              "gates": [task.megatron, task.fused_training]}
    del task, state, vae_c, dit_c
    torch.cuda.empty_cache()
    if first:
        ref_vae, ref_dit = build_census_ldm_models(seed)
        ref = LDMTask(ref_vae, ref_dit, create_transport(), fused_training=False)
        ref_loss, ref_s, ref_peak = measured(lambda: ldm_step(ref, ref.init_state(
            g32.manual_seed(seed))))
        mt_ldm.update(held_step("Megatron census LDM", loss, grads, ref_loss,
                                p17_grads(ref_dit, None), (P16_NEAR, P16_NEAR)))
        load_reference_state_dict(ref_dit, stepped)  # generation from the same weights
        (z1, dec1, _), gen1_s, gen1_peak = measured(lambda: ref.generate_from_noise(
            z0, log_sf, genes, cond, fused_blocks=False, **gen_kw))
        gaps = {k: (a - b).abs().max().item() / (b.abs().max().item() + 1e-30)
                for k, a, b in (("z", z, z1), ("mu", dec["mu"], dec1["mu"]))}
        if max(gaps.values()) > P16_NEAR:
            raise AssertionError(f"phase17 Megatron generation: gaps {gaps} of the largest")
        mt_ldm.update(gen_gaps=gaps, one_s=[ref_s, gen1_s], one_peak=[ref_peak, gen1_peak])
    out["megatron_ldm"] = mt_ldm
    dist.destroy_process_group()
    p17_result(**out)


def p17_check(tag: str, ranks: list, smi: str, launches: dict) -> None:
    """Hold and print an arm's results (`p17_ranks`), adding its launches to
    `launches`."""
    W = ranks[0]["world"]
    per = P17_MICRO * CENSUS_DIT["n_layer"] // W
    for r, res in enumerate(ranks):
        pp, mv, ml = res["pipeline"], res["megatron_vae"], res["megatron_ldm"]
        if pp["step_launches"] != [per, per] or pp["gen_launches"] <= 0:
            raise AssertionError(f"phase17 {tag} rank {r}: pipeline launches "
                                 f"{pp['step_launches']} (want {per} each way), generation "
                                 f"{pp['gen_launches']}")
        if mv["launches"] != [1, 1] or mv["gates"] != [True, False, True]:
            raise AssertionError(f"phase17 {tag} rank {r}: Megatron VAE launches "
                                 f"{mv['launches']}, gates {mv['gates']}")
        if ml["gates"] != [True, False]:
            raise AssertionError(f"phase17 {tag} rank {r}: Megatron LDM gates {ml['gates']}")
        launches["dit_block"] += pp["step_launches"][0] + pp["gen_launches"]
        launches["dit_block_bwd"] += pp["step_launches"][1]
        launches["swiglu_vec_fwd"] += mv["launches"][0]
        launches["swiglu_vec_bwd"] += mv["launches"][1]
        log(f"phase17 {tag} pipeline rank {r} (stage {pp['stage']}, blocks {pp['blocks']}, genes "
            f"{pp['genes']}): step rows 1-2 launches {pp['step_launches']} ({P17_MICRO} "
            f"microbatches x {CENSUS_DIT['n_layer'] // W} blocks), {pp['s'][0]:.3f} s, peak "
            f"{pp['peak'][0] / 2**30:.3f} GiB; euler-{P17_GEN_STEPS} generation row-1 launches "
            f"{pp['gen_launches']}, {pp['s'][1]:.3f} s, peak {pp['peak'][1] / 2**30:.3f} GiB "
            f"({smi})")
        log(f"phase17 {tag} Megatron census VAE rank {r}: rows 16-17 launches {mv['launches']} "
            f"at Hd = {mv['hidden']}; parameter bytes {mv['bytes'][0] / 2**30:.3f} GiB, AdamW "
            f"{mv['bytes'][1] / 2**30:.3f} GiB, peak {mv['peak'] / 2**30:.3f} GiB, step "
            f"{mv['s']:.3f} s ({smi})")
        log(f"phase17 {tag} Megatron census LDM rank {r}: step {ml['s'][0]:.3f} s, peak "
            f"{ml['peak'][0] / 2**30:.3f} GiB; euler-{P17_GEN_STEPS} generation {ml['s'][1]:.3f} s, "
            f"peak {ml['peak'][1] / 2**30:.3f} GiB ({smi})")
    pp, mv, ml = (ranks[0][k] for k in ("pipeline", "megatron_vae", "megatron_ldm"))
    (l_pp, l_one), (gap, name) = pp["loss"], pp["grad_gap"]
    err, rel, beyond, near = pp["mu_bf16"]
    log(f"phase17 {tag} pipeline step vs the one-process fused step (B={CENSUS_LDM_BATCH}): loss "
        f"{l_pp:.6f} vs {l_one:.6f}, largest gradient gap {gap:.3e} of its max ({name}); one "
        f"process {pp['one_s'][0]:.3f} s, peak {pp['one_peak'][0] / 2**30:.3f} GiB; generation "
        f"latents max gap {pp['z_gap']:.3e}, mu {err:.2e} ({rel:.1e} of max, {beyond:.1e} beyond "
        f"{near:g}); one process {pp['one_s'][1]:.3f} s, peak {pp['one_peak'][1] / 2**30:.3f} GiB "
        f"({smi})")
    (l_mt, l_one), (gap, name) = mv["loss"], mv["grad_gap"]
    log(f"phase17 {tag} Megatron census VAE vs one process ({CENSUS_BATCH} cells): loss "
        f"{l_mt:.4f} vs "
        f"{l_one:.4f}, gathered gradients' largest gap {gap:.3e} of its max ({name}); bytes a "
        f"rank: parameters {mv['bytes'][0] / 2**30:.3f} vs {mv['one_bytes'][0] / 2**30:.3f} GiB, "
        f"AdamW {mv['bytes'][1] / 2**30:.3f} vs {mv['one_bytes'][1] / 2**30:.3f} GiB, peak "
        f"{mv['peak'] / 2**30:.3f} vs {mv['one_peak'] / 2**30:.3f} GiB; step {mv['s']:.3f} vs "
        f"{mv['one_s']:.3f} s ({smi})")
    (l_mt, l_one), (gap, name) = ml["loss"], ml["grad_gap"]
    log(f"phase17 {tag} Megatron census LDM (f32) vs one process on the module DiT: loss "
        f"{l_mt:.6f} vs {l_one:.6f}, gathered gradients' largest gap {gap:.3e} of its max "
        f"({name}); generation latents {ml['gen_gaps']['z']:.3e} and mu {ml['gen_gaps']['mu']:.3e} "
        f"of the largest; one process step {ml['one_s'][0]:.3f} s, generation "
        f"{ml['one_s'][1]:.3f} s ({smi})")


def phase17_model_axis(seed: int, smi: str) -> dict:
    """Phase 17, the "model" axis's Megatron and GPipe layouts (the kernels
    already built here): (b) two ranks sharing the card over gloo, beside
    the probe of gloo's point-to-point hop on CUDA tensors; (c) on a machine
    with two cards or more, the same over NCCL, a card a rank (four ranks
    where there are four cards). Returns the launches of rows 1-2 at T = 64
    and rows 16-17 in bf16 (every arm, every rank) for the kernels line."""
    import torch

    phase_t0 = time.perf_counter()
    launches = dict(dit_block=0, dit_block_bwd=0, swiglu_vec_fwd=0, swiglu_vec_bwd=0)
    probe = p17_start("probe", 2, seed)
    arm = p17_start("gloo", 2, seed)
    p17_check("(b) gloo, two ranks on one card", p17_collect("gloo", arm, P17_TIMEOUT), smi,
              launches)
    answers = p17_collect("probe", probe, max(1.0, P17_PROBE_TIMEOUT - (time.perf_counter()
                                                                         - phase_t0)), strict=False)
    log(f"phase17 gloo point-to-point on CUDA tensors (the pipeline's hop is a broadcast on "
        f"a two-rank group under every backend): " + "; ".join(
            f"rank {r} {a.get('p2p', a)}" for r, a in enumerate(answers)))
    n = torch.cuda.device_count()
    if n >= 2:
        world = 4 if n >= 4 else 2
        p17_check(f"(c) NCCL, {world} cards", p17_collect("nccl", p17_start("nccl", world, seed),
                                                          P17_TIMEOUT), smi, launches)
    log(f"phase17 took {time.perf_counter() - phase_t0:.1f} s ({smi})")
    return launches


def phase17_child(arm: str, seed: int) -> int:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if arm == "probe":
        p17_probe()
    else:
        p17_ranks(seed, {"gloo": "gloo", "nccl": "nccl"}[arm])
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=128,
                   help="cells per CFG half, and cells per training step")
    p.add_argument("--phase16", default=None, help=argparse.SUPPRESS)  # a phase-16 child's arm
    p.add_argument("--phase17", default=None, help=argparse.SUPPRESS)  # a phase-17 child's arm
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    if not (ROOT / "scldm_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no scldm_torch sources beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if args.phase16:
        return phase16_child(args.phase16, args.seed, args.batch)
    if args.phase17:
        return phase17_child(args.phase17, args.seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # JAX's bf16 products sum in f32: no bf16 reduction of cuBLAS's split-K partials
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

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
    swiglu = phase1e_swiglu_vec(args.seed)
    flash_cross = phase1f_flash_cross(args.seed)
    trunk_timing = phase1g_fused_trunk(args.seed)
    gate_fwd, gate_bwd, gate_launches = phase1h_swiglu_gate(args.seed)
    flash = phase1i_flash_attention(args.seed)
    tail_grid = phase1b_decoder_tail_grid(args.seed)
    pool_grid = phase1d_encoder_pool_grid(args.seed)

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
    census_swiglu = phase6_census_training(args.seed)
    census_pool = phase6b_census_fused_pool(args.seed)

    # -- phase 7: census LDM training and generation ----------------------------
    census_ldm = phase7_census_ldm(args.seed)

    # -- phase 8: VAE training through the whole-trunk kernels ------------------
    trunk = phase8_trunk_training(args.seed, args.batch)

    # -- phase 9: the census pair at 1,024 latent tokens --------------------------
    long_latent, long_dit, long_dit_bwd = phase9_long_latent(args.seed)

    # -- phase 10: joint conditioning at parse1m / replogle -----------------------
    joint = phase10_joint(args.seed, args.batch, smi)

    # -- phase 11: the CLIs from the repo's YAML configs ---------------------------
    cli = phase11_cli(args.seed, smi)

    # -- phase 12: the scVI baseline and the generation evals -----------------------
    evals = phase12_scvi_and_evals(args.seed, smi)

    # -- phase 13: the default VAE step at two other widths -------------------------
    widths = phase13_widths(args.seed, smi)

    # -- phase 14: the model variants JAX's builders take ------------------------------
    variants = phase14_variants(args.seed, smi)

    # -- phase 15: the transports, joint finetuning and the lean loss -------------------
    p15 = phase15_transports_joint_lean(args.seed, args.batch, smi)

    # -- phase 16: data parallelism, FSDP and gene-SP on the one card -----------------
    p16 = phase16_parallel(args.seed, args.batch, smi)

    # -- phase 17: Megatron tensor parallelism and the GPipe DiT trunk ----------------
    p17 = phase17_model_axis(args.seed, smi)

    tail_src = "scldm_torch/kernels/csrc/decoder_tail.cu"
    pool_src = "scldm_torch/kernels/csrc/encoder_pool.cu"
    pool_launches = {"dense_fwd": parse["encoder_pool_fwd"] + cli["encoder_pool_fwd"],
                     "dense_bwd": parse["encoder_pool_bwd"] + cli["encoder_pool_bwd"],
                     "window_fwd": parse["window_pool_fwd"] + encode_launches
                     + joint["window_pool_fwd"] + variants["window_pool_fwd"],
                     "window_bwd": parse["window_pool_bwd"] + variants["window_pool_bwd"]}
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
         "launches": launches + ldm_fwd + ldm_gen + joint["dit_block"] + cli["dit_block"]
         + evals["dit_block"] + variants["dit_block"] + p15["dit_block"] + p16["dit_block"],
         **dit_block[(16, 384)],
         **dit_block_bound(3 * args.batch, backward=False), "library_ms": None},
        {"name": "dit_block_bwd", "route": "cuda", "source": dit_bwd_src,
         "replaces": "scldm_tpu/ops/fused_dit.py:205",
         "launches": ldm_bwd + joint["dit_block_bwd"] + cli["dit_block_bwd"]
         + evals["dit_block_bwd"] + variants["dit_block_bwd"] + p15["dit_block_bwd"]
         + p16["dit_block_bwd"],
         **dit_block_bwd[(16, 128)], **dit_block_bound(128, backward=True),
         "library_ms": None},
        {"name": "dit_block_t64", "route": "cuda", "source": dit_src,
         "replaces": "scldm_tpu/ops/fused_dit.py:155",
         "launches": census_ldm["dit_block"] + p17["dit_block"],
         **dit_block[(64, census_rows[0])],
         **dit_block_bound(census_rows[0], backward=False, T=64), "library_ms": None},
        {"name": "dit_block_bwd_t64", "route": "cuda", "source": dit_bwd_src,
         "replaces": "scldm_tpu/ops/fused_dit.py:205",
         "launches": census_ldm["dit_block_bwd"] + p17["dit_block_bwd"],
         **dit_block_bwd[(64, census_rows[1])],
         **dit_block_bound(census_rows[1], backward=True, T=64), "library_ms": None},
        {"name": "dit_block_t1024", "route": "cuda", "source": dit_src,
         "replaces": "scldm_tpu/ops/fused_dit.py:155", "launches": long_dit,
         **dit_block[(1024, 3 * LONG_GEN_BATCH)],
         **dit_block_bound(3 * LONG_GEN_BATCH, backward=False, T=1024), "library_ms": None},
        {"name": "dit_block_bwd_t1024", "route": "cuda", "source": dit_bwd_src,
         "replaces": "scldm_tpu/ops/fused_dit.py:205", "launches": long_dit_bwd,
         **dit_block_bwd[(1024, CENSUS_LDM_BATCH)],
         **dit_block_bound(CENSUS_LDM_BATCH, backward=True, T=1024), "library_ms": None},
        {"name": "decoder_tail_fwd", "route": "cuda", "source": tail_src,
         "replaces": "scldm_tpu/ops/fused_decoder.py:262",
         "launches": fwd_launches + parse["decoder_tail_fwd"] + cli["decoder_tail_fwd"]
         + variants["decoder_tail_fwd"] + p15["decoder_tail_fwd"] + p16["decoder_tail_fwd"],
         **tail_fwd,
         **decoder_tail_bound(128, N_GENES, backward=False), "library_ms": None},
        {"name": "decoder_tail_bwd", "route": "cuda", "source": tail_src,
         "replaces": "scldm_tpu/ops/fused_decoder.py:294",
         "launches": bwd_launches + parse["decoder_tail_bwd"] + cli["decoder_tail_bwd"]
         + variants["decoder_tail_bwd"] + p15["decoder_tail_bwd"] + p16["decoder_tail_bwd"],
         **tail_bwd,
         **decoder_tail_bound(128, N_GENES, backward=True), "library_ms": None},
    ] + [
        # dense at parse1m (B=128, G=2,000), window at the dentate window (B=128, S=6,147)
        {"name": f"{'encoder' if v == 'dense' else 'window'}_pool_{part}", "route": "cuda",
         "source": pool_src,
         "replaces": f"scldm_tpu/ops/fused_encoder.py:{pool_replaces[f'{v}_{part}']}",
         "launches": pool_launches[f"{v}_{part}"], **pools[f"{v}_{part}"],
         **(narrow_pool_bwd_bound if part == "bwd" else narrow_pool_fwd_bound)(
             128, PARSE_GENES if v == "dense" else WINDOW, v == "dense"), "library_ms": None}
        for v in ("dense", "window") for part in ("fwd", "bwd")
    ] + [
        # the census decoder's rows: B=16 cells x G=36,601 genes, f32 and the
        # configs' bf16 (one bf16 wgmma pass)
        {"name": f"swiglu_vec_{part}{'' if tag == 'f32' else '_bf16'}", "route": "cuda",
         "source": "scldm_torch/kernels/csrc/swiglu_vec.cu",
         "replaces": f"scldm_tpu/ops/fused_swiglu.py:{line}",
         "launches": census_swiglu[(tag, part)]
         + (p15[f"swiglu_vec_{part}"] + p16[f"swiglu_vec_{part}"] + p17[f"swiglu_vec_{part}"]
            if tag == "bf16" else 0),
         **swiglu[(tag, part)],
         **(swiglu_vec_bound if tag == "f32" else swiglu_vec_bf16_bound)(
             CENSUS_BATCH * CENSUS["n_genes"], CENSUS["n_embed"], CENSUS_HIDDEN, part == "bwd"),
         "library_ms": None}
        for tag in ("f32", "bf16") for part, line in (("fwd", 256), ("bwd", 280))
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
         "replaces": f"scldm_tpu/ops/fused_trunk.py:{line}",
         "launches": trunk[part] + variants[f"fused_trunk_{part}"],
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
         **wide_pool_bound(CENSUS_BATCH, CENSUS_WINDOW, part == "bwd", CENSUS["n_embed"],
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
    # the any-width designs at phase 13's two shapes: the tail at the dentate
    # (B=128, G=17,002, E=64) and parse1m (G=2,000, E=128) steps, the dense pool at
    # parse1m (E=128), the window pool at the dentate window (E=64)
    gen_tail = "scldm_torch/kernels/csrc/decoder_tail_gen.cu"
    gen_pool = "scldm_torch/kernels/csrc/encoder_pool_gen.cu"
    kernels += [
        {"name": f"decoder_tail_gen_{part}_e{E}", "route": "cuda", "source": gen_tail,
         "replaces": f"scldm_tpu/ops/fused_decoder.py:{262 if part == 'fwd' else 294}",
         "launches": widths["dentate" if E == 64 else "parse1m"][f"decoder_tail_{part}"],
         **tail_grid[(part, E)],
         "library_ms": None}
        for E in (64, 128) for part in ("fwd", "bwd")
    ] + [
        {"name": f"{'encoder' if v == 'dense' else 'window'}_pool_gen_{part}", "route": "cuda",
         "source": gen_pool,
         "replaces": f"scldm_tpu/ops/fused_encoder.py:{pool_replaces[f'{v}_{part}']}",
         "launches": (widths["parse1m"][f"encoder_pool_{part}"] if v == "dense" else
                      widths["fused_pool"][f"window_pool_{part}"]),
         **pool_grid[(v, part)], "library_ms": None}
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
