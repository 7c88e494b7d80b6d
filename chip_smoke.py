#!/usr/bin/env python3
"""Smoke run of the PyTorch port (scldm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--batch B]

Phase 0 prints the card's name and power limit and builds the CUDA kernels
from `scldm_torch/kernels/csrc`. Phase 1 holds the DiT block kernel against
its plain PyTorch version on the card at the generation path's shapes, and
phase 1b the decoder-tail kernels (forward and backward) against theirs at
the VAE training step's shape and a ragged one, timing both. Phase 2 runs CFG
generation (`LDMTask.make_sample_fn`) at the dentate-gyrus configuration with
random weights made from the seed, with dopri5 and with euler-50, checks the
outputs, checks that every DiT block went through the kernel, and holds one
DiT evaluation of the sampler (the kernel path) against the plain module path
(`DiT.forward_with_cfg_batched`) on the same inputs. Phase 3 trains the
dentate-gyrus VAE (`VAETask.train_step`) on lean wire batches made like
bench.py's for a warm-up step and TRAIN_STEPS timed steps, checks the losses
and that each tail kernel ran once per step, and holds one step's loss and
gradients on the kernel path against the module path. The line before the last is a
JSON summary of the kernels; the last is {"ok": true, "device": {...}}. Any
failure raises, so the script exits non-zero and prints no result; so does a
machine without CUDA, or a directory without the port's sources.
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


def phase1_dit_block(seed: int) -> dict:
    """dit_block vs dit_block_reference at the sampler's shape and a ragged R."""
    import torch

    from scldm_torch.ops import fused_dit

    E, H, hidden, T = DIT["n_embed"], DIT["n_head"], 684, DIT["seq_len"]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    # non-zero adaLN weights: adaLN-zero init would make the block the identity
    w = {"wada": rnd(E, 6 * E, scale=E**-0.5), "bada": rnd(6 * E, scale=0.1),
         "wqkv": rnd(E, 3 * E, scale=E**-0.5), "bqkv": rnd(3 * E, scale=0.1),
         "wproj": rnd(E, E, scale=E**-0.5), "bproj": rnd(E, scale=0.1),
         "w1": rnd(E, hidden, scale=E**-0.5), "w2": rnd(E, hidden, scale=E**-0.5),
         "wmlp": rnd(hidden, E, scale=hidden**-0.5)}
    eps = 1e-8
    max_err = 0.0
    timing = {}
    for R in (3 * 128, 5):  # R = 3B rows at batch 128, and a ragged small R
        x, c = rnd(R, T, E), rnd(R, E)
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
        worst = {}
        for name, w in want.items():
            scale = w.abs().max().item()
            d = (got[name] - w).abs()
            err, beyond = d.max().item(), (d > 1e-4 * scale).float().mean().item()
            if scale == 0 or err > 1e-2 * scale or beyond > 5e-2:
                raise AssertionError(f"decoder_tail {name} at G={G}, B={B}: max abs err {err:.3e}, "
                                     f"max |ref| {scale:.3e}, share beyond 1e-4 of it {beyond:.2e}")
            worst[name] = (err, err / scale, beyond)
            errs.setdefault("fwd" if name == "logits" else "bwd", []).append(err)
        log(f"phase1b decoder_tail G={G} B={B}: " + ", ".join(
            f"{k} {e:.2e} ({r:.1e} of max, {b:.1e} beyond 1e-4)" for k, (e, r, b) in worst.items()))

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


def lean_batch(rng, batch: int) -> dict:
    """bench.py's lean wire batch: the expressed genes (about 1.5k to 4k per
    cell) and their counts, uint16, zero-padded to the window."""
    import numpy as np

    genes = np.zeros((batch, WINDOW), np.uint16)
    counts = np.zeros((batch, WINDOW), np.uint16)
    for i in range(batch):
        nnz = int(rng.integers(1500, 4000))
        genes[i, :nnz] = np.sort(rng.choice(N_GENES, size=nnz, replace=False)) + 1
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

    # one step's loss and gradients, kernel path vs module path, same parameters
    # and batch; JAX's own bounds between the two (tests/test_fused_decoder.py)
    grads = []
    for t in (task, VAETask(vae, fused_decoder=False)):
        vae.zero_grad(set_to_none=True)
        loss, _ = t.loss(batches[-1])
        loss.backward()
        grads.append((loss.item(), {n: p.grad.clone() for n, p in vae.named_parameters()
                                    if p.grad is not None}))
    (lk, gk), (lm, gm) = grads
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
    vae.zero_grad(set_to_none=True)
    log(f"phase3 reference: one step, kernel path vs module path: loss {lk:.4f} vs {lm:.4f} "
        f"({abs(lk - lm) / abs(lm):.2e} relative), {len(gm)} gradients, largest gap "
        f"{worst[0]:.3e} of its max ({worst[1]})")
    return fwd, bwd


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

    # -- phase 2: the generation path -------------------------------------------
    launches = phase2_generation(args.seed, args.batch)
    phase2_reference(args.seed, args.batch)

    # -- phase 3: the VAE training path -------------------------------------------
    fwd_launches, bwd_launches = phase3_training(args.seed, args.batch)

    tail_src = "scldm_torch/kernels/csrc/decoder_tail.cu"
    kernels = [
        {"name": "dit_block", "route": "cuda", "source": "scldm_torch/kernels/csrc/dit_block.cu",
         "replaces": "scldm_tpu/ops/fused_dit.py:155", "launches": launches, **dit_block},
        {"name": "decoder_tail_fwd", "route": "cuda", "source": tail_src,
         "replaces": "scldm_tpu/ops/fused_decoder.py:262", "launches": fwd_launches, **tail_fwd},
        {"name": "decoder_tail_bwd", "route": "cuda", "source": tail_src,
         "replaces": "scldm_tpu/ops/fused_decoder.py:294", "launches": bwd_launches, **tail_bwd},
    ]
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
