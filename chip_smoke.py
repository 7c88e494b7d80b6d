#!/usr/bin/env python3
"""Smoke run of the PyTorch port (scldm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--batch B]

Phase 0 prints the card's name and power limit and builds the CUDA kernels
from `scldm_torch/kernels/csrc`. Phase 1 holds each kernel against its plain
PyTorch version on the card at the shapes of the generation path, and times
both. Phase 2 runs CFG generation (`LDMTask.make_sample_fn`) at the
dentate-gyrus configuration with random weights made from the seed, with
dopri5 and with euler-50, checks the outputs, checks that every DiT block
went through the kernel, and holds one DiT evaluation of the sampler (the
kernel path) against the plain module path (`DiT.forward_with_cfg_batched`)
on the same inputs. The line before the last is a JSON summary of the
kernels; the last is {"ok": true, "device": {...}}. Any failure raises, so
the script exits non-zero and prints no result; so does a machine without
CUDA, or a directory without the port's sources.
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=128, help="cells per CFG half")
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

    # -- phase 2: the generation path -------------------------------------------
    launches = phase2_generation(args.seed, args.batch)
    phase2_reference(args.seed, args.batch)

    kernels = [{
        "name": "dit_block", "route": "cuda",
        "source": "scldm_torch/kernels/csrc/dit_block.cu",
        "replaces": "scldm_tpu/ops/fused_dit.py:155",
        "launches": launches, **dit_block,
    }]
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
