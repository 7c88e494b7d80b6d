#!/usr/bin/env python3
"""Which faults of the bf16 swiglu_vec kernels chip_smoke.py's bounds catch, on one NVIDIA GPU.

    python3 benchmarks_torch/census_bounds_faults.py

Phase 6's census VAE (`chip_smoke.census_training_setup`: vae_census.yaml as
shipped, bf16 and remat, random weights from seed 0, its last batch): one
step through the fused gate (`VAETask(algebraic_fused_gate=True)`) with the
swiglu_vec wrappers replaced, for that step only, by faulty versions made
from the real kernels, held against the bf16 plain algebraic path and the
f32 step by phase 6's `CENSUS_BF16_BOUNDS`. Then, at phase 1e's census rows
(R = 16 x 36,601, E = 512, Hd = 1,408, random operands), each faulty
wrapper's outputs against the bf16 plain version by phase 1e's `held_bf16`
rule. The faults:

- g not rounded: the forward through the f32 kernel on the bf16 operands
  (exact in f32), so g meets wv unrounded;
- du not rounded: the backward through the f32 kernel on them, dx, dw12 and
  dwv rounded to bf16 after;
- rows dropped: the forward's output zero in its last 1% of rows, or in its
  last 64-row tile; the backward given ds zero there (dx, dw12 and dwv miss
  those rows).

Prints one line a fault and check: caught or not, with the readings. Exits 1
if the step without a fault is beyond the bounds.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0


def faults(fs) -> dict:
    """name -> (forward, backward) wrappers with that fault; None keeps the
    real one. Each acts on bf16 operands only."""
    fwd, bwd = fs.swiglu_vec_fwd, fs.swiglu_vec_bwd

    def f32_fwd(x, w12, wv):
        return fwd(x.float(), w12.float(), wv.float())

    def f32_bwd(x, w12, wv, ds):
        dx, dw12, dwv = bwd(x.float(), w12.float(), wv.float(), ds)
        return dx.to(x.dtype), dw12.to(w12.dtype), dwv.to(wv.dtype)

    def rows(R: int, part: str) -> int:
        return max(1, R // 100) if part == "1%" else 64

    def drop_fwd(part: str):
        def f(x, w12, wv):
            out = fwd(x, w12, wv)
            out[out.shape[0] - rows(out.shape[0], part):] = 0
            return out
        return f

    def drop_bwd(part: str):
        def f(x, w12, wv, ds):
            ds = ds.float().clone()
            ds[ds.shape[0] - rows(ds.shape[0], part):] = 0
            return bwd(x, w12, wv, ds)
        return f

    return {"none": (None, None),
            "g not rounded (forward)": (f32_fwd, None),
            "du not rounded (backward)": (None, f32_bwd),
            "last 1% of rows dropped (forward)": (drop_fwd("1%"), None),
            "last 64-row tile dropped (forward)": (drop_fwd("tile"), None),
            "last 1% of rows dropped (backward)": (None, drop_bwd("1%")),
            "last 64-row tile dropped (backward)": (None, drop_bwd("tile"))}


def patched(fs, pair):
    """A context that swaps the module's wrappers for `pair` on bf16
    operands (f32 ones keep the real kernels) and restores them."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def swap():
        saved = fs.swiglu_vec_fwd, fs.swiglu_vec_bwd
        f, b = pair

        def fwd(x, w12, wv):
            return (f if f and x.dtype == torch.bfloat16 else saved[0])(x, w12, wv)

        def bwd(x, w12, wv, ds):
            return (b if b and x.dtype == torch.bfloat16 else saved[1])(x, w12, wv, ds)

        fs.swiglu_vec_fwd, fs.swiglu_vec_bwd = fwd, bwd
        try:
            yield
        finally:
            fs.swiglu_vec_fwd, fs.swiglu_vec_bwd = saved
    return swap()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("census_bounds_faults: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    from scldm_torch.ops import fused_swiglu as fs
    from scldm_torch.training.vae_task import VAETask

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    vae, vae32, opt, batches = cs.census_training_setup(SEED)
    batch = batches[-1]
    task = VAETask(vae, **opt, algebraic_fused_gate=True)
    refs = {"bf16 plain": cs.vae_loss_and_grads(VAETask(vae, **opt), batch),
            "f32": cs.vae_loss_and_grads(VAETask(vae32, **opt, algebraic_fused_gate=True), batch)}
    del vae32
    torch.cuda.empty_cache()
    table = faults(fs)
    clean = True
    for name, pair in table.items():
        with patched(fs, pair):
            lk, gk = cs.vae_loss_and_grads(task, batch)
        gaps = cs.census_step_gaps(lk, gk, refs)
        del gk
        parts = []
        caught = False
        for ref, (loss_gap, (rel, gname)) in gaps.items():
            lb, gb = cs.CENSUS_BF16_BOUNDS[ref]
            hit = [w for w, v, b in (("loss", loss_gap, lb), ("gradient", rel, gb)) if v > b]
            caught = caught or bool(hit)
            parts.append(f"vs {ref}: loss {loss_gap:.2e}, gradient {rel:.3e} ({gname})"
                         + (f" beyond the {' and '.join(hit)} bound" if hit else ""))
        if name == "none":
            clean = not caught
        print(f"== phase 6 step, {name}: {'CAUGHT' if caught else 'not caught'}; "
              + "; ".join(parts), flush=True)

    # phase 1e's census rows: each fault's outputs against the bf16 plain version
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    R, E, Hd = cs.CENSUS_BATCH * cs.CENSUS["n_genes"], cs.CENSUS["n_embed"], cs.CENSUS_HIDDEN
    bf = torch.bfloat16
    x = torch.randn(R, E, generator=g, device="cuda").to(bf)
    w12 = (torch.randn(E, 2 * Hd, generator=g, device="cuda") * E**-0.5).to(bf)
    wv = (torch.randn(Hd, 1, generator=g, device="cuda") * Hd**-0.5).to(bf)
    ds = torch.randn(R, 1, generator=g, device="cuda")
    want = {"out": fs.swiglu_vec_reference(x, w12, wv),
            **dict(zip(("dx", "dw12", "dwv"), fs.swiglu_vec_backward_reference(x, w12, wv, ds)))}
    for name, pair in table.items():
        with patched(fs, pair):
            got = {"out": fs.swiglu_vec_fwd(x, w12, wv),
                   **dict(zip(("dx", "dw12", "dwv"), fs.swiglu_vec_bwd(x, w12, wv, ds)))}
        parts, caught = [], False
        for k, w in want.items():
            err, scale, beyond = cs.bf16_distance(got[k].float(), w.float())
            hit = err > 1e-2 * scale or beyond > 5e-2
            caught = caught or hit
            parts.append(f"{k} {err / scale:.1e} of max, {beyond:.1e} beyond 1e-4"
                         + (" (beyond)" if hit else ""))
        if name == "none":
            clean = clean and not caught
        print(f"== phase 1e census rows, {name}: {'CAUGHT' if caught else 'not caught'}; "
              + ", ".join(parts), flush=True)
        del got
    return 0 if clean else 1


if __name__ == "__main__":
    sys.exit(main())
