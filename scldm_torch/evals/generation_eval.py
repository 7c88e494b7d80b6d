"""The periodic generation eval of LDM training (counterpart of
scldm_tpu/evals/generation_eval.py; the reference's
LatentDiffusion.on_validation_epoch_end, models.py:849-939): every `freq`
epochs past `warmup_epochs`, generate at least `sample_size` cells, then
compare the unconditional half against the real cells with MMD under four
kernels, Sinkhorn W1 and W2 and the R^2 of the per-gene mean and variance,
on log1p-CPM counts by the real cells' libraries.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable

import numpy as np
import torch

from scldm_torch.evals.mmd import MMD_METRICS
from scldm_torch.evals.wasserstein import sinkhorn
from scldm_torch.ops.transforms import COUNTS, GENES, LIBRARY_SIZE as LIB
from scldm_torch.training.loop import to_device
from scldm_torch.training.metrics import r2_score
from scldm_torch.utils.logger import logger


def should_run(epoch: int, cfg: Dict) -> bool:
    """Enabled, epoch % freq == 0, past the warmup, and not epoch 0."""
    return bool(
        cfg.get("enabled", False)
        and epoch % int(cfg.get("freq", 1)) == 0
        and epoch > int(cfg.get("warmup_epochs", 0))
        and epoch > 0
    )


def distribution_metrics(counts_real: torch.Tensor, counts_gen: torch.Tensor,
                         library: torch.Tensor, timings: Dict | None = None) -> Dict[str, float]:
    """The eval's metrics of generated against real counts (N, G), both
    scaled by the real library (N, 1) where the metric reads log1p-CPM.
    `timings`, where given, receives each group's seconds and the Sinkhorn
    iterations."""
    real_scaled = torch.log1p(counts_real / library * 10_000.0)
    gen_scaled = torch.log1p(counts_gen / library * 10_000.0)
    sync = torch.cuda.synchronize if counts_real.is_cuda else (lambda: None)
    out: Dict[str, float] = {}
    t0 = time.perf_counter()
    for name, fn in MMD_METRICS.items():
        if "counts" in name:  # the scaled-input kernels (models.py:902-906)
            out[f"generation_eval/{name}"] = float(fn(real_scaled, gen_scaled))
        else:
            out[f"generation_eval/{name}"] = float(fn(counts_real, counts_gen))
    sync()
    t1 = time.perf_counter()
    iters = {}
    for p in (1, 2):
        cost, iters[p] = sinkhorn(real_scaled, gen_scaled, power=p)
        out[f"generation_eval/wasserstein{p}_sinkhorn"] = float(cost) ** (0.5 if p == 2 else 1)
    t2 = time.perf_counter()
    out["generation_eval/r2_mean"] = float(r2_score(gen_scaled.mean(0), real_scaled.mean(0)))
    # jnp.var: the biased variance
    out["generation_eval/r2_var"] = float(r2_score(gen_scaled.var(0, unbiased=False),
                                                   real_scaled.var(0, unbiased=False)))
    out["generation_eval/total_samples"] = float(len(counts_real))
    if timings is not None:
        timings.update(mmd_s=t1 - t0, sinkhorn_s=t2 - t1, sinkhorn_iters=iters)
    return out


def run_generation_eval(
    sample_fn,
    state,
    batches: Iterable[Dict[str, np.ndarray]],
    *,
    sample_size: int = 1024,
    rng_seed: int = 0,
    timings: Dict | None = None,
) -> Dict[str, float]:
    """Generate at least `sample_size` cells, a batch's worth for each real
    validation batch, and compare them with those batches
    (`distribution_metrics`). `sample_fn` is `LDMTask.make_sample_fn`'s:
    fn(generator, genes, condition, batch_size, state) -> (counts (2B, G),
    z); batch i draws from a generator on the sample function's device
    seeded `rng_seed + i`, and keeps the first, unconditional, half."""
    device = next(state.module.parameters()).device
    real, gen, libs = [], [], []
    n = 0
    for i, batch in enumerate(batches):
        if n >= sample_size:
            break
        batch = to_device({k: batch[k] for k in (GENES, COUNTS, LIB)}, device)
        generator = torch.Generator(device).manual_seed(rng_seed + i)
        counts, _ = sample_fn(generator, batch[GENES], None, state=state)
        half = len(batch[GENES])
        gen.append(counts[:half].float())
        real.append(batch[COUNTS].float())
        libs.append(batch[LIB].float())
        n += half
    out = distribution_metrics(torch.cat(real), torch.cat(gen), torch.cat(libs), timings)
    logger.info("generation eval: "
                + " ".join(f"{k.split('/')[-1]}={v:.4g}" for k, v in out.items()))
    return out
