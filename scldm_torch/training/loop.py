"""The fit loop (counterpart of scldm_tpu/training/loop.py): epochs over the
DataModule, train steps, validation, CSV logging and checkpoints with
auto-resume, the functional replacement for `pytorch_lightning.Trainer.fit`
as the reference uses it (train.py:62-88).

Batches come from the DataModule as numpy arrays and become tensors on the
task's device in one place, `to_device` (uint16 wire arrays stay uint16;
the task widens them on the device).

On a mesh every rank runs the loop over its own batches (the DataModule's
host split gives each the same count), the steps' collectives keeping the
ranks in lockstep; validation means are reduced over the data ranks. The
CLIs pass the loggers (metrics.csv, wandb) and the profiler on rank 0 only.
"""

from __future__ import annotations

import csv
import inspect
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from scldm_torch.parallel.distributed import collective_device
from scldm_torch.parallel.mesh import axis_rank, axis_size
from scldm_torch.training.checkpoint import CheckpointManager
from scldm_torch.utils.logger import logger
from scldm_torch.utils.profiling import StepProfiler


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on `device`. The copy to a card is synchronous
    (pageable host memory), so the host arrays may be reused once it returns."""
    return {k: torch.from_numpy(np.require(v, requirements=("C", "W"))).to(device)
            for k, v in batch.items()}


def _device_of(state) -> torch.device:
    return next(state.module.parameters()).device


class _StackBuffers:
    """Reusable host buffers for the groups of `steps_per_dispatch` batches.

    Fresh large numpy allocations page-fault on first touch; copying into
    persistent buffers touches the pages once. Reuse is safe because
    `to_device` copies synchronously."""

    def __init__(self):
        self._bufs: Dict[str, np.ndarray] = {}

    def stack(self, batches):
        out = {}
        for k in batches[0]:
            first = np.asarray(batches[0][k])
            shape = (len(batches),) + first.shape
            buf = self._bufs.get(k)
            if buf is None or buf.shape != shape or buf.dtype != first.dtype:
                buf = np.empty(shape, first.dtype)
                self._bufs[k] = buf
            for i, b in enumerate(batches):
                np.copyto(buf[i], b[k])
            out[k] = buf
        return out


class CSVLogger:
    """Append-only metrics CSV that takes rows with different columns.

    Training and validation log different column sets through the same file,
    so the header cannot be frozen from the first row: a row with new columns
    rewrites the file once with the widened header. Missing cells stay
    empty. An existing file's header is adopted (resume)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fieldnames: Optional[list] = None
        if self.path.exists():
            with self.path.open(newline="") as f:
                header = next(csv.reader(f), None)
            if header:
                self._fieldnames = list(header)

    def log(self, row: Dict):
        row = {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
               for k, v in row.items()}
        if self._fieldnames is None:
            self._fieldnames = list(row.keys())
            with self.path.open("a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fieldnames).writeheader()
        new_keys = [k for k in row if k not in self._fieldnames]
        if new_keys:
            widened = self._fieldnames + new_keys
            with self.path.open(newline="") as f:
                existing = list(csv.DictReader(f))
            with self.path.open("w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=widened)
                w.writeheader()
                w.writerows(existing)
            self._fieldnames = widened
        with self.path.open("a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._fieldnames).writerow(row)


def fit(
    task,
    datamodule,
    state,
    *,
    max_steps: int,
    epochs: int,
    ckpt_manager: Optional[CheckpointManager] = None,
    csv_logger: Optional[CSVLogger] = None,
    log_every_steps: int = 50,
    val_every_epochs: int = 1,
    save_every_epochs: int = 1,
    eval_rng_seed: int = 0,
    steps_per_dispatch: int = 1,
    on_validation_end: Optional[Callable] = None,  # (epoch, val_metrics, state)
    wandb_logger=None,  # utils.wandb_logger.WandbLogger
    profile_dir: Optional[str] = None,  # trace the dispatches after the first here
    profile_steps: int = 3,
    preemption=None,  # training.preemption.PreemptionGuard (installed by the caller)
    mesh=None,  # parallel.make_mesh: validation means over the data ranks
):
    """Train until max_steps or the epochs run out, or a preemption signal
    arrives (the guard is polled at dispatch boundaries; on a stop the loop
    checkpoints and returns, so auto-resume continues from the preempted
    step). Returns the final state."""
    device = _device_of(state)
    start_step = int(state.step)
    if ckpt_manager is not None:
        state, resumed = ckpt_manager.maybe_restore(state)
        if resumed:
            start_step = int(state.step)
            logger.info(f"auto-resumed from checkpoint at step {start_step}")

    step = start_step
    start_epoch = 0 if datamodule.steps_per_epoch == 0 else step // max(
        datamodule.steps_per_epoch, 1
    )
    # mid-epoch resume (after a preemption save): the first epoch's stream
    # skips the batches already consumed, so data order stays aligned with the
    # step counter (no replays, exact epoch boundaries)
    resume_skip = (
        step - start_epoch * datamodule.steps_per_epoch
        if datamodule.steps_per_epoch > 0
        else 0
    )
    if resume_skip:
        if "skip" in inspect.signature(datamodule.train_batches).parameters:
            logger.info(
                f"mid-epoch resume: skipping {resume_skip} consumed batches "
                f"of epoch {start_epoch}"
            )
        else:  # a stub datamodule without the fast-forward replays
            resume_skip = 0
    t_last = time.perf_counter()
    cells_seen = 0
    last_logged = step

    stackers = _StackBuffers()
    profiler = StepProfiler(profile_dir, profile_steps)
    preempted = False

    def run_single(b):
        """One un-stacked optimizer step (ragged tails, budget clamps and
        epoch-end flushes all go through here, so the bookkeeping cannot
        drift between the call sites)."""
        nonlocal state, step, cells_seen
        state, m = task.train_step(state, to_device(b, device))
        profiler.tick(m)
        step += 1
        cells_seen += len(b["library_size"])
        return m

    def flush_log(metrics, epoch, force=False):
        """Cadenced metric logging and the non-finite fail-fast (the
        reference's models.py:1049-1051 raises on NaN losses). `force` logs
        regardless of cadence, when the run is about to end, so the final
        steps are inspected before the last checkpoint write."""
        nonlocal last_logged, t_last, cells_seen
        if not force and step - last_logged < log_every_steps:
            return
        if step == last_logged:
            # nothing new since the cadence's row
            return
        last_logged = step
        # in key order, as JAX's jitted steps return their metrics
        metrics = {k: float(v) for k, v in sorted(metrics.items())}
        if not np.isfinite(metrics.get("train_loss", 0.0)):
            raise FloatingPointError(
                f"non-finite train_loss at step {step}: {metrics['train_loss']}"
            )
        now = time.perf_counter()
        if cells_seen:
            metrics["cells_per_sec"] = cells_seen / (now - t_last)
        t_last, cells_seen = now, 0
        metrics.update(step=step, epoch=epoch)
        logger.info(
            f"step {step} epoch {epoch} "
            + " ".join(f"{k}={v:.4g}" for k, v in metrics.items() if k not in ("step", "epoch"))
        )
        if csv_logger:
            csv_logger.log(metrics)
        if wandb_logger:
            wandb_logger.log(metrics, step=step)

    metrics: Optional[Dict] = None
    epoch = start_epoch
    for epoch in range(start_epoch, epochs):
        if step >= max_steps or preempted:
            break
        pending = []
        epoch_skip = resume_skip if epoch == start_epoch else 0
        batches = (
            datamodule.train_batches(epoch, skip=epoch_skip)
            if epoch_skip
            else datamodule.train_batches(epoch)
        )
        for batch in batches:
            if step >= max_steps:
                break
            if preemption is not None and preemption.stop_requested_global():
                preempted = True
                break
            if steps_per_dispatch > 1 and hasattr(task, "train_steps"):
                # K optimizer steps a call. A ragged batch cannot stack with
                # full-size ones: the pending group then runs singly, and the
                # short batch takes the single-step path too.
                if pending and batch["library_size"].shape[0] != (
                    pending[0]["library_size"].shape[0]
                ):
                    for b in pending:
                        if step >= max_steps:
                            break
                        metrics = run_single(b)
                    pending = []
                pending.append(batch)
                if len(pending) < steps_per_dispatch:
                    continue
                if step + len(pending) > max_steps:
                    # the budget cuts through this group: only the remaining
                    # allowance runs, as single steps, so a resumed run never
                    # trains past max_steps (the reference's max_steps =
                    # epochs * n_cells // (batch * world), _utils.py:62-108)
                    for b in pending:
                        if step >= max_steps:
                            break
                        metrics = run_single(b)
                    pending = []
                    # the budget is spent: these steps meet the non-finite
                    # guard and the loggers before the last checkpoint
                    flush_log(metrics, epoch, force=True)
                    continue
                stacked = to_device(stackers.stack(pending), device)
                state, metrics = task.train_steps(state, stacked)
                profiler.tick(metrics)
                step += len(pending)
                cells_seen += sum(len(b["library_size"]) for b in pending)
                pending = []
            else:
                metrics = run_single(batch)
            flush_log(metrics, epoch)

        # a partial group at epoch end runs as single steps, but not on
        # preemption: `step` never counted those batches, so the resumed run
        # takes them in its first group, and the grace window goes to the
        # checkpoint write
        for batch in pending if not preempted else ():
            if step >= max_steps:
                break
            metrics = run_single(batch)
            flush_log(metrics, epoch)

        if preempted:
            logger.info(
                f"preemption signal: checkpointing at step {step} and exiting"
            )
            break

        # -- validation (raw, and EMA where the state has one) -------------------
        if (epoch + 1) % val_every_epochs == 0 and datamodule.n_val_batches > 0:
            val_metrics = validate(task, datamodule, state, mesh=mesh, seed=eval_rng_seed)
            logger.info(
                f"epoch {epoch} validation "
                + " ".join(f"{k}={v:.4g}" for k, v in val_metrics.items())
            )
            if csv_logger:
                csv_logger.log({"step": step, "epoch": epoch, **val_metrics})
            if wandb_logger:
                wandb_logger.log({"epoch": epoch, **val_metrics}, step=step)
            if on_validation_end is not None:
                on_validation_end(epoch, val_metrics, state)
        else:
            val_metrics = {}

        if ckpt_manager is not None and (epoch + 1) % save_every_epochs == 0:
            ckpt_manager.save(step, state, metrics=val_metrics or None)

    # the last metrics meet the non-finite guard and the loggers before the
    # final checkpoint (a no-op where the cadence logged this step, or in a
    # run of no steps)
    if metrics is not None:
        flush_log(metrics, epoch, force=True)
    profiler.close()  # a run shorter than 1+profile_steps dispatches
    if ckpt_manager is not None:
        ckpt_manager.save(step, state)
    return state


def validate(task, datamodule, state, mesh=None, seed: int = 0) -> Dict[str, float]:
    """The means of `task.eval_step`'s metrics over the validation stream,
    and of the EMA weights' where the state has an EMA (the reference's
    BaseModel.validation_step). Batch i draws from a generator seeded
    seed * 100_003 + i, the same for both; on a mesh i counts the data
    ranks' batches in turn (this rank's j-th is j * n_data + its data rank),
    and the means are over every data rank's batches."""
    device = _device_of(state)
    sums: Dict[str, float] = {}
    count = 0
    has_ema = getattr(state, "ema", None) is not None
    n_data, data_rank = axis_size(mesh, "data"), axis_rank(mesh, "data")

    def generator(i):
        return torch.Generator(device).manual_seed(seed * 100_003 + i * n_data + data_rank)

    for i, batch in enumerate(datamodule.val_batches()):
        dev_batch = to_device(batch, device)
        # each call's metrics in key order, as JAX's jitted eval steps return them
        metrics = dict(sorted(task.eval_step(state, dev_batch, generator(i)).items()))
        if has_ema:
            metrics.update(sorted(
                task.eval_step(state, dev_batch, generator(i), use_ema=True).items()))
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        count += 1
    if n_data > 1:
        keys = sorted(sums)
        totals = torch.tensor([sums[k] for k in keys] + [count], dtype=torch.float64,
                              device=collective_device())
        dist.all_reduce(totals, group=mesh.get_group("data"))
        sums, count = dict(zip(keys, totals[:-1].tolist())), int(totals[-1])
    return {k: v / max(count, 1) for k, v in sums.items()}
