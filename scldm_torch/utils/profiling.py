"""Profiling hooks on `torch.profiler` (counterpart of
scldm_tpu/utils/profiling.py, which uses the jax profiler).

Usage:
    with trace("/tmp/scldm_trace"):        # a chrome trace (chrome://tracing, Perfetto)
        state, m = task.train_step(state, batch)

    python -m scldm_torch.cli.train training.profile_dir=/tmp/trace ...
captures the first few dispatches after the first one.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _export(prof, log_dir: str) -> Path:
    """Write the profile as a chrome trace into `log_dir`."""
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{time.time_ns() % 10**9}.json"
    prof.export_chrome_trace(str(path))
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host and, with a card, device activity) and write
    a chrome trace into `log_dir`; the device is synchronised at both edges."""
    _sync()
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
        _sync()
    _export(prof, log_dir)


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the trace."""
    with torch.profiler.record_function(name):
        yield


class StepProfiler:
    """In-loop trace capture for `training.loop.fit` (training.profile_dir=...).

    The first dispatch (kernel builds, allocator warm-up) is left out; the
    trace covers dispatches 2 .. 1+steps. `tick` is called once per train
    dispatch with its metrics; reading the loss synchronises the device at
    the window's edges, so the trace holds exactly the profiled steps."""

    def __init__(self, log_dir: Optional[str], steps: int = 3):
        self.log_dir = log_dir
        self.steps = max(int(steps), 1)
        self._n = 0
        self._prof = None

    def tick(self, metrics) -> None:
        if not self.log_dir:
            return
        self._n += 1
        if self._n == 1:
            float(metrics["train_loss"])  # drain the first dispatch
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.__enter__()
        elif self._prof is not None and self._n >= 1 + self.steps:
            float(metrics["train_loss"])  # the profiled work has finished
            self.close()

    def close(self) -> None:
        """Stop a trace still open (a run shorter than 1+steps dispatches)
        and write it."""
        if self._prof is not None:
            _sync()
            self._prof.__exit__(None, None, None)
            _export(self._prof, self.log_dir)
            self._prof = None


def capture_train_steps(task, state, batch, log_dir: str, steps: int = 3):
    """Trace `steps` train steps after one outside the trace."""
    state, m = task.train_step(state, batch)
    float(m["train_loss"])
    with trace(log_dir):
        for _ in range(steps):
            with annotate("train_step"):
                state, m = task.train_step(state, batch)
        float(m["train_loss"])
    return state
