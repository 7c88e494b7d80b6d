"""Preemption-safe training: checkpoint and exit on SIGTERM (counterpart of
scldm_tpu/training/preemption.py).

Spot and preemptible machines deliver SIGTERM with a grace window before the
hard kill. The signal handler only sets a `threading.Event`; the fit loop
polls the guard at dispatch boundaries, breaks out, writes a checkpoint
through the normal path and returns, so auto-resume continues from the
preempted step.

Ranks must agree on stopping: the checkpoint save is collective, so one
rank saving while the others train on would hang both. Under a process
group `stop_requested_global` all-reduces the local flag (MAX) over the world
once every `poll_every` calls (the loop calls it once a batch on every rank,
in lockstep), so every rank stops at the same step; in between it returns
the last agreed decision, never the bare local flag. With one process it is
the local flag.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable

import torch
import torch.distributed as dist

from scldm_torch.parallel.distributed import collective_device, world_size
from scldm_torch.utils.logger import logger


class PreemptionGuard:
    """Installable SIGTERM (by default) stop flag for the fit loop.
    `poll_every` is the cadence of the ranks' agreement (JAX's default 8):
    a stop costs up to `poll_every` - 1 more batches of the grace window."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,), poll_every: int = 8):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev: dict = {}
        self._installed = False
        self._poll_every = max(int(poll_every), 1)
        self._calls = 0
        self._agreed = False  # the ranks' decision, which latches

    # -- lifecycle ----------------------------------------------------------
    def install(self) -> "PreemptionGuard":
        """Register the handlers (main thread only, a constraint of the
        signal module). Off the main thread `signal.signal` raises
        ValueError; the guard then works through `request_stop()` alone
        instead of crashing a caller that drives the CLIs from a worker
        thread. Installing twice does nothing."""
        if self._installed:
            return self
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._on_signal)
        except ValueError:
            # off the main thread every signal.signal call fails, so nothing
            # was registered and there is nothing to roll back
            self._prev.clear()
            logger.warning(
                "PreemptionGuard: not on the main thread — signal handlers "
                "unavailable; preemption stop works only via request_stop()"
            )
        self._installed = True
        return self

    def uninstall(self) -> None:
        """Restore the handlers that were there before `install`."""
        if not self._installed:
            return
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- signal path ----------------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        # one flag flip; logging and saving happen in the loop
        self._event.set()

    def request_stop(self) -> None:
        """Programmatic trigger (tests, external orchestrators)."""
        self._event.set()

    # -- queries ----------------------------------------------------------------
    @property
    def stop_requested(self) -> bool:
        """This process's flag."""
        return self._event.is_set()

    def stop_requested_global(self) -> bool:
        """The decision every rank must share before the checkpoint save:
        whether any rank was signalled, agreed at the `poll_every` cadence
        (with one process, its own flag)."""
        local = self._event.is_set()
        if world_size() == 1:
            return local
        if self._agreed:
            return True
        refresh = self._calls % self._poll_every == 0
        self._calls += 1
        if not refresh:
            return False
        flag = torch.tensor([1.0 if local else 0.0], device=collective_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        self._agreed = bool(flag.item() > 0)
        if self._agreed and not local:
            logger.info("another rank was preempted; stopping in lockstep")
        return self._agreed
