"""Preemption-safe training: checkpoint and exit on SIGTERM (counterpart of
scldm_tpu/training/preemption.py).

Spot and preemptible machines deliver SIGTERM with a grace window before the
hard kill. The signal handler only sets a `threading.Event`; the fit loop
polls the guard at dispatch boundaries, breaks out, writes a checkpoint
through the normal path and returns, so auto-resume continues from the
preempted step.

The port trains in one process on one card, so the agreement that JAX's
multi-host runs reach before a collective save (an allgather every
`poll_every` batches) is the identity here: `stop_requested_global` is the
local flag. The method stays so that the fit loop reads as JAX's does.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable

from scldm_torch.utils.logger import logger


class PreemptionGuard:
    """Installable SIGTERM (by default) stop flag for the fit loop."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev: dict = {}
        self._installed = False

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
        """The decision every process must share before the checkpoint
        save: with one process, its own flag."""
        return self._event.is_set()
