"""Preemption-safe training (counterpart of ``textreid_tpu/utils/preempt.py
PreemptionGuard``): SIGTERM -> a ``preempt`` checkpoint -> a clean return.

A scheduler that reclaims a machine sends SIGTERM and waits a grace period.
The trainer polls a :class:`PreemptionGuard` at its log boundaries (where it
reads the step's metrics anyway), saves ``preempt.pth`` with ``epoch``
pinned one back so that a resume runs the interrupted epoch again, and
returns; ``train_net --resume-from auto`` then prefers that checkpoint when
it is newer than the last epoch's.

:meth:`PreemptionGuard.triggered_global` agrees across the processes of a
data-parallel group (an all-reduce MAX of the flags, as JAX's allgather):
a SIGTERM to one rank stops every rank at the same log boundary, where
they save ``preempt.pth`` once (rank 0 writes) and return together.
"""

from __future__ import annotations

import logging
import signal
import threading

from ..parallel.mesh import any_rank


class PreemptionGuard:
    """Installs a SIGTERM handler that records the request.

    ``enabled=False`` (``TPU.PREEMPT_SAVE`` off), or a guard made off the
    main thread, where Python forbids ``signal.signal``, installs nothing:
    ``triggered`` then turns True only through :meth:`trip`."""

    def __init__(self, enabled: bool = True):
        self._flag = threading.Event()
        self.installed = False
        self._prev = None
        if not enabled:
            return
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handle)
            self.installed = True
        except ValueError:
            logging.getLogger("PersonSearch.preempt").warning(
                "Not on the main thread; SIGTERM checkpointing disabled")

    def _handle(self, signum, frame):
        self._flag.set()

    def trip(self) -> None:
        """Mark as triggered (a programmatic shutdown, or a test)."""
        self._flag.set()

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()

    def triggered_global(self) -> bool:
        """Whether any process was signalled; with one process, this
        one.  In a group every rank must call it at the same point."""
        return any_rank(self.triggered)

    def uninstall(self) -> None:
        """Restore the previous SIGTERM handler (end of training)."""
        if self.installed:
            signal.signal(signal.SIGTERM, self._prev or signal.SIG_DFL)
            self.installed = False
