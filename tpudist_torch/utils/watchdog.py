"""The training stall watchdog: the port's copy of
``tpudist/utils/watchdog.py``.

A lost peer stalls the step (a collective waits forever), so no
``kick()`` arrives within ``timeout`` seconds; the watchdog thread then
runs ``on_stall``: by default it writes a diagnostic and every thread's
stack to stderr, records a last ``fault`` event with
``point="watchdog_stall"`` in the rank's telemetry, and ends the process
with ``os._exit(STALL_EXIT_CODE)`` (117), which the launcher classifies as
a stall and tears the job down on. The ``watchdog_expire`` fault point
makes a poll fire at once.

``kick`` is one clock store; the polls run on a daemon thread.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from tpudist_torch.faults import STALL_EXIT_CODE

__all__ = ["STALL_EXIT_CODE", "Watchdog"]


def _default_on_stall(elapsed: float, timeout: float,
                      reason: str = "no kick within timeout") -> None:
    sys.stderr.write(
        f"[tpudist.watchdog] no training-step progress for {elapsed:.0f}s "
        f"(timeout {timeout:.0f}s; fire reason: {reason}) — a peer is likely "
        f"lost or a collective is hung; aborting so the launcher can tear "
        f"the job down.\n")
    # Every thread's stack: which collective or copy is stuck.
    for tid, frame in sys._current_frames().items():
        sys.stderr.write(f"--- thread {tid} ---\n")
        sys.stderr.write("".join(traceback.format_stack(frame)))
    sys.stderr.flush()
    try:
        # Last words into the event stream (emit flushes each line, so
        # the event survives the os._exit below).
        from tpudist_torch import telemetry
        tel = telemetry.current()
        if tel is not None:
            tel.emit("fault", point="watchdog_stall", detail=reason,
                     elapsed_s=round(elapsed, 3))
    except Exception:   # noqa: BLE001 — the abort must happen regardless
        pass
    os._exit(STALL_EXIT_CODE)


class Watchdog:
    """``kick()`` once per unit of progress; if no kick lands within
    ``timeout`` seconds, ``on_stall(elapsed, timeout, reason)`` runs on
    the watchdog thread. ``timeout`` <= 0 disables it."""

    def __init__(self, timeout: float,
                 on_stall: Optional[Callable[[float, float, str], None]]
                 = None,
                 poll_interval: Optional[float] = None):
        self.timeout = float(timeout)
        self.on_stall = on_stall or _default_on_stall
        self.poll = poll_interval or max(self.timeout / 10.0, 0.05)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired = False
        self._fire_reason: Optional[str] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        if self.timeout <= 0:
            return self
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpudist-watchdog")
        self._thread.start()
        return self

    def _run(self) -> None:
        from tpudist_torch import faults
        while not self._stop.wait(self.poll):
            elapsed = time.monotonic() - self._last
            reason = None
            if elapsed > self.timeout:
                reason = (f"no kick for {elapsed:.1f}s "
                          f"(budget {self.timeout:.1f}s)")
            elif faults.maybe_watchdog_expire():
                elapsed = self.timeout + 1.0
                reason = "injected: watchdog_expire fault"
            if reason is not None:
                self._fired = True
                self._fire_reason = reason
                self.on_stall(elapsed, self.timeout, reason)
                return

    def kick(self) -> None:
        self._last = time.monotonic()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll)

    @property
    def fired(self) -> bool:
        return self._fired

    @property
    def fire_reason(self) -> Optional[str]:
        """Why the watchdog fired (None while healthy)."""
        return self._fire_reason

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
