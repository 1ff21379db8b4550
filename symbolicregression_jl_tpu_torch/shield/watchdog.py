"""Host-side watchdog: deadlines for device iterations and kernel builds.

Port of ``symbolicregression_jl_tpu/shield/watchdog.py``. A hung kernel
or a runaway build blocks the host in ``torch.cuda.synchronize()`` (or a
``.item()``) forever, and the only diagnostic is an external ``timeout``
killing the job with nothing to show. The watchdog is a daemon thread
armed around each supervised phase; when a phase exceeds its budget it
assembles a diagnostic dump (phase, elapsed against budget, every
thread's Python stack: the main thread's shows which call is stuck) and
invokes the abort action.

The default action writes the dump to stderr (and ``dump_path`` when
set), emits a ``fault`` telemetry record and hard-exits with code 124,
the code an external ``timeout`` gives, but sooner and with the stack.
A Python exception cannot interrupt a thread blocked inside the CUDA
runtime, so a hard exit is the honest abort; tests inject a recording
action instead. The monitor thread runs while the main thread waits in
the CUDA runtime because PyTorch releases the GIL there.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

from ..utils.monitor import thread_dump

__all__ = ["Watchdog", "WatchdogTimeout"]


class WatchdogTimeout(RuntimeError):
    """Raised after the watchdog fired, at the next ``phase()`` entry or
    exit on the supervised thread, when the abort action returned (as a
    test's recording action does): the blocked call itself cannot be
    interrupted, but a phase that eventually returns is failed."""


def _default_abort(dump: str, exit_code: int = 124) -> None:
    sys.stderr.write(dump)
    sys.stderr.flush()
    os._exit(exit_code)


class Watchdog:
    """Arms a deadline around supervised phases of the search loop.

    Usage::

        wd = Watchdog(dump_path=..., on_timeout=None)  # None = abort
        with wd.phase("iteration", budget=options.iteration_deadline):
            state = engine.run_iteration(...)
        with wd.phase("iteration", budget=options.iteration_deadline):
            torch.cuda.synchronize()
        wd.stop()

    ``budget=None`` phases are unsupervised (no arming, no thread work).
    The monitor thread is started lazily on the first armed phase and
    polls at ``poll_interval``; firing is once-per-phase.
    """

    def __init__(
        self,
        *,
        on_timeout: Optional[Callable[[str], None]] = None,
        dump_path: Optional[str] = None,
        telemetry=None,
        poll_interval: float = 0.25,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._on_timeout = on_timeout
        self.dump_path = dump_path
        self.telemetry = telemetry
        self.poll_interval = float(poll_interval)
        self._clock = clock
        self._lock = threading.Lock()
        self._deadline: Optional[float] = None
        self._phase: Optional[str] = None
        self._budget: Optional[float] = None
        self._started: Optional[float] = None
        self._iteration: int = 0
        self._fired_phase: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False
        self.last_dump: Optional[str] = None

    # ------------------------------------------------------------------
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="graftshield-watchdog", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            with self._lock:
                deadline = self._deadline
                phase = self._phase
                budget = self._budget
                started = self._started
                iteration = self._iteration
            if deadline is None or phase is None:
                continue
            now = self._clock()
            if now < deadline:
                continue
            with self._lock:
                if self._deadline is None:  # disarmed while we looked
                    continue
                self._deadline = None  # fire once per phase
                self._fired_phase = phase
            self._fire(phase, budget, now - (started or now), iteration)

    def _fire(self, phase: str, budget: Optional[float], elapsed: float,
              iteration: int) -> None:
        self.fired = True
        dump = self.build_dump(phase, budget, elapsed, iteration)
        self.last_dump = dump
        if self.dump_path is not None:
            try:
                with open(self.dump_path, "w") as f:
                    f.write(dump)
            except OSError:  # the dump must not mask the timeout itself
                pass
        if self.telemetry is not None:
            try:
                self.telemetry.fault(
                    "watchdog_timeout", iteration=iteration,
                    phase=phase, budget_s=budget, elapsed_s=elapsed,
                    dump_path=self.dump_path,
                )
            except Exception:  # pragma: no cover - telemetry best-effort
                pass
        action = self._on_timeout or _default_abort
        action(dump)

    @staticmethod
    def build_dump(phase: str, budget: Optional[float], elapsed: float,
                   iteration: int) -> str:
        head = (
            "=== graftshield watchdog: phase deadline exceeded ===\n"
            f"phase      : {phase}\n"
            f"iteration  : {iteration}\n"
            f"elapsed    : {elapsed:.1f}s (budget "
            f"{'-' if budget is None else f'{budget:.1f}s'})\n"
            "A device iteration or kernel build is not completing. Thread\n"
            "stacks below; the main thread shows the blocked call.\n"
        )
        return head + thread_dump() + "\n"

    # ------------------------------------------------------------------
    @contextmanager
    def phase(self, name: str, budget: Optional[float],
              iteration: int = 0):
        """Supervise one phase. No-op when ``budget`` is None."""
        if budget is None:
            yield
            return
        self._ensure_thread()
        with self._lock:
            if self._fired_phase is not None:
                fired, self._fired_phase = self._fired_phase, None
                raise WatchdogTimeout(
                    f"watchdog fired during phase {fired!r}"
                )
            self._phase = name
            self._budget = float(budget)
            self._started = self._clock()
            self._deadline = self._started + float(budget)
            self._iteration = int(iteration)
        try:
            yield
        finally:
            with self._lock:
                self._deadline = None
                self._phase = None
                if self._fired_phase is not None:
                    fired, self._fired_phase = self._fired_phase, None
                    raise WatchdogTimeout(
                        f"watchdog fired during phase {fired!r}"
                    )

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
