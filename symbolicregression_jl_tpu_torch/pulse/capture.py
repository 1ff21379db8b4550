"""Triggered profiler capture: bounded ``torch.profiler`` trace windows.

Port of the JAX package's ``pulse/capture.py``: the windows, their budget,
their rate limit and their audit events are the same; a window runs
``torch.profiler.profile`` (CPU activity, and CUDA activity where the
device has it) in place of ``jax.profiler``.

The ``sr:iteration`` / ``sr:host:*`` spans (telemetry/spans.py) are
always on but only matter while a trace is being captured; this module
is the thing that captures one — programmatically, from inside the
running search, at the moment something looks wrong:

- the anomaly detector arms a window when a watched metric excurses;
- ``RuntimeOptions(pulse_trace_on=True)`` arms one at the first
  iteration (and graftserve's ``submit(pulse_trace=True)`` sets it for
  one request);
- SIGUSR2 (``SignalArm``) arms one on demand against a live process.

A window spans ``window_iterations`` search iterations and is bounded
two ways: at most ``max_captures`` per run and at least
``min_interval_s`` between windows — a flapping metric cannot turn the
run into one long profiling session. Every transition is audited as a
``pulse`` event (capture_armed / capture_start / capture_stop /
capture_failed) so the stream explains every trace directory on disk.

Trace output lands under ``<out_dir>/pulse_traces/captureNN/`` as one
Chrome trace (``trace.json``, ``torch.profiler``'s export), which Perfetto
and ``chrome://tracing`` open; ``perfetto`` is kept for the JAX package's
signature and changes nothing. A profiler that fails to start or stop
disables further windows for the run and never raises into the search.
"""

from __future__ import annotations

import glob
import os
import signal
import threading
import time
from typing import List, Optional

__all__ = ["TraceCapture", "SignalArm"]

TRACE_FILE = "trace.json"


def _start_profiler(trace_dir: str):
    """Start a ``torch.profiler`` session; returns its handle."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, trace_dir: str) -> None:
    """Stop the session and write its Chrome trace into ``trace_dir``."""
    prof.stop()
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


class TraceCapture:
    """One run's budgeted profiler-capture controller; see module
    docstring. Driven by the search loop at iteration boundaries
    (``maybe_start`` before the iteration's device work, ``maybe_stop``
    after it), so a window always covers whole iterations."""

    def __init__(
        self,
        out_dir: str,
        *,
        hub=None,
        window_iterations: int = 2,
        max_captures: int = 2,
        min_interval_s: float = 30.0,
        perfetto: bool = True,
        clock=time.monotonic,
    ) -> None:
        self.root = os.path.join(out_dir, "pulse_traces")
        self.hub = hub
        self.window_iterations = max(int(window_iterations), 1)
        self.max_captures = max(int(max_captures), 0)
        self.min_interval_s = float(min_interval_s)
        self.perfetto = bool(perfetto)
        self._clock = clock
        self._armed_reason: Optional[str] = None
        self._started_at: Optional[int] = None
        self._dir: Optional[str] = None
        self._last_stop_t: Optional[float] = None
        self._prof = None
        self.captures = 0
        self.disabled = False  # a failing profiler disables the rest

    # ------------------------------------------------------------------
    def _pulse(self, kind: str, iteration: int, **detail) -> None:
        if self.hub is None:
            return
        try:
            self.hub.pulse(kind, iteration=iteration, **detail)
        except Exception:  # auditing must not break the capture
            pass

    @property
    def active(self) -> bool:
        return self._started_at is not None

    def arm(self, reason: str, iteration: int = 0) -> bool:
        """Request a capture window; returns True when armed. Denied
        (quietly — the caller may be a signal-driven retry loop) when
        already armed/active, over budget, inside the rate-limit
        window, or after a profiler failure."""
        if self.disabled or self._armed_reason is not None or self.active:
            return False
        if self.captures >= self.max_captures:
            return False
        if (self._last_stop_t is not None
                and self._clock() - self._last_stop_t < self.min_interval_s):
            return False
        self._armed_reason = str(reason)
        self._pulse("capture_armed", iteration, reason=self._armed_reason)
        return True

    def maybe_start(self, iteration: int) -> bool:
        """Open the window if one is armed (loop calls this right
        before the iteration's device work)."""
        if self._armed_reason is None or self.active or self.disabled:
            return False
        d = os.path.join(self.root, f"capture{self.captures + 1:02d}")
        try:
            os.makedirs(d, exist_ok=True)
            self._prof = _start_profiler(d)
        except Exception as e:
            self.disabled = True
            reason, self._armed_reason = self._armed_reason, None
            self._pulse(
                "capture_failed", iteration, reason=reason,
                error=f"{type(e).__name__}: {e}"[:200],
            )
            return False
        self._started_at = int(iteration)
        self._dir = d
        self._pulse("capture_start", iteration,
                    reason=self._armed_reason, trace_dir=d)
        return True

    def maybe_stop(self, iteration: int, *, force: bool = False) -> bool:
        """Close the window once it has covered ``window_iterations``
        completed iterations (loop calls this after each boundary);
        ``force`` closes it immediately (end of run)."""
        if not self.active:
            return False
        covered = int(iteration) - (self._started_at or 0) + 1
        if not force and covered < self.window_iterations:
            return False
        trace_dir = self._dir
        reason = self._armed_reason
        self._armed_reason = None
        self._started_at = None
        self._dir = None
        prof, self._prof = self._prof, None
        try:
            _stop_profiler(prof, trace_dir)
        except Exception as e:
            self.disabled = True
            self._pulse(
                "capture_failed", iteration, reason=reason,
                error=f"{type(e).__name__}: {e}"[:200],
            )
            return False
        self.captures += 1
        self._last_stop_t = self._clock()
        files = self.trace_files(trace_dir)
        self._pulse(
            "capture_stop", iteration, reason=reason,
            trace_dir=trace_dir, iterations=max(covered, 0),
            files=len(files),
            bytes=sum(os.path.getsize(f) for f in files),
        )
        return True

    def close(self, iteration: int = 0) -> None:
        """Force-stop any open window (run teardown): an abandoned session
        would leave the profiler running and the trace unwritten."""
        self.maybe_stop(iteration, force=True)

    @staticmethod
    def trace_files(trace_dir: Optional[str]) -> List[str]:
        """Every file the profiler wrote under one capture directory."""
        if not trace_dir:
            return []
        return sorted(
            p for p in glob.glob(
                os.path.join(trace_dir, "**", "*"), recursive=True)
            if os.path.isfile(p)
        )


class SignalArm:
    """SIGUSR2 → "arm a capture" flag for a live process.

    As in shield/signals.py, the handler body only sets a
    ``threading.Event`` — no device calls, no IO. The
    search loop polls ``consume()`` at iteration boundaries and does
    the actual arming there. Install is main-thread-only (a Python
    limitation); a worker-thread search simply runs without the signal
    surface — the other arming paths still work.
    """

    def __init__(self, signum: int = signal.SIGUSR2) -> None:
        self.signum = signum
        self._flag = threading.Event()
        self._prev = None
        self.installed = False

    def _on_signal(self, signum, frame) -> None:
        self._flag.set()

    def install(self) -> "SignalArm":
        if self.installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self
        try:
            self._prev = signal.signal(self.signum, self._on_signal)
            self.installed = True
        except (ValueError, OSError, AttributeError):
            self._prev = None
        return self

    def uninstall(self) -> None:
        if not self.installed:
            return
        if threading.current_thread() is threading.main_thread():
            try:
                signal.signal(self.signum, self._prev)
            except (ValueError, OSError, TypeError):
                pass
        self.installed = False
        self._flag.clear()

    def consume(self) -> bool:
        """True once per delivered signal."""
        if self._flag.is_set():
            self._flag.clear()
            return True
        return False
