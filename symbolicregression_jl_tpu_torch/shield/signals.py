"""Preemption signal capture: turn SIGTERM/SIGINT into a graceful stop.

Port of ``symbolicregression_jl_tpu/shield/signals.py``. A preemptible or
shared machine's scheduler delivers SIGTERM with a short grace window; a
bare SIGTERM kills the process mid-iteration and loses everything since
the last periodic checkpoint. The guard turns the signal into a flag that
the search loop polls at iteration boundaries; the loop then stops with
``stop_reason="preempted"`` and writes the emergency checkpoint through
its normal end-of-loop path. The state written is exactly the state an
uninterrupted run has at that boundary, which is what makes
``resume="auto"`` bit-identical (tests/test_torch_shield.py).

Signal-handler discipline: the handlers below only record which signal
arrived and set a ``threading.Event``: no torch calls, no device syncs,
no file IO. Everything else (the checkpoint, the fault records) happens
later, on the main thread, at the iteration boundary.

A second SIGINT (the user leaning on ctrl-C while a long iteration runs)
re-raises ``KeyboardInterrupt``, so the process can still be torn down
the classic way. The guard and the search's stdin watcher
(``utils/stdin_quit.py``, a 'q' on stdin) do not overlap: the watcher
reads characters and touches no signal disposition, and a ctrl-C under
the guard is a preemption, not a quit.

Handler installation is reference-counted and the delivered-signal flag
is process-wide. Several searches in one process (nested, or on worker
threads) each attach a guard: the first attach from the main thread
installs the handlers, the last detach restores the previous ones, and a
single SIGTERM is seen by every attached guard at once. A guard attached
from a worker thread cannot install handlers (a Python limitation) but
still sees the shared flag set by a main-thread installation.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Optional

__all__ = ["PreemptionGuard"]


class _SharedSignalState:
    """Process-wide signal bookkeeping shared by every attached guard."""

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.event = threading.Event()
        self.signum: Optional[int] = None
        self.int_count = 0
        self.attached = 0           # live guards (any thread)
        self.handlers_installed = False
        self.prev: dict = {}


_STATE = _SharedSignalState()


# -- handlers (flag-set only; see the module docstring) -------------------
def _chain_unattended(signum) -> bool:
    """A signal arriving while NO guard is attached — possible when the
    last detach ran on a worker thread and handler restoration was
    deferred (see _restore_handlers) — must not be swallowed by the
    flag-only handler: nobody is polling the flag, so the process would
    become silently immune to SIGTERM/SIGINT. Handlers execute on the
    main thread, so restoring the original disposition here is legal;
    re-delivering the signal then gives it pre-guard behavior. Reads
    _STATE without the lock on purpose: a worker holding it would
    deadlock the main thread inside a signal handler, and a racing
    attach at worst sees one chained (i.e. default-behavior) signal."""
    if _STATE.attached > 0:
        return False
    _restore_handlers()
    os.kill(os.getpid(), signum)
    return True


def _on_sigterm(signum, frame) -> None:
    if _chain_unattended(signum):
        return
    _STATE.signum = signum
    _STATE.event.set()


def _on_sigint(signum, frame) -> None:
    if _chain_unattended(signum):
        return
    _STATE.int_count += 1
    _STATE.signum = signum
    _STATE.event.set()
    if _STATE.int_count >= 2:
        raise KeyboardInterrupt


class PreemptionGuard:
    """Attaches to the shared SIGTERM/SIGINT capture for one search.

    ``install``/``uninstall`` are refcounted across all guards in the
    process (see module docstring): handlers are installed once by the
    first main-thread attach and restored by the last detach, so
    concurrent or nested searches never clobber each other's handlers.
    From a non-main thread the attach is passive — no handlers are
    touched, but ``requested`` still reflects signals captured by a
    main-thread installation elsewhere in the process (e.g. the serve
    layer's own guard).
    """

    def __init__(self) -> None:
        self._attached = False

    # -------------------------------------------------------------------
    def install(self) -> "PreemptionGuard":
        with _STATE.lock:
            if self._attached:
                return self
            self._attached = True
            if _STATE.attached == 0:
                # fresh attach cycle: a flag left over from a previous,
                # fully-detached cycle (including one whose handler
                # restore was deferred — see _restore_handlers) must
                # not preempt this search. Clear BEFORE incrementing
                # the refcount: a signal landing in between still sees
                # attached == 0 and chains to the original disposition
                # instead of being recorded and immediately wiped.
                _STATE.event.clear()
                _STATE.signum = None
                _STATE.int_count = 0
            _STATE.attached += 1
            if (
                not _STATE.handlers_installed
                and threading.current_thread() is threading.main_thread()
            ):
                try:
                    _STATE.prev[signal.SIGTERM] = signal.signal(
                        signal.SIGTERM, _on_sigterm)
                    _STATE.prev[signal.SIGINT] = signal.signal(
                        signal.SIGINT, _on_sigint)
                    _STATE.handlers_installed = True
                except (ValueError, OSError):  # non-main interpreters
                    _restore_handlers()
        return self

    def uninstall(self) -> None:
        with _STATE.lock:
            if not self._attached:
                return
            self._attached = False
            _STATE.attached = max(_STATE.attached - 1, 0)
            if _STATE.attached == 0:
                _restore_handlers()
                _STATE.event.clear()
                _STATE.signum = None
                _STATE.int_count = 0

    @property
    def installed(self) -> bool:
        """True when real handlers are live for this attach (installed
        by this guard or by another attached guard in the process)."""
        return self._attached and _STATE.handlers_installed

    # -------------------------------------------------------------------
    @property
    def requested(self) -> bool:
        return _STATE.event.is_set()

    @property
    def signal_name(self) -> Optional[str]:
        if _STATE.signum is None:
            return None
        try:
            return signal.Signals(_STATE.signum).name
        except ValueError:  # pragma: no cover - exotic signum
            return str(_STATE.signum)

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


def _restore_handlers() -> None:
    # Only the main thread may call signal.signal. When the LAST detach
    # happens on a worker thread (e.g. a serve worker's search outlives
    # the server's own guard), restoration is DEFERRED: the saved
    # original handlers stay in _STATE.prev and handlers_installed stays
    # True, so a later attach cycle reuses the installed handlers
    # without re-saving ours as "previous", and the next main-thread
    # last-detach performs the real restore. Clearing prev here would
    # leak our handlers permanently and lose the originals.
    if threading.current_thread() is not threading.main_thread():
        return
    for signum, prev in list(_STATE.prev.items()):
        try:
            signal.signal(signum, prev)
            del _STATE.prev[signum]
        except (ValueError, OSError):  # pragma: no cover
            pass
    if not _STATE.prev:
        _STATE.handlers_installed = False
