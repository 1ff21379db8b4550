"""graftwarden's runtime side — lock-order auditing and race replay
(port of ``lint/racecheck.py``).

The static analyzer (:mod:`.concurrency`, GL010) derives the lock
acquisition graph on paper; this module checks it against *execution*:

- :class:`InstrumentedLock` wraps any ``threading.Lock/RLock`` behind the
  same acquire/release/context-manager surface (including the private
  ``_release_save``/``_acquire_restore``/``_is_owned`` protocol
  ``threading.Condition`` uses, so ``SearchServer._cond`` keeps working
  over the wrapped lock).
- :class:`LockRecorder` keeps a per-thread held-lock stack and the global
  set of observed acquisition edges; with ``assert_order=True`` every
  acquisition is checked against the blessed :mod:`.lock_order` manifest
  *before* the inner lock is taken, raising :class:`LockOrderViolation`
  (an ``AssertionError``, the debug tier of lint/runtime.py) on an
  inversion.
- :class:`RacePlan` injects deterministic context-switch windows at
  named lock boundaries. Activate it with :func:`install_race_plan` or
  the ``SR_RACE_PLAN`` environment variable (JSON, like
  ``SR_FAULT_PLAN`` / ``SR_SERVE_FAULT_PLAN`` in shield/faults.py)::

      {"windows": [{"lock": "RequestJournal._lock", "op": "acquire",
                    "caller": "submit", "nth": 1, "pause_s": 0.8}]}

  The ``nth`` matching acquire (or release) of the named lock whose
  thread stack contains ``caller`` pauses for ``pause_s`` seconds, long
  enough for the interfering operation to land in the window. Each
  window fires once and exposes an ``entered`` event scenarios wait on,
  so the interleaving is *scheduled*, not raced.
- :func:`instrument_server` swaps every serve/shield lock of a
  :class:`~..serve.server.SearchServer`, and the process-wide locks its
  tenants share (the kernel wrappers', the library build's, the bf16 and
  weighted-rows caches'), for instrumented wrappers
  (``SearchServer(..., debug_checks=True)`` or ``SR_RACECHECK=1`` does
  this at construction).
- :data:`SCENARIOS` replays three races of the serving stack, each as
  current-code-passes / reverted-shim-fails.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import lock_order

__all__ = [
    "InstrumentedLock",
    "LockOrderViolation",
    "LockRecorder",
    "RacePlan",
    "RaceWindow",
    "SCENARIOS",
    "active_race_plan",
    "clear_race_plan",
    "global_recorder",
    "install_race_plan",
    "instrument_server",
    "replay_scenario",
]


class LockOrderViolation(AssertionError):
    """An actual acquisition inverted the blessed lock order."""


# ---------------------------------------------------------------------------
# recorder
# ---------------------------------------------------------------------------


class LockRecorder:
    """Per-thread held-lock stacks + the observed global edge set."""

    def __init__(self) -> None:
        self._tls = threading.local()
        self._meta = threading.Lock()  # guards .edges only
        self.edges: Dict[tuple, int] = {}
        self.violations: List[str] = []

    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def held(self) -> List[str]:
        """This thread's held canonical lock names, outermost first."""
        return list(self._stack())

    def before_acquire(self, name: str, assert_order: bool) -> None:
        """Record (and optionally assert) the edges this acquisition
        creates. Called BEFORE the inner lock is taken, so a raised
        violation never leaves the lock held."""
        stack = self._stack()
        for h in stack:
            if h == name:
                continue  # RLock reentrancy
            with self._meta:
                self.edges[(h, name)] = self.edges.get((h, name), 0) + 1
            if assert_order and lock_order.violates(h, name):
                msg = (
                    f"lock-order inversion: acquiring {name!r} while "
                    f"holding {h!r} (thread {threading.current_thread().name};"
                    f" blessed order in lint/lock_order.py sanctions "
                    f"{name!r} before {h!r})"
                )
                with self._meta:
                    self.violations.append(msg)
                raise LockOrderViolation(msg)

    def after_acquire(self, name: str) -> None:
        self._stack().append(name)

    def after_release(self, name: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return


_GLOBAL_RECORDER = LockRecorder()


def global_recorder() -> LockRecorder:
    return _GLOBAL_RECORDER


# ---------------------------------------------------------------------------
# deterministic context-switch windows
# ---------------------------------------------------------------------------


class RaceWindow:
    """One scheduled pause at a named lock boundary."""

    def __init__(self, lock: str, op: str = "acquire",
                 caller: Optional[str] = None, nth: int = 1,
                 pause_s: float = 0.5) -> None:
        if op not in ("acquire", "release"):
            raise ValueError(f"window op must be acquire|release: {op!r}")
        self.lock = lock
        self.op = op
        self.caller = caller
        self.nth = int(nth)
        self.pause_s = float(pause_s)
        self.entered = threading.Event()  # set when the pause begins
        self._count = 0
        self._fired = False

    def to_dict(self) -> Dict[str, Any]:
        return {"lock": self.lock, "op": self.op, "caller": self.caller,
                "nth": self.nth, "pause_s": self.pause_s}


def _caller_in_stack(name: str) -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == name:
            return True
        f = f.f_back
    return False


class RacePlan:
    """A set of one-shot :class:`RaceWindow` pauses."""

    def __init__(self, windows: Sequence[RaceWindow] = ()) -> None:
        self.windows = list(windows)
        self._meta = threading.Lock()

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RacePlan":
        return cls([RaceWindow(**w) for w in d.get("windows", ())])

    @classmethod
    def from_json(cls, s: str) -> "RacePlan":
        return cls.from_dict(json.loads(s))

    def window(self, lock: str, op: str = "acquire") -> Optional[RaceWindow]:
        for w in self.windows:
            if w.lock == lock and w.op == op:
                return w
        return None

    def maybe_pause(self, lock: str, op: str) -> None:
        for w in self.windows:
            if w.lock != lock or w.op != op:
                continue
            with self._meta:
                if w._fired:
                    continue
                if w.caller is not None and not _caller_in_stack(w.caller):
                    continue
                w._count += 1
                if w._count != w.nth:
                    continue
                w._fired = True
            w.entered.set()
            time.sleep(w.pause_s)


_ACTIVE_PLAN: Optional[RacePlan] = None
_ENV_PLAN: Optional[tuple] = None  # (env string, parsed plan)


def install_race_plan(plan: RacePlan) -> RacePlan:
    global _ACTIVE_PLAN
    _ACTIVE_PLAN = plan
    return plan


def clear_race_plan() -> None:
    global _ACTIVE_PLAN, _ENV_PLAN
    _ACTIVE_PLAN = None
    _ENV_PLAN = None


def active_race_plan() -> Optional[RacePlan]:
    """The installed plan, else one parsed from ``SR_RACE_PLAN`` (JSON)
    if set, else None. The env parse is cached on the raw string so the
    windows' one-shot state survives repeated lookups."""
    global _ENV_PLAN
    if _ACTIVE_PLAN is not None:
        return _ACTIVE_PLAN
    env = os.environ.get("SR_RACE_PLAN")
    if not env:
        return None
    if _ENV_PLAN is not None and _ENV_PLAN[0] == env:
        return _ENV_PLAN[1]
    plan = RacePlan.from_json(env)
    _ENV_PLAN = (env, plan)
    return plan


# ---------------------------------------------------------------------------
# the instrumented lock
# ---------------------------------------------------------------------------


class InstrumentedLock:
    """A named wrapper over a ``Lock``/``RLock`` that feeds the
    recorder, honors the active race plan, and forwards the Condition
    lock protocol so ``threading.Condition(wrapped)`` works."""

    def __init__(self, name: str, inner=None, *,
                 recorder: Optional[LockRecorder] = None,
                 assert_order: bool = True) -> None:
        self.name = name
        self.inner = inner if inner is not None else threading.RLock()
        self.recorder = recorder or _GLOBAL_RECORDER
        self.assert_order = assert_order

    # -- plan hook -----------------------------------------------------
    def _pause(self, op: str) -> None:
        plan = active_race_plan()
        if plan is not None:
            plan.maybe_pause(self.name, op)

    # -- lock surface --------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._pause("acquire")
        self.recorder.before_acquire(self.name, self.assert_order)
        got = self.inner.acquire(blocking, timeout)
        if got:
            self.recorder.after_acquire(self.name)
        return got

    def release(self) -> None:
        self.inner.release()
        self.recorder.after_release(self.name)
        self._pause("release")

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- Condition interop (threading.Condition probes these) ----------
    def _release_save(self):
        """Full release for Condition.wait: pop every reentrant hold of
        this lock from the recorder stack, remembering the depth."""
        stack = self.recorder._stack()
        n = stack.count(self.name)
        for _ in range(n):
            self.recorder.after_release(self.name)
        return (self.inner._release_save(), n)

    def _acquire_restore(self, saved) -> None:
        state, n = saved
        self.inner._acquire_restore(state)
        # no order assert: Condition.wait re-acquiring its own lock is
        # the sanctioned wake-up path, not a new nesting decision
        for _ in range(n):
            self.recorder.after_acquire(self.name)

    def _is_owned(self) -> bool:
        return self.inner._is_owned()

    def __repr__(self) -> str:
        return f"InstrumentedLock({self.name!r}, {self.inner!r})"


def _wrap(obj: Any, attr: str, name: str, recorder: LockRecorder,
          assert_order: bool) -> None:
    cur = getattr(obj, attr, None)
    if cur is None or isinstance(cur, InstrumentedLock):
        return
    setattr(obj, attr, InstrumentedLock(
        name, cur, recorder=recorder, assert_order=assert_order))


def instrument_server(server, assert_order: bool = True) -> LockRecorder:
    """Swap every serve/shield lock of a SearchServer, and the kernel
    launch path's process-wide locks, for instrumented wrappers
    (idempotent; the process-wide ones stay wrapped). Returns the
    recorder. Canonical names match lint/lock_order.py's
    MANIFEST_LOCKS."""
    rec = _GLOBAL_RECORDER
    _wrap(server, "_lock", "SearchServer._lock", rec, assert_order)
    # _cond must be a Condition OVER the wrapped lock (same aliasing as
    # the real fabric) — rebuild it if _lock was just wrapped
    if not isinstance(getattr(server._cond, "_lock", None),
                      InstrumentedLock):
        server._cond = threading.Condition(server._lock)
    _wrap(server.admission, "_lock", "AdmissionController._lock",
          rec, assert_order)
    _wrap(server.journal, "_lock", "RequestJournal._lock",
          rec, assert_order)
    _wrap(server.log, "_lock", "ServeLog._lock", rec, assert_order)
    _wrap(server.cache, "_lock", "ExecutableCache._lock",
          rec, assert_order)
    if getattr(server, "metrics", None) is not None:
        _wrap(server.metrics, "_state_lock", "MetricsServer._state_lock",
              rec, assert_order)
    from ..shield import signals as _signals

    _wrap(_signals._STATE, "lock", "_SharedSignalState.lock",
          rec, assert_order)
    # the process-wide locks the tenants' kernel launches take
    from ..ops import cuda_build, fused_eval

    _wrap(cuda_build, "_LOCK", "cuda_build._LOCK", rec, assert_order)
    _wrap(fused_eval, "_BF16_LOCK", "fused_eval._BF16_LOCK", rec, assert_order)
    _wrap(fused_eval, "_WEIGHTED_LOCK", "fused_eval._WEIGHTED_LOCK", rec, assert_order)
    for kernel in list(vars(fused_eval).values()):
        if isinstance(kernel, fused_eval._ProgramKernel):
            _wrap(kernel, "_lock", "_ProgramKernel._lock", rec, assert_order)
    return rec


# ---------------------------------------------------------------------------
# three races of the serving stack, replayed deterministically
# ---------------------------------------------------------------------------
#
# Each scenario returns {"name", "ok", "detail"...}: ok=True means the
# CURRENT code held its invariant under the scheduled interleaving.
# shim=True swaps in a minimal revert of the historical fix — the same
# plan must then flip ok to False, proving the window actually lands on
# the fixed line (a replay that passes either way pins nothing).


def _mini_problem():
    import numpy as np

    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 2)).astype(np.float32)
    y = (X[:, 0] * 2.0 + X[:, 1]).astype(np.float32)
    return X, y


_FAST_OPTIONS = dict(
    binary_operators=["+", "*"], unary_operators=[], maxsize=8,
    populations=2, population_size=8, ncycles_per_iteration=2,
    tournament_selection_n=4, optimizer_probability=0.0,
)


def _set_plan(plan_dict: Dict[str, Any]) -> RacePlan:
    os.environ["SR_RACE_PLAN"] = json.dumps(plan_dict)
    clear_race_plan()
    plan = active_race_plan()
    assert plan is not None
    return plan


def _clear_plan_env() -> None:
    os.environ.pop("SR_RACE_PLAN", None)
    clear_race_plan()


def _scenario_cancel_vs_submit(root: str, shim: bool, device=None) -> Dict[str, Any]:
    """A cancel racing submit's UNLOCKED journal append.

    The fix: cancel() defers its journal write until the submit record
    is durable (rec.journaled), and submit's publish step finalizes a
    deferred cancel — so the journal can never order `cancel` before
    its `submit` (replay drops lifecycle records preceding their
    submit, resurrecting the request). The window pauses submit at the
    journal-lock boundary with the record still un-journaled; the
    cancel lands inside that window.
    """
    from ..serve import server as _srvmod
    from ..serve.server import SearchServer

    plan = _set_plan({"windows": [{
        "lock": "RequestJournal._lock", "op": "acquire",
        "caller": "submit", "nth": 1, "pause_s": 1.5,
    }]})
    window = plan.windows[0]
    orig_cancel = SearchServer.cancel
    try:
        if shim:
            def _old_cancel(self, request_id, reason="cancelled"):
                # pre-fix behavior: journal the cancel IMMEDIATELY, no
                # journaled/deferred-finalize handshake with submit
                with self._lock:
                    rec = self._records.get(request_id)
                    if rec is None:
                        raise KeyError(request_id)
                    if rec.state in _srvmod._TERMINAL:
                        return False
                    rec.cancel(reason)
                    finalize = rec.state == "queued"
                    if finalize:
                        rec.state = "cancelled"
                        rec.finished_t = time.time()
                        self.admission.release(rec.request.bucket)
                        rec.cancel_event.clear()
                if finalize:
                    self._journal_cancel(rec, where="queued")
                return True

            SearchServer.cancel = _old_cancel

        X, y = _mini_problem()
        srv = SearchServer(root, capacity=4, workers=0,
                           debug_checks=True, device=device)
        err = None
        rid = "race1"

        def _submit():
            nonlocal err
            try:
                srv.submit(X, y, options=dict(_FAST_OPTIONS),
                           niterations=1, request_id=rid)
            except BaseException as e:  # surfaced in detail
                err = e

        t = threading.Thread(target=_submit, name="race1-submit")
        t.start()
        # deterministic: wait until submit is INSIDE the journal-append
        # window (record registered, not yet durable), then cancel
        if not window.entered.wait(timeout=10.0):
            t.join(timeout=5.0)
            return {"name": "cancel_vs_submit", "ok": False,
                    "detail": "race window never entered"}
        srv.cancel(rid)
        t.join(timeout=10.0)
        if err is not None:
            return {"name": "cancel_vs_submit", "ok": False,
                    "detail": f"submit raised: {err!r}"}

        recs, _ = srv.journal.replay()
        seqs = {}
        for r in recs:
            key = (r["event"], r["request_id"])
            seqs.setdefault(key, r["seq"])
        submit_seq = seqs.get(("submit", rid))
        cancel_seq = seqs.get(("cancel", rid))
        ordered = (submit_seq is not None and cancel_seq is not None
                   and submit_seq < cancel_seq)

        # the authoritative probe: a restarted server must see the
        # request as terminally cancelled, not resurrect it as queued
        srv2 = SearchServer(root, capacity=4, workers=0, device=device)
        state = srv2.poll(rid)["state"]
        ok = ordered and state == "cancelled"
        return {"name": "cancel_vs_submit", "ok": ok,
                "detail": {"submit_seq": submit_seq,
                           "cancel_seq": cancel_seq,
                           "replayed_state": state}}
    finally:
        SearchServer.cancel = orig_cancel
        _clear_plan_env()


def _scenario_cancel_overlapping_preemption(root: str, shim: bool,
                                            device=None) -> Dict[str, Any]:
    """A client cancel landing in the preemption window.

    The fix: a terminal cancel OVERRIDES a pending "preempted" reason
    (_RequestRecord.cancel), and the requeue path re-checks the reason
    under the lock — otherwise the requeue resurrects a cancelled
    request, which later completes as "done". The window pauses the
    worker at its requeue-lock boundary; the client cancel lands inside
    it.
    """
    from ..serve import server as _srvmod
    from ..serve.server import SearchServer, _RequestRecord

    plan = _set_plan({"windows": [{
        "lock": "SearchServer._lock", "op": "acquire",
        "caller": "_run_request", "nth": 1, "pause_s": 2.0,
    }]})
    window = plan.windows[0]
    orig_cancel = _RequestRecord.cancel
    try:
        if shim:
            def _old_rec_cancel(self, reason="cancelled"):
                # pre-fix behavior: first reason sticks, so "preempted"
                # can never be overridden by a terminal client cancel
                if self.cancel_reason is None:
                    self.cancel_reason = reason
                self.cancel_event.set()

            _RequestRecord.cancel = _old_rec_cancel

        X, y = _mini_problem()
        srv = SearchServer(root, capacity=4, workers=1,
                           debug_checks=True, device=device).start()
        rid = srv.submit(X, y, options=dict(_FAST_OPTIONS),
                         niterations=50, seed=0)
        deadline = time.monotonic() + 30.0
        while (srv.poll(rid)["state"] != "running"
               and time.monotonic() < deadline):
            time.sleep(0.01)
        if srv.poll(rid)["state"] != "running":
            srv.stop(drain=False, timeout=5.0)
            return {"name": "cancel_overlapping_preemption", "ok": False,
                    "detail": "request never started"}

        # preempt (not drain): the worker exits its search at the next
        # iteration boundary and walks into the requeue window
        stopper = threading.Thread(
            target=lambda: srv.stop(drain=False, timeout=30.0),
            name="race2-stop")
        stopper.start()
        if not window.entered.wait(timeout=30.0):
            stopper.join(timeout=30.0)
            return {"name": "cancel_overlapping_preemption", "ok": False,
                    "detail": "race window never entered"}
        # the terminal cancel lands while the worker is parked at the
        # requeue boundary, preemption already decided
        try:
            srv.cancel(rid)
        except KeyError:
            pass
        stopper.join(timeout=30.0)
        snap = srv.poll(rid)
        ok = (snap["state"] == "cancelled"
              and snap["cancel_reason"] == "cancelled")
        return {"name": "cancel_overlapping_preemption", "ok": ok,
                "detail": {"state": snap["state"],
                           "cancel_reason": snap["cancel_reason"]}}
    finally:
        _RequestRecord.cancel = orig_cancel
        _clear_plan_env()


def _scenario_stale_guard_restart(root: str, shim: bool, device=None) -> Dict[str, Any]:
    """A restart after a SIGTERM-drained pool.

    A SIGTERM kills the workers without stop() running, leaving the
    installed PreemptionGuard's shared preempt flag SET. The fix:
    start() detaches the stale guard before attaching a fresh one
    (refcount to 0 clears the flag) — otherwise the new workers observe
    the old signal and exit immediately, and the submitted request
    stays queued forever.
    """
    import signal as _signal

    from ..serve.server import SearchServer
    from ..shield.signals import PreemptionGuard

    # plan kept for uniformity: the pause marks the restart boundary in
    # the recorder timeline (no cross-thread interleaving needed here —
    # the race is stale state, not a window)
    _set_plan({"windows": [{
        "lock": "_SharedSignalState.lock", "op": "acquire",
        "caller": "start", "nth": 1, "pause_s": 0.05,
    }]})
    orig_start = SearchServer.start
    try:
        if shim:
            def _old_start(self):
                with self._lock:
                    self._threads = [
                        t for t in self._threads if t.is_alive()]
                    if self._threads:
                        return self
                    self._stopping = False
                    self._preempting = False
                    # pre-fix behavior: keep whatever guard is already
                    # attached — a SIGTERM-drained pool leaves its
                    # preempt flag set for the new workers
                    if self._guard is None:
                        self._guard = PreemptionGuard().install()
                    for i in range(max(self.workers, 1)):
                        t = threading.Thread(
                            target=self._worker_loop,
                            name=f"graftserve-worker-{i}", daemon=True)
                        t.start()
                        self._threads.append(t)
                if self.metrics is not None and not self.metrics.running:
                    self.metrics.start()
                return self

            SearchServer.start = _old_start

        X, y = _mini_problem()
        srv = SearchServer(root, capacity=4, workers=1,
                           debug_checks=True, device=device)
        (orig_start if shim else SearchServer.start)(srv)
        # simulated preemption notice: the guard's handler sets the
        # shared flag; idle workers drain and die WITHOUT stop()
        os.kill(os.getpid(), _signal.SIGTERM)
        deadline = time.monotonic() + 15.0
        while (any(t.is_alive() for t in srv._threads)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        if any(t.is_alive() for t in srv._threads):
            srv.stop(drain=False, timeout=5.0)
            return {"name": "stale_guard_restart", "ok": False,
                    "detail": "workers survived SIGTERM drain"}

        srv.start()  # the restart under test (shimmed or fixed)
        rid = srv.submit(X, y, options=dict(_FAST_OPTIONS),
                         niterations=1, seed=0)
        snap = srv.wait(rid, timeout=60.0)
        srv.stop(drain=False, timeout=15.0)
        ok = snap["state"] == "done"
        return {"name": "stale_guard_restart", "ok": ok,
                "detail": {"state": snap["state"]}}
    finally:
        SearchServer.start = orig_start
        _clear_plan_env()


SCENARIOS: Dict[str, Callable[..., Dict[str, Any]]] = {
    "cancel_vs_submit": _scenario_cancel_vs_submit,
    "cancel_overlapping_preemption": _scenario_cancel_overlapping_preemption,
    "stale_guard_restart": _scenario_stale_guard_restart,
}


def replay_scenario(name: str, root: str, shim: bool = False,
                    device=None) -> Dict[str, Any]:
    """Replay one race under its SR_RACE_PLAN schedule.
    ``shim=True`` swaps in the pre-fix behavior (the result's ``ok``
    must then be False — the replay detects the reverted bug). The
    scenario's servers run requests on ``device`` (CUDA unless "cpu")."""
    try:
        fn = SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    return fn(root, shim, device=device)
