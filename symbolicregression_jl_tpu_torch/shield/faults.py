"""Deterministic fault injection: the harness the recovery tests drive.

Port of ``symbolicregression_jl_tpu/shield/faults.py``, the search's
faults and the serve layer's (``ServeFaultPlan``/``ServeFaultInjector``:
kill the server at the k-th request start, corrupt the n-th journal
record, cancel a request mid-flight). Every recovery path is
pinned by injecting the fault it exists for, at an exact, reproducible
point in the search:

- ``raise_on_dispatch=n``: the n-th supervised iteration attempt raises
  :class:`InjectedFault` (its message carries "CUDA out of memory",
  ``RESOURCE_EXHAUSTED`` or any marker you choose, so the classifier and
  the degradation ladder take their production paths). ``raise_count``
  consecutive attempts fail, then the fault clears and a retry succeeds.
- ``sigterm_at_iteration=k``: a real SIGTERM to this process at the end
  of iteration k (the PreemptionGuard path, end to end).
- ``nan_poison_island=(i, k)``: at the end of iteration k, island i's
  constants, costs and losses become NaN: a real NaN storm (re-scoring
  the poisoned members stays NaN), which the quarantine must detect and
  reseed.
- ``hang_on_dispatch=(n, seconds)``: the n-th supervised attempt blocks
  that long inside its watchdog phase, a stand-in for a hung kernel.
- checkpoint corruption helpers (:func:`truncate_file`, :func:`flip_byte`)
  for the digest check and the rolling fallback.

Injection is process-local: tests call :func:`install`; headless runs set
``SR_FAULT_PLAN`` to the plan as JSON. The search loop asks
:func:`active_injector` once per search. No injector, no overhead.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Optional, Tuple

__all__ = ["FaultPlan", "FaultInjector", "InjectedFault", "install", "clear",
           "active_injector", "poison_island", "truncate_file", "flip_byte",
           "ServeFaultPlan", "ServeFaultInjector", "install_serve", "clear_serve",
           "active_serve_injector"]


class InjectedFault(RuntimeError):
    """An injected device failure. Its message is what the classifier
    reads (shield/degrade.py matches markers in the text, as it does for
    a real CUDA error)."""


@dataclasses.dataclass
class FaultPlan:
    """A deterministic schedule of faults for one search."""

    # The n-th supervised iteration attempt (1-based, counted across
    # outputs) raises.
    raise_on_dispatch: Optional[int] = None
    raise_count: int = 1
    raise_message: str = "RESOURCE_EXHAUSTED: injected device OOM"
    # A real SIGTERM to this process at the end of iteration k (1-based).
    sigterm_at_iteration: Optional[int] = None
    # (island, iteration): poison island i at the end of iteration k.
    nan_poison_island: Optional[Tuple[int, int]] = None
    # (attempt, seconds): the n-th supervised attempt blocks that long
    # inside its watchdog phase, so an armed deadline fires.
    hang_on_dispatch: Optional[Tuple[int, float]] = None

    @staticmethod
    def from_json(text: str) -> "FaultPlan":
        d = json.loads(text)
        for name in ("nan_poison_island", "hang_on_dispatch"):
            if d.get(name) is not None:
                d[name] = tuple(d[name])
        return FaultPlan(**d)


class FaultInjector:
    """Stateful executor of a :class:`FaultPlan` for one search run."""

    def __init__(self, plan: FaultPlan, telemetry=None) -> None:
        self.plan = plan
        self.telemetry = telemetry
        self.dispatches = 0
        self.injected = []  # audit trail of (kind, detail) tuples

    def _record(self, kind: str, iteration: int, **detail) -> None:
        self.injected.append((kind, detail))
        if self.telemetry is not None:
            self.telemetry.fault("injected", iteration=iteration, fault=kind, **detail)

    def on_dispatch(self, iteration: int) -> None:
        """Called at the start of each supervised iteration attempt."""
        self.dispatches += 1
        p = self.plan
        if p.hang_on_dispatch is not None:
            at, seconds = p.hang_on_dispatch
            if self.dispatches == at:
                self._record("hang_on_dispatch", iteration, dispatch=self.dispatches,
                             seconds=float(seconds))
                time.sleep(float(seconds))
        if p.raise_on_dispatch is None:
            return
        first = p.raise_on_dispatch
        if first <= self.dispatches < first + p.raise_count:
            self._record("raise_on_dispatch", iteration, dispatch=self.dispatches)
            raise InjectedFault(p.raise_message)

    def on_iteration_end(self, iteration: int, states: list) -> list:
        """Called after iteration ``iteration``'s device work landed."""
        p = self.plan
        if p.nan_poison_island is not None:
            island, at_it = p.nan_poison_island
            if iteration == at_it:
                self._record("nan_poison_island", iteration, island=island)
                states = [poison_island(s, island) for s in states]
        if p.sigterm_at_iteration == iteration:
            self._record("sigterm", iteration)
            os.kill(os.getpid(), signal.SIGTERM)
        return states


def poison_island(state, island: int):
    """A NaN storm on one island of a ``SearchDeviceState``: constants,
    costs and losses all NaN, so even a full-dataset re-score of the
    poisoned members stays non-finite. New tensors: the input state is
    left as it was."""
    pops = state.pops

    def nan_at(t):
        out = t.clone()
        out[island] = float("nan")
        return out

    trees = dataclasses.replace(pops.trees, const=nan_at(pops.trees.const))
    pops = dataclasses.replace(pops, trees=trees, cost=nan_at(pops.cost), loss=nan_at(pops.loss))
    return dataclasses.replace(state, pops=pops)


# ---------------------------------------------------------------------------
# Service-level faults (graftserve, docs/SERVING.md)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeFaultPlan:
    """A deterministic schedule of *service-level* faults for one
    graftserve process — the request-fleet analogue of
    :class:`FaultPlan` (which schedules faults inside one search).

    Driven by the serve tests and ``chip_smoke.py`` phase 32; headless
    runs set ``SR_SERVE_FAULT_PLAN`` to the plan as JSON, exactly like
    ``SR_FAULT_PLAN``.
    """

    # Deliver kill_signal to this process when the k-th accepted
    # request STARTS running (1-based) — the kill-restart-replay
    # scenario: the journal + per-request shield checkpoints must make
    # a restarted server finish every accepted request bit-identically.
    kill_server_at_request: Optional[int] = None
    kill_signal: str = "SIGTERM"
    # Flip one byte inside the n-th appended journal record (1-based),
    # right after it is written — pins the per-record sha256
    # verification + skip-and-audit replay path.
    corrupt_journal_record: Optional[int] = None
    # (k-th accepted request 1-based, iteration): cancel that request
    # while its search is mid-flight, honored at the next iteration
    # boundary — the cancel-mid-iteration scenario.
    cancel_request_at_iteration: Optional[Tuple[int, int]] = None
    # Smoke-driver knob: number of extra storm submissions thrown at a
    # saturated queue to pin the structured-reject path (consumed by a
    # smoke driver, not by the injector hooks).
    queue_overflow_storm: Optional[int] = None

    @staticmethod
    def from_json(text: str) -> "ServeFaultPlan":
        d = json.loads(text)
        if d.get("cancel_request_at_iteration") is not None:
            d["cancel_request_at_iteration"] = tuple(
                d["cancel_request_at_iteration"])
        return ServeFaultPlan(**d)


class ServeFaultInjector:
    """Stateful executor of a :class:`ServeFaultPlan` for one server."""

    def __init__(self, plan: ServeFaultPlan, telemetry=None) -> None:
        self.plan = plan
        self.telemetry = telemetry
        self.journal_records = 0
        self.injected = []  # audit trail of (kind, detail) tuples

    def _record(self, kind: str, **detail) -> None:
        self.injected.append((kind, detail))
        if self.telemetry is not None:
            try:
                d = dict(detail)
                # pop: request_id is serve()'s positional arg — passing
                # it again via ** would TypeError and lose the audit
                rid = d.pop("request_id", "")
                self.telemetry.serve("injected", rid, fault=kind, **d)
            except Exception:  # pragma: no cover - audit is best-effort
                pass

    # -- hook: a request transitioned queued -> running -----------------
    def on_request_start(self, index: int, request_id: str) -> None:
        p = self.plan
        if p.kill_server_at_request is not None and (
                index == p.kill_server_at_request):
            self._record("kill_server", request_id=request_id, index=index,
                         signal=p.kill_signal)
            os.kill(os.getpid(), getattr(signal, p.kill_signal))

    # -- hook: one record was appended to the request journal -----------
    def on_journal_append(self, path: str, record_index: int,
                          offset: int, length: int) -> None:
        p = self.plan
        self.journal_records = record_index
        if p.corrupt_journal_record is not None and (
                record_index == p.corrupt_journal_record):
            self._record("corrupt_journal", record=record_index, path=path)
            # flip a byte in the middle of the record's payload (past
            # the opening brace, before the trailing newline)
            flip_byte(path, offset + max(length // 2, 1))

    # -- hook: per-iteration probe of a running request's search --------
    def should_cancel(self, index: int, iteration: int,
                      request_id: str = "") -> bool:
        p = self.plan
        if p.cancel_request_at_iteration is None:
            return False
        k, at_it = p.cancel_request_at_iteration
        if index == k and iteration >= at_it:
            self._record("cancel_request", request_id=request_id,
                         index=index, iteration=iteration)
            return True
        return False


# ---------------------------------------------------------------------------
# Checkpoint corruption helpers (tests and the chip smoke run)
# ---------------------------------------------------------------------------


def truncate_file(path: str, keep_fraction: float = 0.5) -> None:
    size = os.path.getsize(path)
    with open(path, "rb+") as f:
        f.truncate(max(int(size * keep_fraction), 0))


def flip_byte(path: str, offset: int = -64) -> None:
    """XOR one byte (negative offsets index from the end, where the
    payload bytes, not the envelope header, live)."""
    size = os.path.getsize(path)
    pos = offset % size
    with open(path, "rb+") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))


# ---------------------------------------------------------------------------
# Process-local installation
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultInjector] = None
_ACTIVE_SERVE: Optional[ServeFaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    global _ACTIVE
    _ACTIVE = injector
    return injector


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


def install_serve(injector: ServeFaultInjector) -> ServeFaultInjector:
    global _ACTIVE_SERVE
    _ACTIVE_SERVE = injector
    return injector


def clear_serve() -> None:
    global _ACTIVE_SERVE
    _ACTIVE_SERVE = None


def active_serve_injector(telemetry=None) -> Optional[ServeFaultInjector]:
    """The serve injector the current server should consult: an
    installed one, else one built from ``SR_SERVE_FAULT_PLAN`` (JSON)
    if set, else None."""
    if _ACTIVE_SERVE is not None:
        if telemetry is not None and _ACTIVE_SERVE.telemetry is None:
            _ACTIVE_SERVE.telemetry = telemetry
        return _ACTIVE_SERVE
    env = os.environ.get("SR_SERVE_FAULT_PLAN")
    if env:
        return ServeFaultInjector(
            ServeFaultPlan.from_json(env), telemetry=telemetry)
    return None


def active_injector(telemetry=None) -> Optional[FaultInjector]:
    """The injector the current search should consult: an installed one,
    else one built from ``SR_FAULT_PLAN`` (JSON) if set, else None."""
    if _ACTIVE is not None:
        if telemetry is not None and _ACTIVE.telemetry is None:
            _ACTIVE.telemetry = telemetry
        return _ACTIVE
    env = os.environ.get("SR_FAULT_PLAN")
    if env:
        return FaultInjector(FaultPlan.from_json(env), telemetry=telemetry)
    return None
