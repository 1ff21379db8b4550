"""The flight recorder: last-K-iterations evidence, dumped on faults (a
copy of the JAX package's ``pulse/recorder.py``; a bundle the port writes
validates under both packages' ``validate_bundle``).

A bounded in-memory ring of the most recent iterations (device
counters + host timings) and out-of-band events, held by the process
that is about to die or go wrong. Registered with the telemetry hub
twice — as a sink (``on_iteration``) for the per-iteration view and as
a watcher (``on_event``) for fault/mesh/anomaly/pulse events — so a
shield watchdog timeout, an island quarantine, or an injected fault
triggers a bundle dump BEFORE the watchdog's process abort
(``os._exit(124)``) can discard the evidence; the search loop dumps
once more from its ``finally`` when the run is exiting on an error.

Bundle layout (``graftpulse.bundle.v1``, one JSON object):

- everything OUTSIDE the ``wall`` subtree is deterministic given the
  seed and fault plan — iteration numbers, eval counts, device
  counters, the (event, kind, iteration) timeline — which is what makes
  the dump byte-stable across two identical runs (pinned in
  tests/test_torch_diagnostics.py) and therefore diffable;
- ``wall`` holds everything wall-clock: timings, rates, and the full
  raw events (whose details may carry elapsed times and paths).

``bundle_fingerprint`` hashes the deterministic view; two runs of the
same plan produce the same fingerprint.
"""

from __future__ import annotations

import collections
import hashlib
import json
import math
import os
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "BUNDLE_SCHEMA",
    "FlightRecorder",
    "bundle_fingerprint",
    "deterministic_view",
    "validate_bundle",
]

BUNDLE_SCHEMA = "graftpulse.bundle.v1"

# event types whose arrival triggers a dump (the "something is wrong"
# funnel — every shield recovery path emits a fault event)
_DUMP_TRIGGERS = ("fault",)

# anomaly metrics that ALSO trigger a dump: most anomalies arm a
# profiler capture instead (slow != dying), but the graftgauge leak
# tripwire wants the bundle — its deterministic memory snapshots ARE
# the leak evidence, and a leak that later OOMs may take the process
# with it before any fault event fires
_DUMP_ANOMALY_METRICS = ("live_bytes_growth",)


def _finite(x) -> Optional[float]:
    try:
        v = float(x)
    except (TypeError, ValueError):
        return None
    return v if math.isfinite(v) else None


class FlightRecorder:
    """Bounded ring of recent iterations + events; see module docstring.

    Host-side only: every value recorded was already materialized by
    the search loop or the hub — no device access, no extra transfers,
    nothing fed back into the search (bit-neutral by construction).
    """

    def __init__(
        self,
        *,
        capacity: int = 32,
        path: Optional[str] = None,
        run_id: str = "",
        hub=None,
        event_capacity: int = 64,
        max_dumps: int = 16,
    ) -> None:
        self.capacity = max(int(capacity), 1)
        self.path = path
        self.run_id = run_id
        self.hub = hub
        self.max_dumps = int(max_dumps)
        self.dumps = 0
        # ring slots: (deterministic record, wall-clock record)
        self._iters: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._events: collections.deque = collections.deque(
            maxlen=max(int(event_capacity), 1))
        # graftgauge hookup (attribute, not a constructor arg or
        # import — pulse stays gauge-free): when a MemorySampler is
        # wired, it points this at its deterministic_snapshot and the
        # per-iteration records gain a baseline-relative "memory" view
        # (docs/OBSERVABILITY.md "Capacity & memory"). Deltas, not
        # absolutes, so the bundle byte-stability contract holds: what
        # the RUN allocated is reproducible; what the process already
        # held is not.
        self.memory_provider: Optional[Any] = None

    # -- hub sink protocol ---------------------------------------------
    def on_iteration(self, ctx) -> None:
        memory = None
        if self.memory_provider is not None:
            try:
                memory = self.memory_provider()
            except Exception:  # observation must never break the ring
                memory = None
        det = {
            "iteration": int(ctx.iteration),
            "num_evals": float(ctx.num_evals),
            "best_loss": _finite(ctx.best_loss),
            # device counters ride along when the JSONL stream already
            # pulled them (hub.iteration); None otherwise — the
            # recorder never adds a transfer of its own
            "counters": list(ctx.counters) if ctx.counters else None,
            "memory": memory,
        }
        wall = {
            "iteration": int(ctx.iteration),
            "elapsed_s": float(ctx.elapsed),
            "evals_per_sec": float(ctx.evals_per_sec),
            "device_s": float(ctx.device_s),
            "host_s": float(ctx.host_s),
            "host_fraction": float(ctx.host_fraction),
        }
        self._iters.append((det, wall))

    # -- hub watcher protocol ------------------------------------------
    def on_event(self, event: Dict[str, Any]) -> None:
        """Observe one out-of-band hub event (fault/mesh/anomaly/pulse);
        a fault triggers an immediate dump — it may be the last thing
        this process ever does (watchdog abort)."""
        self._events.append(dict(event))
        if event.get("event") in _DUMP_TRIGGERS:
            self.dump(trigger={
                "reason": "fault",
                "kind": event.get("kind"),
                "iteration": event.get("iteration", 0),
            })
        elif (event.get("event") == "anomaly"
              and event.get("metric") in _DUMP_ANOMALY_METRICS):
            self.dump(trigger={
                "reason": "anomaly",
                "kind": event.get("metric"),
                "iteration": event.get("iteration", 0),
            })

    # ------------------------------------------------------------------
    def _trace_dict(self) -> Optional[Dict[str, Any]]:
        # graftledger trace context rides in from the hub (same ids the
        # JSONL stream stamps); deterministic given the request/run, so
        # it lives OUTSIDE wall and survives into the fingerprint
        trace = getattr(self.hub, "trace", None)
        if trace is None:
            return None
        try:
            return trace.to_dict()
        except Exception:
            return None

    def snapshot(self, trigger: Dict[str, Any]) -> Dict[str, Any]:
        """The bundle dict (see module docstring for the layout)."""
        det_iters = [d for d, _ in self._iters]
        wall_iters = [w for _, w in self._iters]
        events_det = []
        events_wall = []
        for e in self._events:
            events_det.append({
                "event": e.get("event"),
                "kind": e.get("kind", e.get("metric")),
                "iteration": e.get("iteration", 0),
            })
            events_wall.append(e)
        trig = dict(trigger)
        trig.setdefault("reason", "manual")
        return {
            "schema": BUNDLE_SCHEMA,
            "run_id": self.run_id,
            "trace": self._trace_dict(),
            "ring_capacity": self.capacity,
            "dump_seq": self.dumps + 1,
            "trigger": {k: trig[k] for k in sorted(trig)
                        if k != "wall" and trig[k] is not None},
            "iterations": det_iters,
            "events": events_det,
            "wall": {
                "iterations": wall_iters,
                "events": events_wall,
            },
        }

    def dump(self, *, trigger: Dict[str, Any],
             path: Optional[str] = None) -> Optional[str]:
        """Write the bundle; returns its path (None when pathless or
        over the dump budget). Never raises — the dump rides failure
        paths and must not mask the failure it documents."""
        target = path or self.path
        if target is None or self.dumps >= self.max_dumps:
            return None
        bundle = self.snapshot(trigger)
        try:
            d = os.path.dirname(target)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(target, "w") as f:
                json.dump(bundle, f, sort_keys=True, indent=1)
                f.write("\n")
        except OSError:
            return None
        self.dumps += 1
        if self.hub is not None:
            try:
                self.hub.pulse(
                    "bundle_dump",
                    iteration=int(bundle["trigger"].get("iteration", 0)),
                    reason=bundle["trigger"].get("reason"),
                    # "kind" would collide with pulse()'s own kind arg
                    trigger_kind=bundle["trigger"].get("kind"),
                    path=target,
                )
            except Exception:  # auditing must not mask the failure
                pass
        return target


# ---------------------------------------------------------------------------
# bundle consumers (tests, pulse_smoke, report tooling)
# ---------------------------------------------------------------------------


def deterministic_view(bundle: Dict[str, Any]) -> Dict[str, Any]:
    """The bundle minus its wall-clock subtree and dump ordinal — the
    part that is byte-stable across identical runs."""
    out = {k: v for k, v in bundle.items() if k not in ("wall", "dump_seq")}
    return out


def bundle_fingerprint(path: str) -> str:
    """sha256 over the canonical encoding of the deterministic view."""
    with open(path) as f:
        bundle = json.load(f)
    blob = json.dumps(deterministic_view(bundle), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


_REQUIRED: Tuple[Tuple[str, type], ...] = (
    ("schema", str),
    ("run_id", str),
    ("ring_capacity", int),
    ("dump_seq", int),
    ("trigger", dict),
    ("iterations", list),
    ("events", list),
    ("wall", dict),
)


def validate_bundle(bundle: Any) -> List[str]:
    """Table-driven bundle check; returns violation strings (empty =
    valid) — the same hand-rolled style telemetry/schema.py uses."""
    if not isinstance(bundle, dict):
        return [f"bundle is {type(bundle).__name__}, expected object"]
    errors: List[str] = []
    if bundle.get("schema") != BUNDLE_SCHEMA:
        errors.append(
            f"schema is {bundle.get('schema')!r}, expected {BUNDLE_SCHEMA!r}")
    for name, typ in _REQUIRED:
        if name not in bundle:
            errors.append(f"missing field {name!r}")
        elif not isinstance(bundle[name], typ) or (
                typ is int and isinstance(bundle[name], bool)):
            errors.append(
                f"field {name!r} has type {type(bundle[name]).__name__}, "
                f"expected {typ.__name__}")
    for i, rec in enumerate(bundle.get("iterations") or []):
        if not isinstance(rec, dict) or "iteration" not in rec:
            errors.append(f"iterations[{i}]: not an iteration record")
    for i, ev in enumerate(bundle.get("events") or []):
        if not isinstance(ev, dict) or "event" not in ev:
            errors.append(f"events[{i}]: not an event record")
    wall = bundle.get("wall")
    if isinstance(wall, dict):
        for name in ("iterations", "events"):
            if not isinstance(wall.get(name), list):
                errors.append(f"wall.{name}: missing/not a list")
    return errors
