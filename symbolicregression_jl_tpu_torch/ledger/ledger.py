"""graftledger cost accounts: per-request, per-phase attribution.

A copy of the JAX package's ``ledger/ledger.py``; an account the port
writes validates under both packages' ``validate_account``. A
:class:`CostLedger` is a telemetry-hub sink (telemetry/hub.py) that
folds what the loop already materializes — per-iteration device/host
seconds, compile seconds (in the port the kernel loads and nvcc builds of
``ops/cuda_build.py``, ``trace_s`` and ``backend_compile_s``), the timed host-phase spans
(telemetry/spans.py observer), checkpoint byte counts — into one
``graftledger.v1`` *account* per search segment, appended to
``<run_dir>/ledger.jsonl``. Append (not truncate, unlike the hub's
stream): a killed-and-resumed request accumulates one account segment
per attempt in the same file, and :func:`fold_accounts` reduces them to
the same deterministic view an uninterrupted run produces.

The deterministic/wall split follows graftpulse's bundles
(pulse/recorder.py): the ``deterministic`` subtree holds only values
that are pure functions of the search content — final iteration count,
final cumulative evals, the stop reason, the trace ids — so
``ledger_fingerprint`` hashes identically across kill-restart-replay.
Everything clocked (device/host/compile seconds, phase timings,
checkpoint bytes — re-saves make even byte counts schedule-dependent)
lives under ``wall``.

Bit-neutrality: the sink only *reads* host-side values; it draws no
RNG and feeds nothing back into the search (pinned by the on/off A/B
in tests/test_torch_diagnostics.py).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from .context import TraceContext

__all__ = [
    "LEDGER_SCHEMA",
    "LATENCY_BUCKETS_S",
    "CostLedger",
    "bucket_latency",
    "validate_account",
    "load_accounts",
    "fold_accounts",
    "ledger_fingerprint",
]

LEDGER_SCHEMA = "graftledger.v1"

# log-spaced iteration-latency bucket upper bounds (seconds); the
# histogram counts one sample per iteration of device_s + host_s.
# Rendered on /metrics as a Prometheus histogram (serve/metrics.py),
# so the last implicit bucket is +Inf.
LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 60.0,
)


def bucket_latency(seconds: float,
                   counts: Optional[List[int]] = None) -> List[int]:
    """Add one sample to a bucket-count list (len = len(bounds)+1, the
    final slot counting samples above the last bound)."""
    if counts is None:
        counts = [0] * (len(LATENCY_BUCKETS_S) + 1)
    for i, le in enumerate(LATENCY_BUCKETS_S):
        if seconds <= le:
            counts[i] += 1
            return counts
    counts[-1] += 1
    return counts


class CostLedger:
    """Hub sink accumulating one account segment for one search.

    Wire-up (api/search.py): registered with ``hub.add_sink``; the loop
    also points the thread's span observer at :meth:`note_phase` and
    reports checkpoint writes through :meth:`note_checkpoint`.
    """

    def __init__(
        self,
        path: Optional[str],
        *,
        run_id: str,
        trace: TraceContext,
        request_id: Optional[str] = None,
        hub=None,
    ) -> None:
        self.path = path
        self.run_id = run_id
        self.request_id = request_id or run_id
        self.trace = trace
        self.hub = hub
        self._t_start: Optional[float] = None
        self._t_end: Optional[float] = None
        self._iterations = 0
        self._num_evals = 0.0
        self._elapsed_s = 0.0
        self._device_s = 0.0
        self._host_s = 0.0
        self._compile0: Optional[Dict[str, float]] = None
        self._compile: Dict[str, float] = {
            "trace_s": 0.0, "backend_compile_s": 0.0}
        self._phases: Dict[str, Dict[str, float]] = {}
        self._checkpoints = 0
        self._checkpoint_bytes = 0
        self._latency = [0] * (len(LATENCY_BUCKETS_S) + 1)
        self._stop_reason = ""

    # -- hub sink protocol ---------------------------------------------
    def on_iteration(self, ctx) -> None:
        import time

        now = time.time()
        if self._t_start is None:
            self._t_start = now
        self._t_end = now
        self._iterations = max(self._iterations, int(ctx.iteration))
        self._num_evals = float(ctx.num_evals)
        self._elapsed_s = float(ctx.elapsed)
        self._device_s += float(ctx.device_s)
        self._host_s += float(ctx.host_s)
        bucket_latency(float(ctx.device_s) + float(ctx.host_s),
                       self._latency)
        if self.hub is not None:
            snap = self.hub.compile_seconds_snapshot()
            if self._compile0 is None:
                # first observed snapshot anchors the diff: setup-time
                # compiles (engine init) are attributed to this segment
                self._compile0 = {k: 0.0 for k in snap}
            self._compile = {
                k: snap[k] - self._compile0[k] for k in snap}

    def on_end(self, summary: Dict[str, Any]) -> None:
        self._stop_reason = str(summary.get("stop_reason", ""))
        self._elapsed_s = float(summary.get("elapsed_s", self._elapsed_s))
        self._num_evals = float(summary.get("num_evals", self._num_evals))
        self.write()

    # -- phase / checkpoint feeds --------------------------------------
    def note_phase(self, name: str, seconds: float) -> None:
        """Span-observer callback: one completed ``sr:host:<name>``."""
        acc = self._phases.setdefault(name, {"count": 0, "seconds": 0.0})
        acc["count"] += 1
        acc["seconds"] += float(seconds)

    def note_checkpoint(self, nbytes: int) -> None:
        """One full-state checkpoint write of ``nbytes`` bytes."""
        self._checkpoints += 1
        self._checkpoint_bytes += int(nbytes)

    # -- the account record --------------------------------------------
    def account(self) -> Dict[str, Any]:
        return {
            "schema": LEDGER_SCHEMA,
            "run_id": self.run_id,
            "request_id": self.request_id,
            "trace": self.trace.to_dict(),
            "deterministic": {
                "iterations": int(self._iterations),
                "num_evals": float(self._num_evals),
                "stop_reason": self._stop_reason,
            },
            "wall": {
                "t_start": self._t_start,
                "t_end": self._t_end,
                "elapsed_s": self._elapsed_s,
                "device_s": self._device_s,
                "host_s": self._host_s,
                "compile": dict(self._compile),
                "phases": {
                    k: {"count": int(v["count"]),
                        "seconds": float(v["seconds"])}
                    for k, v in sorted(self._phases.items())
                },
                "checkpoints": {
                    "count": self._checkpoints,
                    "bytes": self._checkpoint_bytes,
                },
                "iteration_latency": {
                    "le": list(LATENCY_BUCKETS_S),
                    "counts": list(self._latency),
                },
            },
        }

    def write(self) -> Optional[str]:
        """Append this segment's account; never raises into the loop."""
        if self.path is None:
            return None
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(self.account()) + "\n")
            return self.path
        except OSError:  # accounting must never break the search
            return None


# ---------------------------------------------------------------------------
# validation / folding / fingerprints (the consumer side)
# ---------------------------------------------------------------------------

_NUM = (int, float)

_WALL_FIELDS: Dict[str, Any] = {
    "elapsed_s": _NUM,
    "device_s": _NUM,
    "host_s": _NUM,
    "compile": dict,
    "phases": dict,
    "checkpoints": dict,
    "iteration_latency": dict,
}

_DET_FIELDS: Dict[str, Any] = {
    "iterations": int,
    "num_evals": _NUM,
    "stop_reason": str,
}


def validate_account(obj: Any) -> List[str]:
    """Table-driven account check; returns violations (empty = valid)."""
    errors: List[str] = []
    if not isinstance(obj, dict):
        return [f"account is {type(obj).__name__}, expected object"]
    if obj.get("schema") != LEDGER_SCHEMA:
        errors.append(
            f"schema is {obj.get('schema')!r}, expected {LEDGER_SCHEMA!r}")
    for field in ("run_id", "request_id"):
        if not isinstance(obj.get(field), str):
            errors.append(f"{field}: missing/not str")
    trace = obj.get("trace")
    if not isinstance(trace, dict) or not isinstance(
            trace.get("trace_id"), str) or not isinstance(
            trace.get("span_id"), str):
        errors.append("trace: missing/malformed trace context")
    det = obj.get("deterministic")
    if not isinstance(det, dict):
        errors.append("deterministic: missing/not object")
    else:
        for name, spec in _DET_FIELDS.items():
            v = det.get(name)
            if not isinstance(v, spec) or isinstance(v, bool):
                errors.append(f"deterministic.{name}: missing/bad type")
    wall = obj.get("wall")
    if not isinstance(wall, dict):
        errors.append("wall: missing/not object")
    else:
        for name, spec in _WALL_FIELDS.items():
            v = wall.get(name)
            if not isinstance(v, spec) or isinstance(v, bool):
                errors.append(f"wall.{name}: missing/bad type")
        hist = wall.get("iteration_latency")
        if isinstance(hist, dict) and (
                not isinstance(hist.get("le"), list)
                or not isinstance(hist.get("counts"), list)
                or len(hist.get("counts", [])) !=
                len(hist.get("le", [])) + 1):
            errors.append(
                "wall.iteration_latency: counts must be len(le)+1")
    return errors


def load_accounts(path: str) -> List[dict]:
    """Load + validate a per-request ledger JSONL; raises ValueError."""
    accounts: List[dict] = []
    errors: List[str] = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {lineno}: invalid JSON ({e})")
                continue
            errors.extend(
                f"line {lineno}: {m}" for m in validate_account(obj))
            accounts.append(obj)
    if errors:
        raise ValueError(
            f"{path} failed {LEDGER_SCHEMA} validation:\n  "
            + "\n  ".join(errors[:20]))
    if not accounts:
        raise ValueError(f"{path}: no ledger accounts found")
    return accounts


def fold_accounts(accounts: List[dict]) -> Dict[str, Any]:
    """Reduce one request's account segments (file order = attempt
    order) to the deterministic view: final-value semantics, so a
    killed-and-resumed request folds to exactly what its uninterrupted
    twin writes — segment counts, re-saved checkpoints, and every
    clocked value stay out."""
    if not accounts:
        raise ValueError("fold_accounts: no accounts")
    last = accounts[-1]
    return {
        "schema": LEDGER_SCHEMA,
        "run_id": last.get("run_id"),
        "request_id": last.get("request_id"),
        "trace": last.get("trace"),
        "iterations": max(
            int(a.get("deterministic", {}).get("iterations", 0))
            for a in accounts),
        "num_evals": float(
            last.get("deterministic", {}).get("num_evals", 0.0)),
        "stop_reason": last.get("deterministic", {}).get(
            "stop_reason", ""),
    }


def ledger_fingerprint(path: str) -> str:
    """sha256 over the folded deterministic view of one request's
    ledger file — byte-stable across kill-restart-replay."""
    import hashlib

    view = fold_accounts(load_accounts(path))
    blob = json.dumps(view, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()
