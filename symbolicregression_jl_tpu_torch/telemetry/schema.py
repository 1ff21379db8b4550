"""graftscope JSONL event schema (version 2) + hand-rolled validator.

A copy of the JAX package's ``telemetry/schema.py``: a stream the port
writes validates under both packages' validators.

Every line the `Telemetry` hub emits is one JSON object with at least::

    {"schema": "graftscope.v2", "event": <type>, "t": <unix seconds>}

Event types and their required fields are listed in :data:`EVENT_SPECS`.
No external jsonschema dependency: the validator is a small table-driven
checker (CI validates every emitted line with it, and the report CLI
refuses files that don't validate — see docs/OBSERVABILITY.md for the
full field semantics).

v2 adds the optional graftledger ``trace`` field — a
``{"trace_id", "span_id", "parent_id"}`` causal-context object
(ledger/context.py) the hub stamps onto every event it emits. The
validator type-checks ``trace`` when present but does not require it:
pre-v2 streams (schema ``graftscope.v1``) still validate unchanged, and
synthetic v2 events without a trace (bench fixtures) stay valid too.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Tuple

__all__ = ["SCHEMA_VERSION", "SCHEMA_VERSIONS", "EVENT_SPECS",
           "validate_event", "validate_lines", "load_events",
           "load_events_tolerant"]

SCHEMA_VERSION = "graftscope.v2"

# every schema version the validator accepts, oldest first; v1 events
# (no trace field) remain valid forever — the bump is purely additive
SCHEMA_VERSIONS = ("graftscope.v1", "graftscope.v2")

_NUM = (int, float)

# event type -> {field: type or tuple of types}. Fields may hold None
# where noted ("nullable" set). Unknown extra fields are allowed (the
# schema is forward-extensible; v2 consumers must ignore them too).
EVENT_SPECS: Dict[str, Dict[str, Any]] = {
    "run_start": {
        "run_id": str,
        "backend": str,
        "n_devices": int,
        "nout": int,
        "niterations": int,
        "telemetry_interval": int,
        "options": dict,
        "engines": list,
    },
    "iteration": {
        "iteration": int,
        "num_evals": _NUM,
        "evals_per_sec": _NUM,
        "elapsed_s": _NUM,
        "device_s": _NUM,
        "host_s": _NUM,
        "host_fraction": _NUM,
        "recompiles": dict,
        "transfer_guard_hits": int,
        "outputs": list,
    },
    "run_end": {
        "stop_reason": str,
        "iterations": int,
        "num_evals": _NUM,
        "elapsed_s": _NUM,
        "recompiles_total": dict,
    },
    # graftshield fault/recovery audit records (docs/ROBUSTNESS.md):
    # kind is one of preempt_signal / emergency_checkpoint / retry /
    # degrade / quarantine / watchdog_timeout / checkpoint_corrupt /
    # injected (fault harness); detail carries kind-specific fields
    # (attempt counts, island lists, error text).
    "fault": {
        "kind": str,
        "iteration": int,
        "detail": dict,
    },
    # graftserve request-lifecycle audit records (docs/SERVING.md):
    # kind is one of accept / reject / start / done / cancel / failed /
    # interrupted / replay / cache_hit / cache_miss / injected /
    # shutdown;
    # request_id ties the event to one journaled request (report's
    # per-request view groups on it, falling back to run_id for plain
    # search events); detail carries kind-specific fields (shape bucket,
    # queue depth, retry-after, result fingerprint).
    "serve": {
        "kind": str,
        "request_id": str,
        "detail": dict,
    },
    # graftmesh shard-runtime records (docs/SCALING.md): the periodic
    # cross-shard dedup-key exchange and per-shard balance view.
    # detail carries rows / shard_unique / global_unique / local_dup /
    # cross_shard_dup / per_shard_unique / shard_imbalance /
    # exchanged_bytes / exchange_time_s / sharded_dedup.
    "mesh": {
        "iteration": int,
        "shards": int,
        "detail": dict,
    },
    # graftpulse anomaly-detector findings (docs/OBSERVABILITY.md): a
    # rolling EWMA/z-score excursion on one watched per-iteration metric
    # (evals_per_sec / host_fraction / recompiles / invalid_fraction).
    # detail carries value / mean / zscore / threshold and, when the
    # excursion armed a profiler capture, armed_capture=true.
    "anomaly": {
        "metric": str,
        "iteration": int,
        "detail": dict,
    },
    # graftpulse diagnostics-layer audit records: kind is one of
    # capture_armed / capture_start / capture_stop / capture_failed /
    # bundle_dump / profiler_unusable; detail carries kind-specific
    # fields (reason, trace_dir, trace files/bytes, bundle path).
    "pulse": {
        "kind": str,
        "iteration": int,
        "detail": dict,
    },
    # graftgauge capacity-observability records (docs/OBSERVABILITY.md,
    # "Capacity & memory"): kind is one of memory (per-iteration live
    # bytes + allocator stats) / footprint (one compiled executable's
    # memory/cost analysis) / watermark (end-of-run peaks) /
    # dispatch_latency (end-of-run histogram summary); detail carries
    # kind-specific fields. Additive within graftscope.v2 — the schema
    # allows unknown event fields but not unknown event TYPES, so the
    # entry here is what lets v2 consumers see gauge streams; v1
    # streams (which never contain gauge events) validate unchanged.
    "gauge": {
        "kind": str,
        "iteration": int,
        "detail": dict,
    },
}

# required keys inside each element of iteration.outputs; nullable
# fields are expressed as (type, type(None)) tuples
_OUTPUT_FIELDS: Dict[str, Any] = {
    "output": int,
    "min_loss": (_NUM, type(None)),
    "pareto_volume": _NUM,
    "counters": (dict, type(None)),
    "loss_hist": (list, type(None)),
    "complexity_hist": (list, type(None)),
}

# required keys inside the optional top-level `trace` field (v2,
# ledger/context.py): parent_id is nullable (None at the tree root)
_TRACE_FIELDS: Dict[str, Any] = {
    "trace_id": str,
    "span_id": str,
    "parent_id": (str, type(None)),
}

# required keys inside iteration.outputs[*].counters when present
_COUNTER_FIELDS: Dict[str, Any] = {
    "proposed": dict,
    "accepted": dict,
    "reject_reasons": dict,
    "candidates": int,
    "invalid": int,
    "eval_rows": int,
    "eval_launches": int,
    "dedup": dict,
}

# graftstage staged-eval counters: emitted by every post-graftstage
# stream, but optional in the schema so pre-graftstage artifacts still
# validate. Type-checked when present.
_OPTIONAL_COUNTER_FIELDS: Dict[str, Any] = {
    "screen_rows": int,
    "screen_launches": int,
    "rescore_rows": int,
    "rescore_launches": int,
}


def _type_ok(value, spec) -> bool:
    if isinstance(spec, tuple):
        flat: Tuple[type, ...] = ()
        for s in spec:
            flat += s if isinstance(s, tuple) else (s,)
        spec = flat
    ok = isinstance(value, spec)
    # bool is an int subclass; reject it where a number is expected
    if ok and isinstance(value, bool) and not (
        spec is bool or (isinstance(spec, tuple) and bool in spec)
    ):
        return False
    return ok


def _check_fields(obj: dict, fields: Dict[str, Any], where: str,
                  errors: List[str]) -> None:
    for name, spec in fields.items():
        if name not in obj:
            errors.append(f"{where}: missing field {name!r}")
        elif not _type_ok(obj[name], spec):
            errors.append(
                f"{where}: field {name!r} has type "
                f"{type(obj[name]).__name__}, expected {spec}"
            )


def validate_event(obj: Any) -> List[str]:
    """Validate one decoded JSONL event; return violation strings
    (empty list = valid)."""
    errors: List[str] = []
    if not isinstance(obj, dict):
        return [f"event is {type(obj).__name__}, expected object"]
    if obj.get("schema") not in SCHEMA_VERSIONS:
        errors.append(
            f"schema is {obj.get('schema')!r}, expected one of "
            f"{SCHEMA_VERSIONS!r}"
        )
    trace = obj.get("trace")
    if trace is not None:
        if not isinstance(trace, dict):
            errors.append(
                f"trace is {type(trace).__name__}, expected object")
        else:
            _check_fields(trace, _TRACE_FIELDS, "trace", errors)
    ev = obj.get("event")
    if ev not in EVENT_SPECS:
        errors.append(
            f"event type {ev!r} not one of {sorted(EVENT_SPECS)}"
        )
        return errors
    if not _type_ok(obj.get("t"), _NUM):
        errors.append(f"{ev}: field 't' must be a unix timestamp")
    _check_fields(obj, EVENT_SPECS[ev], ev, errors)
    if ev == "iteration" and isinstance(obj.get("outputs"), list):
        for i, out in enumerate(obj["outputs"]):
            where = f"iteration.outputs[{i}]"
            if not isinstance(out, dict):
                errors.append(f"{where}: not an object")
                continue
            _check_fields(out, _OUTPUT_FIELDS, where, errors)
            counters = out.get("counters")
            if isinstance(counters, dict):
                _check_fields(
                    counters, _COUNTER_FIELDS, where + ".counters", errors
                )
                for name, spec in _OPTIONAL_COUNTER_FIELDS.items():
                    if name in counters and not _type_ok(
                            counters[name], spec):
                        errors.append(
                            f"{where}.counters: field {name!r} has type "
                            f"{type(counters[name]).__name__}, "
                            f"expected {spec}"
                        )
    if ev == "iteration" and isinstance(obj.get("recompiles"), dict):
        for k in ("traces", "backend_compiles"):
            if not isinstance(obj["recompiles"].get(k), int):
                errors.append(f"iteration.recompiles.{k}: missing/not int")
    return errors


def validate_lines(lines: Iterable[str]) -> List[str]:
    """Validate raw JSONL lines; returns one violation string per
    problem, prefixed with the 1-based line number."""
    errors: List[str] = []
    n = 0
    for lineno, line in enumerate(lines, start=1):
        line = line.strip()
        if not line:
            continue
        n += 1
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            errors.append(f"line {lineno}: invalid JSON ({e})")
            continue
        errors.extend(f"line {lineno}: {m}" for m in validate_event(obj))
    if n == 0:
        errors.append("no events found (empty file)")
    return errors


def load_events(path: str) -> List[dict]:
    """Load + validate a JSONL run file; raises ValueError with the full
    violation list on any schema problem."""
    with open(path) as f:
        lines = f.readlines()
    errors = validate_lines(lines)
    if errors:
        raise ValueError(
            f"{path} failed {SCHEMA_VERSION} validation:\n  "
            + "\n  ".join(errors[:20])
            + ("" if len(errors) <= 20 else f"\n  ... +{len(errors) - 20} more")
        )
    return [json.loads(l) for l in lines if l.strip()]


def load_events_tolerant(path: str) -> Tuple[List[dict], List[dict]]:
    """Load a possibly-live or crashed stream, skip-and-count bad lines.

    A writer that crashed (or is still appending) leaves a partial last
    line; ``load_events`` would refuse the whole file over it. This
    loader mirrors serve/journal.py replay: every undecodable or
    schema-invalid line is SKIPPED and returned as a corrupt note
    ``{"line": n, "reason": ..., "torn_tail": bool}`` — torn_tail is
    True only for the final line (the expected crash/live artifact);
    anything earlier is mid-file corruption, reported but not fatal.
    """
    with open(path) as f:
        raw = f.readlines()
    numbered = [(i, l.strip()) for i, l in enumerate(raw, start=1)
                if l.strip()]
    events: List[dict] = []
    notes: List[dict] = []
    last_lineno = numbered[-1][0] if numbered else 0
    for lineno, line in numbered:
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            notes.append({"line": lineno, "reason": f"invalid JSON ({e})",
                          "torn_tail": lineno == last_lineno})
            continue
        errs = validate_event(obj)
        if errs:
            notes.append({"line": lineno, "reason": errs[0],
                          "torn_tail": lineno == last_lineno})
            continue
        events.append(obj)
    return events, notes
