"""graftledger unified timeline: one Perfetto view per serve root (a copy
of the JAX package's ``ledger/timeline.py``).

``build_timeline(root)`` merges everything a serve root (or a single
run directory) recorded — the server's ``serve_telemetry.jsonl``
lifecycle stream, every request's graftscope stream, and the per-request
cost-ledger accounts — into one causally-ordered Chrome trace-event
JSON document (the ``{"traceEvents": [...]}`` format Perfetto and
``chrome://tracing`` open directly):

- one *process* (pid) per request/run, named after it, plus pid 0 for
  the server's own lifecycle events that match no request;
- per process, a ``serve`` thread (lifecycle instants), an
  ``iterations`` thread (one complete slice per iteration with nested
  ``device`` / ``host`` child slices), an ``events`` thread
  (fault/anomaly/pulse/mesh instants), and a ``ledger`` thread (one
  slice per account segment carrying the cost totals in its args);
- every slice's ``args`` carry the graftledger ``trace_id``/``span_id``
  when the stream recorded them, so the exported timeline correlates
  with on-device profiler captures (spans.py stamps the same ids onto
  ``sr:iteration`` StepTraceAnnotations).

CLI: ``python -m symbolicregression_jl_tpu_torch.telemetry timeline <root>
--out t.json`` (telemetry/report.py).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["build_timeline", "write_timeline", "validate_chrome_trace"]

_TID_SERVE = 0
_TID_ITER = 1
_TID_EVENTS = 2
_TID_LEDGER = 3

_THREAD_NAMES = {
    _TID_SERVE: "serve",
    _TID_ITER: "iterations",
    _TID_EVENTS: "events",
    _TID_LEDGER: "ledger",
}


def _load_stream(path: str) -> List[dict]:
    from ..telemetry.schema import load_events_tolerant

    try:
        events, _notes = load_events_tolerant(path)
    except OSError:
        return []
    return events


def _trace_args(e: dict) -> Dict[str, Any]:
    trace = e.get("trace")
    if not isinstance(trace, dict):
        return {}
    out = {}
    for k in ("trace_id", "span_id", "parent_id"):
        if trace.get(k) is not None:
            out[k] = trace[k]
    return out


def _meta(pid: int, name: str) -> dict:
    return {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": name}}


def _thread_meta(pid: int) -> List[dict]:
    return [
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
         "args": {"name": tname}}
        for tid, tname in _THREAD_NAMES.items()
    ]


def _instant(name: str, t: float, pid: int, tid: int,
             args: Dict[str, Any]) -> dict:
    return {"ph": "i", "name": name, "ts": t * 1e6, "pid": pid,
            "tid": tid, "s": "t", "args": args}


def _slice(name: str, start: float, dur_s: float, pid: int, tid: int,
           args: Dict[str, Any]) -> dict:
    return {"ph": "X", "name": name, "ts": start * 1e6,
            "dur": max(dur_s, 0.0) * 1e6, "pid": pid, "tid": tid,
            "args": args}


def _run_stream_events(events: List[dict], pid: int) -> List[dict]:
    out: List[dict] = []
    for e in events:
        kind = e.get("event")
        t = float(e.get("t", 0.0))
        args = _trace_args(e)
        if kind == "iteration":
            device_s = float(e.get("device_s", 0.0))
            host_s = float(e.get("host_s", 0.0))
            start = t - device_s - host_s
            it = e.get("iteration")
            out.append(_slice(
                f"iteration {it}", start, device_s + host_s, pid,
                _TID_ITER, {
                    **args,
                    "iteration": it,
                    "num_evals": e.get("num_evals"),
                    "evals_per_sec": e.get("evals_per_sec"),
                }))
            # nested by containment: Perfetto stacks same-thread
            # complete slices whose intervals nest
            out.append(_slice("device", start, device_s, pid,
                              _TID_ITER, dict(args)))
            out.append(_slice("host", start + device_s, host_s, pid,
                              _TID_ITER, dict(args)))
        elif kind in ("run_start", "run_end"):
            extra = {"stop_reason": e["stop_reason"]} \
                if kind == "run_end" else {}
            out.append(_instant(kind, t, pid, _TID_ITER,
                                {**args, **extra}))
        elif kind in ("fault", "pulse"):
            out.append(_instant(f"{kind}:{e.get('kind')}", t, pid,
                                _TID_EVENTS, {**args,
                                              "detail": e.get("detail")}))
        elif kind == "anomaly":
            out.append(_instant(f"anomaly:{e.get('metric')}", t, pid,
                                _TID_EVENTS, {**args,
                                              "detail": e.get("detail")}))
        elif kind == "mesh":
            out.append(_instant(
                f"mesh:exchange@{e.get('iteration')}", t, pid,
                _TID_EVENTS, {**args, "shards": e.get("shards")}))
        elif kind == "gauge":
            d = e.get("detail") or {}
            if e.get("kind") == "memory":
                # Chrome counter track ("C"): Perfetto renders the
                # per-iteration live-bytes series as a graph alongside
                # the iteration slices
                counters = {"live_bytes": d.get("live_bytes", 0)}
                if d.get("bytes_in_use") is not None:
                    counters["bytes_in_use"] = d["bytes_in_use"]
                out.append({"ph": "C", "name": "memory",
                            "ts": t * 1e6, "pid": pid,
                            "tid": _TID_EVENTS, "args": counters})
            else:
                out.append(_instant(
                    f"gauge:{e.get('kind')}", t, pid, _TID_EVENTS,
                    {**args, "detail": d}))
    return out


def _ledger_events(path: str, pid: int) -> List[dict]:
    from .ledger import load_accounts

    try:
        accounts = load_accounts(path)
    except (OSError, ValueError):
        return []
    out: List[dict] = []
    for seg, a in enumerate(accounts):
        wall = a.get("wall", {})
        t0, t1 = wall.get("t_start"), wall.get("t_end")
        if t0 is None or t1 is None:
            continue
        out.append(_slice(
            f"ledger segment {seg}", float(t0), float(t1) - float(t0),
            pid, _TID_LEDGER, {
                **_trace_args(a),
                "device_s": wall.get("device_s"),
                "host_s": wall.get("host_s"),
                "compile": wall.get("compile"),
                "checkpoints": wall.get("checkpoints"),
                "iterations": a.get("deterministic", {}).get("iterations"),
                "num_evals": a.get("deterministic", {}).get("num_evals"),
            }))
    return out


def _discover(root: str) -> Tuple[Optional[str], List[Tuple[str, str]]]:
    """-> (serve stream path or None, [(key, run telemetry path)...])."""
    serve_path = os.path.join(root, "serve_telemetry.jsonl")
    if not os.path.exists(serve_path):
        serve_path = None
    runs: List[Tuple[str, str]] = []
    for p in sorted(glob.glob(
            os.path.join(root, "requests", "*", "*", "telemetry.jsonl"))):
        runs.append((os.path.basename(os.path.dirname(p)), p))
    if not runs:  # a plain run directory works too
        solo = os.path.join(root, "telemetry.jsonl")
        if os.path.exists(solo):
            runs.append((os.path.basename(os.path.abspath(root)), solo))
    return serve_path, runs


def build_timeline(root: str) -> Dict[str, Any]:
    """Merge a serve root's streams into one Chrome trace document."""
    serve_path, runs = _discover(root)
    events: List[dict] = []
    pid_of: Dict[str, int] = {}
    for i, (key, path) in enumerate(runs):
        pid = i + 1
        pid_of[key] = pid
        events.append(_meta(pid, f"request {key}"))
        events.extend(_thread_meta(pid))
        stream = _load_stream(path)
        events.extend(_run_stream_events(stream, pid))
        events.extend(_ledger_events(
            os.path.join(os.path.dirname(path), "ledger.jsonl"), pid))
    if serve_path is not None:
        server_pid_used = False
        for e in _load_stream(serve_path):
            kind = e.get("event")
            t = float(e.get("t", 0.0))
            args = _trace_args(e)
            rid = e.get("request_id") or e.get(
                "detail", {}).get("request_id")
            pid = pid_of.get(rid, 0)
            server_pid_used = server_pid_used or pid == 0
            if kind == "serve":
                events.append(_instant(
                    f"serve:{e.get('kind')}", t, pid, _TID_SERVE,
                    {**args, "request_id": rid,
                     "detail": e.get("detail")}))
            elif kind == "fault":
                events.append(_instant(
                    f"fault:{e.get('kind')}", t, pid, _TID_EVENTS,
                    {**args, "detail": e.get("detail")}))
        if server_pid_used:
            events.append(_meta(0, "graftserve"))
            events.extend(_thread_meta(0))
    meta = [e for e in events if e["ph"] == "M"]
    timed = sorted((e for e in events if e["ph"] != "M"),
                   key=lambda e: e["ts"])
    return {"traceEvents": meta + timed, "displayTimeUnit": "ms"}


def write_timeline(root: str, out: str) -> Dict[str, Any]:
    doc = build_timeline(root)
    d = os.path.dirname(out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f)
    return doc


_PHASES = {"X", "i", "I", "M", "B", "E", "C", "b", "e", "n", "s", "t",
           "f"}


def validate_chrome_trace(doc: Any) -> List[str]:
    """Check the Perfetto-required shape of an exported timeline:
    a ``traceEvents`` list whose members each carry ``ph``/``name``/
    ``pid``/``tid``, a numeric ``ts`` on every non-metadata event, and
    a numeric ``dur`` on complete (``X``) slices."""
    errors: List[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["document must be an object with a traceEvents list"]
    for i, e in enumerate(doc["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if not isinstance(ph, str) or ph not in _PHASES:
            errors.append(f"{where}: bad ph {ph!r}")
        if not isinstance(e.get("name"), str):
            errors.append(f"{where}: missing name")
        for k in ("pid", "tid"):
            if not isinstance(e.get(k), int):
                errors.append(f"{where}: missing {k}")
        if ph != "M" and not isinstance(e.get("ts"), (int, float)):
            errors.append(f"{where}: missing ts")
        if ph == "X" and not isinstance(e.get("dur"), (int, float)):
            errors.append(f"{where}: complete slice missing dur")
    return errors
