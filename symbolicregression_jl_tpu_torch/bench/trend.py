"""Trajectory report: fold benchmark results into one view (port of
``bench/trend.py``).

``build_trend(paths)`` reads the files named, and the ``*.json`` files
of any directory named, and nothing else: the repo's ``BENCH_r*.json``
and ``MULTICHIP_r*.json`` are the JAX package's TPU record and never
enter a trend of the port unless a caller names them. Two kinds of file
fold in:

- ``graftbench.result.v1`` results of ``bench run`` / ``bench gate``
  (a gate row: the cells, failures, the gate's verdict, anomalies);
- headline lines of ``python -m symbolicregression_jl_tpu_torch.bench.headline``
  (a JSON object with ``metric`` and ``value``, or an artifact holding
  one under ``parsed`` or at the end of ``tail``).

- multi-chip dryrun artifacts (``python -m
  symbolicregression_jl_tpu_torch.mesh.dryrun --out``: ``n_devices``,
  ``rc``, ``ok``, ``legs``), one row each, red when the dryrun ran and
  failed (a skip is reported, not red);
- mesh-scaling curves (schema ``graftmesh.scaling.v1``: shards against
  evals/s), red when a point failed or none was measured.

A NON-GREEN artifact (a failed cell, a failed gate, a nonzero rc, an
unreadable file) is a RED row, never silently dropped.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["build_trend", "format_trend", "trend_files", "root_files"]

_ROUND_RE = re.compile(r"_r(\d+)\.json$")


def _round_of(path: str) -> Optional[int]:
    m = _ROUND_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else None


def _last_json_line(text: str) -> Optional[Dict[str, Any]]:
    for line in reversed((text or "").strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def trend_files(paths: Sequence[str]) -> List[str]:
    """The files a trend reads: each named file, and the ``*.json`` files
    directly under each named directory, sorted."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "*.json"))))
        else:
            out.append(p)
    return out


def _bench_row(path: str, art: Dict[str, Any]) -> Dict[str, Any]:
    rc = art.get("rc")
    row: Dict[str, Any] = {
        "round": art.get("n", _round_of(path)),
        "file": os.path.basename(path),
        "rc": rc,
        "red": rc not in (0, None),
    }
    parsed = art if "value" in art else (
        art.get("parsed") or _last_json_line(art.get("tail", "")))
    if parsed and "value" in parsed:
        row["evals_per_sec"] = parsed.get("value")
        row["vs_baseline"] = parsed.get("vs_baseline")
        row["n_devices"] = parsed.get("n_devices")
        row["device"] = parsed.get("device")
    elif not row["red"]:
        row["red"] = True
        row["note"] = "no parseable bench JSON line in artifact"
    return row


def _multichip_row(path: str, art: Dict[str, Any]) -> Dict[str, Any]:
    ok = bool(art.get("ok"))
    row: Dict[str, Any] = {
        "round": art.get("n", _round_of(path)),
        "file": os.path.basename(path),
        "rc": art.get("rc"),
        "ok": ok,
        "skipped": bool(art.get("skipped")),
        # red = the dryrun ran and failed; no device to run on is no regression
        "red": not ok and not art.get("skipped"),
        "n_devices": art.get("n_devices"),
        "legs": dict(art.get("legs") or {}),
    }
    if row["red"]:
        row["note"] = f"dryrun failed rc={art.get('rc')}"
    return row


def _mesh_scaling_row(path: str, rec: Dict[str, Any]) -> Dict[str, Any]:
    points = rec.get("points") or []
    errs = [p for p in points if "error" in p]
    row: Dict[str, Any] = {
        "file": os.path.basename(path),
        "matrix": rec.get("matrix"),
        "points": [{k: p.get(k) for k in ("shards", "evals_per_sec", "evals_per_sec_per_shard")}
                   for p in points if "error" not in p],
        "red": bool(errs) or not points,
    }
    if errs:
        row["note"] = (f"{len(errs)} scaling point(s) failed: "
                       + ", ".join(f"shards={p.get('shards')}" for p in errs))
    elif not points:
        row["note"] = "no measured points in artifact"
    return row


def _is_multichip(art: Dict[str, Any]) -> bool:
    return "schema" not in art and "ok" in art and ("legs" in art or "n_devices" in art)


def _gate_row(path: str, rec: Dict[str, Any]) -> Dict[str, Any]:
    cells = rec.get("cells", {})
    failures = rec.get("failures", {})
    gate = rec.get("gate") or {}
    gate_failed = bool(gate.get("failed"))
    eps = [c["metrics"].get("evals_per_sec") for c in cells.values()]
    eps = [v for v in eps if isinstance(v, (int, float))]
    anomalies = sum(int(c["metrics"].get("anomalies") or 0) for c in cells.values())
    peaks = [c["metrics"].get("peak_live_bytes") for c in cells.values()]
    peaks = [int(v) for v in peaks if isinstance(v, (int, float))]
    row: Dict[str, Any] = {
        "file": os.path.basename(path),
        "matrix": rec.get("matrix"),
        "platform": rec.get("platform"),
        "cells": len(cells),
        "failed_cells": sorted(failures),
        "anomalies": anomalies,
        "peak_live_bytes": max(peaks) if peaks else None,
        # red = cells crashed OR the embedded gate verdict failed OR an
        # otherwise-green run carried anomaly events
        "red": bool(failures) or gate_failed or anomalies > 0,
        "mean_evals_per_sec": round(sum(eps) / len(eps), 1) if eps else None,
    }
    notes = []
    if failures:
        notes.append(f"{len(failures)} matrix cell(s) failed")
    if gate_failed:
        n_reg = sum(1 for f in gate.get("findings", [])
                    if f.get("status") in ("regression", "missing_cell", "schema"))
        notes.append(f"gate FAILED ({n_reg} finding(s))")
    if anomalies and not failures and not gate_failed:
        notes.append(f"{anomalies} anomaly event(s) in a green run")
    if notes:
        row["note"] = "; ".join(notes)
    return row


def root_files(root: str = ".", gate_paths: Optional[Sequence[str]] = None) -> List[str]:
    """The files a trend of ``root`` reads, as the JAX package's
    ``build_trend(root, gate_paths)`` finds them: ``gate_paths``,
    ``root/benchmarks/history/*.json`` and
    ``root/profiling/MESH_SCALING*.json``. The root's ``BENCH_r*.json`` and
    ``MULTICHIP_r*.json`` are the JAX package's TPU record and stay out."""
    found = list(gate_paths or [])
    found += sorted(glob.glob(os.path.join(root, "benchmarks", "history", "*.json")))
    found += sorted(glob.glob(os.path.join(root, "profiling", "MESH_SCALING*.json")))
    return found


def build_trend(root=".", gate_paths: Optional[Sequence[str]] = None,
                paths: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Machine-readable trajectory: headline rows (red ones flagged with
    their rc), gate rows, multi-chip dryrun rows and mesh-scaling rows.
    The files are ``paths`` (files, or directories whose ``*.json`` are
    read), or a sequence given as the first argument, or else those of
    ``root`` and ``gate_paths`` (:func:`root_files`)."""
    from .gate import RESULT_SCHEMA

    if paths is None:
        paths = (list(root) if not isinstance(root, (str, os.PathLike))
                 else root_files(os.fspath(root), gate_paths))

    bench: List[Dict[str, Any]] = []
    gates: List[Dict[str, Any]] = []
    multichip: List[Dict[str, Any]] = []
    scaling: List[Dict[str, Any]] = []
    for path in trend_files(paths):
        try:
            with open(path) as f:
                art = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            gates.append({"file": os.path.basename(path), "red": True,
                          "note": f"unreadable artifact: {e}"})
            continue
        if not isinstance(art, dict):
            gates.append({"file": os.path.basename(path), "red": True,
                          "note": "not a JSON object"})
        elif art.get("schema") == RESULT_SCHEMA:
            gates.append(_gate_row(path, art))
        elif art.get("schema") == "graftmesh.scaling.v1":
            scaling.append(_mesh_scaling_row(path, art))
        elif _is_multichip(art):
            multichip.append(_multichip_row(path, art))
        elif "schema" in art:
            gates.append({"file": os.path.basename(path), "red": True,
                          "note": f"unexpected schema {art.get('schema')!r}"})
        else:
            bench.append(_bench_row(path, art))
    bench.sort(key=lambda r: (r.get("round") or 0, r["file"]))
    multichip.sort(key=lambda r: (r.get("round") or 0, r["file"]))
    reds = ([r for r in bench if r["red"]] + [r for r in gates if r.get("red")]
            + [r for r in multichip if r["red"]] + [r for r in scaling if r["red"]])
    greens = [r for r in bench if not r["red"] and r.get("evals_per_sec") is not None]
    flat_note = None
    if len(greens) >= 2:
        prev, last = greens[-2], greens[-1]
        if prev["evals_per_sec"]:
            delta = (last["evals_per_sec"] - prev["evals_per_sec"]) / prev["evals_per_sec"]
            if abs(delta) < 0.05:
                flat_note = f"headline flat {prev['file']}->{last['file']} ({delta:+.1%})"
    return {
        "schema": "graftbench.trend.v1",
        "bench": bench,
        "gates": gates,
        "multichip": multichip,
        "mesh_scaling": scaling,
        "red_count": len(reds),
        "flat_note": flat_note,
    }


def _fmt(v, spec: str = ",.0f") -> str:
    return "-" if v is None else format(v, spec)


def format_trend(trend: Dict[str, Any]) -> str:
    lines = []
    if trend["bench"]:
        lines.append("headline bench (python -m symbolicregression_jl_tpu_torch.bench.headline):")
        for r in trend["bench"]:
            mark = f"RED rc={r['rc']}" if r["red"] else "ok"
            lines.append(
                f"  {r['file']:<28} {_fmt(r.get('evals_per_sec')):>12} evals/s  "
                f"vs_baseline {_fmt(r.get('vs_baseline'), '.2f'):>6}  [{mark}]"
                + (f"  {r['note']}" if r.get("note") else ""))
    if trend["gates"]:
        lines.append("gate matrix results:")
        for r in trend["gates"]:
            mark = f"RED ({r.get('note')})" if r.get("red") else "green"
            peak = r.get("peak_live_bytes")
            lines.append(
                f"  {r['file']:<28} {r.get('matrix') or '?'}/{r.get('platform') or '?'}  "
                f"cells={r.get('cells', '-')}  "
                f"mean evals/s {_fmt(r.get('mean_evals_per_sec'))}  "
                f"anomalies={r.get('anomalies', '-')}  "
                + (f"peak live {peak:,} B  " if peak else "")
                + f"[{mark}]")
    if trend.get("multichip"):
        lines.append("multi-chip dryrun (python -m symbolicregression_jl_tpu_torch.mesh.dryrun):")
        for r in trend["multichip"]:
            mark = ("skipped" if r["skipped"] else "ok" if r["ok"]
                    else f"RED rc={r['rc']}")
            legs = ", ".join(f"{k} {v:.1f}s" for k, v in r["legs"].items()
                             if isinstance(v, (int, float)))
            lines.append(f"  {r['file']:<28} {r.get('n_devices') or '?'} rank(s)  [{mark}]"
                         + (f"  {legs}" if legs else ""))
    if trend.get("mesh_scaling"):
        lines.append("measured mesh scaling:")
        for r in trend["mesh_scaling"]:
            pts = ", ".join(f"{p['shards']}:{_fmt(p.get('evals_per_sec'))}" for p in r["points"])
            mark = f"RED ({r.get('note')})" if r["red"] else "green"
            lines.append(f"  {r['file']:<28} shards:evals/s {pts or '-'}  [{mark}]")
    if not lines:
        lines.append("no benchmark artifacts given")
    if trend.get("flat_note"):
        lines.append(f"note: {trend['flat_note']}")
    lines.append(f"{trend['red_count']} red artifact(s) in the trajectory"
                 if trend["red_count"] else "trajectory is green")
    return "\n".join(lines)
