"""The quality gate: the port's matrix cells against the committed baseline.

Port of the JAX package's ``bench/gate.py`` (``Band``, ``GATED_METRICS``,
the backstops, ``diff_result``, ``gate_failed``) for a result record the
port makes (``make_result``). The baseline (``benchmarks/baseline.json``,
schema ``graftbench.baseline.v1``) was made with the JAX package on the
CPU, so the port's results always run under the gate's rule for library
drift (``diff_result``): a quality-band excursion (best_loss above +5%,
pareto_volume below -10%) is a ``soft`` finding, reported and not
failing, and only the backstops fail hard — best_loss above 10x the
baseline's, pareto_volume below 0.1x. Throughput metrics are not gated:
the baseline's are CPU wall-clock numbers of another library. Pure host
JSON; no device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "BASELINE_SCHEMA", "RESULT_SCHEMA", "GATED_METRICS", "PORT_GATED",
    "CPU_THROUGHPUT_BAND_FACTOR", "Band", "Finding",
    "load_baseline", "library_provenance", "make_result", "diff_result", "gate_failed",
    "format_findings", "calibrate_bands", "make_baseline",
]

BASELINE_SCHEMA = "graftbench.baseline.v1"
# The JAX package's bench/matrix.py result schema, which the gate checks.
RESULT_SCHEMA = "graftbench.result.v1"


@dataclasses.dataclass(frozen=True)
class Band:
    """Noise band for one metric. ``direction`` names the REGRESSION
    direction ("higher" = an increase is bad). A fresh value regresses
    when it crosses ``base`` by more than rel*|base| + abs in that
    direction; ``kind`` picks quality vs throughput gating."""

    direction: str  # "higher" | "lower" (which way is worse)
    kind: str       # "quality" | "throughput"
    rel: float = 0.0
    abs: float = 0.0


# The JAX package's default bands.
GATED_METRICS: Dict[str, Band] = {
    "best_loss": Band(direction="higher", kind="quality",
                      rel=0.05, abs=1e-7),
    "pareto_volume": Band(direction="lower", kind="quality",
                          rel=0.10, abs=1e-7),
    "evals_per_sec": Band(direction="lower", kind="throughput",
                          rel=0.30),
    "host_fraction": Band(direction="higher", kind="throughput",
                          rel=0.50, abs=0.10),
    "recompiles": Band(direction="higher", kind="throughput",
                       rel=0.25, abs=8),
}
# What the port's gate diffs: the quality metrics (throughput is not
# comparable with the JAX package's CPU baseline).
PORT_GATED = ("best_loss", "pareto_volume")

# The JAX package widens throughput bands by this factor when reporting a
# CPU result (shared cores are noisy); a baseline records it, as there.
CPU_THROUGHPUT_BAND_FACTOR = 2.0

# Backstops (any band width): a fresh value below COLLAPSE_FLOOR_FRACTION
# x baseline ("lower is worse" metrics) or above max(BLOWUP_CEILING_FACTOR
# x baseline, the metric's abs band) ("higher is worse") always fails.
COLLAPSE_FLOOR_FRACTION = 0.10
BLOWUP_CEILING_FACTOR = 10.0


@dataclasses.dataclass
class Finding:
    cell: str
    metric: str
    # regression | soft (band excursion under library drift,
    # non-failing) | improvement | ok | missing_cell | schema | note
    status: str
    base: Optional[float] = None
    fresh: Optional[float] = None
    allowed: Optional[float] = None
    note: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _spread_band(values: List[float], default: Band) -> Band:
    """``default`` widened to cover the spread of repeated runs of one cell
    (x2 for safety), never narrower than it."""
    finite = [v for v in values if v is not None]
    if len(finite) < 2:
        return default
    lo, hi = min(finite), max(finite)
    mid = (lo + hi) / 2.0
    if mid == 0:
        return dataclasses.replace(default, abs=max(default.abs, 2.0 * (hi - lo)))
    return dataclasses.replace(default, rel=max(default.rel, 2.0 * (hi - lo) / abs(mid)))


def calibrate_bands(results: List[Dict[str, Any]]) -> Dict[str, Band]:
    """Per-metric bands from two or more repeated matrix runs: the widest
    per-cell spread seen across the repeats, at least GATED_METRICS'."""
    bands = dict(GATED_METRICS)
    if len(results) < 2:
        return bands
    cell_ids = set().union(*(r.get("cells", {}) for r in results))
    for metric, default in GATED_METRICS.items():
        widest = default
        for cid in cell_ids:
            vals = [r["cells"][cid]["metrics"].get(metric) for r in results
                    if cid in r.get("cells", {})]
            cand = _spread_band(vals, default)
            if (cand.rel, cand.abs) > (widest.rel, widest.abs):
                widest = cand
        bands[metric] = widest
    return bands


def make_baseline(results: List[Dict[str, Any]],
                  bands: Optional[Dict[str, Band]] = None) -> Dict[str, Any]:
    """A ``graftbench.baseline.v1`` baseline from one or more runs of one
    matrix kind: each cell's metric medians over the repeats, with bands
    (calibrated from the repeats unless given). Raises ValueError for a
    non-finite gated metric (a NaN pinned would fail every later gate)."""
    if not results:
        raise ValueError("need at least one matrix result")
    kinds = {r.get("matrix") for r in results}
    if len(kinds) != 1:
        raise ValueError(f"mixed matrix kinds {kinds} cannot baseline")
    bands = bands or calibrate_bands(results)
    cells: Dict[str, Any] = {}
    for cid in sorted(set().union(*(r.get("cells", {}) for r in results))):
        recs = [r["cells"][cid] for r in results if cid in r.get("cells", {})]
        metrics: Dict[str, Any] = {}
        for k in sorted(set().union(*(rec["metrics"] for rec in recs))):
            vals = sorted(rec["metrics"][k] for rec in recs
                          if isinstance(rec["metrics"].get(k), (int, float)))
            if k in GATED_METRICS and any(not math.isfinite(v) for v in vals):
                raise ValueError(f"refusing to pin baseline: non-finite {k} in cell {cid}: "
                                 f"{vals}")
            metrics[k] = vals[len(vals) // 2] if vals else None
        cells[cid] = {"metrics": metrics, "variant": recs[0].get("variant"),
                      "seed": recs[0].get("seed")}
    return {
        "schema": BASELINE_SCHEMA,
        "matrix": results[0].get("matrix"),
        "platform": results[0].get("platform"),
        "created": time.strftime("%Y-%m-%d", time.gmtime()),
        "provenance": library_provenance(),
        "repeats": len(results),
        "cpu_throughput_band_factor": CPU_THROUGHPUT_BAND_FACTOR,
        "bands": {m: {"direction": b.direction, "kind": b.kind, "rel": b.rel, "abs": b.abs}
                  for m, b in bands.items()},
        "cells": cells,
    }


def load_baseline(path: str) -> Dict[str, Any]:
    with open(path) as f:
        baseline = json.load(f)
    if baseline.get("schema") != BASELINE_SCHEMA:
        raise ValueError(
            f"{path}: baseline schema {baseline.get('schema')!r} != {BASELINE_SCHEMA!r}")
    return baseline


def library_provenance() -> Dict[str, Optional[str]]:
    """What a result ran on: the torch and numpy versions, the CUDA
    version torch was built for, the driver's version and the card's
    name (None where there is no CUDA). Best-effort."""
    versions: Dict[str, Optional[str]] = {}
    for name in ("torch", "numpy"):
        try:
            versions[name] = __import__(name).__version__
        except Exception:  # noqa: BLE001 - provenance is best-effort
            versions[name] = None
    versions["cuda"] = versions["driver"] = versions["device"] = None
    try:
        import torch

        versions["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            versions["device"] = torch.cuda.get_device_name(0)
            import subprocess

            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30)
            versions["driver"] = out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
    except Exception:  # noqa: BLE001 - provenance is best-effort
        pass
    return versions


def make_result(cells: List[Dict[str, Any]], *, matrix: str, platform: str,
                failures: Optional[Dict[str, Dict[str, Any]]] = None) -> Dict[str, Any]:
    """A ``graftbench.result.v1`` record of the port's cell records
    (bench/cell.py ``run_cell``); ``platform`` is "gpu" or "cpu"."""
    return {
        "schema": RESULT_SCHEMA,
        "matrix": matrix,
        "platform": platform,
        "provenance": library_provenance(),
        "t": time.time(),
        "cells": {c["cell_id"]: c for c in cells},
        "failures": dict(failures or {}),
    }


def _bands_of(baseline: Dict[str, Any]) -> Dict[str, Band]:
    bands = {}
    for m, d in (baseline.get("bands") or {}).items():
        bands[m] = Band(direction=d["direction"], kind=d["kind"],
                        rel=float(d.get("rel", 0.0)),
                        abs=float(d.get("abs", 0.0)))
    for m, b in GATED_METRICS.items():
        bands.setdefault(m, b)
    return bands


def _drift(base_prov: Dict[str, Any], fresh_prov: Dict[str, Any]) -> List[str]:
    """Libraries that differ between the baseline and the result, a
    library present on one side only included (the baseline's jax against
    the port's torch)."""
    out = []
    for lib in sorted(set(base_prov) | set(fresh_prov)):
        a, b = base_prov.get(lib), fresh_prov.get(lib)
        if a != b:
            out.append(f"{lib} {b} vs baseline's {a}")
    return out


def diff_result(
    result: Dict[str, Any], baseline: Dict[str, Any],
    cells_filter: Optional[List[str]] = None,
) -> List[Finding]:
    """All findings from gating ``result`` against ``baseline`` on
    ``PORT_GATED``; the gate fails iff any finding has status
    regression/missing_cell/schema (see :func:`gate_failed`).
    ``cells_filter`` restricts the diff to those baseline cell ids; None =
    all."""
    findings: List[Finding] = []
    if result.get("schema") != RESULT_SCHEMA:
        findings.append(Finding(
            cell="*", metric="schema", status="schema",
            note=(f"result schema {result.get('schema')!r} != "
                  f"{RESULT_SCHEMA!r}")))
        return findings
    if baseline.get("schema") != BASELINE_SCHEMA:
        findings.append(Finding(
            cell="*", metric="schema", status="schema",
            note=(f"baseline schema {baseline.get('schema')!r} != "
                  f"{BASELINE_SCHEMA!r}")))
        return findings
    if result.get("matrix") != baseline.get("matrix"):
        findings.append(Finding(
            cell="*", metric="matrix", status="schema",
            note=(f"matrix kind {result.get('matrix')!r} does not match "
                  f"baseline {baseline.get('matrix')!r}")))
        return findings

    drifted = _drift(baseline.get("provenance") or {}, result.get("provenance") or {})
    if drifted:
        # Another library moves the chaotic search trajectory: under
        # drift, quality-band excursions gate soft and the backstops
        # stay hard.
        findings.append(Finding(
            cell="*", metric="provenance", status="note",
            note=(", ".join(drifted) + " — quality-band excursions "
                  "gate soft under library drift")))

    bands = _bands_of(baseline)
    cells = result.get("cells", {})
    for cid, base_cell in sorted(baseline.get("cells", {}).items()):
        if cells_filter is not None and cid not in cells_filter:
            continue
        fresh_cell = cells.get(cid)
        if fresh_cell is None:
            err = (result.get("failures", {}).get(cid) or {}).get("error")
            findings.append(Finding(
                cell=cid, metric="*", status="missing_cell",
                note=err or "cell absent from fresh result"))
            continue
        for metric in PORT_GATED:
            band = bands[metric]
            base = base_cell["metrics"].get(metric)
            fresh = fresh_cell["metrics"].get(metric)
            if base is None:
                continue
            if fresh is None:
                findings.append(Finding(
                    cell=cid, metric=metric, status="regression",
                    base=base, note="metric missing from fresh result"))
                continue
            if not math.isfinite(fresh) or not math.isfinite(base):
                findings.append(Finding(
                    cell=cid, metric=metric, status="regression",
                    base=base, fresh=fresh,
                    note=(f"non-finite value (base={base!r}, "
                          f"fresh={fresh!r})")))
                continue
            margin = band.rel * abs(base) + band.abs
            if band.direction == "higher":
                allowed = base + margin
                allowed = min(allowed, max(base * BLOWUP_CEILING_FACTOR, band.abs))
                regressed = fresh > allowed
                improved = fresh < base - margin
            else:
                allowed = base - margin
                if base > 0:
                    allowed = max(allowed, base * COLLAPSE_FLOOR_FRACTION)
                regressed = fresh < allowed
                improved = fresh > base + margin
            status = ("regression" if regressed
                      else "improvement" if improved else "ok")
            if status == "regression" and drifted and band.kind == "quality":
                # a band excursion is soft unless it crosses the collapse
                # floor / blowup ceiling — those backstops always gate hard
                if band.direction == "lower":
                    hard = base > 0 and fresh < base * COLLAPSE_FLOOR_FRACTION
                else:
                    hard = fresh > max(base * BLOWUP_CEILING_FACTOR, band.abs)
                if not hard:
                    status = "soft"
            findings.append(Finding(
                cell=cid, metric=metric, status=status,
                base=base, fresh=fresh, allowed=allowed))
    for cid in sorted(set(cells) - set(baseline.get("cells", {}))):
        findings.append(Finding(
            cell=cid, metric="*", status="note",
            note="cell not in baseline — ungated"))
    return findings


def gate_failed(findings: List[Finding]) -> bool:
    return any(f.status in ("regression", "missing_cell", "schema")
               for f in findings)


def format_findings(findings: List[Finding], verbose: bool = True) -> str:
    """Every finding on its own line (each cell's values and its band
    status), then the verdict; ``verbose=False`` leaves out the in-band
    (ok) lines, as the JAX package's default does."""
    lines: List[str] = []
    for f in findings:
        if f.status == "ok" and not verbose:
            continue
        if f.fresh is not None and f.allowed is not None:
            lines.append(
                f"{f.status.upper():<12} {f.cell:<22} {f.metric:<14} "
                f"base={f.base:.6g} fresh={f.fresh:.6g} allowed={f.allowed:.6g}")
        else:
            lines.append(f"{f.status.upper():<12} {f.cell:<22} {f.metric:<14} {f.note}")
    count = lambda s: sum(f.status == s for f in findings)
    lines.append(
        f"gate: {count('ok')} ok, {count('improvement')} improved, "
        f"{count('regression')} regressed, {count('soft')} soft (non-failing), "
        f"{count('missing_cell')} missing — "
        + ("FAIL" if gate_failed(findings) else "PASS"))
    return "\n".join(lines)
