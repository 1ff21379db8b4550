"""graftscope run-report CLI (a copy of the JAX package's ``telemetry/report.py``).

Summarizes a graftscope.v1 JSONL run file (see :mod:`.schema` and
docs/OBSERVABILITY.md)::

    python -m symbolicregression_jl_tpu_torch.telemetry report run.jsonl
    python -m symbolicregression_jl_tpu_torch.telemetry report run.jsonl --json
    python -m symbolicregression_jl_tpu_torch.telemetry validate run.jsonl

``report`` refuses files that fail schema validation (run ``validate``
for the full violation list). ``--json`` emits the machine-readable
summary dict instead of the human-readable text. Pure host-side JSON
processing — no device is touched.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional

from .schema import (
    SCHEMA_VERSION,
    load_events,
    load_events_tolerant,
    validate_lines,
)

__all__ = ["summarize", "summarize_requests", "metrics_view",
           "format_report", "main"]


def _mean(xs: List[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def _rate(num: int, den: int) -> Optional[float]:
    return num / den if den else None


_SERVE_LIFECYCLE = ("accept", "start", "interrupted", "done", "cancel",
                    "reject", "failed")


def _request_key(e: dict) -> Optional[str]:
    """The human-readable grouping key of one event for the per-request
    view: an explicit request_id (serve events; fault events emitted by
    the serve layer carry it in detail), else the emitting search's
    run_id."""
    rid = e.get("request_id")
    if not rid and isinstance(e.get("detail"), dict):
        rid = e["detail"].get("request_id")
    return (rid or e.get("run_id")) or None


def _trace_id(e: dict) -> Optional[str]:
    trace = e.get("trace")
    if isinstance(trace, dict):
        tid = trace.get("trace_id")
        return tid if isinstance(tid, str) else None
    return None


def summarize_requests(events: List[dict]) -> Dict[str, Any]:
    """Group graftscope records into the per-request view of a
    multi-tenant (graftserve) or concatenated stream.

    Events group by graftledger ``trace_id`` when present (v2), falling
    back to request_id/run_id — so a mixed v1+v2 directory (old runs
    next to new ones) still groups every event, and two streams of one
    request join on the causal id even when their human ids differ.
    Returned groups stay keyed by the human-readable id (the first
    request_id/run_id seen for each trace); events with neither id are
    ignored."""
    # pass 1: canonical human key per trace_id (first seen wins)
    canon: Dict[str, str] = {}
    for e in events:
        tid = _trace_id(e)
        if tid is None or tid in canon:
            continue
        canon[tid] = _request_key(e) or tid
    groups: Dict[str, Dict[str, Any]] = {}
    for e in events:
        tid = _trace_id(e)
        key = canon[tid] if tid is not None else _request_key(e)
        if key is None:
            continue
        g = groups.setdefault(key, {
            "events": 0, "iterations": 0, "num_evals": None,
            "faults": {}, "serve": {}, "state": None,
            "first_t": None, "last_t": None, "stop_reason": None,
            "trace_id": None, "padding": None,
        })
        if tid is not None and g["trace_id"] is None:
            g["trace_id"] = tid
        g["events"] += 1
        t = e.get("t")
        if isinstance(t, (int, float)):
            g["first_t"] = t if g["first_t"] is None else min(g["first_t"], t)
            g["last_t"] = t if g["last_t"] is None else max(g["last_t"], t)
        kind = e.get("kind")
        if e["event"] == "iteration":
            g["iterations"] = max(g["iterations"], int(e["iteration"]))
            g["num_evals"] = e.get("num_evals")
        elif e["event"] == "run_end":
            g["stop_reason"] = e.get("stop_reason")
            g["iterations"] = max(g["iterations"],
                                  int(e.get("iterations", 0)))
        elif e["event"] == "fault":
            g["faults"][kind] = g["faults"].get(kind, 0) + 1
        elif e["event"] == "serve":
            g["serve"][kind] = g["serve"].get(kind, 0) + 1
            if kind in _SERVE_LIFECYCLE:
                g["state"] = kind
            if kind == "accept":
                # graftpack padded-bucket provenance from the journaled
                # accept record: replay/audit reads it back here rather
                # than re-deriving the padding from shapes
                det = e.get("detail") or {}
                if det.get("bucket_rows"):
                    g["padding"] = {
                        "bucket_rows": det.get("bucket_rows"),
                        "pad_rows": det.get("pad_rows"),
                        "sample_rows": det.get("sample_rows"),
                    }
    for g in groups.values():
        if g["first_t"] is not None and g["last_t"] is not None:
            g["span_s"] = g["last_t"] - g["first_t"]
    return groups


def _summarize_serve(serve: List[dict]) -> Dict[str, Any]:
    """Fleet-level aggregates of graftserve events: lifecycle counts,
    executable-cache hit rate (overall and per shape bucket), admission
    rejections."""
    kinds: Dict[str, int] = {}
    for e in serve:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    hits = kinds.get("cache_hit", 0)
    misses = kinds.get("cache_miss", 0)
    by_bucket: Dict[str, Dict[str, int]] = {}
    for e in serve:
        if e["kind"] not in ("cache_hit", "cache_miss"):
            continue
        b = str(e.get("detail", {}).get("bucket"))
        d = by_bucket.setdefault(b, {"hits": 0, "misses": 0})
        d["hits" if e["kind"] == "cache_hit" else "misses"] += 1
    for d in by_bucket.values():
        d["hit_rate"] = _rate(d["hits"], d["hits"] + d["misses"])
    out = {
        "events": len(serve),
        "by_kind": kinds,
        "accepted": kinds.get("accept", 0),
        "rejected": kinds.get("reject", 0),
        "cache": {
            "hits": hits,
            "misses": misses,
            "hit_rate": _rate(hits, hits + misses),
            "by_bucket": by_bucket,
        },
    }
    # graftpack aggregates: launches, multi-tenant launches, mean
    # occupancy (from pack_done), and how much padding admission added
    padded = pad_rows_total = tenants = multi = 0
    occ: List[float] = []
    for e in serve:
        det = e.get("detail") or {}
        if e["kind"] == "accept" and det.get("pad_rows"):
            padded += 1
            pad_rows_total += int(det["pad_rows"])
        elif e["kind"] == "pack_launch":
            t = det.get("tenants") or []
            tenants += len(t)
            if len(t) > 1:
                multi += 1
        elif e["kind"] == "pack_join":
            tenants += 1
        elif e["kind"] == "pack_done":
            if isinstance(det.get("occupancy"), (int, float)):
                occ.append(float(det["occupancy"]))
    if kinds.get("pack_launch") or padded:
        out["packing"] = {
            "launches": kinds.get("pack_launch", 0),
            "multi_tenant_launches": multi,
            "tenants": tenants,
            "padded_accepts": padded,
            "pad_rows_total": pad_rows_total,
            "mean_occupancy": (round(sum(occ) / len(occ), 4)
                               if occ else None),
        }
    return out


def summarize(events: List[dict]) -> Dict[str, Any]:
    """Machine-readable summary of a validated event list."""
    run_start = next((e for e in events if e["event"] == "run_start"), None)
    run_end = next((e for e in events if e["event"] == "run_end"), None)
    iters = [e for e in events if e["event"] == "iteration"]
    faults = [e for e in events if e["event"] == "fault"]
    serve = [e for e in events if e["event"] == "serve"]

    summary: Dict[str, Any] = {"schema": SCHEMA_VERSION}
    if run_start is not None:
        summary["run"] = {
            k: run_start.get(k)
            for k in ("run_id", "backend", "n_devices", "nout",
                      "niterations", "telemetry_interval")
        }
        summary["run"]["options"] = run_start.get("options", {})
        summary["run"]["engines"] = run_start.get("engines", [])

    evals_curve = [[e["iteration"], e["evals_per_sec"]] for e in iters]
    host_fracs = [e["host_fraction"] for e in iters]
    recompile_traces = sum(e["recompiles"]["traces"] for e in iters)
    recompile_backend = sum(e["recompiles"]["backend_compiles"] for e in iters)
    warm = [e for e in iters[1:] if e["recompiles"]["traces"] == 0]
    summary["iterations"] = {
        "count": len(iters),
        "evals_per_sec": {
            "curve": evals_curve,
            "final": evals_curve[-1][1] if evals_curve else None,
            "peak": max((v for _, v in evals_curve), default=None),
        },
        "host_fraction": {
            "mean": _mean(host_fracs),
            "max": max(host_fracs, default=None),
            "final": host_fracs[-1] if host_fracs else None,
        },
        "recompiles": {
            "traces": recompile_traces,
            "backend_compiles": recompile_backend,
            "warm_iterations": len(warm),
            # the one place the warm rule (post-first event, zero
            # traces) is computed; metrics_view gates on these ids
            "warm_iteration_ids": [e["iteration"] for e in warm],
        },
        "transfer_guard_hits": sum(
            e.get("transfer_guard_hits", 0) for e in iters
        ),
    }

    # Per-output aggregates across every iteration event that carried
    # counters (intervals already sum within each event).
    nout = max((len(e["outputs"]) for e in iters), default=0)
    outputs = []
    for j in range(nout):
        outs = [e["outputs"][j] for e in iters if len(e["outputs"]) > j]
        counters = [o["counters"] for o in outs if o.get("counters")]
        agg: Dict[str, Any] = {
            "output": j + 1,
            "pareto_volume_curve": [
                [e["iteration"], e["outputs"][j]["pareto_volume"]]
                for e in iters if len(e["outputs"]) > j
            ],
            "final_min_loss": outs[-1]["min_loss"] if outs else None,
        }
        if counters:
            kinds = sorted(
                {k for c in counters for k in c["proposed"]}
            )
            proposed = {
                k: sum(c["proposed"].get(k, 0) for c in counters)
                for k in kinds
            }
            accepted = {
                k: sum(c["accepted"].get(k, 0) for c in counters)
                for k in kinds
            }
            agg["proposed"] = proposed
            agg["accepted"] = accepted
            agg["acceptance_rate"] = {
                k: _rate(accepted[k], proposed[k])
                for k in kinds if proposed[k]
            }
            agg["reject_reasons"] = {
                r: sum(c["reject_reasons"].get(r, 0) for c in counters)
                for r in sorted(
                    {r for c in counters for r in c["reject_reasons"]}
                )
            }
            cands = sum(c["candidates"] for c in counters)
            agg["candidates"] = cands
            agg["invalid_fraction"] = _rate(
                sum(c["invalid"] for c in counters), cands
            )
            agg["eval_rows"] = sum(c["eval_rows"] for c in counters)
            agg["eval_launches"] = sum(c["eval_launches"] for c in counters)
            # graftstage staged-eval counters (.get: pre-graftstage
            # streams don't carry them)
            screen = sum(c.get("screen_rows", 0) for c in counters)
            if screen:
                agg["screen_rows"] = screen
                agg["rescore_rows"] = sum(
                    c.get("rescore_rows", 0) for c in counters)
                agg["screen_launches"] = sum(
                    c.get("screen_launches", 0) for c in counters)
                agg["rescore_launches"] = sum(
                    c.get("rescore_launches", 0) for c in counters)
                agg["observed_rescore_fraction"] = _rate(
                    agg["rescore_rows"], screen)
                # the raw invalid_fraction includes the structural
                # unrescored-NaN floor (docs/PRECISION.md); this is the
                # storm-relevant fraction among rescored candidates
                unrescored = screen - agg["rescore_rows"]
                agg["rescored_invalid_fraction"] = _rate(
                    max(0, sum(c["invalid"] for c in counters) - unrescored),
                    max(1, cands - unrescored),
                )
            dedup_rows = sum(c["dedup"]["rows"] for c in counters)
            agg["dedup_hit_rate"] = _rate(
                sum(c["dedup"]["hits"] for c in counters), dedup_rows
            )
        outputs.append(agg)
    summary["outputs"] = outputs

    # graftshield fault/recovery audit (docs/ROBUSTNESS.md): per-kind
    # counts plus the raw timeline (kind, iteration) for small runs.
    if faults:
        by_kind: Dict[str, int] = {}
        for e in faults:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
        summary["faults"] = {
            "count": len(faults),
            "by_kind": by_kind,
            "timeline": [[e["iteration"], e["kind"]] for e in faults[:50]],
        }

    # graftmesh exchange view (docs/SCALING.md): the periodic
    # cross-shard dedup-key exchanges, aggregated. Duplication split =
    # what per-shard dedup exploits vs what only a cross-shard scheme
    # could reach.
    mesh = [e for e in events if e["event"] == "mesh"]
    if mesh:
        last = mesh[-1].get("detail", {})
        rows = sum(e.get("detail", {}).get("rows", 0) for e in mesh)
        local_dup = sum(
            e.get("detail", {}).get("local_dup", 0) for e in mesh)
        cross_dup = sum(
            e.get("detail", {}).get("cross_shard_dup", 0) for e in mesh)
        summary["mesh"] = {
            "exchanges": len(mesh),
            "shards": mesh[-1].get("shards"),
            "local_dup_fraction": _rate(local_dup, rows),
            "cross_shard_dup_fraction": _rate(cross_dup, rows),
            "last_shard_imbalance": last.get("shard_imbalance"),
            "last_shard_eval_imbalance": last.get("shard_eval_imbalance"),
            "exchanged_bytes_total": sum(
                e.get("detail", {}).get("exchanged_bytes", 0)
                for e in mesh),
            "exchange_time_s_total": sum(
                e.get("detail", {}).get("exchange_time_s", 0.0)
                for e in mesh),
            "sharded_dedup": last.get("sharded_dedup"),
        }

    # graftpulse anomaly view (docs/OBSERVABILITY.md): detector
    # excursions, per metric, with the small-run timeline — and the
    # pulse audit trail (capture windows, bundle dumps).
    anomalies = [e for e in events if e["event"] == "anomaly"]
    if anomalies:
        by_metric: Dict[str, int] = {}
        for e in anomalies:
            by_metric[e["metric"]] = by_metric.get(e["metric"], 0) + 1
        summary["anomalies"] = {
            "count": len(anomalies),
            "by_metric": by_metric,
            "timeline": [
                [e["iteration"], e["metric"]] for e in anomalies[:50]
            ],
        }
    pulse = [e for e in events if e["event"] == "pulse"]
    if pulse:
        pk: Dict[str, int] = {}
        for e in pulse:
            pk[e["kind"]] = pk.get(e["kind"], 0) + 1
        summary["pulse"] = {
            "count": len(pulse),
            "by_kind": pk,
            "captures": pk.get("capture_stop", 0),
            "bundles": pk.get("bundle_dump", 0),
        }

    # graftgauge capacity view (docs/OBSERVABILITY.md, "Capacity &
    # memory"): peak live bytes across memory/watermark events, the
    # end-of-run dispatch-latency histogram summary, and the footprint
    # events' count + largest program.
    gauges = [e for e in events if e["event"] == "gauge"]
    if gauges:
        gk: Dict[str, int] = {}
        peak_live = None
        latency = None
        footprint_max = None
        for e in gauges:
            gk[e["kind"]] = gk.get(e["kind"], 0) + 1
            d = e.get("detail", {})
            if e["kind"] in ("memory", "watermark"):
                p = d.get("peak_live_bytes", d.get("live_bytes"))
                if p is not None and (peak_live is None or p > peak_live):
                    peak_live = p
            elif e["kind"] == "dispatch_latency":
                latency = {
                    k: d.get(k)
                    for k in ("count", "sum_s", "max_s", "p50_s", "p99_s")
                }
            elif e["kind"] == "footprint":
                total = (d.get("summary") or {}).get("total_bytes")
                if total and (footprint_max is None
                              or total > footprint_max):
                    footprint_max = total
        summary["gauge"] = {
            "count": len(gauges),
            "by_kind": gk,
            "peak_live_bytes": peak_live,
            "dispatch_latency": latency,
            "footprints": gk.get("footprint", 0),
            "footprint_max_bytes": footprint_max,
        }

    # graftserve per-request view (docs/SERVING.md): the serve event
    # stream always gets one; a plain search stream gets one only when
    # it actually interleaves multiple run_ids.
    request_groups = summarize_requests(events)
    if serve:
        summary["serve"] = _summarize_serve(serve)
        summary["requests"] = request_groups
    elif len(request_groups) > 1:
        summary["requests"] = request_groups

    if run_end is not None:
        summary["end"] = {
            k: run_end.get(k)
            for k in ("stop_reason", "iterations", "num_evals", "elapsed_s",
                      "recompiles_total")
        }
        if run_end.get("faults_total"):
            summary.setdefault("faults", {})["totals_at_end"] = (
                run_end["faults_total"]
            )
        if run_end.get("anomalies_total"):
            summary.setdefault("anomalies", {})["totals_at_end"] = (
                run_end["anomalies_total"]
            )
    return summary


def metrics_view(summary: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten a :func:`summarize` dict to the scalar metrics the
    graftbench regression gate consumes (docs/BENCHMARKING.md): one
    number per gated dimension, chosen for per-run stability.

    ``evals_per_sec`` prefers the mean over WARM iterations (no traces,
    excluding the first event, whose window absorbs compile) and falls
    back to the peak — on CPU the first-iteration rate is dominated by
    trace time and would gate on compiler noise, not throughput.
    """
    it = summary["iterations"]
    curve = it["evals_per_sec"]["curve"]
    # warm ids come from summarize (zero traces, first event excluded
    # — its window absorbs startup compile even when nothing retraced):
    # a mid-run retrace's rate must not leak into the gated mean
    warm_iters = set(it["recompiles"].get("warm_iteration_ids", []))
    warm_vals = [v for i, v in curve if i in warm_iters]
    eps = (_mean(warm_vals) if warm_vals
           else it["evals_per_sec"]["peak"])
    outputs = summary.get("outputs") or []
    best_loss = None
    pareto_volume = None
    for out in outputs:
        fl = out.get("final_min_loss")
        if fl is not None and (best_loss is None or fl > best_loss):
            best_loss = fl  # worst output gates (multi-output runs)
        pv = out.get("pareto_volume_curve") or []
        if pv:
            v = pv[-1][1]
            pareto_volume = v if pareto_volume is None else min(
                pareto_volume, v)
    end = summary.get("end") or {}
    return {
        "evals_per_sec": eps,
        "evals_per_sec_final": it["evals_per_sec"]["final"],
        "best_loss": best_loss,
        "pareto_volume": pareto_volume,
        "host_fraction": it["host_fraction"]["mean"],
        "recompiles": it["recompiles"]["traces"],
        "backend_compiles": it["recompiles"]["backend_compiles"],
        "warm_iterations": it["recompiles"]["warm_iterations"],
        "iterations": it["count"],
        "num_evals": end.get("num_evals"),
        "elapsed_s": end.get("elapsed_s"),
        "stop_reason": end.get("stop_reason"),
        # graftpulse: detector excursions in this run. Rides into the
        # bench artifacts via extract.py (extra metrics_view keys are
        # carried along) and colors `bench trend`'s anomalies column.
        "anomalies": (summary.get("anomalies") or {}).get("count", 0),
        # graftgauge: peak live-array bytes the run reached (None for
        # pre-gauge streams / gauge off); rides into bench cells the
        # same way and shows in `bench trend`.
        "peak_live_bytes": (summary.get("gauge")
                            or {}).get("peak_live_bytes"),
    }


def _fmt_pct(x: Optional[float]) -> str:
    return "-" if x is None else f"{100.0 * x:.1f}%"


def _fmt_num(x: Optional[float]) -> str:
    if x is None:
        return "-"
    return f"{x:,.3g}" if isinstance(x, float) else f"{x:,}"


def format_report(summary: Dict[str, Any]) -> str:
    """Human-readable text report."""
    lines: List[str] = []
    run = summary.get("run", {})
    if run:
        lines.append(
            f"run {run.get('run_id')}  [{run.get('backend')} x "
            f"{run.get('n_devices')} device(s), nout={run.get('nout')}, "
            f"interval={run.get('telemetry_interval')}]"
        )
    it = summary["iterations"]
    eps = it["evals_per_sec"]
    lines.append(
        f"iterations: {it['count']} events  |  evals/s final "
        f"{_fmt_num(eps['final'])}, peak {_fmt_num(eps['peak'])}"
    )
    curve = eps["curve"]
    if len(curve) > 1:
        pts = ", ".join(f"{i}:{_fmt_num(v)}" for i, v in curve[:12])
        more = "" if len(curve) <= 12 else f", ... +{len(curve) - 12}"
        lines.append(f"  evals/s trajectory: {pts}{more}")
    hf = it["host_fraction"]
    lines.append(
        f"host-fraction: mean {_fmt_pct(hf['mean'])}, max "
        f"{_fmt_pct(hf['max'])}, final {_fmt_pct(hf['final'])}"
    )
    rc = it["recompiles"]
    lines.append(
        f"recompiles: {rc['traces']} traces / {rc['backend_compiles']} "
        f"backend compiles across iteration events "
        f"({rc['warm_iterations']} warm iterations); "
        f"{it['transfer_guard_hits']} transfer-guard hits"
    )
    for out in summary["outputs"]:
        lines.append(f"output {out['output']}:")
        pv = out["pareto_volume_curve"]
        if pv:
            pts = ", ".join(f"{i}:{v:.3g}" for i, v in pv[:12])
            more = "" if len(pv) <= 12 else f", ... +{len(pv) - 12}"
            lines.append(f"  pareto volume: {pts}{more}")
        if out.get("final_min_loss") is not None:
            lines.append(f"  final min loss: {out['final_min_loss']:.6g}")
        if "acceptance_rate" in out:
            rates = sorted(
                out["acceptance_rate"].items(), key=lambda kv: -kv[1]
            )
            lines.append("  acceptance by kind (accepted/proposed):")
            for k, r in rates:
                lines.append(
                    f"    {k:<18} {out['accepted'][k]:>8,} / "
                    f"{out['proposed'][k]:>8,}  ({_fmt_pct(r)})"
                )
            lines.append(
                f"  candidates: {_fmt_num(out['candidates'])}  "
                f"(invalid {_fmt_pct(out['invalid_fraction'])})  |  "
                f"eval rows {_fmt_num(out['eval_rows'])} in "
                f"{_fmt_num(out['eval_launches'])} launches  |  "
                f"dedup hit-rate {_fmt_pct(out['dedup_hit_rate'])}"
            )
            if out.get("screen_rows"):
                lines.append(
                    f"  staged eval: screened "
                    f"{_fmt_num(out['screen_rows'])}, rescored "
                    f"{_fmt_num(out['rescore_rows'])}  "
                    f"(observed rescore fraction "
                    f"{_fmt_pct(out['observed_rescore_fraction'])}, "
                    f"rescored-invalid "
                    f"{_fmt_pct(out.get('rescored_invalid_fraction'))})"
                )
            rej = out.get("reject_reasons", {})
            if rej:
                lines.append(
                    "  reject reasons: "
                    + ", ".join(f"{k}={v:,}" for k, v in rej.items())
                )
    fl = summary.get("faults")
    if fl:
        kinds = ", ".join(
            f"{k}={v}" for k, v in sorted(fl.get("by_kind", {}).items())
        )
        lines.append(
            f"faults: {fl.get('count', 0)} event(s)"
            + (f"  ({kinds})" if kinds else "")
        )
        for it_n, kind in fl.get("timeline", [])[:12]:
            lines.append(f"  iter {it_n}: {kind}")
    an = summary.get("anomalies")
    if an and an.get("count"):
        kinds = ", ".join(
            f"{k}={v}" for k, v in sorted(an.get("by_metric", {}).items())
        )
        lines.append(
            f"anomalies: {an['count']} event(s)"
            + (f"  ({kinds})" if kinds else "")
        )
        for it_n, metric in an.get("timeline", [])[:12]:
            lines.append(f"  iter {it_n}: {metric}")
    pu = summary.get("pulse")
    if pu:
        lines.append(
            f"pulse: {pu['captures']} profiler capture(s), "
            f"{pu['bundles']} bundle dump(s)  ("
            + ", ".join(f"{k}={v}"
                        for k, v in sorted(pu["by_kind"].items()))
            + ")"
        )
    ga = summary.get("gauge")
    if ga:
        lines.append(
            f"gauge: peak live {_fmt_num(ga.get('peak_live_bytes'))} B  ("
            + ", ".join(f"{k}={v}"
                        for k, v in sorted(ga["by_kind"].items()))
            + ")"
        )
        dl = ga.get("dispatch_latency")
        if dl and dl.get("count"):
            lines.append(
                f"  dispatch latency: {dl['count']} launches, "
                f"p50 {_fmt_num(dl.get('p50_s'))}s, "
                f"p99 {_fmt_num(dl.get('p99_s'))}s, "
                f"max {_fmt_num(dl.get('max_s'))}s"
            )
        if ga.get("footprints"):
            lines.append(
                f"  footprints: {ga['footprints']} compiled program(s), "
                f"largest {_fmt_num(ga.get('footprint_max_bytes'))} B"
            )
    ms = summary.get("mesh")
    if ms:
        lines.append(
            f"mesh: {ms['exchanges']} dedup-key exchange(s) over "
            f"{ms.get('shards')} shard(s)  |  dup local "
            f"{_fmt_pct(ms['local_dup_fraction'])} / cross-shard "
            f"{_fmt_pct(ms['cross_shard_dup_fraction'])}"
            f"  |  imbalance {ms.get('last_shard_imbalance')}"
            f"  |  {_fmt_num(ms['exchanged_bytes_total'])} B in "
            f"{ms['exchange_time_s_total']:.3f}s"
            + ("" if ms.get("sharded_dedup") else
               "  [sharded dedup OFF]")
        )
    sv = summary.get("serve")
    if sv:
        cache = sv["cache"]
        lines.append(
            f"serve: {sv['accepted']} accepted, {sv['rejected']} rejected"
            f"  |  executable cache {cache['hits']} hit / "
            f"{cache['misses']} miss ({_fmt_pct(cache['hit_rate'])})"
        )
        other = {k: v for k, v in sorted(sv["by_kind"].items())
                 if k not in ("accept", "reject")}
        if other:
            lines.append(
                "  events: " + ", ".join(f"{k}={v}" for k, v in other.items())
            )
        pk = sv.get("packing")
        if pk:
            lines.append(
                f"  packing: {pk['launches']} launch(es) "
                f"({pk['multi_tenant_launches']} multi-tenant, "
                f"{pk['tenants']} tenant(s))  |  "
                f"{pk['padded_accepts']} padded accept(s), "
                f"{pk['pad_rows_total']} pad rows  |  "
                f"occupancy {pk['mean_occupancy']}"
            )
    reqs = summary.get("requests")
    if reqs:
        lines.append(
            f"requests: {len(reqs)} "
            "(grouped by trace_id, else request_id/run_id)")
        for rid in sorted(reqs):
            g = reqs[rid]
            bits = []
            if g.get("state"):
                bits.append(g["state"])
            if g.get("stop_reason"):
                bits.append(f"stop={g['stop_reason']}")
            if g.get("iterations"):
                bits.append(f"iters={g['iterations']}")
            if g.get("num_evals") is not None:
                bits.append(f"evals={_fmt_num(g['num_evals'])}")
            if g.get("faults"):
                bits.append(
                    "faults["
                    + ",".join(f"{k}={v}"
                               for k, v in sorted(g["faults"].items()))
                    + "]"
                )
            if g.get("serve", {}).get("cache_hit"):
                bits.append("cache-hit")
            if g.get("padding"):
                bits.append(
                    f"padded+{g['padding'].get('pad_rows')}"
                    f"->{g['padding'].get('bucket_rows')}")
            if g.get("span_s") is not None:
                bits.append(f"{g['span_s']:.1f}s")
            lines.append(f"  {rid}: " + (", ".join(bits) or "no activity"))
    end = summary.get("end")
    if end:
        lines.append(
            f"run end: {end.get('stop_reason')} after "
            f"{end.get('iterations')} iterations, "
            f"{_fmt_num(end.get('num_evals'))} evals in "
            f"{_fmt_num(end.get('elapsed_s'))}s; lifetime compiles "
            f"{end.get('recompiles_total')}"
        )
    return "\n".join(lines)


_USAGE = """usage: python -m symbolicregression_jl_tpu_torch.telemetry <cmd> <run.jsonl>
       python -m symbolicregression_jl_tpu_torch.telemetry <run.jsonl>   (= report)

commands:
  report <run.jsonl> [--json]      summarize a run (refuses invalid files)
  report <run.jsonl> --metrics     flat gate-metrics JSON (graftbench view)
  validate <run.jsonl>             check every line against graftscope.v1
  tail <run.jsonl> [--interval S]  follow a live stream with a refreshing
       [--once]                    single-screen summary (--once: one shot)
  timeline <root> --out <t.json>   merge a serve root's journal, request
                                   streams and cost ledgers into one
                                   Chrome trace-event file (Perfetto /
                                   chrome://tracing openable)

report tolerates a torn final line (the crash artifact of a killed
writer): it is skipped and counted on stderr, like journal replay.
"""


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_USAGE, end="")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd not in ("validate", "report", "tail", "timeline") and os.path.isfile(cmd):
        cmd, rest = "report", argv   # a bare run file: its report
    if cmd == "validate":
        if len(rest) != 1:
            print(_USAGE, end="", file=sys.stderr)
            return 2
        with open(rest[0]) as f:
            errors = validate_lines(f.readlines())
        if errors:
            for e in errors:
                print(e, file=sys.stderr)
            print(f"{rest[0]}: {len(errors)} violation(s)", file=sys.stderr)
            return 1
        print(f"{rest[0]}: valid {SCHEMA_VERSION}")
        return 0
    if cmd == "report":
        as_json = "--json" in rest
        as_metrics = "--metrics" in rest
        paths = [a for a in rest if not a.startswith("-")]
        if len(paths) != 1:
            print(_USAGE, end="", file=sys.stderr)
            return 2
        try:
            events = load_events(paths[0])
        except ValueError:
            # skip-and-count fallback (journal-replay idiom): a torn
            # tail — the expected artifact of a crashed/killed writer —
            # must not make the rest of the stream unreadable. Any
            # OTHER bad line still refuses: mid-file corruption means
            # records may be missing, and a silently partial report
            # would misrepresent the run.
            events, notes = load_events_tolerant(paths[0])
            hard = [n for n in notes if not n["torn_tail"]]
            if hard or not events:
                for n in notes:
                    print(f"line {n['line']}: {n['reason']}",
                          file=sys.stderr)
                print(f"{paths[0]}: unreadable ({len(notes)} bad line(s), "
                      f"{len(hard)} before the tail)", file=sys.stderr)
                return 1
            for n in notes:
                print(f"warning: skipped torn line {n['line']}: "
                      f"{n['reason']}", file=sys.stderr)
        summary = summarize(events)
        if as_metrics:
            print(json.dumps(metrics_view(summary)))
        elif as_json:
            print(json.dumps(summary))
        else:
            print(format_report(summary))
        return 0
    if cmd == "tail":
        from .tail import main as tail_main

        return tail_main(rest)
    if cmd == "timeline":
        from ..ledger.timeline import write_timeline

        out = None
        paths = []
        i = 0
        while i < len(rest):
            if rest[i] == "--out":
                if i + 1 >= len(rest):
                    print(_USAGE, end="", file=sys.stderr)
                    return 2
                out = rest[i + 1]
                i += 2
            elif rest[i].startswith("-"):
                print(_USAGE, end="", file=sys.stderr)
                return 2
            else:
                paths.append(rest[i])
                i += 1
        if len(paths) != 1 or not out:
            print(_USAGE, end="", file=sys.stderr)
            return 2
        doc = write_timeline(paths[0], out)
        n = len(doc.get("traceEvents", []))
        if n == 0:
            print(f"{paths[0]}: no telemetry found", file=sys.stderr)
            return 1
        print(f"{out}: {n} trace events")
        return 0
    print(_USAGE, end="", file=sys.stderr)
    return 2
