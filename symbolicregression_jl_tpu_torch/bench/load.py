"""Serve-level load benchmark: a sustained submit/poll storm against a
real :class:`~..serve.server.SearchServer`.

Port of the JAX package's ``bench/load.py`` on the port's server (CUDA
unless ``device="cpu"``). Reports the four numbers serve regressions are
judged by — requests/s, p99 poll latency, engine-cache hit rate, and
shed fraction — measured from a live server (workers draining tiny
deterministic searches), with the cache hit rate read back from the
server's own graftscope serve stream rather than re-counted here.

    python -m symbolicregression_jl_tpu_torch.bench.load [--packed] [--compare]
        [--requests N] [--workers N] [--capacity N] [--device cpu] [--root DIR]

prints the report as one JSON line (``--compare``: timeshared and packed
in turns).

The storm deliberately over-submits relative to ``capacity`` so the
overload ladder engages: sheds and structured rejects are part of the
measured behavior, not an error. Every submitted request must still
reach a terminal state (or a structured reject) — anything else fails
the benchmark.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

__all__ = ["LOAD_SCHEMA", "COMPARE_SCHEMA", "percentile", "run_load",
           "run_compare"]

LOAD_SCHEMA = "graftbench.load.v1"
COMPARE_SCHEMA = "graftbench.load_compare.v1"


def percentile(samples: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]); None on empty input."""
    if not samples:
        return None
    xs = sorted(samples)
    k = max(0, min(len(xs) - 1,
                   int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[k]


def _storm_options() -> Dict[str, Any]:
    # tiny deterministic search: the load bench measures the SERVER
    # (queueing, journaling, cache, poll responsiveness), not the
    # search kernel — the matrix cells own that
    return {
        "binary_operators": ["+", "*"],
        "unary_operators": [],
        "maxsize": 8,
        "populations": 2,
        "population_size": 8,
        "ncycles_per_iteration": 2,
        "tournament_selection_n": 4,
        "optimizer_probability": 0.0,
    }


def run_load(
    root: str,
    *,
    requests: int = 10,
    workers: int = 2,
    capacity: int = 4,
    rows: int = 160,
    niterations: int = 1,
    poll_interval_s: float = 0.02,
    timeout_s: float = 600.0,
    packed: bool = False,
    row_step: int = 0,
    log=print,
    device: Optional[str] = None,
) -> Dict[str, Any]:
    """Run the storm; returns the schema-versioned load report.

    All requests share one shape bucket (same ``rows``), so repeats
    after the first SHOULD hit the executable cache — the hit rate is
    the serve-scaling headline (docs/SERVING.md pins >=90% on repeats).

    ``packed=True`` turns on graftpack multi-tenant packing (default
    PackPolicy) and adds the ``pack`` metrics section: per-launch
    occupancy, coalesce wait p50/p99, and — via the graftledger rollup
    already reported — the per-tenant device-seconds fairness spread.
    ``row_step`` varies request row counts (rows + (i % 4) * row_step)
    WITHIN the same shape bucket: the near-miss mix that padding
    collapses onto one traced executable and that timesharing retraces
    per distinct shape — set it on both sides of a packed-vs-timeshared
    comparison (:func:`run_compare`).
    """
    import numpy as np

    from ..ledger.rollup import load_rollup
    from ..pack import PackPolicy
    from ..serve.admission import ServerSaturated, shape_bucket
    from ..serve.server import SearchServer
    from ..telemetry.report import summarize
    from ..telemetry.schema import load_events

    if os.path.isdir(root):
        shutil.rmtree(root)  # a stale journal would replay old requests
    row_counts = [rows + (i % 4) * max(int(row_step), 0)
                  for i in range(requests)]
    if len({shape_bucket(r, 2) for r in row_counts}) > 1:
        raise ValueError(
            f"row_step={row_step} pushes the near-miss mix across shape "
            f"buckets; the storm must stay same-bucket")
    rng = np.random.default_rng(0)
    Xfull = rng.uniform(-2.0, 2.0, (max(row_counts), 2)).astype(np.float32)
    yfull = (Xfull[:, 0] * 2.0 + Xfull[:, 1]).astype(np.float32)
    opts = _storm_options()

    server = SearchServer(
        root, capacity=capacity, workers=workers,
        pack=PackPolicy() if packed else None, device=device)
    submitted: List[str] = []
    rejects = 0
    poll_lat: List[float] = []
    t0 = time.perf_counter()
    try:
        server.start()
        # sustained storm: a rejected submit backs off (bounded by the
        # server's retry-after hint) and retries — structured rejects
        # are counted as backpressure events, not lost requests, so the
        # storm keeps the queue pinned at capacity for its whole span
        deadline0 = time.monotonic() + timeout_s
        for i in range(requests):
            n_i = row_counts[i]
            while True:
                try:
                    rid = server.submit(
                        Xfull[:n_i], yfull[:n_i], options=opts,
                        niterations=niterations, seed=i,
                    )
                    submitted.append(rid)
                    break
                except ServerSaturated as e:
                    rejects += 1
                    if time.monotonic() > deadline0:
                        break
                    time.sleep(min(e.retry_after_s or 0.1, 0.25))
        # sustained poll loop: every poll() call is timed — its latency
        # is the client-visible responsiveness of the server lock under
        # concurrent worker/journal traffic
        pending = set(submitted)
        deadline = time.monotonic() + timeout_s
        while pending and time.monotonic() < deadline:
            for rid in list(pending):
                tp = time.perf_counter()
                snap = server.poll(rid)
                poll_lat.append(time.perf_counter() - tp)
                if snap["state"] in ("done", "failed", "cancelled"):
                    pending.discard(rid)
            time.sleep(poll_interval_s)
        wall = time.perf_counter() - t0
    finally:
        server.stop(drain=False, timeout=30.0)

    snaps = {rid: server.poll(rid) for rid in submitted}
    done = [r for r, s in snaps.items() if s["state"] == "done"]
    failed = [r for r, s in snaps.items() if s["state"] == "failed"]
    unfinished = sorted(set(submitted) - set(done) - set(failed)
                        - {r for r, s in snaps.items()
                           if s["state"] == "cancelled"})
    shed = [r for r, s in snaps.items()
            if s.get("sample_rows") is not None]

    cache_hit_rate = None
    pack_metrics: Optional[Dict[str, Any]] = None
    serve_stream = os.path.join(root, "serve_telemetry.jsonl")
    if os.path.exists(serve_stream):
        events = load_events(serve_stream)
        summary = summarize(events)
        cache_hit_rate = (summary.get("serve", {})
                          .get("cache", {}).get("hit_rate"))
        if packed:
            # graftpack occupancy + coalesce waits from the serve
            # stream: pack_launch carries per-tenant coalesce waits,
            # pack_join the late joiners', pack_done the per-round
            # occupancy record (pack/cohort.py)
            waits: List[float] = []
            occs: List[float] = []
            launches = multi = tenants = 0
            for e in events:
                if e.get("event") != "serve":
                    continue
                det = e.get("detail") or {}
                if e.get("kind") == "pack_launch":
                    launches += 1
                    members = det.get("tenants") or []
                    tenants += len(members)
                    if len(members) > 1:
                        multi += 1
                    waits.extend(
                        float(w) for w in
                        (det.get("coalesce_wait_s") or {}).values())
                elif e.get("kind") == "pack_join":
                    tenants += 1
                    if det.get("coalesce_wait_s") is not None:
                        waits.append(float(det["coalesce_wait_s"]))
                elif e.get("kind") == "pack_done":
                    if isinstance(det.get("occupancy"), (int, float)):
                        occs.append(float(det["occupancy"]))
            pack_metrics = {
                "launches": launches,
                "multi_tenant_launches": multi,
                "tenants": tenants,
                "occupancy_mean": (round(sum(occs) / len(occs), 4)
                                   if occs else None),
                "coalesce_wait_s": {
                    "samples": len(waits),
                    "p50": percentile(waits, 50),
                    "p99": percentile(waits, 99),
                    "max": max(waits) if waits else None,
                },
            }

    # per-tenant cost attribution: the server's graftledger rollup
    # (written on every request completion) gives each request's
    # device-seconds; the max/min spread is the fairness headline — a
    # storm of IDENTICAL searches should cost every tenant about the
    # same, so a wide spread means scheduling skew, not workload skew
    ledger: Optional[Dict[str, Any]] = None
    rollup = load_rollup(root)
    if rollup and rollup.get("requests"):
        per_req = {
            rid: round(float(acct.get("device_s", 0.0)), 6)
            for rid, acct in sorted(rollup["requests"].items())
        }
        costs = [c for c in per_req.values() if c > 0.0]
        spread = (round(max(costs) / min(costs), 3)
                  if costs and min(costs) > 0.0 else None)
        totals = rollup.get("totals", {})
        ledger = {
            "requests": len(per_req),
            "device_seconds": per_req,
            "total_device_s": round(float(totals.get("device_s", 0.0)), 6),
            "total_evals": totals.get("num_evals"),
            "fairness_spread": spread,  # max/min per-request device_s
        }

    report = {
        "schema": LOAD_SCHEMA,
        "t": time.time(),
        "config": {
            "requests": requests, "workers": workers,
            "capacity": capacity, "rows": rows,
            "niterations": niterations,
            "packed": packed, "row_step": row_step,
            "device": str(server.device),
        },
        "submitted": len(submitted),
        "rejected": rejects,
        "completed": len(done),
        "failed": len(failed),
        "unfinished": len(unfinished),
        "shed": len(shed),
        "shed_fraction": (len(shed) / len(submitted)
                          if submitted else None),
        "wall_s": round(wall, 3),
        "requests_per_sec": (round(len(done) / wall, 3)
                             if wall > 0 else None),
        "poll_latency_s": {
            "samples": len(poll_lat),
            "p50": percentile(poll_lat, 50),
            "p99": percentile(poll_lat, 99),
            "max": max(poll_lat) if poll_lat else None,
        },
        "cache_hit_rate": cache_hit_rate,
        "pack": pack_metrics,
        "ledger": ledger,
        "serve_telemetry": serve_stream,
    }
    p99 = report["poll_latency_s"]["p99"]
    log(f"load: {len(done)}/{len(submitted)} done "
        f"(+{rejects} rejected, {len(shed)} shed) in {wall:.1f}s — "
        f"{report['requests_per_sec']} req/s, "
        f"p99 poll {'-' if p99 is None else format(p99, '.4f')}s, "
        f"cache hit rate "
        f"{'-' if cache_hit_rate is None else format(cache_hit_rate, '.0%')}")
    if ledger is not None:
        log(f"load: ledger {ledger['requests']} request(s), "
            f"{ledger['total_device_s']:.3f} device-s total, "
            f"fairness spread (max/min device-s) "
            f"{'-' if ledger['fairness_spread'] is None else ledger['fairness_spread']}")
    if pack_metrics is not None:
        cw = pack_metrics["coalesce_wait_s"]
        log(f"load: pack {pack_metrics['launches']} launch(es) "
            f"({pack_metrics['multi_tenant_launches']} multi-tenant, "
            f"{pack_metrics['tenants']} tenants), "
            f"occupancy {pack_metrics['occupancy_mean']}, "
            f"coalesce wait p50 "
            f"{'-' if cw['p50'] is None else format(cw['p50'], '.3f')}s / "
            f"p99 {'-' if cw['p99'] is None else format(cw['p99'], '.3f')}s")
    # a storm where admission wedged and some requests were NEVER
    # accepted (the retry loop ran out its deadline) must fail too —
    # submitted==0 with zero failures is not a healthy server
    report["ok"] = (not failed and not unfinished
                    and len(submitted) == requests)
    return report


def run_compare(root: str, *, log=print, **kw) -> Dict[str, Any]:
    """Timeshared-vs-packed A/B at identical storm parameters.

    Runs the same near-miss same-bucket storm twice — once on the
    timeshared path (each distinct row count retraces the shared
    engine's jitted programs), once packed (every request padded to the
    bucket, one trace, cohorts of concurrent tenants) — and reports the
    wall-clock ratio (the JAX package holds packed <= 0.6x timeshared
    on a 4x oversubscribed same-bucket CPU storm).
    """
    kw.setdefault("row_step", 8)
    ts = run_load(os.path.join(root, "timeshared"),
                  packed=False, log=log, **kw)
    pk = run_load(os.path.join(root, "packed"),
                  packed=True, log=log, **kw)
    speedup = (round(ts["wall_s"] / pk["wall_s"], 3)
               if pk["wall_s"] else None)
    log(f"compare: timeshared {ts['wall_s']}s vs packed {pk['wall_s']}s "
        f"-> packed/timeshared = "
        f"{'-' if not speedup else format(pk['wall_s'] / ts['wall_s'], '.2f')}x"
        f" (speedup {speedup}x)")
    return {
        "schema": COMPARE_SCHEMA,
        "t": time.time(),
        "timeshared": ts,
        "packed": pk,
        "wall_ratio_packed_over_timeshared": (
            round(pk["wall_s"] / ts["wall_s"], 3) if ts["wall_s"] else None),
        "speedup": speedup,
        "ok": bool(ts["ok"] and pk["ok"]),
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="graftserve load bench (the port's server)")
    ap.add_argument("--root", default=None,
                    help="serve root (default: a fresh temporary directory, removed after)")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--rows", type=int, default=160)
    ap.add_argument("--niterations", type=int, default=1)
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--compare", action="store_true",
                    help="timeshared then packed at the same storm")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    import tempfile

    tmp = None if args.root else tempfile.mkdtemp(prefix="sr_load_")
    root = args.root or tmp
    kw = dict(requests=args.requests, workers=args.workers, capacity=args.capacity,
              rows=args.rows, niterations=args.niterations, device=args.device,
              log=lambda *a: print(*a, file=__import__("sys").stderr))
    try:
        rep = (run_compare(root, **kw) if args.compare
               else run_load(root, packed=args.packed, **kw))
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(rep))
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
