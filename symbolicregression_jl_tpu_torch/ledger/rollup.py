"""graftledger server rollup: the per-tenant view over a serve root (a copy
of the JAX package's ``ledger/rollup.py``).

``build_rollup(root)`` rescans every request's ``ledger.jsonl`` under
``<root>/requests/<rid>/<rid>/`` and reduces them to one
``graftledger.rollup.v1`` document: per-request wall totals (summed
across resume segments), the folded deterministic view's identity
fields, and fleet totals. ``write_rollup`` persists it as
``<root>/ledger_rollup.json`` — a full rewrite on every request
completion (``SearchServer._finish``), so a crash between writes
loses nothing: the next rewrite rebuilds from the per-request files,
which are the source of truth.

Consumers: the per-tenant counters + histograms on ``/metrics``
(serve/metrics.py) and ``bench load``'s fairness-spread report
(bench/load.py).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional

from .ledger import (
    LATENCY_BUCKETS_S,
    fold_accounts,
    ledger_fingerprint,
    load_accounts,
)

__all__ = ["ROLLUP_SCHEMA", "ROLLUP_NAME", "build_rollup", "write_rollup",
           "load_rollup", "request_ledger_paths"]

ROLLUP_SCHEMA = "graftledger.rollup.v1"
ROLLUP_NAME = "ledger_rollup.json"


def request_ledger_paths(root: str) -> List[str]:
    """Every per-request ledger file under a serve root, sorted for a
    deterministic rollup ordering."""
    return sorted(
        glob.glob(os.path.join(root, "requests", "*", "*", "ledger.jsonl")))


def _sum_hist(acc: Optional[List[int]], counts: List[int]) -> List[int]:
    if acc is None:
        return list(counts)
    return [a + b for a, b in zip(acc, counts)]


def build_rollup(root: str) -> Dict[str, Any]:
    """Scan + fold every request ledger under ``root``; unreadable or
    invalid files are reported under ``errors`` instead of raising —
    the rollup writer runs on the server's hot completion path."""
    requests: Dict[str, Any] = {}
    errors: List[str] = []
    totals = {
        "device_s": 0.0, "host_s": 0.0, "compile_s": 0.0,
        "num_evals": 0.0, "iterations": 0,
        "checkpoint_bytes": 0, "checkpoints": 0,
    }
    hist_total: Optional[List[int]] = None
    for path in request_ledger_paths(root):
        try:
            accounts = load_accounts(path)
            folded = fold_accounts(accounts)
            fingerprint = ledger_fingerprint(path)
        except (OSError, ValueError) as e:
            errors.append(f"{path}: {e}")
            continue
        rid = folded["request_id"]
        device_s = host_s = compile_s = 0.0
        ckpt_bytes = ckpt_count = 0
        hist: Optional[List[int]] = None
        for a in accounts:
            wall = a.get("wall", {})
            device_s += float(wall.get("device_s", 0.0))
            host_s += float(wall.get("host_s", 0.0))
            compile_s += sum(
                float(v) for v in wall.get("compile", {}).values())
            ck = wall.get("checkpoints", {})
            ckpt_bytes += int(ck.get("bytes", 0))
            ckpt_count += int(ck.get("count", 0))
            counts = wall.get("iteration_latency", {}).get("counts")
            if isinstance(counts, list):
                hist = _sum_hist(hist, counts)
        requests[rid] = {
            "trace_id": (folded.get("trace") or {}).get("trace_id"),
            "run_id": folded.get("run_id"),
            "iterations": folded["iterations"],
            "num_evals": folded["num_evals"],
            "stop_reason": folded["stop_reason"],
            "segments": len(accounts),
            "fingerprint": fingerprint,
            "device_s": device_s,
            "host_s": host_s,
            "compile_s": compile_s,
            "checkpoint_bytes": ckpt_bytes,
            "checkpoints": ckpt_count,
            "iteration_latency": {
                "le": list(LATENCY_BUCKETS_S),
                "counts": hist or [0] * (len(LATENCY_BUCKETS_S) + 1),
            },
        }
        totals["device_s"] += device_s
        totals["host_s"] += host_s
        totals["compile_s"] += compile_s
        totals["num_evals"] += folded["num_evals"]
        totals["iterations"] += folded["iterations"]
        totals["checkpoint_bytes"] += ckpt_bytes
        totals["checkpoints"] += ckpt_count
        hist_total = _sum_hist(hist_total, requests[rid][
            "iteration_latency"]["counts"])
    return {
        "schema": ROLLUP_SCHEMA,
        "root": os.path.abspath(root),
        "requests": requests,
        "totals": totals,
        "iteration_latency": {
            "le": list(LATENCY_BUCKETS_S),
            "counts": hist_total or [0] * (len(LATENCY_BUCKETS_S) + 1),
        },
        "errors": errors,
    }


def write_rollup(root: str) -> Optional[str]:
    """Rebuild + atomically replace ``<root>/ledger_rollup.json``."""
    path = os.path.join(root, ROLLUP_NAME)
    try:
        rollup = build_rollup(root)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rollup, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path
    except OSError:  # accounting must never break serving
        return None


def load_rollup(root: str) -> Optional[Dict[str, Any]]:
    """Read the persisted rollup; None when absent/unreadable."""
    try:
        with open(os.path.join(root, ROLLUP_NAME)) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return obj if obj.get("schema") == ROLLUP_SCHEMA else None
