"""Metric extraction: graftscope JSONL -> the gate's flat metric dict.

A copy of the JAX package's ``bench/extract.py``: every gated number
comes out of the telemetry stream the port's searches emit
(telemetry/report.py's :func:`~..telemetry.report.metrics_view`), so
what the quality check sees is what observability reports.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..telemetry.report import metrics_view, summarize

__all__ = ["extract_metrics", "GATE_METRIC_KEYS"]

# The subset of metrics_view keys the JAX package's gate diffs; the rest
# ride along in result files as context (the port gates the quality ones,
# bench/gate.PORT_GATED).
GATE_METRIC_KEYS = (
    "evals_per_sec", "best_loss", "pareto_volume", "host_fraction",
    "recompiles",
)


def extract_metrics(events: List[dict]) -> Dict[str, Any]:
    """Flat per-cell metrics from a validated graftscope event list."""
    return metrics_view(summarize(events))
