"""Prometheus text-exposition builder for the live metrics surface (a copy
of the JAX package's ``pulse/metrics.py``, which raises on a NaN or
non-numeric sample; the port renders it as ``nan``).

graftserve's ``/metrics`` endpoint (serve/metrics.py) renders its
gauges through this tiny builder rather than depending on the
``prometheus_client`` package (not in the image, and overkill for a
read-only exposition of a dozen gauges). The output follows the
text format v0.0.4: one ``# HELP`` / ``# TYPE`` pair per metric family
(emitted once, on first sample), then one sample line per label set.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

__all__ = ["PromText", "histogram_quantile"]


def histogram_quantile(le_bounds: Sequence[float],
                       counts: Sequence[int],
                       q: float) -> Optional[float]:
    """Bucket-upper-bound quantile estimate over a pre-bucketed
    histogram (``counts`` may carry the extra +Inf slot past
    ``le_bounds``). Returns the upper bound of the bucket containing
    the q-th sample — the same coarse-but-honest estimate a
    ``histogram_quantile()`` PromQL query makes — or None while empty.
    Samples in the +Inf bucket report the last finite bound (a floor,
    not a fabricated extrapolation)."""
    total = sum(int(n) for n in counts)
    if total <= 0 or not le_bounds:
        return None
    target = max(min(float(q), 1.0), 0.0) * total
    cum = 0
    for i, n in enumerate(counts):
        cum += int(n)
        if cum >= target and cum > 0:
            return float(le_bounds[min(i, len(le_bounds) - 1)])
    return float(le_bounds[-1])


def _escape_label(value: str) -> str:
    return (str(value)
            .replace("\\", "\\\\")
            .replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


class PromText:
    """Accumulate samples, then ``render()`` the exposition body."""

    def __init__(self, prefix: str = "graftserve") -> None:
        self.prefix = prefix
        self._lines: List[str] = []
        self._seen_meta: Dict[str, str] = {}  # family -> declared type

    def _sample(self, name: str, mtype: str, help_text: str,
                value, labels: Optional[Dict[str, str]]) -> None:
        family = f"{self.prefix}_{name}" if self.prefix else name
        if family not in self._seen_meta:
            self._seen_meta[family] = mtype
            self._lines.append(f"# HELP {family} {_escape_help(help_text)}")
            self._lines.append(f"# TYPE {family} {mtype}")
        label_str = ""
        if labels:
            pairs = ",".join(
                f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items()))
            label_str = "{" + pairs + "}"
        try:
            v = float(value)
        except (TypeError, ValueError):
            v = float("nan")
        # integers render without a trailing .0 (matches common
        # exporters; keeps counters diff-friendly)
        # (a NaN or inf renders as Python spells it: int() would raise)
        body = (repr(int(v)) if math.isfinite(v) and v == int(v) and abs(v) < 1e15
                else repr(v))
        self._lines.append(f"{family}{label_str} {body}")

    def gauge(self, name: str, value, help_text: str = "",
              labels: Optional[Dict[str, str]] = None) -> "PromText":
        self._sample(name, "gauge", help_text, value, labels)
        return self

    def counter(self, name: str, value, help_text: str = "",
                labels: Optional[Dict[str, str]] = None) -> "PromText":
        self._sample(name, "counter", help_text, value, labels)
        return self

    def histogram(self, name: str, le_bounds, bucket_counts, sum_value,
                  help_text: str = "",
                  labels: Optional[Dict[str, str]] = None) -> "PromText":
        """One pre-bucketed histogram sample set (graftledger's
        log-bucketed iteration latencies): ``bucket_counts`` has one
        extra slot past ``le_bounds`` for the +Inf bucket; buckets
        render CUMULATIVE per the exposition format, plus the
        ``_count`` / ``_sum`` series."""
        family = f"{self.prefix}_{name}" if self.prefix else name
        if family not in self._seen_meta:
            self._seen_meta[family] = "histogram"
            self._lines.append(f"# HELP {family} {_escape_help(help_text)}")
            self._lines.append(f"# TYPE {family} histogram")
        base = dict(labels or {})

        def label_str(extra: Dict[str, str]) -> str:
            pairs = ",".join(
                f'{k}="{_escape_label(v)}"'
                for k, v in sorted({**base, **extra}.items()))
            return "{" + pairs + "}" if pairs else ""

        cum = 0
        for le, n in zip(le_bounds, bucket_counts):
            cum += int(n)
            self._lines.append(
                f"{family}_bucket{label_str({'le': repr(float(le))})} {cum}")
        cum += int(bucket_counts[len(le_bounds)]) \
            if len(bucket_counts) > len(le_bounds) else 0
        self._lines.append(
            f"{family}_bucket{label_str({'le': '+Inf'})} {cum}")
        self._lines.append(f"{family}_count{label_str({})} {cum}")
        self._lines.append(
            f"{family}_sum{label_str({})} {float(sum_value)!r}")
        return self

    def render(self) -> str:
        return "\n".join(self._lines) + ("\n" if self._lines else "")
