"""Dispatch-latency histograms (graftgauge, part c; a copy of the JAX
package's ``gauge/latency.py``).

Per-launch host cost is a first-order axis at small geometries. This
module measures it continuously: a log-bucketed host-side histogram of the wall-clock time
each candidate-eval launch spends in the dispatch path (the per-engine
``one()`` closure in the search loop: enqueueing the iteration's device
work, NOT the device execution itself — the blocking sync is timed
separately by the loop's existing device_s accounting).

Bit-neutral by the same contract pulse/ledger pinned: the timer wraps
calls the loop already makes, reads only the wall clock, and feeds
nothing back into the search (tests/test_torch_diagnostics.py pins the on/off
HoF A/B). Rendered via ``PromText.histogram()`` on ``/metrics`` (both the
per-run instance and the process-wide aggregate a serve scrape sees)
and summarized by ``telemetry report`` from the end-of-run ``gauge``
event (kind ``dispatch_latency``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ..pulse.metrics import histogram_quantile

__all__ = ["DispatchLatency", "DEFAULT_LE_BOUNDS", "global_latency"]

# Log-spaced upper bounds (seconds): 0.25 ms .. ~131 s, one octave per
# bucket. Covers a warm CPU-test dispatch (~ms) through a device-scale
# compile-bearing launch (~minutes land in +Inf, which is fine — they
# are outliers by definition).
DEFAULT_LE_BOUNDS = tuple(0.00025 * (2.0 ** i) for i in range(20))


class DispatchLatency:
    """Thread-safe log-bucketed latency accumulator.

    ``counts`` carries one slot per bound plus the +Inf overflow slot —
    exactly the shape ``PromText.histogram`` renders (cumulative
    buckets, ``_count``/``_sum``).
    """

    def __init__(self, le_bounds=DEFAULT_LE_BOUNDS) -> None:
        self.le_bounds = tuple(float(b) for b in le_bounds)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.le_bounds) + 1)
        self._sum = 0.0
        self._max = 0.0

    def observe(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        i = 0
        for i, le in enumerate(self.le_bounds):
            if s <= le:
                break
        else:
            i = len(self.le_bounds)
        with self._lock:
            self._counts[i] += 1
            self._sum += s
            self._max = max(self._max, s)

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    def snapshot(self) -> Dict[str, Any]:
        """Consistent copy: ``{"le", "counts", "count", "sum_s",
        "max_s", "p50_s", "p99_s"}`` (quantiles are bucket-upper-bound
        estimates, None while empty)."""
        with self._lock:
            counts = list(self._counts)
            total = sum(counts)
            sum_s = self._sum
            max_s = self._max
        def _q(q: float) -> Optional[float]:
            v = histogram_quantile(self.le_bounds, counts, q)
            if v is None:
                return None
            # a bucket-upper-bound estimate can exceed the true max
            # when few samples land in a wide bucket; clamp so the
            # report never shows p50 > max
            return min(v, max_s) if total else v

        return {
            "le": list(self.le_bounds),
            "counts": counts,
            "count": total,
            "sum_s": sum_s,
            "max_s": max_s if total else None,
            "p50_s": _q(0.5),
            "p99_s": _q(0.99),
        }

    def to_detail(self) -> Dict[str, Any]:
        """Compact JSON-able summary for the end-of-run ``gauge`` event
        (kind ``dispatch_latency``): scalars plus only the NONZERO
        buckets (the full 21-slot vector is /metrics' job)."""
        snap = self.snapshot()
        return {
            "count": snap["count"],
            "sum_s": round(snap["sum_s"], 6),
            "max_s": (round(snap["max_s"], 6)
                      if snap["max_s"] is not None else None),
            "p50_s": snap["p50_s"],
            "p99_s": snap["p99_s"],
            "buckets": {
                ("inf" if i == len(self.le_bounds)
                 else repr(self.le_bounds[i])): n
                for i, n in enumerate(snap["counts"]) if n
            },
        }

    def render(self, p, *, name: str = "dispatch_latency_seconds",
               help_text: str = ("Host-side candidate-eval dispatch "
                                 "latency (log-bucketed)"),
               labels: Optional[Dict[str, str]] = None) -> None:
        """Append this histogram to a ``PromText`` builder (no-op while
        empty — a scrape before the first dispatch shows no family
        rather than an all-zero one)."""
        snap = self.snapshot()
        if not snap["count"]:
            return
        p.histogram(name, snap["le"], snap["counts"], snap["sum_s"],
                    help_text, labels)


# Process-wide aggregate: every search's per-run instance also feeds
# this one, so a serve process' /metrics shows dispatch latency across
# all tenants without threading a handle through RuntimeOptions.
_GLOBAL = DispatchLatency()


def global_latency() -> DispatchLatency:
    return _GLOBAL
