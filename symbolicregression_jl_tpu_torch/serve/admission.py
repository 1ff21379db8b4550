"""Admission control: bounded, shape-bucketed request classes with
structured backpressure (a copy of the JAX package's
``serve/admission.py``: the same buckets and decisions for the same
sequence).

Every request is classified into a **shape bucket** — dataset rows
rounded up to a power of two (floored at ``MIN_ROW_BUCKET``) plus the
exact feature/output counts. Buckets serve two purposes:

1. **admission classes**: the queue is bounded both in total and per
   bucket, so a storm of one shape cannot starve every other class of
   its share of the queue;
2. **engine-cache accounting**: requests in one bucket are the ones
   that can share an engine (serve/cache.py), and the
   hit/miss counters graftscope reports are grouped by bucket.

Saturation never blocks and never hangs: ``decide`` either admits
(possibly degraded by the :class:`~..shield.degrade.OverloadLadder`) or
raises :class:`ServerSaturated`, a structured error carrying the queue
depth, the bucket, and a retry-after hint derived from observed request
service times — the reject-with-retry-after contract in docs/SERVING.md.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

from ..shield.degrade import OverloadLadder

__all__ = [
    "MIN_ROW_BUCKET",
    "ServerSaturated",
    "AdmissionDecision",
    "AdmissionController",
    "shape_bucket",
]

MIN_ROW_BUCKET = 256


def shape_bucket(n_rows: int, nfeatures: int, nout: int = 1
                 ) -> Tuple[int, int, int]:
    """(row-bucket, nfeatures, nout): rows rounded up to a power of two,
    never below ``MIN_ROW_BUCKET`` — the granularity at which requests
    share a launch geometry."""
    b = MIN_ROW_BUCKET
    while b < int(n_rows):
        b *= 2
    return (b, int(nfeatures), int(nout))


class ServerSaturated(RuntimeError):
    """Structured backpressure: the queue (total or this request's shape
    class) is full. Clients should back off for ``retry_after_s`` and
    resubmit; nothing was journaled or enqueued."""

    def __init__(self, message: str, *, retry_after_s: float,
                 queue_depth: int, capacity: int,
                 bucket: Tuple[int, int, int],
                 level: str = "reject") -> None:
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.queue_depth = int(queue_depth)
        self.capacity = int(capacity)
        self.bucket = tuple(bucket)
        self.level = level

    def to_dict(self) -> dict:
        return {
            "error": "server_saturated",
            "message": str(self),
            "retry_after_s": self.retry_after_s,
            "queue_depth": self.queue_depth,
            "capacity": self.capacity,
            "bucket": list(self.bucket),
            "level": self.level,
        }


@dataclasses.dataclass
class AdmissionDecision:
    admitted: bool
    bucket: Tuple[int, int, int]
    priority: int
    sample_rows: Optional[int]
    level: str
    utilization: float
    # graftgauge memory advisory (capacity.HeadroomModel.advise):
    # predicted program bytes vs the device byte budget for this shape
    # bucket, or None when no headroom model is attached / the ledger
    # has no history for the shape. ADVISORY ONLY — admission never
    # rejects on it (a floor estimate's false "no" would be an outage);
    # it is recorded on the accept audit event for operators to alert
    # on.
    memory: Optional[dict] = None


class AdmissionController:
    """Bounded admission with shape-bucketed classes + overload ladder.

    ``capacity`` bounds queued-plus-running requests in total;
    ``bucket_capacity`` (default: the full capacity, i.e. no per-class
    penalty) optionally bounds any single shape class so one shape's
    storm cannot monopolize the queue. Thread-safe; the server calls
    ``admit``/``release`` around a request's queued+running lifetime.
    """

    def __init__(
        self,
        capacity: int = 8,
        *,
        bucket_capacity: Optional[int] = None,
        ladder: Optional[OverloadLadder] = None,
        default_retry_after_s: float = 5.0,
        headroom=None,
        memory_limit_bytes: Optional[int] = None,
    ) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.bucket_capacity = int(
            bucket_capacity if bucket_capacity is not None else capacity
        )
        self.ladder = ladder or OverloadLadder()
        self.default_retry_after_s = float(default_retry_after_s)
        # graftgauge memory-aware admission (docs/SERVING.md): a
        # capacity.HeadroomModel whose advisory is attached to every
        # admitted decision; memory_limit_bytes overrides the backend
        # allocator limit (the only source on CPU)
        self.headroom = headroom
        self.memory_limit_bytes = memory_limit_bytes
        self._lock = threading.Lock()
        self._in_flight: Dict[Tuple[int, int, int], int] = {}
        self._total = 0
        # EWMA of request service time → retry-after hint
        self._avg_service_s: Optional[float] = None

    # ------------------------------------------------------------------
    @property
    def depth(self) -> int:
        return self._total

    def utilization(self) -> float:
        return self._total / self.capacity

    def in_flight_by_bucket(self) -> Dict[Tuple[int, int, int], int]:
        """Snapshot of per-bucket queued+running counts (the /metrics
        per-bucket admission gauges read this)."""
        with self._lock:
            return dict(self._in_flight)

    def observe_service_time(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        self._avg_service_s = (
            s if self._avg_service_s is None
            else 0.8 * self._avg_service_s + 0.2 * s
        )

    def retry_after_s(self, queue_depth: int) -> float:
        """Drain-time estimate: how long until a queue slot frees."""
        per = self._avg_service_s
        if per is None:
            return self.default_retry_after_s
        return max(per * max(queue_depth, 1) / max(self.capacity, 1), per)

    # ------------------------------------------------------------------
    def admit(self, *, n_rows: int, nfeatures: int, nout: int = 1,
              priority: int = 0, request_id: str = ""
              ) -> AdmissionDecision:
        """Admit (and count) one request, or raise ServerSaturated."""
        bucket = shape_bucket(n_rows, nfeatures, nout)
        # memory advisory BEFORE taking the admission lock: advise()
        # reads the footprint ledger (its own lock) and the backend
        # allocator — neither may nest inside self._lock
        memory = None
        if self.headroom is not None:
            try:
                memory = self.headroom.advise(
                    bucket=bucket, limit_bytes=self.memory_limit_bytes)
            except Exception:  # noqa: BLE001 - advisory is best-effort
                memory = None
        with self._lock:
            util = self._total / self.capacity
            bucket_depth = self._in_flight.get(bucket, 0)
            if self._total >= self.capacity or (
                    bucket_depth >= self.bucket_capacity):
                scope = ("queue" if self._total >= self.capacity
                         else f"shape class {bucket}")
                self.ladder.rejects_total += 1
                raise ServerSaturated(
                    f"server saturated: {scope} is full "
                    f"({self._total}/{self.capacity} total, "
                    f"{bucket_depth}/{self.bucket_capacity} in bucket)",
                    retry_after_s=self.retry_after_s(self._total),
                    queue_depth=self._total, capacity=self.capacity,
                    bucket=bucket,
                )
            shed = self.ladder.apply(
                util, n_rows=n_rows, priority=priority,
                request_id=request_id)
            if not shed["admit"]:
                raise ServerSaturated(
                    f"server overloaded (utilization {util:.0%} >= "
                    f"reject threshold)",
                    retry_after_s=self.retry_after_s(self._total),
                    queue_depth=self._total, capacity=self.capacity,
                    bucket=bucket, level=shed["level"],
                )
            self._in_flight[bucket] = bucket_depth + 1
            self._total += 1
            return AdmissionDecision(
                admitted=True, bucket=bucket,
                priority=shed["priority"],
                sample_rows=shed["sample_rows"],
                level=shed["level"], utilization=util,
                memory=memory,
            )

    def readmit(self, bucket: Tuple[int, int, int]) -> None:
        """Count a journal-replayed request WITHOUT bounds or ladder:
        an accepted request survives a restart unconditionally — the
        admission decision was already made (and journaled) by the
        process that accepted it. Recovery may transiently exceed
        capacity; new submissions then see a saturated queue until the
        backlog drains, which is the correct backpressure."""
        bucket = tuple(bucket)
        with self._lock:
            self._in_flight[bucket] = self._in_flight.get(bucket, 0) + 1
            self._total += 1

    def release(self, bucket: Tuple[int, int, int]) -> None:
        """A request left the system (done/failed/cancelled)."""
        bucket = tuple(bucket)
        with self._lock:
            self._total = max(self._total - 1, 0)
            n = self._in_flight.get(bucket, 0)
            if n <= 1:
                self._in_flight.pop(bucket, None)
            else:
                self._in_flight[bucket] = n - 1
