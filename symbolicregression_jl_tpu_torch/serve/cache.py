"""Engine cache: share ``Engine`` instances across requests.

Port of the JAX package's ``serve/cache.py``, with its key and its hit
and miss accounting. In the JAX package an ``Engine`` carries the jit
caches of its compiled programs, so a shared engine saves minutes of
tracing. In the port an ``Engine`` holds its evolve configuration, its
complexity tables and the kernels' opcode tables on the device, and the
kernel libraries are loaded once per process (ops/cuda_build.py); a
shared engine saves that set-up and keeps every request of a pack group
on one launch geometry.

Requests whose **canonical Options fingerprint** (api/checkpoint.py
``options_fingerprint`` — every field that can affect the search's
numerics, host-only IO/supervision fields and the seed excluded) and
structural geometry (features, dtype, parameter banks, device) match
reuse one Engine instance. Shape buckets (serve/admission.py) label the
hit/miss counters graftscope reports.

Uncacheable configs — template expressions (host callables inside the
engine), custom callables the fingerprint cannot canonicalize — return
None and the caller builds a fresh Engine; correctness is never traded
for a cache hit.

Concurrency notes: ``Engine.run_iteration`` reads the engine and writes
only tensors it allocates, so tenant threads share one engine safely.
``Engine.degrade_eval_tile_rows`` (the OOM step-down) replaces the shared
engine's configuration — a degrade triggered by one tenant lowers the
screening sample for all of them, which is the intended whole-device
behavior under memory pressure (docs/SERVING.md).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

from ..api.checkpoint import options_fingerprint

__all__ = ["ExecutableCache"]


class ExecutableCache:
    """Process-wide Engine cache keyed by canonical config + geometry."""

    def __init__(
        self,
        on_event: Optional[Callable[[str, Dict[str, Any]], None]] = None,
        max_entries: int = 16,
    ) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[Tuple, Any] = {}
        self._on_event = on_event
        self.max_entries = int(max_entries)
        self.hits = 0
        self.misses = 0
        self.uncacheable = 0
        self.by_bucket: Dict[Tuple[int, int, int],
                             Dict[str, int]] = {}

    # ------------------------------------------------------------------
    def _note(self, kind: str, bucket, detail: Dict[str, Any]) -> None:
        if bucket is not None:
            with self._lock:
                d = self.by_bucket.setdefault(
                    tuple(bucket), {"hits": 0, "misses": 0})
                if kind == "cache_hit":
                    d["hits"] += 1
                elif kind == "cache_miss":
                    d["misses"] += 1
        if self._on_event is not None:
            try:
                self._on_event(kind, detail)
            except Exception:  # pragma: no cover - audit is best-effort
                pass

    @staticmethod
    def _footprint_bytes(fp: Optional[str]) -> Optional[int]:
        """Known footprint for a config fingerprint from the graftgauge
        ledger (largest geometry recorded), stamped onto cache hit/miss
        telemetry: read-only bookkeeping, None until a footprint probe
        has recorded the config."""
        try:
            from ..gauge import global_ledger

            entry = global_ledger().lookup(fp)
            if entry is None:
                return None
            total = (entry.get("summary") or {}).get("total_bytes")
            return int(total) if total else None
        except Exception:  # noqa: BLE001 - audit detail is best-effort
            return None

    # ------------------------------------------------------------------
    def get_engine(
        self,
        options,
        *,
        nfeatures: int,
        dtype,
        n_params: int,
        n_classes: int,
        device,
        rows: int,
        bucket: Optional[Tuple[int, int, int]] = None,
        plan=None,
        mesh_runtime: bool = False,
        template=None,
        n_data_shards: int = 1,
        n_island_shards: int = 1,
        mesh=None,
    ):
        """An Engine for this config — shared when possible, else fresh
        (and cached), else None (uncacheable; caller builds its own).
        Under an island mesh (``plan``, or the JAX package's shard counts
        and ``mesh``: ``MeshPlan.for_layout``) the key also takes the shard
        counts, the rank grid, the dedup policy and the runtime, so a
        mesh engine is never served to another layout or runtime. A
        ``template`` (or the options' template spec) is never cached."""
        from ..evolve.engine import _template_of

        if plan is None:
            from ..mesh.plan import MeshPlan

            plan = MeshPlan.for_layout(n_island_shards, n_data_shards, mesh)

        if bucket is None:
            from .admission import shape_bucket

            bucket = shape_bucket(rows, nfeatures)
        if template is not None or _template_of(options) is not None:
            # template structures hold host callables whose identity the
            # fingerprint cannot guarantee across requests
            self.uncacheable += 1
            self._note("cache_uncacheable", None,
                       {"reason": "template", "bucket": list(bucket)})
            return None
        fp = options_fingerprint(options)
        if fp is None:
            self.uncacheable += 1
            self._note("cache_uncacheable", None,
                       {"reason": "unfingerprintable",
                        "bucket": list(bucket)})
            return None
        key = (fp, int(nfeatures), str(dtype), int(n_params), int(n_classes),
               str(device), _plan_key(plan, mesh_runtime))
        with self._lock:
            engine = self._entries.get(key)
            if engine is not None:
                # LRU refresh: re-insert at the end of the (insertion-
                # ordered) dict so the hottest engine is never the
                # first evicted when the cache fills
                self._entries.pop(key)
                self._entries[key] = engine
                self.hits += 1
        if engine is not None:
            self._note("cache_hit", bucket,
                       {"bucket": list(bucket), "rows": int(rows),
                        "footprint_bytes": self._footprint_bytes(fp)})
            return engine
        from ..mesh.engine import make_engine

        # build OUTSIDE the lock: a slow construction for one config
        # must not serialize other workers' lookups. Losing the insert
        # race costs at most one duplicated build.
        engine = make_engine(options, nfeatures, device=device, n_params=n_params,
                             n_classes=n_classes, dtype=dtype, plan=plan,
                             mesh_runtime=mesh_runtime)
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                engine = existing  # another worker won the race
            else:
                if len(self._entries) >= self.max_entries:
                    # drop the least-recently-used entry (hits
                    # re-insert at the end) — a bounded cache must not
                    # pin every config's engine forever
                    oldest = next(iter(self._entries))
                    self._entries.pop(oldest, None)
                self._entries[key] = engine
            self.misses += 1
        self._note("cache_miss", bucket,
                   {"bucket": list(bucket), "rows": int(rows),
                    "footprint_bytes": self._footprint_bytes(fp)})
        return engine

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "uncacheable": self.uncacheable,
            "hit_rate": (self.hits / total) if total else None,
            "by_bucket": {
                str(list(b)): dict(d) for b, d in self.by_bucket.items()
            },
        }

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


def _plan_key(plan, mesh_runtime: bool):
    """The part of a cache key an island mesh adds (None without one)."""
    if plan is None:
        return None
    return (int(plan.n_island_shards), int(plan.n_data_shards), plan.mesh.ranks,
            int(plan.mesh.rank), bool(plan.sharded_dedup), int(plan.dedup_exchange_every),
            bool(mesh_runtime))
