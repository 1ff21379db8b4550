"""MeshEngine: the mesh runtime of the island mesh (port of ``mesh/engine.py``).

In the JAX package the mesh runtime runs the whole iteration inside one
``shard_map`` region with explicit collectives, where the legacy runtime
leaves GSPMD to infer them. In the port both are explicit collectives
around the engine's own steps (``evolve/engine.py``: global draws sliced
per rank, the per-rank cycles and island epilogue with their kernel
launches, the gathered hall-of-fame merge, migration and statistics, each
rank carving its islands back out). The mesh runtime differs from the
legacy one in three flags of that one engine:

- **per-shard finalize dedup**: each rank dedups its local finalize batch
  (exact: duplicates copy their group leader's bit-identical result,
  ops/fused_eval.fused_loss_dedup), where the legacy runtime forfeits
  dedup under island shards; ``plan.sharded_dedup`` gates it for an A/B;
- whenever dedup is eligible the finalize takes the materializing
  loss -> cost chain, dedup on or off: at ragged row counts the fused
  cost epilogue and that chain differ by about an ULP in the JAX
  package, so without the pin an A/B would compare arithmetic, not
  scheduling (ROADMAP.md queue 3);
- the finalize's duplication counters are each shard's, summed over the
  shards (the legacy runtime reports zeros under sharding).

:meth:`MeshEngine.dedup_exchange` gathers the members' identity keys over
the island axis and reports the duplication local to a shard and visible
only across shards, as the telemetry ``mesh`` event.

Determinism: all randomness is drawn island-major before the shard
boundary, migration's draws and pack ranks are computed on gathered
state on every rank, and a 1-shard mesh is bit-identical to the plain
``Engine``. Under more than one shard with the constant optimizer off the
mesh run is bit-identical to the unsharded run; with it on, the fused
optimizer's restart key is decorrelated per shard (``fold_in``), as in
the JAX package.
"""

from __future__ import annotations

import time
from typing import Any, Dict

from ..evolve.engine import Engine, SearchDeviceState
from ..ops.encoding import TreeBatch
from ..parallel.collectives import all_gather_islands, all_sum
from .plan import MeshPlan

__all__ = ["MeshEngine", "make_engine"]


class MeshEngine(Engine):
    """An Engine on the mesh runtime over ``plan``'s island axis (module
    docstring). ``plan.n_data_shards`` must be 1."""

    def __init__(self, options, nfeatures: int, plan: MeshPlan, device=None,
                 window_size: int = 100_000, n_params: int = 0, n_classes: int = 0,
                 dtype=None, template=None):
        if plan.n_data_shards != 1:
            raise NotImplementedError(
                "MeshEngine shards the island axis only; data-row sharded layouts stay on "
                "the legacy GSPMD path (docs/SCALING.md)")
        super().__init__(options, nfeatures, device=device, window_size=window_size,
                         n_params=n_params, n_classes=n_classes, dtype=dtype, plan=plan,
                         template=template)

    def _use_dedup(self) -> bool:
        """Per-shard finalize dedup: the dedup's sorts run on this rank's
        finalize batch, with no collective; ``plan.sharded_dedup`` gates it
        (bit-exact either way)."""
        if not self._dedup_eligible():
            return False
        return self.n_island_shards == 1 or self.plan.sharded_dedup

    def _finalize_fuse_cost(self) -> bool:
        """Where dedup is eligible the finalize takes the materializing
        loss -> cost chain, on or off (module docstring); which is also
        what the unsharded engine's eligible finalize takes."""
        return False if self._dedup_eligible() else self.cfg.fuse_cost

    def _dup_stats(self, local_trees: TreeBatch, all_trees: TreeBatch):
        """Each shard's duplication counters summed over the shards:
        exactly the duplication per-shard dedup exploits (at one shard
        the global counters, bit for bit)."""
        from ..telemetry.counters import member_dup_stats

        rows, unique = member_dup_stats(local_trees)
        group = self._island_group()
        return all_sum(rows, group), all_sum(unique, group)

    # ------------------------------------------------------------------
    def dedup_exchange(self, state: SearchDeviceState) -> Dict[str, Any]:
        """The periodic cross-shard dedup-key exchange (observability only;
        the search state is not touched): gathers the members' identity
        keys (telemetry/counters.member_hash_keys, the keys of the
        duplication counters) over the island axis and splits the
        duplication into the part local to a shard (per-shard dedup
        already exploits it) and the part visible only globally. Every
        rank of the mesh makes the call; the host loop drives it every
        ``plan.dedup_exchange_every`` iterations and emits the result as
        the telemetry ``mesh`` event."""
        from ..telemetry.counters import member_hash_keys, unique_key_count

        group = self._island_group()
        S = self.n_island_shards
        t0 = time.perf_counter()
        keys = member_hash_keys(state.pops.trees)
        local_unique = unique_key_count(keys).reshape(1)
        *gathered, per_shard = all_gather_islands(*keys, local_unique, group=group)
        global_unique = unique_key_count(tuple(gathered))
        ps = [int(v) for v in per_shard.tolist()]
        rows, shard_u, global_u = int(gathered[0].shape[0]), sum(ps), int(global_unique)
        dt = time.perf_counter() - t0
        mean_u = sum(ps) / len(ps) if ps else 0.0
        # graftpulse's shard-balance gauge: each shard's eval work scales
        # with the rows it evaluates, its unique members under per-shard
        # dedup, its whole block otherwise; the slowest shard gates the step.
        eval_rows = ps if self.plan.sharded_dedup else [rows // S] * S
        ratio = max(eval_rows) / max(min(eval_rows), 1) if eval_rows else 1.0
        return {
            "rows": rows,
            "shard_unique": shard_u,
            "global_unique": global_u,
            "local_dup": rows - shard_u,
            "cross_shard_dup": shard_u - global_u,
            "per_shard_unique": ps,
            "shard_imbalance": (max(ps) / mean_u) if mean_u else 1.0,
            "per_shard_eval_rows": eval_rows,
            "shard_eval_imbalance": ratio,
            "exchanged_bytes": 3 * 4 * rows * max(S - 1, 0),
            "exchange_time_s": dt,
            "sharded_dedup": bool(self.plan.sharded_dedup),
        }



def make_engine(options, nfeatures: int, *, device=None, n_params: int = 0, n_classes: int = 0,
                dtype=None, plan: MeshPlan = None, mesh_runtime: bool = False) -> Engine:
    """The engine for one search: the plain ``Engine`` without a plan, the
    legacy sharded runtime (``Engine(plan=)``) or the mesh runtime
    (``MeshEngine``) with one."""
    if plan is not None and mesh_runtime:
        return MeshEngine(options, nfeatures, plan, device=device, n_params=n_params,
                          n_classes=n_classes, dtype=dtype)
    return Engine(options, nfeatures, device=device, n_params=n_params, n_classes=n_classes,
                  dtype=dtype, plan=plan)
