"""MeshPlan: the island mesh's execution plan (port of ``mesh/plan.py``).

One object answers every placement question of the multi-device search:
the grid of ranks, which islands and which dataset rows this rank holds,
whether the mesh runtime dedups its finalize per shard, and how often it
exchanges dedup keys across shards. ``parallel/mesh.py``'s
``shard_search_state`` / ``shard_device_data`` delegate here.

Layout (SURVEY.md §5.8): the per-island fields (``pops``, ``birth``,
``ref``) split their leading island axis over the ``island`` axis in
contiguous blocks, in island-index order; the global state (hall of
fame, running statistics, evaluation counter, key, telemetry) is whole
on every rank; the dataset's rows split over the ``data`` axis when it
has more than one shard, else every rank holds every row.

The JAX plan's donation policy (``donate_state``, ``resolve_donation``)
has no torch analogue: an iteration here builds new tensors and never
donates its input. It is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..parallel.collectives import row_block as block
from ..parallel.mesh import DATA_AXIS, ISLAND_AXIS, RankMesh, make_mesh

__all__ = ["MeshPlan"]


def _leaf_bytes(x) -> int:
    return int(x.numel()) * int(x.element_size()) if isinstance(x, torch.Tensor) else 0


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            if f.init:
                yield from _tensors(getattr(obj, f.name))


def _map(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _map(getattr(obj, f.name), fn)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """The island-mesh execution plan (immutable; one per engine).

    ``sharded_dedup`` gates the mesh runtime's per-shard finalize dedup
    (bit-exact either way: duplicates copy their group leader's result,
    so the A/B is a speed toggle). ``dedup_exchange_every`` is the
    iteration period of the cross-shard dedup-key exchange (0 turns it
    off); the exchange is observability only and never changes the
    search."""

    mesh: RankMesh
    n_island_shards: int
    n_data_shards: int = 1
    sharded_dedup: bool = True
    dedup_exchange_every: int = 8

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, ranks: Optional[Sequence[int]] = None,
              n_island_shards: Optional[int] = None, n_data_shards: int = 1,
              **kw) -> "MeshPlan":
        """Build the ``(island, data)`` grid of ``ranks`` (default: the
        whole process group) and wrap it in a plan."""
        if ranks is None:
            from ..parallel import multihost

            ranks = list(range(multihost.process_count()))
        ranks = list(ranks)
        if n_island_shards is None:
            n_island_shards = len(ranks) // n_data_shards
        mesh = make_mesh(ranks[: n_island_shards * n_data_shards],
                         n_island_shards=n_island_shards, n_data_shards=n_data_shards)
        return cls(mesh=mesh, n_island_shards=n_island_shards,
                   n_data_shards=n_data_shards, **kw)

    def replace(self, **kw) -> "MeshPlan":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Placement questions
    # ------------------------------------------------------------------
    @property
    def island_index(self) -> int:
        return self.mesh.coords()[0]

    @property
    def data_index(self) -> int:
        return self.mesh.coords()[1]

    def island_group(self):
        return self.mesh.groups()[0]

    def data_group(self):
        return self.mesh.groups()[1]

    def islands_of(self, n_islands: int, island_index: Optional[int] = None) -> Tuple[int, int]:
        """[lo, hi) of the islands an island shard holds (this rank's by
        default). ``n_islands`` must divide into the shards."""
        if n_islands % self.n_island_shards:
            raise ValueError(f"{n_islands} islands do not divide into "
                             f"{self.n_island_shards} island shards")
        i = self.island_index if island_index is None else island_index
        per = n_islands // self.n_island_shards
        return i * per, (i + 1) * per

    def rows_of(self, n_rows: int, data_index: Optional[int] = None) -> Tuple[int, int]:
        """[lo, hi) of the dataset rows a data shard holds (this rank's by
        default): contiguous blocks in data-index order; every row with
        one data shard."""
        d = self.data_index if data_index is None else data_index
        return block(n_rows, self.n_data_shards, d)

    # ------------------------------------------------------------------
    # Placement
    # ------------------------------------------------------------------
    def place_state(self, state):
        """This rank's block of a full SearchDeviceState: its islands of
        ``pops``, ``birth`` and ``ref``, the global fields whole."""
        lo, hi = self.islands_of(int(state.birth.shape[0]))
        cut = lambda t: t[lo:hi]
        return dataclasses.replace(state, pops=_map(state.pops, cut), birth=cut(state.birth),
                                   ref=cut(state.ref))

    def gather_state(self, state):
        """The full SearchDeviceState from every island shard's block (a
        collective over the island axis; the inverse of place_state)."""
        from ..parallel.collectives import all_gather_tree

        pops, birth, ref = all_gather_tree(state.pops, state.birth, state.ref,
                                           group=self.island_group())
        return dataclasses.replace(state, pops=pops, birth=birth, ref=ref)

    def place_data(self, data):
        """This rank's block of a DeviceData's rows, which then carries its
        row shard (core/dataset.DeviceData.row_shard), or ``data`` itself
        with one data shard. The baseline and the dimensional row stay the
        whole dataset's."""
        if self.n_data_shards == 1:
            return data
        from ..parallel.collectives import RowShard

        n = data.n
        lo, hi = self.rows_of(n)
        rows = lambda t: None if t is None else t[..., lo:hi].contiguous()
        return dataclasses.replace(
            data, Xt=rows(data.Xt), y=rows(data.y), weights=rows(data.weights),
            class_idx=rows(data.class_idx),
            row_shard=RowShard(group=self.data_group(), n_rows=n, index=self.data_index,
                               count=self.n_data_shards))

    # ------------------------------------------------------------------
    # Introspection (telemetry, docs)
    # ------------------------------------------------------------------
    def exchange_bytes(self, state) -> Dict[str, int]:
        """The bytes a rank receives a iteration through the explicit
        all-gathers, for its placed ``state``: the other shards' blocks of
        ``pops`` and ``birth`` (the hall-of-fame merge and the migration
        pool) and of ``best_seen`` (one hall-of-fame-sized slice per
        island)."""
        others = max(self.n_island_shards - 1, 0)
        I_loc = int(state.birth.shape[0])
        pops_b = sum(_leaf_bytes(x) for x in _tensors(state.pops))
        hof_b = sum(_leaf_bytes(x) for x in _tensors(state.hof))
        return {"pops_bytes": pops_b * others, "best_seen_bytes": hof_b * I_loc * others,
                "birth_bytes": I_loc * 4 * others}

    def describe(self) -> Dict[str, Any]:
        return {
            "axes": {ISLAND_AXIS: self.n_island_shards, DATA_AXIS: self.n_data_shards},
            "n_devices": self.n_island_shards * self.n_data_shards,
            "devices": [f"rank{r}" for r in self.mesh.ranks],
            "sharded_dedup": self.sharded_dedup,
            "dedup_exchange_every": self.dedup_exchange_every,
        }
