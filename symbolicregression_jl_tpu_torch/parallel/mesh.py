"""The ``(island, data)`` grid of ranks (port of ``parallel/mesh.py``).

The JAX package lays its devices out as a ``Mesh`` with axes ``island``
and ``data``; here the devices are the ranks of the ``torch.distributed``
group, one device each. :func:`make_mesh` arranges the ranks into the
grid and :class:`RankMesh` holds it, with this rank's coordinates and
its two subgroups: the ranks of its data index (the island axis, over
which populations are gathered) and the ranks of its island index (the
data axis, over which row partials are added). Islands shard over the
island axis; dataset rows shard over the data axis when it has more
than one shard, else every rank holds every row.

``shard_search_state`` and ``shard_device_data`` delegate to
``mesh/plan.MeshPlan``, so the helpers and the mesh runtime cannot
disagree about placement. A placement is a :class:`RankSharding`: the
grid and a spec, the mesh axis each tensor axis is split over (the JAX
package's ``NamedSharding`` and ``PartitionSpec`` as a tuple);
:func:`replicated` is the whole tensor on every rank.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from . import multihost

__all__ = ["ISLAND_AXIS", "DATA_AXIS", "RankMesh", "RankSharding", "make_mesh", "replicated",
           "shard_search_state", "shard_device_data"]

ISLAND_AXIS = "island"
DATA_AXIS = "data"


@dataclasses.dataclass
class RankMesh:
    """The ranks as an [n_island_shards, n_data_shards] grid. ``rank`` is
    this process's rank (0 without a process group)."""

    grid: np.ndarray
    rank: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return {ISLAND_AXIS: int(self.grid.shape[0]), DATA_AXIS: int(self.grid.shape[1])}

    @property
    def ranks(self) -> Tuple[int, ...]:
        return tuple(int(r) for r in self.grid.reshape(-1))

    @property
    def size(self) -> int:
        return int(self.grid.size)

    def coords(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """(island index, data index) of ``rank`` (this rank by default)."""
        r = self.rank if rank is None else rank
        hit = np.argwhere(self.grid == r)
        if not len(hit):
            raise ValueError(f"rank {r} is not in the mesh {self.ranks}")
        return int(hit[0][0]), int(hit[0][1])

    def contains(self, rank: Optional[int] = None) -> bool:
        return bool((self.grid == (self.rank if rank is None else rank)).any())

    def groups(self, timeout_s: Optional[float] = None) -> Tuple[Any, Any]:
        """(island group, data group) of this rank, made on the first call
        with the group of every rank of the mesh (:meth:`all_group`).
        Every rank of the process group must make this call at the same
        point (``new_group`` is collective); a group of one rank is None
        (its collectives are the identity), a group of the whole world
        in rank order the default group. Without a process group all
        three are None."""
        if getattr(self, "_groups", None) is not None:
            return self._groups
        out = (None, None)
        self._all = None
        if multihost.is_initialized():
            import torch.distributed as dist

            world = dist.get_world_size()
            t = datetime.timedelta(seconds=float(timeout_s or multihost.DEFAULT_TIMEOUT_S))
            made: Dict[Tuple[int, ...], Any] = {}

            def group_of(ranks: Tuple[int, ...]):
                if ranks not in made:
                    if len(ranks) == world and ranks == tuple(range(world)):
                        made[ranks] = dist.group.WORLD
                    elif len(ranks) == 1:
                        made[ranks] = None
                    else:
                        made[ranks] = dist.new_group(list(ranks), timeout=t)
                return made[ranks]

            island_groups = [group_of(tuple(int(r) for r in self.grid[:, d]))
                             for d in range(self.grid.shape[1])]
            data_groups = [group_of(tuple(int(r) for r in self.grid[i, :]))
                           for i in range(self.grid.shape[0])]
            everyone = group_of(tuple(sorted(self.ranks)))
            if self.contains():
                self._all = everyone
                i, d = self.coords()
                out = (island_groups[d], data_groups[i])
        self._groups = out
        return out

    def all_group(self):
        """The group of every rank of the mesh (host decisions such as the
        stop reason are agreed over it); None without a process group."""
        self.groups()
        return self._all


def make_mesh(devices: Optional[Sequence[int]] = None, n_island_shards: Optional[int] = None,
              n_data_shards: int = 1) -> RankMesh:
    """Arrange ``devices``, ranks here (default: every rank of the process
    group, or rank 0 without one), as an ``(island, data)`` grid. By
    default every rank goes to the island axis; ``n_data_shards > 1``
    splits each island shard's rows over that many ranks."""
    ranks = list(devices if devices is not None else range(multihost.process_count()))
    n = len(ranks)
    if n_island_shards is None:
        n_island_shards = n // n_data_shards
    if n_island_shards * n_data_shards != n:
        raise ValueError(f"mesh shape {n_island_shards}x{n_data_shards} != {n} devices")
    grid = np.array(ranks, dtype=np.int64).reshape(n_island_shards, n_data_shards)
    return RankMesh(grid=grid, rank=multihost.process_index())


@dataclasses.dataclass(frozen=True)
class RankSharding:
    """Where a tensor lives on the grid: ``spec[i]`` names the mesh axis
    tensor axis i is split over in contiguous blocks (None: whole), and
    axes past the spec are whole, as in a ``PartitionSpec``."""

    mesh: RankMesh
    spec: Tuple[Optional[str], ...] = ()


def replicated(mesh: RankMesh) -> RankSharding:
    """Every rank holds the whole tensor."""
    return RankSharding(mesh, ())


def _plan_for(mesh: RankMesh):
    from ..mesh.plan import MeshPlan

    return MeshPlan(mesh=mesh, n_island_shards=mesh.shape[ISLAND_AXIS],
                    n_data_shards=mesh.shape[DATA_AXIS])


def shard_search_state(state, mesh: RankMesh):
    """This rank's block of a full SearchDeviceState: its islands of the
    per-island fields, the global fields whole (``MeshPlan.place_state``)."""
    return _plan_for(mesh).place_state(state)


def shard_device_data(data, mesh: RankMesh):
    """This rank's block of the dataset's rows over the ``data`` axis, or
    the whole dataset with one data shard (``MeshPlan.place_data``)."""
    return _plan_for(mesh).place_data(data)
