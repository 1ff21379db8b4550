"""graftmesh for the port: the island mesh's plan and runtimes on
``torch.distributed``.

- :class:`MeshPlan` — the grid of ranks, which islands and rows each rank
  holds, the dedup and dedup-exchange policy, in one inspectable object.
- :class:`MeshEngine` — the mesh runtime: an ``Engine`` whose island-local
  phases run per rank, with explicit collectives for the hall-of-fame
  merge, the migration pool and the counters, per-shard finalize dedup,
  and the periodic cross-shard dedup-key exchange (telemetry ``mesh``
  events). The legacy runtime is the same engine without those flags
  (``Engine(plan=...)``).
- :mod:`.aot` — the executable cache of mesh engines.
- :mod:`.dryrun` — the dryrun tier over N gloo CPU ranks (the MULTICHIP
  artifact).
"""

from .engine import MeshEngine
from .plan import MeshPlan

__all__ = ["MeshPlan", "MeshEngine"]
