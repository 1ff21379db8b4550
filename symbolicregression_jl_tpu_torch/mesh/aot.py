"""The executable cache of mesh engines (port of ``mesh/aot.py``, its
cache only).

In the JAX package this module lowers and compiles the mesh iteration
ahead of time (``jit(...).lower().compile()``), harvests its cost and
memory analyses and serializes the executable, so a restarted replica
loads the program instead of recompiling it. None of that has a torch
analogue: an iteration here is host code that launches the kernels,
which ``ops/cuda_build.py`` builds once per process and keeps on disk.
Those parts are left out. What the port keeps is the cache: a mesh
engine is built once per key and every later request with the same key
(the options' fingerprint, the plan, the geometry) is served that
engine, whose iteration equals a fresh engine's.

``compile_iteration`` returns a :class:`MeshIterationExecutable` (the
engine and its key); ``run`` dispatches one iteration through it.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional

__all__ = ["MeshIterationExecutable", "aot_cache_key", "compile_iteration",
           "executable_cache_stats"]

_EXECUTABLES: Dict[str, "MeshIterationExecutable"] = {}
_STATS = {"hits": 0, "misses": 0, "uncacheable": 0}


def aot_cache_key(engine, rows: int) -> Optional[str]:
    """An engine's identity: the canonical options fingerprint (None for
    an uncacheable configuration, under serve/cache.py's rules) with the
    plan and the geometry it runs at."""
    from ..api.checkpoint import options_fingerprint

    fp = options_fingerprint(engine.options)
    if fp is None:
        return None
    plan = engine.plan
    grid = plan.mesh.ranks if plan is not None else ()
    geom = (f"{fp}|nfeat={engine.nfeatures}|rows={int(rows)}"
            f"|shards={engine.n_island_shards}"
            f"|data_shards={plan.n_data_shards if plan is not None else 1}|ranks={grid}"
            f"|rank={plan.mesh.rank if plan is not None else 0}"
            f"|runtime={type(engine).__name__}"
            f"|dedup={plan.sharded_dedup if plan is not None else None}"
            f"|dtype={engine.dtype}|device={engine.device}")
    return hashlib.sha256(geom.encode()).hexdigest()


@dataclasses.dataclass
class MeshIterationExecutable:
    """A cached mesh engine and its key."""

    engine: Any
    cache_key: Optional[str]

    @property
    def n_devices(self) -> int:
        plan = self.engine.plan
        return plan.mesh.size if plan is not None else 1

    def run(self, state, data, cur_maxsize):
        """Dispatch one iteration (every rank of the mesh makes the call)."""
        return self.engine.run_iteration(state, data, int(cur_maxsize))


def compile_iteration(engine, state=None, data=None, cur_maxsize=None,
                      rows: Optional[int] = None) -> MeshIterationExecutable:
    """The executable of ``engine``'s key: the first engine built for the
    key serves every later request with it (``engine`` is the one
    offered). ``data`` (or ``rows``) gives the geometry; ``state`` and
    ``cur_maxsize`` are accepted for the JAX signature and unused."""
    del state, cur_maxsize
    n = int(rows if rows is not None else data.n)
    key = aot_cache_key(engine, n)
    if key is None:
        _STATS["uncacheable"] += 1
        return MeshIterationExecutable(engine, None)
    hit = _EXECUTABLES.get(key)
    if hit is not None:
        _STATS["hits"] += 1
        return hit
    _STATS["misses"] += 1
    ex = MeshIterationExecutable(engine, key)
    _EXECUTABLES[key] = ex
    return ex


def executable_cache_stats(clear: bool = False) -> Dict[str, Any]:
    """Entries, hits, misses and uncacheable requests of the cache."""
    out = dict(_STATS, entries=len(_EXECUTABLES))
    if clear:
        _EXECUTABLES.clear()
        _STATS.update(hits=0, misses=0, uncacheable=0)
    return out
