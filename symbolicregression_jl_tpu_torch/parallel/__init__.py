"""Multi-process execution of the search on ``torch.distributed`` (the
reference's Distributed.jl island model as one SPMD program, SURVEY.md
§2.4): process bring-up, the ``(island, data)`` rank grid, and the
collectives."""

from .mesh import make_mesh, replicated, shard_device_data, shard_search_state
from .multihost import initialize_multihost, is_multihost, process_index

__all__ = [
    "make_mesh",
    "replicated",
    "shard_device_data",
    "shard_search_state",
    "initialize_multihost",
    "is_multihost",
    "process_index",
]
