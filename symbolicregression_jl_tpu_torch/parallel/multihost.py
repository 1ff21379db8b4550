"""Multi-process execution on ``torch.distributed`` (port of
``parallel/multihost.py``).

The search is one SPMD program: every rank runs the same
``equation_search`` with the same arguments and the same seed, and the
island axis is split over the ranks (``parallel/mesh.py``,
``mesh/plan.py``). Nothing is shipped between processes but tensors:
user operators, template combiners and losses are the ranks' own copies
of the same code.

Usage, once per process before the search::

    from symbolicregression_jl_tpu_torch.parallel import initialize_multihost
    initialize_multihost("10.0.0.1:29500", num_processes=4, process_id=rank)
    # or a file store (no port), as the tests do:
    initialize_multihost(num_processes=2, process_id=rank,
                         init_method="file:///tmp/sr_store", backend="gloo")
    hof = equation_search(X, y, options=options)   # unchanged

The backend is taken explicitly: ``nccl`` where each rank owns a CUDA
device of its own, ``gloo`` for CPU ranks and for several ranks on one
card (NCCL refuses two ranks on one device). ``backend=None`` picks
``nccl`` when the host has a CUDA device for every local rank, else
``gloo``. The group and its collectives run under a timeout, so a rank
that dies fails the run instead of hanging it. With no cluster argument
and no cluster environment (``WORLD_SIZE`` > 1) it is a quiet no-op: the
single-device path.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch

__all__ = ["DEFAULT_TIMEOUT_S", "initialize_multihost", "is_initialized", "is_multihost",
           "process_index", "process_count", "backend", "shutdown"]

#: The group's timeout (seconds) for joining and for every collective.
DEFAULT_TIMEOUT_S = 600.0


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def is_initialized() -> bool:
    dist = _dist()
    return bool(dist is not None and dist.is_initialized())


def _pick_backend(num_processes: int, local_device_ids: Optional[Sequence[int]]) -> str:
    if not torch.cuda.is_available():
        return "gloo"
    if local_device_ids:
        return "nccl"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         local_device_ids: Optional[Sequence[int]] = None, *,
                         backend: Optional[str] = None, init_method: Optional[str] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to the run's process group
    (``torch.distributed.init_process_group``).

    ``coordinator_address`` is rank 0's ``host:port`` (a TCP store), or
    ``init_method`` any store URL (``file://...``, ``tcp://...``,
    ``env://``); without either, ``MASTER_ADDR``/``MASTER_PORT`` with
    ``WORLD_SIZE``/``RANK`` (torchrun's environment) are read.
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``. ``local_device_ids[0]`` is the CUDA device this rank owns
    (default ``LOCAL_RANK``, under ``nccl``). Idempotent once joined."""
    dist = _dist()
    if dist is None or dist.is_initialized():
        return
    env = os.environ
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if init_method is None:
        if coordinator_address is not None:
            init_method = f"tcp://{coordinator_address}"
        elif env.get("MASTER_ADDR") and num_processes:
            init_method = "env://"
    if init_method is None and coordinator_address is None and not num_processes:
        return   # a single process: nothing to join
    if init_method is None or num_processes is None or process_id is None:
        raise RuntimeError(
            "Multi-process initialization needs a store (coordinator_address or "
            "init_method), num_processes and process_id; every process passes the same "
            "store and count and a distinct process_id.")
    chosen = backend or _pick_backend(int(num_processes), local_device_ids)
    if chosen == "nccl":
        local = (local_device_ids[0] if local_device_ids
                 else int(env.get("LOCAL_RANK", process_id)) % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(int(local))
    dist.init_process_group(chosen, init_method=init_method, world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=float(timeout_s)))


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    dist = _dist()
    if dist is not None and dist.is_initialized():
        dist.destroy_process_group()


def is_multihost() -> bool:
    return process_count() > 1


def process_index() -> int:
    """This process's rank (0 writes the run's CSVs and telemetry)."""
    return _dist().get_rank() if is_initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def backend() -> Optional[str]:
    """The default group's backend, or None without a group."""
    return str(_dist().get_backend()) if is_initialized() else None
