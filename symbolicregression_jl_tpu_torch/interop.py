"""Build the port's tensors from the JAX package's state held as numpy.

The caller converts the JAX package's objects to numpy first (for
example ``jax.tree.map(np.asarray, state)``, and ``jax.random.key_data``
for a key); this module never sees a JAX array. Each function reads the
fields by name, so any object with those numpy attributes will do. Both
packages can then start from the same population and the same key.
Template states carry over as they are: their trees keep the key axis
([I, P, K, L] in the populations, [maxsize, K, L] in the hall of fame).
Parameter banks (``params``, zero-sized for plain expressions) and a
dataset's class column carry over too. Like the port's other entry
points, every function puts its tensors on the GPU unless the caller asks
for the CPU (``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.dataset import DeviceData
from .device import resolve_device
from .evolve.engine import RunningStats, SearchDeviceState
from .evolve.population import PopulationState
from .evolve.step import HofState
from .ops.encoding import TreeBatch

__all__ = ["tensor", "key", "tree_batch", "population_state", "hof_state", "running_stats",
           "device_data", "search_state"]


def tensor(a, device=None) -> torch.Tensor:
    """numpy array (or scalar) -> tensor with the same dtype and shape;
    uint32 becomes int32 with the same bits."""
    arr = np.array(a, order="C", copy=True)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(resolve_device(device))


def key(words, device=None) -> torch.Tensor:
    """threefry key words (uint32 [..., 2], as ``jax.random.key_data``
    gives them) -> the port's int32 key tensor."""
    return tensor(np.asarray(words, dtype=np.uint32), device)


def tree_batch(t, device=None) -> TreeBatch:
    return TreeBatch(*(tensor(getattr(t, f), device)
                       for f in ("arity", "op", "feat", "const", "length")))


def population_state(p, device=None) -> PopulationState:
    """Plain, parametric or template populations, parameter banks included."""
    return PopulationState(
        trees=tree_batch(p.trees, device),
        **{f: tensor(getattr(p, f), device)
           for f in ("cost", "loss", "complexity", "birth", "ref", "parent", "params")})


def hof_state(h, device=None) -> HofState:
    return HofState(trees=tree_batch(h.trees, device),
                    **{f: tensor(getattr(h, f), device)
                       for f in ("cost", "loss", "complexity", "exists", "params")})


def running_stats(s, device=None) -> RunningStats:
    return RunningStats(tensor(s.frequencies, device), tensor(s.normalized_frequencies, device))


def device_data(d, device=None) -> DeviceData:
    return DeviceData(
        Xt=tensor(d.Xt, device), y=tensor(d.y, device),
        weights=None if d.weights is None else tensor(d.weights, device),
        baseline_loss=tensor(d.baseline_loss, device),
        use_baseline=tensor(d.use_baseline, device),
        class_idx=None if d.class_idx is None else tensor(d.class_idx, device))


def search_state(s, device=None) -> SearchDeviceState:
    """``SearchDeviceState`` from its numpy pieces; ``s.key`` holds the
    key's uint32 words (replace the typed key with
    ``jax.random.key_data(key)`` before converting to numpy)."""
    return SearchDeviceState(
        pops=population_state(s.pops, device), hof=hof_state(s.hof, device),
        stats=running_stats(s.stats, device), birth=tensor(s.birth, device),
        ref=tensor(s.ref, device), num_evals=tensor(s.num_evals, device),
        key=key(s.key, device))
