"""Population state and random initialization (port of ``evolve/population.py``).

The reference's vector of PopMember becomes a struct of tensors with a
member axis; leading axes stack islands. Plain expressions only: the JAX
package's per-member parameter banks (parametric expressions) are not
carried.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.encoding import TreeBatch
from . import rng
from .mutation import MutationContext, gen_random_tree

__all__ = ["PopulationState", "init_population"]


@dataclasses.dataclass
class PopulationState:
    trees: TreeBatch          # fields [..., P, L]
    cost: torch.Tensor        # [..., P] float32
    loss: torch.Tensor        # [..., P] float32
    complexity: torch.Tensor  # [..., P] int32
    birth: torch.Tensor       # [..., P] int32 birth-order ticks
    ref: torch.Tensor         # [..., P] int32 lineage id
    parent: torch.Tensor      # [..., P] int32 parent lineage id

    @property
    def pop_size(self) -> int:
        return self.cost.shape[-1]


def init_population(keys: torch.Tensor, population_size: int, ctx: MutationContext,
                    nlength: int = 3) -> TreeBatch:
    """Random trees via `gen_random_tree(nlength=3)`, one population per
    key: keys [..., 2] -> trees [..., P, L]. Costs are filled by the
    caller's eval pass."""
    member_keys = rng.split(keys, population_size)            # [..., P, 2]
    flat = member_keys.reshape(-1, 2)
    trees = gen_random_tree(flat, nlength, ctx)
    return trees.reshape(*member_keys.shape[:-1])
