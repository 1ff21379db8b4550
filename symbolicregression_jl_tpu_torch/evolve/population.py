"""Population state and random initialization (port of ``evolve/population.py``).

The reference's vector of PopMember becomes a struct of tensors with a
member axis; leading axes stack islands. Template members carry a key
axis: trees [..., P, K, L]. Every member has a parameter bank
``params`` [..., P, NP, NC]: its per-class parameters for parametric
expressions, its template parameter vector as [total_params, 1] for
templates with parameters, and zero-sized (NP = NC = 0) otherwise.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.encoding import TreeBatch
from . import rng
from .mutation import MutationContext, gen_random_tree

__all__ = ["PopulationState", "init_population", "init_template_population", "init_params",
           "zero_params"]


@dataclasses.dataclass
class PopulationState:
    trees: TreeBatch          # fields [..., P, L] ([..., P, K, L] for templates)
    cost: torch.Tensor        # [..., P] float32
    loss: torch.Tensor        # [..., P] float32
    complexity: torch.Tensor  # [..., P] int32
    birth: torch.Tensor       # [..., P] int32 birth-order ticks
    ref: torch.Tensor         # [..., P] int32 lineage id
    parent: torch.Tensor      # [..., P] int32 parent lineage id
    params: torch.Tensor      # [..., P, NP, NC] float32 parameter banks

    @property
    def pop_size(self) -> int:
        return self.cost.shape[-1]

    @property
    def n_params(self) -> int:
        return self.params.shape[-2]


def zero_params(batch_shape, n_params: int, n_classes: int, device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.zeros((*batch_shape, n_params, n_classes), dtype=dtype, device=device)


def init_params(key: torch.Tensor, batch_shape, n_params: int, n_classes: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard-normal parameter banks [*batch_shape, NP, NC] in ``dtype``,
    drawn as ``jax.random.normal(key, shape, dtype)`` draws them;
    zero-sized without parameters."""
    if n_params == 0:
        return zero_params(batch_shape, n_params, n_classes, key.device, dtype)
    return rng.normal(key, (*batch_shape, n_params, n_classes), dtype)


def init_population(keys: torch.Tensor, population_size: int, ctx: MutationContext,
                    nlength: int = 3) -> TreeBatch:
    """Random trees via `gen_random_tree(nlength=3)`, one population per
    key: keys [..., 2] -> trees [..., P, L]. Costs are filled by the
    caller's eval pass."""
    member_keys = rng.split(keys, population_size)            # [..., P, 2]
    flat = member_keys.reshape(-1, 2)
    trees = gen_random_tree(flat, nlength, ctx)
    return trees.reshape(*member_keys.shape[:-1])


def init_template_population(keys: torch.Tensor, population_size: int, template,
                             ctx: MutationContext, nlength: int = 3) -> TreeBatch:
    """Random template members [..., P, K, L], one population per key:
    subexpression k is generated with its own argument count from
    ``fold_in(key, k)``, as the JAX package draws it."""
    subs = [init_population(rng.fold_in(keys, k), population_size,
                            ctx._replace(nfeatures=nf), nlength)
            for k, nf in enumerate(template.num_features)]
    slot = lambda name: torch.stack([getattr(t, name) for t in subs], dim=-2)
    return TreeBatch(slot("arity"), slot("op"), slot("feat"), slot("const"),
                     torch.stack([t.length for t in subs], dim=-1))
