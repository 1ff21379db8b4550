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
from typing import Optional

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

    def member(self, idx) -> "PopulationState":
        """The members ``idx`` (an int or an index tensor) along the member
        axis, which is located from the cost's shape: template trees carry
        a subexpression axis ([..., P, K, L], lengths [..., P, K])."""
        extra = self.trees.arity.dim() - self.cost.dim() - 1   # 0, or 1 (template)
        idx = torch.as_tensor(idx, device=self.cost.device)
        take = lambda x, axis: torch.index_select(x, x.dim() + axis, idx.reshape(-1)).reshape(
            x.shape[:x.dim() + axis] + idx.shape + x.shape[x.dim() + axis + 1:])
        t = self.trees
        return PopulationState(
            trees=TreeBatch(*(take(f, -(2 + extra)) for f in (t.arity, t.op, t.feat, t.const)),
                            take(t.length, -(1 + extra))),
            cost=take(self.cost, -1), loss=take(self.loss, -1),
            complexity=take(self.complexity, -1), birth=take(self.birth, -1),
            ref=take(self.ref, -1), parent=take(self.parent, -1),
            params=take(self.params, -3))


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


def init_population(key: torch.Tensor, population_size: int, ctx: MutationContext,
                    dtype: Optional[torch.dtype] = None, nlength: int = 3) -> TreeBatch:
    """Random trees via `gen_random_tree(nlength=3)`, one population per
    key: key [..., 2] -> trees [..., P, L]. ``dtype`` sets the constants'
    type (default ``ctx.dtype``). Costs are filled by the caller's eval
    pass."""
    member_keys = rng.split(key, population_size)             # [..., P, 2]
    return gen_random_tree(member_keys, nlength, ctx, dtype)


def init_template_population(key: torch.Tensor, population_size: int, template,
                             ctx: MutationContext, dtype: Optional[torch.dtype] = None,
                             nlength: int = 3) -> TreeBatch:
    """Random template members [..., P, K, L], one population per key:
    subexpression k is generated with its own argument count from
    ``fold_in(key, k)``, as the JAX package draws it."""
    subs = [init_population(rng.fold_in(key, k), population_size,
                            ctx._replace(nfeatures=nf), dtype, nlength)
            for k, nf in enumerate(template.num_features)]
    slot = lambda name: torch.stack([getattr(t, name) for t in subs], dim=-2)
    return TreeBatch(slot("arity"), slot("op"), slot("feat"), slot("const"),
                     torch.stack([t.length for t in subs], dim=-1))
