"""Trees for the tests of the port's kernels (tests/test_torch_cuda.py,
tests/test_torch_tile_host.py): random populations of given step counts
and a list of hand-written trees. Imports no JAX, so the CUDA tests can
use it where JAX is not installed."""

from __future__ import annotations

import torch

from symbolicregression_jl_tpu_torch.evolve import rng
from symbolicregression_jl_tpu_torch.evolve.population import init_population
from symbolicregression_jl_tpu_torch.ops.encoding import TreeBatch, encode_population
from symbolicregression_jl_tpu_torch.ops.tree import parse_expression

# Constant-only trees (one identity step reading a constant), one-step
# programs, a deep left spine (held results), a root reading a held result
# under a unary operator and constants under every operator.
WRITTEN = ("2.5", "x1", "cos(1.5)", "(0.5 * 2.0) + 1.0", "x1 * 2.84375", "x1 - 0.25",
           "(x1 * x1) - (cos(x1 + 0.5) * 3.0)",
           "exp(x2 * -0.5) / (x1 + 3.5)",
           "((((x1 * 1.5) + x2) * (x3 - 0.7)) / (cos(x2) + 2.0)) - abs(x1 * -1.25)",
           "(x1 * x1) + ((x2 * 0.3) * (x3 + (x1 * (0.2 - x2))))")


def cat_trees(parts) -> TreeBatch:
    return TreeBatch(*(torch.cat(fields) for fields in zip(*(p.fields() for p in parts))))


def random_trees(seed: int, islands: int, size: int, ctx, nlength, device) -> TreeBatch:
    """``islands`` x ``size`` random trees (``init_population``) of
    ``nlength`` operator draws, flat; for a tuple of lengths, that many
    trees of each, from seeds ``seed``, ``seed + 1``, ... in turn."""
    lengths = nlength if isinstance(nlength, tuple) else (nlength,)
    return cat_trees([init_population(rng.split(rng.key(seed + i, device=device), islands), size,
                                      ctx, nlength=nl).reshape(-1)
                      for i, nl in enumerate(lengths)])


def with_written(trees: TreeBatch, ops, nfeatures: int) -> TreeBatch:
    """``trees`` followed by those of WRITTEN over ``nfeatures`` features
    that ``ops`` can write."""
    names = [f"x{i + 1}" for i in range(nfeatures)]
    words = {o.name for o in ops.binary} | {o.name for o in ops.unary}
    exprs = [e for e in WRITTEN
             if all(f"x{i}" not in e for i in range(nfeatures + 1, 4))
             and all(tok in words for tok in ("+", "-", "*", "/", "cos", "exp", "abs") if tok in e)]
    fixed = encode_population([parse_expression(e, ops, names) for e in exprs], trees.max_nodes,
                              ops, device=trees.device)
    return cat_trees([trees, fixed])
