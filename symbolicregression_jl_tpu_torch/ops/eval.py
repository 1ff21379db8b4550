"""Eager postfix tree interpreter (port of ``ops/eval.py``).

The ``turbo=False`` evaluation path and the oracle for the interpreter
kernel: a loop over tree slots on a [T, L, n] value buffer, each step
reading its children's rows, computing every operator of the slot's
arity and selecting by operator index (as the JAX package does under
vmap). A tree is invalid iff any of its nodes has a non-finite output on
any row.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .encoding import LEAF_CONST, LEAF_PARAM, TreeBatch, tree_structure_arrays
from .operators import OperatorSet

__all__ = ["eval_tree_batch"]


def _select(fns, o, *args):
    out = fns[0](*args)
    for j in range(1, len(fns)):
        out = torch.where((o == j)[:, None], fns[j](*args), out)
    return out


def eval_tree_batch(batch: TreeBatch, X: torch.Tensor, operators: OperatorSet,
                    params: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a batch of trees over all rows of ``X`` [F, n].

    ``params`` [..., NP, n] (parametric expressions) holds each tree's
    parameter values per row, already gathered by class; a LEAF_PARAM
    leaf reads row ``clip(feat, 0, NP - 1)``. Without ``params`` a
    parameter leaf is invalid.

    The buffer takes the constants' dtype: bfloat16 constants and ``X``
    give graftstage's bf16 mirror of kernel 1b (``evolve.step.eval_cost_batch``
    with ``bf16``), every node's value rounded to bf16 and checked there.

    Returns ``(y[..., n], valid[...])`` with the batch's leading dims."""
    batch_shape = batch.batch_shape
    L = batch.max_nodes
    F, n = X.shape
    flat = batch.reshape(-1)
    T = flat.length.shape[0]
    child, _, _ = tree_structure_arrays(flat, need_depth=False)
    child = child.long()
    dtype = flat.const.dtype
    dev = X.device
    rows = torch.arange(T, device=dev)
    buf = torch.zeros((T, L, n), dtype=dtype, device=dev)
    valid = torch.ones(T, dtype=torch.bool, device=dev)
    p_flat = None if params is None else params.reshape(T, *params.shape[-2:])
    unary = [o.fn for o in operators.unary]
    binary = [o.fn for o in operators.binary]
    for k in range(L):
        a = flat.arity[:, k]
        o = flat.op[:, k]
        c0 = buf[rows, child[:, k, 0]]
        c1 = buf[rows, child[:, k, 1]]
        x_row = X[torch.clamp(flat.feat[:, k].long(), 0, F - 1)]
        leaf = torch.where((o == LEAF_CONST)[:, None], flat.const[:, k, None], x_row)
        if p_flat is not None:
            pi = torch.clamp(flat.feat[:, k].long(), 0, p_flat.shape[1] - 1)
            leaf = torch.where((o == LEAF_PARAM)[:, None], p_flat[rows, pi], leaf)
        else:
            # A parameter leaf evaluated without parameters is invalid.
            leaf = torch.where(((a == 0) & (o == LEAF_PARAM))[:, None], float("nan"), leaf)
        val = leaf
        if unary:
            oc = torch.clamp(o, 0, len(unary) - 1)
            val = torch.where((a == 1)[:, None], _select(unary, oc, c0), val)
        if binary:
            oc = torch.clamp(o, 0, len(binary) - 1)
            val = torch.where((a == 2)[:, None], _select(binary, oc, c0, c1), val)
        val = val.to(dtype)
        in_tree = k < flat.length
        valid = valid & (torch.isfinite(val).all(dim=-1) | ~in_tree)
        buf[:, k] = val
    root = torch.clamp(flat.length.long() - 1, 0, L - 1)
    y = buf[rows, root]
    return y.reshape(*batch_shape, n), valid.reshape(batch_shape)
