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

__all__ = ["eval_tree_batch", "eval_single_tree"]


def _select(fns, o, *args):
    out = fns[0](*args)
    for j in range(1, len(fns)):
        out = torch.where((o == j)[:, None], fns[j](*args), out)
    return out


def eval_tree_batch(batch: TreeBatch, X: torch.Tensor, operators: OperatorSet,
                    params: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a batch of trees over all rows of ``X`` [F, n], or of each
    tree's own rows ``X`` [T, F, n] (T the batch's size; template call
    sites with per-member arguments). Every step is a PyTorch op, so the
    result is differentiable in the constants and ``X`` to any order.

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
    F, n = X.shape[-2:]
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
        fi = torch.clamp(flat.feat[:, k].long(), 0, F - 1)
        x_row = X[rows, fi] if X.dim() == 3 else X[fi]
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


def eval_single_tree(arity: torch.Tensor, op: torch.Tensor, feat: torch.Tensor,
                     const: torch.Tensor, length, child: Optional[torch.Tensor],
                     X: torch.Tensor, operators: OperatorSet,
                     params: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate one postfix tree (slot fields [L], ``length`` a scalar) over
    every row of ``X`` [F, n]: (y [n], valid), as the JAX package's
    ``eval_single_tree``. ``child`` [L, 2] is that function's child table
    (``structure_from_arity``), or None: the interpreter derives the same
    table from ``arity`` and reads no other. ``params`` [NP, n] are the parameter
    values per row, already gathered by class. Differentiable in
    ``const``, ``X`` and ``params`` to any order."""
    batch = TreeBatch(arity[None], op[None], feat[None], const[None],
                      torch.as_tensor(length, dtype=torch.int32, device=arity.device)[None])
    y, valid = eval_tree_batch(batch, X, operators,
                               params=None if params is None else params[None])
    return y[0], valid[0]
