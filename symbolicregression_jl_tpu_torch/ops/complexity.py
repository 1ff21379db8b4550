"""Complexity and constraint checks (port of ``ops/complexity.py``).

Batched equivalents of compute_complexity over a ComplexityMapping and of
check_constraints (maxsize, maxdepth, per-operator argument sizes,
nested-operator limits). Subtree aggregates use the postfix property that
a subtree is the contiguous slot range ``[k - size_k + 1, k]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.options import Options
from .encoding import LEAF_CONST, MAX_ARITY, TreeBatch, lane_take, tree_structure_arrays

__all__ = ["ComplexityTables", "build_complexity_tables", "compute_complexity_batch",
           "check_constraints_batch"]


@dataclasses.dataclass
class ComplexityTables:
    unary_w: torch.Tensor     # [max(U,1)]
    binary_w: torch.Tensor    # [max(B,1)]
    variable_w: torch.Tensor  # [nfeatures]
    constant_w: torch.Tensor  # 0-d


def build_complexity_tables(options: Options, nfeatures: int,
                            device: torch.device) -> ComplexityTables:
    cm = options.complexity_mapping
    U = max(len(options.operators.unary), 1)
    B = max(len(options.operators.binary), 1)
    un = np.ones(U, np.float32)
    bi = np.ones(B, np.float32)
    if cm.use:
        for i, w in enumerate(cm.op_complexities.get(1, [])):
            un[i] = w
        for i, w in enumerate(cm.op_complexities.get(2, [])):
            bi[i] = w
    if isinstance(cm.variable_complexity, list):
        var = np.asarray(cm.variable_complexity, np.float32)
        if var.shape[0] != nfeatures:
            raise ValueError(
                f"complexity_of_variables has {var.shape[0]} entries; expected {nfeatures}"
            )
    else:
        var = np.full(nfeatures, cm.variable_complexity, np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    return ComplexityTables(
        unary_w=t(un), binary_w=t(bi), variable_w=t(var),
        constant_w=t(np.float32(cm.constant_complexity)),
    )


def _node_weights(batch: TreeBatch, tables: ComplexityTables) -> torch.Tensor:
    """Per-slot complexity weight (garbage at padded slots; callers mask)."""
    a, o, f = batch.arity, batch.op, batch.feat
    nF = tables.variable_w.shape[0]
    var_w = tables.variable_w[torch.clamp(f.long(), 0, nF - 1)]
    leaf_w = torch.where(o == LEAF_CONST, tables.constant_w, var_w)
    un_w = tables.unary_w[torch.clamp(o.long(), 0, tables.unary_w.shape[0] - 1)]
    bi_w = tables.binary_w[torch.clamp(o.long(), 0, tables.binary_w.shape[0] - 1)]
    return torch.where(a == 0, leaf_w, torch.where(a == 1, un_w, bi_w))


def compute_complexity_batch(batch: TreeBatch, tables: ComplexityTables) -> torch.Tensor:
    """Rounded-int complexity per tree."""
    w = _node_weights(batch, tables)
    L = batch.max_nodes
    mask = torch.arange(L, device=w.device) < batch.length[..., None]
    raw = torch.where(mask, w, 0.0).sum(dim=-1)
    return torch.round(raw).to(torch.int32)


def _postfix_max_plus(vals: torch.Tensor, arity: torch.Tensor) -> torch.Tensor:
    """r[k] = vals[k] + max(r[children of k], default 0), one stack walk
    over the slots for a [N, L] batch: the maximum sum of ``vals`` along
    any path inside each node's subtree."""
    N, L = arity.shape
    dev = arity.device
    rows = torch.arange(N, device=dev)
    stack = torch.zeros((N, L), dtype=vals.dtype, device=dev)
    sp = torch.zeros(N, dtype=torch.long, device=dev)
    out = []
    for k in range(L):
        a = arity[:, k].long()
        best = torch.zeros(N, dtype=vals.dtype, device=dev)
        for j in range(MAX_ARITY):
            pos = torch.clamp(sp - a + j, min=0)
            got = stack[rows, torch.clamp(pos, max=L - 1)]
            best = torch.maximum(best, torch.where(j < a, got, torch.zeros_like(got)))
        r_k = vals[:, k] + best
        sp = sp - a + 1
        stack[rows, torch.clamp(sp - 1, 0, L - 1)] = r_k
        out.append(r_k)
    return torch.stack(out, dim=-1)


def _subtree_sums(w: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Subtree sums via the contiguous-span prefix-sum trick ([..., L])."""
    csum = torch.cat([torch.zeros_like(w[..., :1]), torch.cumsum(w, dim=-1)], dim=-1)
    k = torch.arange(w.shape[-1], device=w.device)
    start = torch.clamp(k - size.long() + 1, min=0)
    return lane_take(csum, k + 1 + torch.zeros_like(start)) - lane_take(csum, start)


def check_constraints_batch(batch: TreeBatch, options: Options, tables: ComplexityTables,
                            cur_maxsize, child=None, size=None, depth=None) -> torch.Tensor:
    """Batched check_constraints: True where a tree satisfies all of
    maxsize, maxdepth, the per-operator argument-size constraints and the
    nested-operator constraints."""
    L = batch.max_nodes
    dev = batch.arity.device
    slot = torch.arange(L, device=dev)
    mask = slot < batch.length[..., None]

    complexity = compute_complexity_batch(batch, tables)
    ok = complexity <= cur_maxsize

    has_op_cons = any(
        any(c != -1 for c in cons)
        for d, conslist in options.op_constraints.items()
        for cons in conslist
    )

    if options.maxdepth < L:
        if depth is None:
            child, size, depth = tree_structure_arrays(batch, need_depth=True)
        root_depth = torch.where(mask, depth, 0).amax(dim=-1)
        ok = ok & (root_depth <= options.maxdepth)

    if has_op_cons or options.nested_constraints:
        if size is None:
            child, size, _ = tree_structure_arrays(batch, need_depth=False)
        sub_cx = _subtree_sums(_node_weights(batch, tables), size)

    if has_op_cons:
        for d, conslist in options.op_constraints.items():
            for op_idx, cons in enumerate(conslist):
                if all(c == -1 for c in cons):
                    continue
                is_target = mask & (batch.arity == d) & (batch.op == op_idx)
                for j, limit in enumerate(cons):
                    if limit == -1:
                        continue
                    child_cx = lane_take(sub_cx, child[..., j])
                    violation = is_target & (torch.round(child_cx) > limit)
                    ok = ok & ~violation.any(dim=-1)

    for (d, op_idx, inners) in options.nested_constraints:
        is_outer = mask & (batch.arity == d) & (batch.op == op_idx)
        for (nd, ni, max_nest) in inners:
            is_inner = (mask & (batch.arity == nd) & (batch.op == ni)).to(torch.int32)
            flat_inner = is_inner.reshape(-1, L)
            flat_arity = batch.arity.reshape(-1, L)
            r = _postfix_max_plus(flat_inner, flat_arity).reshape(is_inner.shape)
            nestedness = r - is_inner
            violation = is_outer & (nestedness > max_nest)
            ok = ok & ~violation.any(dim=-1)

    return ok
