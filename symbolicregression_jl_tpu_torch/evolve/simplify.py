"""Constant folding on the postfix encoding (port of ``evolve/simplify.py``).

Collapses maximal all-constant subtrees into single constant leaves (the
tensor form of simplify_tree!), batched over any leading dims:

- a subtree is all-constant iff its span holds no variable leaf: one
  prefix sum over the slots;
- node values come from one pass over the slots on a [..., L] buffer,
  the operator selected by a where-chain over the operator table;
- a node is inside a folded subtree iff a later constant node's span
  covers it (an exclusive suffix minimum of the constant spans' starts);
  kept slots are compacted in order.
"""

from __future__ import annotations

import torch

from ..ops.encoding import LEAF_CONST, TreeBatch, lane_take, structure_from_arity

__all__ = ["fold_constants_batch"]


def _select_op_lanes(fns, o, *args):
    out = fns[0](*args)
    for j in range(1, len(fns)):
        out = torch.where(o == j, fns[j](*args), out)
    return out


def fold_constants_batch(trees: TreeBatch, operators) -> TreeBatch:
    """Fold constants for a [..., L] batch of trees. Variable leaves
    evaluate as 0 into lanes that are never read, so no data is needed."""
    arity, op, feat, const, length = trees.fields()
    L = arity.shape[-1]
    dev = arity.device
    slot = torch.arange(L, dtype=torch.int32, device=dev)
    in_tree = slot < length[..., None]

    child, size, _ = structure_from_arity(arity, need_depth=False)
    start = (slot - size + 1).to(torch.int32)

    bad = (in_tree & (arity == 0) & (op != LEAF_CONST)).to(torch.int32)
    badc = torch.cumsum(bad, dim=-1).to(torch.int32)
    before = torch.where(start > 0, lane_take(badc, torch.clamp(start - 1, min=0)), 0)
    is_const = ((badc - before) == 0) & in_tree

    unary_fns = tuple(o_.fn for o_ in operators.unary)
    binary_fns = tuple(o_.fn for o_ in operators.binary)
    leaf_val = torch.where((arity == 0) & (op == LEAF_CONST), const, 0.0)
    buf = torch.zeros(arity.shape, dtype=const.dtype, device=dev)
    for k in range(L):
        a = arity[..., k]
        o = op[..., k]
        ch = lane_take(buf, child[..., k, :])
        val = leaf_val[..., k]
        if unary_fns:
            val = torch.where(a == 1, _select_op_lanes(unary_fns, o, ch[..., 0]), val)
        if binary_fns:
            val = torch.where(a == 2, _select_op_lanes(binary_fns, o, ch[..., 0], ch[..., 1]), val)
        buf = torch.where(slot == k, val[..., None].to(const.dtype), buf)
    values = buf

    BIG = L + 1
    vals = torch.where(is_const & in_tree, start, BIG)
    pad = torch.full(vals.shape[:-1] + (1,), BIG, dtype=vals.dtype, device=dev)
    m_excl = torch.cat([vals[..., 1:], pad], dim=-1)
    sh = 1
    while sh < L:
        shifted = torch.cat(
            [m_excl[..., sh:],
             torch.full(m_excl.shape[:-1] + (sh,), BIG, dtype=vals.dtype, device=dev)], dim=-1)
        m_excl = torch.minimum(m_excl, shifted)
        sh *= 2
    parent_is_const = m_excl <= slot
    is_fold_root = is_const & ~parent_is_const & in_tree
    keep = in_tree & (~is_const | is_fold_root)

    new_len = keep.to(torch.int32).sum(dim=-1).to(torch.int32)
    order_key = torch.where(keep, slot, L + slot)
    perm = torch.argsort(order_key, dim=-1, stable=True)
    g = lambda x: lane_take(x, perm)
    folded_to_leaf = is_fold_root & (arity > 0)
    arity2 = torch.where(folded_to_leaf, 0, arity)
    op2 = torch.where(folded_to_leaf, LEAF_CONST, op)
    const2 = torch.where(is_fold_root, values, const)
    out_mask = slot < new_len[..., None]
    return TreeBatch(
        arity=torch.where(out_mask, g(arity2), 0).to(torch.int32),
        op=torch.where(out_mask, g(op2), 0).to(torch.int32),
        feat=torch.where(out_mask, g(feat), 0).to(torch.int32),
        const=torch.where(out_mask, g(const2), 0.0),
        length=new_len,
    )
