"""Piece-concatenation gathers: structural tree edits as index arithmetic.

Port of ``evolve/pieces.py``. In postfix order every subtree is a
contiguous slot range, so every structural mutation is "concatenate these
source spans in this order": one gather per field. All functions work on
a batch of N trees at once (fields [N, S], piece tables [N, NP]).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.encoding import TreeBatch, lane_take

__all__ = ["concat_pieces", "combine_sources", "splice_span", "tree_fields", "make_tree"]


def tree_fields(t: TreeBatch):
    return (t.arity, t.op, t.feat, t.const)


def make_tree(arity, op, feat, const, length) -> TreeBatch:
    return TreeBatch(arity=arity, op=op, feat=feat, const=const, length=length)


def combine_sources(*trees: TreeBatch):
    """Concatenate trees' fields along the slot axis; piece starts for
    tree ``i`` are offset by ``i * L``."""
    return tuple(torch.cat([getattr(t, f) for t in trees], dim=-1)
                 for f in ("arity", "op", "feat", "const"))


def concat_pieces(sources, starts: torch.Tensor, lens: torch.Tensor,
                  max_nodes: int) -> Tuple[TreeBatch, torch.Tensor]:
    """Build trees from ordered source pieces.

    ``sources`` = (arity, op, feat, const) [N, S]; ``starts``/``lens``
    [N, NP] (zero-length pieces are skipped). Returns ``(tree, ok)`` with
    ``ok`` False where the total length exceeds ``max_nodes`` (the
    caller rejects that attempt)."""
    s_arity, s_op, s_feat, s_const = sources
    starts = starts.long()
    lens = lens.long()
    ends = torch.cumsum(lens, dim=-1)
    begins = ends - lens
    total = ends[:, -1]
    ok = total <= max_nodes
    k = torch.arange(max_nodes, device=starts.device)
    in_piece = (k[None, :, None] >= begins[:, None, :]) & (k[None, :, None] < ends[:, None, :])
    src = torch.where(in_piece, starts[:, None, :] + (k[None, :, None] - begins[:, None, :]),
                      0).sum(dim=-1)                                     # [N, L]
    mask = k[None, :] < total[:, None]
    take = lambda field: torch.where(mask, lane_take(field, src), 0).to(field.dtype)
    tree = TreeBatch(
        arity=take(s_arity),
        op=take(s_op),
        feat=take(s_feat),
        const=take(s_const),
        length=torch.clamp(total, max=max_nodes).to(torch.int32),
    )
    return tree, ok


def splice_span(tree: TreeBatch, span_start, span_end, replacement_sources,
                repl_start, repl_len, max_nodes: int):
    """Replace ``tree[span_start..span_end]`` (inclusive) with a span of
    ``replacement_sources``, whose first L slots must be ``tree`` itself."""
    zero = torch.zeros_like(span_start)
    starts = torch.stack([zero, repl_start, span_end + 1], dim=-1)
    lens = torch.stack([span_start, repl_len, tree.length - (span_end + 1)], dim=-1)
    return concat_pieces(replacement_sources, starts, lens, max_nodes)
