"""The collectives of the island mesh, on ``torch.distributed``.

Every collective the multi-device search makes goes through this module:

- :func:`all_gather_islands` gathers island-major tensors, tiled along
  dim 0 in rank order (the JAX package's ``all_gather(..., tiled=True)``
  over the ``island`` axis). Several tensors travel as one byte buffer,
  one collective for all of them, bit for bit whatever their dtype.
- :func:`ordered_sum` adds per-rank partials. **A float sum is never an
  all_reduce**: the partials are gathered and added in rank order, so a
  seed gives the same bits on every rank and in every run
  (docs/ROBUSTNESS.md). :func:`all_sum` is the same for counters.
- :func:`first_of_ranks` agrees on host decisions (the stop reason).
- The data-row shards' reduction (``n_data_shards > 1``):
  :func:`row_shard` makes a :class:`RowShard` active for the calling
  thread. ``core/losses.aggregate_loss`` then reduces each tree's row
  partials over the shard's group (:func:`shard_row_sum`, which autograd
  passes through) and takes validity over every shard
  (:func:`shard_all`); the kernel wrappers reduce their row sums,
  validity and denominator in one collective (:func:`shard_reduce`); a
  custom whole-prediction loss reads every shard's predictions
  (:func:`gather_rows`, whose backward is the rank's slice) and the whole
  targets (:func:`whole_rows`); the constant optimizers add their
  gradient partials with :func:`sum_over_row_shards`. A shard's rows may
  be a minibatch or a sample of the dataset's (``RowShard.take``).

A ``group`` of None means no process group: a single shard, where every
function is the identity. Under ``gloo`` a CUDA tensor is copied to the
host and back on purpose: gloo's ``all_gather`` takes CPU tensors only
(this is the route for several ranks on one card, not a fallback).
Every collective runs under its group's timeout (``multihost``). The
module counts the collectives, their bytes and seconds
(:func:`collective_stats`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

__all__ = ["all_gather_islands", "all_gather_tree", "ordered_sum", "all_sum",
           "first_of_ranks", "collective_stats", "RowShard", "row_shard",
           "active_row_shard", "shard_row_sum", "shard_all", "sum_over_row_shards",
           "shard_reduce", "gather_rows", "whole_rows", "row_block"]

_STATS = {"collectives": 0, "bytes": 0, "seconds": 0.0}


def collective_stats(reset: bool = False) -> Dict[str, Any]:
    """The collectives made since the last reset: count, bytes received
    from other ranks, seconds spent in them."""
    out = dict(_STATS)
    if reset:
        _STATS.update(collectives=0, bytes=0, seconds=0.0)
    return out


def _dist():
    import torch.distributed as dist

    return dist


def group_size(group) -> int:
    return 1 if group is None else _dist().get_world_size(group)


def _to_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _gather_bytes(buf: torch.Tensor, group) -> torch.Tensor:
    """[S, nbytes]: every rank's ``buf`` in rank order."""
    dist = _dist()
    S = group_size(group)
    t0 = time.perf_counter()
    host = buf.is_cuda and str(dist.get_backend(group)) == "gloo"
    src = buf.cpu() if host else buf            # gloo: CPU tensors only
    out = torch.empty(S * src.numel(), dtype=torch.uint8, device=src.device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, src, group=group)
    out = out.reshape(S, src.numel())
    if host:
        out = out.to(buf.device)
    _STATS["collectives"] += 1
    _STATS["bytes"] += int(src.numel()) * (S - 1)
    _STATS["seconds"] += time.perf_counter() - t0
    return out


def _gather_stacked(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor of every rank, stacked [S, *shape] in rank order."""
    S = group_size(group)
    if group is None:
        return [t.unsqueeze(0) for t in tensors]
    parts, sizes = [], []
    for t in tensors:
        b = _to_bytes(t)
        sizes.append(int(b.numel()))
        parts.append(b)
        pad = -int(b.numel()) % 8      # every leaf starts 8-byte aligned
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8, device=b.device))
    buf = torch.cat(parts) if parts else torch.empty(0, dtype=torch.uint8)
    out = _gather_bytes(buf, group)
    res, off = [], 0
    for t, n in zip(tensors, sizes):
        block = out[:, off:off + n].contiguous().reshape(-1)
        res.append(block.view(t.dtype).reshape((S,) + tuple(t.shape)))
        off += n + (-n % 8)
    return res


def all_gather_islands(*tensors: torch.Tensor, group=None):
    """Each tensor of every rank concatenated along dim 0 in rank order
    (one collective for all of them). Returns one tensor, or a tuple."""
    S = group_size(group)
    out = [g.reshape((S * t.shape[0],) + tuple(t.shape[1:])) if t.dim() else g.reshape(S)
           for t, g in zip(tensors, _gather_stacked(tensors, group))]
    return out[0] if len(out) == 1 else tuple(out)


def _leaves(obj, out: List[torch.Tensor]) -> None:
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            if f.init:
                _leaves(getattr(obj, f.name), out)


def _rebuild(obj, it):
    if isinstance(obj, torch.Tensor):
        return next(it)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _rebuild(getattr(obj, f.name), it)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def all_gather_tree(*objs, group=None):
    """:func:`all_gather_islands` over every tensor of the given
    dataclass trees (populations, hall-of-fame slices, counters), their
    structure kept. Returns one tree, or a tuple."""
    leaves: List[torch.Tensor] = []
    for o in objs:
        _leaves(o, leaves)
    if not leaves:
        return objs[0] if len(objs) == 1 else objs
    gathered = all_gather_islands(*leaves, group=group)
    if len(leaves) == 1:
        gathered = (gathered,)
    it = iter(gathered)
    out = tuple(_rebuild(o, it) for o in objs)
    return out[0] if len(out) == 1 else out


def _add_in_order(stacked: torch.Tensor) -> torch.Tensor:
    acc = stacked[0]
    for k in range(1, stacked.shape[0]):
        acc = acc + stacked[k]
    return acc


def ordered_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``t``, added in rank order (never an
    all_reduce, whose order the backend picks)."""
    if group is None:
        return t
    return _add_in_order(_gather_stacked([t], group)[0])


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Counters summed over the group (:func:`ordered_sum`)."""
    return ordered_sum(t, group)


def first_of_ranks(obj, group=None):
    """The first non-None of every rank's ``obj``, in rank order, on every
    rank (a host decision any rank may take, such as a stop)."""
    if group is None:
        return obj
    dist = _dist()
    box = [None] * group_size(group)
    dist.all_gather_object(box, obj, group=group)
    return next((o for o in box if o is not None), None)


# ---------------------------------------------------------------------------
# Data-row shards
# ---------------------------------------------------------------------------


def row_block(n: int, count: int, index: int):
    """[lo, hi) of block ``index`` of ``count`` contiguous blocks of
    ``n`` rows (ceil-sized; the last may be shorter)."""
    size = -(-int(n) // int(count))
    lo = min(int(index) * size, int(n))
    return lo, min(lo + size, int(n))


@dataclasses.dataclass(frozen=True, eq=False)
class RowShard:
    """This rank's part of a dataset's rows: ``group`` holds the ranks
    of the other parts (data index order), ``n_rows`` is the whole
    dataset's row count. ``positions`` are the rank's rows among the
    ``n_rows``, ascending; None is the contiguous block ``row_block(n_rows,
    count, index)`` (``MeshPlan.place_data``). ``cache`` keeps what a
    shard gathers once (its row layout, the whole targets)."""

    group: Any
    n_rows: int
    index: int
    count: int
    positions: Optional[torch.Tensor] = None
    cache: Dict[str, Any] = dataclasses.field(default_factory=dict, repr=False)

    def local_positions(self, device) -> torch.Tensor:
        """The rank's rows among the ``n_rows`` [n_local], ascending."""
        if self.positions is not None:
            return self.positions.to(device)
        lo, hi = row_block(self.n_rows, self.count, self.index)
        return torch.arange(lo, hi, device=device)

    def take(self, idx: torch.Tensor):
        """Rows ``idx`` [B] of the ``n_rows`` (any order, repeats allowed):
        (the local indices of those this rank holds, in ``idx`` order; the
        row shard of the B taken rows)."""
        pos = self.local_positions(idx.device)
        if pos.numel():
            j = torch.searchsorted(pos, idx)
            hit = (j < pos.numel()) & (pos[torch.clamp(j, max=pos.numel() - 1)] == idx)
        else:
            j, hit = torch.zeros_like(idx), torch.zeros_like(idx, dtype=torch.bool)
        taken = torch.arange(idx.numel(), device=idx.device)[hit]
        return j[hit], RowShard(self.group, int(idx.numel()), self.index, self.count,
                                positions=taken)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("sr_row_shard", default=None)


@contextlib.contextmanager
def row_shard(shard: Optional[RowShard]):
    """Make ``shard`` the calling thread's row reduction (None: none)."""
    token = _ACTIVE.set(shard)
    try:
        yield shard
    finally:
        _ACTIVE.reset(token)


def active_row_shard() -> Optional[RowShard]:
    return _ACTIVE.get()


class _ShardSum(torch.autograd.Function):
    """Forward: the row partials of every data shard, added in shard
    order. Backward: the cotangent passes to this shard's partial (each
    shard's constants' gradient is then summed by sum_over_row_shards)."""

    @staticmethod
    def forward(ctx, partial, shard):
        return ordered_sum(partial.detach(), shard.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def shard_row_sum(partial: torch.Tensor, shard: RowShard) -> torch.Tensor:
    return _ShardSum.apply(partial, shard)


def shard_all(valid: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """Validity over every shard's rows."""
    stacked = _gather_stacked([valid.to(torch.bool)], shard.group)[0]
    return torch.all(stacked, dim=0)


def sum_over_row_shards(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the active row shards in shard order (the
    constants' gradient partials); the identity without one."""
    shard = active_row_shard()
    return t if shard is None else ordered_sum(t, shard.group)


def shard_reduce(shard: RowShard, sums: Sequence[torch.Tensor], valid: torch.Tensor,
                 weight_sum: Optional[torch.Tensor] = None):
    """The kernel wrappers' reduction over the data axis, one collective:
    each of ``sums`` added over every shard in shard order, validity over
    every shard, and the weight sum (when given) over every shard.
    Returns (sums, valid, weight_sum)."""
    tensors = list(sums) + [valid.to(torch.bool)] + ([weight_sum] if weight_sum is not None
                                                     else [])
    stacked = _gather_stacked(tensors, shard.group)
    out = [_add_in_order(s) for s in stacked[:len(sums)]]
    ok = torch.all(stacked[len(sums)], dim=0)
    wsum = _add_in_order(stacked[-1]) if weight_sum is not None else None
    return out, ok, wsum


def _row_layout(shard: RowShard, device):
    """(each rank's row count, every rank's positions in rank order [n_rows]),
    gathered once per shard (a contiguous block needs no collective)."""
    lay = shard.cache.get("layout")
    if lay is None:
        if shard.positions is None:
            blocks = [row_block(shard.n_rows, shard.count, d) for d in range(shard.count)]
            counts = [hi - lo for lo, hi in blocks]
            order = torch.arange(shard.n_rows, device=device)
        else:
            mine = torch.tensor([shard.positions.numel()], dtype=torch.int64, device=device)
            counts = [int(c) for c in _gather_stacked([mine], shard.group)[0].reshape(-1)]
            pos = torch.full((max(counts),), -1, dtype=torch.int64, device=device)
            pos[:counts[shard.index]] = shard.positions.to(device)
            allpos = _gather_stacked([pos], shard.group)[0]
            order = torch.cat([allpos[d, :c] for d, c in enumerate(counts)])
        lay = shard.cache["layout"] = (counts, order)
    return lay


class _GatherRows(torch.autograd.Function):
    """Forward: every shard's rows of ``x`` [..., n_local] placed at their
    positions [..., n_rows]. Backward: the cotangent at this rank's rows."""

    @staticmethod
    def forward(ctx, x, shard):
        counts, order = _row_layout(shard, x.device)
        m = max(counts)
        pad = torch.zeros(x.shape[:-1] + (m - x.shape[-1],), dtype=x.dtype, device=x.device)
        stacked = _gather_stacked([torch.cat([x.detach(), pad], dim=-1)], shard.group)[0]
        cat = torch.cat([stacked[d, ..., :c] for d, c in enumerate(counts)], dim=-1)
        out = torch.empty_like(cat)
        out[..., order.to(x.device)] = cat
        ctx.shard = shard
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad.index_select(-1, ctx.shard.local_positions(grad.device)), None


def gather_rows(x: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """``x`` [..., n_local] of every shard as [..., n_rows] in the dataset's
    row order (differentiable: the gradient of this rank's rows)."""
    return _GatherRows.apply(x, shard)


def whole_rows(t: torch.Tensor, shard: RowShard, name: str) -> torch.Tensor:
    """:func:`gather_rows` of a dataset vector (the targets, the weights),
    gathered once per shard and kept under ``name``."""
    hit = shard.cache.get(name)
    if hit is None or hit[0] is not t:
        hit = shard.cache[name] = (t, gather_rows(t.detach(), shard))
    return hit[1]
