"""Postfix tensor encoding of expression-tree populations (torch).

Port of ``symbolicregression_jl_tpu/ops/encoding.py``. Trees are stored in
depth-first post-order, so every subtree occupies a contiguous slot range
``[k - size_k + 1, k]`` and structural edits become index arithmetic.

Per-tree tensors (slot axis L = maxsize, padded):

- ``arity[L]``  int32: 0 for leaves, d for arity-d operator nodes.
- ``op[L]``     int32: leaves 0=constant, 1=variable, 2=parameter;
  operator nodes index the OperatorSet's arity-d table.
- ``feat[L]``   int32: feature index of variable leaves.
- ``const[L]``  float32: value of constant leaves.
- ``length``    int32: number of used slots; the root is ``length - 1``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .operators import OperatorSet
from .tree import Node

__all__ = [
    "LEAF_CONST",
    "LEAF_VAR",
    "LEAF_PARAM",
    "MAX_ARITY",
    "TreeBatch",
    "encode_tree",
    "decode_tree",
    "encode_population",
    "decode_population",
    "tree_structure_arrays",
    "lane_take",
]

LEAF_CONST = 0
LEAF_VAR = 1
LEAF_PARAM = 2

MAX_ARITY = 2


def lane_take(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(vals, idx, axis=-1)`` with the reference's
    out-of-range semantics: indices outside ``[0, S)`` read 0.

    ``vals`` [..., S], ``idx`` [..., K] (leading dims broadcastable).
    Float reads add 0.0, as the reference's masked-sum take does, so a
    negative zero comes back positive."""
    S = vals.shape[-1]
    idx = idx.long()
    shape = torch.broadcast_shapes(vals.shape[:-1], idx.shape[:-1])
    v = vals.expand(*shape, S)
    i = idx.expand(*shape, idx.shape[-1])
    ok = (i >= 0) & (i < S)
    out = torch.gather(v, -1, i.clamp(0, S - 1))
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    if vals.is_floating_point():
        out = out + 0.0
    return torch.where(ok, out, zero)


@dataclasses.dataclass
class TreeBatch:
    """A batch of postfix-encoded trees: tensors with shared leading batch
    dims; the last axis of the per-slot fields is the slot axis L."""

    arity: torch.Tensor   # int32 [..., L]
    op: torch.Tensor      # int32 [..., L]
    feat: torch.Tensor    # int32 [..., L]
    const: torch.Tensor   # float32 [..., L]
    length: torch.Tensor  # int32 [...]

    @property
    def max_nodes(self) -> int:
        return self.arity.shape[-1]

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.arity.shape[:-1])

    @property
    def device(self) -> torch.device:
        return self.arity.device

    def fields(self):
        return (self.arity, self.op, self.feat, self.const, self.length)

    def map(self, fn, with_length: bool = True) -> "TreeBatch":
        """Apply ``fn`` to every slot field (and to ``length`` with the
        slot axis absent)."""
        return TreeBatch(
            arity=fn(self.arity), op=fn(self.op), feat=fn(self.feat),
            const=fn(self.const),
            length=fn(self.length) if with_length else self.length,
        )

    def reshape(self, *batch_shape) -> "TreeBatch":
        L = self.max_nodes
        return TreeBatch(
            arity=self.arity.reshape(*batch_shape, L),
            op=self.op.reshape(*batch_shape, L),
            feat=self.feat.reshape(*batch_shape, L),
            const=self.const.reshape(*batch_shape, L),
            length=self.length.reshape(*batch_shape),
        )

    def __getitem__(self, idx) -> "TreeBatch":
        return TreeBatch(
            arity=self.arity[idx],
            op=self.op[idx],
            feat=self.feat[idx],
            const=self.const[idx],
            length=self.length[idx],
        )

    @staticmethod
    def empty(batch_shape: Tuple[int, ...], max_nodes: int,
              device: torch.device, dtype=torch.float32) -> "TreeBatch":
        """All-padding batch of single-constant (0.0) trees."""
        shape = (*batch_shape, max_nodes)
        z = lambda dt: torch.zeros(shape, dtype=dt, device=device)
        return TreeBatch(
            arity=z(torch.int32),
            op=z(torch.int32),
            feat=z(torch.int32),
            const=z(dtype),
            length=torch.ones(batch_shape, dtype=torch.int32, device=device),
        )


def select_tree(pred: torch.Tensor, a: TreeBatch, b: TreeBatch) -> TreeBatch:
    """Elementwise tree select; ``pred`` has the batch shape."""

    def sel(x, y):
        p = pred.reshape(pred.shape + (1,) * (x.dim() - pred.dim()))
        return torch.where(p, x, y)

    return TreeBatch(sel(a.arity, b.arity), sel(a.op, b.op), sel(a.feat, b.feat),
                     sel(a.const, b.const), sel(a.length, b.length))


# ---------------------------------------------------------------------------
# Host encode / decode
# ---------------------------------------------------------------------------


def encode_tree(tree: Node, max_nodes: int, operators: OperatorSet, const_dtype=np.float32):
    """Encode a host `Node` into per-slot numpy arrays (postfix order)."""
    arity = np.zeros(max_nodes, np.int32)
    op = np.zeros(max_nodes, np.int32)
    feat = np.zeros(max_nodes, np.int32)
    const = np.zeros(max_nodes, const_dtype)
    k = 0
    for n in tree.nodes():
        if k >= max_nodes:
            raise ValueError(
                f"Tree has more than max_nodes={max_nodes} nodes: "
                f"{tree.count_nodes()}"
            )
        arity[k] = n.degree
        if n.degree == 0:
            if n.is_parameter:
                op[k] = LEAF_PARAM
                feat[k] = n.parameter
            elif n.constant:
                op[k] = LEAF_CONST
                const[k] = n.val
            else:
                op[k] = LEAF_VAR
                feat[k] = n.feature
        else:
            idx = None
            for i, o in enumerate(operators[n.degree]):
                if o.name == n.op.name:
                    idx = i
                    break
            if idx is None:
                raise ValueError(
                    f"Operator {n.op.name!r}/{n.degree} not in operator set"
                )
            op[k] = idx
        k += 1
    return arity, op, feat, const, np.int32(k)


def decode_tree(arity, op, feat, const, length, operators: OperatorSet) -> Node:
    """Decode per-slot arrays back into a host `Node` (inverse of encode)."""
    arity = np.asarray(arity)
    op = np.asarray(op)
    feat = np.asarray(feat)
    const = np.asarray(const)
    length = int(length)
    stack: List[Node] = []
    for k in range(length):
        a = int(arity[k])
        if a == 0:
            code = int(op[k])
            if code == LEAF_CONST:
                stack.append(Node.const(float(const[k])))
            elif code == LEAF_VAR:
                stack.append(Node.var(int(feat[k])))
            else:
                stack.append(Node.param(int(feat[k])))
        else:
            children = stack[-a:]
            del stack[-a:]
            stack.append(Node(op=operators[a][int(op[k])], children=children))
    if len(stack) != 1:
        raise ValueError(f"Malformed postfix encoding (stack={len(stack)})")
    return stack[0]


def encode_population(trees: Sequence[Node], max_nodes: int,
                      operators: OperatorSet, device=None,
                      dtype: torch.dtype = torch.float32) -> TreeBatch:
    """Host trees -> a [len(trees), max_nodes] TreeBatch on ``device``
    (CUDA unless the caller asks for the CPU), constants in ``dtype``."""
    dev = resolve_device(device)
    n = len(trees)
    cdt = np.float64 if dtype == torch.float64 else np.float32
    arity = np.zeros((n, max_nodes), np.int32)
    op = np.zeros((n, max_nodes), np.int32)
    feat = np.zeros((n, max_nodes), np.int32)
    const = np.zeros((n, max_nodes), cdt)
    length = np.zeros((n,), np.int32)
    for i, t in enumerate(trees):
        arity[i], op[i], feat[i], const[i], length[i] = encode_tree(
            t, max_nodes, operators, cdt)
    return TreeBatch(*(torch.from_numpy(a).to(dev)
                       for a in (arity, op, feat, const, length)))


def decode_population(batch: TreeBatch, operators: OperatorSet) -> List[Node]:
    """Decode a TreeBatch (flattened over leading dims) into host Nodes."""
    flat = batch.reshape(-1)
    arity, op, feat, const, length = (f.cpu().numpy() for f in flat.fields())
    return [
        decode_tree(arity[i], op[i], feat[i], const[i], length[i], operators)
        for i in range(arity.shape[0])
    ]


# ---------------------------------------------------------------------------
# Structural derivation
# ---------------------------------------------------------------------------


def structure_from_arity(arity: torch.Tensor, need_depth: bool = True):
    """Closed-form (child, size, depth) for postfix trees, any leading
    batch shape (slot axis last).

    With D the inclusive prefix sum of ``1 - arity`` (the running postfix
    stack height): the span of node k starts at the last ``j <= k`` with
    ``D(j-1) == D(k) - 1``; a binary node's right child is ``k-1`` and its
    left child ``k - 1 - size(k-1)``; depth comes from the ancestor
    indicator ``anc[i,j] = (j > i) & (start(j) <= i)``. Padding slots
    yield size 1, depth 1 and children 0."""
    L = arity.shape[-1]
    dev = arity.device
    a = arity.long()
    step = 1 - a
    D = torch.cumsum(step, dim=-1)
    Dm1 = D - step
    j = torch.arange(L, device=dev)

    hit = (j <= j[:, None]) & (Dm1[..., None, :] == (D[..., :, None] - 1))
    start = torch.where(hit, j, torch.full_like(j, -1)).amax(dim=-1)
    start = torch.minimum(torch.clamp(start, min=0), j)
    size = j - start + 1

    size_prev = torch.roll(size, 1, dims=-1)
    size_prev[..., 0] = 0
    right = torch.clamp(j - 1, min=0)
    left = torch.clamp(j - 1 - size_prev, min=0)
    zero = torch.zeros_like(left)
    child0 = torch.where(a == 2, left, torch.where(a == 1, right.expand_as(left), zero))
    child1 = torch.where(a == 2, right.expand_as(left), zero)
    child = torch.stack([child0, child1], dim=-1).to(torch.int32)

    if not need_depth:
        return child, size.to(torch.int32), None

    anc = (j[:, None] < j) & (start[..., None, :] <= j[:, None])      # [..., i, j]
    A_cnt = anc.sum(dim=-1)                                           # [..., i]
    within = (start[..., :, None] <= j) & (j <= j[:, None])           # [..., k, i]
    span_max = torch.where(within, A_cnt[..., None, :],
                           torch.zeros((), dtype=A_cnt.dtype, device=dev)).amax(dim=-1)
    depth = 1 + span_max - A_cnt
    return child, size.to(torch.int32), depth.to(torch.int32)


def tree_structure_arrays(batch: TreeBatch, need_depth: bool = True):
    """Batched (child, size, depth) derivation over any leading dims."""
    return structure_from_arity(batch.arity, need_depth=need_depth)
