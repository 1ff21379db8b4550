"""ValidVector algebra and ComposableExpression: the building blocks of
template expressions (port of ``models/composable.py``).

- ``ValidVector``: a tensor of row values paired with a validity flag.
  Every operation propagates validity: all operands valid AND the result
  finite on every row. ``valid`` is a bool tensor, a scalar for shared
  rows or ``[M]`` for member-batched data ``[M, n]``; finiteness is
  reduced over the last axis only.
- Arithmetic dunders and module-level named functions (``cos``, ``exp``,
  ``safe_log``...) drawn from the search's own operator registry
  (``ops/operators.py``), so a template combiner sees the same NaN
  domains as evolved trees.
- ``ComposableExpression``: a host expression that can be called on data
  or on other ComposableExpressions (tree splicing). Its symbolic
  ``derivative`` comes with a later slice.
"""

from __future__ import annotations

import builtins as _builtins
import dataclasses
from typing import Any, Sequence, Union

import numpy as np
import torch

from ..ops.operators import OPERATOR_REGISTRY, OperatorSet, resolve_operator
from ..ops.tree import Node

__all__ = ["ValidVector", "ComposableExpression", "apply_operator", "ParamVec"]


@dataclasses.dataclass
class ValidVector:
    """Row values + validity flag. Invalid values poison everything
    downstream: the template evaluation gives such a member loss inf."""

    x: torch.Tensor
    valid: torch.Tensor  # bool, scalar or [M]
    # Whether the last axis of ``x`` holds the dataset's rows (what a
    # data-row shard splits); an index that keeps fewer entries (a scalar
    # row) gives a value that is the same on every rank.
    rows: bool = True

    def __add__(self, o): return apply_operator("+", self, o)
    def __radd__(self, o): return apply_operator("+", o, self)
    def __sub__(self, o): return apply_operator("-", self, o)
    def __rsub__(self, o): return apply_operator("-", o, self)
    def __mul__(self, o): return apply_operator("*", self, o)
    def __rmul__(self, o): return apply_operator("*", o, self)
    def __truediv__(self, o): return apply_operator("/", self, o)
    def __rtruediv__(self, o): return apply_operator("/", o, self)
    def __pow__(self, o): return apply_operator("^", self, o)
    def __rpow__(self, o): return apply_operator("^", o, self)
    def __neg__(self): return apply_operator("neg", self)
    def __abs__(self): return apply_operator("abs", self)
    def __mod__(self, o): return apply_operator("mod", self, o)

    def __getitem__(self, idx):
        """``x[idx]`` with numpy's rules (a negative step included); validity
        unchanged. What it indexes depends on the shape, as in the JAX
        package: a dataset column [n] by rows (``x1[0]`` is row 0), a
        subexpression's member-batched output [M, n] by members
        (``f(x1)[0]`` is member 0's rows) unless a tuple index reaches the
        last axis.

        Every other operation of the algebra is row-wise; an index that
        reaches the rows under a data-row shard (each rank holding a block
        of them) reads every rank's rows (``gather_rows``), indexes the
        whole array, as the JAX package's GSPMD does, and keeps this
        rank's block where the result still has a row per dataset row,
        else the whole result (the same on every rank). Its gradient adds
        every rank's cotangent in rank order."""
        from ..parallel.collectives import active_row_shard, gather_rows

        x = self.x
        reach = self.rows and _reaches_last_axis(x.dim(), idx)
        shard = active_row_shard()
        if reach and shard is not None:
            full = gather_rows(x, shard, shared=False)
            out = _np_index(full, idx)
            rows = out.dim() >= 1 and out.shape[-1] == shard.n_rows
            if rows:
                out = out.index_select(-1, shard.local_positions(out.device))
            return ValidVector(out, self.valid, rows)
        out = _np_index(x, idx)
        rows = self.rows and (out.dim() >= 1 and out.shape[-1] == x.shape[-1] if reach
                              else out.dim() >= 1)
        return ValidVector(out, self.valid, rows)


def _consumed(i) -> int:
    """The axes of ``x`` one item of an index consumes."""
    if i is None or i is Ellipsis:
        return 0
    if isinstance(i, (torch.Tensor, np.ndarray)) and i.dtype in (torch.bool, np.bool_):
        return max(i.ndim, 1)
    return 1


def _reaches_last_axis(ndim: int, idx) -> bool:
    """Whether ``x[idx]`` indexes the last axis of an ``ndim``-axis ``x``."""
    if ndim == 0:
        return False
    items = idx if isinstance(idx, tuple) else (idx,)
    if any(i is Ellipsis for i in items):
        after = items[[i is Ellipsis for i in items].index(True) + 1:]
        return any(_consumed(i) for i in after)
    return sum(_consumed(i) for i in items) >= ndim


def _np_index(x: torch.Tensor, idx):
    """``x[idx]`` as jax.numpy takes it where torch differs: a slice of
    negative step (``[::-1]``; torch's slices step forward only), and an
    integer array index, whose entries wrap once and are then clamped to
    the axis (jax.numpy's gather clamps an index out of range)."""
    items = idx if isinstance(idx, tuple) else (idx,)

    def int_array(i):
        if isinstance(i, (list, np.ndarray, torch.Tensor)):
            t = torch.as_tensor(i)
            return t if not t.dtype.is_floating_point and t.dtype != torch.bool else None
        return None

    if not any(isinstance(i, slice) and i.step is not None and i.step < 0
               or int_array(i) is not None for i in items):
        return x[idx]
    items = [torch.as_tensor(i) if isinstance(i, (list, np.ndarray)) else i for i in items]
    named = sum(_consumed(i) for i in items)
    axis, kept = 0, []
    for i in items:
        if i is Ellipsis:
            axis += x.dim() - named
            kept.append(i)
            continue
        if isinstance(i, slice) and i.step is not None and i.step < 0:
            sel = torch.tensor(list(range(x.shape[axis])[i]), dtype=torch.long, device=x.device)
            x = x.index_select(axis, sel)
            i = slice(None)
        elif int_array(i) is not None:
            n = x.shape[axis]
            i = i.to(device=x.device, dtype=torch.long)
            i = torch.clamp(torch.where(i < 0, i + n, i), 0, max(n - 1, 0))
        kept.append(i)
        axis += _consumed(i)
    return x[tuple(kept)]


def _is_vv(v) -> bool:
    return isinstance(v, ValidVector)


def _all_finite(x: torch.Tensor) -> torch.Tensor:
    """All-finite over the row (last) axis: a scalar flag for rows [n], a
    per-member flag [M] for member-batched data [M, n]."""
    if x.dim() == 0:
        return torch.isfinite(x)
    return torch.isfinite(x).all(dim=-1)


def apply_operator(op: Union[str, Any], *args) -> ValidVector:
    """Apply a (safe) operator elementwise with validity propagation.

    ``op`` is a registry name, an ``Op`` or a torch-elementwise callable.
    Scalar operands become float32 tensors on the ValidVector operands'
    device and broadcast against them."""
    if isinstance(op, str):
        fn = resolve_operator(op).fn
    elif hasattr(op, "fn"):
        fn = op.fn
    else:
        fn = op
    like = next((a.x for a in args if _is_vv(a)), None)
    dev = like.device if like is not None else None
    dtype = like.dtype if like is not None else torch.float32
    vals = [a.x if _is_vv(a) else
            a if isinstance(a, torch.Tensor) else torch.as_tensor(a, dtype=dtype, device=dev)
            for a in args]
    out = fn(*vals)
    valid = _all_finite(out)
    for a in args:
        if _is_vv(a):
            valid = valid & a.valid
    return ValidVector(out, valid, any(a.rows for a in args if _is_vv(a)))


def _make_named(name):
    def f(*args):
        return apply_operator(name, *args)

    f.__name__ = name
    f.__qualname__ = name
    f.__doc__ = f"ValidVector-lifted `{name}` (validity-propagating)."
    return f


_NAMED_FNS = {name: _make_named(name) for name in OPERATOR_REGISTRY if name.isidentifier()}
# Names that shadow builtins (max, min, abs, round, ...) resolve through
# the module's __getattr__, so this module's own code keeps the builtins.
globals().update({k: v for k, v in _NAMED_FNS.items() if not hasattr(_builtins, k)})
__all__ += sorted(_NAMED_FNS)


def __getattr__(name):
    try:
        return _NAMED_FNS[name]
    except KeyError:
        raise AttributeError(name) from None


@dataclasses.dataclass
class ParamVec:
    """A read-only parameter vector visible to template combiners: an int
    index gives a scalar, a ValidVector index gathers per row."""

    data: torch.Tensor  # [n_params]

    def __getitem__(self, idx):
        if _is_vv(idx):
            i = torch.clamp(idx.x.to(torch.int64), 0, self.data.shape[0] - 1)
            return ValidVector(self.data[i], idx.valid)
        return self.data[idx]

    def __len__(self):
        return self.data.shape[0]

    def __iter__(self):
        return (self.data[i] for i in range(self.data.shape[0]))


class ComposableExpression:
    """Host-side callable/composable expression over argument slots
    ``#1..#k``. Called with other ComposableExpressions it splices trees
    (argument ``i``'s leaves become a copy of ``args[i]``'s tree); called
    with tensors, arrays, ValidVectors or scalars it evaluates them with
    the eager interpreter on ``device`` (the arguments' device when they
    are tensors; CUDA unless the caller asks for the CPU otherwise).
    Invalid results come back as NaN."""

    def __init__(self, tree: Node, operators: OperatorSet, nfeatures: int, device=None):
        self.tree = tree
        self.operators = operators
        self.nfeatures = nfeatures
        self.device = device

    def __repr__(self) -> str:  # pragma: no cover
        return f"ComposableExpression({self.string()})"

    def string(self, variable_names=None) -> str:
        from ..ops.tree import string_tree

        names = variable_names or [f"#{i + 1}" for i in range(self.nfeatures)]
        return string_tree(self.tree, variable_names=names)

    def __call__(self, *args):
        if args and all(isinstance(a, ComposableExpression) for a in args):
            return self._compose(args)
        return self._evaluate(args)

    def derivative(self, argnum: int = 1) -> "ComposableExpression":
        """Symbolic row-wise derivative w.r.t. argument slot ``argnum``
        (1-based), the host-side face of the template ``D`` operator: a new
        ComposableExpression of the same arity whose tree is the simplified
        symbolic derivative (ops/diff.py ``D``). Derivative rules can bring
        operators outside the original set (``neg``/``sin`` from d cos); the
        result's operator set is extended with the derivative rules' Op
        objects (a user operator is not in the registry)."""
        from ..ops.diff import D as symbolic_D

        if not 1 <= argnum <= max(self.nfeatures, 1):
            raise ValueError(f"derivative argnum {argnum} out of range 1..{self.nfeatures}")
        dtree = symbolic_D(self.tree, argnum - 1)
        have = {(op.name, d) for d, ops_d in self.operators.ops.items() for op in ops_d}
        need = {(n.op, n.degree) for n in dtree.nodes() if n.degree > 0}
        operators = self.operators
        missing = [(op, d) for op, d in need if (op.name, d) not in have]
        if missing:
            by_arity = {d: list(ops_d) for d, ops_d in self.operators.ops.items()}
            for op, d in sorted(missing, key=lambda t: (t[1], t[0].name)):
                by_arity.setdefault(d, []).append(op)
            operators = OperatorSet(ops_by_arity={d: tuple(o) for d, o in by_arity.items()})
        return ComposableExpression(dtree, operators, self.nfeatures, self.device)

    def _compose(self, args: Sequence["ComposableExpression"]):
        if len(args) < self.nfeatures:
            raise ValueError(f"Expression uses {self.nfeatures} arguments; got {len(args)}")

        def substitute(n: Node) -> Node:
            if n.degree == 0:
                if (not n.constant) and (not n.is_parameter):
                    return args[n.feature].tree.copy()
                return n.copy()
            return Node(op=n.op, children=[substitute(c) for c in n.children])

        nfeat = max((a.nfeatures for a in args), default=0)
        return ComposableExpression(substitute(self.tree), self.operators, nfeat, self.device)

    def _evaluate(self, args):
        from ..device import resolve_device
        from ..ops.encoding import encode_population
        from ..ops.eval import eval_tree_batch

        raw = [a.x if _is_vv(a) else a for a in args]
        dev = next((r.device for r in raw if isinstance(r, torch.Tensor)), None)
        dev = resolve_device(dev if dev is not None else self.device)
        scalar_input = bool(args) and all(np.ndim(r) == 0 for r in raw)
        vecs = [torch.atleast_1d(torch.as_tensor(r, dtype=torch.float32, device=dev)) for r in raw]
        valid_in = torch.ones((), dtype=torch.bool, device=dev)
        for a in args:
            if _is_vv(a):
                valid_in = valid_in & a.valid
        n = max([1] + [v.shape[0] for v in vecs])
        X = (torch.stack([torch.broadcast_to(v, (n,)) for v in vecs]) if vecs
             else torch.zeros((1, 1), dtype=torch.float32, device=dev))
        batch = encode_population([self.tree], max(self.tree.count_nodes(), 1), self.operators,
                                  device=dev)
        y, valid = eval_tree_batch(batch, X, self.operators)
        y, valid = y[0], valid[0] & valid_in
        if any(_is_vv(a) for a in args):
            return ValidVector(y, valid)
        y = torch.where(valid, y, torch.nan)
        return float(y[0]) if scalar_input else y
