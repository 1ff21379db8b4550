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
        """Slices the data; validity unchanged."""
        return ValidVector(self.x[idx], self.valid)


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
    return ValidVector(out, valid)


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
        raise NotImplementedError(
            "the host-side symbolic derivative of a ComposableExpression (ops/diff.py) is "
            "not in the PyTorch port yet; it comes with the expression-plugin slice "
            "(ROADMAP.md queue 1 item 4).")

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
