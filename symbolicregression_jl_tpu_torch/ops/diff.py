"""Public evaluation and differentiation API over expression trees (port
of ``ops/diff.py``).

The DynamicExpressions surface of the Julia reference
(src/SymbolicRegression.jl:101-144, wrapped at
src/InterfaceDynamicExpressions.jl:58-183), in PyTorch:

- ``eval_tree_array``      — evaluate one host tree over a dataset.
- ``eval_diff_tree_array`` — forward-mode derivative w.r.t. one feature.
- ``eval_grad_tree_array`` — gradient w.r.t. all features or all constants.
- ``differentiable_eval_tree_array`` — alias: the eager interpreter is
  differentiable (``torch.autograd`` flows through it).
- ``D``                    — symbolic differentiation of host trees (the
  DynamicDiff.D analogue template structures use,
  src/SymbolicRegression.jl:172).

Derivatives are forward-mode (``torch.autograd.forward_ad``) through the
eager postfix interpreter (ops/eval.py ``eval_single_tree``), as the JAX
package takes ``jax.jvp``/``jax.jacfwd`` through its interpreter: an
operator the tree does not select cannot spread a non-finite derivative
into the result. The symbolic ``D`` exists for the template API, where a
*tree-valued* derivative is needed. Results are torch tensors on ``X``'s
device (a numpy ``X`` goes to ``device``: CUDA unless ``"cpu"``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..device import resolve_device
from .encoding import encode_population
from .eval import eval_single_tree
from .operators import Op, OperatorSet, resolve_operator
from .tree import Node

__all__ = [
    "eval_tree_array",
    "eval_diff_tree_array",
    "eval_grad_tree_array",
    "differentiable_eval_tree_array",
    "extend_operators_for",
    "D",
]


def _as_xt(X, dtype, device) -> torch.Tensor:
    """User arrays are (n_rows, n_features); the interpreter wants [F, n]."""
    if isinstance(X, torch.Tensor):
        Xt = X.to(dtype)
    else:
        Xt = torch.as_tensor(np.asarray(X), dtype=dtype, device=resolve_device(device))
    if Xt.dim() != 2:
        raise ValueError(f"X must be 2D (n_rows, n_features); got {tuple(Xt.shape)}")
    return Xt.T.contiguous()


def extend_operators_for(tree: Node, operators: OperatorSet) -> OperatorSet:
    """Extend ``operators`` with any ops used by ``tree`` but absent from
    the set. Symbolic derivatives (``D``) introduce helper operators
    (``neg``, ``sign``, comparison ops, ...) outside the search vocabulary;
    evaluation widens the operator tables for them."""
    have = {(d, o.name) for d, ops in operators.ops.items() for o in ops}
    extra = {}
    for n in tree.nodes():
        if n.degree > 0 and (n.degree, n.op.name) not in have:
            extra[(n.degree, n.op.name)] = n.op
    if not extra:
        return operators
    ops_by_arity = {d: list(ops) for d, ops in operators.ops.items()}
    for (d, _), op in extra.items():
        ops_by_arity.setdefault(d, []).append(op)
    return OperatorSet(ops_by_arity={d: tuple(v) for d, v in ops_by_arity.items()})


def _encode_single(tree: Node, operators: OperatorSet, dtype, device):
    """(arity, op, feat, const, length) of one tree, slot fields [L]."""
    b = encode_population([tree], tree.count_nodes(), operators, device=device, dtype=dtype)
    return b.arity[0], b.op[0], b.feat[0], b.const[0], b.length[0]


def eval_tree_array(tree: Node, X, operators: OperatorSet, params: Optional[torch.Tensor] = None,
                    dtype=torch.float32, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate ``tree`` over ``X`` (n_rows, n_features).

    Returns ``(y[n_rows], completed)`` where ``completed`` is False iff a
    non-finite value appeared anywhere in the evaluation (the reference's
    early-exit flag, src/InterfaceDynamicExpressions.jl:32-44)."""
    Xt = _as_xt(X, dtype, device)
    operators = extend_operators_for(tree, operators)
    a, o, f, c, ln = _encode_single(tree, operators, dtype, Xt.device)
    return eval_single_tree(a, o, f, c, ln, None, Xt, operators, params=params)


def _jvp(run, primal: torch.Tensor, tangent: torch.Tensor):
    """(primal outputs, tangent of the first output) of ``run`` at
    ``primal`` along ``tangent``, in forward mode."""
    with fwAD.dual_level():
        out = run(fwAD.make_dual(primal, tangent))
        y, dy = fwAD.unpack_dual(out[0])
        rest = tuple(fwAD.unpack_dual(r).primal if isinstance(r, torch.Tensor) else r
                     for r in out[1:])
    if dy is None:
        dy = torch.zeros_like(y)
    return (y,) + rest, dy


def eval_diff_tree_array(tree: Node, X, operators: OperatorSet, direction: int,
                         dtype=torch.float32, device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward-mode derivative w.r.t. feature ``direction`` (0-based).

    Returns ``(y[n], dy_dx[n], completed)``, the ``eval_diff_tree_array``
    analogue (src/InterfaceDynamicExpressions.jl:118-130)."""
    Xt = _as_xt(X, dtype, device)
    operators = extend_operators_for(tree, operators)
    a, o, f, c, ln = _encode_single(tree, operators, dtype, Xt.device)
    seed = torch.zeros_like(Xt)
    seed[direction] = 1.0
    (y, valid), dy = _jvp(lambda x: eval_single_tree(a, o, f, c, ln, None, x, operators),
                          Xt, seed)
    return y, dy, valid


def eval_grad_tree_array(tree: Node, X, operators: OperatorSet, variable: bool = False,
                         dtype=torch.float32, device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradient of the tree's output at every row.

    ``variable=True``: w.r.t. all features, grad ``[F, n]``.
    ``variable=False``: w.r.t. the tree's scalar constants in depth-first
    post-order, grad ``[n_constants, n]``. Mirrors
    ``eval_grad_tree_array`` (src/InterfaceDynamicExpressions.jl:153-165):
    one forward-mode pass per feature or per constant."""
    Xt = _as_xt(X, dtype, device)
    operators = extend_operators_for(tree, operators)
    a, o, f, c, ln = _encode_single(tree, operators, dtype, Xt.device)
    y, valid = eval_single_tree(a, o, f, c, ln, None, Xt, operators)
    rows: List[torch.Tensor] = []
    if variable:
        for fidx in range(Xt.shape[0]):
            seed = torch.zeros_like(Xt)
            seed[fidx] = 1.0
            rows.append(_jvp(lambda x: eval_single_tree(a, o, f, c, ln, None, x, operators),
                             Xt, seed)[1])
        return y, torch.stack(rows), valid
    # w.r.t. constants: one tangent per constant leaf's slot
    const_slots = [k for k, n in enumerate(tree.nodes())
                   if n.degree == 0 and n.constant and not n.is_parameter]
    for k in const_slots:
        seed = torch.zeros_like(c)
        seed[k] = 1.0
        rows.append(_jvp(lambda c_: eval_single_tree(a, o, f, c_, ln, None, Xt, operators),
                         c, seed)[1])
    grad = torch.stack(rows) if rows else torch.zeros((0, Xt.shape[1]), dtype=Xt.dtype,
                                                        device=Xt.device)
    return y, grad, valid


# The interpreter is differentiable: it IS the differentiable evaluator.
differentiable_eval_tree_array = eval_tree_array


# ---------------------------------------------------------------------------
# Symbolic differentiation (DynamicDiff.D analogue)
# ---------------------------------------------------------------------------


def _op(name: str) -> Op:
    return resolve_operator(name)


def _c(v: float) -> Node:
    return Node.const(float(v))


def _is_const(n: Node, v: Optional[float] = None) -> bool:
    return (
        n.degree == 0 and n.constant and not n.is_parameter
        and (v is None or n.val == v)
    )


def _add(a: Node, b: Node) -> Node:
    if _is_const(a, 0.0):
        return b
    if _is_const(b, 0.0):
        return a
    if _is_const(a) and _is_const(b):
        return _c(a.val + b.val)
    return Node(op=_op("+"), children=[a, b])


def _sub(a: Node, b: Node) -> Node:
    if _is_const(b, 0.0):
        return a
    if _is_const(a) and _is_const(b):
        return _c(a.val - b.val)
    if _is_const(a, 0.0):
        return Node(op=_op("neg"), children=[b])
    return Node(op=_op("-"), children=[a, b])


def _mul(a: Node, b: Node) -> Node:
    if _is_const(a, 0.0) or _is_const(b, 0.0):
        return _c(0.0)
    if _is_const(a, 1.0):
        return b
    if _is_const(b, 1.0):
        return a
    if _is_const(a) and _is_const(b):
        return _c(a.val * b.val)
    return Node(op=_op("*"), children=[a, b])


def _div(a: Node, b: Node) -> Node:
    if _is_const(a, 0.0):
        return _c(0.0)
    if _is_const(b, 1.0):
        return a
    if _is_const(a) and _is_const(b) and b.val != 0:
        return _c(a.val / b.val)
    return Node(op=_op("/"), children=[a, b])


def _pow(a: Node, b: Node) -> Node:
    if _is_const(b, 1.0):
        return a
    if _is_const(b, 0.0):
        return _c(1.0)
    return Node(op=_op("^"), children=[a, b])


def _un(name: str, a: Node) -> Node:
    return Node(op=_op(name), children=[a])


def D(tree: Node, feature: int) -> Node:
    """Symbolic derivative of ``tree`` w.r.t. variable ``feature`` (0-based).

    Returns a new tree (inputs are not mutated). Supports the operator
    vocabulary of the builtin registry; raises ``ValueError`` for operators
    with no registered derivative rule. The result is lightly simplified
    (constant folding, 0/1 identities) so that iterated application stays
    compact, as the JAX package's ``D`` (and the reference's,
    src/SymbolicRegression.jl:172) does.
    """
    if tree.degree == 0:
        if tree.is_parameter or tree.constant:
            return _c(0.0)
        return _c(1.0 if tree.feature == feature else 0.0)

    name = tree.op.name
    if tree.degree == 2:
        a, b = tree.children
        da, db = D(a, feature), D(b, feature)
        ac, bc = a.copy(), b.copy()
        if name == "+":
            return _add(da, db)
        if name == "-":
            return _sub(da, db)
        if name == "*":
            return _add(_mul(da, bc), _mul(ac, db))
        if name == "/":
            return _div(
                _sub(_mul(da, bc), _mul(ac, db)), _mul(b.copy(), b.copy())
            )
        if name == "^":
            if b.degree == 0 and b.constant:
                # Constant exponent: d(a^c) = c*a^(c-1)*da — valid at a=0
                # and for negative bases with integer c, where the log(a)
                # form below would be NaN.
                return _mul(_mul(bc, _pow(a.copy(), _c(b.val - 1.0))), da)
            # d(a^b) = a^b * (db*log(a) + b*da/a)
            term1 = _mul(db, _un("log", ac))
            term2 = _div(_mul(bc, da), a.copy())
            return _mul(_pow(a.copy(), b.copy()), _add(term1, term2))
        if name == "max":
            ge = Node(op=_op("greater_equal"), children=[ac, bc])
            one_minus = _sub(_c(1.0), ge.copy())
            return _add(_mul(ge, da), _mul(one_minus, db))
        if name == "min":
            le = Node(op=_op("less_equal"), children=[ac, bc])
            one_minus = _sub(_c(1.0), le.copy())
            return _add(_mul(le, da), _mul(one_minus, db))
        if name == "atan2":
            denom = _add(_mul(a.copy(), a.copy()), _mul(b.copy(), b.copy()))
            return _div(_sub(_mul(bc, da), _mul(ac, db)), denom)
        raise ValueError(f"No derivative rule for binary operator {name!r}")

    (a,) = tree.children
    da = D(a, feature)
    ac = a.copy()
    rules = {
        "sin": lambda: _un("cos", ac),
        "cos": lambda: _un("neg", _un("sin", ac)),
        "tan": lambda: _add(_c(1.0), _mul(_un("tan", ac), _un("tan", a.copy()))),
        "sinh": lambda: _un("cosh", ac),
        "cosh": lambda: _un("sinh", ac),
        "tanh": lambda: _sub(
            _c(1.0), _mul(_un("tanh", ac), _un("tanh", a.copy()))
        ),
        "exp": lambda: _un("exp", ac),
        "log": lambda: _div(_c(1.0), ac),
        "log2": lambda: _div(_c(1.0 / np.log(2.0)), ac),
        "log10": lambda: _div(_c(1.0 / np.log(10.0)), ac),
        "log1p": lambda: _div(_c(1.0), _add(_c(1.0), ac)),
        "sqrt": lambda: _div(_c(0.5), _un("sqrt", ac)),
        "cbrt": lambda: _div(
            _c(1.0 / 3.0), _mul(_un("cbrt", ac), _un("cbrt", a.copy()))
        ),
        "abs": lambda: _un("sign", ac),
        "neg": lambda: _c(-1.0),
        "square": lambda: _mul(_c(2.0), ac),
        "cube": lambda: _mul(_c(3.0), _mul(ac, a.copy())),
        "inv": lambda: _un("neg", _div(_c(1.0), _mul(ac, a.copy()))),
        "asin": lambda: _div(
            _c(1.0), _un("sqrt", _sub(_c(1.0), _mul(ac, a.copy())))
        ),
        "acos": lambda: _un(
            "neg",
            _div(_c(1.0), _un("sqrt", _sub(_c(1.0), _mul(ac, a.copy())))),
        ),
        "atan": lambda: _div(_c(1.0), _add(_c(1.0), _mul(ac, a.copy()))),
        "asinh": lambda: _div(
            _c(1.0), _un("sqrt", _add(_c(1.0), _mul(ac, a.copy())))
        ),
        "acosh": lambda: _div(
            _c(1.0), _un("sqrt", _sub(_mul(ac, a.copy()), _c(1.0)))
        ),
        "atanh": lambda: _div(_c(1.0), _sub(_c(1.0), _mul(ac, a.copy()))),
        "erf": lambda: _mul(
            _c(2.0 / np.sqrt(np.pi)),
            _un("exp", _un("neg", _mul(ac, a.copy()))),
        ),
        "erfc": lambda: _mul(
            _c(-2.0 / np.sqrt(np.pi)),
            _un("exp", _un("neg", _mul(ac, a.copy()))),
        ),
        "relu": lambda: Node(op=_op("greater"), children=[ac, _c(0.0)]),
        "sign": lambda: _c(0.0),
        "round": lambda: _c(0.0),
        "floor": lambda: _c(0.0),
        "ceil": lambda: _c(0.0),
    }
    if name not in rules:
        raise ValueError(f"No derivative rule for unary operator {name!r}")
    outer = rules[name]()
    return _mul(outer, da)
