"""User operators on the interpreter kernels: a tracer and two emitters.

The JAX package traces any elementwise operator into its kernels: the
forward in ``_fwd_dispatch`` and the adjoint through ``jax.vjp`` of the
operator's own function (``symbolicregression_jl_tpu/ops/fused_eval.py``
:216-300, :1983-1992). The port's kernels are CUDA C++ built ahead of the
search, so a user ``Op`` (a torch callable of one or two tensors) is traced
here into a small IR, a DAG of elementwise nodes, and the IR is emitted
twice:

- as CUDA device functions ``user_unary_<k><C>(C x)`` and
  ``user_binary_<k><C>(C a, C b)``, with their adjoints
  ``user_unary_vjp_<k>`` / ``user_binary_vjp_<k>``, written against the
  compute type ``C`` with ``rn_add``/``rn_mul``/... (no contraction) and
  the ``m_*`` math functions of ``csrc/interp.cuh``. The header goes into
  ``build/kernels/`` (ops/cuda_build.py), one library per operator set;
- as a torch function from the same IR (:meth:`OpIR.torch_forward`) and
  its reverse sweep (:meth:`OpIR.torch_vjp`); the tests hold them against
  ``op.fn`` and ``torch.autograd``.

The adjoint is one reverse sweep over the IR with autograd's own rules, as
``torch.autograd`` applies them to the function (the kernels' plain
versions differentiate ``op.fn`` with it): ``where`` sends the cotangent to
the selected branch only, and an unselected branch's ``0 * inf`` stays NaN,
as it does under ``jax.vjp``. Contributions to a value add in the order
autograd adds them (the latest consumer's first).

What the tracer takes (:data:`TRACEABLE`): tensor arithmetic ``+ - * /``,
``**`` by a Python number, unary minus, comparisons and the logical
operators on their results; Python numbers (rounded to the compute type,
as JAX rounds weak scalars); ``torch.where``, ``abs``, ``exp``, ``log``,
``log1p``, ``sqrt``, ``sin``, ``cos``, ``tan``, ``tanh``, ``sigmoid``,
``erf``, ``minimum``, ``maximum``, ``clamp``/``clip`` by numbers,
``square``, ``zeros_like``/``ones_like``/``full_like``, ``.to(x.dtype)`` of
a comparison; and the port's own operator functions (``ops/operators.py``:
``safe_log``, ``safe_sqrt``, ``safe_pow``, ``py_mod``, ...) called by the
operator, which become the built-in operator's own kernel code and
derivative. Anything else refuses the operator, naming the function.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import operator as _pyop
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["UntraceableOperator", "OpIR", "trace_op", "is_builtin", "UserOpSet",
           "user_op_set", "USER_BINARY_BASE", "USER_UNARY_BASE", "USER_ID_END", "TRACEABLE"]

# Operator ids of user operators in csrc/interp.cuh (binary 96-111, unary
# 112-127), beside the built-in ids 0-15 and 32-64.
USER_BINARY_BASE = 96
USER_UNARY_BASE = 112
USER_ID_END = 128

TRACEABLE = ("+", "-", "*", "/", "** (by a number)", "unary -", "< <= > >= == !=",
             "& | ~ (of comparisons)", "where", "abs", "exp", "log", "log1p", "sqrt", "sin",
             "cos", "tan", "tanh", "sigmoid", "erf", "minimum", "maximum",
             "clamp/clip (by numbers)", "square", "zeros_like", "ones_like", "full_like",
             ".to(x.dtype) of a comparison", "the operator functions of ops/operators.py")


class UntraceableOperator(NotImplementedError):
    """A user operator the kernels' tracer cannot take."""


def _refuse(op_name: str, what: str):
    raise UntraceableOperator(
        f"user operator {op_name!r} calls {what}, which the kernels' tracer "
        f"(ops/user_ops.py) does not take; it takes {', '.join(TRACEABLE)}. Pass turbo=False "
        f"to run the operator on the eager path.")


# ---------------------------------------------------------------------------
# The IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Node:
    """One elementwise node. ``args`` are node indices, or Python floats
    (:class:`Num`) where the operator took a number; ``boolean`` marks a
    comparison's result; ``param`` is the node's static parameter (the
    constant, the exponent, the clamp bounds, the built-in operator)."""

    op: str
    args: Tuple = ()
    param: object = None
    boolean: bool = False


class Num(float):
    """A Python number operand (kept as a number, so the torch emitter
    replays the same scalar call)."""


_UNARY_MATH = ("exp", "log", "log1p", "sqrt", "sin", "cos", "tan", "tanh", "sigmoid", "erf",
               "abs")
_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_PY_CMP = {"lt": _pyop.lt, "le": _pyop.le, "gt": _pyop.gt, "ge": _pyop.ge, "eq": _pyop.eq,
           "ne": _pyop.ne}
_ARITH = {"add": _pyop.add, "sub": _pyop.sub, "mul": _pyop.mul, "div": _pyop.truediv}


@dataclasses.dataclass(frozen=True)
class OpIR:
    """The traced DAG of one operator: ``nodes`` in creation order (the
    first ``arity`` are its arguments) and the output node ``out``."""

    name: str
    arity: int
    nodes: Tuple[Node, ...]
    out: int

    # -- the torch emitter -------------------------------------------------

    def torch_forward(self, *xs: torch.Tensor) -> torch.Tensor:
        """The operator's value from the IR, by the same torch calls."""
        return self._values(xs)[self.out]

    def _values(self, xs):
        from .operators import OPERATOR_REGISTRY

        vals: List = []
        ref = xs[0]

        def arg(a):
            return float(a) if isinstance(a, Num) else vals[a]

        for nd in self.nodes:
            a = [arg(v) for v in nd.args]
            op = nd.op
            if op == "arg":
                v = xs[nd.param]
            elif op == "const":
                v = torch.full_like(ref, nd.param)
            elif op in _ARITH:
                v = _ARITH[op](a[0], a[1])
            elif op == "neg":
                v = -a[0]
            elif op == "recip":
                v = torch.reciprocal(a[0])
            elif op == "pow":
                v = a[0] ** nd.param
            elif op in _UNARY_MATH:
                v = getattr(torch, op)(a[0])
            elif op in _CMP:
                v = _PY_CMP[op](a[0], a[1])
            elif op == "and":
                v = a[0] & a[1]
            elif op == "or":
                v = a[0] | a[1]
            elif op == "not":
                v = ~a[0]
            elif op == "tofloat":
                v = a[0].to(ref.dtype)
            elif op == "where":
                v = torch.where(a[0], a[1], a[2])
            elif op == "minimum":
                v = torch.minimum(a[0], a[1])
            elif op == "maximum":
                v = torch.maximum(a[0], a[1])
            elif op == "clamp":
                v = torch.clamp(a[0], min=nd.param[0], max=nd.param[1])
            elif op == "builtin":
                v = OPERATOR_REGISTRY[nd.param].fn(*a)
            else:  # pragma: no cover - the tracer makes no other node
                raise AssertionError(op)
            vals.append(v)
        return vals

    def _needs_grad(self) -> List[bool]:
        """Which nodes depend on an argument (autograd's requires_grad)."""
        need = []
        for nd in self.nodes:
            need.append(nd.op == "arg" or (not nd.boolean and nd.op != "const" and any(
                not isinstance(a, Num) and need[a] for a in nd.args)))
        return need

    def _contributions(self, i: int):
        """[(operand position, rule)] of node i's adjoint: each rule names
        how the cotangent g becomes that operand's contribution."""
        nd = self.nodes[i]
        op = nd.op
        if op in ("add", "sub", "mul", "div"):
            return [(0, op + "0"), (1, op + "1")]
        if op == "where":
            return [(1, "where1"), (2, "where2")]
        if op in ("minimum", "maximum"):
            return [(0, op + "0"), (1, op + "1")]
        if op == "builtin":
            return [(j, f"builtin{j}") for j in range(len(nd.args))]
        if op in ("neg", "recip", "pow", "clamp") or op in _UNARY_MATH:
            return [(0, op)]
        return []

    def torch_vjp(self, xs: Sequence[torch.Tensor], ct: torch.Tensor):
        """Each argument's cotangent from the root's ``ct`` (zeros where the
        operator does not depend on it), by torch autograd's rules."""
        from .operators import OPERATOR_REGISTRY
        from .vjp import BINARY_VJP, UNARY_VJP

        vals = self._values(xs)
        need = self._needs_grad()
        grads: Dict[int, torch.Tensor] = {self.out: ct}
        for i in reversed(range(len(self.nodes))):
            g = grads.get(i)
            nd = self.nodes[i]
            if g is None or nd.op == "arg":
                continue
            a = [float(v) if isinstance(v, Num) else vals[v] for v in nd.args]
            for pos, rule in self._contributions(i):
                src = nd.args[pos]
                if isinstance(src, Num) or not need[src]:
                    continue
                c = _torch_rule(rule, nd, a, vals[i], g, OPERATOR_REGISTRY, BINARY_VJP,
                                UNARY_VJP)
                grads[src] = c if src not in grads else grads[src] + c
        return tuple(grads.get(k, torch.zeros_like(ct)) for k in range(self.arity))

    # -- the CUDA emitter --------------------------------------------------

    def cuda(self, k: int) -> str:
        """The device functions of this operator as number ``k`` of its
        arity: the forward and the adjoint."""
        from .fused_eval import _KERNEL_OP_IDS

        names = ("x",) if self.arity == 1 else ("a", "b")
        fwd = self._cuda_values(names, _KERNEL_OP_IDS)
        kind = "unary" if self.arity == 1 else "binary"
        params = ", ".join(f"C {n}" for n in names)
        out = [f"// {self.name}",
               "template <typename C>",
               f"__device__ __forceinline__ C user_{kind}_{k}({params}) {{"]
        out += [f"  {line}" for line in fwd]
        out.append(f"  return {_ref(self.out)};")
        out.append("}")
        rev, have = self._cuda_adjoint(_KERNEL_OP_IDS)
        grads = [f"g{j}" if j in have else "C(0)" for j in range(self.arity)]
        out.append("template <typename C>")
        if self.arity == 1:
            out.append(f"__device__ __forceinline__ C user_unary_vjp_{k}(C x, C ct) {{")
        else:
            out.append(f"__device__ __forceinline__ void user_binary_vjp_{k}(C a, C b, C ct, "
                       f"C& da, C& db) {{")
        used = _used_refs(rev, self.nodes)
        out += [f"  {line}" for line in fwd if _defines(line) in used]
        out += [f"  {line}" for line in rev]
        if self.arity == 1:
            out.append(f"  return {grads[0]};")
        else:
            out.append(f"  da = {grads[0]};")
            out.append(f"  db = {grads[1]};")
        out.append("}")
        return "\n".join(out)

    def _cuda_values(self, names, ids) -> List[str]:
        lines = []
        for i, nd in enumerate(self.nodes):
            if nd.op == "arg":
                expr = names[nd.param]
            else:
                expr = _cuda_expr(nd, ids)
            ty = "bool" if nd.boolean else "C"
            lines.append(f"const {ty} {_ref(i)} = {expr};")
        return lines

    def _cuda_adjoint(self, ids):
        """(lines, the nodes given a cotangent) of the reverse sweep."""
        need = self._needs_grad()
        lines = []
        have = {self.out}
        lines.append(f"C g{self.out} = ct;")
        for i in reversed(range(len(self.nodes))):
            nd = self.nodes[i]
            if i not in have or nd.op == "arg":
                continue
            for pos, rule in self._contributions(i):
                src = nd.args[pos]
                if isinstance(src, Num) or not need[src]:
                    continue
                c = _cuda_rule(rule, nd, i, ids)
                if src in have:
                    lines.append(f"g{src} = rn_add(g{src}, {c});")
                else:
                    lines.append(f"C g{src} = {c};")
                    have.add(src)
        return lines, have


def _ref(i: int) -> str:
    return f"v{i}"


def _defines(line: str) -> str:
    return line.split("=", 1)[0].split()[-1]


def _used_refs(lines: List[str], nodes) -> set:
    """The forward values the adjoint's lines read, and what they read."""
    import re

    used = set()
    text = "\n".join(lines)
    for m in re.finditer(r"\bv(\d+)\b", text):
        used.add(int(m.group(1)))
    # close over the forward dependencies
    stack = list(used)
    while stack:
        i = stack.pop()
        for a in nodes[i].args:
            if not isinstance(a, Num) and a not in used:
                used.add(a)
                stack.append(a)
    return {_ref(i) for i in used}


def _lit(v: float) -> str:
    """A number at the compute type's rounding: ``C(<exact double>)``."""
    if math.isnan(v):
        return "qnan<C>()"
    if math.isinf(v):
        return "C(INFINITY)" if v > 0 else "C(-INFINITY)"
    return f"C({float(v)!r})"


def _opnd(a) -> str:
    return _lit(float(a)) if isinstance(a, Num) else _ref(a)


def _cuda_expr(nd: Node, ids) -> str:
    op = nd.op
    a = [_opnd(v) for v in nd.args]
    if op == "const":
        return _lit(nd.param)
    if op in _ARITH:
        return f"rn_{op}({a[0]}, {a[1]})"
    if op == "neg":
        return f"-{a[0]}"
    if op == "recip":
        return f"rn_div(C(1), {a[0]})"
    if op == "pow":
        p = float(nd.param)
        # torch's pow by a number: these exponents by multiplication,
        # square root and reciprocal (as JAX's integer_pow for 2 and 3).
        if p == 2:
            return f"rn_mul({a[0]}, {a[0]})"
        if p == 3:
            return f"rn_mul(rn_mul({a[0]}, {a[0]}), {a[0]})"
        if p == 1:
            return a[0]
        if p == 0:
            return "C(1)"
        if p == 0.5:
            return f"m_sqrt({a[0]})"
        if p == -0.5:
            return f"rn_div(C(1), m_sqrt({a[0]}))"
        if p == -1:
            return f"rn_div(C(1), {a[0]})"
        if p == -2:
            return f"rn_div(C(1), rn_mul({a[0]}, {a[0]}))"
        return f"m_pow({a[0]}, {_lit(p)})"
    if op == "sigmoid":
        return f"rn_div(C(1), rn_add(C(1), m_exp(-{a[0]})))"
    if op in _UNARY_MATH:
        return f"m_{op}({a[0]})"
    if op in _CMP:
        return f"({a[0]} {_CMP[op]} {a[1]})"
    if op == "and":
        return f"({a[0]} && {a[1]})"
    if op == "or":
        return f"({a[0]} || {a[1]})"
    if op == "not":
        return f"(!{a[0]})"
    if op == "tofloat":
        return f"({a[0]} ? C(1) : C(0))"
    if op == "where":
        return f"({a[0]} ? {a[1]} : {a[2]})"
    if op == "minimum":
        return f"nan_min({a[0]}, {a[1]})"
    if op == "maximum":
        return f"nan_max({a[0]}, {a[1]})"
    if op == "clamp":
        lo, hi = nd.param
        e = a[0]
        if lo is not None:
            e = f"nan_max({e}, {_lit(lo)})"
        if hi is not None:
            e = f"nan_min({e}, {_lit(hi)})"
        return e
    if op == "builtin":
        fn = "apply_unary" if len(a) == 1 else "apply_binary"
        return f"{fn}<C>({ids[nd.param]}, {', '.join(a)})"
    raise AssertionError(op)  # pragma: no cover


# ---------------------------------------------------------------------------
# Adjoint rules (torch autograd's formulas, tools/autograd/derivatives.yaml)
# ---------------------------------------------------------------------------


def _torch_rule(rule, nd, a, val, g, registry, bvjp, uvjp):
    op = nd.op
    if rule == "add0" or rule == "add1":
        return g
    if rule == "sub0":
        return g
    if rule == "sub1":
        return -g
    if rule == "mul0":
        return g * a[1]
    if rule == "mul1":
        return g * a[0]
    if rule == "div0":
        return g / a[1]
    if rule == "div1":
        return -g * ((a[0] / a[1]) / a[1])
    if rule == "neg":
        return -g
    if rule == "recip":
        return -g * (val * val)
    if rule == "pow":
        p = float(nd.param)
        if p == 0:
            return torch.zeros_like(g)
        return g * (p * a[0].pow(p - 1))
    if rule == "exp":
        return g * val
    if rule == "log":
        return g / a[0]
    if rule == "log1p":
        return g / (a[0] + 1)
    if rule == "sqrt":
        return g / (2 * val)
    if rule == "sin":
        return g * a[0].cos()
    if rule == "cos":
        return g * -a[0].sin()
    if rule == "tan":
        return g * (1 + val.pow(2))
    if rule == "tanh":
        return torch.ops.aten.tanh_backward(g, val)
    if rule == "sigmoid":
        return torch.ops.aten.sigmoid_backward(g, val)
    if rule == "erf":
        return 2.0 / math.sqrt(math.pi) * torch.exp(-(a[0].pow(2))) * g
    if rule == "abs":
        return g * a[0].sgn()
    if rule == "where1":
        return torch.where(a[0], g, 0.0)
    if rule == "where2":
        return torch.where(a[0], 0.0, g)
    if op in ("minimum", "maximum"):
        x, y = a
        half = torch.where(x == y, g / 2, g)
        mine_smaller = (x > y) if op == "minimum" else (x < y)
        mine_larger = (x < y) if op == "minimum" else (x > y)
        return half.masked_fill(mine_smaller if rule.endswith("0") else mine_larger, 0)
    if rule == "clamp":
        lo, hi = nd.param
        x = a[0]
        ok = torch.ones_like(x, dtype=torch.bool)
        if lo is not None:
            ok = ok & (x >= lo)
        if hi is not None:
            ok = ok & (x <= hi)
        return torch.where(ok, g, torch.zeros_like(g))
    if rule.startswith("builtin"):
        op_ = registry[nd.param]
        if op_.arity == 1:
            return uvjp[nd.param](a[0], g)
        return bvjp[nd.param](a[0], a[1], g)[int(rule[-1])]
    raise AssertionError(rule)  # pragma: no cover


def _cuda_rule(rule, nd, i, ids) -> str:
    op = nd.op
    a = [_opnd(v) for v in nd.args]
    g = f"g{i}"
    v = _ref(i)
    if rule in ("add0", "add1", "sub0"):
        return g
    if rule == "sub1":
        return f"-{g}"
    if rule == "mul0":
        return f"rn_mul({g}, {a[1]})"
    if rule == "mul1":
        return f"rn_mul({g}, {a[0]})"
    if rule == "div0":
        return f"rn_div({g}, {a[1]})"
    if rule == "div1":
        return f"rn_mul(-{g}, rn_div(rn_div({a[0]}, {a[1]}), {a[1]}))"
    if rule == "neg":
        return f"-{g}"
    if rule == "recip":
        return f"rn_mul(-{g}, rn_mul({v}, {v}))"
    if rule == "pow":
        p = float(nd.param)
        if p == 0:
            return "C(0)"
        q = p - 1
        if q == 1:
            pw = a[0]
        elif q == 2:
            pw = f"rn_mul({a[0]}, {a[0]})"
        elif q == 0:
            pw = "C(1)"
        else:
            pw = _cuda_expr(Node("pow", (nd.args[0],), q), ids)
        return f"rn_mul({g}, rn_mul({_lit(p)}, {pw}))"
    if rule == "exp":
        return f"rn_mul({g}, {v})"
    if rule == "log":
        return f"rn_div({g}, {a[0]})"
    if rule == "log1p":
        return f"rn_div({g}, rn_add({a[0]}, C(1)))"
    if rule == "sqrt":
        return f"rn_div({g}, rn_mul(C(2), {v}))"
    if rule == "sin":
        return f"rn_mul({g}, m_cos({a[0]}))"
    if rule == "cos":
        return f"rn_mul({g}, -m_sin({a[0]}))"
    if rule == "tan":
        return f"rn_mul({g}, rn_add(C(1), rn_mul({v}, {v})))"
    if rule == "tanh":
        return f"rn_mul({g}, rn_fma(-{v}, {v}, C(1)))"
    if rule == "sigmoid":
        return f"rn_mul(rn_mul({g}, rn_sub(C(1), {v})), {v})"
    if rule == "erf":
        return (f"rn_mul(rn_mul(Num<C>::two_over_sqrt_pi(), m_exp(-rn_mul({a[0]}, {a[0]}))), "
                f"{g})")
    if rule == "abs":
        return f"rn_mul({g}, sign_of({a[0]}))"
    if rule == "where1":
        return f"({a[0]} ? {g} : C(0))"
    if rule == "where2":
        return f"({a[0]} ? C(0) : {g})"
    if op in ("minimum", "maximum"):
        x, y = a
        smaller, larger = ("<", ">") if op == "maximum" else (">", "<")
        cmp = smaller if rule.endswith("0") else larger
        return f"(({x} {cmp} {y}) ? C(0) : (({x} == {y}) ? rn_div({g}, C(2)) : {g}))"
    if rule == "clamp":
        lo, hi = nd.param
        conds = []
        if lo is not None:
            conds.append(f"{a[0]} >= {_lit(lo)}")
        if hi is not None:
            conds.append(f"{a[0]} <= {_lit(hi)}")
        return f"(({' && '.join(conds) or 'true'}) ? {g} : C(0))"
    if rule.startswith("builtin"):
        if len(a) == 1:
            return f"vjp_unary<C>({ids[nd.param]}, {a[0]}, {g})"
        j = int(rule[-1])
        return f"user_vjp_part<C>({ids[nd.param]}, {a[0]}, {a[1]}, {g}, {j})"
    raise AssertionError(rule)  # pragma: no cover


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------


class _Dtype:
    """``x.dtype`` of a traced value (only ``.to(x.dtype)`` takes it)."""


_DTYPE = _Dtype()


class _Tracer:
    def __init__(self, name: str):
        self.name = name
        self.nodes: List[Node] = []

    def add(self, node: Node) -> "_Sym":
        self.nodes.append(node)
        return _Sym(self, len(self.nodes) - 1, node.boolean)

    def operand(self, v, allow_bool: bool = False):
        if isinstance(v, _Sym):
            if v._t is not self:
                _refuse(self.name, "a value traced elsewhere")
            if v._b and not allow_bool:
                _refuse(self.name, "arithmetic on a comparison's result (convert it with "
                                   ".to(x.dtype) first)")
            return v._i
        if isinstance(v, bool):
            _refuse(self.name, "a Python bool operand")
        if isinstance(v, (int, float)):
            return Num(float(v))
        _refuse(self.name, f"an operand of type {type(v).__name__}")


class _Sym:
    """A traced value: arithmetic and comparisons by Python's operators,
    torch functions by ``__torch_function__``."""

    __slots__ = ("_t", "_i", "_b")

    def __init__(self, tracer: _Tracer, index: int, boolean: bool):
        self._t, self._i, self._b = tracer, index, boolean

    def _bin(self, op, other, reverse=False, boolean=False, allow_bool=False):
        t = self._t
        x, y = t.operand(self, allow_bool), t.operand(other, allow_bool)
        if reverse:
            x, y = y, x
        return t.add(Node(op, (x, y), boolean=boolean))

    __add__ = lambda s, o: s._bin("add", o)
    __radd__ = lambda s, o: s._bin("add", o, True)
    __sub__ = lambda s, o: s._bin("sub", o)
    __rsub__ = lambda s, o: s._bin("sub", o, True)
    __mul__ = lambda s, o: s._bin("mul", o)
    __rmul__ = lambda s, o: s._bin("mul", o, True)
    __truediv__ = lambda s, o: s._bin("div", o)
    def __rtruediv__(self, o):
        # torch's ``number / tensor`` is ``tensor.reciprocal() * number``
        # (torch/_tensor.py ``__rdiv__``), and so is its gradient.
        t = self._t
        r = t.add(Node("recip", (t.operand(self),)))
        return r._bin("mul", o)
    __lt__ = lambda s, o: s._bin("lt", o, boolean=True)
    __le__ = lambda s, o: s._bin("le", o, boolean=True)
    __gt__ = lambda s, o: s._bin("gt", o, boolean=True)
    __ge__ = lambda s, o: s._bin("ge", o, boolean=True)
    __eq__ = lambda s, o: s._bin("eq", o, boolean=True)
    __ne__ = lambda s, o: s._bin("ne", o, boolean=True)

    def _logic(self, op, other):
        t = self._t
        if not (self._b and isinstance(other, _Sym) and other._b):
            _refuse(t.name, f"the operator {op!r} on a value that is not a comparison")
        return t.add(Node(op, (self._i, t.operand(other, True)), boolean=True))

    __and__ = lambda s, o: s._logic("and", o)
    __or__ = lambda s, o: s._logic("or", o)

    def __invert__(self):
        if not self._b:
            _refuse(self._t.name, "~ on a value that is not a comparison")
        return self._t.add(Node("not", (self._i,), boolean=True))

    def __neg__(self):
        return self._t.add(Node("neg", (self._t.operand(self),)))

    def __pos__(self):
        return self

    def __abs__(self):
        return self._t.add(Node("abs", (self._t.operand(self),)))

    def __pow__(self, p):
        if isinstance(p, bool) or not isinstance(p, (int, float)):
            _refuse(self._t.name, "** by a tensor (safe_pow of ops/operators.py is taken)")
        return self._t.add(Node("pow", (self._t.operand(self),), float(p)))

    def __rpow__(self, base):
        _refuse(self._t.name, "a number ** a tensor")

    def __bool__(self):
        _refuse(self._t.name, "a Python branch on a traced value (bool())")

    def __float__(self):
        _refuse(self._t.name, "float() of a traced value")

    __hash__ = object.__hash__

    @property
    def dtype(self):
        return _DTYPE

    def to(self, *args, **kwargs):
        target = args[0] if args else kwargs.get("dtype")
        if target is not _DTYPE or len(args) > 1 or (kwargs and set(kwargs) != {"dtype"}):
            _refuse(self._t.name, ".to() with anything but x.dtype")
        if not self._b:
            return self
        return self._t.add(Node("tofloat", (self._i,)))

    def __getattr__(self, name):
        if name in _METHODS:
            return functools.partial(_call, self._t, name, self)
        _refuse(self._t.name, f"the tensor attribute .{name}")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        tracer = next(a._t for a in list(args) + list((kwargs or {}).values())
                      if isinstance(a, _Sym))
        name = getattr(func, "__name__", repr(func))
        return _call(tracer, name, *args, **(kwargs or {}))


_METHODS = set(_UNARY_MATH) | {"neg", "negative", "square", "clamp", "clip", "minimum",
                               "maximum", "pow", "float"}


def _call(t: _Tracer, name: str, *args, **kwargs):
    name = name.lstrip("_").rstrip("_") if name.startswith("__") else name
    if name in _UNARY_MATH and len(args) == 1 and not kwargs:
        return t.add(Node(name, (t.operand(args[0]),)))
    if name in ("neg", "negative") and len(args) == 1 and not kwargs:
        return -args[0]
    if name == "square" and len(args) == 1 and not kwargs:
        return args[0] ** 2
    if name == "pow" and len(args) == 2 and not kwargs and isinstance(args[0], _Sym):
        return args[0] ** args[1]
    if name in ("add", "sub", "mul", "div", "truediv", "lt", "le", "gt", "ge", "eq", "ne") \
            and len(args) == 2 and not kwargs:
        op = {"truediv": "div"}.get(name, name)
        x, y = args
        if isinstance(x, _Sym):
            return x._bin(op, y, boolean=op in _CMP)
        return y._bin(op, x, reverse=True, boolean=op in _CMP)
    if name in ("greater", "less", "greater_equal", "less_equal", "not_equal") and \
            len(args) == 2 and not kwargs:
        op = {"greater": "gt", "less": "lt", "greater_equal": "ge", "less_equal": "le",
              "not_equal": "ne"}[name]
        return _call(t, op, *args)
    if name in ("logical_and", "logical_or") and len(args) == 2 and not kwargs:
        return args[0]._logic(name[8:], args[1])
    if name == "logical_not" and len(args) == 1 and not kwargs:
        return ~args[0]
    if name == "where" and len(args) == 3 and not kwargs:
        c, x, y = args
        if not (isinstance(c, _Sym) and c._b):
            _refuse(t.name, "torch.where with a condition that is not a comparison")
        ops = [t.operand(x), t.operand(y)]
        if all(isinstance(o, Num) for o in ops):
            _refuse(t.name, "torch.where of two numbers")
        return t.add(Node("where", (c._i, *ops)))
    if name in ("minimum", "maximum") and len(args) == 2 and not kwargs:
        x, y = args
        if not (isinstance(x, _Sym) and isinstance(y, _Sym)):
            _refuse(t.name, f"torch.{name} with a number (use clamp)")
        return t.add(Node(name, (t.operand(x), t.operand(y))))
    if name in ("clamp", "clip"):
        x = args[0]
        lo = args[1] if len(args) > 1 else kwargs.get("min")
        hi = args[2] if len(args) > 2 else kwargs.get("max")
        for b in (lo, hi):
            if b is not None and (isinstance(b, bool) or not isinstance(b, (int, float))):
                _refuse(t.name, f"torch.{name} by a tensor")
        if lo is None and hi is None:
            _refuse(t.name, f"torch.{name} without bounds")
        return t.add(Node("clamp", (t.operand(x),),
                          (None if lo is None else float(lo), None if hi is None else float(hi))))
    if name in ("zeros_like", "ones_like", "full_like"):
        if name == "full_like":
            v = args[1] if len(args) > 1 else kwargs.pop("fill_value", None)
            rest = kwargs
        else:
            v = 0.0 if name == "zeros_like" else 1.0
            rest = kwargs
        if rest or len(args) > (2 if name == "full_like" else 1) or \
                isinstance(v, bool) or not isinstance(v, (int, float)):
            _refuse(t.name, f"torch.{name} with a dtype, a device or a tensor fill")
        return t.add(Node("const", (), float(v)))
    if name == "float" and len(args) == 1 and isinstance(args[0], _Sym) and args[0]._b:
        return args[0].to(_DTYPE)
    _refuse(t.name, f"torch.{name}" if name else repr(name))


class _BuiltinHook:
    """Stands in for a port operator function while an operator is traced:
    on traced values it records the built-in operator, on anything else it
    is the function itself, so a thread evaluating the operator meanwhile
    computes what it would."""

    def __init__(self, fn, name: str):
        self.fn, self.name = fn, name
        functools.update_wrapper(self, fn)

    def __call__(self, *args):
        syms = [a for a in args if isinstance(a, _Sym)]
        if not syms:
            return self.fn(*args)
        t = syms[0]._t
        return t.add(Node("builtin", tuple(t.operand(a) for a in args), self.name))


def _port_functions() -> Dict[int, Tuple[object, str]]:
    """id(fn) -> (fn, built-in operator name) of the port's operator
    functions that a user operator may call."""
    from .fused_eval import _KERNEL_OP_IDS
    from .operators import OPERATOR_REGISTRY

    out = {}
    for name, op in OPERATOR_REGISTRY.items():
        if name in _KERNEL_OP_IDS and getattr(op.fn, "__module__", "") == \
                "symbolicregression_jl_tpu_torch.ops.operators":
            out[id(op.fn)] = (op.fn, name)
    return out


_TRACE_LOCK = threading.Lock()


def _hooked_globals(fn, ports):
    """[(dict, key, original)] of ``fn``'s globals and closure cells that
    hold a port operator function."""
    spots = []
    g = getattr(fn, "__globals__", None)
    code = getattr(fn, "__code__", None)
    if g is not None and code is not None:
        for key in code.co_names:
            v = g.get(key)
            if v is not None and id(v) in ports:
                spots.append((g, key, v))
    return spots


def trace_op(op) -> OpIR:
    """The IR of the user operator ``op`` (arity 1 or 2); raises
    :class:`UntraceableOperator` naming the function it cannot take."""
    if op.arity not in (1, 2):
        _refuse(op.name, f"{op.arity} arguments")
    t = _Tracer(op.name)
    xs = [t.add(Node("arg", (), j)) for j in range(op.arity)]
    ports = _port_functions()
    with _TRACE_LOCK:
        spots = _hooked_globals(op.fn, ports)
        cells = []
        for cell in getattr(op.fn, "__closure__", None) or ():
            try:
                v = cell.cell_contents
            except ValueError:
                continue
            if id(v) in ports:
                cells.append((cell, v))
        try:
            for g, key, v in spots:
                g[key] = _BuiltinHook(v, ports[id(v)][1])
            for cell, v in cells:
                cell.cell_contents = _BuiltinHook(v, ports[id(v)][1])
            if id(op.fn) in ports:
                out = _BuiltinHook(op.fn, ports[id(op.fn)][1])(*xs)
            else:
                try:
                    out = op.fn(*xs)
                except UntraceableOperator:
                    raise
                except Exception as e:  # noqa: BLE001 - any failure names the call
                    _refuse(op.name, f"something that failed under tracing "
                                     f"({type(e).__name__}: {e})")
        finally:
            for g, key, v in spots:
                g[key] = v
            for cell, v in cells:
                cell.cell_contents = v
    if isinstance(out, (int, float)) and not isinstance(out, bool):
        out = t.add(Node("const", (), float(out)))
    if not isinstance(out, _Sym) or out._t is not t:
        _refuse(op.name, f"a function returning {type(out).__name__}")
    if out._b:
        _refuse(op.name, "a function returning a comparison (convert it with .to(x.dtype))")
    return _prune(OpIR(op.name, op.arity, tuple(t.nodes), out._i))


def _prune(ir: OpIR) -> OpIR:
    """The IR without nodes the output does not read (arguments kept)."""
    live = set(range(ir.arity)) | {ir.out}
    for i in reversed(range(len(ir.nodes))):
        if i in live:
            live.update(a for a in ir.nodes[i].args if not isinstance(a, Num))
    order = sorted(live)
    new = {old: k for k, old in enumerate(order)}
    nodes = tuple(dataclasses.replace(ir.nodes[i], args=tuple(
        a if isinstance(a, Num) else new[a] for a in ir.nodes[i].args)) for i in order)
    return OpIR(ir.name, ir.arity, nodes, new[ir.out])


# ---------------------------------------------------------------------------
# An operator set's user operators
# ---------------------------------------------------------------------------


def is_builtin(op) -> bool:
    """Whether the kernels implement ``op`` themselves (a built-in operator
    under its own name and function)."""
    from .fused_eval import _KERNEL_OP_IDS
    from .operators import OPERATOR_REGISTRY

    builtin = OPERATOR_REGISTRY.get(op.name)
    return builtin is not None and builtin.fn is op.fn and op.name in _KERNEL_OP_IDS


_HEADER_TOP = """// Generated by symbolicregression_jl_tpu_torch/ops/user_ops.py: the user
// operators of one operator set, included by csrc/interp.cuh (SR_USER_OPS).
#pragma once
"""


@dataclasses.dataclass(frozen=True)
class UserOpSet:
    """An operator set's user operators: their kernel ids (by ``id(op)``),
    IRs and the generated CUDA header (its ``digest`` names the libraries
    built with it); ``entries`` maps each kernel id to its operator's
    generated code."""

    ids: Dict[int, int]
    irs: Tuple[OpIR, ...]
    header: str
    digest: str
    entries: Dict[int, str]

    def op_id(self, op) -> int:
        return self.ids[id(op)]

    def covers(self, other: "UserOpSet") -> bool:
        """Whether a library built for this set runs ``other``'s operators:
        each of them generated to the same code under the same id (an
        operator set with a user operator fewer, say)."""
        return all(self.entries.get(i) == code for i, code in other.entries.items())


def _header(entries: Dict[int, str], nbinary: int, nunary: int) -> str:
    parts = [_HEADER_TOP] + [entries[i] for i in sorted(entries)]
    cases = [f"BIN({USER_BINARY_BASE + k}, user_binary_{k}, user_binary_vjp_{k})"
             for k in range(nbinary)]
    cases += [f"UN({USER_UNARY_BASE + k}, user_unary_{k}, user_unary_vjp_{k})"
              for k in range(nunary)]
    parts.append("#define SR_USER_OPS_CASES(BIN, UN) " + " ".join(cases))
    return "\n\n".join(parts) + "\n"


_SETS: Dict = {}
_SETS_LOCK = threading.Lock()


def user_op_set(operators) -> Optional[UserOpSet]:
    """The user operators of ``operators`` (None when every operator is
    built in), traced once per operator set."""
    key = operators._key() if hasattr(operators, "_key") else id(operators)
    with _SETS_LOCK:
        if key in _SETS:
            return _SETS[key]
    binary = [op for op in operators.binary if not is_builtin(op)]
    unary = [op for op in operators.unary if not is_builtin(op)]
    if not binary and not unary:
        out = None
    else:
        if len(binary) > USER_UNARY_BASE - USER_BINARY_BASE or \
                len(unary) > USER_ID_END - USER_UNARY_BASE:
            raise UntraceableOperator(
                f"{len(binary)} binary and {len(unary)} unary user operators exceed the "
                f"kernels' {USER_UNARY_BASE - USER_BINARY_BASE} of each; pass turbo=False")
        birs = [trace_op(op) for op in binary]
        uirs = [trace_op(op) for op in unary]
        ids = {id(op): USER_BINARY_BASE + k for k, op in enumerate(binary)}
        ids.update({id(op): USER_UNARY_BASE + k for k, op in enumerate(unary)})
        entries = {USER_BINARY_BASE + k: ir.cuda(k) for k, ir in enumerate(birs)}
        entries.update({USER_UNARY_BASE + k: ir.cuda(k) for k, ir in enumerate(uirs)})
        header = _header(entries, len(birs), len(uirs))
        out = UserOpSet(ids, tuple(birs + uirs), header,
                        hashlib.sha256(header.encode()).hexdigest()[:16], entries)
    with _SETS_LOCK:
        _SETS[key] = out
    return out
