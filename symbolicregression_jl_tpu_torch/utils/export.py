"""Expression export: LaTeX, SymPy, and python callables.

Port of ``symbolicregression_jl_tpu/utils/export.py``: the same strings
and expressions from the same trees, host-side only. ``to_sympy`` imports
sympy when it is called (the package does not need it otherwise), and
``to_callable`` evaluates through the port's operator table (PyTorch on
the CPU, float32).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops.tree import Node

__all__ = ["to_latex", "to_sympy", "to_callable", "template_to_latex"]


_LATEX_UNARY = {
    "sin": r"\sin", "cos": r"\cos", "tan": r"\tan", "sinh": r"\sinh",
    "cosh": r"\cosh", "tanh": r"\tanh", "exp": r"\exp", "log": r"\log",
    "safe_log": r"\log", "abs": None, "sqrt": None, "safe_sqrt": None,
    "neg": None, "square": None, "cube": None, "inv": None,
}


def _varname(i: int, variable_names: Optional[Sequence[str]]) -> str:
    if variable_names is not None and i < len(variable_names):
        return variable_names[i]
    return f"x_{{{i + 1}}}"


def to_latex(
    tree: Node, variable_names: Optional[Sequence[str]] = None,
    precision: int = 4,
) -> str:
    """Render a tree as LaTeX."""

    def fmt(v: float) -> str:
        s = f"{v:.{precision}g}"
        if "e" in s:
            mant, exp = s.split("e")
            return f"{mant} \\cdot 10^{{{int(exp)}}}"
        return s

    def go(n: Node) -> str:
        if n.degree == 0:
            if n.is_parameter:
                return f"p_{{{n.parameter + 1}}}"
            if n.constant:
                return fmt(n.val)
            return _varname(n.feature, variable_names)
        name = n.op.name
        if n.degree == 2:
            a, b = (go(c) for c in n.children)
            if name == "+":
                return f"{a} + {b}"
            if name == "-":
                return f"{a} - \\left({b}\\right)" if _needs_paren(n.children[1]) else f"{a} - {b}"
            if name == "*":
                return f"{_paren(n.children[0], a)} {_paren(n.children[1], b)}"
            if name == "/":
                return f"\\frac{{{a}}}{{{b}}}"
            if name in ("^", "pow", "safe_pow"):
                return f"{_paren(n.children[0], a)}^{{{b}}}"
            return f"\\mathrm{{{name}}}\\left({a}, {b}\\right)"
        (a,) = (go(c) for c in n.children)
        if name in ("sqrt", "safe_sqrt"):
            return f"\\sqrt{{{a}}}"
        if name == "abs":
            return f"\\left|{a}\\right|"
        if name == "neg":
            return f"-{_paren(n.children[0], a)}"
        if name == "square":
            return f"{_paren(n.children[0], a)}^{{2}}"
        if name == "cube":
            return f"{_paren(n.children[0], a)}^{{3}}"
        if name == "inv":
            return f"\\frac{{1}}{{{a}}}"
        mapped = _LATEX_UNARY.get(name)
        if mapped:
            return f"{mapped}\\left({a}\\right)"
        return f"\\mathrm{{{name.replace('safe_', '')}}}\\left({a}\\right)"

    def _needs_paren(n: Node) -> bool:
        return n.degree == 2 and n.op.name in ("+", "-")

    def _paren(n: Node, s: str) -> str:
        if n.degree == 2 and n.op.name in ("+", "-"):
            return f"\\left({s}\\right)"
        return s

    return go(tree)


_SYMPY_NAMES = {
    "+": lambda sp, a, b: a + b,
    "-": lambda sp, a, b: a - b,
    "*": lambda sp, a, b: a * b,
    "/": lambda sp, a, b: a / b,
    "^": lambda sp, a, b: a**b,
    "safe_pow": lambda sp, a, b: a**b,
    "pow": lambda sp, a, b: a**b,
    "max": lambda sp, a, b: sp.Max(a, b),
    "min": lambda sp, a, b: sp.Min(a, b),
    "mod": lambda sp, a, b: sp.Mod(a, b),
    "atan2": lambda sp, a, b: sp.atan2(a, b),
    "sin": lambda sp, a: sp.sin(a),
    "cos": lambda sp, a: sp.cos(a),
    "tan": lambda sp, a: sp.tan(a),
    "sinh": lambda sp, a: sp.sinh(a),
    "cosh": lambda sp, a: sp.cosh(a),
    "tanh": lambda sp, a: sp.tanh(a),
    "asin": lambda sp, a: sp.asin(a),
    "acos": lambda sp, a: sp.acos(a),
    "atan": lambda sp, a: sp.atan(a),
    "exp": lambda sp, a: sp.exp(a),
    "log": lambda sp, a: sp.log(a),
    "safe_log": lambda sp, a: sp.log(a),
    "safe_log2": lambda sp, a: sp.log(a, 2),
    "safe_log10": lambda sp, a: sp.log(a, 10),
    "safe_log1p": lambda sp, a: sp.log(a + 1),
    "sqrt": lambda sp, a: sp.sqrt(a),
    "safe_sqrt": lambda sp, a: sp.sqrt(a),
    "safe_asin": lambda sp, a: sp.asin(a),
    "safe_acos": lambda sp, a: sp.acos(a),
    "safe_acosh": lambda sp, a: sp.acosh(a),
    "safe_atanh": lambda sp, a: sp.atanh(a),
    "abs": lambda sp, a: sp.Abs(a),
    "neg": lambda sp, a: -a,
    "square": lambda sp, a: a**2,
    "cube": lambda sp, a: a**3,
    "inv": lambda sp, a: 1 / a,
    "sign": lambda sp, a: sp.sign(a),
    "gamma": lambda sp, a: sp.gamma(a),
    "erf": lambda sp, a: sp.erf(a),
    "erfc": lambda sp, a: sp.erfc(a),
    "relu": lambda sp, a: sp.Max(a, 0),
}


def to_sympy(tree: Node, variable_names: Optional[Sequence[str]] = None):
    """Convert a tree into a SymPy expression (requires sympy installed)."""
    try:
        import sympy as sp
    except ImportError as e:  # pragma: no cover
        raise ImportError("to_sympy requires the `sympy` package") from e

    def var(i: int):
        name = (
            variable_names[i]
            if variable_names is not None and i < len(variable_names)
            else f"x{i + 1}"
        )
        return sp.Symbol(name, real=True)

    def go(n: Node):
        if n.degree == 0:
            if n.is_parameter:
                return sp.Symbol(f"p{n.parameter + 1}", real=True)
            if n.constant:
                return sp.Float(n.val)
            return var(n.feature)
        args = [go(c) for c in n.children]
        fn = _SYMPY_NAMES.get(n.op.name)
        if fn is None:
            f = sp.Function(n.op.name.replace("safe_", ""))
            return f(*args)
        return fn(sp, *args)

    return go(tree)


def to_callable(
    tree: Node, variable_names: Optional[Sequence[str]] = None
) -> Callable:
    """Build a vectorized callable ``f(X: (n, nfeatures), params=None) -> (n,)``.

    Computation runs through the operator table's PyTorch functions on the
    CPU in float32 (the framework's eval precision) and returns numpy.
    Parameter leaves read from ``params`` (a 1D vector); calling a
    parametric tree without ``params`` raises.
    """

    def f(X, params=None):
        Xt = torch.as_tensor(np.asarray(X, dtype=np.float32))

        def go(n: Node):
            if n.degree == 0:
                if n.is_parameter:
                    if params is None:
                        raise ValueError(
                            "Tree contains parameter leaves; pass `params`."
                        )
                    return torch.full((Xt.shape[0],), float(np.float32(params[n.parameter])))
                if n.constant:
                    return torch.full((Xt.shape[0],), float(np.float32(n.val)))
                return Xt[:, n.feature]
            args = [go(c) for c in n.children]
            return n.op.fn(*args).to(torch.float32)

        return go(tree).numpy()

    return f


def template_to_latex(template_expr, precision: int = 4) -> str:
    """LaTeX for a HostTemplateExpression: aligned per-component lines
    (subexpression arguments render as ``\\#i``; parameter vectors as
    row matrices)."""
    st = template_expr.structure
    lines = []
    for k, key in enumerate(st.expr_keys):
        names = [f"\\#{i + 1}" for i in range(st.num_features[k])]
        body = to_latex(template_expr.trees[key], variable_names=names,
                        precision=precision)
        lines.append(f"{key} &= {body}")
    if st.has_params and template_expr.params is not None:
        for key, off, cnt in zip(st.param_keys, st.param_offsets,
                                 st.num_params):
            vals = ", ".join(
                f"{float(v):.{precision}g}"
                for v in template_expr.params[off:off + cnt]
            )
            lines.append(f"{key} &= [{vals}]")
    sep = " \\\\\n"
    return "\\begin{aligned}\n" + sep.join(lines) + "\n\\end{aligned}"
