"""Host-side expression trees: the `Node` equivalent of DynamicExpressions.jl.

Copy of ``symbolicregression_jl_tpu/ops/tree.py`` for the PyTorch port
(host Python: parsing, printing, simplification). The device form is the
postfix tensor encoding in :mod:`.encoding`.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Sequence

import torch

from .operators import Op, OperatorSet, resolve_operator

__all__ = ["Node", "parse_expression", "string_tree"]


def _scalar64(v: float) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float64)


class Node:
    """An expression tree node.

    ``degree == 0``: leaf. Either a constant (``constant=True``, value in
    ``val``) or a variable referencing feature index ``feature`` (0-based).
    ``degree >= 1``: operator node with ``op`` an :class:`Op` and
    ``children`` a tuple of Nodes.

    A leaf may also be a *parameter* node (``is_parameter=True`` with
    ``parameter`` index) for ParametricExpression support, mirroring
    `ParametricNode` (SymbolicRegression.jl src/ParametricExpression.jl:126-135).
    """

    __slots__ = ("degree", "constant", "val", "feature", "op", "children",
                 "is_parameter", "parameter")

    def __init__(
        self,
        *,
        val: Optional[float] = None,
        feature: Optional[int] = None,
        op: Optional[Op] = None,
        children: Sequence["Node"] = (),
        is_parameter: bool = False,
        parameter: int = 0,
    ):
        if op is not None:
            self.degree = len(children)
            assert self.degree == op.arity, (op, children)
            self.op = op
            self.children = tuple(children)
            self.constant = False
            self.val = None
            self.feature = 0
            self.is_parameter = False
            self.parameter = 0
        elif is_parameter:
            self.degree = 0
            self.op = None
            self.children = ()
            self.constant = False
            self.val = None
            self.feature = 0
            self.is_parameter = True
            self.parameter = parameter
        elif feature is not None:
            self.degree = 0
            self.op = None
            self.children = ()
            self.constant = False
            self.val = None
            self.feature = feature
            self.is_parameter = False
            self.parameter = 0
        else:
            self.degree = 0
            self.op = None
            self.children = ()
            self.constant = True
            self.val = float(val) if val is not None else 0.0
            self.feature = 0
            self.is_parameter = False
            self.parameter = 0

    # -- constructors --------------------------------------------------
    @staticmethod
    def const(val: float) -> "Node":
        return Node(val=val)

    @staticmethod
    def var(feature: int) -> "Node":
        return Node(feature=feature)

    @staticmethod
    def param(parameter: int) -> "Node":
        return Node(is_parameter=True, parameter=parameter)

    # -- traversal -----------------------------------------------------
    def nodes(self):
        """Depth-first post-order iteration (children before parents)."""
        for c in self.children:
            yield from c.nodes()
        yield self

    def copy(self) -> "Node":
        if self.degree > 0:
            return Node(op=self.op, children=[c.copy() for c in self.children])
        if self.is_parameter:
            return Node.param(self.parameter)
        if self.constant:
            return Node.const(self.val)
        return Node.var(self.feature)

    def count_nodes(self) -> int:
        return 1 + sum(c.count_nodes() for c in self.children)

    def count_depth(self) -> int:
        if self.degree == 0:
            return 1
        return 1 + max(c.count_depth() for c in self.children)

    def has_constants(self) -> bool:
        return any(n.degree == 0 and n.constant for n in self.nodes())

    def has_operators(self) -> bool:
        return self.degree > 0

    # -- constants API (get/set_scalar_constants,
    #    SymbolicRegression.jl src/ConstantOptimization.jl:64-76) -------------
    def get_scalar_constants(self) -> List[float]:
        return [n.val for n in self.nodes() if n.degree == 0 and n.constant]

    def set_scalar_constants(self, values: Sequence[float]) -> None:
        it = iter(values)
        for n in self.nodes():
            if n.degree == 0 and n.constant:
                n.val = float(next(it))

    # -- evaluation (host; for tests/golden values) --------------------
    def eval_scalar(self, x: Sequence[float], params: Optional[Sequence[float]] = None) -> float:
        if self.degree == 0:
            if self.is_parameter:
                return float(params[self.parameter])
            if self.constant:
                return float(self.val)
            return float(x[self.feature])
        args = [c.eval_scalar(x, params) for c in self.children]
        out = self.op.fn(*[_scalar64(a) for a in args])
        return float(out)

    def __eq__(self, other):
        if not isinstance(other, Node):
            return NotImplemented
        if self.degree != other.degree:
            return False
        if self.degree == 0:
            if self.is_parameter != other.is_parameter or self.constant != other.constant:
                return False
            if self.is_parameter:
                return self.parameter == other.parameter
            if self.constant:
                return self.val == other.val or (
                    math.isnan(self.val) and math.isnan(other.val)
                )
            return self.feature == other.feature
        return self.op.name == other.op.name and all(
            a == b for a, b in zip(self.children, other.children)
        )

    def __hash__(self):
        if self.degree == 0:
            if self.is_parameter:
                return hash(("p", self.parameter))
            if self.constant:
                return hash(("c", self.val))
            return hash(("v", self.feature))
        return hash((self.op.name, self.children))

    def __repr__(self) -> str:
        return f"Node({string_tree(self)})"


# ---------------------------------------------------------------------------
# Printing (string_tree, SymbolicRegression.jl src/InterfaceDynamicExpressions.jl:199-317)
# ---------------------------------------------------------------------------

_PRECEDENCE = {"+": 1, "-": 1, "*": 2, "/": 2, "^": 3}


def _fmt_const(v: float, precision: int) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e12:
        return str(float(v))
    return f"{v:.{precision}g}"


def string_tree(
    tree: Node,
    variable_names: Optional[Sequence[str]] = None,
    *,
    pretty: bool = False,
    precision: int = 5,
) -> str:
    """Render a tree as an infix string (round-trippable by parse_expression)."""

    def varname(i: int) -> str:
        if variable_names is not None and i < len(variable_names):
            return variable_names[i]
        return f"x{i + 1}"

    def go(n: Node, parent_prec: int, side: str) -> str:
        if n.degree == 0:
            if n.is_parameter:
                return f"p{n.parameter + 1}"
            if n.constant:
                return _fmt_const(n.val, precision)
            return varname(n.feature)
        name = n.op.display if pretty else n.op.name
        if n.op.infix and n.degree == 2:
            prec = _PRECEDENCE.get(n.op.name, 1)
            if n.op.name == "^":  # right-associative
                left = go(n.children[0], prec + 1, "l")
                right = go(n.children[1], prec, "r")
            else:  # left-associative
                left = go(n.children[0], prec, "l")
                right = go(n.children[1], prec + 1, "r")
            s = f"{left} {name} {right}"
            if prec < parent_prec:
                return f"({s})"
            return s
        args = ", ".join(go(c, 0, "f") for c in n.children)
        return f"{name}({args})"

    return go(tree, 0, "f")


# ---------------------------------------------------------------------------
# Parsing (parse_expression analogue)
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<sym>\*\*|>=|<=|[-+*/^(),<>#]))"
)


def _tokenize(s: str):
    pos, out = 0, []
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if m is None:
            if s[pos:].strip() == "":
                break
            raise ValueError(f"Cannot tokenize {s[pos:]!r}")
        pos = m.end()
        if m.group("num") is not None:
            out.append(("num", float(m.group("num"))))
        elif m.group("name") is not None:
            out.append(("name", m.group("name")))
        else:
            sym = m.group("sym")
            out.append(("sym", "^" if sym == "**" else sym))
    out.append(("end", None))
    return out


class _Parser:
    """Pratt parser for infix expressions over an OperatorSet."""

    def __init__(self, tokens, operators: OperatorSet, variable_names):
        self.toks = tokens
        self.i = 0
        self.operators = operators
        self.variable_names = list(variable_names) if variable_names else None

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, sym):
        t = self.next()
        if t != ("sym", sym):
            raise ValueError(f"Expected {sym!r}, got {t!r}")

    def _binop(self, name: str) -> Op:
        for op in self.operators.binary:
            if op.name == name or op.display == name:
                return op
        # Fall back to registry so parsing works even if the op isn't in the
        # search's set (e.g. printing round-trips of guesses).
        return resolve_operator(name, 2)

    def parse(self, min_prec: int = 0) -> Node:
        node = self.parse_unary()
        while True:
            kind, value = self.peek()
            if kind != "sym" or value not in _PRECEDENCE and value not in (">", "<", ">=", "<="):
                break
            prec = _PRECEDENCE.get(value, 0)
            if prec < min_prec:
                break
            self.next()
            if value == "^":  # right-assoc
                rhs = self.parse(prec)
            else:
                rhs = self.parse(prec + 1)
            node = Node(op=self._binop(value), children=[node, rhs])
        return node

    def parse_unary(self) -> Node:
        kind, value = self.next()
        if kind == "num":
            return Node.const(value)
        if kind == "sym" and value == "-":
            child = self.parse_unary()
            if child.degree == 0 and child.constant:
                return Node.const(-child.val)
            for op in self.operators.unary:
                if op.name == "neg":
                    return Node(op=op, children=[child])
            neg_op = resolve_operator("neg", 1)
            return Node(op=neg_op, children=[child])
        if kind == "sym" and value == "+":
            return self.parse_unary()
        if kind == "sym" and value == "(":
            node = self.parse()
            self.expect(")")
            return node
        if kind == "sym" and value == "#":
            # TemplateExpression placeholder syntax `#N`
            # (SymbolicRegression.jl src/TemplateExpression.jl:1014+)
            k, v = self.next()
            if k != "num":
                raise ValueError("Expected number after '#'")
            return Node.var(int(v) - 1)
        if kind == "name":
            nxt = self.peek()
            if nxt == ("sym", "("):
                self.next()
                args = [self.parse()]
                while self.peek() == ("sym", ","):
                    self.next()
                    args.append(self.parse())
                self.expect(")")
                # Find op with matching name & arity:
                for d, ops in self.operators.ops.items():
                    for op in ops:
                        if (op.name == value or op.display == value) and op.arity == len(args):
                            return Node(op=op, children=args)
                op = resolve_operator(value, len(args))
                return Node(op=op, children=args)
            return self._leaf_name(value)
        raise ValueError(f"Unexpected token {(kind, value)!r}")

    def _leaf_name(self, name: str) -> Node:
        if self.variable_names is not None and name in self.variable_names:
            return Node.var(self.variable_names.index(name))
        m = re.fullmatch(r"x(\d+)", name)
        if m:
            return Node.var(int(m.group(1)) - 1)
        m = re.fullmatch(r"p(\d+)", name)
        if m:
            return Node.param(int(m.group(1)) - 1)
        if name in ("pi", "π"):
            return Node.const(math.pi)
        if name == "e":
            return Node.const(math.e)
        if name in ("NaN", "nan"):
            return Node.const(float("nan"))
        if name in ("Inf", "inf"):
            return Node.const(float("inf"))
        raise ValueError(f"Unknown variable {name!r}")


def parse_expression(
    s: str,
    operators: Optional[OperatorSet] = None,
    variable_names: Optional[Sequence[str]] = None,
) -> Node:
    """Parse an infix expression string into a :class:`Node` tree."""
    operators = operators or OperatorSet()
    p = _Parser(_tokenize(s), operators, variable_names)
    node = p.parse()
    if p.peek()[0] != "end":
        raise ValueError(f"Trailing tokens in expression: {s!r}")
    return node


# ---------------------------------------------------------------------------
# Simplification (simplify_tree! + combine_operators analogues)
# ---------------------------------------------------------------------------


def simplify_tree(tree: Node, operators: Optional[OperatorSet] = None) -> Node:
    """Constant folding: collapse any all-constant subtree to a constant."""
    if tree.degree == 0:
        return tree
    children = [simplify_tree(c, operators) for c in tree.children]
    if all(c.degree == 0 and c.constant for c in children):
        val = tree.op.fn(*[_scalar64(c.val) for c in children])
        return Node.const(float(val))
    return Node(op=tree.op, children=children)


def combine_operators(tree: Node, operators: Optional[OperatorSet] = None) -> Node:
    """Merge nested +/* with constant operands, and fold `-`/`/` chains.

    Port of the *behavior* of DynamicExpressions' `combine_operators`:
    e.g. `(x + 1.5) + 2.5 -> x + 4.0`, `(x * 2) * 3 -> x * 6`,
    `(x - 1) - 2 -> x - 3`.
    """
    if tree.degree == 0:
        return tree
    children = [combine_operators(c, operators) for c in tree.children]
    tree = Node(op=tree.op, children=children)
    name = tree.op.name

    def is_const(n):
        return n.degree == 0 and n.constant

    if name in ("+", "*") and tree.degree == 2:
        a, b = tree.children
        # normalize constant to the right
        if is_const(a) and not is_const(b):
            a, b = b, a
        if is_const(b) and a.degree == 2 and a.op.name == name:
            inner_a, inner_b = a.children
            if is_const(inner_b):
                combined = inner_b.val + b.val if name == "+" else inner_b.val * b.val
                return Node(op=tree.op, children=[inner_a, Node.const(combined)])
            if is_const(inner_a):
                combined = inner_a.val + b.val if name == "+" else inner_a.val * b.val
                return Node(op=tree.op, children=[inner_b, Node.const(combined)])
        return Node(op=tree.op, children=[a, b])
    if name == "-" and tree.degree == 2:
        a, b = tree.children
        if is_const(b) and a.degree == 2 and a.op.name == "-" and is_const(a.children[1]):
            return Node(op=tree.op,
                        children=[a.children[0], Node.const(a.children[1].val + b.val)])
        if is_const(b) and a.degree == 2 and a.op.name == "+" and is_const(a.children[1]):
            return Node(op=a.op, children=[a.children[0], Node.const(a.children[1].val - b.val)])
    return tree
