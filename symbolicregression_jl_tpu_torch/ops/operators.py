"""Operator registry with domain-safe semantics (torch).

Port of ``symbolicregression_jl_tpu/ops/operators.py``. Every operator is
an elementwise torch function returning NaN outside its domain, so an
invalid expression is found by a validity reduction over the rows. The
NaN domains match the JAX package operator for operator; the CUDA
interpreter kernel (``csrc/program_eval.cu``) implements the same table
under the same names.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence, Union

import torch

__all__ = [
    "Op",
    "OperatorSet",
    "resolve_operator",
    "DEFAULT_BINARY",
    "DEFAULT_UNARY",
    "OPERATOR_REGISTRY",
]


def _nan(x):
    return torch.full_like(x, float("nan"))


def py_mod(x, y):
    """Remainder with the divisor's sign (``jnp.mod``): the truncated
    remainder, moved by ``y`` where its sign differs. Unlike
    ``torch.remainder`` it stays finite when ``x / y`` overflows. The
    truncated remainder is exact, so taking it in float64 changes no
    result; PyTorch's vectorised float32 ``fmod`` returns NaN there."""
    m = torch.fmod(x.double(), y.double()).to(x.dtype)
    return torch.where((m != 0) & ((m < 0) != (y < 0)), m + y, m)


def safe_pow(x, y):
    """``x^y`` with NaN where the real power is undefined: integer
    exponents allow negative bases (0^negative is NaN); non-integer
    exponents need a positive base (or a zero base with a positive
    exponent)."""
    is_int = y == torch.round(y)
    is_odd = torch.abs(py_mod(y, torch.full_like(y, 2.0))) == 1.0
    mag = torch.abs(x) ** y
    signed = torch.where(is_odd & (x < 0), -mag, mag)
    int_res = torch.where((y < 0) & (x == 0), _nan(mag), signed)
    bad = ((y > 0) & (x < 0)) | ((y < 0) & (x <= 0))
    nonint_res = torch.where(bad, _nan(mag), torch.abs(x) ** y)
    return torch.where(is_int, int_res, nonint_res)


def erf(x):
    return torch.erf(x)


def erfc(x):
    return torch.erfc(x)


def safe_log(x):
    return torch.where(x > 0, torch.log(torch.where(x > 0, x, 1.0)), _nan(x))


def safe_log2(x):
    return torch.where(x > 0, torch.log2(torch.where(x > 0, x, 1.0)), _nan(x))


def safe_log10(x):
    return torch.where(x > 0, torch.log10(torch.where(x > 0, x, 1.0)), _nan(x))


def safe_log1p(x):
    return torch.where(x > -1, torch.log1p(torch.where(x > -1, x, 0.0)), _nan(x))


def safe_sqrt(x):
    return torch.where(x >= 0, torch.sqrt(torch.where(x >= 0, x, 0.0)), _nan(x))


def safe_asin(x):
    ok = (x >= -1) & (x <= 1)
    return torch.where(ok, torch.asin(torch.clamp(x, -1, 1)), _nan(x))


def safe_acos(x):
    ok = (x >= -1) & (x <= 1)
    return torch.where(ok, torch.acos(torch.clamp(x, -1, 1)), _nan(x))


def safe_acosh(x):
    return torch.where(x >= 1, torch.acosh(torch.where(x >= 1, x, 1.0)), _nan(x))


def safe_atanh(x):
    ok = (x >= -1) & (x <= 1)
    return torch.where(ok, torch.atanh(torch.clamp(x, -1, 1)), _nan(x))


def atanh_clip(x):
    """atanh((x + 1) % 2 - 1), always defined."""
    return torch.atanh(py_mod(x + 1.0, torch.full_like(x, 2.0)) - 1.0)


def gamma(x):
    """Gamma function via exp(lgamma) with the reflection sign for
    negative inputs, in float64 and rounded; inf maps to NaN."""
    x64 = x.double()
    sign = torch.where(x64 > 0, torch.ones_like(x64), _sign(torch.sin(math.pi * x64)))
    out = (sign * torch.exp(torch.lgamma(x64))).to(x.dtype)
    return torch.where(torch.isinf(out), _nan(out), out)


def cbrt(x):
    # torch has no cbrt; the real cube root in float64 rounds to the
    # nearest float32.
    x64 = x.double()
    return (torch.sign(x64) * torch.abs(x64).pow(1.0 / 3.0)).to(x.dtype)


# In float64 and rounded: PyTorch's float32 sinh/cosh overflow before
# their float32 results do (cosh(89) is finite), and its float32 asinh
# is off by 2 ULP where the JAX package's is not.
def sinh(x):
    return torch.sinh(x.double()).to(x.dtype)


def cosh(x):
    return torch.cosh(x.double()).to(x.dtype)


def asinh(x):
    return torch.asinh(x.double()).to(x.dtype)


def _sign(x):
    return torch.where(torch.isnan(x), x, torch.sign(x))


def square(x):
    return x * x


def cube(x):
    return x * x * x


def neg(x):
    return -x


def inv(x):
    return 1.0 / x


def relu(x):
    return torch.where(x > 0, x, 0.0)


def greater(x, y):
    return (x > y).to(x.dtype)


def less(x, y):
    return (x < y).to(x.dtype)


def greater_equal(x, y):
    return (x >= y).to(x.dtype)


def less_equal(x, y):
    return (x <= y).to(x.dtype)


def cond(x, y):
    """(x > 0) * y."""
    return torch.where(x > 0, y, 0.0)


def logical_or(x, y):
    return ((x > 0) | (y > 0)).to(x.dtype)


def logical_and(x, y):
    return ((x > 0) & (y > 0)).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Op:
    """One operator: an elementwise torch function plus metadata.

    ``name`` is the canonical (file-save) name; ``pretty_name`` is used
    for terminal printing."""

    name: str
    arity: int
    fn: Callable
    infix: bool = False
    pretty_name: Union[str, None] = None
    commutative: bool = False

    @property
    def display(self) -> str:
        return self.pretty_name if self.pretty_name is not None else self.name

    def __call__(self, *args):
        return self.fn(*args)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Op({self.name}/{self.arity})"


def _binary(name, fn, **kw):
    return Op(name=name, arity=2, fn=fn, **kw)


def _unary(name, fn, **kw):
    return Op(name=name, arity=1, fn=fn, **kw)


_BUILTIN_OPS = [
    # Binary
    _binary("+", lambda x, y: x + y, infix=True, commutative=True),
    _binary("-", lambda x, y: x - y, infix=True),
    _binary("*", lambda x, y: x * y, infix=True, commutative=True),
    _binary("/", lambda x, y: x / y, infix=True),
    _binary("^", safe_pow, infix=True),
    _binary("mod", py_mod),
    _binary("max", torch.maximum, commutative=True),
    _binary("min", torch.minimum, commutative=True),
    _binary("atan2", torch.atan2),
    _binary("greater", greater, pretty_name=">"),
    _binary("less", less, pretty_name="<"),
    _binary("greater_equal", greater_equal, pretty_name=">="),
    _binary("less_equal", less_equal, pretty_name="<="),
    _binary("cond", cond),
    _binary("logical_or", logical_or),
    _binary("logical_and", logical_and),
    # Unary
    _unary("exp", torch.exp),
    _unary("abs", torch.abs),
    _unary("log", safe_log),
    _unary("log2", safe_log2),
    _unary("log10", safe_log10),
    _unary("log1p", safe_log1p),
    _unary("sqrt", safe_sqrt),
    _unary("cbrt", cbrt),
    _unary("sin", torch.sin),
    _unary("cos", torch.cos),
    _unary("tan", torch.tan),
    _unary("sinh", sinh),
    _unary("cosh", cosh),
    _unary("tanh", torch.tanh),
    _unary("asin", safe_asin),
    _unary("acos", safe_acos),
    _unary("atan", torch.atan),
    _unary("asinh", asinh),
    _unary("acosh", safe_acosh),
    _unary("atanh", safe_atanh),
    _unary("atanh_clip", atanh_clip),
    _unary("erf", erf),
    _unary("erfc", erfc),
    _unary("gamma", gamma),
    _unary("square", square),
    _unary("cube", cube),
    _unary("neg", neg),
    _unary("inv", inv),
    _unary("relu", relu),
    _unary("round", torch.round),
    _unary("floor", torch.floor),
    _unary("ceil", torch.ceil),
    _unary("sign", _sign),
]

OPERATOR_REGISTRY = {op.name: op for op in _BUILTIN_OPS}

# Aliases mapping "unsafe"/Julia-style names to the safe versions.
_ALIASES = {
    "plus": "+",
    "sub": "-",
    "mult": "*",
    "div": "/",
    "pow": "^",
    "safe_pow": "^",
    "pow_abs": "^",
    "safe_log": "log",
    "safe_log2": "log2",
    "safe_log10": "log10",
    "safe_log1p": "log1p",
    "safe_sqrt": "sqrt",
    "safe_asin": "asin",
    "safe_acos": "acos",
    "safe_acosh": "acosh",
    "safe_atanh": "atanh",
    ">": "greater",
    "<": "less",
    ">=": "greater_equal",
    "<=": "less_equal",
    "maximum": "max",
    "minimum": "min",
}


def resolve_operator(spec, arity: Union[int, None] = None) -> Op:
    """Resolve a user operator spec (name string, Op, or callable) to an Op.

    Plain callables must be elementwise torch functions; they are wrapped
    with the callable's ``__name__``."""
    if isinstance(spec, Op):
        return spec
    if isinstance(spec, str):
        name = _ALIASES.get(spec, spec)
        if name not in OPERATOR_REGISTRY:
            raise ValueError(
                f"Unknown operator {spec!r}. Register it by passing an "
                f"`Op(name=..., arity=..., fn=...)` instead."
            )
        op = OPERATOR_REGISTRY[name]
        if arity is not None and op.arity != arity:
            raise ValueError(f"Operator {spec!r} has arity {op.arity}, expected {arity}.")
        return op
    if callable(spec):
        if arity is None:
            raise ValueError(
                "When passing a bare callable as an operator you must place it "
                "in the correct arity list."
            )
        name = getattr(spec, "__name__", None) or f"custom_{arity}ary"
        return Op(name=name, arity=arity, fn=spec)
    raise TypeError(f"Cannot interpret operator spec: {spec!r}")


DEFAULT_BINARY = ("+", "-", "/", "*")
DEFAULT_UNARY = ()


class OperatorSet:
    """Operators grouped by arity (the `OperatorEnum` equivalent).

    ``ops[d]`` is the tuple of operators of arity ``d``; ``nops`` gives
    the per-arity counts used by mutation sampling."""

    def __init__(
        self,
        binary_operators: Sequence = DEFAULT_BINARY,
        unary_operators: Sequence = DEFAULT_UNARY,
        *,
        ops_by_arity: Union[dict, None] = None,
    ):
        if ops_by_arity is None:
            ops_by_arity = {
                1: tuple(resolve_operator(o, 1) for o in unary_operators),
                2: tuple(resolve_operator(o, 2) for o in binary_operators),
            }
        self._ops = {d: tuple(ops) for d, ops in sorted(ops_by_arity.items())}
        self.max_arity = max([d for d, ops in self._ops.items() if ops], default=2)
        for d, ops in self._ops.items():
            for op in ops:
                if op.arity != d:
                    raise ValueError(f"{op} placed in arity-{d} slot")

    @property
    def ops(self):
        return self._ops

    def __getitem__(self, arity: int):
        return self._ops.get(arity, ())

    @property
    def unary(self):
        return self._ops.get(1, ())

    @property
    def binary(self):
        return self._ops.get(2, ())

    @property
    def nops(self):
        return {d: len(ops) for d, ops in self._ops.items()}

    def nops_tuple(self, max_arity: Union[int, None] = None):
        ma = max_arity or self.max_arity
        return tuple(len(self._ops.get(d, ())) for d in range(1, ma + 1))

    def index_of(self, spec, arity: Union[int, None] = None):
        """Return (arity, index) of an operator within this set."""
        if isinstance(spec, (Op, str)):
            target = resolve_operator(spec, arity)
            target_name = target.name
        elif callable(spec):
            target = spec
            target_name = getattr(spec, "__name__", None)
        else:
            raise TypeError(f"Cannot look up operator {spec!r}")
        for d, ops in self._ops.items():
            for i, op in enumerate(ops):
                if op is target or op.fn is target or op.name == target_name:
                    return d, i
        raise KeyError(f"Operator {spec!r} not in OperatorSet")

    def _key(self):
        return tuple(
            (d, tuple((o.name, id(o.fn)) for o in ops)) for d, ops in self._ops.items()
        )

    def __eq__(self, other):
        if not isinstance(other, OperatorSet):
            return NotImplemented
        return self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self) -> str:  # pragma: no cover
        parts = []
        for d, ops in self._ops.items():
            parts.append(f"{d}: [" + ", ".join(o.name for o in ops) + "]")
        return "OperatorSet(" + "; ".join(parts) + ")"
