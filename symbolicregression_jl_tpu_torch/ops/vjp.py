"""Reverse-mode derivatives of the built-in operators and losses.

The JAX package differentiates each operator with ``jax.vjp`` inside its
gradient kernel (``ops/fused_eval.py`` ``_bwd_dispatch``). This module
writes the same functions out by hand, one per operator, each following
the JVP rule JAX applies to the operator's own definition
(``ops/operators.py``) rather than a calculus table, so that the
non-finite values land where they land in the JAX package:

- ``ct / y`` at ``y = 0`` and ``ct * inf`` with ``ct = 0`` give NaN, as they
  do there (weight-0 rows carry a zero cotangent and are not masked);
- the ``where``-guarded safe operators send the cotangent only into the
  taken branch, so the untaken branch's infinite derivative is never
  multiplied in;
- ``abs'(0) = 1`` (JAX: ``select(x >= 0, g, -g)``), the ``clip`` inside
  ``asin``/``acos``/``atanh`` halves the derivative at +-1 (ties of
  ``max``/``min`` split the cotangent), and the pieces of ``^`` are
  computed on both branches and summed.

The CUDA gradient kernel (``csrc/interp.cuh``) holds the same table; this
one is its plain PyTorch version. Operators and losses outside the table
raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..core.losses import LOSS_REGISTRY, l1_dist_loss, l2_dist_loss
from .operators import _sign, py_mod

__all__ = ["vjp_binary", "vjp_unary", "loss_vjp", "BINARY_VJP", "UNARY_VJP"]

_LN2 = float(np.float32(math.log(2.0)))
_INV_LN10 = float(np.float32(0.4342944819032518))
_THIRD = float(np.float32(1.0 / 3.0))
_TWO_OVER_SQRT_PI = float(np.float32(2.0 / math.sqrt(math.pi)))


def _zero(x):
    return torch.zeros_like(x)


def _rsqrt(v):
    return 1.0 / torch.sqrt(v)


def _sq(v):
    return v * v


def _recip2(v):
    """integer_pow(v, -2) as JAX evaluates it: 1 / (v * v)."""
    return 1.0 / (v * v)


def _balanced(x, ans, other):
    """JAX's ``_balanced_eq``: 1 where x is the max/min, halved on a tie."""
    return (torch.where(x == ans, 1.0, 0.0).to(x.dtype)
            / torch.where(other == ans, 2.0, 1.0).to(x.dtype))


def _clip_vjp(x, ct_c):
    """Cotangent through ``clip(x, -1, 1) = min(1, max(-1, x))``."""
    m = torch.maximum(torch.full_like(x, -1.0), x)
    c = torch.minimum(torch.full_like(x, 1.0), m)
    ct_m = ct_c * _balanced(m, c, torch.full_like(x, 1.0))
    return ct_m * _balanced(x, m, torch.full_like(x, -1.0)), c


# ---------------------------------------------------------------------------
# Binary operators: (a, b, ct) -> (da, db)
# ---------------------------------------------------------------------------


def _d_add(a, b, ct):
    return ct, ct


def _d_sub(a, b, ct):
    return ct, -ct


def _d_mul(a, b, ct):
    return ct * b, a * ct


def _d_div(a, b, ct):
    return ct / b, -((ct * _recip2(b)) * a)


def _d_pow(a, b, ct):
    is_int = b == torch.round(b)
    is_odd = torch.abs(py_mod(b, torch.full_like(b, 2.0))) == 1.0
    ax = torch.abs(a)
    mag = ax ** b
    ct_int = torch.where(is_int, ct, 0.0)
    ct_non = torch.where(is_int, 0.0, ct)
    ct_s = torch.where((b < 0) & (a == 0), 0.0, ct_int)
    ct_m1 = torch.where(is_odd & (a < 0), -ct_s, ct_s)
    bad = ((b > 0) & (a < 0)) | ((b < 0) & (a <= 0))
    ct_m2 = torch.where(bad, 0.0, ct_non)
    jac_x = b * ax ** (b - 1.0)
    jac_y = torch.log(torch.where(ax == 0, 1.0, ax)) * mag
    d_ax = ct_m1 * jac_x + ct_m2 * jac_x
    return torch.where(a >= 0, d_ax, -d_ax), ct_m1 * jac_y + ct_m2 * jac_y


def _d_mod(a, b, ct):
    tm = torch.fmod(a.double(), b.double()).to(a.dtype)
    do_plus = ((tm < 0) != (b < 0)) & (tm != 0)
    q = a / b
    jac = _sign(q) * torch.floor(torch.abs(q))
    return ct, -(ct * jac) + torch.where(do_plus, ct, 0.0)


def _d_max(a, b, ct):
    ans = torch.maximum(a, b)
    return ct * _balanced(a, ans, b), ct * _balanced(b, ans, a)


def _d_min(a, b, ct):
    ans = torch.minimum(a, b)
    return ct * _balanced(a, ans, b), ct * _balanced(b, ans, a)


def _d_atan2(a, b, ct):
    den = a * a + b * b
    return ct * (b / den), ct * (-a / den)


def _d_none(a, b, ct):
    return _zero(a), _zero(b)


def _d_cond(a, b, ct):
    return _zero(a), torch.where(a > 0, ct, 0.0)


BINARY_VJP: Dict[str, Callable] = {
    "+": _d_add, "-": _d_sub, "*": _d_mul, "/": _d_div, "^": _d_pow, "mod": _d_mod,
    "max": _d_max, "min": _d_min, "atan2": _d_atan2, "greater": _d_none,
    "less": _d_none, "greater_equal": _d_none, "less_equal": _d_none, "cond": _d_cond,
    "logical_or": _d_none, "logical_and": _d_none,
}


# ---------------------------------------------------------------------------
# Unary operators: (x, ct) -> dx
# ---------------------------------------------------------------------------


def _f64(fn):
    """A float32 function value taken in float64 and rounded, as the
    forward operators of ops/operators.py take it."""
    return lambda x: fn(x.double()).to(x.dtype)


def _d_asin_like(sign: float):
    def d(x, ct):
        ok = (x >= -1) & (x <= 1)
        ct_in = torch.where(ok, ct, 0.0)
        c = torch.minimum(torch.full_like(x, 1.0), torch.maximum(torch.full_like(x, -1.0), x))
        r = _rsqrt(1.0 - c * c)
        dx, _ = _clip_vjp(x, ct_in * (r if sign > 0 else -r))
        return dx
    return d


def _d_atanh(x, ct):
    ok = (x >= -1) & (x <= 1)
    ct_in = torch.where(ok, ct, 0.0)
    c = torch.minimum(torch.full_like(x, 1.0), torch.maximum(torch.full_like(x, -1.0), x))
    dx, _ = _clip_vjp(x, ((1.0 / (1.0 + c)) * ct_in) / (1.0 - c))
    return dx


def _d_atanh_clip(x, ct):
    u = py_mod(x + 1.0, torch.full_like(x, 2.0)) - 1.0
    return ((1.0 / (1.0 + u)) * ct) / (1.0 - u)


def _d_gamma(x, ct):
    x64 = x.double()
    sign = torch.where(x64 > 0, torch.ones_like(x64), _sign(torch.sin(math.pi * x64)))
    e64 = torch.exp(torch.lgamma(x64))
    out = (sign * e64).to(x.dtype)
    ct_o = torch.where(torch.isinf(out), 0.0, ct)
    ct_lg = (sign.to(x.dtype) * ct_o) * e64.to(x.dtype)
    return ct_lg * torch.digamma(x)


def _d_cube(x, ct):
    p = x * x
    ct_p = ct * x
    return p * ct + (ct_p * x + x * ct_p)


def _d_tanh(x, ct):
    ans = torch.tanh(x)
    t = ct * (1.0 - ans)
    return t + t * ans


UNARY_VJP: Dict[str, Callable] = {
    "exp": lambda x, ct: ct * torch.exp(x),
    "abs": lambda x, ct: torch.where(x >= 0, ct, -ct),
    "log": lambda x, ct: torch.where(x > 0, ct / torch.where(x > 0, x, 1.0), 0.0),
    "log2": lambda x, ct: torch.where(x > 0, (ct / _LN2) / torch.where(x > 0, x, 1.0), 0.0),
    "log10": lambda x, ct: torch.where(x > 0, (ct * _INV_LN10) / torch.where(x > 0, x, 1.0),
                                       0.0),
    "log1p": lambda x, ct: torch.where(x > -1, ct / (torch.where(x > -1, x, 0.0) + 1.0), 0.0),
    "sqrt": lambda x, ct: torch.where(
        x >= 0, ct * (0.5 / torch.sqrt(torch.where(x >= 0, x, 0.0))), 0.0),
    "cbrt": lambda x, ct: ct * (_THIRD * _recip2(
        (torch.sign(x.double()) * torch.abs(x.double()).pow(1.0 / 3.0)).to(x.dtype))),
    "sin": lambda x, ct: ct * torch.cos(x),
    "cos": lambda x, ct: (-ct) * torch.sin(x),
    "tan": lambda x, ct: ct * (1.0 + torch.tan(x) * torch.tan(x)),
    "sinh": lambda x, ct: ct * _f64(torch.cosh)(x),
    "cosh": lambda x, ct: ct * _f64(torch.sinh)(x),
    "tanh": _d_tanh,
    "asin": _d_asin_like(1.0),
    "acos": _d_asin_like(-1.0),
    "atan": lambda x, ct: ct / (1.0 + x * x),
    "asinh": lambda x, ct: ct * _rsqrt(x * x + 1.0),
    "acosh": lambda x, ct: torch.where(
        x >= 1, ct * _rsqrt(_sq(torch.where(x >= 1, x, 1.0)) - 1.0), 0.0),
    "atanh": _d_atanh,
    "atanh_clip": _d_atanh_clip,
    "erf": lambda x, ct: _TWO_OVER_SQRT_PI * (ct * torch.exp(-(x * x))),
    "erfc": lambda x, ct: -_TWO_OVER_SQRT_PI * (ct * torch.exp(-(x * x))),
    "gamma": _d_gamma,
    "square": lambda x, ct: ct * x + x * ct,
    "cube": _d_cube,
    "neg": lambda x, ct: -ct,
    "inv": lambda x, ct: -((ct * _recip2(x)) * 1.0),
    "relu": lambda x, ct: torch.where(x > 0, ct, 0.0),
    "round": lambda x, ct: _zero(x),
    "floor": lambda x, ct: _zero(x),
    "ceil": lambda x, ct: _zero(x),
    "sign": lambda x, ct: _zero(x),
}


def _builtin(op, table):
    from .operators import OPERATOR_REGISTRY

    builtin = OPERATOR_REGISTRY.get(op.name)
    if builtin is None or builtin.fn is not op.fn or op.name not in table:
        raise NotImplementedError(
            f"operator {op.name!r} is not a built-in operator; the constant "
            f"optimizer's gradient covers built-in operators only")
    return table[op.name]


def vjp_binary(op) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    return _builtin(op, BINARY_VJP)


def vjp_unary(op) -> Callable[..., torch.Tensor]:
    return _builtin(op, UNARY_VJP)


# ---------------------------------------------------------------------------
# Elementwise losses: (pred, target, ct) -> d pred
# ---------------------------------------------------------------------------


def _l2_vjp(p, y, ct):
    d = p - y
    return ct * d + d * ct


def _l1_vjp(p, y, ct):
    return torch.where(p - y >= 0, ct, -ct)


def _huber_vjp(p, y, ct):
    d = p - y
    a = torch.abs(d)
    near = a <= 1.0
    ct1 = torch.where(near, ct, 0.0)
    ct2 = torch.where(near, 0.0, ct)
    ct_a = (0.5 * a) * ct1 + 0.5 * (ct1 * a) + ct2
    return torch.where(d >= 0, ct_a, -ct_a)


def loss_vjp(loss_fn: Callable) -> Callable:
    """d elementwise_loss / d pred for the losses the kernels implement."""
    if loss_fn is l2_dist_loss:
        return _l2_vjp
    if loss_fn is l1_dist_loss:
        return _l1_vjp
    if loss_fn is LOSS_REGISTRY["HuberLoss"] or loss_fn is LOSS_REGISTRY["huber"]:
        return _huber_vjp
    raise NotImplementedError(
        "the constant optimizer's gradient implements the L2, L1 and Huber "
        "elementwise losses only")
