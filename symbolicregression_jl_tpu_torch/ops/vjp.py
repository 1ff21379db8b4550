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
one is its plain PyTorch version. A user operator's derivative is
``torch.autograd`` through its own function, the plain version of the
adjoint ops/user_ops.py generates for the kernels. Losses outside the
table raise ``NotImplementedError``. Each function keeps its input's dtype
(float32 or float64); constants are taken at that dtype's rounding.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..core.losses import (LOSS_HUBER, LOSS_L1, LOSS_L2, LOSS_LOGCOSH, LOSS_LOGIT_DIST,
                           LOSS_PERIODIC_L2, LOSS_SIGMOID_CE, _logaddexp, kernel_loss)
from .operators import _sign, py_mod

__all__ = ["vjp_binary", "vjp_unary", "loss_vjp", "BINARY_VJP", "UNARY_VJP"]



def _at(x, value: float) -> float:
    """``value`` at the rounding of x's dtype: float32-rounded for float32
    (as the JAX package's float32 derivatives take their constants), exact
    for float64."""
    return value if x.dtype == torch.float64 else float(np.float32(value))


_LN2 = math.log(2.0)
_INV_LN10 = 0.4342944819032518
_THIRD = 1.0 / 3.0
_TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)


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
    "log2": lambda x, ct: torch.where(
        x > 0, (ct / _at(x, _LN2)) / torch.where(x > 0, x, 1.0), 0.0),
    "log10": lambda x, ct: torch.where(
        x > 0, (ct * _at(x, _INV_LN10)) / torch.where(x > 0, x, 1.0), 0.0),
    "log1p": lambda x, ct: torch.where(x > -1, ct / (torch.where(x > -1, x, 0.0) + 1.0), 0.0),
    "sqrt": lambda x, ct: torch.where(
        x >= 0, ct * (0.5 / torch.sqrt(torch.where(x >= 0, x, 0.0))), 0.0),
    "cbrt": lambda x, ct: ct * (_at(x, _THIRD) * _recip2(
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
    "erf": lambda x, ct: _at(x, _TWO_OVER_SQRT_PI) * (ct * torch.exp(-(x * x))),
    "erfc": lambda x, ct: -_at(x, _TWO_OVER_SQRT_PI) * (ct * torch.exp(-(x * x))),
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
    from .user_ops import is_builtin

    return table[op.name] if is_builtin(op) and op.name in table else None


def _autograd_vjp(op):
    """A user operator's derivative: ``torch.autograd`` through ``op.fn``
    (the plain version of the kernels' generated adjoint, ops/user_ops.py),
    zeros for an argument the operator does not read."""

    def vjp(*args):
        *xs, ct = args
        with torch.enable_grad():
            req = [x.detach().requires_grad_(True) for x in xs]
            out = op.fn(*req)
            gs = torch.autograd.grad(out, req, ct, allow_unused=True)
        return tuple(torch.zeros_like(ct) if g is None else g for g in gs)

    return vjp


def vjp_binary(op) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    fn = _builtin(op, BINARY_VJP)
    return fn if fn is not None else _autograd_vjp(op)


def vjp_unary(op) -> Callable[..., torch.Tensor]:
    fn = _builtin(op, UNARY_VJP)
    if fn is not None:
        return fn
    vjp = _autograd_vjp(op)
    return lambda x, ct: vjp(x, ct)[0]


# ---------------------------------------------------------------------------
# Elementwise losses: (pred, target, ct) -> d pred
# ---------------------------------------------------------------------------


def _replace_inf(x):
    """JAX's ``_replace_inf`` (logaddexp's JVP): +inf becomes 0."""
    return torch.where(x == torch.inf, 0.0, x)


def _logaddexp_jac(a, b):
    """The factors of logaddexp's custom JVP, exp(ri(a) - ri(out)) and
    exp(ri(b) - ri(out))."""
    out = _replace_inf(_logaddexp(a, b))
    return torch.exp(_replace_inf(a) - out), torch.exp(_replace_inf(b) - out)


def _l2_vjp(p, y, ct, param):
    d = p - y
    return ct * d + d * ct


def _l1_vjp(p, y, ct, param):
    return torch.where(p - y >= 0, ct, -ct)


def _huber_vjp(p, y, ct, delta):
    d = p - y
    a = torch.abs(d)
    near = a <= delta
    ct1 = torch.where(near, ct, 0.0)
    ct2 = torch.where(near, 0.0, ct)
    ct_a = (0.5 * a) * ct1 + 0.5 * (ct1 * a) + ct2 * delta
    return torch.where(d >= 0, ct_a, -ct_a)


def _log_cosh_vjp(p, y, ct, param):
    ea, eb = _logaddexp_jac(p - y, y - p)
    return ct * ea + -(ct * eb)


def _logit_dist_vjp(p, y, ct, param):
    d = p - y
    ea, eb = _logaddexp_jac(d / 2, -d / 2)
    c2 = ct * 2.0
    return (c2 * ea) / 2 + -((c2 * eb) / 2)


def _sigmoid_ce_vjp(p, y, ct, param):
    # The log1p term's cotangent, then the product's, then the maximum's
    # (the order JAX's transpose accumulates them in).
    e = torch.exp(-torch.abs(p))
    c3 = -((ct / (e + 1.0)) * e)
    c_log = torch.where(p >= 0, c3, -c3)
    zero = torch.zeros_like(p)
    c_max = ct * _balanced(p, torch.maximum(p, zero), zero)
    return (c_log + (-ct) * y) + c_max


def _periodic_l2_vjp(p, y, ct, c):
    e = py_mod(p - y + c / 2, torch.full_like(p, c)) - c / 2
    return ct * e + e * ct


_LOSS_VJP = {LOSS_L2: _l2_vjp, LOSS_L1: _l1_vjp, LOSS_HUBER: _huber_vjp,
             LOSS_LOGCOSH: _log_cosh_vjp, LOSS_LOGIT_DIST: _logit_dist_vjp,
             LOSS_SIGMOID_CE: _sigmoid_ce_vjp, LOSS_PERIODIC_L2: _periodic_l2_vjp}


def loss_vjp(loss_fn: Callable) -> Callable:
    """d elementwise_loss / d pred, ``(pred, target, ct) -> d pred``, for
    the library losses (core/losses.py ``KernelLoss``): the transpose of the
    JVP JAX takes of each loss's formula, as csrc/interp.cuh
    ``loss_vjp_of_kind`` computes it."""
    kl = kernel_loss(loss_fn)
    if kl is None:
        raise NotImplementedError(
            "the constant optimizer's kernel gradient covers the library elementwise "
            "losses only (core/losses.py LOSS_REGISTRY and its factories)")
    fn = _LOSS_VJP[kl.kind]
    return lambda p, y, ct: fn(p, y, ct, kl.param)
