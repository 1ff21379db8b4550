"""Elementwise losses and cost (port of ``core/losses.py``).

``elementwise_loss(prediction, target)`` returns elementwise values; the
framework aggregates: unweighted = mean, weighted = sum(loss * w) / sum(w).
An invalid evaluation has loss ``inf``. `loss_to_cost` adds the baseline
normalization and the parsimony complexity penalty.

Each library loss is a :class:`KernelLoss`: its formula is the JAX
package's, operation for operation, and its ``kind`` and ``param`` name it
to the interpreter kernels (csrc/interp.cuh ``LossSpec``), which compute
the same formula. A user callable has no kind; the kernels refuse it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np
import torch

__all__ = ["resolve_loss", "aggregate_loss", "loss_to_cost", "baseline_normalization",
           "LOSS_REGISTRY", "KernelLoss", "kernel_loss", "huber_loss", "periodic_l2_loss",
           "sigmoid_cross_entropy_loss", "loss_from_pred"]


def _logaddexp(a, b):
    """``jnp.logaddexp``: max(a, b) + log1p(exp(-|a - b|)), or a + b where
    a - b is NaN (NaNs, or infinities of one sign)."""
    delta = a - b
    return torch.where(torch.isnan(delta), a + b,
                       torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(delta))))


def _ln2(x):
    """log(2) at the dtype of ``x``, as ``jnp.log(2.0).astype(dtype)``."""
    return float(np.float32(math.log(2.0))) if x.dtype != torch.float64 else math.log(2.0)


def _l2(pred, target, param):
    d = pred - target
    return d * d


def _l1(pred, target, param):
    return torch.abs(pred - target)


def _huber(pred, target, delta):
    a = torch.abs(pred - target)
    return torch.where(a <= delta, 0.5 * a * a, delta * (a - 0.5 * delta))


def _log_cosh(pred, target, param):
    return _logaddexp(pred - target, target - pred) - _ln2(pred)


def _logit_dist(pred, target, param):
    # LossFunctions.jl LogitDistLoss(d) = -log(4 e^d / (1+e^d)^2) = 2 log(cosh(d/2))
    d = pred - target
    return 2.0 * (_logaddexp(d / 2, -d / 2) - _ln2(d))


def _sigmoid_ce(pred, target, param):
    # target in {0,1}; pred is a logit
    return torch.maximum(pred, torch.zeros_like(pred)) - pred * target + torch.log1p(
        torch.exp(-torch.abs(pred)))


def _periodic_l2(pred, target, c):
    from ..ops.operators import py_mod

    d = py_mod(pred - target + c / 2, torch.full_like(pred, c)) - c / 2
    return d * d


# Kernel kinds of the library losses (csrc/interp.cuh LOSS_*).
LOSS_L2, LOSS_L1, LOSS_HUBER, LOSS_LOGCOSH, LOSS_LOGIT_DIST, LOSS_SIGMOID_CE, LOSS_PERIODIC_L2 = (
    range(7))
_FORMULAS = {LOSS_L2: _l2, LOSS_L1: _l1, LOSS_HUBER: _huber, LOSS_LOGCOSH: _log_cosh,
             LOSS_LOGIT_DIST: _logit_dist, LOSS_SIGMOID_CE: _sigmoid_ce,
             LOSS_PERIODIC_L2: _periodic_l2}


class KernelLoss:
    """A library elementwise loss: ``loss(pred, target)`` computes it, and
    ``kind`` and ``param`` (Huber's delta, the periodic L2's period; 0.0
    for the others) tell the interpreter kernels which loss it is. Two
    losses with the same kind and parameter are equal, so each call of a
    factory names the same kernel loss."""

    __slots__ = ("kind", "param", "name")

    def __init__(self, kind: int, param: float = 0.0, name: str = ""):
        self.kind = int(kind)
        self.param = float(param)
        self.name = name

    def __call__(self, pred, target):
        return _FORMULAS[self.kind](pred, target, self.param)

    @property
    def __name__(self):
        return self.name

    def __eq__(self, other):
        return (isinstance(other, KernelLoss) and self.kind == other.kind
                and self.param == other.param)

    def __hash__(self):
        return hash((self.kind, self.param))

    def __repr__(self):
        return f"{self.name}({self.param})" if self.kind in (LOSS_HUBER, LOSS_PERIODIC_L2) \
            else self.name


def kernel_loss(fn) -> Optional[KernelLoss]:
    """``fn`` if it is a library loss the kernels implement, else None."""
    return fn if isinstance(fn, KernelLoss) else None


l2_dist_loss = KernelLoss(LOSS_L2, name="l2_dist_loss")
l1_dist_loss = KernelLoss(LOSS_L1, name="l1_dist_loss")
log_cosh_loss = KernelLoss(LOSS_LOGCOSH, name="log_cosh_loss")
logit_dist_loss = KernelLoss(LOSS_LOGIT_DIST, name="logit_dist_loss")
sigmoid_cross_entropy_loss = KernelLoss(LOSS_SIGMOID_CE, name="sigmoid_cross_entropy_loss")


def huber_loss(delta: float = 1.0) -> KernelLoss:
    return KernelLoss(LOSS_HUBER, delta, name="huber_loss")


def periodic_l2_loss(c: float = 2 * 3.141592653589793) -> KernelLoss:
    return KernelLoss(LOSS_PERIODIC_L2, c, name="periodic_l2_loss")


LOSS_REGISTRY = {
    "L2DistLoss": l2_dist_loss,
    "L1DistLoss": l1_dist_loss,
    "LogitDistLoss": logit_dist_loss,
    "HuberLoss": huber_loss(1.0),
    "mse": l2_dist_loss,
    "l2": l2_dist_loss,
    "mae": l1_dist_loss,
    "l1": l1_dist_loss,
    "huber": huber_loss(1.0),
    "logcosh": log_cosh_loss,
}


def resolve_loss(spec: Union[str, Callable, None]) -> Callable:
    if spec is None:
        return l2_dist_loss
    if callable(spec):
        return spec
    name = str(spec).replace("()", "")
    if name in LOSS_REGISTRY:
        return LOSS_REGISTRY[name]
    raise ValueError(f"Unknown loss {spec!r}; pass a callable (pred, target) -> elementwise loss")


def aggregate_loss(
    elementwise: Callable,
    pred: torch.Tensor,      # [..., n]
    target: torch.Tensor,    # [n]
    valid: torch.Tensor,     # bool [...]
    weights: Optional[torch.Tensor] = None,  # [n]
):
    """Mean (or weighted-mean) loss with invalid -> inf and NaN -> inf.
    Under an active data-row shard (parallel/collectives.row_shard) the
    rows are this rank's block: the row partials and validity are
    reduced over every block, in block order."""
    from ..parallel.collectives import active_row_shard

    shard = active_row_shard()
    if shard is not None:
        return _aggregate_sharded(elementwise(pred, target), valid, weights, shard)
    vals = elementwise(pred, target)
    if weights is None:
        loss = torch.mean(vals, dim=-1)
    else:
        w = weights
        vals = torch.where(torch.isfinite(vals), vals, math.inf)
        vals = torch.where(w > 0, vals, 0.0)
        loss = torch.sum(vals * w, dim=-1) / torch.sum(w)
    loss = torch.where(valid, loss, math.inf)
    return torch.where(torch.isnan(loss), math.inf, loss)


def _aggregate_sharded(vals, valid, weights, shard):
    from ..parallel.collectives import shard_all, shard_row_sum

    if weights is None:
        loss = shard_row_sum(torch.sum(vals, dim=-1), shard) / shard.n_rows
    else:
        w = weights
        vals = torch.where(torch.isfinite(vals), vals, math.inf)
        vals = torch.where(w > 0, vals, 0.0)
        loss = shard_row_sum(torch.sum(vals * w, dim=-1), shard) / shard_row_sum(
            torch.sum(w), shard)
    loss = torch.where(shard_all(valid, shard), loss, math.inf)
    return torch.where(torch.isnan(loss), math.inf, loss)


def baseline_normalization(baseline_loss: torch.Tensor, use_baseline: torch.Tensor):
    """max(baseline, 0.01) with the 0.01 floor when the baseline is
    unusable. Shared by `loss_to_cost` and the kernel's cost epilogue
    (ops.fused_eval.fused_cost_program) so the two paths cannot drift."""
    floor = torch.full_like(baseline_loss, 0.01)
    return torch.where(use_baseline & (baseline_loss >= 0.01), baseline_loss, floor)


def loss_to_cost(loss, baseline_loss, use_baseline, complexity, parsimony: float):
    """cost = loss / max(baseline, 0.01) + parsimony * complexity."""
    normalization = baseline_normalization(baseline_loss, use_baseline)
    return loss / normalization + parsimony * complexity.to(loss.dtype)


def loss_from_pred(pred, valid, y, w, elementwise_loss, loss_function=None):
    """Per-tree loss from predictions ``pred`` [..., n] and validity
    [...]: the custom whole-prediction hook (``loss_function`` or
    ``loss_function_expression``, called per tree as
    ``loss_function(pred, y, w, valid)``) or the elementwise path. An
    invalid tree, or a NaN from the hook, gets inf. The hook runs under
    ``torch.func.vmap`` over the trees, as the JAX package ``jax.vmap``s
    it, and stays differentiable by ``torch.autograd``. Under an active
    data-row shard the hook sees the whole prediction: every shard's rows
    gathered in row order (their gradient flows back to this rank's
    rows), the whole targets and weights, and validity over every shard,
    so its loss is the unsharded one."""
    if loss_function is None:
        return aggregate_loss(elementwise_loss, pred, y, valid, w)
    from ..parallel.collectives import active_row_shard, gather_rows, shard_all, whole_rows

    shard = active_row_shard()
    if shard is not None:
        pred = gather_rows(pred, shard)
        valid = shard_all(valid, shard)
        y = whole_rows(y, shard, "y")
        w = None if w is None else whole_rows(w, shard, "w")
    flat_pred = pred.reshape(-1, pred.shape[-1])
    flat_valid = valid.reshape(-1)
    one = lambda p, v: torch.as_tensor(loss_function(p, y, w, v), dtype=pred.dtype,
                                       device=pred.device)
    loss = torch.func.vmap(one)(flat_pred, flat_valid).reshape(valid.shape)
    return torch.where(valid & ~torch.isnan(loss), loss, torch.inf)
