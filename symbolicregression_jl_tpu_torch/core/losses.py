"""Elementwise losses and cost (port of ``core/losses.py``).

``elementwise_loss(prediction, target)`` returns elementwise values; the
framework aggregates: unweighted = mean, weighted = sum(loss * w) / sum(w).
An invalid evaluation has loss ``inf``. `loss_to_cost` adds the baseline
normalization and the parsimony complexity penalty.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch

__all__ = ["resolve_loss", "aggregate_loss", "loss_to_cost",
           "baseline_normalization", "LOSS_REGISTRY"]


def l2_dist_loss(pred, target):
    d = pred - target
    return d * d


def l1_dist_loss(pred, target):
    return torch.abs(pred - target)


def huber_loss(delta: float = 1.0):
    def f(pred, target):
        a = torch.abs(pred - target)
        return torch.where(a <= delta, 0.5 * a * a, delta * (a - 0.5 * delta))

    return f


def log_cosh_loss(pred, target):
    return torch.logaddexp(pred - target, target - pred) - math.log(2.0)


def logit_dist_loss(pred, target):
    d = pred - target
    return 2.0 * (torch.logaddexp(d / 2, -d / 2) - math.log(2.0))


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
    """Mean (or weighted-mean) loss with invalid -> inf and NaN -> inf."""
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
