"""Device-resident datasets (port of ``core/dataset.py``).

The whole dataset lives in device memory for the whole search. The
public layout is sklearn-style ``X: (n, nfeatures)``; the device copy is
the transpose ``Xt: (nfeatures, n)`` so a feature read is one contiguous
row.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .losses import aggregate_loss

__all__ = ["Dataset", "DeviceData", "make_dataset"]


def _subscriptify(i: int) -> str:
    subs = "₀₁₂₃₄₅₆₇₈₉"
    return "".join(subs[int(c)] for c in str(i))


@dataclasses.dataclass
class DeviceData:
    """The device tensors of a Dataset."""

    Xt: torch.Tensor                 # [nfeatures, n] float32
    y: torch.Tensor                  # [n] float32
    weights: Optional[torch.Tensor]  # [n] float32 or None
    baseline_loss: torch.Tensor      # 0-d float32
    use_baseline: torch.Tensor       # 0-d bool

    @property
    def device(self) -> torch.device:
        return self.Xt.device

    @property
    def n(self) -> int:
        return int(self.Xt.shape[1])


@dataclasses.dataclass
class Dataset:
    """Host wrapper: device data + metadata."""

    data: DeviceData
    n: int
    nfeatures: int
    avg_y: Optional[float] = None
    variable_names: Sequence[str] = ()
    display_variable_names: Sequence[str] = ()
    y_variable_name: str = "y"

    @property
    def X(self):
        return self.data.Xt.T

    @property
    def y(self):
        return self.data.y

    @property
    def weights(self):
        return self.data.weights

    @property
    def is_weighted(self) -> bool:
        return self.data.weights is not None

    def update_baseline_loss(self, elementwise_loss) -> None:
        """Evaluate the constant (avg-y) predictor to set the baseline."""
        if self.avg_y is None:
            return
        y = self.data.y
        pred = torch.full_like(y, float(np.float32(self.avg_y)))
        loss = aggregate_loss(elementwise_loss, pred, y,
                              torch.ones((), dtype=torch.bool, device=y.device),
                              self.data.weights)
        loss_f = float(loss)
        if np.isfinite(loss_f):
            self.data = dataclasses.replace(
                self.data,
                baseline_loss=torch.tensor(loss_f, dtype=torch.float32, device=y.device),
                use_baseline=torch.tensor(True, device=y.device),
            )
        else:
            self.data = dataclasses.replace(
                self.data,
                baseline_loss=torch.ones((), dtype=torch.float32, device=y.device),
                use_baseline=torch.tensor(False, device=y.device),
            )


def make_dataset(
    X,
    y,
    *,
    weights=None,
    variable_names: Optional[Sequence[str]] = None,
    y_variable_name: Optional[str] = None,
    device=None,
) -> Dataset:
    """Build a Dataset from ``X: (n, nfeatures)`` and ``y: (n,)`` on
    ``device`` (CUDA unless ``device="cpu"``). Data is float32."""
    dev = resolve_device(device)
    X = np.asarray(X)
    if X.ndim != 2:
        raise ValueError(f"X must be 2D (n, nfeatures); got shape {X.shape}")
    n, nfeatures = X.shape
    y_arr = np.asarray(y, np.float32).reshape(-1)
    if y_arr.shape[0] != n:
        raise ValueError(f"y has {y_arr.shape[0]} rows but X has {n}")
    w_arr = None if weights is None else np.asarray(weights, np.float32).reshape(-1)
    if w_arr is not None and w_arr.shape[0] != n:
        raise ValueError(f"weights has {w_arr.shape[0]} rows but X has {n}")

    variable_names = list(variable_names or [f"x{i + 1}" for i in range(nfeatures)])
    default_names = [f"x{i + 1}" for i in range(nfeatures)]
    display_variable_names = (
        variable_names if variable_names != default_names
        else [f"x{_subscriptify(i + 1)}" for i in range(nfeatures)]
    )
    if y_variable_name is None:
        y_variable_name = "y" if "y" not in variable_names else "target"

    if w_arr is not None:
        avg_y = float(np.sum(y_arr * w_arr) / np.sum(w_arr))
    else:
        avg_y = float(np.mean(y_arr))

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    data = DeviceData(
        Xt=t(X.T.astype(np.float32)),
        y=t(y_arr),
        weights=None if w_arr is None else t(w_arr),
        baseline_loss=torch.ones((), dtype=torch.float32, device=dev),
        use_baseline=torch.tensor(True, device=dev),
    )
    return Dataset(
        data=data, n=n, nfeatures=nfeatures, avg_y=avg_y,
        variable_names=variable_names,
        display_variable_names=display_variable_names,
        y_variable_name=y_variable_name,
    )
