"""Device-resident datasets (port of ``core/dataset.py``).

The whole dataset lives in device memory for the whole search. The
public layout is sklearn-style ``X: (n, nfeatures)``; the device copy is
the transpose ``Xt: (nfeatures, n)`` so a feature read is one contiguous
row.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .losses import aggregate_loss

__all__ = ["Dataset", "DeviceData", "make_dataset"]


def _round_bf16(a) -> np.ndarray:
    """``a`` rounded to bfloat16 (round to nearest even), as float32."""
    t = torch.as_tensor(np.asarray(a, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def to_numpy_dtype(dtype: torch.dtype):
    """numpy's float32 or float64 for the torch dtype."""
    return np.float64 if dtype == torch.float64 else np.float32


def _subscriptify(i: int) -> str:
    subs = "₀₁₂₃₄₅₆₇₈₉"
    return "".join(subs[int(c)] for c in str(i))


@dataclasses.dataclass
class DeviceData:
    """The device tensors of a Dataset."""

    Xt: torch.Tensor                 # [nfeatures, n] float32 (or float64)
    y: torch.Tensor                  # [n], X's dtype
    weights: Optional[torch.Tensor]  # [n], X's dtype, or None
    baseline_loss: torch.Tensor      # 0-d, X's dtype
    use_baseline: torch.Tensor       # 0-d bool
    # Each row's class [n] int32 (the ``class`` column of ``extra``, as
    # indices into its sorted unique values), or None.
    class_idx: Optional[torch.Tensor] = None
    # Dimensional analysis (None when the dataset has no units): SI
    # exponent vectors read by ops.dims_eval, and the row the single-sample
    # check reads (the full dataset's first row, kept by take_rows, as the
    # JAX package reads ``data.Xt[:, 0]`` under a minibatch too).
    x_dims: Optional[torch.Tensor] = None    # [nfeatures, 7] float32
    y_dims: Optional[torch.Tensor] = None    # [7] float32
    dims_row: Optional[torch.Tensor] = None  # [nfeatures], X's dtype
    # This rank's block of a row-sharded dataset (mesh/plan.MeshPlan.place_data;
    # parallel/collectives.RowShard): losses add the row partials of every
    # block. None holds every row.
    row_shard: Optional[object] = None
    # Row samples made by strided_sample, by size (a replace() starts empty).
    _samples: Dict[int, "DeviceData"] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.Xt.device

    @property
    def n(self) -> int:
        return int(self.Xt.shape[1])

    def take_rows(self, idx: torch.Tensor) -> "DeviceData":
        """Rows ``idx`` [B] (any order, repeats allowed) as a DeviceData of
        their own: X, y, weights and classes gathered into contiguous
        tensors (the kernels read contiguous [F, n] storage), the baseline
        normalization the full data's. A minibatch is gathered once per
        iteration and read by every cycle and the constant optimizer."""
        idx = idx.to(self.device).long()
        take = lambda t: None if t is None else t.index_select(-1, idx).contiguous()
        return DeviceData(Xt=take(self.Xt), y=take(self.y), weights=take(self.weights),
                          baseline_loss=self.baseline_loss, use_baseline=self.use_baseline,
                          class_idx=take(self.class_idx), x_dims=self.x_dims,
                          y_dims=self.y_dims, dims_row=self.dims_row)

    def strided_sample(self, sample_rows: int) -> "DeviceData":
        """graftstage's screening rows (``ops.fused_eval.strided_sample_indices``)
        as a DeviceData of their own (``take_rows``), made once per size and
        kept. On a minibatch these are the batch's strided rows, as the JAX
        package's ``take(batch_idx, strided)``."""
        sample = self._samples.get(sample_rows)
        if sample is None:
            from ..ops.fused_eval import strided_sample_indices

            sample = self.take_rows(torch.from_numpy(
                strided_sample_indices(self.n, sample_rows)))
            self._samples[sample_rows] = sample
        return sample


@dataclasses.dataclass
class Dataset:
    """Host wrapper: device data + metadata."""

    data: DeviceData
    n: int
    nfeatures: int
    index: int = 1                   # the output this dataset holds, from 1
    avg_y: Optional[float] = None
    variable_names: Sequence[str] = ()
    display_variable_names: Sequence[str] = ()
    y_variable_name: str = "y"
    # Units as given (unit specs per feature, and of y), or None.
    X_units: Optional[Sequence[Any]] = None
    y_units: Optional[Any] = None
    # The ``extra`` columns as given (``class`` among them), carried with
    # the dataset as in the JAX package.
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def has_units(self) -> bool:
        return self.X_units is not None or self.y_units is not None

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

    @property
    def n_classes(self) -> int:
        if self.data.class_idx is None:
            return 0
        return int(self.data.class_idx.max()) + 1

    def update_baseline_loss(self, elementwise_loss) -> None:
        """Evaluate the constant (avg-y) predictor to set the baseline."""
        if self.avg_y is None:
            return
        y = self.data.y
        pred = torch.full_like(y, float(np.asarray(self.avg_y, to_numpy_dtype(y.dtype))))
        loss = aggregate_loss(elementwise_loss, pred, y,
                              torch.ones((), dtype=torch.bool, device=y.device),
                              self.data.weights)
        loss_f = float(loss)
        if np.isfinite(loss_f):
            self.data = dataclasses.replace(
                self.data,
                baseline_loss=torch.tensor(loss_f, dtype=y.dtype, device=y.device),
                use_baseline=torch.tensor(True, device=y.device),
            )
        else:
            self.data = dataclasses.replace(
                self.data,
                baseline_loss=torch.ones((), dtype=y.dtype, device=y.device),
                use_baseline=torch.tensor(False, device=y.device),
            )


def make_dataset(
    X,
    y,
    *,
    weights=None,
    variable_names: Optional[Sequence[str]] = None,
    display_variable_names: Optional[Sequence[str]] = None,
    y_variable_name: Optional[str] = None,
    extra: Optional[Dict[str, Any]] = None,
    X_units=None,
    y_units=None,
    index: int = 1,
    device=None,
    dtype=torch.float32,
) -> Dataset:
    """Build a Dataset from ``X: (n, nfeatures)`` and ``y: (n,)`` on
    ``device`` (CUDA unless ``device="cpu"``). Data is ``dtype``: float32,
    float64 (``eval_dtype="float64"``, as the JAX package under x64), or
    bfloat16 (its values rounded to bf16, held in float32).

    ``extra={"class": values}`` (or ``"classes"``) gives each row a class
    for parametric expressions: ``class_idx`` holds each value's index
    among the sorted unique values; every ``extra`` column is carried in
    ``Dataset.extra``. ``X_units`` (one unit spec per feature) and
    ``y_units`` give the dimensional analysis its ``x_dims``/``y_dims``
    (core/units.py ``units_to_dims_arrays``), and string units annotate
    the display names (``x1[m]``). ``index`` numbers the output this
    dataset holds in a multi-output search (from 1)."""
    dev = resolve_device(device)
    X = np.asarray(X)
    if X.ndim != 2:
        raise ValueError(f"X must be 2D (n, nfeatures); got shape {X.shape}")
    n, nfeatures = X.shape
    ndt = to_numpy_dtype(dtype)
    if dtype == torch.bfloat16:
        # bf16 data (eval_dtype="bfloat16"): the values rounded to bf16, held
        # in float32 (core/options.py state_dtype).
        X = _round_bf16(X)
        y = _round_bf16(y)
        weights = None if weights is None else _round_bf16(weights)
        dtype = torch.float32
    y_arr = np.asarray(y, ndt).reshape(-1)
    if y_arr.shape[0] != n:
        raise ValueError(f"y has {y_arr.shape[0]} rows but X has {n}")
    w_arr = None if weights is None else np.asarray(weights, ndt).reshape(-1)
    if w_arr is not None and w_arr.shape[0] != n:
        raise ValueError(f"weights has {w_arr.shape[0]} rows but X has {n}")
    extra = dict(extra or {})
    class_idx = None
    if "class" in extra or "classes" in extra:
        cls = np.asarray(extra.get("class", extra.get("classes"))).reshape(-1)
        class_idx = np.searchsorted(np.unique(cls), cls).astype(np.int32)
        extra["class"] = cls

    variable_names = list(variable_names or [f"x{i + 1}" for i in range(nfeatures)])
    default_names = [f"x{i + 1}" for i in range(nfeatures)]
    display_variable_names = list(display_variable_names or (
        variable_names if variable_names != default_names
        else [f"x{_subscriptify(i + 1)}" for i in range(nfeatures)]))
    if X_units is not None:
        # Unit-annotated printing, as in the JAX package: only plain string
        # specs annotate.
        display_variable_names = [
            f"{name}[{u}]" if isinstance(u, str) and u not in ("", "1") else name
            for name, u in zip(display_variable_names, X_units)]
    if y_variable_name is None:
        y_variable_name = "y" if "y" not in variable_names else "target"

    if w_arr is not None:
        avg_y = float(np.sum(y_arr * w_arr) / np.sum(w_arr))
    else:
        avg_y = float(np.mean(y_arr))

    from .units import units_to_dims_arrays

    x_dims_np, y_dims_np = units_to_dims_arrays(X_units, nfeatures, y_units)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    data = DeviceData(
        Xt=t(X.T.astype(ndt)),
        y=t(y_arr),
        weights=None if w_arr is None else t(w_arr),
        baseline_loss=torch.ones((), dtype=dtype, device=dev),
        use_baseline=torch.tensor(True, device=dev),
        class_idx=None if class_idx is None else t(class_idx),
        x_dims=None if x_dims_np is None else t(x_dims_np),
        y_dims=None if y_dims_np is None else t(y_dims_np),
        dims_row=None if x_dims_np is None else t(X[0].astype(ndt)),
    )
    return Dataset(
        data=data, n=n, nfeatures=nfeatures, index=index, avg_y=avg_y,
        variable_names=variable_names,
        display_variable_names=display_variable_names,
        y_variable_name=y_variable_name,
        X_units=list(X_units) if X_units is not None else None,
        y_units=y_units,
        extra=extra,
    )
