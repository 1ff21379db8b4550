"""Sklearn-style regressor API (port of ``symbolicregression_jl_tpu/api/regressor.py``).

`SRRegressor` takes every `Options` field as a constructor keyword, runs
`equation_search` on `fit` (on ``device``, CUDA unless ``device="cpu"``),
refits warm by running only the iterations it has not run yet, and
predicts with the `choose_best` selection rule or an equation the caller
picks. LaTeX and SymPy export and unit-typed predictions come with later
slices and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.options import Options, SEARCH_API_REST
from ..device import resolve_device
from ..ops.encoding import encode_population
from ..ops.eval import eval_tree_batch
from ..ops.tree import Node
from .hall_of_fame import HallOfFame, calculate_pareto_frontier, compute_scores
from .search import RuntimeOptions, SearchState, equation_search

__all__ = ["SRRegressor", "MultitargetSRRegressor", "EquationRecord", "choose_best"]

EXPORT_SLICE = SEARCH_API_REST + ", with utils/export.py"


def _coerce_table(X):
    """(values [n, F], column names or None) from an array, a pandas
    DataFrame or a dict of columns."""
    if hasattr(X, "columns") and hasattr(X, "to_numpy"):
        return X.to_numpy(), [str(c) for c in X.columns]
    if isinstance(X, dict):
        names = list(X)
        return (np.stack([np.asarray(X[k]).reshape(-1) for k in names], axis=1),
                [str(n) for n in names])
    return np.asarray(X), None


def choose_best(*, trees, losses, scores, complexities, options: Optional[Options] = None) -> int:
    """The highest score among equations whose loss is at most 1.5 times
    the smallest; with ``loss_scale="linear"`` the smallest loss."""
    losses = np.asarray(losses, dtype=float)
    if options is not None and options.loss_scale == "linear":
        return int(np.argmin(losses))
    threshold = 1.5 * np.min(losses)
    return int(np.argmax([s if l <= threshold else -np.inf for s, l in zip(scores, losses)]))


@dataclasses.dataclass
class EquationRecord:
    """One row of the fitted report (``equations_``)."""

    complexity: int
    loss: float
    score: float
    equation: str
    tree: Optional[Node]
    params: Optional[np.ndarray] = None   # (n_params, n_classes) for parametric members
    template_expr: Optional[Any] = None   # HostTemplateExpression; tree is None then


class SRRegressor:
    """Symbolic-regression estimator with the sklearn fit/predict contract.

    ``device_scale="auto"`` applies ``_DEVICE_SCALE_CONFIG`` (512 islands
    x 256 members, tournament 16, 100 cycles) where the JAX package does
    on its accelerator: here when ``device`` is CUDA, unless the caller
    sets any of those four options. ``device`` replaces the JAX package's
    ``devices``: the port runs on one device."""

    _MULTITARGET = False

    # The JAX package's accelerator-scale search.
    _DEVICE_SCALE_CONFIG = dict(populations=512, population_size=256,
                                tournament_selection_n=16, ncycles_per_iteration=100)

    def __init__(self, *, niterations: int = 40, selection_method: Callable = choose_best,
                 seed: Optional[int] = None, verbosity: int = 0, progress: bool = False,
                 run_id: Optional[str] = None, warm_start: bool = True,
                 device: Optional[Union[str, torch.device]] = None,
                 device_scale: Union[str, bool] = "auto", **option_kwargs: Any):
        self.niterations = int(niterations)
        self.selection_method = selection_method
        self.seed = seed
        self.verbosity = verbosity
        self.progress = progress
        self.run_id = run_id
        self.warm_start = bool(warm_start)
        self.device = device
        self.device_scale = device_scale
        self.option_kwargs = dict(option_kwargs)
        self.options_: Optional[Options] = None
        self.state_: Optional[SearchState] = None
        self.hofs_: Optional[List[HallOfFame]] = None
        self.equations_: Optional[Any] = None
        self.best_idx_: Optional[Any] = None
        self.nout_: int = 1
        self.nfeatures_: Optional[int] = None
        self.variable_names_: Optional[Sequence[str]] = None
        self.fitted_iterations_: int = 0
        self.classes_: Optional[np.ndarray] = None
        self._named_fit_ = False

    def _make_options(self) -> Options:
        kwargs = dict(self.option_kwargs)
        self.device_scaled_ = False
        if self.device_scale in ("auto", True) and resolve_device(self.device).type == "cuda" \
                and not set(self._DEVICE_SCALE_CONFIG) & set(kwargs):
            kwargs.update(self._DEVICE_SCALE_CONFIG)
            self.device_scaled_ = True
        return Options(seed=self.seed, **kwargs)

    def fit(self, X, y, *, weights=None, variable_names: Optional[Sequence[str]] = None,
            X_units=None, y_units=None, category=None, resume: Optional[str] = None,
            initial_population: Optional[Sequence] = None, guesses: Optional[Sequence] = None
            ) -> "SRRegressor":
        """Run the search. ``category`` gives each row its class for
        parametric expressions. ``resume="auto"`` (or a checkpoint or run
        directory) continues a stopped search to ``niterations`` in total;
        ``initial_population`` and ``guesses`` seed it as in
        ``equation_search``."""
        X, table_names = _coerce_table(X)
        if variable_names is None and table_names is not None:
            variable_names = table_names
        self._named_fit_ = variable_names is not None
        y = np.asarray(y)
        if self._MULTITARGET:
            if y.ndim != 2:
                raise ValueError("MultitargetSRRegressor requires 2D y")
            y_internal = y.T   # (n, nout) -> (nout, n)
            self.nout_ = y_internal.shape[0]
        else:
            if y.ndim != 1:
                raise ValueError("SRRegressor requires 1D y; use Multitarget")
            y_internal = y
            self.nout_ = 1
        new_options = self._make_options()
        saved_state = None
        if resume is None and self.warm_start and self.state_ is not None:
            issues = new_options.check_warm_start_compatibility(self.options_)
            if issues:
                raise ValueError(f"Warm-start refit with changed incompatible options: {issues}. "
                                 "Pass warm_start=False or reset the model.")
            saved_state = self.state_
        self.options_ = new_options
        self.nfeatures_ = X.shape[1]
        self.variable_names_ = (list(variable_names) if variable_names is not None
                                else [f"x{i + 1}" for i in range(X.shape[1])])
        extra = None
        self.classes_ = None
        if category is not None:
            cat = np.asarray(category)
            extra = {"class": cat}
            self.classes_ = np.unique(cat)
        # A warm refit runs only the iterations not yet run.
        niterations = self.niterations
        if saved_state is not None:
            niterations = max(self.niterations - self.fitted_iterations_, 0)
            if niterations == 0:
                self._build_report()
                return self
        ropt = RuntimeOptions(niterations=niterations, verbosity=self.verbosity,
                              progress=self.progress, seed=self.seed, return_state=True)
        if self.run_id is not None:
            ropt.run_id = self.run_id
        state, hof = equation_search(
            X, y_internal, options=new_options, weights=weights, variable_names=variable_names,
            X_units=X_units, y_units=y_units, extra=extra, saved_state=saved_state,
            resume=resume, runtime_options=ropt, initial_population=initial_population,
            guesses=guesses, device=self.device)
        self.state_ = state
        self.hofs_ = hof if isinstance(hof, list) else [hof]
        if saved_state is None:
            self.fitted_iterations_ = niterations
        else:
            self.fitted_iterations_ += niterations
        self._build_report()
        return self

    def _build_report(self) -> None:
        tables: List[List[EquationRecord]] = []
        best_idx: List[int] = []
        for hof in self.hofs_:
            frontier = compute_scores(calculate_pareto_frontier(hof.entries),
                                      self.options_.loss_scale)
            recs = [EquationRecord(complexity=e.complexity, loss=e.loss, score=e.score,
                                   equation=e.equation_string(variable_names=self.variable_names_),
                                   tree=e.tree, params=e.params, template_expr=e.template_expr)
                    for e in frontier]
            tables.append(recs)
            best_idx.append(self.selection_method(
                trees=[r.tree for r in recs], losses=[r.loss for r in recs],
                scores=[r.score for r in recs], complexities=[r.complexity for r in recs],
                options=self.options_) if recs else 0)
        if self._MULTITARGET:
            self.equations_, self.best_idx_ = tables, best_idx
        else:
            self.equations_, self.best_idx_ = tables[0], best_idx[0]

    def _check_fitted(self) -> None:
        if self.equations_ is None:
            raise RuntimeError("This SRRegressor instance is not fitted yet.")

    def _predict_one(self, recs, idx, X, category=None) -> np.ndarray:
        """One equation's predictions on ``self.device``; an invalid
        evaluation predicts zeros."""
        dev = resolve_device(self.device)
        rec = recs[idx]
        if rec.template_expr is not None:
            out = rec.template_expr(X, device=dev)
            return np.zeros(X.shape[0], out.dtype) if np.any(~np.isfinite(out)) else out
        tree = rec.tree
        enc = encode_population([tree], max(tree.count_nodes(), 1), self.options_.operators,
                                device=dev)
        params = None
        if rec.params is not None and rec.params.shape[0] > 0:
            if category is None:
                raise ValueError("This model was fit with a parametric expression spec; "
                                 "predict requires `category=`")
            cat = np.asarray(category)
            if cat.shape[0] != X.shape[0]:
                raise ValueError(f"`category` has {cat.shape[0]} entries but X has "
                                 f"{X.shape[0]} rows — one category per row is required")
            cls = np.clip(np.searchsorted(self.classes_, cat), 0, rec.params.shape[1] - 1)
            unseen = self.classes_[cls] != cat
            if np.any(unseen):
                raise ValueError(f"predict got categories not seen during fit: "
                                 f"{np.unique(cat[unseen])!r} (known: {self.classes_!r})")
            # Per-row parameter values p[k, row] = params[k, class[row]].
            params = torch.as_tensor(np.ascontiguousarray(rec.params[:, cls], np.float32),
                                     device=dev)[None]
        Xt = torch.as_tensor(np.ascontiguousarray(np.asarray(X, np.float32).T), device=dev)
        pred, valid = eval_tree_batch(enc, Xt, self.options_.operators, params=params)
        out = pred[0].cpu().numpy()
        return out if bool(valid[0]) else np.zeros(X.shape[0], out.dtype)

    def predict(self, X, idx: Optional[Union[int, Sequence[int]]] = None, *, category=None,
                with_units: bool = False):
        """Predict with the selected (or ``idx``-chosen) equation. Column
        tables (DataFrames, dicts of columns) are reordered by the fitted
        variable names."""
        if with_units:
            raise NotImplementedError("predict(with_units=True) is not in the PyTorch port "
                                      "yet; it comes with the expression-plugin slice "
                                      "(ROADMAP.md queue 1 item 4).")
        self._check_fitted()
        X, table_names = _coerce_table(X)
        if table_names is not None and self.variable_names_ is not None:
            if set(self.variable_names_) <= set(table_names):
                X = X[:, [table_names.index(n) for n in self.variable_names_]]
            elif self._named_fit_:
                raise ValueError(f"Prediction table columns {table_names} do not cover the "
                                 f"fitted variable names {list(self.variable_names_)}")
        if self._MULTITARGET:
            if idx is None:
                idxs = list(self.best_idx_)
            elif np.ndim(idx) == 0:
                idxs = [int(idx)] * len(self.equations_)
            else:
                idxs = list(idx)
            return np.stack([self._predict_one(recs, i, X, category)
                             for recs, i in zip(self.equations_, idxs)], axis=1)
        i = int(idx) if idx is not None else int(self.best_idx_)
        return self._predict_one(self.equations_, i, X, category)

    def score(self, X, y, *, sample_weight=None, category=None) -> float:
        """Coefficient of determination R^2."""
        self._check_fitted()
        y = np.asarray(y)
        pred = self.predict(X, category=category)
        if self._MULTITARGET:
            pred = pred.reshape(y.shape)
        w = (np.ones_like(y, dtype=float) if sample_weight is None
             else np.asarray(sample_weight, dtype=float))
        ss_res = float(np.sum(w * (y - pred) ** 2))
        ss_tot = float(np.sum(w * (y - np.average(y, weights=w)) ** 2))
        if ss_tot == 0:
            return 0.0 if ss_res > 0 else 1.0
        return 1.0 - ss_res / ss_tot

    def get_best(self):
        """The selected equation record (one per output for multitarget)."""
        self._check_fitted()
        if self._MULTITARGET:
            return [recs[i] for recs, i in zip(self.equations_, self.best_idx_)]
        return self.equations_[self.best_idx_]

    def latex(self, idx: Optional[int] = None):
        raise NotImplementedError(f"SRRegressor.latex() is not in the PyTorch port yet; it "
                                  f"comes with {EXPORT_SLICE}.")

    def sympy(self, idx: Optional[int] = None):
        raise NotImplementedError(f"SRRegressor.sympy() is not in the PyTorch port yet; it "
                                  f"comes with {EXPORT_SLICE}.")

    def __repr__(self) -> str:  # pragma: no cover
        fitted = "fitted" if self.equations_ is not None else "unfitted"
        return f"{type(self).__name__}(niterations={self.niterations}, {fitted})"


class MultitargetSRRegressor(SRRegressor):
    """Multi-output variant: ``y`` has shape (n, nout); one hall of fame
    and one selected equation per output."""

    _MULTITARGET = True
