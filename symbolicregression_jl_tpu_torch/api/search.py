"""`equation_search`: the search loop on one device.

Port of ``symbolicregression_jl_tpu/api/search.py`` for plain,
parametric (``Options(expression_spec=ParametricExpressionSpec(...))``
with ``extra={"class": ...}``) and template expressions
(``Options(expression_spec=TemplateExpressionSpec(...))``, parameter
vectors included): one output, no warm start, no checkpoints, no
telemetry, one device. The
loop runs `Engine.run_iteration` ``niterations`` times with the maxsize
warm-up, decodes the hall of fame after each iteration, and stops early
on ``timeout_in_seconds``, ``max_evals`` or ``early_stop_condition``
(checked at iteration boundaries). The port writes no files:
``save_to_file`` is not read in this slice.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core.dataset import make_dataset
from ..core.options import Options, check_supported
from ..device import resolve_device
from ..evolve import rng
from ..evolve.engine import Engine
from ..models.spec import ParametricExpressionSpec
from .hall_of_fame import HallOfFame, string_dominating_pareto_curve

__all__ = ["equation_search", "get_cur_maxsize"]


def get_cur_maxsize(maxsize: int, warmup_maxsize_by: float, total_cycles: int,
                    cycles_remaining: int) -> int:
    """Maxsize warm-up 3 -> maxsize over the first ``warmup_maxsize_by``
    fraction of cycles."""
    if warmup_maxsize_by <= 0:
        return maxsize
    fraction_elapsed = (total_cycles - cycles_remaining) / total_cycles
    if fraction_elapsed <= warmup_maxsize_by:
        return 3 + int((maxsize - 3) * fraction_elapsed / warmup_maxsize_by)
    return maxsize


# Arguments of the JAX package's `equation_search` that this slice does not
# carry: each must stay at its default, or the call is refused. `progress`
# may also be False (the JAX package's `warmup` passes it): no progress bar
# is what the port does.
_LATER = {
    "y_variable_names": "the search-API slice (multi-output)",
    "X_units": "the expression-plugin slice (units)",
    "y_units": "the expression-plugin slice (units)",
    "extra": "a later slice (extra columns other than `class`)",
    "guesses": "the search-API slice (warm starts)",
    "initial_population": "the search-API slice (warm starts)",
    "saved_state": "the search-API slice (checkpoint and resume)",
    "resume": "the search-API slice (checkpoint and resume)",
    "runtime_options": "the search-API slice (runtime options, more than one device)",
    "progress": "the observability slice",
    "run_id": "the search-API slice (output files)",
    "return_state": "the search-API slice (checkpoint and resume)",
    "dtype": "a later slice (float32 only)",
}


def equation_search(X, y, *, options: Optional[Options] = None, niterations: int = 40,
                    weights=None, variable_names: Optional[Sequence[str]] = None,
                    display_variable_names: Optional[Sequence[str]] = None,
                    y_variable_names=None, X_units=None, y_units=None, extra=None,
                    guesses=None, initial_population=None, saved_state=None, resume=None,
                    runtime_options=None, verbosity: Optional[int] = None,
                    progress: Optional[bool] = None, run_id: Optional[str] = None,
                    return_state: bool = False, seed: Optional[int] = None, dtype=None,
                    device: Optional[Union[str, torch.device]] = None) -> HallOfFame:
    """Run the symbolic-regression search; returns the hall of fame.

    ``X`` (n, nfeatures) and ``y`` (n,) are host arrays; the search runs
    on ``device`` (CUDA unless ``device="cpu"``). ``seed`` (or
    ``options.seed``) fixes every random draw: one seed gives one hall of
    fame. The other arguments are the JAX package's; those outside the
    plain-expression path, and such options, raise NotImplementedError
    naming the slice that brings them."""
    other_extra = {k: v for k, v in (extra or {}).items() if k not in ("class", "classes")}
    given = dict(y_variable_names=y_variable_names, X_units=X_units, y_units=y_units,
                 extra=other_extra or None, guesses=guesses, initial_population=initial_population,
                 saved_state=saved_state, resume=resume, runtime_options=runtime_options,
                 progress=progress or None, run_id=run_id, return_state=return_state or None,
                 dtype=None if dtype in (None, np.float32, torch.float32, "float32") else dtype)
    for name, value in given.items():
        if value is not None:
            raise NotImplementedError(
                f"equation_search({name}=...) is not in the PyTorch port yet; it comes "
                f"with {_LATER[name]} (ROADMAP.md queue 1).")
    options = options or Options()
    check_supported(options)
    if np.asarray(y).ndim != 1:
        raise NotImplementedError(
            "multi-output y is not in the PyTorch port yet; it comes with the "
            "search-API slice (ROADMAP.md queue 1)")
    dev = resolve_device(device)
    if seed is None:
        seed = options.seed
    if seed is None:
        if options.deterministic:
            raise ValueError("deterministic=True requires a seed (pass seed= or Options(seed=...))")
        seed = int(np.random.randint(0, 2**31 - 1))

    ds = make_dataset(X, y, weights=weights, variable_names=variable_names, extra=extra,
                      device=dev)
    if display_variable_names is not None:
        ds.display_variable_names = list(display_variable_names)
    ds.update_baseline_loss(options.elementwise_loss)
    n_params = n_classes = 0
    if isinstance(options.expression_spec, ParametricExpressionSpec):
        if ds.data.class_idx is None:
            raise ValueError("ParametricExpressionSpec requires a `class` column: pass "
                             "extra={'class': ...}")
        n_params, n_classes = options.expression_spec.max_parameters, ds.n_classes
    engine = Engine(options, ds.nfeatures, device=dev, n_params=n_params, n_classes=n_classes)
    if engine.template is not None and ds.nfeatures != engine.template.n_variables:
        raise ValueError(
            f"Template combiner consumes {engine.template.n_variables} variables but the "
            f"dataset has {ds.nfeatures} features")
    _, k_init = rng.split(rng.key(seed, device=dev), 2)
    state = engine.init_state(k_init, ds.data, options.populations)

    total_cycles = niterations * options.ncycles_per_iteration
    cycles_remaining = total_cycles
    start = time.time()
    hof = HallOfFame(entries=[])
    stop_reason = None
    it = 0
    while it < niterations and stop_reason is None:
        cur_maxsize = get_cur_maxsize(options.maxsize, options.warmup_maxsize_by,
                                      total_cycles, cycles_remaining)
        state = engine.run_iteration(state, ds.data, cur_maxsize)
        cycles_remaining -= options.ncycles_per_iteration
        it += 1
        hof = HallOfFame.from_device(state.hof, options.operators, template=engine.template)
        if options.early_stop_condition is not None and any(
                options.early_stop_condition(e.loss, e.complexity) for e in hof.entries):
            stop_reason = "early_stop_condition"
        elif (options.timeout_in_seconds is not None
              and time.time() - start > options.timeout_in_seconds):
            stop_reason = "timeout"
        elif options.max_evals is not None and float(state.num_evals) >= options.max_evals:
            stop_reason = "max_evals"

    verbosity = options.verbosity if verbosity is None else verbosity
    if verbosity is not None and verbosity >= 1:
        print(string_dominating_pareto_curve(hof, options.operators,
                                             variable_names=ds.display_variable_names,
                                             loss_scale=options.loss_scale))
        if stop_reason:
            print(f"Search stopped early: {stop_reason}")
    return hof
