"""`equation_search`: the search API and its host loop on one device.

Port of ``symbolicregression_jl_tpu/api/search.py`` for plain,
parametric (``Options(expression_spec=ParametricExpressionSpec(...))``
with ``extra={"class": ...}``) and template expressions
(``Options(expression_spec=TemplateExpressionSpec(...))``, parameter
vectors included), one or several outputs, on one device. The loop runs
`Engine.run_iteration` for every output ``niterations`` times with the
maxsize warm-up, decodes the halls of fame after each iteration, writes
their CSVs and a rolling checkpoint every ``checkpoint_every_n``
iterations (``save_to_file``), and stops early on ``timeout_in_seconds``,
``max_evals``, ``early_stop_condition`` or ``RuntimeOptions.stop_hook``,
all checked at iteration boundaries.

Warm starts: ``guesses`` (per output where nested; an ``(expression,
params)`` pair carries a fitted parameter bank) replace island 0's worst
members and enter the hall of fame at once; ``initial_population`` tiles
its expressions over every island's members; ``saved_state`` (a
``SearchState`` or a checkpoint path) runs ``niterations`` more
iterations; ``resume="auto"`` or ``resume=<path>`` continues the newest
valid checkpoint to ``niterations`` in total, so a killed and resumed
search ends bit-identical to one that ran through.
"""

from __future__ import annotations

import dataclasses
import os
import time
import uuid
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.dataset import Dataset, make_dataset
from ..core.options import OBSERVABILITY_SLICE, PLUGIN_SLICE, SEARCH_API_REST, Options, \
    check_supported
from ..device import resolve_device
from ..evolve import rng
from ..evolve.engine import Engine, SearchDeviceState
from ..evolve.population import init_params
from ..evolve.step import update_hof
from ..models.spec import ParametricExpressionSpec
from ..ops.encoding import TreeBatch, encode_population
from ..ops.tree import Node, parse_expression
from .checkpoint import map_arrays
from .hall_of_fame import HallOfFame, save_hall_of_fame_csv, string_dominating_pareto_curve

__all__ = ["RuntimeOptions", "SearchState", "equation_search", "get_cur_maxsize", "warmup"]

MULTI_DEVICE_SLICE = "the multi-device slice (ROADMAP.md queue 1 item 9)"
SERVING_SLICE = "the serving-stack slice (ROADMAP.md queue 1 item 7)"


def _default_run_id() -> str:
    """A timestamp and a random suffix."""
    return f"{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:6]}"


@dataclasses.dataclass
class RuntimeOptions:
    """Execution (not search) parameters, with the JAX package's names
    and defaults. The port runs on one device (``equation_search``'s
    ``device``); a field that asks for a subsystem of a later slice
    (devices and meshes, the logger, the engine cache, trace contexts,
    profiler captures, the capacity gauge, an input stream) raises
    NotImplementedError naming that slice when it leaves its default."""

    niterations: int = 40
    devices: Optional[Sequence] = None
    n_data_shards: int = 1
    mesh_runtime: bool = False
    mesh_dedup: bool = True
    mesh_exchange_every: int = 8
    verbosity: int = 1
    progress: bool = False
    run_id: str = dataclasses.field(default_factory=_default_run_id)
    return_state: bool = False
    seed: Optional[int] = None
    logger: Optional[Any] = None
    log_every_n: int = 1
    input_stream: Optional[Any] = None
    # Full-state checkpoint cadence (iterations) when save_to_file is on;
    # the final or stopping iteration always checkpoints.
    checkpoint_every_n: int = 5
    # Polled once per iteration, at the boundary: a string it returns
    # stops the search with that stop reason, after a state an
    # uninterrupted run also reaches (so resume stays bit-identical).
    stop_hook: Optional[Callable[[], Optional[str]]] = None
    engine_cache: Optional[Any] = None
    pulse: bool = True
    pulse_ring: int = 32
    pulse_trace_on: bool = False
    pulse_trace_iterations: int = 2
    pulse_trace_budget: int = 2
    trace: Optional[Any] = None
    ledger: bool = True
    gauge: bool = True
    gauge_footprint: bool = False
    gauge_headroom_fraction: Optional[float] = None
    gauge_limit_bytes: Optional[int] = None


# RuntimeOptions fields whose subsystems come with later slices: each
# must keep its default.
_RUNTIME_LATER = {
    "devices": (None, MULTI_DEVICE_SLICE),
    "n_data_shards": (1, MULTI_DEVICE_SLICE),
    "mesh_runtime": (False, MULTI_DEVICE_SLICE),
    "mesh_dedup": (True, MULTI_DEVICE_SLICE),
    "mesh_exchange_every": (8, MULTI_DEVICE_SLICE),
    "progress": (False, OBSERVABILITY_SLICE),
    "logger": (None, OBSERVABILITY_SLICE),
    "input_stream": (None, OBSERVABILITY_SLICE),
    "engine_cache": (None, SERVING_SLICE),
    "trace": (None, SERVING_SLICE),
    "pulse_trace_on": (False, SERVING_SLICE),
    "gauge_footprint": (False, SERVING_SLICE),
    "gauge_headroom_fraction": (None, SERVING_SLICE),
    "gauge_limit_bytes": (None, SERVING_SLICE),
}


def _check_runtime_options(ropt: RuntimeOptions) -> None:
    for name, (default, where) in _RUNTIME_LATER.items():
        if getattr(ropt, name) != default:
            raise NotImplementedError(
                f"RuntimeOptions({name}={getattr(ropt, name)!r}) is not in the PyTorch port "
                f"yet; it comes with {where}.")


@dataclasses.dataclass
class SearchState:
    """Search state for warm starts and resume (``return_state=True``).

    ``num_evals`` is the total over every earlier run; the device
    states' own counters restart at 0 when the state is resumed.
    ``nfeatures`` holds each output's feature count (trees index features
    by position). ``iterations_done`` is what ``resume`` continues from."""

    device_states: List[SearchDeviceState]  # one per output
    hofs: List[HallOfFame]
    options: Options
    num_evals: float = 0.0
    nfeatures: Optional[List[int]] = None
    iterations_done: int = 0


def _on_device(state: SearchDeviceState, dev: torch.device) -> SearchDeviceState:
    return map_arrays(state, lambda t: torch.as_tensor(t).to(dev))


def _resolve_datasets(X, y, weights, variable_names, display_variable_names,
                      y_variable_names, extra, device) -> List[Dataset]:
    """One Dataset per output. ``X`` may be a Dataset or a list of them;
    else ``y`` is [n] or [nout, n]."""
    if isinstance(X, Dataset):
        return [X]
    if isinstance(X, (list, tuple)) and X and isinstance(X[0], Dataset):
        return list(X)
    y_arr = np.asarray(y)
    ys = y_arr if y_arr.ndim == 2 else y_arr[None, :]
    nout = ys.shape[0]
    datasets = []
    for j in range(nout):
        if y_variable_names is None:
            y_name = "y" if nout == 1 else f"y{j + 1}"
        elif isinstance(y_variable_names, str):
            y_name = y_variable_names
        else:
            y_name = y_variable_names[j]
        datasets.append(make_dataset(
            X, ys[j], weights=weights, variable_names=variable_names,
            display_variable_names=display_variable_names, y_variable_name=y_name,
            extra=extra, index=j + 1, device=device))
    return datasets


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


# ---------------------------------------------------------------------------
# Guesses and initial populations
# ---------------------------------------------------------------------------


def _parse_guess(guess, operators, variable_names) -> Node:
    if isinstance(guess, Node):
        return guess
    return parse_expression(str(guess), operators, variable_names=variable_names)


def _encode_template_seeds(engine: Engine, items, operators
                           ) -> Tuple[Optional[TreeBatch], List[Optional[np.ndarray]]]:
    """Template guesses (HostTemplateExpression, ``'f = ...; g = ...'``
    strings or ``{key: expr}`` dicts) as an [n, K, L] TreeBatch and each
    seed's parameter vector."""
    from ..models.template import (HostTemplateExpression, parse_template_expression,
                                   template_from_dict)

    st = engine.template
    if not items:
        return None, []
    encs, params = [], []
    for expr, gp in items:
        if isinstance(expr, HostTemplateExpression):
            h = expr
        elif isinstance(expr, str):
            h = parse_template_expression(expr, st, operators)
        elif isinstance(expr, dict):
            h = template_from_dict(expr, st, operators)
        else:
            raise TypeError(f"Template guess must be a template string, dict, or "
                            f"HostTemplateExpression; got {type(expr).__name__}")
        encs.append(h.encode(engine.cfg.max_nodes, device=engine.device))
        params.append(gp if gp is not None else h.params)
    return TreeBatch(*(torch.stack(f) for f in zip(*(e.fields() for e in encs)))), params


def _seed_population(engine: Engine, state: SearchDeviceState, trees: Sequence[Node], data,
                     mode: str, params: Optional[Sequence[Optional[np.ndarray]]] = None,
                     encoded: Optional[TreeBatch] = None) -> SearchDeviceState:
    """Put host trees into the device population, scored on every row.

    ``mode="replace_worst"`` (guesses) replaces island 0's worst members
    with the seeds, which also enter the hall of fame at once;
    ``mode="tile"`` (initial_population) tiles the seeds over every
    island's members. Seeds larger than maxsize are skipped with a
    warning. ``params`` are per-seed fitted banks (flat or (n_params,
    n_classes)); a seed without one gets a fresh normal bank, drawn after
    the state's key is split as the JAX package splits it. ``encoded``
    is an already encoded [n, K, L] batch (template members)."""
    if encoded is None and not trees:
        return state
    cfg = engine.cfg
    I = state.birth.shape[0]
    P = cfg.population_size
    if encoded is None:
        # Drop oversized seeds first, then cut to the islands x members
        # capacity, so a rejected seed never pushes a valid one out.
        kept, kept_params = [], []
        ps = list(params) if params is not None else None
        for i, t in enumerate(trees):
            if len(kept) >= I * P:
                break
            n = t.count_nodes()
            if n > cfg.max_nodes:
                warnings.warn(f"seed expression has {n} nodes > max_nodes={cfg.max_nodes} "
                              "(maxsize); skipping it")
                continue
            kept.append(t)
            if ps is not None:
                kept_params.append(ps[i] if i < len(ps) else None)
        if not kept:
            return state
        trees = kept
        if params is not None:
            params = kept_params
    enc = encoded if encoded is not None else encode_population(
        list(trees)[:I * P], cfg.max_nodes, cfg.operators, device=engine.device)
    n_seed = enc.length.shape[0]
    ks = rng.split(state.key, 2)
    state = dataclasses.replace(state, key=ks[1])
    seed_params = init_params(ks[0], (n_seed,), cfg.n_params, cfg.n_classes)
    if params is not None and cfg.n_params > 0:
        seed_params = seed_params.clone()
        for i, p in enumerate(list(params)[:n_seed]):
            if p is not None:
                seed_params[i] = torch.as_tensor(
                    np.asarray(p, np.float32).reshape(cfg.n_params, cfg.n_classes),
                    device=seed_params.device)
    cost, loss, cx = engine._eval(enc, seed_params, data, fuse_cost=cfg.fuse_cost)

    if mode == "replace_worst":
        # Guesses enter the hall of fame directly, so an exact seed is
        # kept even if evolution replaces it before a cycle records it.
        state = dataclasses.replace(state, hof=update_hof(state.hof, enc, cost, loss, cx,
                                                          cfg.maxsize, params=seed_params))
    pops = state.pops
    if mode == "tile":
        idx = torch.arange(I * P, device=engine.device) % n_seed

        def tile(seeded):
            return seeded[idx].reshape((I, P) + seeded.shape[1:])

        pops = dataclasses.replace(pops, trees=TreeBatch(*(tile(f) for f in enc.fields())),
                                   cost=tile(cost), loss=tile(loss), complexity=tile(cx),
                                   params=tile(seed_params))
    else:  # replace_worst on island 0
        k = min(n_seed, P)
        targets = torch.argsort(pops.cost[0], stable=True)[P - k:]   # best .. worst

        def put(dst, src):
            out = dst.clone()
            out[0, targets] = src[:k].to(out.dtype)
            return out

        pops = dataclasses.replace(
            pops, trees=TreeBatch(*(put(d, s) for d, s in zip(pops.trees.fields(),
                                                              enc.fields()))),
            cost=put(pops.cost, cost), loss=put(pops.loss, loss),
            complexity=put(pops.complexity, cx), params=put(pops.params, seed_params))
    return dataclasses.replace(state, pops=pops)


def _is_guess_pair(g) -> bool:
    """An ``(expression, fitted_params)`` guess, as
    ``load_hall_of_fame_csv(return_params=True)`` gives them."""
    from ..models.template import HostTemplateExpression

    return (isinstance(g, tuple) and len(g) == 2
            and isinstance(g[0], (str, Node, dict, HostTemplateExpression))
            and (g[1] is None or isinstance(g[1], (np.ndarray, list))))


def _is_nested(guesses, nout: int) -> bool:
    """Per-output guess lists; a guess pair is never a nesting level."""
    return (nout > 1 and isinstance(guesses, (list, tuple)) and len(guesses) == nout
            and all(isinstance(g, (list, tuple)) and not _is_guess_pair(g) for g in guesses))


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


def _output_base(options: Options) -> str:
    """Where CSVs and checkpoints go: ``output_directory``, else
    ``outputs``, or ``$TMPDIR/sr_outputs`` under
    ``SYMBOLIC_REGRESSION_IS_TESTING``. ``resume="auto"`` searches here."""
    if options.output_directory:
        return options.output_directory
    if os.environ.get("SYMBOLIC_REGRESSION_IS_TESTING"):
        return os.path.join(os.environ.get("TMPDIR", "/tmp"), "sr_outputs")
    return "outputs"


def equation_search(X, y=None, *, options: Optional[Options] = None, niterations: int = 40,
                    weights=None, variable_names: Optional[Sequence[str]] = None,
                    display_variable_names: Optional[Sequence[str]] = None,
                    y_variable_names=None, X_units=None, y_units=None,
                    extra: Optional[Dict[str, Any]] = None, guesses: Optional[Sequence] = None,
                    initial_population: Optional[Sequence] = None,
                    saved_state: Optional[Union[SearchState, str]] = None,
                    resume: Optional[str] = None,
                    runtime_options: Optional[RuntimeOptions] = None,
                    verbosity: Optional[int] = None, progress: Optional[bool] = None,
                    run_id: Optional[str] = None, return_state: bool = False,
                    seed: Optional[int] = None, dtype=None,
                    device: Optional[Union[str, torch.device]] = None):
    """Run the symbolic-regression search on ``device`` (CUDA unless
    ``device="cpu"``).

    ``X`` (n, nfeatures) and ``y`` ((n,) or (nout, n)) are host arrays (or
    ``X`` a Dataset or a list of them). Returns the hall of fame (a list
    for several outputs), or ``(state, hall of fame)`` with
    ``return_state=True``. ``runtime_options`` (its ``niterations``
    replaces the argument) and the explicit ``verbosity``, ``run_id``,
    ``return_state`` and ``seed`` arguments, which override its fields,
    are the JAX package's. ``seed`` (or ``options.seed``) fixes every
    random draw. See the module docstring for warm starts and resume.
    Units, ``extra`` columns other than ``class``, ``dtype``,
    ``progress=True`` and the RuntimeOptions fields of later slices raise
    NotImplementedError naming their slice."""
    other_extra = {k: v for k, v in (extra or {}).items() if k not in ("class", "classes")}
    later = {"X_units": (X_units, PLUGIN_SLICE), "y_units": (y_units, PLUGIN_SLICE),
             "extra": (other_extra or None, PLUGIN_SLICE),
             "dtype": (None if dtype in (None, np.float32, torch.float32, "float32") else dtype,
                       SEARCH_API_REST)}
    for name, (value, where) in later.items():
        if value is not None:
            raise NotImplementedError(
                f"equation_search({name}=...) is not in the PyTorch port yet; it comes with "
                f"{where}.")
    options = options or Options()
    check_supported(options)
    # A copy: the caller's RuntimeOptions may serve several searches.
    ropt = (dataclasses.replace(runtime_options) if runtime_options is not None
            else RuntimeOptions(niterations=niterations))
    if verbosity is not None:
        ropt.verbosity = verbosity
    if progress is not None:
        ropt.progress = progress
    if run_id is not None:
        ropt.run_id = run_id
    if return_state:
        ropt.return_state = True
    if seed is not None:
        ropt.seed = seed
    elif ropt.seed is None:
        ropt.seed = options.seed
    _check_runtime_options(ropt)
    if options.deterministic and ropt.seed is None:
        raise ValueError("deterministic=True requires a seed (pass seed= or Options(seed=...))")
    if resume is not None and saved_state is not None:
        raise ValueError("pass either resume= or saved_state=, not both")
    dev = resolve_device(device)
    out_base = _output_base(options)

    if isinstance(saved_state, (str, os.PathLike)):
        from .checkpoint import load_search_state

        saved_state = load_search_state(os.fspath(saved_state), options, device=dev)
    # resume: the newest valid checkpoint (past corrupt ones) continues to
    # niterations in total.
    start_iter = 0
    if resume is not None:
        from ..shield.checkpoints import discover_resume_path, load_newest_valid

        search_base = out_base if resume == "auto" else os.fspath(resume)
        candidates = discover_resume_path(search_base, keep=max(8, options.checkpoint_keep))
        if candidates is None:
            if resume != "auto":
                raise FileNotFoundError(f"resume={resume!r}: no checkpoint found there")
            if ropt.verbosity >= 1:
                print(f"resume='auto': no checkpoint under {search_base}; starting fresh")
        else:
            saved_state, _ = load_newest_valid(candidates, options, device=dev)
            start_iter = int(saved_state.iterations_done)

    datasets = _resolve_datasets(X, y, weights, variable_names, display_variable_names,
                                 y_variable_names, extra, dev)
    for ds in datasets:
        ds.update_baseline_loss(options.elementwise_loss)
    key = rng.key(ropt.seed if ropt.seed is not None else np.random.randint(0, 2**31 - 1),
                  device=dev)
    out_dir = os.path.join(out_base, ropt.run_id) if options.save_to_file else None
    total_cycles = ropt.niterations * options.ncycles_per_iteration

    engines: List[Engine] = []
    states: List[SearchDeviceState] = []
    for j, ds in enumerate(datasets):
        n_params = n_classes = 0
        if isinstance(options.expression_spec, ParametricExpressionSpec):
            if ds.data.class_idx is None:
                raise ValueError("ParametricExpressionSpec requires a `class` column: pass "
                                 "extra={'class': ...}")
            n_params, n_classes = options.expression_spec.max_parameters, ds.n_classes
        engine = Engine(options, ds.nfeatures, device=dev, n_params=n_params,
                        n_classes=n_classes)
        template = engine.template
        if template is not None and ds.nfeatures != template.n_variables:
            raise ValueError(f"Template combiner consumes {template.n_variables} variables "
                             f"but the dataset has {ds.nfeatures} features")
        ks = rng.split(key, 2)
        key, k_init = ks[0], ks[1]
        if saved_state is not None and j < len(saved_state.device_states):
            issues = options.check_warm_start_compatibility(saved_state.options)
            if issues:
                raise ValueError(f"Warm start incompatible; changed options: {issues}")
            if saved_state.nfeatures is not None and saved_state.nfeatures[j] != ds.nfeatures:
                raise ValueError(
                    f"Warm start incompatible: saved state was fitted on "
                    f"{saved_state.nfeatures[j]} features but the dataset has {ds.nfeatures} "
                    "(trees index features positionally)")
            state = _on_device(saved_state.device_states[j], dev)
            # The saved counters are already in saved_state.num_evals.
            state = dataclasses.replace(state, num_evals=torch.zeros(
                (), dtype=torch.float32, device=dev))
            if n_classes and state.pops.params.shape[-1] != ds.n_classes:
                raise ValueError(
                    f"Warm start incompatible: saved parametric state has "
                    f"{state.pops.params.shape[-1]} classes but the dataset has {ds.n_classes}")
        else:
            state = engine.init_state(k_init, ds.data, options.populations)
            if initial_population:
                if template is not None:
                    enc, gparams = _encode_template_seeds(
                        engine, [(g, None) for g in initial_population], options.operators)
                    state = _seed_population(engine, state, [], ds.data, mode="tile",
                                             params=gparams, encoded=enc)
                else:
                    trees = [_parse_guess(g, options.operators, ds.variable_names)
                             for g in initial_population]
                    state = _seed_population(engine, state, trees, ds.data, mode="tile")
        if guesses is not None:
            gs = guesses[j] if _is_nested(guesses, len(datasets)) else guesses
            items = [g if _is_guess_pair(g) else (g, None) for g in gs]
            if template is not None:
                enc, gparams = _encode_template_seeds(engine, items, options.operators)
                state = _seed_population(engine, state, [], ds.data, mode="replace_worst",
                                         params=gparams, encoded=enc)
            else:
                trees = [_parse_guess(expr, options.operators, ds.variable_names)
                         for expr, _ in items]
                state = _seed_population(engine, state, trees, ds.data, mode="replace_worst",
                                         params=[gp for _, gp in items])
        engines.append(engine)
        states.append(state)

    hofs = [HallOfFame(entries=[]) for _ in datasets]
    if saved_state is not None:
        # A resume with nothing left to run still returns the saved halls.
        hofs = [HallOfFame.from_device(s.hof, options.operators, template=e.template)
                for s, e in zip(states, engines)]
    num_evals0 = saved_state.num_evals if saved_state is not None else 0.0
    ckpt = None
    if out_dir is not None:
        from ..shield.checkpoints import RollingCheckpointer

        ckpt = RollingCheckpointer(os.path.join(out_dir, "search_state.pkl"),
                                   keep=options.checkpoint_keep)

    def total_evals() -> float:
        return num_evals0 + sum(float(s.num_evals) for s in states)

    def checkpoint_state() -> SearchState:
        return SearchState(device_states=list(states), hofs=hofs, options=options,
                           num_evals=total_evals(), nfeatures=[ds.nfeatures for ds in datasets],
                           iterations_done=it)

    start_time = time.time()
    stop_reason = None
    cycles_remaining = total_cycles - start_iter * options.ncycles_per_iteration
    last_ckpt_it = -1
    it = start_iter
    while it < ropt.niterations and stop_reason is None:
        cur_maxsize = get_cur_maxsize(options.maxsize, options.warmup_maxsize_by,
                                      total_cycles, cycles_remaining)
        for j, (engine, ds) in enumerate(zip(engines, datasets)):
            states[j] = engine.run_iteration(states[j], ds.data, cur_maxsize)
        cycles_remaining -= options.ncycles_per_iteration
        it += 1
        if ropt.stop_hook is not None:
            hook_reason = ropt.stop_hook()
            if hook_reason:
                stop_reason = str(hook_reason)
        hofs = [HallOfFame.from_device(s.hof, options.operators, template=e.template)
                for s, e in zip(states, engines)]
        if out_dir is not None:
            for j, ds in enumerate(datasets):
                fname = ("hall_of_fame.csv" if len(datasets) == 1
                         else f"hall_of_fame_output{j + 1}.csv")
                save_hall_of_fame_csv(os.path.join(out_dir, fname), hofs[j], options.operators,
                                      variable_names=ds.variable_names)
            if it % ropt.checkpoint_every_n == 0:
                ckpt.save(checkpoint_state())
                last_ckpt_it = it
        if ropt.verbosity >= 2:
            best = min((e.loss for h in hofs for e in h.entries), default=np.inf)
            print(f"[iter {it}/{ropt.niterations}] best_loss={best:.6g} "
                  f"evals={total_evals():.3g}")
        if stop_reason is None and options.early_stop_condition is not None and any(
                options.early_stop_condition(e.loss, e.complexity)
                for h in hofs for e in h.entries):
            stop_reason = "early_stop_condition"
        if stop_reason is None and options.timeout_in_seconds is not None \
                and time.time() - start_time > options.timeout_in_seconds:
            stop_reason = "timeout"
        if stop_reason is None and options.max_evals is not None \
                and total_evals() >= options.max_evals:
            stop_reason = "max_evals"
    # The final or stopping state is always checkpointed, once; a resume
    # that ran nothing writes nothing (each save rotates a generation out).
    if ckpt is not None and it > start_iter and it != last_ckpt_it:
        ckpt.save(checkpoint_state())

    if ropt.verbosity >= 1:
        for j, (hof, ds) in enumerate(zip(hofs, datasets)):
            if len(datasets) > 1:
                print(f"Output {j + 1} ({ds.y_variable_name}):")
            print(string_dominating_pareto_curve(hof, options.operators,
                                                 variable_names=ds.display_variable_names,
                                                 loss_scale=options.loss_scale))
        if stop_reason:
            print(f"Search stopped early: {stop_reason}")
    result: Any = hofs if len(datasets) > 1 else hofs[0]
    if ropt.return_state:
        return checkpoint_state(), result
    return result


def warmup(options: Optional[Options] = None, *, nfeatures: int = 2, n_rows: int = 10_000,
           niterations: int = 4, dtype=None, seed: int = 0,
           device: Optional[Union[str, torch.device]] = None) -> None:
    """Run a short, quiet search at ``options``' shapes on random data and
    write nothing (``save_to_file`` off on a copy of the options). In the
    port this builds the CUDA kernels and warms PyTorch's allocator and
    caches before the first real fit; only shapes matter, not the data."""
    import copy

    options = copy.copy(options) if options is not None else Options()
    options.save_to_file = False
    gen = np.random.default_rng(seed)
    X = gen.uniform(-3.0, 3.0, (int(n_rows), int(nfeatures)))
    y = gen.uniform(-1.0, 1.0, (int(n_rows),))
    equation_search(X, y, options=options, niterations=niterations, verbosity=0,
                    progress=False, seed=seed, dtype=dtype, device=device)
