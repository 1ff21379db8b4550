"""`equation_search`: the search API and its host loop, on one device or
over the ranks of a ``torch.distributed`` group (the island mesh).

Port of ``symbolicregression_jl_tpu/api/search.py`` for plain,
parametric (``Options(expression_spec=ParametricExpressionSpec(...))``
with ``extra={"class": ...}``) and template expressions
(``Options(expression_spec=TemplateExpressionSpec(...))``, parameter
vectors included), one or several outputs. The loop runs
`Engine.run_iteration` for every output ``niterations`` times with the
maxsize warm-up, decodes the halls of fame after each iteration, writes
their CSVs and a rolling checkpoint every ``checkpoint_every_n``
iterations (``save_to_file``), and stops early on ``timeout_in_seconds``,
``max_evals`` or a 'q' on stdin (``user_quit``), checked between chunks
of an iteration's cycles and at its end, or on ``early_stop_condition``
or ``RuntimeOptions.stop_hook``, checked at iteration boundaries (the
serve layer's cancel and deadline wire, ``serve/server.py``).

Observability (``telemetry/``, ``utils/``): ``Options(telemetry=True)``
writes the graftscope JSONL stream (``telemetry_file`` in the run's
output directory) with the engine's device counters; ``use_recorder``
writes the genealogy record; ``RuntimeOptions.progress`` and ``logger``
are per-iteration sinks of the same hub. Each iteration is an
``sr:iteration`` range, and the host phases ``sr:host:*`` ranges, in a
``torch.profiler`` capture (and NVTX ranges on a CUDA device).

Warm starts: ``guesses`` (per output where nested; an ``(expression,
params)`` pair carries a fitted parameter bank) replace island 0's worst
members and enter the hall of fame at once; ``initial_population`` tiles
its expressions over every island's members; ``saved_state`` (a
``SearchState`` or a checkpoint path) runs ``niterations`` more
iterations; ``resume="auto"`` or ``resume=<path>`` continues the newest
valid checkpoint to ``niterations`` in total, so a killed and resumed
search ends bit-identical to one that ran through.

Diagnostics on by default, as in the JAX package, host-side and
bit-neutral (``RuntimeOptions(ledger=, pulse=, gauge=)``): the graftledger
cost account appended to ``<run_dir>/ledger.jsonl`` (``ledger/``); the
graftpulse flight recorder, which dumps ``<run_dir>/pulse_bundle.json`` on
a fault or an exception, the anomaly detector and, with
``pulse_trace_on``, an anomaly or SIGUSR2, ``torch.profiler`` windows
under ``<run_dir>/pulse_traces/`` (``pulse/``); graftgauge's memory
samples (``gauge`` events, with a telemetry stream or the opt-in
headroom degrader), dispatch-latency histogram and, with
``gauge_footprint``, one footprint probe iteration per engine
(``gauge/``). ``RuntimeOptions(engine_cache=)`` shares engines between
searches (``serve/cache.py``) and ``trace`` threads a served request's
trace context through.

graftshield (``shield/``, on with ``Options(shield=True)``, the default):
SIGTERM or SIGINT stops the search at the next iteration boundary with
``stop_reason="preempted"`` and an emergency checkpoint; each iteration
attempt runs under ``ShieldRunner`` (transient failures such as a CUDA
out-of-memory retry with backoff) and under the watchdog's deadline
(``iteration_deadline``, or ``compile_budget`` for the first iteration,
where the kernels build, and for re-attempts), which exits with code 124
and a thread dump; an island whose members are all non-finite is reseeded
from the hall of fame (``island_quarantine``). ``SR_FAULT_PLAN`` (or
``shield.faults.install``) injects faults for tests. Every fault and
recovery, and every corrupt checkpoint a resume passes over, is a
``fault`` record of the telemetry stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import sys
import time
import uuid
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.dataset import Dataset, DeviceData, make_dataset
from ..core.options import Options, check_supported, float_dtype
from ..device import resolve_device
from ..evolve import rng
from ..evolve.engine import Engine, SearchDeviceState
from ..evolve.population import init_params
from ..evolve.step import update_hof
from ..ledger.context import mint_run_trace
from ..ledger.ledger import CostLedger
from ..mesh.engine import MeshEngine, make_engine
from ..models.spec import ParametricExpressionSpec
from ..ops.encoding import TreeBatch, encode_population
from ..ops.tree import Node, parse_expression
from ..telemetry.hub import IterationContext, LoggerSink, ProgressSink, RecorderSink, Telemetry
from ..telemetry.spans import host_span, set_nvtx, set_span_observer, step_span
from ..utils.monitor import ResourceMonitor
from ..utils.progress import ProgressBar
from ..utils.recorder import Recorder
from ..utils.stdin_quit import StdinQuitWatcher
from .checkpoint import map_arrays
from .hall_of_fame import HallOfFame, save_hall_of_fame_csv, string_dominating_pareto_curve

__all__ = ["RuntimeOptions", "SearchState", "equation_search", "get_cur_maxsize", "warmup"]

_DEFAULT_RUN_ID_RE = re.compile(r"^\d{8}_\d{6}_[0-9a-f]{6}$")


def _default_run_id() -> str:
    """A timestamp and a random suffix."""
    return f"{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:6]}"


@dataclasses.dataclass
class RuntimeOptions:
    """Execution (not search) parameters, with the JAX package's names
    and defaults. ``devices`` are the ranks of the ``torch.distributed``
    group the search spreads over (None: the whole group; a process with
    no group is the single-device path), ``n_data_shards`` splits the
    dataset's rows over that many ranks of each island shard,
    ``mesh_runtime`` takes the mesh runtime (``mesh/engine.MeshEngine``)
    over the legacy one, with per-shard finalize dedup
    (``mesh_dedup``) and a dedup-key exchange every
    ``mesh_exchange_every`` iterations. ``progress`` draws a progress bar,
    ``logger`` (an ``SRLogger`` or anything with ``log_iteration``) is
    called every ``log_every_n`` iterations, and ``input_stream`` is
    watched for a 'q' that stops the search (``user_quit``)."""

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


def _mesh_plan(ropt: RuntimeOptions, options: Options):
    """The island mesh of this search, or None for the single-device path
    (no process group, no ``devices``, one data shard, the legacy runtime).
    The island-shard count is the largest divisor of ``populations`` that
    fits the ranks (spare ranks idle rather than resize the user's
    islands), as in the JAX package. Every rank of the process group
    makes the mesh's subgroups here."""
    from ..mesh.plan import MeshPlan
    from ..parallel import multihost

    grouped = multihost.is_initialized()
    if (not grouped and ropt.devices is None and ropt.n_data_shards == 1
            and not ropt.mesh_runtime):
        return None
    ranks = list(ropt.devices) if ropt.devices is not None else list(
        range(multihost.process_count()))
    bad = [r for r in ranks if isinstance(r, bool) or not isinstance(r, (int, np.integer))]
    if bad:
        raise ValueError(f"RuntimeOptions(devices=...) are ranks of the torch.distributed "
                         f"group (ints), not {bad!r}; a rank's device is its own")
    if not grouped and len(ranks) > 1:
        raise ValueError(
            f"RuntimeOptions(devices={ropt.devices!r}) names {len(ranks)} ranks but this process "
            "is in no torch.distributed group: call parallel.initialize_multihost first")
    max_shards = max(len(ranks) // ropt.n_data_shards, 1)
    n_island_shards = max(d for d in range(1, max_shards + 1) if options.populations % d == 0)
    plan = MeshPlan.build(ranks, n_island_shards=n_island_shards,
                          n_data_shards=ropt.n_data_shards, sharded_dedup=ropt.mesh_dedup,
                          dedup_exchange_every=max(int(ropt.mesh_exchange_every), 0))
    if ropt.mesh_runtime and ropt.n_data_shards != 1:
        raise ValueError(
            "mesh_runtime shards the island axis only; data-row sharding (n_data_shards > 1) "
            "stays on the legacy GSPMD path (docs/SCALING.md)")
    plan.mesh.groups()
    if not plan.mesh.contains():
        raise ValueError(
            f"rank {plan.mesh.rank} is not in the search's mesh (ranks {plan.mesh.ranks}: "
            f"{n_island_shards} island shard(s) of {options.populations} islands x "
            f"{ropt.n_data_shards} data shard(s))")
    return plan


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
    # A rank's block of a multi-process run, as its checkpoint holds it:
    # the device states hold that rank's islands (api/checkpoint.py).
    # None for a full state.
    placement: Optional[Dict[str, Any]] = None


def _on_device(state: SearchDeviceState, dev: torch.device) -> SearchDeviceState:
    return map_arrays(state, lambda t: torch.as_tensor(t).to(dev))


def _resolve_datasets(X, y, weights, variable_names, display_variable_names,
                      y_variable_names, extra, device, dtype=torch.float32, X_units=None,
                      y_units=None) -> List[Dataset]:
    """One Dataset per output, its data ``dtype``. ``X`` may be a Dataset or
    a list of them; else ``y`` is [n] or [nout, n]."""
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
            X_units=X_units,
            y_units=(y_units[j] if (y_units is not None and not isinstance(y_units, str))
                     else y_units),
            extra=extra, index=j + 1, device=device, dtype=dtype))
    return datasets


# Chunked iterations: the chunk count adapts toward this stop latency, up
# to _MAX_CHUNKS chunks an iteration.
_STOP_LATENCY_TARGET_S = 1.0
_MAX_CHUNKS = 16


def _chunk_sizes(nc: int, n_chunks: int) -> List[int]:
    """Chunk lengths summing to ``nc``, about ``n_chunks`` of them: equal
    lengths that divide ``nc`` (at most twice the requested count), else
    near-equal chunks (the JAX package's rule, which keeps its compiled
    chunk programs few; here it only sets where the budget is polled)."""
    target = max(nc // n_chunks, 1)
    length = next((d for d in range(target, nc + 1) if nc % d == 0), nc)
    if length <= 2 * target or n_chunks == 1:
        return [length] * (nc // length)
    base, rem = divmod(nc, n_chunks)
    sizes = [base + (1 if c < rem else 0) for c in range(n_chunks)]
    return [c for c in sizes if c > 0]


def _stdin_is_tty() -> bool:
    try:
        return sys.stdin is not None and sys.stdin.isatty()
    except (AttributeError, ValueError, OSError):
        return False


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


def _seed_batch(engine: Engine, key: torch.Tensor, capacity: int, trees: Sequence[Node],
                params: Optional[Sequence[Optional[np.ndarray]]] = None,
                encoded: Optional[TreeBatch] = None):
    """The seeds encoded, with their banks: ``(enc, seed_params, key)``,
    ``key`` being what the state's key becomes, or None without a seed.

    Seeds larger than maxsize are skipped with a warning, and at most
    ``capacity`` are kept. ``params`` are per-seed fitted banks (flat or
    (n_params, n_classes)); a seed without one gets a fresh normal bank,
    drawn after the state's ``key`` is split as the JAX package splits
    it. ``encoded`` is an already encoded [n, K, L] batch (template
    members)."""
    if encoded is None and not trees:
        return None
    cfg = engine.cfg
    I = capacity // cfg.population_size
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
            return None
        trees = kept
        if params is not None:
            params = kept_params
    enc = encoded if encoded is not None else encode_population(
        list(trees)[:I * P], cfg.max_nodes, cfg.operators, device=engine.device,
        dtype=engine.dtype)
    n_seed = enc.length.shape[0]
    ks = rng.split(key, 2)
    seed_params = init_params(ks[0], (n_seed,), cfg.n_params, cfg.n_classes, engine.dtype)
    if params is not None and cfg.n_params > 0:
        seed_params = seed_params.clone()
        for i, p in enumerate(list(params)[:n_seed]):
            if p is not None:
                seed_params[i] = torch.as_tensor(
                    np.asarray(p).reshape(cfg.n_params, cfg.n_classes),
                    dtype=seed_params.dtype, device=seed_params.device)
    return enc, seed_params, ks[1]


def _initial_state(engine: Engine, key: torch.Tensor, data, n_islands: int,
                   trees: Sequence[Node], params=None,
                   encoded: Optional[TreeBatch] = None) -> SearchDeviceState:
    """``engine.init_state`` with ``initial_population``'s seeds tiled
    over every island's members (``initial_trees``/``initial_params``),
    scored on every row; the random populations without a seed."""
    P = engine.cfg.population_size
    seeded = _seed_batch(engine, engine.state_key(key.to(engine.device)), n_islands * P,
                         trees, params=params, encoded=encoded)
    if seeded is None:
        return engine.init_state(key, data, n_islands)
    enc, seed_params, state_key = seeded
    idx = torch.arange(n_islands * P, device=engine.device) % enc.length.shape[0]

    def tile(seeded):
        return seeded[idx].reshape((n_islands, P) + seeded.shape[1:])

    state = engine.init_state(key, data, n_islands,
                              initial_trees=TreeBatch(*(tile(f) for f in enc.fields())),
                              initial_params=tile(seed_params))
    return dataclasses.replace(state, key=state_key)


def _seed_population(engine: Engine, state: SearchDeviceState, trees: Sequence[Node], data,
                     mode: str, params: Optional[Sequence[Optional[np.ndarray]]] = None,
                     encoded: Optional[TreeBatch] = None) -> SearchDeviceState:
    """Put host trees into the device population, scored on every row.

    ``mode="replace_worst"`` (guesses) replaces island 0's worst members
    with the seeds, which also enter the hall of fame at once;
    ``mode="tile"`` tiles the seeds over every island's members, as
    ``initial_population`` seeds a fresh state (``_initial_state``).
    ``_seed_batch`` says how the seeds are encoded."""
    cfg = engine.cfg
    I = state.birth.shape[0]
    P = cfg.population_size
    seeded = _seed_batch(engine, state.key, I * P, trees, params=params, encoded=encoded)
    if seeded is None:
        return state
    enc, seed_params, key = seeded
    n_seed = enc.length.shape[0]
    state = dataclasses.replace(state, key=key)
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
    ``dtype`` (float32, float64 or bfloat16; default ``options.eval_dtype``)
    is the data's, the constants', the costs' and the hall of fame's
    floating type: float64 runs the kernels' double forms; bfloat16 rounds
    the data to bf16 and keeps a float32 state, its losses rounded to bf16
    (kernels 1b and 2b's bf16-data forms). ``X_units`` (one unit spec per
    feature) and ``y_units`` (one per output, or one for all) turn on the
    dimensional analysis: a tree that violates them pays
    ``options.dimensional_constraint_penalty`` (1000 by default) on its
    cost. ``extra`` columns ride the Dataset (``class`` gives parametric
    expressions their classes).

    In a ``torch.distributed`` group (``parallel.initialize_multihost``)
    every rank calls this with the same arguments: the islands split over
    the ranks (``RuntimeOptions``' ``devices``, ``n_data_shards``,
    ``mesh_runtime``), rank 0 writes the CSVs and the telemetry, every
    rank writes its checkpoint block (``search_state.pkl.rank{k}``), and
    every rank returns the same hall of fame (and the full state with
    ``return_state``)."""
    options = options or Options()
    dev = resolve_device(device)
    check_supported(options, dev, dtype)
    fdtype = float_dtype(dtype if dtype is not None else options.eval_dtype)
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
    from ..parallel import multihost
    from ..parallel.collectives import first_of_ranks

    plan = _mesh_plan(ropt, options)
    if multihost.process_count() > 1 and _DEFAULT_RUN_ID_RE.match(ropt.run_id):
        # Every rank writes its checkpoint block into the same run
        # directory: a defaulted (random) run_id becomes a seed-derived one.
        if ropt.seed is None:
            raise ValueError("multi-process runs need an identity shared by every rank: pass "
                             "run_id= (the same on every rank) or a seed")
        ropt.run_id = f"multihost_seed{ropt.seed}"
    is_rank0 = multihost.process_index() == 0
    multi = plan is not None and plan.mesh.size > 1
    if options.deterministic and ropt.seed is None:
        raise ValueError("deterministic=True requires a seed (pass seed= or Options(seed=...))")
    if resume is not None and saved_state is not None:
        raise ValueError("pass either resume= or saved_state=, not both")
    out_base = _output_base(options)

    if isinstance(saved_state, (str, os.PathLike)):
        from .checkpoint import load_search_state

        saved_state = load_search_state(os.fspath(saved_state), options, device=dev)
    # resume: the newest valid checkpoint (past corrupt ones) continues to
    # niterations in total; the corrupt ones passed over and the file used
    # become fault records once the hub exists.
    start_iter = 0
    resume_events: List[Tuple[str, Dict[str, Any]]] = []
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
            corrupt_log: List[Tuple[str, str]] = []
            saved_state, used_path = load_newest_valid(candidates, options, device=dev,
                                                       corrupt_log=corrupt_log)
            start_iter = int(saved_state.iterations_done)
            resume_events = [("checkpoint_corrupt", {"path": bad, "error": err[:500]})
                             for bad, err in corrupt_log]
            resume_events.append(("resume", {"path": used_path, "iterations_done": start_iter}))

    datasets = _resolve_datasets(X, y, weights, variable_names, display_variable_names,
                                 y_variable_names, extra, dev, fdtype, X_units=X_units,
                                 y_units=y_units)
    for ds in datasets:
        ds.update_baseline_loss(options.elementwise_loss)
    key = rng.key(ropt.seed if ropt.seed is not None else np.random.randint(0, 2**31 - 1),
                  device=dev)
    out_dir = os.path.join(out_base, ropt.run_id) if options.save_to_file else None
    total_cycles = ropt.niterations * options.ncycles_per_iteration

    engines: List[Engine] = []
    states: List[SearchDeviceState] = []
    datas: List[DeviceData] = []
    for j, ds in enumerate(datasets):
        n_params = n_classes = 0
        if isinstance(options.expression_spec, ParametricExpressionSpec):
            if ds.data.class_idx is None:
                raise ValueError("ParametricExpressionSpec requires a `class` column: pass "
                                 "extra={'class': ...}")
            n_params, n_classes = options.expression_spec.max_parameters, ds.n_classes
        # graftserve's engine cache: an equivalent canonical config reuses
        # an earlier request's Engine; None (no cache, or an uncacheable
        # config) builds a fresh one.
        engine = None
        # bf16 data is held in float32; the engine is told it is bf16.
        edtype = fdtype if fdtype == torch.bfloat16 else ds.data.Xt.dtype
        if ropt.engine_cache is not None:
            engine = ropt.engine_cache.get_engine(
                options, nfeatures=ds.nfeatures, dtype=edtype, n_params=n_params,
                n_classes=n_classes, device=dev, rows=int(ds.data.y.shape[0]), plan=plan,
                mesh_runtime=ropt.mesh_runtime)
        if engine is None:
            engine = make_engine(options, ds.nfeatures, device=dev, n_params=n_params,
                                 n_classes=n_classes, dtype=edtype, plan=plan,
                                 mesh_runtime=ropt.mesh_runtime)
        # This rank's rows (all of them with one data shard).
        data = plan.place_data(ds.data) if plan is not None else ds.data
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
            if plan is not None:
                state = plan.place_state(state)   # the full saved state: this rank's block
        elif initial_population:
            # The seeds tiled over every island's members are the engine's
            # initial trees (each rank keeps its islands of them).
            if template is not None:
                enc, gparams = _encode_template_seeds(
                    engine, [(g, None) for g in initial_population], options.operators)
                state = _initial_state(engine, k_init, data, options.populations, [],
                                       params=gparams, encoded=enc)
            else:
                trees = [_parse_guess(g, options.operators, ds.variable_names)
                         for g in initial_population]
                state = _initial_state(engine, k_init, data, options.populations, trees)
        else:
            state = engine.init_state(k_init, data, options.populations)
        seeding = guesses is not None
        if plan is not None and seeding:
            # Seeds go into the full state, as the unsharded search seeds it.
            state = plan.gather_state(state)
        if guesses is not None:
            gs = guesses[j] if _is_nested(guesses, len(datasets)) else guesses
            items = [g if _is_guess_pair(g) else (g, None) for g in gs]
            if template is not None:
                enc, gparams = _encode_template_seeds(engine, items, options.operators)
                state = _seed_population(engine, state, [], data, mode="replace_worst",
                                         params=gparams, encoded=enc)
            else:
                trees = [_parse_guess(expr, options.operators, ds.variable_names)
                         for expr, _ in items]
                state = _seed_population(engine, state, trees, data, mode="replace_worst",
                                         params=[gp for _, gp in items])
        if plan is not None and seeding:
            state = plan.place_state(state)
        engines.append(engine)
        states.append(state)
        datas.append(data)

    hofs = [HallOfFame(entries=[]) for _ in datasets]
    if saved_state is not None:
        # A resume with nothing left to run still returns the saved halls.
        hofs = [HallOfFame.from_device(s.hof, options.operators, template=e.template)
                for s, e in zip(states, engines)]
    num_evals0 = saved_state.num_evals if saved_state is not None else 0.0
    ckpt = None
    # Only rank 0 of a multi-process run writes the CSVs, the telemetry
    # stream and the diagnostics (they would race on the same files);
    # every rank writes its checkpoint block.
    io_dir = out_dir if is_rank0 else None
    placement = None
    if multihost.process_count() > 1:
        placement = {"rank": multihost.process_index(),
                     "process_count": multihost.process_count(),
                     "island_index": plan.island_index, "data_index": plan.data_index,
                     "n_island_shards": plan.n_island_shards,
                     "n_data_shards": plan.n_data_shards, "n_islands": options.populations}
    if out_dir is not None:
        from ..shield.checkpoints import RollingCheckpointer

        ckpt = RollingCheckpointer(os.path.join(out_dir, "search_state.pkl"),
                                   keep=options.checkpoint_keep,
                                   rank=placement["rank"] if placement else None)

    def total_evals() -> float:
        return num_evals0 + sum(float(s.num_evals) for s in states)

    def checkpoint_state(full: bool = False) -> SearchState:
        """The search state: this rank's blocks (a checkpoint of a
        multi-process run), or with ``full`` the whole state (a collective
        under a mesh)."""
        dstates = list(states)
        if full and plan is not None:
            dstates = [plan.gather_state(s) for s in dstates]
        return SearchState(device_states=dstates, hofs=hofs, options=options,
                           num_evals=total_evals(), nfeatures=[ds.nfeatures for ds in datasets],
                           iterations_done=it, placement=None if full else placement)

    start_time = time.time()
    stop_reason = None
    cycles_remaining = total_cycles - start_iter * options.ncycles_per_iteration

    # ---- graftscope telemetry hub (telemetry/hub.py) ----
    # One object owns every per-iteration consumer (the SRLogger, the
    # genealogy Recorder, the ProgressBar) as registered sinks, plus the
    # schema-versioned JSONL stream when options.telemetry is set; every
    # event carries the search's trace: a child span of a served request's
    # journaled root TraceContext, else one minted from run_id.
    search_trace = (ropt.trace.child("search") if ropt.trace is not None
                    else mint_run_trace(ropt.run_id))
    hub = Telemetry(
        options, run_id=ropt.run_id, out_dir=io_dir, niterations=ropt.niterations,
        nout=len(datasets), backend=dev.type, trace=search_trace, stream=is_rank0,
        n_devices=plan.mesh.size if plan is not None else 1,
        engine_info=[{"output": j + 1, "turbo": bool(e.cfg.turbo),
                      "fuse_cost": bool(e.cfg.fuse_cost),
                      "collect_telemetry": bool(e.cfg.collect_telemetry),
                      "n_islands": int(options.populations),
                      "n_island_shards": int(e.n_island_shards),
                      "nfeatures": int(e.nfeatures),
                      "mesh_runtime": isinstance(e, MeshEngine)}
                     for j, e in enumerate(engines)])
    if options.use_recorder and is_rank0:
        rec_path = (os.path.join(io_dir, options.recorder_file) if io_dir is not None
                    else options.recorder_file)
        # stream_path caps recorder_verbosity>=2 memory: iteration event
        # batches spill to disk as they are assembled (utils/recorder.py).
        recorder = Recorder(options, stream_path=rec_path + ".stream")
        hub.add_sink(RecorderSink(recorder, [ds.variable_names for ds in datasets], rec_path))
    if ropt.logger is not None and is_rank0:
        hub.add_sink(LoggerSink(ropt.logger, every=ropt.log_every_n))
    if ropt.progress and is_rank0:
        hub.add_sink(ProgressSink(ProgressBar(ropt.niterations)))
    set_nvtx(dev.type == "cuda")

    # ---- graftpulse diagnostics (pulse/) ----
    # The flight recorder is a sink (the per-iteration ring) and a watcher
    # (a fault dumps the bundle, before a watchdog abort can end the
    # process); the anomaly detector arms the budgeted profiler capture.
    from ..pulse import AnomalyDetector, FlightRecorder, SignalArm, TraceCapture

    pulse_rec = pulse_cap = pulse_sig = pulse_det = None
    if ropt.pulse and is_rank0:
        pulse_rec = FlightRecorder(
            capacity=ropt.pulse_ring, run_id=ropt.run_id, hub=hub,
            path=os.path.join(io_dir, "pulse_bundle.json") if io_dir is not None else None)
        hub.add_sink(pulse_rec)
        hub.add_watcher(pulse_rec.on_event)
        if io_dir is not None:
            pulse_cap = TraceCapture(io_dir, hub=hub,
                                     window_iterations=ropt.pulse_trace_iterations,
                                     max_captures=ropt.pulse_trace_budget)
            if ropt.pulse_trace_on:
                pulse_cap.arm("option", 0)
            pulse_sig = SignalArm().install()
        pulse_det = AnomalyDetector(
            hub, on_anomaly=pulse_cap.arm if pulse_cap is not None else None,
            expected_rescore_fraction=(float(options.rescore_fraction)
                                       if options.staged_eval else None))
        hub.add_sink(pulse_det)

    # ---- graftledger cost account (ledger/ledger.py) ----
    # One account segment per search attempt, appended to
    # <run_dir>/ledger.jsonl: device and host seconds per iteration, kernel
    # load and build seconds, the host spans (this thread's observer only,
    # so concurrent serve tenants each see their own), checkpoint bytes.
    ledger_sink = None
    if ropt.ledger and is_rank0:
        ledger_sink = CostLedger(
            os.path.join(io_dir, "ledger.jsonl") if io_dir is not None else None,
            run_id=ropt.run_id, trace=search_trace, hub=hub)
        hub.add_sink(ledger_sink)
        set_span_observer(ledger_sink.note_phase)

    # ---- graftgauge capacity observability (gauge/) ----
    # The memory sampler arms only when something reads it (a telemetry
    # stream or the opt-in headroom degrader); the dispatch-latency
    # histogram is always on with gauge.
    from ..gauge import DispatchLatency, MemorySampler, ProactiveDegrader
    from ..gauge import global_latency as _gauge_global_latency

    gauge_sampler = gauge_lat = None
    if ropt.gauge and is_rank0:
        gauge_degrader = None
        if ropt.gauge_headroom_fraction is not None:
            def _degrade_all_engines():
                new_rows = None
                for e in engines:
                    r = e.degrade_eval_tile_rows()
                    if r is not None:
                        new_rows = r
                return new_rows

            gauge_degrader = ProactiveDegrader(
                _degrade_all_engines, headroom_fraction=ropt.gauge_headroom_fraction,
                limit_bytes=ropt.gauge_limit_bytes, hub=hub)
        if hub.path is not None or gauge_degrader is not None:
            gauge_sampler = MemorySampler(hub, detector=pulse_det, recorder=pulse_rec,
                                          degrader=gauge_degrader, device=dev)
            hub.add_sink(gauge_sampler)
        gauge_lat = DispatchLatency()
        if ropt.gauge_footprint:
            from ..gauge import probe_engine_iteration

            for j, (e, st, d) in enumerate(zip(engines, states, datas)):
                entry = probe_engine_iteration(e, st, d)
                if entry is not None:
                    hub.gauge("footprint", iteration=0, output=j + 1, **entry)
        if gauge_sampler is not None:
            if ledger_sink is not None:
                def _observe_span(name, seconds, _ledger=ledger_sink, _smp=gauge_sampler):
                    _ledger.note_phase(name, seconds)
                    _smp.note_phase(name, seconds)

                set_span_observer(_observe_span)
            else:
                set_span_observer(gauge_sampler.note_phase)

    # ---- graftshield supervision (shield/) ----
    # The guard turns SIGTERM/SIGINT into a stop at the next iteration
    # boundary, whose end-of-loop save is the emergency checkpoint; the
    # watchdog puts a deadline on each iteration attempt and its sync; the
    # runner retries transient failures and steps the engine down; the
    # quarantine reseeds NaN-collapsed islands.
    from ..shield.degrade import ShieldRunner
    from ..shield.faults import active_injector
    from ..shield.quarantine import IslandQuarantine
    from ..shield.signals import PreemptionGuard
    from ..shield.watchdog import Watchdog

    shield_on = bool(options.shield)
    rank_tag = "" if is_rank0 else f".rank{multihost.process_index()}"
    guard = PreemptionGuard()
    watchdog = runner = quarantine = injector = None
    if shield_on:
        watchdog = Watchdog(dump_path=(os.path.join(out_dir, f"watchdog_dump{rank_tag}.txt")
                                       if out_dir is not None else None), telemetry=hub)
        # Under a multi-rank mesh a retry on one rank would re-enter the
        # iteration's collectives alone: no retries there; the collectives'
        # timeout fails the run instead.
        runner = ShieldRunner(max_retries=0 if multi else options.max_retries,
                              backoff=options.retry_backoff, telemetry=hub)
        # The quarantine reseeds islands from one rank's view: single-process
        # runs only, as in the JAX package.
        if options.island_quarantine and multihost.process_count() == 1:
            quarantine = IslandQuarantine(threshold=options.quarantine_invalid_fraction,
                                          telemetry=hub)
        injector = active_injector(telemetry=hub)
    for kind, detail in resume_events:
        hub.fault(kind, iteration=start_iter, **detail)

    def _note_checkpoint_bytes(saved_path: Optional[str]) -> None:
        # graftledger: the bytes of each full-state checkpoint (wall: a
        # re-save after a resume makes the count schedule-dependent)
        if ledger_sink is None or not saved_path:
            return
        try:
            ledger_sink.note_checkpoint(os.path.getsize(saved_path))
        except OSError:
            pass

    last_ckpt_it = -1
    it = start_iter
    try:
        if shield_on:
            guard.install()
        # The stdin watcher engages only for an injected stream or an
        # interactive session (Options(interactive_quit=True) and a real
        # TTY); otherwise no thread reads stdin.
        if ropt.input_stream is not None:
            watcher = StdinQuitWatcher(ropt.input_stream, force=True)
        elif options.interactive_quit and _stdin_is_tty():
            watcher = StdinQuitWatcher()
        else:
            watcher = StdinQuitWatcher.disabled()

        def _budget_stop(pending_evals=None) -> Optional[str]:
            """The stop checks that also run between cycle chunks:
            ``pending_evals`` is a thunk for the evaluations of a partly
            run iteration, forced only when max_evals is set (it waits for
            the device). The stop hook is polled at the iteration boundary
            only, so a stop never truncates an iteration and the
            checkpointed state stays on the bit-identical resume="auto"
            trajectory."""
            if watcher.check():
                return "user_quit"
            if options.timeout_in_seconds is not None \
                    and time.time() - start_time > options.timeout_in_seconds:
                return "timeout"
            if options.max_evals is not None:
                pending = pending_evals() if pending_evals is not None else 0.0
                if total_evals() + pending >= options.max_evals:
                    return "max_evals"
            return None

        def _budget_hit(pending_evals=None) -> bool:
            nonlocal stop_reason
            if stop_reason is None:
                stop_reason = _budget_stop(pending_evals)
            return stop_reason is not None

        # Each iteration's cycles run in chunks with the budget polled
        # between them, so a timeout, max_evals or quit cannot overshoot
        # by a whole iteration (the reference checks once per dispatched
        # cycle batch). The chunk count adapts toward a stop latency of
        # about a second from the measured iteration time, in powers of
        # two; chunked and single-chunk iterations are bit-identical.
        # Under a mesh the cycles run in one chunk: a stop between chunks
        # would be one rank's decision inside the iteration's collectives.
        n_chunks = 1 if plan is not None else min(4, options.ncycles_per_iteration)
        monitor = ResourceMonitor()
        host_t0 = time.time()
        attempts = 0     # the current iteration's attempts, over every output

        def _phase():
            """The watchdog phase of one attempt or sync: "compile" (under
            compile_budget) on this process's first iteration, where the
            kernels build and load, and on any re-attempt; "iteration"
            (under iteration_deadline) otherwise. None budgets are
            unsupervised."""
            if watchdog is None:
                return contextlib.nullcontext()
            comp = it == start_iter or attempts > len(engines)
            return watchdog.phase("compile" if comp else "iteration",
                                  options.compile_budget if comp else options.iteration_deadline,
                                  iteration=it + 1)

        while it < ropt.niterations and stop_reason is None:
            cur_maxsize = get_cur_maxsize(options.maxsize, options.warmup_maxsize_by,
                                          total_cycles, cycles_remaining)
            dev_t0 = time.time()
            monitor_host = dev_t0 - host_t0  # bookkeeping since the last iteration
            sizes = _chunk_sizes(options.ncycles_per_iteration, n_chunks)
            iter_events = [None] * len(engines)
            attempts = 0
            # graftpulse capture boundary: an armed window opens before
            # this iteration's device work (SIGUSR2 arms here too; its
            # handler only set a flag).
            if pulse_cap is not None:
                if pulse_sig is not None and pulse_sig.consume():
                    pulse_cap.arm("sigusr2", it + 1)
                pulse_cap.maybe_start(it + 1)
            with step_span(it + 1, trace_id=search_trace.trace_id,
                           span_id=search_trace.span_id):
                for j, engine in enumerate(engines):
                    def attempt(j=j, engine=engine):
                        nonlocal attempts
                        attempts += 1
                        with _phase():
                            # inside the phase, so an injected hang meets the deadline
                            if injector is not None:
                                injector.on_dispatch(it + 1)
                            return engine.run_iteration(
                                states[j], datas[j], cur_maxsize,
                                chunk_sizes=sizes if len(sizes) > 1 else None,
                                should_stop=_budget_hit)

                    # graftgauge dispatch latency: the host time of the
                    # launch call (the blocking sync is timed below).
                    lat_t0 = time.perf_counter() if gauge_lat is not None else None
                    out = (runner.run(attempt, iteration=it + 1, engine=engine, output=j + 1)
                           if runner is not None else attempt())
                    if lat_t0 is not None:
                        lat_dt = time.perf_counter() - lat_t0
                        gauge_lat.observe(lat_dt)
                        _gauge_global_latency().observe(lat_dt)
                    if engine.cfg.record_events:
                        states[j], iter_events[j] = out
                    else:
                        states[j] = out
                hub.prefetch(states)
                if dev.type == "cuda":
                    with _phase():
                        torch.cuda.synchronize(dev)
            host_t0 = time.time()
            if it > start_iter and plan is None:   # the first builds kernels, warms caches
                target = (host_t0 - dev_t0) / _STOP_LATENCY_TARGET_S
                cap = min(options.ncycles_per_iteration, _MAX_CHUNKS)
                n_chunks = 1
                while n_chunks < cap and n_chunks * 2 <= target:
                    n_chunks *= 2
            monitor.record(host_t0 - dev_t0, monitor_host)
            monitor.check_and_warn(ropt.verbosity)
            cycles_remaining -= options.ncycles_per_iteration
            it += 1
            # The boundary's shield work: injected faults first (a poisoned
            # island must meet the quarantine's scan, as a real storm
            # would), then the quarantine, then the preemption flag.
            if injector is not None:
                states = injector.on_iteration_end(it, states)
            if quarantine is not None:
                for j, engine in enumerate(engines):
                    states[j] = quarantine.check_and_reseed(engine, states[j], iteration=it,
                                                            output=j + 1)
            if guard.requested and stop_reason is None:
                stop_reason = "preempted"
                hub.fault("preempt_signal", iteration=it, signal=guard.signal_name)
            if stop_reason is None and ropt.stop_hook is not None:
                hook_reason = ropt.stop_hook()
                if hook_reason:
                    stop_reason = str(hook_reason)
                    hub.fault("external_stop", iteration=it, reason=stop_reason)
            with host_span("hof_decode"):
                hofs = [HallOfFame.from_device(s.hof, options.operators, template=e.template)
                        for s, e in zip(states, engines)]
            with host_span("checkpoint"):
                if io_dir is not None:
                    for j, ds in enumerate(datasets):
                        fname = ("hall_of_fame.csv" if len(datasets) == 1
                                 else f"hall_of_fame_output{j + 1}.csv")
                        save_hall_of_fame_csv(os.path.join(io_dir, fname), hofs[j],
                                              options.operators,
                                              variable_names=ds.variable_names)
                if out_dir is not None and it % ropt.checkpoint_every_n == 0:
                    _note_checkpoint_bytes(ckpt.save(checkpoint_state()))
                    last_ckpt_it = it
            elapsed = time.time() - start_time
            best = min((e.loss for h in hofs for e in h.entries), default=np.inf)
            evals = total_evals()
            rate = evals / max(elapsed, 1e-9)
            hub.iteration(IterationContext(
                iteration=it, states=states, hofs=hofs, options=options, num_evals=evals,
                elapsed=elapsed, best_loss=best, evals_per_sec=rate,
                device_s=host_t0 - dev_t0, host_s=monitor_host,
                host_fraction=monitor.estimate_work_fraction(), events=iter_events))
            # Close a trace window once it has covered its iterations
            # (after hub.iteration, so it holds the sinks' spans too).
            if pulse_cap is not None:
                pulse_cap.maybe_stop(it)
            # graftmesh: the periodic cross-shard dedup-key exchange, as
            # telemetry ``mesh`` events. A collective, so every rank makes
            # it (the gate is the same on every rank); observability only,
            # it never touches the state.
            if (options.telemetry and plan is not None and plan.dedup_exchange_every > 0
                    and it % plan.dedup_exchange_every == 0):
                for j, engine in enumerate(engines):
                    if isinstance(engine, MeshEngine):
                        hub.mesh(iteration=it, shards=plan.n_island_shards, output=j + 1,
                                 **engine.dedup_exchange(states[j]))
            if ropt.verbosity >= 2:
                print(f"[iter {it}/{ropt.niterations}] best_loss={best:.6g} "
                      f"evals={evals:.3g} ({rate:.3g}/s, host "
                      f"{monitor.estimate_work_fraction():.0%})")
            if stop_reason is None and options.early_stop_condition is not None and any(
                    options.early_stop_condition(e.loss, e.complexity)
                    for h in hofs for e in h.entries):
                stop_reason = "early_stop_condition"
            if stop_reason is None:
                stop_reason = _budget_stop()
            if plan is not None:
                # Every rank stops where the first rank (in rank order) with
                # a reason stops: one rank's clock, signal or quit must not
                # leave the others in the next iteration's collectives.
                stop_reason = first_of_ranks(stop_reason, plan.mesh.all_group())
        watcher.stop()
        # The final or stopping state is always checkpointed, once; a
        # resume that ran nothing writes nothing (each save rotates a
        # generation out).
        if ckpt is not None and it > start_iter and it != last_ckpt_it:
            _note_checkpoint_bytes(ckpt.save(checkpoint_state()))
        if ckpt is not None and it > 0 and stop_reason == "preempted":
            hub.fault("emergency_checkpoint", iteration=it, path=ckpt.base,
                      iterations_done=it)
        # graftgauge's end-of-run records, before run_end: the memory
        # watermarks and the dispatch-latency histogram.
        if gauge_sampler is not None:
            gauge_sampler.emit_final(iteration=int(it))
        if gauge_lat is not None and gauge_lat.count:
            hub.gauge("dispatch_latency", iteration=int(it), **gauge_lat.to_detail())
        # Flush any partial telemetry interval, emit run_end, close sinks
        # (ProgressBar close, Recorder final state and write).
        hub.finish(stop_reason=stop_reason or "niterations", num_evals=total_evals(),
                   elapsed=time.time() - start_time)
    finally:
        # graftpulse teardown first, while the hub is open: dump the
        # flight recorder's ring when the search is leaving on an error
        # (a fault already dumped it), close any open trace window,
        # release SIGUSR2.
        exc_type = sys.exc_info()[0]
        if pulse_rec is not None and exc_type is not None:
            pulse_rec.dump(trigger={"reason": "exception", "kind": exc_type.__name__,
                                    "iteration": int(it)})
        if pulse_cap is not None:
            pulse_cap.close(int(it))
        if pulse_sig is not None:
            pulse_sig.uninstall()
        # A failing or interrupted search still releases the hub's
        # kernel-build listener (idempotent after a clean finish), the
        # signal handlers and the watchdog's thread.
        hub.close()
        set_nvtx(False)
        guard.uninstall()
        if watchdog is not None:
            watchdog.stop()
        if ledger_sink is not None or gauge_sampler is not None:
            # a serve worker thread runs searches back to back: the next
            # one must not bill its phases to this one's ledger
            set_span_observer(None)

    if ropt.verbosity >= 1 and is_rank0:
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
        return checkpoint_state(full=True), result
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
