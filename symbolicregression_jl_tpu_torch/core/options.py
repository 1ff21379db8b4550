"""Search options: copy of ``symbolicregression_jl_tpu/core/options.py``.

`Options` carries every search hyperparameter with the same defaults and
the same validation errors as the JAX package. The PyTorch port runs
plain, parametric and template expressions, minibatching and graftstage;
:func:`check_supported` refuses, by name and with the ROADMAP item that
brings it, every option this port does not carry yet.
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from ..ops.operators import DEFAULT_BINARY, DEFAULT_UNARY, OperatorSet

__all__ = ["MutationWeights", "ComplexityMapping", "Options", "MUTATION_KINDS",
           "EvalGeometry", "KERNEL_TREE_BLOCK", "KERNEL_TILE_ROWS",
           "check_supported"]

# Candidate-eval kernel launch-geometry defaults (ops/fused_eval.py's
# fused_cost/fused_loss wrappers). These are THE defaults: every layer
# that needs resolved geometry goes through Options.eval_geometry()
# instead of re-spelling a `x if x is not None else N` fallback chain.
KERNEL_TREE_BLOCK = 8
KERNEL_TILE_ROWS = 16384


class EvalGeometry(NamedTuple):
    """Resolved candidate-eval kernel launch geometry.

    The single source of the kernel-geometry fallback (tree_block=8,
    tile_rows=16384): evolve/step.py, evolve/engine.py and the bench
    provenance all resolve unset Options knobs through
    :meth:`Options.eval_geometry` rather than forking their own
    `getattr(...) or default` chains."""

    tree_block: int = KERNEL_TREE_BLOCK
    tile_rows: int = KERNEL_TILE_ROWS


# Order matters: it defines the integer encoding of mutation kinds used on
# device (mirrors `fieldnames(MutationWeights)`,
# SymbolicRegression.jl src/MutationWeights.jl:103-120).
MUTATION_KINDS = (
    "mutate_constant",
    "mutate_operator",
    "mutate_feature",
    "swap_operands",
    "rotate_tree",
    "add_node",
    "insert_node",
    "delete_node",
    "simplify",
    "randomize",
    "do_nothing",
    "optimize",
    "form_connection",
    "break_connection",
)


@dataclasses.dataclass
class MutationWeights:
    """Relative frequencies of each mutation (src/MutationWeights.jl:103-118).

    Defaults are the v2 tuned values from `default_options()`
    (SymbolicRegression.jl src/Options.jl:1174-1188).
    """

    mutate_constant: float = 0.0346
    mutate_operator: float = 0.293
    mutate_feature: float = 0.1
    swap_operands: float = 0.198
    rotate_tree: float = 4.26
    add_node: float = 2.47
    insert_node: float = 0.0112
    delete_node: float = 0.870
    simplify: float = 0.00209
    randomize: float = 0.000502
    do_nothing: float = 0.273
    optimize: float = 0.0
    form_connection: float = 0.5
    break_connection: float = 0.1

    def as_vector(self) -> np.ndarray:
        return np.array([getattr(self, k) for k in MUTATION_KINDS], np.float64)

    @staticmethod
    def struct_defaults() -> "MutationWeights":
        """The struct-level defaults (src/MutationWeights.jl:103-118)."""
        return MutationWeights(
            mutate_constant=0.0353,
            mutate_operator=3.63,
            mutate_feature=0.1,
            swap_operands=0.00608,
            rotate_tree=1.42,
            add_node=0.0771,
            insert_node=2.44,
            delete_node=0.369,
            simplify=0.00148,
            randomize=0.00695,
            do_nothing=0.431,
            optimize=0.0,
            form_connection=0.5,
            break_connection=0.1,
        )


@dataclasses.dataclass
class ComplexityMapping:
    """Per-op / per-variable / per-constant complexity weights
    (src/OptionsStruct.jl:22-27). `use=False` => plain node count."""

    use: bool = False
    # op_complexities[arity] -> list of weights (1-based arity key)
    op_complexities: Dict[int, List[float]] = dataclasses.field(default_factory=dict)
    variable_complexity: Union[float, List[float]] = 1.0
    constant_complexity: float = 1.0


def _build_complexity_mapping(
    complexity_of_operators, complexity_of_constants, complexity_of_variables,
    operators: OperatorSet,
) -> ComplexityMapping:
    use = any(
        x is not None
        for x in (complexity_of_operators, complexity_of_constants, complexity_of_variables)
    )
    op_complexities = {
        d: [1.0] * len(ops) for d, ops in operators.ops.items()
    }
    if complexity_of_operators:
        for spec, w in dict(complexity_of_operators).items():
            found = False
            for d, ops in operators.ops.items():
                for i, op in enumerate(ops):
                    target_name = spec if isinstance(spec, str) else getattr(spec, "name", getattr(spec, "__name__", None))
                    if op.name == target_name or op.display == target_name:
                        op_complexities[d][i] = float(w)
                        found = True
            if not found:
                raise ValueError(f"complexity_of_operators key {spec!r} not in operator set")
    vc: Union[float, List[float]] = 1.0
    if complexity_of_variables is not None:
        if np.ndim(complexity_of_variables) > 0:
            vc = [float(v) for v in complexity_of_variables]
        else:
            vc = float(complexity_of_variables)
    cc = 1.0 if complexity_of_constants is None else float(complexity_of_constants)
    return ComplexityMapping(
        use=use, op_complexities=op_complexities, variable_complexity=vc,
        constant_complexity=cc,
    )


def _resolve_op_key(operators: OperatorSet, key) -> Tuple[int, int]:
    """Find (arity, index) for a constraint key (name or Op)."""
    name = key if isinstance(key, str) else getattr(key, "name", getattr(key, "__name__", None))
    from ..ops.operators import _ALIASES  # canonicalize "pow" -> "^" etc.

    name = _ALIASES.get(name, name)
    for d, ops in operators.ops.items():
        for i, op in enumerate(ops):
            if op.name == name or op.display == name:
                return d, i
    raise ValueError(f"Constraint key {key!r} not in operator set")


def _build_op_constraints(constraints, operators: OperatorSet) -> Dict[int, List[Tuple[int, ...]]]:
    """constraints: {op: int | tuple-per-arg}; -1 = unconstrained.

    Result: per arity, per op-index, a tuple of per-argument max subtree
    complexities (src/Options.jl:51-99).
    """
    out = {
        d: [tuple([-1] * d) for _ in ops] for d, ops in operators.ops.items()
    }
    if constraints:
        for key, val in dict(constraints).items():
            d, i = _resolve_op_key(operators, key)
            if isinstance(val, (int, float)):
                if d == 1:
                    out[d][i] = (int(val),)
                else:
                    raise ValueError(
                        f"Constraint for arity-{d} op {key!r} must be a tuple of {d} ints"
                    )
            else:
                tup = tuple(int(v) for v in val)
                if len(tup) != d:
                    raise ValueError(
                        f"Constraint tuple for {key!r} must have {d} entries, got {len(tup)}"
                    )
                out[d][i] = tup
    return out


def _build_nested_constraints(nested_constraints, operators: OperatorSet):
    """[(op, {inner_op: max_nestedness})] -> [(d,i,[(nd,ni,max)])]
    (src/Options.jl:101-180)."""
    if not nested_constraints:
        return []
    items = (
        nested_constraints.items()
        if isinstance(nested_constraints, dict)
        else nested_constraints
    )
    out = []
    for outer, inner_spec in items:
        d, i = _resolve_op_key(operators, outer)
        inner_items = (
            inner_spec.items() if isinstance(inner_spec, dict) else inner_spec
        )
        inners = []
        for inner, max_nest in inner_items:
            nd, ni = _resolve_op_key(operators, inner)
            inners.append((nd, ni, int(max_nest)))
        out.append((d, i, inners))
    return out


_V1_DEFAULTS = dict(  # default_options(v"0.24.5"), src/Options.jl:1112-1159
    maxsize=20, populations=15, population_size=33, ncycles_per_iteration=550,
    parsimony=0.0032, warmup_maxsize_by=0.0, adaptive_parsimony_scaling=20.0,
    crossover_probability=0.066, annealing=False, alpha=0.1,
    perturbation_factor=0.076, probability_negate_constant=0.01,
    tournament_selection_n=12, tournament_selection_p=0.86,
    fraction_replaced=0.00036, fraction_replaced_hof=0.035,
    fraction_replaced_guesses=0.001, topn=12, batching=False, batch_size=50,
    mutation_weights=dict(
        mutate_constant=0.048, mutate_operator=0.47, swap_operands=0.1,
        rotate_tree=0.0, add_node=0.79, insert_node=5.1, delete_node=1.7,
        simplify=0.0020, randomize=0.00023, do_nothing=0.21, optimize=0.0,
        form_connection=0.5, break_connection=0.1,
    ),
)

_V2_DEFAULTS = dict(  # default_options(), src/Options.jl:1161-1208
    maxsize=30, populations=31, population_size=27, ncycles_per_iteration=380,
    parsimony=0.0, warmup_maxsize_by=0.0, adaptive_parsimony_scaling=1040.0,
    crossover_probability=0.0259, annealing=True, alpha=3.17,
    perturbation_factor=0.129, probability_negate_constant=0.00743,
    tournament_selection_n=15, tournament_selection_p=0.982,
    fraction_replaced=0.00036, fraction_replaced_hof=0.0614,
    fraction_replaced_guesses=0.001, topn=12, batching=False, batch_size=50,
    mutation_weights=dict(
        mutate_constant=0.0346, mutate_operator=0.293, swap_operands=0.198,
        rotate_tree=4.26, add_node=2.47, insert_node=0.0112, delete_node=0.870,
        simplify=0.00209, randomize=0.000502, do_nothing=0.273, optimize=0.0,
        form_connection=0.5, break_connection=0.1,
    ),
)


class Options:
    """Search hyperparameters. Hashable by identity (static under jit)."""

    def __init__(
        self,
        *,
        defaults: Optional[str] = None,
        # 1. Search space
        binary_operators: Sequence = None,
        unary_operators: Sequence = None,
        operators: Optional[OperatorSet] = None,
        maxsize: Optional[int] = None,
        maxdepth: Optional[int] = None,
        expression_spec=None,
        # 2. Search size
        populations: Optional[int] = None,
        population_size: Optional[int] = None,
        ncycles_per_iteration: Optional[int] = None,
        # 3. Objective
        elementwise_loss: Union[str, Callable, None] = None,
        loss_function: Optional[Callable] = None,
        loss_function_expression: Optional[Callable] = None,
        loss_scale: str = "log",
        dimensional_constraint_penalty: Optional[float] = None,
        dimensionless_constants_only: bool = False,
        # 4. Complexity
        parsimony: Optional[float] = None,
        constraints=None,
        nested_constraints=None,
        complexity_of_operators=None,
        complexity_of_constants=None,
        complexity_of_variables=None,
        warmup_maxsize_by: Optional[float] = None,
        use_frequency: bool = True,
        use_frequency_in_tournament: bool = True,
        adaptive_parsimony_scaling: Optional[float] = None,
        should_simplify: Optional[bool] = None,
        # 5. Mutations
        mutation_weights: Union[MutationWeights, dict, None] = None,
        crossover_probability: Optional[float] = None,
        annealing: Optional[bool] = None,
        alpha: Optional[float] = None,
        perturbation_factor: Optional[float] = None,
        probability_negate_constant: Optional[float] = None,
        skip_mutation_failures: bool = True,
        # 6. Tournament
        tournament_selection_n: Optional[int] = None,
        tournament_selection_p: Optional[float] = None,
        # 7. Constant optimization
        optimizer_algorithm: str = "BFGS",
        optimizer_nrestarts: int = 2,
        optimizer_probability: float = 0.14,
        optimizer_iterations: Optional[int] = None,
        optimizer_f_calls_limit: Optional[int] = None,
        should_optimize_constants: bool = True,
        # bfloat16 line-search evals on the fused TPU path (step-size
        # selection only; accepted points re-verified at f32). Doubles
        # the variants-per-dispatch of the optimizer's dominant kernel,
        # but every step pays a bf16<->f32 relayout on v5e (bf16 (16,128)
        # vs f32 (8,128) tiling), which measured as a NET loss on the
        # bench — off by default; the f32 single-chunk line search
        # (fused_loss_multi's chunk planner) captures the dispatch
        # amortization without the conversions.
        optimizer_bf16_linesearch: bool = False,
        # 8. Migration
        migration: bool = True,
        hof_migration: bool = True,
        fraction_replaced: Optional[float] = None,
        fraction_replaced_hof: Optional[float] = None,
        fraction_replaced_guesses: Optional[float] = None,
        topn: Optional[int] = None,
        # 10. Stopping
        early_stop_condition: Union[float, Callable, None] = None,
        timeout_in_seconds: Optional[float] = None,
        max_evals: Optional[int] = None,
        # 11. Performance
        batching: Optional[bool] = None,
        batch_size: Optional[int] = None,
        turbo: Optional[bool] = None,  # None = auto: the CUDA kernel on a CUDA device
        # The JAX package's TPU kernel launch geometry (trees per block,
        # row-tile cap); kept so both packages take the same Options, and
        # not read by the CUDA kernel, which runs one tree per block over
        # all rows.
        eval_tree_block: Optional[int] = None,
        eval_tile_rows: Optional[int] = None,
        # Fuse the loss->cost epilogue (mean, validity->inf, baseline
        # normalization, parsimony penalty) into the candidate-eval
        # kernel. None = auto: on whenever turbo is on; False keeps the
        # post-kernel arithmetic.
        fuse_cost_epilogue: Optional[bool] = None,
        # graftstage (docs/PRECISION.md): the two engine modes that trade
        # exactness for throughput, both default OFF — the f32/full path
        # is bit-identical with them off.
        # `eval_precision`: "f32" (exact) or "bf16" (candidate evals run
        # the kernel's bfloat16 row tiles with an f32 reduction spine for
        # the loss/cost epilogue; quality-gated, not bit-exact).
        eval_precision: str = "f32",
        # Staged sample-then-rescore candidate evaluation: screen every
        # candidate on a deterministic strided row sample, then re-score
        # only the top `rescore_fraction` on the full dataset; candidates
        # outside the rescore set are rejected (parents kept), so
        # acceptance, HoF updates, and finalize consume only
        # fully-rescored costs. `staged_sample_rows` pins the sample
        # size; None derives it as `staged_sample_fraction` of the
        # dataset (floored at 64 rows, capped by eval_tile_rows — the
        # shield degrade ladder keeps that cap as it steps tiles down).
        staged_eval: bool = False,
        staged_sample_rows: Optional[int] = None,
        staged_sample_fraction: float = 0.125,
        rescore_fraction: float = 0.25,
        bumper: bool = False,  # accepted for API parity (no allocator to tune)
        autodiff_backend=None,  # accepted for API parity
        # 12. Determinism
        deterministic: bool = False,
        seed: Optional[int] = None,
        # 13. Monitoring
        verbosity: Optional[int] = None,
        print_precision: int = 5,
        progress: Optional[bool] = None,
        # graftscope telemetry (telemetry/ package, docs/OBSERVABILITY.md):
        # device-side counters ride the evolve scan carry (0 extra
        # dispatches/transfers/retraces in the hot loop) and the host hub
        # emits schema-versioned JSONL (`graftscope.v1`) merging them
        # with timings and jax.monitoring compile events. `telemetry`
        # turns the JSONL stream on; the counters themselves are
        # collected whenever it is set. `telemetry_file` is relative to
        # the run's output directory unless absolute;
        # `telemetry_interval` emits one `iteration` event per N
        # iterations (counters summed across the interval).
        telemetry: bool = False,
        telemetry_file: str = "telemetry.jsonl",
        telemetry_interval: int = 1,
        # Interactive 'q'-to-quit stdin watcher: engaged only when this
        # is True AND sys.stdin is a real TTY (or an explicit
        # RuntimeOptions.input_stream is injected). Headless/server
        # deployments (graftserve) set False so a long-lived process
        # never spawns a stdin-reading thread or flips terminal modes
        # per request (docs/SERVING.md).
        interactive_quit: bool = True,
        # graftshield fault tolerance (shield/ package, docs/ROBUSTNESS.md):
        # `shield` arms the whole supervision layer in equation_search —
        # SIGTERM/SIGINT → graceful stop + emergency checkpoint at the
        # next iteration boundary, transient-failure retries, and (when
        # island_quarantine is on) NaN-storm island reseeding. The
        # watchdog deadlines are opt-in per budget: `iteration_deadline`
        # bounds a warm device iteration, `compile_budget` bounds
        # compile-bearing dispatches (first use of a program); on expiry
        # the watchdog aborts with a thread-stack diagnostic dump
        # instead of hanging until an external timeout (rc=124).
        shield: bool = True,
        iteration_deadline: Optional[float] = None,
        compile_budget: Optional[float] = None,
        # Rolling checkpoint depth: search_state.pkl plus the previous
        # (checkpoint_keep - 1) generations, digest-verified; resume
        # falls back to the newest valid one on corruption.
        checkpoint_keep: int = 3,
        # Transient-failure policy: bounded exponential backoff
        # (retry_backoff * 2^k seconds, capped at 30) for max_retries
        # attempts, then eval-tile-rows degradation on OOM-shaped
        # failures, then raise.
        max_retries: int = 3,
        retry_backoff: float = 0.5,
        # Island quarantine: islands whose non-finite member fraction
        # reaches quarantine_invalid_fraction are reseeded from the hall
        # of fame in-graph. The 1.0 default only fires on a FULLY
        # collapsed island, so healthy searches are bit-identical with
        # the feature on or off until a genuine NaN storm hits.
        island_quarantine: bool = True,
        quarantine_invalid_fraction: float = 1.0,
        # Run the graftlint runtime auditor (lint/runtime.py
        # validate_programs) over every engine state: postfix-encoding
        # invariants are re-checked after init and after each iteration's
        # mutation/crossover/migration output. Debug tier — each check
        # pulls the population tables to host.
        debug_checks: bool = False,
        # 15. Export
        output_directory: Optional[str] = None,
        save_to_file: bool = True,
        use_recorder: bool = False,
        recorder_file: str = "recorder.json",
        # 1: accepted events + per-kind aggregate rejection counts;
        # >=2: every rejected candidate becomes its own event with its
        # reason (constraint / invalid / annealing), matching the
        # reference's per-mutation tmp_recorder detail
        # (src/RegularizedEvolution.jl:47-75, src/Mutate.jl:270-355).
        recorder_verbosity: int = 1,
        # TPU-specific extensions:
        eval_dtype: str = "float32",
        mutation_attempts: int = 5,  # speculative batch width (reference's
        # sequential retry cap is 10, src/Mutate.jl:201; expected successes
        # land in the first few, and each attempt costs real TPU time)
    ):
        d = _V2_DEFAULTS
        if defaults is not None:
            ver = tuple(int(p) for p in str(defaults).split(".")[:1])
            if ver and ver[0] < 1:
                d = _V1_DEFAULTS

        if operators is None:
            operators = OperatorSet(
                binary_operators=(
                    DEFAULT_BINARY if binary_operators is None else binary_operators
                ),
                unary_operators=(
                    DEFAULT_UNARY if unary_operators is None else unary_operators
                ),
            )
        self.operators = operators
        self.maxsize = int(maxsize if maxsize is not None else d["maxsize"])
        self.maxdepth = int(maxdepth if maxdepth is not None else self.maxsize)
        self.expression_spec = expression_spec
        self.populations = int(populations if populations is not None else d["populations"])
        self.population_size = int(
            population_size if population_size is not None else d["population_size"]
        )
        self.ncycles_per_iteration = int(
            ncycles_per_iteration
            if ncycles_per_iteration is not None
            else d["ncycles_per_iteration"]
        )
        from .losses import resolve_loss

        if sum(x is not None for x in (elementwise_loss, loss_function, loss_function_expression)) > 1:
            raise ValueError(
                "Specify at most one of elementwise_loss / loss_function / "
                "loss_function_expression"
            )
        self.elementwise_loss = resolve_loss(elementwise_loss)
        self.loss_function = loss_function
        self.loss_function_expression = loss_function_expression
        if loss_scale not in ("log", "linear"):
            raise ValueError("`loss_scale` must be 'log' or 'linear'")
        self.loss_scale = loss_scale
        self.dimensional_constraint_penalty = dimensional_constraint_penalty
        self.dimensionless_constants_only = bool(dimensionless_constants_only)

        self.parsimony = float(parsimony if parsimony is not None else d["parsimony"])
        self.constraints = constraints
        self.op_constraints = _build_op_constraints(constraints, operators)
        self.nested_constraints = _build_nested_constraints(nested_constraints, operators)
        self.complexity_mapping = _build_complexity_mapping(
            complexity_of_operators, complexity_of_constants, complexity_of_variables,
            operators,
        )
        self.warmup_maxsize_by = float(
            warmup_maxsize_by if warmup_maxsize_by is not None else d["warmup_maxsize_by"]
        )
        self.use_frequency = bool(use_frequency)
        self.use_frequency_in_tournament = bool(use_frequency_in_tournament)
        self.adaptive_parsimony_scaling = float(
            adaptive_parsimony_scaling
            if adaptive_parsimony_scaling is not None
            else d["adaptive_parsimony_scaling"]
        )
        if should_simplify is None:
            # src/Options.jl:813-821
            should_simplify = (
                loss_function is None
                and nested_constraints is None
                and constraints is None
            )
        self.should_simplify = bool(should_simplify)

        if mutation_weights is None:
            mutation_weights = MutationWeights(**d["mutation_weights"])
        elif isinstance(mutation_weights, dict):
            mutation_weights = MutationWeights(**mutation_weights)
        self.mutation_weights = mutation_weights
        self.crossover_probability = float(
            crossover_probability
            if crossover_probability is not None
            else d["crossover_probability"]
        )
        self.annealing = bool(annealing if annealing is not None else d["annealing"])
        self.alpha = float(alpha if alpha is not None else d["alpha"])
        self.perturbation_factor = float(
            perturbation_factor
            if perturbation_factor is not None
            else d["perturbation_factor"]
        )
        self.probability_negate_constant = float(
            probability_negate_constant
            if probability_negate_constant is not None
            else d["probability_negate_constant"]
        )
        self.skip_mutation_failures = bool(skip_mutation_failures)

        self.tournament_selection_n = int(
            tournament_selection_n
            if tournament_selection_n is not None
            else d["tournament_selection_n"]
        )
        self.tournament_selection_p = float(
            tournament_selection_p
            if tournament_selection_p is not None
            else d["tournament_selection_p"]
        )

        self.optimizer_algorithm = optimizer_algorithm
        self.optimizer_nrestarts = int(optimizer_nrestarts)
        self.optimizer_bf16_linesearch = bool(optimizer_bf16_linesearch)
        self.optimizer_probability = float(optimizer_probability)
        self.optimizer_iterations = int(
            optimizer_iterations if optimizer_iterations is not None else 8
        )
        self.optimizer_f_calls_limit = int(
            optimizer_f_calls_limit if optimizer_f_calls_limit is not None else 10_000
        )
        self.should_optimize_constants = bool(should_optimize_constants)

        self.migration = bool(migration)
        self.hof_migration = bool(hof_migration)
        self.fraction_replaced = float(
            fraction_replaced if fraction_replaced is not None else d["fraction_replaced"]
        )
        self.fraction_replaced_hof = float(
            fraction_replaced_hof
            if fraction_replaced_hof is not None
            else d["fraction_replaced_hof"]
        )
        self.fraction_replaced_guesses = float(
            fraction_replaced_guesses
            if fraction_replaced_guesses is not None
            else d["fraction_replaced_guesses"]
        )
        self.topn = int(topn if topn is not None else d["topn"])

        if isinstance(early_stop_condition, (int, float)):
            threshold = float(early_stop_condition)
            early_stop_condition = lambda loss, complexity: loss < threshold  # noqa: E731
        self.early_stop_condition = early_stop_condition
        self.timeout_in_seconds = timeout_in_seconds
        self.max_evals = max_evals

        self.batching = bool(batching if batching is not None else d["batching"])
        self.batch_size = int(batch_size if batch_size is not None else d["batch_size"])
        self.turbo = turbo  # tri-state: None=auto / True / False
        self.eval_tree_block = (
            None if eval_tree_block is None else int(eval_tree_block)
        )
        self.eval_tile_rows = (
            None if eval_tile_rows is None else int(eval_tile_rows)
        )
        self.fuse_cost_epilogue = fuse_cost_epilogue  # tri-state
        self.eval_precision = str(eval_precision)
        self.staged_eval = bool(staged_eval)
        self.staged_sample_rows = (
            None if staged_sample_rows is None else int(staged_sample_rows)
        )
        self.staged_sample_fraction = float(staged_sample_fraction)
        self.rescore_fraction = float(rescore_fraction)
        self.bumper = bool(bumper)
        self.autodiff_backend = autodiff_backend

        self.deterministic = bool(deterministic)
        self.seed = seed
        self.verbosity = verbosity
        self.telemetry = bool(telemetry)
        self.telemetry_file = str(telemetry_file)
        self.telemetry_interval = int(telemetry_interval)
        self.interactive_quit = bool(interactive_quit)
        self.shield = bool(shield)
        self.iteration_deadline = (
            None if iteration_deadline is None else float(iteration_deadline)
        )
        self.compile_budget = (
            None if compile_budget is None else float(compile_budget)
        )
        self.checkpoint_keep = int(checkpoint_keep)
        self.max_retries = int(max_retries)
        self.retry_backoff = float(retry_backoff)
        self.island_quarantine = bool(island_quarantine)
        self.quarantine_invalid_fraction = float(quarantine_invalid_fraction)
        self.debug_checks = bool(debug_checks)
        self.print_precision = int(print_precision)
        self.progress = progress
        self.output_directory = output_directory
        self.save_to_file = bool(save_to_file)
        self.use_recorder = bool(use_recorder)
        self.recorder_file = recorder_file
        self.recorder_verbosity = int(recorder_verbosity)

        self.eval_dtype = eval_dtype
        self.mutation_attempts = int(mutation_attempts)

        # Validation (src/Options.jl:823-826)
        if self.maxsize <= 3:
            raise ValueError("maxsize must be > 3")
        if self.warmup_maxsize_by < 0:
            raise ValueError("warmup_maxsize_by must be >= 0")
        if self.tournament_selection_n >= self.population_size:
            raise ValueError(
                "tournament_selection_n must be less than population_size"
            )
        if self.eval_tree_block is not None and self.eval_tree_block <= 0:
            raise ValueError("eval_tree_block must be positive")
        if self.eval_tile_rows is not None and self.eval_tile_rows <= 0:
            raise ValueError("eval_tile_rows must be positive")
        if self.eval_precision not in ("f32", "bf16"):
            raise ValueError('eval_precision must be "f32" or "bf16"')
        if (self.staged_sample_rows is not None
                and self.staged_sample_rows <= 0):
            raise ValueError("staged_sample_rows must be positive (or None)")
        if not (0.0 < self.staged_sample_fraction <= 1.0):
            raise ValueError("staged_sample_fraction must be in (0, 1]")
        if not (0.0 < self.rescore_fraction <= 1.0):
            raise ValueError("rescore_fraction must be in (0, 1]")
        if self.telemetry_interval < 1:
            raise ValueError("telemetry_interval must be >= 1")
        if self.checkpoint_keep < 1:
            raise ValueError("checkpoint_keep must be >= 1")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.retry_backoff < 0:
            raise ValueError("retry_backoff must be >= 0")
        if not (0.0 < self.quarantine_invalid_fraction <= 1.0):
            raise ValueError(
                "quarantine_invalid_fraction must be in (0, 1]"
            )
        for name in ("iteration_deadline", "compile_budget"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive (or None)")

    def eval_geometry(self) -> EvalGeometry:
        """Candidate-eval kernel launch geometry with the kernel defaults
        resolved — the one fallback chain for `eval_tree_block` /
        `eval_tile_rows` (see :class:`EvalGeometry`)."""
        return EvalGeometry(
            tree_block=(self.eval_tree_block
                        if self.eval_tree_block else KERNEL_TREE_BLOCK),
            tile_rows=(self.eval_tile_rows
                       if self.eval_tile_rows else KERNEL_TILE_ROWS),
        )

    @property
    def nops(self):
        return self.operators.nops

    @property
    def resolved_loss_function(self):
        """The custom whole-prediction loss hook, if any (loss_function
        takes precedence over loss_function_expression, matching the
        reference's dispatch order, src/LossFunctions.jl:139-159)."""
        return self.loss_function or self.loss_function_expression

    # Warm-start option compatibility (check_warm_start_compatibility,
    # SymbolicRegression.jl src/OptionsStruct.jl:314-336).
    _WARM_START_FIELDS = (
        "maxsize", "maxdepth", "loss_scale", "parsimony",
        "dimensional_constraint_penalty", "batching", "batch_size",
        "population_size", "populations", "expression_spec",
    )

    def check_warm_start_compatibility(self, other: "Options") -> List[str]:
        issues = []
        if self.operators != other.operators:
            issues.append("operators")
        for f in self._WARM_START_FIELDS:
            if getattr(self, f) != getattr(other, f):
                issues.append(f)
        return issues

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Options(maxsize={self.maxsize}, populations={self.populations}, "
            f"population_size={self.population_size}, "
            f"ncycles_per_iteration={self.ncycles_per_iteration}, "
            f"operators={self.operators})"
        )


def _refuse(what: str, where: str) -> None:
    raise NotImplementedError(
        f"{what} is not in the PyTorch port yet; it comes with {where}.")


# The slices that bring what the port still refuses, as ROADMAP.md queue 1
# numbers them.
SEARCH_API_REST = "the rest of the search-API slice (ROADMAP.md queue 1 item 3)"
PLUGIN_SLICE = "the expression-plugin slice (ROADMAP.md queue 1 item 4)"
OBSERVABILITY_SLICE = "the observability slice (ROADMAP.md queue 1 item 5)"


def _check_expression_spec(options: Options) -> None:
    """Plain, parametric and template expressions run (templates with
    parameter vectors too); a template with D(...) call sites runs without
    the constant optimizer."""
    from ..models.spec import ExpressionSpec, ParametricExpressionSpec, TemplateExpressionSpec

    spec = options.expression_spec
    if spec is None or type(spec) is ExpressionSpec or isinstance(spec, ParametricExpressionSpec):
        return
    if not isinstance(spec, TemplateExpressionSpec):
        _refuse(f"expression_spec of type {type(spec).__name__}", PLUGIN_SLICE)
    if spec.structure.uses_deriv and options.should_optimize_constants:
        _refuse("constant optimization of a template with D(...) call sites "
                "(should_optimize_constants=True; it needs second-order derivatives)",
                PLUGIN_SLICE)


def check_supported(options: Options) -> None:
    """Raise NotImplementedError for every option outside the
    elementwise-loss paths this port carries (plain, parametric and
    template expressions, minibatching, graftstage's staged and bf16
    evaluation), naming the ROADMAP item that brings it."""
    _check_expression_spec(options)
    if options.dimensional_constraint_penalty is not None:
        _refuse("dimensional_constraint_penalty (units)", PLUGIN_SLICE)
    if options.loss_function is not None or options.loss_function_expression is not None:
        _refuse("loss_function / loss_function_expression (custom "
                "whole-prediction losses)", SEARCH_API_REST)
    if options.telemetry:
        _refuse("telemetry=True", OBSERVABILITY_SLICE)
    if options.use_recorder:
        _refuse("use_recorder=True", OBSERVABILITY_SLICE)
    if str(options.eval_dtype) not in ("float32", "f32"):
        _refuse(f"eval_dtype={options.eval_dtype!r} (the kernels compute in float32)",
                SEARCH_API_REST)
