"""The evolution step: tournaments, mutations, accepts, replacement.

Port of ``symbolicregression_jl_tpu/evolve/step.py`` for plain,
parametric and template expressions. Where the JAX package vmaps one island's step over
the island axis, every function here takes that axis explicitly:
population fields are ``[I, P, ...]`` (trees ``[I, P, L]``, or
``[I, P, K, L]`` for templates) and keys ``[I, 2]``. A template member
mutates one randomly chosen subexpression per slot, with that
subexpression's argument count for feature draws. Members with parameter
banks (``params`` [I, P, NP, NC]) carry them through every take,
mutation, crossover and replacement; ``mutate_constant`` scales one bank
row instead of a constant half the time. One generation step runs
the ``ceil(P / tournament_n)`` slots of every island in parallel from one
population snapshot; each slot makes up to two babies (a mutation, or
crossover's pair) that replace the oldest members. The speculative
``mutation_attempts`` batch takes the first attempt that passes the
constraints.

`s_r_cycle` runs ``ncycles`` steps over the annealing ramp and keeps the
best member seen per complexity; a chunk of an iteration's cycles runs
the same steps from a global cycle offset, so chunked and single-chunk
iterations are bit-identical.

With ``Options(telemetry=True)`` each step also counts what it did
(`telemetry.counters.step_telemetry`, from values it already computed),
and with ``use_recorder`` it emits `CycleEvents` for the genealogy
recorder; neither changes what the step computes.

graftstage (``docs/PRECISION.md``): ``eval_precision="bf16"`` scores
candidates on a bfloat16 value buffer (kernel 1b, or the interpreter's
bf16 mirror) with a float32 loss; ``staged_eval`` screens every candidate
on a strided sample of rows and rescores only each island's best
``rescore_fraction`` of them on every row, so only full-data costs reach
the population.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Union

import torch

from ..core.losses import aggregate_loss, kernel_loss, loss_from_pred, loss_to_cost
from ..core.options import KERNEL_TILE_ROWS, MUTATION_KINDS, Options, turbo_requested
from ..ops.complexity import ComplexityTables, check_constraints_batch, compute_complexity_batch
from ..ops.encoding import LEAF_CONST, LEAF_VAR, TreeBatch, select_tree, structure_from_arity
from ..ops.eval import eval_tree_batch
from ..ops.fused_eval import fused_cost, fused_loss, supports_fused_eval
from ..ops.operators import OperatorSet
from ..parallel.collectives import row_shard
from . import mutation as M
from . import rng
from .population import PopulationState
from .rng import USlice, u_bernoulli, u_categorical_weights, u_randint
from .tournament import tournament_select

__all__ = ["CycleEvents", "EvolveConfig", "HofState", "evolve_config_from_options",
           "eval_cost_batch",
           "generation_step", "empty_hof", "update_hof", "s_r_cycle", "take_members",
           "template_check_batch", "template_k", "MIN_SAMPLE_ROWS", "resolve_sample_rows",
           "rescore_count"]

_KIND = {name: i for i, name in enumerate(MUTATION_KINDS)}
_IMMEDIATE_KINDS = (_KIND["simplify"], _KIND["do_nothing"], _KIND["optimize"],
                    _KIND["form_connection"], _KIND["break_connection"])

# Clamp applied where the JAX package gathers float rows with a one-hot
# matmul (0 * inf would be NaN there): non-finite constants come back as
# +-3e38, and callers that must keep a NaN verdict track it separately.
_CLAMP = 3.0e38


class CycleEvents(NamedTuple):
    """Per-cycle genealogy events of every island, one entry per candidate
    baby [I, 2B] (the reference's per-mutation recorder stream), emitted
    from values the step already computed.

    ``kind`` is the sampled mutation-kind index; ``len(MUTATION_KINDS)``
    denotes crossover and -1 a phantom second row of a mutation slot.
    ``died_ref`` is the ref of the member the baby replaced (-1 when it
    replaced none). ``reject_reason``: 0 none, 1 constraint / no valid
    candidate, 2 non-finite cost, 3 annealing/frequency rejection; a
    kept-parent fallback row carries ``accepted`` and its reason."""

    kind: torch.Tensor           # int32 [I, 2B]
    parent_ref: torch.Tensor     # int32 [I, 2B]
    parent2_ref: torch.Tensor    # int32 [I, 2B]  (-1 unless crossover)
    child_ref: torch.Tensor      # int32 [I, 2B]
    died_ref: torch.Tensor       # int32 [I, 2B]
    accepted: torch.Tensor       # bool  [I, 2B]
    cost_delta: torch.Tensor     # f32   [I, 2B]  child cost - parent cost
    reject_reason: torch.Tensor  # int32 [I, 2B]


class EvolveConfig(NamedTuple):
    """Static engine configuration derived from Options."""

    operators: OperatorSet
    maxsize: int
    maxdepth: int
    max_nodes: int
    population_size: int
    tournament_n: int
    tournament_p: float
    crossover_probability: float
    annealing: bool
    alpha: float
    use_frequency: bool
    use_frequency_in_tournament: bool
    adaptive_parsimony_scaling: float
    parsimony: float
    skip_mutation_failures: bool
    should_simplify: bool
    attempts: int
    nfeatures: int
    perturbation_factor: float
    probability_negate_constant: float
    ncycles: int
    turbo: bool       # candidate and finalize evals through the interpreter kernels
    fuse_cost: bool   # the kernel's loss -> cost epilogue on candidate evals
    # Per-member parameter banks [NP, NC]: parametric expressions, or a
    # template's parameter vector as [total_params, 1]; 0 = none.
    n_params: int = 0
    n_classes: int = 0
    # Template expressions: the structure (combiner and per-key arities);
    # trees gain a key axis [..., K, L].
    template: "object" = None
    # graftstage (docs/PRECISION.md), all off by default: bf16 candidate
    # evaluations, and the staged screen on ``staged_sample_rows`` rows
    # (0: ``staged_sample_fraction`` of the data; see resolve_sample_rows)
    # followed by the full-data rescore of ``rescore_fraction`` of them.
    # ``eval_tile_rows`` is the resolved eval geometry; here it only caps
    # the screen's sample.
    eval_bf16: Union[bool, str] = False   # True: a bf16 value buffer; "data": bf16 data
    staged_eval: bool = False
    staged_sample_rows: int = 0
    staged_sample_fraction: float = 0.125
    rescore_fraction: float = 0.25
    eval_tile_rows: int = KERNEL_TILE_ROWS
    # Minibatching: each iteration's cycles and constant optimizer read
    # ``batch_size`` rows drawn once per iteration (the finalize reads all).
    batching: bool = False
    batch_size: int = 50
    # graftscope device counters (options.telemetry) and the recorder's
    # CycleEvents (options.use_recorder): both read what the step already
    # computed, so the search is bit-identical with them on or off.
    collect_telemetry: bool = False
    record_events: bool = False
    # The floating type of constants, costs and the bulk uniforms
    # (eval_dtype / equation_search(dtype=...)): float32, or float64 as the
    # JAX package runs under x64.
    dtype: torch.dtype = torch.float32
    # Dimensional analysis: the cost penalty for a unit violation (applied
    # only where the dataset carries units), and whether constants are
    # wildcards (off with ``dimensionless_constants_only``).
    dim_penalty: float = 1000.0
    wildcard_constants: bool = True

    @property
    def n_slots(self) -> int:
        return -(-self.population_size // self.tournament_n)

    @property
    def mctx(self) -> M.MutationContext:
        return M.MutationContext(
            nops=self.operators.nops_tuple(),
            nfeatures=self.nfeatures,
            max_nodes=self.max_nodes,
            perturbation_factor=self.perturbation_factor,
            probability_negate_constant=self.probability_negate_constant,
            # Template parameters live in the bank, not in tree leaves.
            n_params=0 if self.template is not None else self.n_params,
            dtype=self.dtype,
        )


def evolve_config_from_options(options: Options, nfeatures: int, device: torch.device,
                               n_params: int = 0, n_classes: int = 0,
                               template=None, dtype: torch.dtype = torch.float32) -> EvolveConfig:
    """``turbo`` defaults to on for a CUDA device and off on the CPU, and
    is off with a custom whole-prediction loss (the JAX package's eager
    path for it); ``core.options.check_supported`` has refused, up front,
    what turbo cannot run. A user elementwise callable runs with turbo on
    the user-loss route (``ops/fused_eval.py``: kernel #4's predictions and
    the callable), so it has no cost epilogue: kernel #1 never sees it."""
    turbo = turbo_requested(options, device) and options.resolved_loss_function is None
    turbo = turbo and supports_fused_eval(options.operators)
    return EvolveConfig(
        operators=options.operators,
        maxsize=options.maxsize,
        maxdepth=options.maxdepth,
        max_nodes=options.maxsize,
        population_size=options.population_size,
        tournament_n=options.tournament_selection_n,
        tournament_p=options.tournament_selection_p,
        crossover_probability=options.crossover_probability,
        annealing=options.annealing,
        alpha=options.alpha,
        use_frequency=options.use_frequency,
        use_frequency_in_tournament=options.use_frequency_in_tournament,
        adaptive_parsimony_scaling=options.adaptive_parsimony_scaling,
        parsimony=options.parsimony,
        skip_mutation_failures=options.skip_mutation_failures,
        should_simplify=options.should_simplify,
        attempts=options.mutation_attempts,
        nfeatures=nfeatures,
        perturbation_factor=options.perturbation_factor,
        probability_negate_constant=options.probability_negate_constant,
        ncycles=options.ncycles_per_iteration,
        turbo=turbo,
        fuse_cost=(turbo and options.fuse_cost_epilogue is not False
                   and kernel_loss(options.elementwise_loss) is not None),
        n_params=n_params,
        n_classes=n_classes,
        template=template,
        eval_bf16=options.eval_precision == "bf16",
        staged_eval=options.staged_eval,
        staged_sample_rows=options.staged_sample_rows or 0,
        staged_sample_fraction=options.staged_sample_fraction,
        rescore_fraction=options.rescore_fraction,
        eval_tile_rows=options.eval_geometry().tile_rows,
        batching=options.batching,
        batch_size=options.batch_size,
        collect_telemetry=bool(options.telemetry),
        record_events=bool(options.use_recorder),
        dtype=dtype,
        dim_penalty=(options.dimensional_constraint_penalty
                     if options.dimensional_constraint_penalty is not None
                     else 1000.0),  # src/LossFunctions.jl:236-245's default
        wildcard_constants=not options.dimensionless_constants_only,
    )


# ---------------------------------------------------------------------------
# Cost evaluation
# ---------------------------------------------------------------------------


def eval_cost_batch(trees: TreeBatch, data, elementwise_loss, tables: ComplexityTables,
                    operators: OperatorSet, parsimony: float, *, member_params=None,
                    turbo: bool = False, fuse_cost: bool = False, dedup: bool = False,
                    template=None, bf16: Union[bool, str] = False, loss_function=None,
                    dim_penalty: float = 1000.0, wildcard_constants: bool = True):
    """(cost, loss, complexity) per tree, any batch shape, on the rows of
    ``data``: the dataset, or a row subset of it such as graftstage's
    screening sample (``DeviceData.strided_sample``, whose baseline
    normalization is the full data's).

    ``turbo`` runs the interpreter kernel (ops/fused_eval.py); with
    ``fuse_cost`` (and not ``dedup``) the kernel's epilogue also computes
    the cost. A user elementwise callable with ``turbo`` (``fuse_cost``
    off) takes ``fused_loss``'s user-loss route, kernel #4's predictions
    and the callable, for candidates and the deduplicated finalize alike.
    Otherwise the eager interpreter (ops/eval.py) predicts and the loss
    and cost follow in PyTorch.

    ``member_params`` [..., NP, NC] are the members' parameter banks.
    Parametric members read theirs through the dataset's class column
    (``turbo``: the kernel's parametric form, with no cost epilogue;
    otherwise the interpreter on the banks gathered by class); without a
    class column they raise ValueError.

    With a ``template`` structure the members' trees are [..., K, L]: the
    combiner runs over the subexpressions (kernel #4 per call site with
    ``turbo``, its plain version otherwise) and reads the parameter vector
    ``member_params[..., :, 0]``, complexity is summed over K, and
    ``fuse_cost``/``dedup``/``bf16`` do not apply.

    ``bf16`` (``eval_precision="bf16"``) evaluates on a bfloat16 value
    buffer with a loss in the data's dtype (``"data"``, bf16 data from
    ``eval_dtype="bfloat16"``: the loss rounded to bf16 as well): kernel 1b
    with ``turbo`` (plain and
    parametric members; no dedup), else the interpreter on bf16 X and
    constants with the prediction cast back to float32 before the loss
    (plain members; parametric ones stay float32 there, as in the JAX
    package).

    ``loss_function`` is the custom whole-prediction loss
    (``Options.resolved_loss_function``): with it every member is
    predicted by the eager interpreter (or the template combiner) and
    the loss is ``loss_function(pred, y, w, valid)`` per tree, a NaN or
    an invalid tree giving inf (core/losses.loss_from_pred), as the JAX
    package's ``_loss_from_pred`` computes it; ``turbo`` is off for it.

    Where ``data`` carries units (``x_dims``), every plain or parametric
    tree gets the single-sample dimensional check on the full dataset's
    first row (ops/dims_eval.py; src/DimensionalAnalysis.jl:223-257 of the
    Julia reference) and ``dim_penalty`` times its violation added to its
    cost (src/LossFunctions.jl:236-245); templates are excluded, as in
    the JAX package.

    Under a data-row shard (``data.row_shard``) the rows are this rank's
    part of them, and every loss reduces over every shard's part."""
    with row_shard(getattr(data, "row_shard", None)):
        return _eval_cost_batch(trees, data, elementwise_loss, tables, operators, parsimony,
                                member_params, turbo, fuse_cost, dedup, template, bf16,
                                loss_function, dim_penalty, wildcard_constants)


def _eval_cost_batch(trees: TreeBatch, data, elementwise_loss, tables: ComplexityTables,
                     operators: OperatorSet, parsimony: float, member_params, turbo: bool,
                     fuse_cost: bool, dedup: bool, template, bf16: Union[bool, str],
                     loss_function, dim_penalty: float, wildcard_constants: bool):
    X, y, w = data.Xt, data.y, data.weights
    has_params = member_params is not None and member_params.shape[-2] > 0
    if template is not None:
        from ..models.template import eval_template_batch

        t_params = member_params[..., :, 0] if has_params else None
        # A named range for torch.profiler (bench/profile_iteration.py).
        with torch.profiler.record_function("sr:template_eval"):
            pred, valid = eval_template_batch(trees, X, template, operators, params=t_params,
                                              fused=turbo)
            loss = loss_from_pred(pred, valid, y, w, elementwise_loss, loss_function)
        complexity = compute_complexity_batch(trees, tables).sum(dim=-1).to(torch.int32)
        cost = loss_to_cost(loss, data.baseline_loss, data.use_baseline, complexity, parsimony)
        return cost, loss, complexity
    if has_params and data.class_idx is None:
        raise ValueError("Parametric evaluation requires a `class` column in the dataset")
    complexity = compute_complexity_batch(trees, tables)
    if loss_function is not None:
        prows = member_params[..., data.class_idx.long()] if has_params else None
        pred, valid = eval_tree_batch(trees, X, operators, params=prows)
        loss = loss_from_pred(pred, valid, y, w, elementwise_loss, loss_function)
        cost = loss_to_cost(loss, data.baseline_loss, data.use_baseline, complexity, parsimony)
        return _dims_penalty(cost, trees, data, operators, dim_penalty,
                             wildcard_constants), loss, complexity
    if turbo and fuse_cost and not dedup and not has_params:
        cost, loss, _ = fused_cost(
            trees, X, y, w, complexity, operators, elementwise_loss,
            baseline_loss=data.baseline_loss, use_baseline=data.use_baseline,
            parsimony=parsimony, bf16=bf16)
        return _dims_penalty(cost, trees, data, operators, dim_penalty,
                             wildcard_constants), loss, complexity
    if turbo and has_params:
        loss, _ = fused_loss(trees, X, y, w, operators, elementwise_loss, params=member_params,
                             class_idx=data.class_idx, bf16=bf16)
    elif turbo:
        loss, _ = fused_loss(trees, X, y, w, operators, elementwise_loss, dedup=dedup,
                             bf16=bf16)
    elif bf16 and not has_params:
        # The interpreter's mirror of kernel 1b: bf16 X and constants, the
        # prediction back in the data's dtype before the loss.
        trees_b = dataclasses.replace(trees, const=trees.const.to(torch.bfloat16))
        pred, valid = eval_tree_batch(trees_b, X.to(torch.bfloat16), operators)
        loss = aggregate_loss(elementwise_loss, pred.to(X.dtype), y, valid, w)
    else:
        prows = member_params[..., data.class_idx.long()] if has_params else None
        pred, valid = eval_tree_batch(trees, X, operators, params=prows)
        loss = aggregate_loss(elementwise_loss, pred, y, valid, w)
    if bf16 == "data" and not turbo:
        loss = loss.to(torch.bfloat16).to(loss.dtype)   # bf16 data: a bf16 loss
    cost = loss_to_cost(loss, data.baseline_loss, data.use_baseline, complexity, parsimony)
    return _dims_penalty(cost, trees, data, operators, dim_penalty,
                         wildcard_constants), loss, complexity


def _dims_penalty(cost, trees: TreeBatch, data, operators: OperatorSet, dim_penalty: float,
                  wildcard_constants: bool):
    """``cost + dim_penalty * violates`` where the data carries units, else
    ``cost``: the single-sample check on the full dataset's first row."""
    if data.x_dims is None:
        return cost
    from ..ops.dims_eval import N_DIMS, dimensional_violations_batch

    viol = dimensional_violations_batch(
        trees, data.dims_row, data.x_dims,
        (torch.zeros(N_DIMS, device=cost.device) if data.y_dims is None else data.y_dims),
        data.y_dims is not None, operators, wildcard_constants=wildcard_constants)
    return cost + torch.as_tensor(dim_penalty, dtype=cost.dtype, device=cost.device) * viol


# ---------------------------------------------------------------------------
# graftstage: staged sample-then-rescore evaluation (docs/PRECISION.md)
# ---------------------------------------------------------------------------

#: Floor of the screening sample: below it the screen's ranking is too
#: noisy to be worth a second launch.
MIN_SAMPLE_ROWS = 64


def resolve_sample_rows(cfg: EvolveConfig, n_rows: int) -> int:
    """The screen's sample size: ``staged_sample_rows`` when set, else
    ``ceil(staged_sample_fraction * n_rows)``; at least MIN_SAMPLE_ROWS,
    at most the dataset and ``eval_tile_rows``."""
    if cfg.staged_sample_rows > 0:
        k = int(cfg.staged_sample_rows)
    else:
        k = int(-(-n_rows * cfg.staged_sample_fraction // 1))
    k = max(MIN_SAMPLE_ROWS, k)
    k = min(k, int(n_rows))
    if cfg.eval_tile_rows:
        k = min(k, int(cfg.eval_tile_rows))
    return max(1, k)


def rescore_count(cfg: EvolveConfig, n_candidates: int) -> int:
    """Candidates promoted from the screen to the full-data rescore:
    ``ceil(rescore_fraction * N)``, at least 1."""
    r = int(-(-n_candidates * cfg.rescore_fraction // 1))
    return max(1, min(int(n_candidates), r))


# ---------------------------------------------------------------------------
# Row takes
# ---------------------------------------------------------------------------


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[i, idx[i, b], ...]`` for ``x`` [I, P, ...] and ``idx`` [I, B]."""
    idx = idx.long()
    shape = idx.shape + x.shape[2:]
    full = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, full)


def _take_floats(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a float field, clamped as the one-hot gather does."""
    return torch.nan_to_num(_take_rows(x, idx), nan=_CLAMP, posinf=_CLAMP, neginf=-_CLAMP)


def _take_trees(trees: TreeBatch, idx: torch.Tensor) -> TreeBatch:
    """Trees ``idx`` [I, B] of each island, constants clamped."""
    const = _take_floats(trees.const, idx)
    return TreeBatch(_take_rows(trees.arity, idx), _take_rows(trees.op, idx),
                     _take_rows(trees.feat, idx), const, _take_rows(trees.length, idx))


def take_members(pop: PopulationState, idx: torch.Tensor) -> PopulationState:
    """Members ``idx`` [I, B] of each island, with the JAX package's
    one-hot-gather semantics: non-finite constants and parameters come
    back clamped."""
    t = lambda x: _take_rows(x, idx)
    params = _take_floats(pop.params, idx) if pop.params.numel() else t(pop.params)
    return PopulationState(
        trees=_take_trees(pop.trees, idx), cost=t(pop.cost), loss=t(pop.loss),
        complexity=t(pop.complexity), birth=t(pop.birth), ref=t(pop.ref),
        parent=t(pop.parent), params=params)


def _stable_top(mask: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k(mask.astype(f32), k)`` indices: the True entries in
    order, then the False ones in order."""
    return torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)[..., :k]


# ---------------------------------------------------------------------------
# Mutation weights and speculative attempts
# ---------------------------------------------------------------------------


def _condition_weights(base_w: torch.Tensor, tree: TreeBatch, complexity, cur_maxsize,
                       cfg: EvolveConfig, nfeat_dyn=None) -> torch.Tensor:
    """condition_mutation_weights! for a batch of target trees: [..., kinds].
    ``nfeat_dyn`` (templates) is each target subexpression's argument
    count in place of the dataset's feature count."""
    L = cfg.max_nodes
    slot = torch.arange(L, device=tree.device)
    mask = slot < tree.length[..., None]
    root = (tree.length - 1).long()[..., None]
    root_arity = torch.gather(tree.arity, -1, root)[..., 0]
    root_op = torch.gather(tree.op, -1, root)[..., 0]
    root_is_leaf = root_arity == 0
    root_is_const = root_is_leaf & (root_op == LEAF_CONST)
    has_binary = (mask & (tree.arity == 2)).any(-1)
    n_const = (mask & (tree.arity == 0) & (tree.op == LEAF_CONST)).sum(-1)

    w = base_w.expand(*tree.length.shape, base_w.shape[0]).clone()

    def zero_where(name, cond):
        k = _KIND[name]
        w[..., k] = torch.where(cond, 0.0, w[..., k])

    for name in ("mutate_operator", "swap_operands", "delete_node", "simplify"):
        zero_where(name, root_is_leaf)
    zero_where("optimize", root_is_leaf & ~root_is_const)
    zero_where("mutate_constant", root_is_leaf & ~root_is_const)
    zero_where("mutate_feature", root_is_leaf & root_is_const)
    zero_where("swap_operands", ~has_binary)
    if cfg.n_params == 0 and cfg.template is None:  # parametric and template members skip
        # the constant-count scaling
        k = _KIND["mutate_constant"]
        w[..., k] = w[..., k] * torch.clamp(n_const, max=8).to(w.dtype) / 8.0
    if nfeat_dyn is not None:
        zero_where("mutate_feature", nfeat_dyn <= 1)
    elif cfg.nfeatures <= 1:
        w[..., _KIND["mutate_feature"]] = 0.0
    too_big = complexity >= cur_maxsize
    zero_where("add_node", too_big)
    zero_where("insert_node", too_big)
    w[..., _KIND["form_connection"]] = 0.0
    w[..., _KIND["break_connection"]] = 0.0
    return w


def _attempt_nu(cfg: EvolveConfig) -> int:
    return sum(M.branch_nu(cfg.mctx).values())


def _apply_kind(kind, u_all, tree: TreeBatch, temperature, cur_maxsize, cfg: EvolveConfig,
                structure, mctx=None):
    """Every mutation branch on a flat [N] batch, selected by ``kind``;
    ``mctx`` overrides ``cfg.mctx`` (templates pass per-row ``nfeatures``)."""
    mctx = mctx if mctx is not None else cfg.mctx
    budgets = M.branch_nu(mctx)
    s = USlice(u_all)
    branches = []

    def add(name, fn):
        branches.append((_KIND[name], fn(s.take(budgets[name]))))

    add("mutate_constant", lambda u: M.mutate_constant(u, tree, temperature, mctx))
    add("mutate_operator", lambda u: M.mutate_operator(u, tree, mctx))
    add("mutate_feature", lambda u: M.mutate_feature(u, tree, mctx))
    add("swap_operands", lambda u: M.swap_operands(u, tree, mctx, structure))
    add("rotate_tree", lambda u: M.rotate_tree(u, tree, mctx, structure))
    add("add_node", lambda u: M.add_node(u, tree, mctx, structure))
    add("insert_node", lambda u: M.insert_random_op(u, tree, mctx, structure))
    add("delete_node", lambda u: M.delete_node(u, tree, mctx, structure))
    add("randomize", lambda u: M.randomize_tree(u, tree, cur_maxsize, mctx))

    out_tree = tree
    out_ok = torch.ones_like(kind, dtype=torch.bool)
    for kid, (t, ok) in branches:
        hit = kind == kid
        out_tree = select_tree(hit, t, out_tree)
        out_ok = torch.where(hit, ok, out_ok)
    return out_tree, out_ok


def _first_valid(valid: torch.Tensor, stacked: TreeBatch, fallback: TreeBatch):
    """First attempt (last batch axis of ``valid``) with valid=True, else
    ``fallback``. A float field picked this way adds 0.0, as the JAX
    package's masked sum does."""
    any_valid = valid.any(-1)
    first = torch.argmax(valid.to(torch.int8), dim=-1)

    def pick(x):
        extra = x.dim() - valid.dim()
        idx = first.reshape(first.shape + (1,) * (extra + 1))
        idx = idx.expand(*first.shape, 1, *x.shape[valid.dim():])
        out = torch.gather(x, valid.dim() - 1, idx).squeeze(valid.dim() - 1)
        return out + 0.0 if out.is_floating_point() else out

    picked = TreeBatch(*(pick(f) for f in stacked.fields()))
    return select_tree(any_valid, picked, fallback), any_valid


def _expand_attempts(tree: TreeBatch, A: int) -> TreeBatch:
    """[I, B, L] -> flat [I * B * A, L], each tree repeated A times."""
    def rep(x):
        return x.unsqueeze(2).expand(*x.shape[:2], A, *x.shape[2:]).reshape(-1, *x.shape[2:])

    return TreeBatch(*(rep(f) for f in tree.fields()))


def _structure(tree: TreeBatch):
    child, size, _ = structure_from_arity(tree.arity, need_depth=False)
    return child, size, None


def template_check_batch(trees: TreeBatch, options: Options, tables: ComplexityTables,
                         cur_maxsize, template) -> torch.Tensor:
    """check_constraints for template members [..., K, L]: every
    subexpression passes its own constraints, the complexity summed over K
    is at most ``cur_maxsize``, and no subexpression reads an argument
    beyond its arity."""
    per = check_constraints_batch(trees, options, tables, cur_maxsize)       # [..., K]
    cx = compute_complexity_batch(trees, tables)                            # [..., K]
    ok = per.all(dim=-1) & (cx.sum(dim=-1) <= cur_maxsize)
    nfeat = torch.tensor(template.num_features, dtype=torch.int32, device=trees.device)
    in_tree = torch.arange(trees.max_nodes, device=trees.device) < trees.length[..., None]
    bad_feat = (in_tree & (trees.arity == 0) & (trees.op == LEAF_VAR)
                & (trees.feat >= nfeat[:, None]))
    return ok & ~bad_feat.any(dim=-1).any(dim=-1)


def _take_sub(trees: TreeBatch, k: torch.Tensor) -> TreeBatch:
    """Subexpression ``k`` [...] of each template member [..., K, L]."""
    kk = k.long()
    L = trees.max_nodes
    slot = lambda x: torch.gather(x, -2, kk[..., None, None].expand(*kk.shape, 1, L))[..., 0, :]
    return TreeBatch(slot(trees.arity), slot(trees.op), slot(trees.feat), slot(trees.const),
                     torch.gather(trees.length, -1, kk[..., None])[..., 0])


def _put_sub(trees: TreeBatch, sub: TreeBatch, k: torch.Tensor) -> TreeBatch:
    """Write ``sub`` [..., L] into subexpression ``k`` [...] of ``trees``."""
    K = trees.length.shape[-1]
    hit = torch.arange(K, device=k.device) == k[..., None]                  # [..., K]
    slot = lambda x, v: torch.where(hit[..., None], v[..., None, :], x)
    return TreeBatch(slot(trees.arity, sub.arity), slot(trees.op, sub.op),
                     slot(trees.feat, sub.feat), slot(trees.const, sub.const),
                     torch.where(hit, sub.length[..., None], trees.length))


def template_k(cfg: EvolveConfig) -> int:
    """The number of subexpressions of a template config, else 0."""
    return cfg.template.n_subexpressions if cfg.template is not None else 0


def _member_shape(trees: TreeBatch, template):
    """The member batch shape: the tree batch shape without the key axis."""
    return trees.batch_shape[:-1] if template is not None else trees.batch_shape


def _flat_members(trees: TreeBatch, template) -> TreeBatch:
    """Members flattened to [N, L], or [N, K, L] for templates."""
    if template is None:
        return trees.reshape(-1)
    return trees.reshape(-1, template.n_subexpressions)


# ---------------------------------------------------------------------------
# One bulk generation step (== one reg_evol_cycle)
# ---------------------------------------------------------------------------


def _scatter_rows(dst: torch.Tensor, target: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst[i, target[i, j]] = src[i, j]`` with ``target == P`` dropped."""
    I, P = dst.shape[:2]
    pad = torch.zeros((I, 1) + dst.shape[2:], dtype=dst.dtype, device=dst.device)
    out = torch.cat([dst, pad], dim=1)
    idx = target.long().reshape(target.shape + (1,) * (dst.dim() - 2)).expand(src.shape)
    out = out.scatter(1, idx, src)
    return out[:, :P]


def generation_step(key, pop: PopulationState, data, stats_nf, temperature, cur_maxsize,
                    birth0, ref0, cfg: EvolveConfig, options: Options,
                    tables: ComplexityTables, elementwise_loss, marks):
    """One generation step of every island.

    ``key`` [I, 2]; ``pop`` fields [I, P, ...]; ``birth0``/``ref0`` [I];
    ``marks`` = (simplify_mark, optimize_mark), bool [I, P]. Returns
    (new_pop, num_evals [I], birth0 + 2B, ref0 + 2B, new_marks), then the
    step's `CycleTelemetry` [I] with ``cfg.collect_telemetry`` and its
    `CycleEvents` with ``cfg.record_events``."""
    B = cfg.n_slots
    A = cfg.attempts
    P = cfg.population_size
    L = cfg.max_nodes
    I = pop.cost.shape[0]
    dev = pop.cost.device

    keys = rng.split(key, B)                      # [I, B, 2]
    slot_keys3 = rng.split(keys, 3)               # [I, B, 3, 2]

    def tourney(k):
        return tournament_select(
            k, pop.cost[:, None, :], pop.complexity[:, None, :], stats_nf,
            tournament_n=cfg.tournament_n, p=cfg.tournament_p,
            use_frequency=cfg.use_frequency_in_tournament,
            adaptive_parsimony_scaling=cfg.adaptive_parsimony_scaling,
            maxsize=cfg.maxsize)

    i1 = tourney(slot_keys3[..., 0, :])           # [I, B]
    i2 = tourney(slot_keys3[..., 1, :])
    m1 = take_members(pop, i1)
    m2 = take_members(pop, i2)

    NKINDS = len(MUTATION_KINDS)
    ATT_NU = _attempt_nu(cfg)
    L2 = 2 * L
    template = cfg.template
    TK = 2 if template is not None else 0     # template key draws
    SLOT_NU = 1 + NKINDS + TK + A * ATT_NU + A * L2 + 1 + 1 + 4
    u = rng.uniform(slot_keys3[..., 2, :], (SLOT_NU,), dtype=cfg.dtype)   # [I, B, SLOT_NU]
    s = USlice(u)
    is_xover = u_bernoulli(s.take1(), cfg.crossover_probability)

    base_w = torch.as_tensor(options.mutation_weights.as_vector(), dtype=torch.float32,
                             device=dev)
    attempts = lambda x: x.unsqueeze(-1).expand(I, B, A).reshape(-1)
    if template is not None:
        # One random subexpression per member; its arity drives feature draws.
        K = template.n_subexpressions
        u_tk = s.take(TK)
        sub1 = u_randint(u_tk[..., 0], K)
        sub2 = u_randint(u_tk[..., 1], K)
        nfeat1 = torch.tensor(template.num_features, dtype=torch.int32, device=dev)[sub1.long()]
        tgt1, tgt2 = _take_sub(m1.trees, sub1), _take_sub(m2.trees, sub2)
        mctx1 = cfg.mctx._replace(nfeatures=attempts(nfeat1))
        w = _condition_weights(base_w, tgt1, m1.complexity, cur_maxsize, cfg,
                               nfeat_dyn=nfeat1)

        def members(trees: TreeBatch, src: TreeBatch, k):
            """Attempt trees put back into their members: [I * B * A, K, L]."""
            return _put_sub(_expand_attempts(src, A), trees, attempts(k))

        def check(trees):
            return template_check_batch(trees, options, tables, cur_maxsize, template)

        by_attempt = lambda t: t.reshape(I, B, A, K)
    else:
        tgt1, tgt2 = m1.trees, m2.trees
        mctx1 = None
        w = _condition_weights(base_w, tgt1, m1.complexity, cur_maxsize, cfg)
        members = lambda trees, src, k: trees
        sub1 = sub2 = None

        def check(trees):
            return check_constraints_batch(trees, options, tables, cur_maxsize)

        by_attempt = lambda t: t.reshape(I, B, A)

    # ---- mutation path ----
    kind = u_categorical_weights(s.take(NKINDS), w)          # [I, B]
    immediate = torch.zeros_like(kind, dtype=torch.bool)
    for kid in _IMMEDIATE_KINDS:
        immediate = immediate | (kind == kid)

    att_u = s.take(A * ATT_NU).reshape(I * B * A, ATT_NU)
    flat1 = _expand_attempts(tgt1, A)
    att_trees, att_ok = _apply_kind(attempts(kind), att_u, flat1, temperature, cur_maxsize, cfg,
                                    _structure(flat1), mctx=mctx1)
    att_trees = members(att_trees, m1.trees, sub1)
    att_valid = (att_ok & check(att_trees)).reshape(I, B, A)
    mut_tree, mut_success = _first_valid(att_valid, by_attempt(att_trees), m1.trees)

    # With parameter banks, mutate_constant scales a bank row instead half
    # the time, leaving the tree as it was.
    u_pb = s.take1()
    u_prow = s.take(4)
    has_p = cfg.n_params > 0
    mut_params = m1.params
    if has_p:
        mutate_param = (kind == _KIND["mutate_constant"]) & u_bernoulli(u_pb)
        new_params = M.mutate_parameter_row(u_prow.reshape(I * B, 4),
                                            m1.params.reshape(I * B, *m1.params.shape[2:]),
                                            temperature, cfg.mctx).reshape(m1.params.shape)
        mut_params = torch.where(mutate_param[..., None, None], new_params, m1.params)
        mut_tree = select_tree(mutate_param, m1.trees, mut_tree)
        mut_success = mut_success | mutate_param

    # ---- crossover path ----
    xa_u = s.take(A * L2).reshape(I * B * A, L2)
    flat2 = _expand_attempts(tgt2, A)
    c1s, c2s, ok1s, ok2s = M.crossover_trees(xa_u, flat1, flat2, cfg.mctx,
                                             _structure(flat1), _structure(flat2))
    c1s, c2s = members(c1s, m1.trees, sub1), members(c2s, m2.trees, sub2)
    pair_valid = (ok1s & ok2s & check(c1s) & check(c2s)).reshape(I, B, A)
    xo1, xo_success = _first_valid(pair_valid, by_attempt(c1s), m1.trees)
    xo2, _ = _first_valid(pair_valid, by_attempt(c2s), m2.trees)

    cand1 = select_tree(is_xover, xo1, mut_tree)
    cand2 = xo2
    # Crossover exchanges the whole parameter banks.
    cand1_params = torch.where(is_xover[..., None, None], m2.params, mut_params) if has_p \
        else m1.params
    cand2_params = m1.params
    needs_eval1 = torch.where(is_xover, xo_success, mut_success & ~immediate)
    needs_eval2 = is_xover & xo_success
    accept_u = s.take1()

    # ---- one eval launch over all candidates ----
    # cand2 matters only on crossover slots; a pool of k2 of them (about
    # 3 sigma above the binomial mean) joins the launch, and crossover
    # slots past the pool count as failed crossovers.
    p_x = cfg.crossover_probability
    if p_x <= 0.0:
        k2 = 0
    elif p_x >= 0.5:
        k2 = B
    else:
        k2 = min(B, int(math.ceil(B * p_x + 3.0 * math.sqrt(B * p_x * (1.0 - p_x)) + 1.0)))

    def _eval_on(flat: TreeBatch, p_flat, rows):
        return eval_cost_batch(flat, rows, elementwise_loss, tables, cfg.operators,
                               cfg.parsimony, member_params=p_flat, turbo=cfg.turbo,
                               fuse_cost=cfg.fuse_cost, template=template, bf16=cfg.eval_bf16,
                               loss_function=options.resolved_loss_function,
                               dim_penalty=cfg.dim_penalty,
                               wildcard_constants=cfg.wildcard_constants)

    # graftstage's staged path (templates excepted, as in the JAX package):
    # every candidate is screened on the strided sample, each island's best
    # R by screened cost (NaN last, ties to the lower index, as lax.top_k)
    # is rescored on every row, and the others keep NaN cost and inf loss,
    # so acceptance keeps their parents and no sample cost enters the
    # population. One screen launch and one rescore launch per cycle.
    staged_ok = (cfg.staged_eval and template is None
                 and options.resolved_loss_function is None)
    # the whole dataset's rows under a data-row shard: the sample is the
    # global strided rows (DeviceData.strided_sample)
    sample_rows = resolve_sample_rows(cfg, data.n_global) if staged_ok else data.n_global
    staged = sample_rows < data.n_global

    def _eval(trees: TreeBatch, params):
        bshape = _member_shape(trees, template)
        flat = _flat_members(trees, template)
        p_flat = params.reshape(-1, *params.shape[-2:]) if has_p else None
        if not staged:
            c, lo, cx = _eval_on(flat, p_flat, data)
            return c.reshape(bshape), lo.reshape(bshape), cx.reshape(bshape)
        NI = flat.length.shape[0] // I                       # candidates per island
        c_s, _, cx = _eval_on(flat, p_flat, data.strided_sample(sample_rows))
        R = rescore_count(cfg, NI)
        score = torch.where(torch.isnan(c_s), math.inf, c_s).reshape(I, NI)
        sel = torch.argsort(score, dim=1, stable=True)[:, :R]
        sel = (sel + NI * torch.arange(I, device=dev)[:, None]).reshape(-1)
        # A genome with non-finite constants or parameters keeps its NaN
        # verdict whatever the rescore finds.
        row_bad = ~torch.isfinite(flat.const).reshape(I * NI, -1).all(1)
        if has_p:
            row_bad = row_bad | ~torch.isfinite(p_flat).reshape(I * NI, -1).all(1)
        c_r, l_r, _ = _eval_on(TreeBatch(*(f[sel] for f in flat.fields())),
                               p_flat[sel] if has_p else None, data)
        bad = row_bad[sel]
        cost = torch.full((I * NI,), math.nan, dtype=c_r.dtype, device=dev)
        loss = torch.full((I * NI,), math.inf, dtype=l_r.dtype, device=dev)
        cost[sel] = torch.where(bad, math.nan, c_r)
        loss[sel] = torch.where(bad, math.inf, l_r)
        return cost.reshape(bshape), loss.reshape(bshape), cx.reshape(bshape)

    inf = torch.tensor(math.inf, dtype=cfg.dtype, device=dev)
    if 0 < k2 < B:
        sel2 = _stable_top(is_xover, k2)                         # [I, k2]
        cand2_sel = _take_trees(cand2, sel2)
        slot_bad2 = ~torch.isfinite(cand2.const).reshape(I, B, -1).all(-1)   # [I, B]
        packed = TreeBatch(*(torch.cat([a, b], dim=1)
                             for a, b in zip(cand1.fields(), cand2_sel.fields())))
        packed_params = cand1_params
        if has_p:
            slot_bad2 = slot_bad2 | ~torch.isfinite(cand2_params).reshape(I, B, -1).all(-1)
            packed_params = torch.cat([cand1_params, _take_floats(cand2_params, sel2)], dim=1)
        n_eval_rows = B + k2
        c_all, l_all, x_all = _eval(packed, packed_params)

        def unpack(v, default):
            v2 = torch.full((I, B), default, dtype=v.dtype, device=dev)
            v2 = v2.scatter(1, sel2.long(), v[:, B:])
            return torch.stack([v[:, :B], v2], dim=-1)

        cost = unpack(c_all, math.inf)
        loss = unpack(l_all, math.inf)
        complexity = unpack(x_all, 1)
        cost[..., 1] = torch.where(slot_bad2, math.nan, cost[..., 1])
        xover_rank = torch.cumsum(is_xover.to(torch.int32), dim=-1) - 1
        overflow = is_xover & (xover_rank >= k2)
        xo_success = xo_success & ~overflow
        needs_eval2 = needs_eval2 & ~overflow
    elif k2 == 0:
        n_eval_rows = B
        cost1, loss1, cx1 = _eval(cand1, cand1_params)
        cost = torch.stack([cost1, inf.expand(I, B)], dim=-1)
        loss = torch.stack([loss1, inf.expand(I, B)], dim=-1)
        complexity = torch.stack([cx1, torch.ones_like(cx1)], dim=-1)
    else:
        both = TreeBatch(*(torch.stack([a, b], dim=2)
                           for a, b in zip(cand1.fields(), cand2.fields())))
        n_eval_rows = 2 * B
        cost, loss, complexity = _eval(both, torch.stack([cand1_params, cand2_params], dim=2)
                                       if has_p else cand1_params)
    needs_eval = torch.stack([needs_eval1, needs_eval2], dim=-1)
    num_evals = needs_eval.to(torch.float32).sum(dim=(1, 2))

    # ---- accept logic ----
    m1_cost, m1_loss, m1_cx = m1.cost, m1.loss, m1.complexity
    after_cost, after_loss, after_cx = cost[..., 0], loss[..., 0], complexity[..., 0]
    prob = torch.ones_like(after_cost)
    if cfg.annealing:
        delta = after_cost - m1_cost
        prob = prob * torch.exp(-delta / (cfg.alpha * temperature + 1e-12))
    if cfg.use_frequency:
        def freq_of(sz):
            in_r = (sz > 0) & (sz <= cfg.maxsize)
            return torch.where(in_r, stats_nf[torch.clamp(sz.long() - 1, 0, cfg.maxsize - 1)],
                               1e-6)

        prob = prob * (freq_of(m1_cx) / torch.clamp(freq_of(after_cx), min=1e-12))
    anneal_ok = accept_u < torch.where(torch.isnan(prob), 0.0, prob)
    accepted_mut = mut_success & ~torch.isnan(after_cost) & anneal_ok
    mut_replace = immediate | accepted_mut | (not cfg.skip_mutation_failures)

    # A kept parent whose genome carried non-finite constants or
    # parameters was clamped by the member take; plant NaN at its constant
    # leaves (and in its bank) so it stays invalid on the next eval, as its
    # parent was.
    lane = torch.arange(L, device=dev)
    cleaf = ((pop.trees.arity == 0) & (pop.trees.op == LEAF_CONST)
             & (lane < pop.trees.length[..., None]))
    bad_const = (cleaf & ~torch.isfinite(pop.trees.const)).reshape(I, P, -1).any(-1)
    m1_params = m1.params
    if has_p:
        bad_params = ~torch.isfinite(pop.params).reshape(I, P, -1).all(-1)
        bad_p1 = torch.gather(bad_params, 1, i1.long())
        m1_params = torch.where(bad_p1[..., None, None], math.nan, m1_params)
        bad_const = bad_const | bad_params
    slot_bad1 = torch.gather(bad_const, 1, i1.long())                      # [I, B]
    fb = m1.trees
    fb_cleaf = (fb.arity == 0) & (fb.op == LEAF_CONST)
    nan_mark = slot_bad1.reshape(I, B, *(1,) * (fb.const.dim() - 2)) & fb_cleaf
    fb = dataclasses.replace(fb, const=torch.where(nan_mark, math.nan, fb.const))
    accept1 = accepted_mut & ~immediate
    baby1_tree = select_tree(accept1, cand1, fb)
    baby1_cost = torch.where(accept1, after_cost, m1_cost)
    baby1_loss = torch.where(accept1, after_loss, m1_loss)
    baby1_cx = torch.where(accept1, after_cx, m1_cx)

    xo_nan = torch.isnan(cost[..., 0]) | torch.isnan(cost[..., 1])
    xo_replace = xo_success & ~xo_nan

    tele = None
    if cfg.collect_telemetry:
        from ..telemetry.counters import step_telemetry

        tele = step_telemetry(
            kind=kind, is_xover=is_xover, immediate=immediate,
            accepted_mut=accepted_mut, xo_replace=xo_replace,
            mut_success=mut_success, xo_success=xo_success,
            after_cost=after_cost, xo_nan=xo_nan, anneal_ok=anneal_ok,
            cost=cost, needs_eval1=needs_eval1, needs_eval2=needs_eval2,
            n_eval_rows=n_eval_rows,
            n_screen_rows=n_eval_rows if staged else 0,
            n_rescore_rows=rescore_count(cfg, n_eval_rows) if staged else 0)
    replace1 = torch.where(is_xover, xo_replace, mut_replace)
    replace2 = is_xover & xo_replace
    baby1_tree = select_tree(is_xover, cand1, baby1_tree)
    if has_p:
        baby1_params = torch.where((accept1 | is_xover)[..., None, None], cand1_params,
                                   m1_params)
    baby1_cost = torch.where(is_xover, cost[..., 0], baby1_cost)
    baby1_loss = torch.where(is_xover, loss[..., 0], baby1_loss)
    baby1_cx = torch.where(is_xover, complexity[..., 0], baby1_cx)

    nb = 2 * B
    flat = lambda a, b: torch.stack([a, b], dim=2).reshape(I, nb, *a.shape[2:])
    babies = TreeBatch(*(flat(a, b) for a, b in zip(baby1_tree.fields(), cand2.fields())))
    baby_cost = flat(baby1_cost, cost[..., 1])
    baby_loss = flat(baby1_loss, loss[..., 1])
    baby_cx = flat(baby1_cx, complexity[..., 1])
    baby_parent = flat(torch.gather(pop.ref, 1, i1.long()), torch.gather(pop.ref, 1, i2.long()))
    flat_replace = flat(replace1, replace2)                                # [I, 2B]

    # ---- replace the oldest members, one distinct target per baby ----
    order = torch.argsort(pop.birth, dim=-1, stable=True)
    rank = torch.cumsum(flat_replace.to(torch.int32), dim=-1) - 1
    nrep = flat_replace.to(torch.int32).sum(-1, keepdim=True)
    survives = flat_replace & ((rank < P - 1) | (rank == nrep - 1))
    target = torch.where(survives, torch.gather(order, 1, torch.clamp(rank, 0, P - 1).long()), P)
    scat = lambda dst, src: _scatter_rows(dst, target, src)

    steps = torch.arange(nb, dtype=torch.int32, device=dev)
    new_pop = PopulationState(
        trees=TreeBatch(*(scat(d, s_) for d, s_ in zip(pop.trees.fields(), babies.fields()))),
        cost=scat(pop.cost, baby_cost),
        loss=scat(pop.loss, baby_loss),
        complexity=scat(pop.complexity, baby_cx.to(pop.complexity.dtype)),
        birth=scat(pop.birth, birth0[:, None] + steps),
        ref=scat(pop.ref, ref0[:, None] + steps),
        parent=scat(pop.parent, baby_parent),
        params=scat(pop.params, flat(baby1_params, cand2_params)) if has_p else pop.params,
    )
    simp_mark, opt_mark = marks
    not_xover = ~is_xover
    zeros2 = torch.zeros_like(not_xover)
    simp_flags = flat(not_xover & (kind == _KIND["simplify"]) & replace1, zeros2)
    opt_flags = flat(not_xover & (kind == _KIND["optimize"]) & replace1, zeros2)
    new_marks = (scat(simp_mark, simp_flags), scat(opt_mark, opt_flags))
    out = (new_pop, num_evals, birth0 + nb, ref0 + nb, new_marks)
    if cfg.collect_telemetry:
        out = out + (tele,)
    if cfg.record_events:
        XO = len(MUTATION_KINDS)   # the crossover pseudo-kind
        ref_i1 = torch.gather(pop.ref, 1, i1.long())
        ref_i2 = torch.gather(pop.ref, 1, i2.long())
        # child-2 rows exist only for crossover slots; -1 marks the
        # phantom rows so they never count as rejected crossovers
        k1 = torch.where(is_xover, XO, kind)
        k2_kind = torch.where(is_xover, XO, -1)
        parent_cost2 = flat(m1_cost, torch.gather(pop.cost, 1, i2.long()))
        mut_reason = torch.where(
            ~mut_success, 1,
            torch.where(~torch.isfinite(after_cost), 2, torch.where(~anneal_ok, 3, 0)))
        xo_reason = torch.where(~xo_success, 1, torch.where(xo_nan, 2, 0))
        reason1 = torch.where(is_xover, xo_reason, torch.where(immediate, 0, mut_reason))
        reason2 = torch.where(is_xover, xo_reason, 0)
        died = torch.gather(pop.ref, 1, torch.gather(order, 1, torch.clamp(rank, 0, P - 1).long()))
        i32 = lambda t: t.to(torch.int32)
        out = out + (CycleEvents(
            kind=i32(flat(k1, k2_kind)),
            parent_ref=baby_parent,
            parent2_ref=i32(flat(torch.where(is_xover, ref_i2, -1), ref_i1)),
            child_ref=ref0[:, None] + steps,
            died_ref=i32(torch.where(survives, died, -1)),
            accepted=survives,
            cost_delta=baby_cost - parent_cost2,
            reject_reason=i32(flat(reason1, reason2))),)
    return out


# ---------------------------------------------------------------------------
# Best-seen hall of fame (per complexity)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HofState:
    trees: TreeBatch          # [..., maxsize, L]
    cost: torch.Tensor        # [..., maxsize]
    loss: torch.Tensor        # [..., maxsize]
    complexity: torch.Tensor  # [..., maxsize] int32
    exists: torch.Tensor      # [..., maxsize] bool
    params: torch.Tensor      # [..., maxsize, NP, NC] parameter banks


def empty_hof(batch_shape, maxsize: int, max_nodes: int, device,
              template_k: int = 0, n_params: int = 0, n_classes: int = 0,
              dtype: torch.dtype = torch.float32) -> HofState:
    """``template_k`` > 0 gives the trees the template key axis; constants,
    costs, losses and banks are ``dtype``."""
    shape = (*batch_shape, maxsize)
    tree_shape = (*shape, template_k) if template_k else shape
    return HofState(
        trees=TreeBatch.empty(tree_shape, max_nodes, device, dtype),
        cost=torch.full(shape, math.inf, dtype=dtype, device=device),
        loss=torch.full(shape, math.inf, dtype=dtype, device=device),
        complexity=torch.zeros(shape, dtype=torch.int32, device=device),
        exists=torch.zeros(shape, dtype=torch.bool, device=device),
        params=torch.zeros((*shape, n_params, n_classes), dtype=dtype, device=device),
    )


def update_hof(hof: HofState, trees: TreeBatch, cost, loss, complexity,
               maxsize: int, params=None) -> HofState:
    """Per-complexity best update over the member axis (last axis of
    ``cost``); leading axes batch independent halls of fame. ``params``
    are the members' banks (needed when the hall of fame has any)."""
    sizes = torch.arange(1, maxsize + 1, device=cost.device)[:, None]
    m = complexity[..., None, :] == sizes                       # [..., maxsize, P]
    cost_m = torch.where(m, cost[..., None, :], math.inf)
    best_idx = torch.argmin(cost_m, dim=-1)                     # [..., maxsize]
    best_cost = torch.gather(cost_m, -1, best_idx[..., None])[..., 0]
    better = best_cost < hof.cost

    def pick(hof_field, field):
        nb = cost.dim() - 1
        idx = best_idx.reshape(best_idx.shape + (1,) * (field.dim() - cost.dim()))
        idx = idx.expand(*best_idx.shape, *field.shape[nb + 1:])
        got = torch.gather(field, nb, idx)
        b = better.reshape(better.shape + (1,) * (got.dim() - better.dim()))
        return torch.where(b, got, hof_field)

    return HofState(
        trees=TreeBatch(*(pick(h, f) for h, f in zip(hof.trees.fields(), trees.fields()))),
        cost=torch.where(better, best_cost, hof.cost),
        loss=pick(hof.loss, loss),
        complexity=pick(hof.complexity, complexity),
        exists=hof.exists | better,
        params=pick(hof.params, params) if hof.params.numel() else hof.params,
    )


def s_r_cycle(key, pop: PopulationState, data, stats_nf, cur_maxsize, birth0, ref0,
              cfg: EvolveConfig, options: Options, tables: ComplexityTables,
              elementwise_loss, c0: int = 0, total_cycles=None, carry_in=None):
    """``cfg.ncycles`` generation steps of every island over the annealing
    ramp. ``key`` [I, 2]. Returns (pop, best_seen [I, maxsize], num_evals
    [I], birth0, ref0, marks), then the summed `CycleTelemetry` [I] with
    ``cfg.collect_telemetry`` and the `CycleEvents` [I, ncycles, 2B] with
    ``cfg.record_events``.

    A chunk of an iteration: ``c0`` is the global index of its first
    cycle, ``total_cycles`` the iteration's cycle count (the annealing
    ramp and the per-cycle key fold-in use global indices, so chunked and
    single-chunk iterations are bit-identical), and ``carry_in`` =
    (best_seen, num_evals, marks[, telemetry]) from the earlier chunks."""
    I, P = pop.cost.shape
    dev = pop.cost.device
    total = total_cycles if total_cycles is not None else cfg.ncycles
    if carry_in is not None:
        hof, nev, marks = carry_in[:3]
        tele = carry_in[3] if cfg.collect_telemetry else None
    else:
        hof = empty_hof((I,), cfg.maxsize, cfg.max_nodes, dev, template_k=template_k(cfg),
                        n_params=cfg.n_params, n_classes=cfg.n_classes, dtype=cfg.dtype)
        marks = (torch.zeros((I, P), dtype=torch.bool, device=dev),
                 torch.zeros((I, P), dtype=torch.bool, device=dev))
        nev = torch.zeros(I, dtype=torch.float32, device=dev)
        tele = None
        if cfg.collect_telemetry:
            from ..telemetry.counters import empty_cycle_telemetry

            tele = empty_cycle_telemetry((I,), dev)
    events = []
    for c in range(c0, c0 + cfg.ncycles):
        gc = torch.tensor(c, dtype=torch.float32, device=dev)
        if cfg.annealing and total > 1:
            temperature = 1.0 - gc / (total - 1)
        else:
            temperature = torch.ones((), dtype=torch.float32, device=dev)
        k = rng.fold_in(key, c)
        out = generation_step(
            k, pop, data, stats_nf, temperature, cur_maxsize, birth0, ref0, cfg, options,
            tables, elementwise_loss, marks)
        pop, nev_c, birth0, ref0, marks = out[:5]
        if cfg.collect_telemetry:
            from ..telemetry.counters import add_cycle_telemetry

            tele = add_cycle_telemetry(tele, out[5])
        if cfg.record_events:
            events.append(out[-1])
        nev = nev + nev_c
        hof = update_hof(hof, pop.trees, pop.cost, pop.loss, pop.complexity, cfg.maxsize,
                         params=pop.params)
    ret = (pop, hof, nev, birth0, ref0, marks)
    if cfg.collect_telemetry:
        ret = ret + (tele,)
    if cfg.record_events:
        ret = ret + (CycleEvents(*(torch.stack(f, dim=1) for f in zip(*events))),)
    return ret
