"""The evolution step: tournaments, mutations, accepts, replacement.

Port of ``symbolicregression_jl_tpu/evolve/step.py`` for plain
expressions. Where the JAX package vmaps one island's step over the
island axis, every function here takes that axis explicitly: population
fields are ``[I, P, ...]`` and keys ``[I, 2]``. One generation step runs
the ``ceil(P / tournament_n)`` slots of every island in parallel from one
population snapshot; each slot makes up to two babies (a mutation, or
crossover's pair) that replace the oldest members. The speculative
``mutation_attempts`` batch takes the first attempt that passes the
constraints.

`s_r_cycle` runs ``ncycles`` steps over the annealing ramp and keeps the
best member seen per complexity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..core.losses import aggregate_loss, loss_to_cost
from ..core.options import MUTATION_KINDS, Options
from ..ops.complexity import ComplexityTables, check_constraints_batch, compute_complexity_batch
from ..ops.encoding import LEAF_CONST, TreeBatch, select_tree, structure_from_arity
from ..ops.eval import eval_tree_batch
from ..ops.fused_eval import fused_cost, fused_loss, supports_fused_eval
from ..ops.operators import OperatorSet
from . import mutation as M
from . import rng
from .population import PopulationState
from .rng import USlice, u_bernoulli, u_categorical_weights
from .tournament import tournament_select

__all__ = ["EvolveConfig", "HofState", "evolve_config_from_options", "eval_cost_batch",
           "generation_step", "empty_hof", "update_hof", "s_r_cycle", "take_members"]

_KIND = {name: i for i, name in enumerate(MUTATION_KINDS)}
_IMMEDIATE_KINDS = (_KIND["simplify"], _KIND["do_nothing"], _KIND["optimize"],
                    _KIND["form_connection"], _KIND["break_connection"])

# Clamp applied where the JAX package gathers float rows with a one-hot
# matmul (0 * inf would be NaN there): non-finite constants come back as
# +-3e38, and callers that must keep a NaN verdict track it separately.
_CLAMP = 3.0e38


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
    turbo: bool       # candidate and finalize evals through the interpreter kernel
    fuse_cost: bool   # the kernel's loss -> cost epilogue on candidate evals

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
        )


def evolve_config_from_options(options: Options, nfeatures: int,
                               device: torch.device) -> EvolveConfig:
    """``turbo`` defaults to on for a CUDA device and off on the CPU."""
    turbo = options.turbo if options.turbo is not None else device.type == "cuda"
    turbo = bool(turbo) and supports_fused_eval(options.operators)
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
        fuse_cost=turbo and options.fuse_cost_epilogue is not False,
    )


# ---------------------------------------------------------------------------
# Cost evaluation
# ---------------------------------------------------------------------------


def eval_cost_batch(trees: TreeBatch, data, elementwise_loss, tables: ComplexityTables,
                    operators: OperatorSet, parsimony: float, *, turbo: bool = False,
                    fuse_cost: bool = False, dedup: bool = False):
    """(cost, loss, complexity) per tree, any batch shape.

    ``turbo`` runs the interpreter kernel (ops/fused_eval.py); with
    ``fuse_cost`` (and not ``dedup``) the kernel's epilogue also computes
    the cost. Otherwise the eager interpreter (ops/eval.py) predicts and
    the loss and cost follow in PyTorch."""
    X, y, w = data.Xt, data.y, data.weights
    complexity = compute_complexity_batch(trees, tables)
    if turbo and fuse_cost and not dedup:
        cost, loss, _ = fused_cost(
            trees, X, y, w, complexity, operators, elementwise_loss,
            baseline_loss=data.baseline_loss, use_baseline=data.use_baseline,
            parsimony=parsimony)
        return cost, loss, complexity
    if turbo:
        loss, _ = fused_loss(trees, X, y, w, operators, elementwise_loss, dedup=dedup)
    else:
        pred, valid = eval_tree_batch(trees, X, operators)
        loss = aggregate_loss(elementwise_loss, pred, y, valid, w)
    cost = loss_to_cost(loss, data.baseline_loss, data.use_baseline, complexity, parsimony)
    return cost, loss, complexity


# ---------------------------------------------------------------------------
# Row takes
# ---------------------------------------------------------------------------


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[i, idx[i, b], ...]`` for ``x`` [I, P, ...] and ``idx`` [I, B]."""
    idx = idx.long()
    shape = idx.shape + x.shape[2:]
    full = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, full)


def _take_trees(trees: TreeBatch, idx: torch.Tensor, clamp: bool) -> TreeBatch:
    const = _take_rows(trees.const, idx)
    if clamp:
        const = torch.nan_to_num(const, nan=_CLAMP, posinf=_CLAMP, neginf=-_CLAMP)
    return TreeBatch(_take_rows(trees.arity, idx), _take_rows(trees.op, idx),
                     _take_rows(trees.feat, idx), const, _take_rows(trees.length, idx))


def take_members(pop: PopulationState, idx: torch.Tensor) -> PopulationState:
    """Members ``idx`` [I, B] of each island, with the JAX package's
    one-hot-gather semantics: non-finite constants come back clamped."""
    t = lambda x: _take_rows(x, idx)
    return PopulationState(
        trees=_take_trees(pop.trees, idx, clamp=True), cost=t(pop.cost), loss=t(pop.loss),
        complexity=t(pop.complexity), birth=t(pop.birth), ref=t(pop.ref),
        parent=t(pop.parent))


def _stable_top(mask: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k(mask.astype(f32), k)`` indices: the True entries in
    order, then the False ones in order."""
    return torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)[..., :k]


# ---------------------------------------------------------------------------
# Mutation weights and speculative attempts
# ---------------------------------------------------------------------------


def _condition_weights(base_w: torch.Tensor, tree: TreeBatch, complexity, cur_maxsize,
                       cfg: EvolveConfig) -> torch.Tensor:
    """condition_mutation_weights! for a batch of target trees: [..., K]."""
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
    k = _KIND["mutate_constant"]
    w[..., k] = w[..., k] * torch.clamp(n_const, max=8).to(w.dtype) / 8.0
    if cfg.nfeatures <= 1:
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
                structure):
    """Every mutation branch on a flat [N] batch, selected by ``kind``."""
    mctx = cfg.mctx
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
    (new_pop, num_evals [I], birth0 + 2B, ref0 + 2B, new_marks)."""
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
    SLOT_NU = 1 + NKINDS + A * ATT_NU + A * L2 + 1 + 1 + 4
    u = rng.uniform(slot_keys3[..., 2, :], (SLOT_NU,))   # [I, B, SLOT_NU]
    s = USlice(u)
    is_xover = u_bernoulli(s.take1(), cfg.crossover_probability)

    base_w = torch.as_tensor(options.mutation_weights.as_vector(), dtype=torch.float32,
                             device=dev)
    tgt1, tgt2 = m1.trees, m2.trees
    w = _condition_weights(base_w, tgt1, m1.complexity, cur_maxsize, cfg)

    # ---- mutation path ----
    kind = u_categorical_weights(s.take(NKINDS), w)          # [I, B]
    immediate = torch.zeros_like(kind, dtype=torch.bool)
    for kid in _IMMEDIATE_KINDS:
        immediate = immediate | (kind == kid)

    att_u = s.take(A * ATT_NU).reshape(I * B * A, ATT_NU)
    flat1 = _expand_attempts(tgt1, A)
    att_trees, att_ok = _apply_kind(
        kind.unsqueeze(-1).expand(I, B, A).reshape(-1), att_u, flat1, temperature,
        cur_maxsize, cfg, _structure(flat1))
    att_cons = check_constraints_batch(att_trees, options, tables, cur_maxsize)
    att_valid = (att_ok & att_cons).reshape(I, B, A)
    mut_tree, mut_success = _first_valid(att_valid, att_trees.reshape(I, B, A), tgt1)

    s.take1()   # parameter-row branch draw (parametric expressions only)
    s.take(4)

    # ---- crossover path ----
    xa_u = s.take(A * L2).reshape(I * B * A, L2)
    flat2 = _expand_attempts(tgt2, A)
    c1s, c2s, ok1s, ok2s = M.crossover_trees(xa_u, flat1, flat2, cfg.mctx,
                                             _structure(flat1), _structure(flat2))
    cons1 = check_constraints_batch(c1s, options, tables, cur_maxsize)
    cons2 = check_constraints_batch(c2s, options, tables, cur_maxsize)
    pair_valid = (ok1s & ok2s & cons1 & cons2).reshape(I, B, A)
    xo1, xo_success = _first_valid(pair_valid, c1s.reshape(I, B, A), tgt1)
    xo2, _ = _first_valid(pair_valid, c2s.reshape(I, B, A), tgt2)

    cand1 = select_tree(is_xover, xo1, mut_tree)
    cand2 = xo2
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

    def _eval(trees: TreeBatch):
        bshape = trees.batch_shape
        c, lo, cx = eval_cost_batch(trees.reshape(-1), data, elementwise_loss, tables,
                                    cfg.operators, cfg.parsimony, turbo=cfg.turbo,
                                    fuse_cost=cfg.fuse_cost)
        return c.reshape(bshape), lo.reshape(bshape), cx.reshape(bshape)

    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    if 0 < k2 < B:
        sel2 = _stable_top(is_xover, k2)                         # [I, k2]
        cand2_sel = _take_trees(cand2, sel2, clamp=True)
        slot_bad2 = ~torch.isfinite(cand2.const).all(-1)        # [I, B]
        packed = TreeBatch(*(torch.cat([a, b], dim=1)
                             for a, b in zip(cand1.fields(), cand2_sel.fields())))
        c_all, l_all, x_all = _eval(packed)

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
        cost1, loss1, cx1 = _eval(cand1)
        cost = torch.stack([cost1, inf.expand(I, B)], dim=-1)
        loss = torch.stack([loss1, inf.expand(I, B)], dim=-1)
        complexity = torch.stack([cx1, torch.ones_like(cx1)], dim=-1)
    else:
        both = TreeBatch(*(torch.stack([a, b], dim=2)
                           for a, b in zip(cand1.fields(), cand2.fields())))
        cost, loss, complexity = _eval(both)
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

    # A kept parent whose genome carried non-finite constants was clamped
    # by the member take; plant NaN at its constant leaves so it stays
    # invalid on the next eval, as its parent was.
    lane = torch.arange(L, device=dev)
    cleaf = ((pop.trees.arity == 0) & (pop.trees.op == LEAF_CONST)
             & (lane < pop.trees.length[..., None]))
    bad_const = (cleaf & ~torch.isfinite(pop.trees.const)).any(-1)       # [I, P]
    slot_bad1 = torch.gather(bad_const, 1, i1.long())                      # [I, B]
    fb = m1.trees
    fb_cleaf = (fb.arity == 0) & (fb.op == LEAF_CONST)
    fb = dataclasses.replace(fb, const=torch.where(slot_bad1[..., None] & fb_cleaf,
                                                   math.nan, fb.const))
    accept1 = accepted_mut & ~immediate
    baby1_tree = select_tree(accept1, cand1, fb)
    baby1_cost = torch.where(accept1, after_cost, m1_cost)
    baby1_loss = torch.where(accept1, after_loss, m1_loss)
    baby1_cx = torch.where(accept1, after_cx, m1_cx)

    xo_nan = torch.isnan(cost[..., 0]) | torch.isnan(cost[..., 1])
    xo_replace = xo_success & ~xo_nan
    replace1 = torch.where(is_xover, xo_replace, mut_replace)
    replace2 = is_xover & xo_replace
    baby1_tree = select_tree(is_xover, cand1, baby1_tree)
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
    )
    simp_mark, opt_mark = marks
    not_xover = ~is_xover
    zeros2 = torch.zeros_like(not_xover)
    simp_flags = flat(not_xover & (kind == _KIND["simplify"]) & replace1, zeros2)
    opt_flags = flat(not_xover & (kind == _KIND["optimize"]) & replace1, zeros2)
    new_marks = (scat(simp_mark, simp_flags), scat(opt_mark, opt_flags))
    return new_pop, num_evals, birth0 + nb, ref0 + nb, new_marks


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


def empty_hof(batch_shape, maxsize: int, max_nodes: int, device) -> HofState:
    shape = (*batch_shape, maxsize)
    return HofState(
        trees=TreeBatch.empty(shape, max_nodes, device),
        cost=torch.full(shape, math.inf, dtype=torch.float32, device=device),
        loss=torch.full(shape, math.inf, dtype=torch.float32, device=device),
        complexity=torch.zeros(shape, dtype=torch.int32, device=device),
        exists=torch.zeros(shape, dtype=torch.bool, device=device),
    )


def update_hof(hof: HofState, trees: TreeBatch, cost, loss, complexity,
               maxsize: int) -> HofState:
    """Per-complexity best update over the member axis (last axis of
    ``cost``); leading axes batch independent halls of fame."""
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
    )


def s_r_cycle(key, pop: PopulationState, data, stats_nf, cur_maxsize, birth0, ref0,
              cfg: EvolveConfig, options: Options, tables: ComplexityTables,
              elementwise_loss):
    """``cfg.ncycles`` generation steps of every island over the annealing
    ramp. ``key`` [I, 2]. Returns (pop, best_seen [I, maxsize], num_evals
    [I], birth0, ref0, marks)."""
    I, P = pop.cost.shape
    dev = pop.cost.device
    hof = empty_hof((I,), cfg.maxsize, cfg.max_nodes, dev)
    marks = (torch.zeros((I, P), dtype=torch.bool, device=dev),
             torch.zeros((I, P), dtype=torch.bool, device=dev))
    nev = torch.zeros(I, dtype=torch.float32, device=dev)
    total = cfg.ncycles
    for c in range(cfg.ncycles):
        gc = torch.tensor(c, dtype=torch.float32, device=dev)
        if cfg.annealing and total > 1:
            temperature = 1.0 - gc / (total - 1)
        else:
            temperature = torch.ones((), dtype=torch.float32, device=dev)
        k = rng.fold_in(key, c)
        pop, nev_c, birth0, ref0, marks = generation_step(
            k, pop, data, stats_nf, temperature, cur_maxsize, birth0, ref0, cfg, options,
            tables, elementwise_loss, marks)
        nev = nev + nev_c
        hof = update_hof(hof, pop.trees, pop.cost, pop.loss, pop.complexity, cfg.maxsize)
    return pop, hof, nev, birth0, ref0, marks
