"""The per-iteration engine: islands evolve, simplify, finalize, migrate.

Port of ``symbolicregression_jl_tpu/evolve/engine.py`` for plain,
parametric and template expressions on one device. One `Engine.run_iteration` is one
reference iteration for every island at once:

    s_r_cycle (ncycles bulk generation steps over the annealing ramp)
    -> constant folding (simplify)
    -> constant optimization of the selected members (evolve/constant_opt.py)
    -> finalize costs (the whole population re-scored on every row,
       duplicates once)
    -> hall-of-fame merge across islands
    -> migration (island <- best members of all islands, island <- HoF)
    -> running-statistics update (frequency histogram, windowing)

With ``Options(batching=True)`` the cycles and the optimizer read one
minibatch of ``batch_size`` rows an iteration (``draw_batch``: the fifth
key's ``randint``, as the JAX package draws it), gathered once into
contiguous tensors; the evaluation count scales by ``batch_size / n``.

The optimizer's randomness is drawn as the JAX package draws it
(``_epilogue_draws``), so one key gives the same selection in both.
Template members (``Options(expression_spec=TemplateExpressionSpec(...))``)
carry a key axis, trees [I, P, K, L]; they fold per subexpression, and
their constants are optimized jointly (``optimize_constants_template``).
Every member carries a parameter bank ``params`` [I, P, NP, NC]:
parametric members' per-class parameters (``n_params``, ``n_classes``),
or a template's parameter vector as [total_params, 1]. The optimizer
takes the banks jointly with the constants, on the eager path.

graftstage (``docs/PRECISION.md``): with ``eval_precision="bf16"`` the
init eval, the cycles and the finalize score on the bf16 value buffer;
the finalize and the optimizer always read every row (only the cycles'
candidates are staged). ``optimizer_bf16_linesearch`` runs the L-BFGS
line search on kernel 2b where the kernels run (``turbo`` on the card);
elsewhere it stays float32, as the JAX package's interpret mode does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from ..core.dataset import DeviceData
from ..core.options import Options, check_supported
from ..device import resolve_device
from ..ops.complexity import ComplexityTables, build_complexity_tables
from ..ops.encoding import TreeBatch
from . import rng
from .constant_opt import (OptimizerConfig, optimize_constants_batch, optimize_constants_fused,
                           optimize_constants_template)
from .population import PopulationState, init_params, init_population, init_template_population
from .simplify import fold_constants_batch
from .step import (EvolveConfig, HofState, _take_rows, empty_hof, eval_cost_batch,
                   evolve_config_from_options, s_r_cycle, take_members, template_k, update_hof)

__all__ = ["RunningStats", "SearchDeviceState", "Engine"]


@dataclasses.dataclass
class RunningStats:
    """RunningSearchStatistics: complexity frequencies."""

    frequencies: torch.Tensor            # [maxsize]
    normalized_frequencies: torch.Tensor  # [maxsize]


@dataclasses.dataclass
class SearchDeviceState:
    """All device-resident search state."""

    pops: PopulationState   # leading island axis [I, P, ...]
    hof: HofState           # global best per complexity [maxsize, ...]
    stats: RunningStats
    birth: torch.Tensor     # [I] int32 per-island birth counters
    ref: torch.Tensor       # [I] int32 per-island lineage counters
    num_evals: torch.Tensor  # 0-d float32
    key: torch.Tensor       # [2] threefry key words


def _move_window(freq, window_size: float, maxsize: int):
    """Shrink frequencies toward 1 so they sum to window_size."""
    total = torch.sum(freq)
    excess_scale = (window_size - maxsize) / torch.clamp(total - maxsize, min=1e-9)
    scaled = 1.0 + (freq - 1.0) * torch.clamp(excess_scale, max=1.0)
    return torch.where(total > window_size, scaled, freq)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """[I, P, ...] -> [I * P, ...] (zero-sized banks included)."""
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


def _flat_trees(trees: TreeBatch) -> TreeBatch:
    """[I, P, ...] trees -> [I * P, ...]."""
    return TreeBatch(*(_flat(f) for f in trees.fields()))


def _template_of(options: Options):
    from ..models.spec import TemplateExpressionSpec

    spec = options.expression_spec
    return spec.structure if isinstance(spec, TemplateExpressionSpec) else None


class Engine:
    """Search engine for one (options, dataset width) pair on one device.
    ``n_params``/``n_classes`` size parametric members' banks; templates
    set them from their parameter vectors."""

    def __init__(self, options: Options, nfeatures: int,
                 device: Optional[Union[str, torch.device]] = None,
                 window_size: int = 100_000, n_params: int = 0, n_classes: int = 0):
        check_supported(options)
        self.options = options
        self.nfeatures = nfeatures
        self.device = resolve_device(device)
        self.template = _template_of(options)
        if self.template is not None:
            # Template parameters ride the member bank as [total_params, 1].
            n_params = self.template.total_params
            n_classes = 1 if n_params else 0
        self.cfg: EvolveConfig = evolve_config_from_options(options, nfeatures, self.device,
                                                            n_params=n_params,
                                                            n_classes=n_classes,
                                                            template=self.template)
        self.tables: ComplexityTables = build_complexity_tables(options, nfeatures, self.device)
        self.opt_cfg = OptimizerConfig(
            iterations=options.optimizer_iterations, nrestarts=options.optimizer_nrestarts,
            ls_bf16=(options.optimizer_bf16_linesearch and self.cfg.turbo
                     and self.device.type == "cuda"))
        self.window_size = float(window_size)

    def _eval(self, trees: TreeBatch, params, data: DeviceData, *, fuse_cost: bool,
              dedup: bool = False):
        """Costs of flat members ``trees`` with their banks ``params``."""
        cfg = self.cfg
        return eval_cost_batch(trees, data, self.options.elementwise_loss, self.tables,
                               cfg.operators, cfg.parsimony,
                               member_params=params if cfg.n_params else None,
                               turbo=cfg.turbo, fuse_cost=fuse_cost, dedup=dedup,
                               template=cfg.template, bf16=cfg.eval_bf16)

    def _epilogue_draws(self, k_opt, I: int):
        """The optimizer's selection size and its island-major random
        draws, as the JAX package makes them. Returns
        ``(k_sel, scores, gate, ko2)``; ``scores`` and ``gate`` are None
        when the epilogue optimizes nothing."""
        options = self.options
        P = self.cfg.population_size
        k_sel = max(1, round(P * options.optimizer_probability))
        gate_p = min(P * options.optimizer_probability / k_sel, 1.0)
        opt_kind_on = float(options.mutation_weights.optimize) > 0
        if opt_kind_on:
            # Cover the expected number of members marked by
            # `optimize`-kind mutations this iteration.
            frac_opt = float(options.mutation_weights.optimize) / max(
                float(options.mutation_weights.as_vector().sum()), 1e-12)
            expected = self.cfg.n_slots * self.cfg.ncycles * frac_opt
            k_sel = max(k_sel, min(P, math.ceil(expected)))
        do_optimize = options.should_optimize_constants and (
            options.optimizer_probability > 0 or opt_kind_on)
        scores = gate = None
        ko2 = k_opt
        if do_optimize:
            ko1, ko2, ko3 = rng.split(k_opt, 3)
            scores = rng.uniform(ko1, (I, P))
            gate = rng.bernoulli(ko3, gate_p, (I, k_sel))
        return k_sel, scores, gate, ko2

    # ------------------------------------------------------------------
    def init_state(self, key: torch.Tensor, data: DeviceData, n_islands: int) -> SearchDeviceState:
        """Random populations, scored. ``key`` [2] threefry key words."""
        cfg = self.cfg
        P = cfg.population_size
        dev = self.device
        key = key.to(dev)
        k_init, k_params, k_state = rng.split(key, 3)
        if cfg.template is not None:
            trees = init_template_population(rng.split(k_init, n_islands), P, cfg.template,
                                             cfg.mctx)
        else:
            trees = init_population(rng.split(k_init, n_islands), P, cfg.mctx)
        params = init_params(k_params, (n_islands, P), cfg.n_params, cfg.n_classes)
        cost, loss, cx = self._eval(_flat_trees(trees), _flat(params), data,
                                    fuse_cost=cfg.fuse_cost)
        arange = torch.arange(P, dtype=torch.int32, device=dev)
        pops = PopulationState(
            trees=trees,
            cost=cost.reshape(n_islands, P),
            loss=loss.reshape(n_islands, P),
            complexity=cx.reshape(n_islands, P),
            birth=arange.expand(n_islands, P).clone(),
            ref=arange[None, :] + torch.arange(n_islands, dtype=torch.int32,
                                               device=dev)[:, None] * 1_000_000,
            parent=torch.full((n_islands, P), -1, dtype=torch.int32, device=dev),
            params=params,
        )
        freq = torch.ones(cfg.maxsize, dtype=torch.float32, device=dev)
        return SearchDeviceState(
            pops=pops,
            hof=empty_hof((), cfg.maxsize, cfg.max_nodes, dev, template_k=template_k(cfg),
                          n_params=cfg.n_params, n_classes=cfg.n_classes),
            stats=RunningStats(freq, freq / torch.sum(freq)),
            birth=torch.full((n_islands,), P, dtype=torch.int32, device=dev),
            ref=torch.full((n_islands,), P, dtype=torch.int32, device=dev),
            num_evals=torch.tensor(float(n_islands * P), dtype=torch.float32, device=dev),
            key=k_state,
        )

    def draw_batch(self, k_batch, data: DeviceData) -> Optional[DeviceData]:
        """With ``batching``, this iteration's minibatch: ``batch_size``
        rows drawn as ``jax.random.randint(k_batch, (batch_size,), 0, n)``
        and gathered into contiguous tensors; else None."""
        if not self.cfg.batching:
            return None
        return data.take_rows(rng.randint(k_batch, (self.cfg.batch_size,), 0, data.n))

    # ------------------------------------------------------------------
    def run_iteration(self, state: SearchDeviceState, data: DeviceData,
                      cur_maxsize: int) -> SearchDeviceState:
        """One full iteration of every island."""
        cfg = self.cfg
        options = self.options
        I = state.birth.shape[0]
        P = cfg.population_size
        ks = rng.split(state.key, 5)
        key, k_batch, k_cycle, k_opt, k_mig = (ks[i] for i in range(5))
        # Minibatching: one batch of rows per iteration, gathered once, read
        # by every cycle and the constant optimizer (the finalize reads all
        # rows); evaluations count as batch_size / n of a full one.
        batch = self.draw_batch(k_batch, data)
        eval_fraction = cfg.batch_size / data.n if batch is not None else 1.0
        cycle_data = batch if batch is not None else data

        pops, best_seen, nev, birth, ref, marks = s_r_cycle(
            rng.split(k_cycle, I), state.pops, cycle_data, state.stats.normalized_frequencies,
            cur_maxsize, state.birth, state.ref, cfg, options, self.tables,
            options.elementwise_loss)
        num_evals = state.num_evals + torch.sum(nev) * eval_fraction

        k_sel, scores, gate, ko2 = self._epilogue_draws(k_opt, I)
        pops, ref, f_calls = self._island_epilogue(pops, ref, marks[0], marks[1], scores,
                                                   gate, ko2, data, k_sel, batch=batch)
        num_evals = num_evals + f_calls * eval_fraction
        num_evals = num_evals + I * P  # the finalize re-eval

        # ---- merge best_seen + final pops into the global HoF ----
        hof = update_hof(state.hof, _flat_trees(best_seen.trees),
                         _flat(torch.where(best_seen.exists, best_seen.cost, math.inf)),
                         _flat(best_seen.loss), _flat(best_seen.complexity), cfg.maxsize,
                         params=_flat(best_seen.params))
        hof = update_hof(hof, _flat_trees(pops.trees), _flat(pops.cost), _flat(pops.loss),
                         _flat(pops.complexity), cfg.maxsize, params=_flat(pops.params))

        # ---- migration ----
        if options.migration:
            topn = min(options.topn, P)
            order = torch.argsort(pops.cost, dim=1, stable=True)[:, :topn]
            pool = take_members(pops, order)
            pool = PopulationState(
                trees=_flat_trees(pool.trees), cost=_flat(pool.cost),
                loss=_flat(pool.loss), complexity=_flat(pool.complexity),
                birth=_flat(pool.birth), ref=_flat(pool.ref), parent=_flat(pool.parent),
                params=_flat(pool.params))
            km = rng.split(k_mig, 4)
            pops, birth = _migrate(km[0], pops, pool, options.fraction_replaced, birth, I, P,
                                   candidate_mask=torch.isfinite(pool.cost))
            if options.hof_migration:
                zeros = torch.zeros(cfg.maxsize, dtype=torch.int32, device=self.device)
                hof_pool = PopulationState(
                    trees=hof.trees, cost=torch.where(hof.exists, hof.cost, math.inf),
                    loss=hof.loss, complexity=hof.complexity, birth=zeros, ref=zeros,
                    parent=zeros, params=hof.params)
                pops, birth = _migrate(km[1], pops, hof_pool, options.fraction_replaced_hof,
                                       birth, I, P, candidate_mask=hof.exists)

        # ---- running statistics ----
        sizes = pops.complexity.reshape(-1)
        in_range = (sizes > 0) & (sizes <= cfg.maxsize)
        hist = torch.zeros(cfg.maxsize, dtype=torch.float32, device=self.device).index_add_(
            0, torch.where(in_range, sizes - 1, 0).long(), in_range.to(torch.float32))
        freq = _move_window(state.stats.frequencies + hist, self.window_size, cfg.maxsize)
        stats = RunningStats(freq, freq / torch.sum(freq))
        return SearchDeviceState(pops=pops, hof=hof, stats=stats, birth=birth, ref=ref,
                                 num_evals=num_evals, key=key)

    def _island_epilogue(self, pops: PopulationState, ref, simp_mark, opt_mark, scores, gate,
                         opt_key, data: DeviceData, k_sel: int,
                         batch: Optional[DeviceData] = None):
        """Fold constants, optimize the selected members' constants (on the
        minibatch ``batch`` where there is one), finalize costs on every
        row, rotate lineage refs. Returns (pops, ref, f_calls)."""
        cfg = self.cfg
        options = self.options
        I, P = pops.cost.shape
        if cfg.should_simplify:
            pops = dataclasses.replace(pops, trees=fold_constants_batch(pops.trees,
                                                                        cfg.operators))
        elif float(options.mutation_weights.simplify) > 0:
            from ..ops.encoding import select_tree

            folded = fold_constants_batch(pops.trees, cfg.operators)
            pops = dataclasses.replace(pops, trees=select_tree(simp_mark, folded, pops.trees))
        f_calls = torch.zeros((), dtype=torch.float32, device=self.device)
        if scores is not None:
            pops, f_calls = self._optimize(pops, opt_mark, scores, gate, opt_key,
                                           batch if batch is not None else data, k_sel)
        pops = self._finalize_costs(pops, data)
        new_refs = ref[:, None] + torch.arange(P, dtype=torch.int32, device=self.device)[None, :]
        pops = dataclasses.replace(pops, parent=pops.ref, ref=new_refs)
        return pops, ref + P, f_calls

    def _optimize(self, pops: PopulationState, opt_mark, scores, gate, opt_key,
                  data: DeviceData, k_sel: int):
        """Select ``k_sel`` members per island (``optimize``-marked ones
        first), optimize their constants and scatter the winners back.
        Returns (pops, total f_calls)."""
        cfg = self.cfg
        options = self.options
        I, P = pops.cost.shape
        opt_kind_on = float(options.mutation_weights.optimize) > 0
        if opt_kind_on:
            scores = scores + 10.0 * opt_mark.to(scores.dtype)
        # jax.lax.top_k: the larger score first, the lower index first on ties.
        sel_idx = torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :k_sel]
        if opt_kind_on:
            gate = gate | torch.gather(opt_mark, 1, sel_idx)
        sub = TreeBatch(*(_take_rows(f, sel_idx) for f in pops.trees.fields()))
        # Parametric and template members optimize their banks jointly with
        # their constants, on the eager path (never the fused L-BFGS).
        sub_p = _take_rows(pops.params, sel_idx) if cfg.n_params else None
        # A named range for torch.profiler (bench/profile_iteration.py).
        with torch.profiler.record_function("sr:constant_optimizer"):
            if cfg.template is not None:
                # One key per island, as the JAX package vmaps it; all
                # islands' members run as one batch.
                out = optimize_constants_template(
                    rng.split(opt_key, I), sub, gate, data, options.elementwise_loss,
                    cfg.operators, self.opt_cfg, cfg.template, fused=cfg.turbo, params=sub_p)
            elif cfg.turbo and not cfg.n_params:
                out = optimize_constants_fused(
                    opt_key, sub.reshape(I * k_sel), gate.reshape(I * k_sel), data,
                    options.elementwise_loss, cfg.operators, self.opt_cfg)
                out = (out[0].reshape(I, k_sel, cfg.max_nodes),) + out[1:]
            else:
                out = optimize_constants_batch(
                    rng.split(opt_key, I), sub, gate, data, options.elementwise_loss,
                    cfg.operators, self.opt_cfg, params=sub_p)
        # (new_const, improved, new_loss, f_calls[, new_params])
        new_const, f_calls = out[0], out[3]
        idx = sel_idx.reshape(I, k_sel, *(1,) * (new_const.dim() - 2)).expand(new_const.shape)
        const = pops.trees.const.scatter(1, idx, new_const)
        pops = dataclasses.replace(pops, trees=dataclasses.replace(pops.trees, const=const))
        if sub_p is not None:
            pidx = sel_idx[..., None, None].expand(out[4].shape)
            pops = dataclasses.replace(pops, params=pops.params.scatter(1, pidx, out[4]))
        return pops, torch.sum(f_calls)

    def _finalize_costs(self, pops: PopulationState, data: DeviceData) -> PopulationState:
        """Re-score every member on the whole dataset. On the kernel path
        identical (structure, constants) members across all islands run
        once (``fused_loss(dedup=True)``); results are bit-equal. Template
        and parametric members are all re-scored (no dedup, as in the JAX
        package)."""
        I, P = pops.cost.shape
        cfg = self.cfg
        cost, loss, cx = self._eval(_flat_trees(pops.trees), _flat(pops.params), data,
                                    fuse_cost=cfg.fuse_cost, dedup=cfg.turbo)
        return dataclasses.replace(pops, cost=cost.reshape(I, P), loss=loss.reshape(I, P),
                                   complexity=cx.reshape(I, P))


def _migrate(key, pops: PopulationState, pool: PopulationState, frac: float, birth,
             I: int, P: int, candidate_mask):
    """Replace each member with a random pool candidate with probability
    ``frac``; replaced members get fresh birth ticks. Only a pack of
    about 3 sigma above the binomial mean is gathered; replacements past
    it skip this iteration (as in the JAX package)."""
    if frac <= 0:
        return pops, birth
    k1, k2 = rng.split(key, 2)
    replace = rng.bernoulli(k1, frac, (I, P))
    logits = torch.where(candidate_mask, 0.0, -math.inf)
    pick = rng.categorical(k2, logits, shape=(I, P))
    replace = replace & candidate_mask.any()

    N = I * P
    f = min(float(frac), 1.0)
    kpack = min(N, int(math.ceil(N * f + 3.0 * math.sqrt(N * f * (1.0 - f)) + 1.0)))
    flat_replace = replace.reshape(N)
    rank = torch.cumsum(flat_replace.to(torch.int32), dim=0) - 1
    flat_replace = flat_replace & ~(flat_replace & (rank >= kpack))
    replace = flat_replace.reshape(I, P)

    pos = torch.argsort((~flat_replace).to(torch.int8), stable=True)[:kpack]
    target = torch.where(flat_replace[pos], pos, N)
    src = pick.reshape(N)[pos].long()

    def scat(old, new):
        flat = old.reshape((N,) + old.shape[2:])
        pad = torch.zeros((1,) + flat.shape[1:], dtype=flat.dtype, device=flat.device)
        out = torch.cat([flat, pad])
        out[target] = new.to(out.dtype)
        return out[:N].reshape(old.shape)

    take = lambda x: x[src]
    new_birth = birth[:, None] + torch.arange(P, dtype=torch.int32, device=birth.device)[None, :]
    out = PopulationState(
        trees=TreeBatch(*(scat(o, take(n)) for o, n in zip(pops.trees.fields(),
                                                           pool.trees.fields()))),
        cost=scat(pops.cost, take(pool.cost)),
        loss=scat(pops.loss, take(pool.loss)),
        complexity=scat(pops.complexity, take(pool.complexity)),
        birth=torch.where(replace, new_birth, pops.birth),
        ref=scat(pops.ref, take(pool.ref)),
        parent=scat(pops.parent, take(pool.parent)),
        params=scat(pops.params, take(pool.params)) if pops.params.numel() else pops.params,
    )
    return out, birth + P
