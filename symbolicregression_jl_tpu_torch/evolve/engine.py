"""The per-iteration engine: islands evolve, simplify, finalize, migrate.

Port of ``symbolicregression_jl_tpu/evolve/engine.py`` for plain
expressions on one device. One `Engine.run_iteration` is one reference
iteration for every island at once:

    s_r_cycle (ncycles bulk generation steps over the annealing ramp)
    -> constant folding (simplify)
    -> finalize costs (the whole population re-scored, duplicates once)
    -> hall-of-fame merge across islands
    -> migration (island <- best members of all islands, island <- HoF)
    -> running-statistics update (frequency histogram, windowing)

The constant optimizer (``should_optimize_constants=True``) is refused:
it comes with the next slice. With it off the JAX package's epilogue
draws no optimizer randomness, so the key streams stay the same.
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
from .population import PopulationState, init_population
from .simplify import fold_constants_batch
from .step import (EvolveConfig, HofState, empty_hof, eval_cost_batch,
                   evolve_config_from_options, s_r_cycle, take_members, update_hof)

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
    return x.reshape((-1,) + x.shape[2:])


class Engine:
    """Search engine for one (options, dataset width) pair on one device."""

    def __init__(self, options: Options, nfeatures: int,
                 device: Optional[Union[str, torch.device]] = None,
                 window_size: int = 100_000):
        check_supported(options)
        self.options = options
        self.nfeatures = nfeatures
        self.device = resolve_device(device)
        self.cfg: EvolveConfig = evolve_config_from_options(options, nfeatures, self.device)
        self.tables: ComplexityTables = build_complexity_tables(options, nfeatures, self.device)
        self.window_size = float(window_size)

    def _eval(self, trees: TreeBatch, data: DeviceData, *, fuse_cost: bool,
              dedup: bool = False):
        cfg = self.cfg
        return eval_cost_batch(trees, data, self.options.elementwise_loss, self.tables,
                               cfg.operators, cfg.parsimony, turbo=cfg.turbo,
                               fuse_cost=fuse_cost, dedup=dedup)

    # ------------------------------------------------------------------
    def init_state(self, key: torch.Tensor, data: DeviceData, n_islands: int) -> SearchDeviceState:
        """Random populations, scored. ``key`` [2] threefry key words."""
        cfg = self.cfg
        P = cfg.population_size
        dev = self.device
        key = key.to(dev)
        k_init, _k_params, k_state = rng.split(key, 3)
        trees = init_population(rng.split(k_init, n_islands), P, cfg.mctx)
        cost, loss, cx = self._eval(trees.reshape(-1), data, fuse_cost=cfg.fuse_cost)
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
        )
        freq = torch.ones(cfg.maxsize, dtype=torch.float32, device=dev)
        return SearchDeviceState(
            pops=pops,
            hof=empty_hof((), cfg.maxsize, cfg.max_nodes, dev),
            stats=RunningStats(freq, freq / torch.sum(freq)),
            birth=torch.full((n_islands,), P, dtype=torch.int32, device=dev),
            ref=torch.full((n_islands,), P, dtype=torch.int32, device=dev),
            num_evals=torch.tensor(float(n_islands * P), dtype=torch.float32, device=dev),
            key=k_state,
        )

    # ------------------------------------------------------------------
    def run_iteration(self, state: SearchDeviceState, data: DeviceData,
                      cur_maxsize: int) -> SearchDeviceState:
        """One full iteration of every island."""
        cfg = self.cfg
        options = self.options
        I = state.birth.shape[0]
        P = cfg.population_size
        ks = rng.split(state.key, 5)
        key, _k_batch, k_cycle, _k_opt, k_mig = (ks[i] for i in range(5))

        pops, best_seen, nev, birth, ref, marks = s_r_cycle(
            rng.split(k_cycle, I), state.pops, data, state.stats.normalized_frequencies,
            cur_maxsize, state.birth, state.ref, cfg, options, self.tables,
            options.elementwise_loss)
        num_evals = state.num_evals + torch.sum(nev)

        pops, ref = self._island_epilogue(pops, ref, marks[0], data)
        num_evals = num_evals + I * P  # the finalize re-eval

        # ---- merge best_seen + final pops into the global HoF ----
        hof = update_hof(state.hof, TreeBatch(*(_flat(f) for f in best_seen.trees.fields())),
                         _flat(torch.where(best_seen.exists, best_seen.cost, math.inf)),
                         _flat(best_seen.loss), _flat(best_seen.complexity), cfg.maxsize)
        hof = update_hof(hof, pops.trees.reshape(I * P), _flat(pops.cost), _flat(pops.loss),
                         _flat(pops.complexity), cfg.maxsize)

        # ---- migration ----
        if options.migration:
            topn = min(options.topn, P)
            order = torch.argsort(pops.cost, dim=1, stable=True)[:, :topn]
            pool = take_members(pops, order)
            pool = PopulationState(
                trees=pool.trees.reshape(I * topn), cost=_flat(pool.cost),
                loss=_flat(pool.loss), complexity=_flat(pool.complexity),
                birth=_flat(pool.birth), ref=_flat(pool.ref), parent=_flat(pool.parent))
            km = rng.split(k_mig, 4)
            pops, birth = _migrate(km[0], pops, pool, options.fraction_replaced, birth, I, P,
                                   candidate_mask=torch.isfinite(pool.cost))
            if options.hof_migration:
                zeros = torch.zeros(cfg.maxsize, dtype=torch.int32, device=self.device)
                hof_pool = PopulationState(
                    trees=hof.trees, cost=torch.where(hof.exists, hof.cost, math.inf),
                    loss=hof.loss, complexity=hof.complexity, birth=zeros, ref=zeros,
                    parent=zeros)
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

    def _island_epilogue(self, pops: PopulationState, ref, simp_mark, data: DeviceData):
        """Fold constants, finalize costs, rotate lineage refs."""
        cfg = self.cfg
        I, P = pops.cost.shape
        if cfg.should_simplify:
            pops = dataclasses.replace(pops, trees=fold_constants_batch(pops.trees,
                                                                        cfg.operators))
        elif float(self.options.mutation_weights.simplify) > 0:
            from ..ops.encoding import select_tree

            folded = fold_constants_batch(pops.trees, cfg.operators)
            pops = dataclasses.replace(pops, trees=select_tree(simp_mark, folded, pops.trees))
        pops = self._finalize_costs(pops, data)
        new_refs = ref[:, None] + torch.arange(P, dtype=torch.int32, device=self.device)[None, :]
        pops = dataclasses.replace(pops, parent=pops.ref, ref=new_refs)
        return pops, ref + P

    def _finalize_costs(self, pops: PopulationState, data: DeviceData) -> PopulationState:
        """Re-score every member on the whole dataset. On the kernel path
        identical (structure, constants) members across all islands run
        once (``fused_loss(dedup=True)``); results are bit-equal."""
        I, P = pops.cost.shape
        cfg = self.cfg
        cost, loss, cx = self._eval(pops.trees.reshape(I * P), data,
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
    )
    return out, birth + P
