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

``run_iteration(chunk_sizes=, should_stop=)`` runs the cycles in chunks
with a host callback polled between them (the search's timeout,
``max_evals`` and quit checks); a stop skips the remaining cycles and runs
the epilogue once, and chunked iterations are bit-identical to
single-chunk ones. With ``Options(telemetry=True)`` the iteration leaves
its counters on ``state.telem`` (`telemetry.counters.IterationTelemetry`),
computed on the device from values it already has; with ``use_recorder``
it returns ``(state, CycleEvents)``.

Multi-device (``plan``, a ``mesh/plan.MeshPlan``): the engine holds this
rank's block of the islands and runs the island-local phases (the
cycles, simplify, the optimizer, the finalize) on them alone, with the
kernels launched per rank. Every draw is taken island-major for the
global island count before the shard boundary and then sliced, so the
streams do not depend on the layout. The hall-of-fame merge, the
migration pool and the running statistics run on every rank, identically,
over populations gathered from all shards (parallel/collectives.py); each
rank then carves its islands back out, and the counters are gathered
and added in shard order. This is the legacy sharded runtime of the JAX
package (``mesh_runtime=False``): no finalize dedup and zero duplication
statistics under more than one island shard, the fused-cost finalize.
``mesh/engine.MeshEngine`` is the mesh runtime on the same code. With the
optimizer off, N island shards are bit-identical to the unsharded run;
with it on, the restart key is decorrelated per shard
(``fold_in(key, shard)``), as in the JAX package. With data-row shards
(``n_data_shards > 1``) each rank holds a block of the rows and every
loss, on the kernels or the eager interpreter, adds the row partials of
every block before the mean (``ops/fused_eval._row_totals``,
``core/losses.aggregate_loss``): templates, custom losses, minibatches
(drawn over the whole dataset's rows) and graftstage's screening sample
(the global strided rows) included. The cost epilogue of #1 is off there:
it needs the whole loss.

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
from typing import Callable, Optional, Sequence, Union

import torch

from ..core.dataset import DeviceData
from ..core.options import Options, check_supported, float_dtype, state_dtype
from ..device import resolve_device
from ..ops.complexity import ComplexityTables, build_complexity_tables
from ..ops.encoding import TreeBatch
from ..parallel.collectives import all_gather_tree, ordered_sum, row_shard
from . import rng
from .constant_opt import (OptimizerConfig, optimize_constants_batch, optimize_constants_fused,
                           optimize_constants_template)
from .population import PopulationState, init_params, init_population, init_template_population
from .simplify import fold_constants_batch
from .step import (CycleEvents, EvolveConfig, HofState, _take_rows, empty_hof, eval_cost_batch,
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
    # The last iteration's counters (telemetry.counters.IterationTelemetry)
    # with Options(telemetry=True), else None.
    telem: Optional[object] = None


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
    """Search engine for one (options, dataset width) pair on one device,
    or for this rank's islands of a mesh (``plan``; module docstring).
    ``n_params``/``n_classes`` size parametric members' banks; templates
    set them from their parameter vectors. ``template`` is the
    ``TemplateStructure`` (default: the options' template spec's).
    Without a ``plan``, ``n_island_shards``/``n_data_shards`` > 1 or a
    ``mesh`` (``parallel.make_mesh``'s grid of ranks) build one, as the
    JAX engine takes its mesh."""

    def __init__(self, options: Options, nfeatures: int,
                 device: Optional[Union[str, torch.device]] = None,
                 window_size: int = 100_000, n_params: int = 0, n_classes: int = 0,
                 dtype: Optional[torch.dtype] = None, plan=None, template=None,
                 n_data_shards: int = 1, n_island_shards: int = 1, mesh=None):
        if plan is None:
            from ..mesh.plan import MeshPlan

            plan = MeshPlan.for_layout(n_island_shards, n_data_shards, mesh)
        self.device = resolve_device(device)
        check_supported(options, self.device)
        self.options = options
        self.plan = plan
        self.n_island_shards = plan.n_island_shards if plan is not None else 1
        self.nfeatures = nfeatures
        # The floating type of the constants, costs and hall of fame (and of
        # the data, whose bf16 values it holds for eval_dtype="bfloat16").
        data_dtype = dtype if dtype is not None else float_dtype(options.eval_dtype)
        bf16_data = data_dtype == torch.bfloat16
        self.dtype = state_dtype(data_dtype)
        self.template = template if template is not None else _template_of(options)
        if self.template is not None:
            # Template parameters ride the member bank as [total_params, 1].
            n_params = self.template.total_params
            n_classes = 1 if n_params else 0
        self.cfg: EvolveConfig = evolve_config_from_options(options, nfeatures, self.device,
                                                            n_params=n_params,
                                                            n_classes=n_classes,
                                                            template=self.template,
                                                            dtype=self.dtype,
                                                            n_data_shards=(
                                                                1 if plan is None
                                                                else plan.n_data_shards))
        self.tables: ComplexityTables = build_complexity_tables(options, nfeatures, self.device)
        if bf16_data:
            # bf16 data: every evaluation on the bf16 value buffer with a
            # bf16 loss spine (kernels 1b and 2b's bf16-data forms), the
            # gradient on kernel #3 in float32, as in the JAX package.
            self.cfg = self.cfg._replace(eval_bf16="data")
        self.opt_cfg = OptimizerConfig(
            iterations=options.optimizer_iterations, nrestarts=options.optimizer_nrestarts,
            ls_bf16=("data" if bf16_data and self.cfg.turbo else
                     (options.optimizer_bf16_linesearch and self.cfg.turbo
                      and self.device.type == "cuda")))
        self.window_size = float(window_size)

    @property
    def n_params(self) -> int:
        return self.cfg.n_params

    @property
    def n_classes(self) -> int:
        return self.cfg.n_classes

    def degrade_eval_tile_rows(self, floor: int = 512) -> Optional[int]:
        """graftshield's degradation step (shield/degrade.py): halve
        ``cfg.eval_tile_rows``, which in the port caps graftstage's
        screening sample (``step.resolve_sample_rows``). Returns the new
        cap, or None at the floor (the ladder is exhausted)."""
        cur = int(self.cfg.eval_tile_rows)
        new = max(cur // 2, int(floor))
        if new >= cur:
            return None
        self.cfg = self.cfg._replace(eval_tile_rows=new)
        return new

    # ------------------------------------------------------------------
    # The island mesh
    # ------------------------------------------------------------------
    def _islands(self, n_islands: int):
        """[lo, hi) of this rank's islands of ``n_islands``."""
        return (0, n_islands) if self.plan is None else self.plan.islands_of(n_islands)

    def _island_group(self):
        return None if self.plan is None else self.plan.island_group()

    @staticmethod
    def _rows(data: DeviceData):
        """The data-row reduction of ``data``'s row shard, if any."""
        return row_shard(data.row_shard)

    def _dedup_eligible(self) -> bool:
        """Whether the finalize can dedup: plain members on the kernels."""
        cfg = self.cfg
        return bool(cfg.turbo) and cfg.template is None and cfg.n_params == 0

    def _use_dedup(self) -> bool:
        """The finalize dedups where it is eligible and the island axis is
        whole: the legacy runtime forfeits it under island shards, as in
        the JAX package (mesh/engine.MeshEngine dedups per shard)."""
        return self._dedup_eligible() and self.n_island_shards == 1

    def _finalize_fuse_cost(self) -> bool:
        """The finalize's cost epilogue (used where it does not dedup)."""
        return self.cfg.fuse_cost

    def _dup_stats(self, local_trees: TreeBatch, all_trees: TreeBatch):
        """The finalize's member-duplication counters: the global ones on a
        whole island axis, zeros under island shards (the legacy runtime,
        as in the JAX package)."""
        from ..telemetry.counters import member_dup_stats

        if self.n_island_shards > 1:
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            return zero, zero
        return member_dup_stats(all_trees)

    # ------------------------------------------------------------------
    # graftshield quarantine primitives (shield/quarantine.py drives them
    # from the host loop)
    # ------------------------------------------------------------------
    def island_invalid_fractions(self, state: SearchDeviceState) -> torch.Tensor:
        """[I] fraction of non-finite member losses per island, the NaN-storm
        detector's input."""
        return torch.mean((~torch.isfinite(state.pops.loss)).to(torch.float32), dim=1)

    def reseed_islands(self, state: SearchDeviceState, mask: torch.Tensor) -> SearchDeviceState:
        """Reseed the islands ``mask`` ([I] bool) selects from the hall of
        fame: each such island's members become the existing entries tiled
        across its slots, with their costs, losses, complexities and
        banks (hall-of-fame costs are full-dataset ones, so nothing is
        re-scored), fresh birth and lineage ticks and no parent; the
        islands' birth and lineage counters move on by P. Other islands
        are left as they are, and an empty hall of fame makes it an
        identity. It draws nothing at random, so a resumed search
        quarantines as an uninterrupted one does, and it reads nothing
        back to the host. New tensors: the input state is left as it was."""
        P = self.cfg.population_size
        hof, pops = state.hof, state.pops
        I = pops.cost.shape[0]
        exists = hof.exists
        n_exist = torch.sum(exists.to(torch.int32))
        mask = mask.to(torch.bool) & (n_exist > 0)
        # The existing entries' indices in order first (jnp.nonzero(size=)).
        exist_idx = torch.argsort((~exists).to(torch.int8), stable=True)
        slot = exist_idx[torch.arange(P, device=exists.device) % torch.clamp(n_exist, min=1)]

        def sel(orig, entries):   # orig [I, P, ...], entries [maxsize, ...]
            repl = entries[slot]
            m = mask.reshape((I,) + (1,) * (orig.dim() - 1))
            return torch.where(m, repl.unsqueeze(0).to(orig.dtype), orig)

        fresh = state.birth[:, None] + torch.arange(P, dtype=torch.int32,
                                                    device=state.birth.device)[None, :]
        m2 = mask[:, None]
        new_pops = dataclasses.replace(
            pops,
            trees=TreeBatch(*(sel(o, h) for o, h in zip(pops.trees.fields(),
                                                        hof.trees.fields()))),
            cost=sel(pops.cost, torch.where(exists, hof.cost, math.inf)),
            loss=sel(pops.loss, hof.loss),
            complexity=sel(pops.complexity, hof.complexity),
            birth=torch.where(m2, fresh, pops.birth),
            parent=torch.where(m2, torch.full_like(pops.parent, -1), pops.parent),
            ref=torch.where(m2, fresh, pops.ref),
            params=sel(pops.params, hof.params))
        bump = mask.to(torch.int32) * P
        return dataclasses.replace(state, pops=new_pops, birth=state.birth + bump,
                                   ref=state.ref + bump)

    def _eval(self, trees: TreeBatch, params, data: DeviceData, *, fuse_cost: bool,
              dedup: bool = False):
        """Costs of flat members ``trees`` with their banks ``params``."""
        cfg = self.cfg
        with self._rows(data):
            return eval_cost_batch(trees, data, self.options.elementwise_loss, self.tables,
                                   cfg.operators, cfg.parsimony,
                                   member_params=params if cfg.n_params else None,
                                   turbo=cfg.turbo, fuse_cost=fuse_cost, dedup=dedup,
                                   template=cfg.template, bf16=cfg.eval_bf16,
                                   loss_function=self.options.resolved_loss_function,
                                   dim_penalty=cfg.dim_penalty,
                                   wildcard_constants=cfg.wildcard_constants)

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
            scores = rng.uniform(ko1, (I, P), dtype=self.dtype)
            gate = rng.bernoulli(ko3, gate_p, (I, k_sel), dtype=self.dtype)
        return k_sel, scores, gate, ko2

    # ------------------------------------------------------------------
    @staticmethod
    def state_key(key: torch.Tensor) -> torch.Tensor:
        """The key ``init_state(key, ...)`` leaves in the state."""
        return rng.split(key, 3)[2]

    def init_state(self, key: torch.Tensor, data: DeviceData, n_islands: int,
                   initial_trees: Optional[TreeBatch] = None,
                   initial_params: Optional[torch.Tensor] = None) -> SearchDeviceState:
        """Random populations, scored. ``key`` [2] threefry key words.
        ``n_islands`` is the global count; under a plan the state holds
        this rank's islands, drawn as the unsharded run draws them.
        ``initial_trees`` ([n_islands, P, L], or [n_islands, P, K, L] for
        templates) and ``initial_params`` ([n_islands, P, NP, NC]) take the
        place of the random trees and banks, as in the JAX engine; under a
        plan they are the whole mesh's, and this rank keeps its islands."""
        cfg = self.cfg
        P = cfg.population_size
        dev = self.device
        key = key.to(dev)
        k_init, k_params, k_state = rng.split(key, 3)
        lo, hi = self._islands(n_islands)
        n_loc = hi - lo
        if initial_trees is not None:
            trees = initial_trees.map(lambda t: t.to(dev)[lo:hi])
            trees = dataclasses.replace(trees, const=trees.const.to(self.dtype))
        elif cfg.template is not None:
            trees = init_template_population(rng.split(k_init, n_islands)[lo:hi], P,
                                             cfg.template, cfg.mctx)
        else:
            trees = init_population(rng.split(k_init, n_islands)[lo:hi], P, cfg.mctx)
        if initial_params is not None:
            params = initial_params.to(device=dev, dtype=self.dtype)[lo:hi]
        else:
            params = init_params(k_params, (n_islands, P), cfg.n_params, cfg.n_classes,
                                 self.dtype)[lo:hi]
        cost, loss, cx = self._eval(_flat_trees(trees), _flat(params), data,
                                    fuse_cost=cfg.fuse_cost)
        arange = torch.arange(P, dtype=torch.int32, device=dev)
        pops = PopulationState(
            trees=trees,
            cost=cost.reshape(n_loc, P),
            loss=loss.reshape(n_loc, P),
            complexity=cx.reshape(n_loc, P),
            birth=arange.expand(n_loc, P).clone(),
            ref=arange[None, :] + torch.arange(lo, hi, dtype=torch.int32,
                                               device=dev)[:, None] * 1_000_000,
            parent=torch.full((n_loc, P), -1, dtype=torch.int32, device=dev),
            params=params,
        )
        freq = torch.ones(cfg.maxsize, dtype=torch.float32, device=dev)
        telem = None
        if cfg.collect_telemetry:
            from ..telemetry.counters import empty_iteration_telemetry

            telem = empty_iteration_telemetry(cfg.maxsize, dev)
        state = SearchDeviceState(
            pops=pops,
            hof=empty_hof((), cfg.maxsize, cfg.max_nodes, dev, template_k=template_k(cfg),
                          n_params=cfg.n_params, n_classes=cfg.n_classes, dtype=self.dtype),
            stats=RunningStats(freq, freq / torch.sum(freq)),
            birth=torch.full((n_loc,), P, dtype=torch.int32, device=dev),
            ref=torch.full((n_loc,), P, dtype=torch.int32, device=dev),
            num_evals=torch.tensor(float(n_islands * P), dtype=torch.float32, device=dev),
            key=k_state,
            telem=telem,
        )
        if self.options.debug_checks:
            self._audit_state(state, where="init_state")
        return state

    def _audit_state(self, state: SearchDeviceState, where: str) -> None:
        """graftlint's runtime audit (``Options(debug_checks=True)``): the
        postfix-encoding invariants of the population and the hall of fame
        after mutation, crossover and migration rewrote them
        (lint/runtime.py). Copies the tables to the host; debug tier only."""
        from ..lint.runtime import validate_programs

        cfg = self.cfg
        # Template members carry a subexpression axis whose feature counts
        # vary by slot: no feature-range check there.
        nfeat = None if cfg.template is not None else self.nfeatures
        n_params = None if cfg.template is not None else cfg.n_params
        validate_programs(state.pops.trees, cfg.operators, nfeatures=nfeat,
                          n_params=n_params, where=f"engine {where}: population")
        # Empty hall-of-fame slots hold the all-padding single-constant
        # tree, which is itself valid.
        validate_programs(state.hof.trees, cfg.operators, nfeatures=nfeat,
                          n_params=n_params, where=f"engine {where}: hall of fame")

    def draw_batch(self, k_batch, data: DeviceData) -> Optional[DeviceData]:
        """With ``batching``, this iteration's minibatch: ``batch_size``
        rows drawn as ``jax.random.randint(k_batch, (batch_size,), 0, n)``
        over the whole dataset's ``n`` rows and gathered into contiguous
        tensors (under a data-row shard, those in this rank's block); else
        None."""
        if not self.cfg.batching:
            return None
        return data.take_rows(rng.randint(k_batch, (self.cfg.batch_size,), 0, data.n_global))

    # ------------------------------------------------------------------
    def run_iteration(self, state: SearchDeviceState, data: DeviceData, cur_maxsize: int,
                      chunk_sizes: Optional[Sequence[int]] = None,
                      should_stop: Optional[Callable] = None):
        """One full iteration of every island.

        ``chunk_sizes`` (summing to ``ncycles_per_iteration``) runs the
        cycles in chunks with ``should_stop`` polled between them; it gets
        a thunk for the evaluations of the cycles run so far (forcing it
        waits for the device, so only a ``max_evals`` check calls it) and
        returns True to stop. A stop skips the remaining chunks but still
        runs the epilogue (optimize, simplify, finalize, migrate) exactly
        once; the annealing ramp and the per-cycle keys use global cycle
        indices, so chunked and single-chunk iterations are otherwise
        bit-identical. Returns the new state, or ``(state, CycleEvents)``
        with ``use_recorder``. Under a plan the state is this rank's
        block and every rank of the mesh must make the call (the
        epilogue's collectives); a ``should_stop`` must then decide alike
        on every rank (the search runs mesh iterations in one chunk)."""
        with self._rows(data):
            return self._run_iteration(state, data, cur_maxsize, chunk_sizes, should_stop)

    def _run_iteration(self, state: SearchDeviceState, data: DeviceData, cur_maxsize: int,
                       chunk_sizes, should_stop):
        cfg = self.cfg
        options = self.options
        I = state.birth.shape[0] * self.n_island_shards   # the global island count
        lo, hi = self._islands(I)
        ks = rng.split(state.key, 5)
        key, k_batch, k_cycle, k_opt, k_mig = (ks[i] for i in range(5))
        # Minibatching: one batch of rows per iteration, gathered once, read
        # by every cycle and the constant optimizer (the finalize reads all
        # rows); evaluations count as batch_size / n of a full one.
        batch = self.draw_batch(k_batch, data)
        eval_fraction = cfg.batch_size / data.n_global if batch is not None else 1.0
        cycle_data = batch if batch is not None else data
        chunked = bool(chunk_sizes) and list(chunk_sizes) != [cfg.ncycles]
        if not chunk_sizes:
            chunk_sizes = [cfg.ncycles]
        if sum(chunk_sizes) != cfg.ncycles:
            raise ValueError(f"chunk_sizes {list(chunk_sizes)} must sum to {cfg.ncycles}")

        keys = rng.split(k_cycle, I)[lo:hi]
        pops, birth, ref = state.pops, state.birth, state.ref
        carry = None
        events = []
        c0 = 0
        for i, nc in enumerate(chunk_sizes):
            out = s_r_cycle(keys, pops, cycle_data, state.stats.normalized_frequencies,
                            cur_maxsize, birth, ref, cfg._replace(ncycles=nc), options,
                            self.tables, options.elementwise_loss, c0=c0,
                            total_cycles=cfg.ncycles, carry_in=carry)
            pops, best_seen, nev, birth, ref, marks = out[:6]
            carry = (best_seen, nev, marks) + ((out[6],) if cfg.collect_telemetry else ())
            if cfg.record_events:
                events.append(out[-1])
            c0 += nc
            # No sync here: quit and timeout polls read the host clock; only
            # a max_evals check forces the thunk.
            if should_stop is not None and i < len(chunk_sizes) - 1 and should_stop(
                    lambda nv=nev: float(torch.sum(nv)) * eval_fraction):
                break
        tele = carry[3] if cfg.collect_telemetry else None
        new_state = self._epilogue(state, data, cur_maxsize, pops, best_seen, nev, birth, ref,
                                   marks, tele, key, k_opt, k_mig, batch, eval_fraction)
        if options.debug_checks:
            self._audit_state(new_state,
                              where="run_iteration(chunked)" if chunked else "run_iteration")
        if cfg.record_events:
            ev = CycleEvents(*(torch.cat(f, dim=1) for f in zip(*events)))
            if self.plan is not None:
                ev = all_gather_tree(ev, group=self._island_group())
            return new_state, ev
        return new_state

    def _epilogue(self, state: SearchDeviceState, data: DeviceData, cur_maxsize: int, pops,
                  best_seen, nev, birth, ref, marks, tele, key, k_opt, k_mig,
                  batch: Optional[DeviceData], eval_fraction: float) -> SearchDeviceState:
        """Everything after the cycles, once per iteration: optimize and
        simplify, the full-dataset finalize, lineage rotation, the
        hall-of-fame merge, migration, running statistics and, with
        telemetry, the iteration's counters."""
        cfg = self.cfg
        options = self.options
        S = self.n_island_shards
        I = state.birth.shape[0] * S     # the global island count
        lo, hi = self._islands(I)
        P = cfg.population_size
        group = self._island_group()

        # Every draw island-major for the global count, then this rank's
        # block: the layout cannot change the streams.
        k_sel, scores, gate, ko2 = self._epilogue_draws(k_opt, I)
        if scores is not None:
            scores, gate = scores[lo:hi], gate[lo:hi]
            if S > 1:
                # decorrelate the shards' optimizer restart draws
                ko2 = rng.fold_in(ko2, self.plan.island_index)
        pops, ref, f_calls = self._island_epilogue(pops, ref, marks[0], marks[1], scores,
                                                   gate, ko2, data, k_sel, batch=batch)
        if self.plan is not None:
            # The cross-shard phases read every island: gather the
            # populations, birth counters, per-island bests and counters
            # (one collective), and add the optimizer's calls in shard order.
            pops, birth, best_seen, nev, tele = all_gather_tree(
                pops, birth, best_seen, nev, tele, group=group)
            f_calls = ordered_sum(f_calls, group)
        num_evals = state.num_evals + torch.sum(nev) * eval_fraction
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
                                   candidate_mask=torch.isfinite(pool.cost), dtype=self.dtype)
            if options.hof_migration:
                zeros = torch.zeros(cfg.maxsize, dtype=torch.int32, device=self.device)
                hof_pool = PopulationState(
                    trees=hof.trees, cost=torch.where(hof.exists, hof.cost, math.inf),
                    loss=hof.loss, complexity=hof.complexity, birth=zeros, ref=zeros,
                    parent=zeros, params=hof.params)
                pops, birth = _migrate(km[1], pops, hof_pool, options.fraction_replaced_hof,
                                       birth, I, P, candidate_mask=hof.exists, dtype=self.dtype)

        # ---- running statistics ----
        sizes = pops.complexity.reshape(-1)
        in_range = (sizes > 0) & (sizes <= cfg.maxsize)
        hist = torch.zeros(cfg.maxsize, dtype=torch.float32, device=self.device).index_add_(
            0, torch.where(in_range, sizes - 1, 0).long(), in_range.to(torch.float32))
        freq = _move_window(state.stats.frequencies + hist, self.window_size, cfg.maxsize)
        stats = RunningStats(freq, freq / torch.sum(freq))

        pops_all = pops
        if self.plan is not None:
            # carve this rank's islands back out of the migrated populations
            pops, birth = _island_block(pops, lo, hi), birth[lo:hi]

        telem = None
        if cfg.collect_telemetry:
            # The cycles' per-island counters summed over islands, plus the
            # finalize re-eval (every member, one launch), the
            # post-migration loss histogram, the member-duplication stats
            # and the complexity histogram, all on the device.
            from ..telemetry.counters import CycleTelemetry, IterationTelemetry, loss_histogram

            cyc = CycleTelemetry(*(f.sum(dim=0, dtype=torch.int32) for f in tele.fields()))
            cyc.eval_rows = cyc.eval_rows + I * P
            cyc.eval_launches = cyc.eval_launches + 1
            fin_rows, fin_unique = self._dup_stats(pops.trees, pops_all.trees)
            telem = IterationTelemetry(cycle=cyc, finalize_rows=fin_rows,
                                       finalize_unique=fin_unique,
                                       loss_hist=loss_histogram(pops_all.loss),
                                       cx_hist=hist.to(torch.int32))
        return SearchDeviceState(pops=pops, hof=hof, stats=stats, birth=birth, ref=ref,
                                 num_evals=num_evals, key=key, telem=telem)

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
        # A named range for torch.profiler (bench/profile_iteration.py); the
        # losses reduce over the row shard of the rows optimized on.
        with torch.profiler.record_function("sr:constant_optimizer"), self._rows(data):
            if cfg.template is not None:
                # One key per island, as the JAX package vmaps it; all
                # islands' members run as one batch.
                out = optimize_constants_template(
                    rng.split(opt_key, I), sub, gate, data, options.elementwise_loss,
                    cfg.operators, self.opt_cfg, cfg.template,
                    # D call sites take their gradient on the eager
                    # interpreter (second order; kernel #5's backward is
                    # first order) and their line search on the kernels.
                    fused=cfg.turbo, params=sub_p,
                    loss_function=options.resolved_loss_function)
            elif cfg.turbo and not cfg.n_params:
                out = optimize_constants_fused(
                    opt_key, sub.reshape(I * k_sel), gate.reshape(I * k_sel), data,
                    options.elementwise_loss, cfg.operators, self.opt_cfg)
                out = (out[0].reshape(I, k_sel, cfg.max_nodes),) + out[1:]
            else:
                out = optimize_constants_batch(
                    rng.split(opt_key, I), sub, gate, data, options.elementwise_loss,
                    cfg.operators, self.opt_cfg, params=sub_p,
                    loss_function=options.resolved_loss_function)
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
        identical (structure, constants) members across this engine's
        islands run once (``fused_loss(dedup=True)``; ``_use_dedup``);
        results are bit-equal. Template and parametric members are all
        re-scored (no dedup, as in the JAX package)."""
        I, P = pops.cost.shape
        cost, loss, cx = self._eval(_flat_trees(pops.trees), _flat(pops.params), data,
                                    fuse_cost=self._finalize_fuse_cost(),
                                    dedup=self._use_dedup())
        return dataclasses.replace(pops, cost=cost.reshape(I, P), loss=loss.reshape(I, P),
                                   complexity=cx.reshape(I, P))


def _island_block(obj, lo: int, hi: int):
    """Islands [lo, hi) of every tensor of a dataclass tree."""
    if isinstance(obj, torch.Tensor):
        return obj[lo:hi]
    return dataclasses.replace(obj, **{f.name: _island_block(getattr(obj, f.name), lo, hi)
                                       for f in dataclasses.fields(obj) if f.init})


def _migrate(key, pops: PopulationState, pool: PopulationState, frac: float, birth,
             I: int, P: int, candidate_mask, dtype: torch.dtype = torch.float32):
    """Replace each member with a random pool candidate with probability
    ``frac``; replaced members get fresh birth ticks. Only a pack of
    about 3 sigma above the binomial mean is gathered; replacements past
    it skip this iteration (as in the JAX package)."""
    if frac <= 0:
        return pops, birth
    k1, k2 = rng.split(key, 2)
    replace = rng.bernoulli(k1, frac, (I, P), dtype=dtype)
    logits = torch.where(candidate_mask, 0.0, -math.inf).to(dtype)
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
