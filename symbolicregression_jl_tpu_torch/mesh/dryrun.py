"""The mesh dryrun tier: fast, budgeted, artifact-producing (port of
``mesh/dryrun.py``).

``python -m symbolicregression_jl_tpu_torch.mesh.dryrun --devices N --out f``
spawns N gloo CPU ranks (``parallel/launch.py``; a ``file://`` store, no
port), runs the island mesh end to end on them and writes the MULTICHIP
artifact JSON (``n_devices`` / ``rc`` / ``ok`` / ``legs``) that ``bench
trend`` folds into the trajectory.

Legs (each under a graftshield watchdog budget, ``SR_DRYRUN_LEG_BUDGET``
seconds, so a runaway leg aborts its rank with a thread dump instead of an
opaque timeout):

- ``mesh-jnp`` — the mesh runtime on the eager path (turbo off): finite
  populations, a hall of fame that decodes, and migration that moved
  genomes across shards (the pool's all-gather mixes the mesh).
- ``mesh-turbo-dedup`` — the kernel path (the wrappers' plain versions on
  the CPU) with per-shard finalize dedup, bit-identical to the same run
  with dedup off, and one dedup-key exchange with its invariants.
- ``mesh-staged`` — graftstage's staged evaluation on the mesh: every
  population and hall-of-fame cost a finite full-dataset value.
- ``mesh-cache`` — the executable cache (mesh/aot.py): an engine cached
  once, a second request with the same key served it, and an iteration
  through the cached engine equal to a fresh engine's.
- ``legacy-turbo`` / ``legacy-template`` / ``legacy-datagrid`` — the
  default runtime (``mesh_runtime=False``): plain and template
  expressions on the kernel path under island shards, and the (island,
  data) grid (four or more ranks): plain and template expressions on the
  kernel path with the rows' partials added over the data axis.

``--fast`` runs ``mesh-jnp`` only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["make_dryrun_problem", "run_dryrun", "run_legs", "check_populations",
           "check_migration_mixed", "main"]


def _leg_budget_s() -> float:
    return float(os.environ.get("SR_DRYRUN_LEG_BUDGET", "240"))


def _legs(fast: bool):
    legs = [("mesh-jnp", _leg_jnp)]
    if not fast:
        legs += [("mesh-turbo-dedup", _leg_turbo_dedup),
                 ("mesh-staged", _leg_staged),
                 ("mesh-cache", _leg_cache),
                 ("legacy-turbo", _leg_legacy_turbo),
                 ("legacy-template", _leg_legacy_template),
                 ("legacy-datagrid", _leg_legacy_datagrid)]
    return legs


def _total_budget_s(fast: bool) -> float:
    """The whole dryrun's backstop, rank start-up included: from the
    per-leg budget, so no legally budgeted run exceeds it;
    ``SR_DRYRUN_BUDGET`` overrides."""
    explicit = float(os.environ.get("SR_DRYRUN_BUDGET", "0"))
    if explicit > 0:
        return explicit
    return len(_legs(fast)) * _leg_budget_s() + 120.0


def make_dryrun_problem(n_rows: int, nfeatures: int = 5, seed: int = 0):
    """The bench family's synthetic problem (bench/headline.py's law)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.uniform(-3.0, 3.0, (n_rows, nfeatures)).astype(np.float32)
    y = (np.cos(2.13 * X[:, 0]) + 0.5 * X[:, 1] * np.abs(X[:, 2]) ** 0.9
         - 0.3 * np.abs(X[:, 3]) ** 1.5).astype(np.float32)
    return X, y


def _options(n_island_shards: int, turbo: bool, expression_spec=None, **extra):
    from ..core.options import Options

    return Options(
        expression_spec=expression_spec,
        binary_operators=["+", "-", "*", "/"],
        unary_operators=["cos"],
        maxsize=10,
        populations=2 * n_island_shards,   # 2 islands per shard
        population_size=32,
        ncycles_per_iteration=3,
        tournament_selection_n=8,
        optimizer_probability=0.5,
        optimizer_iterations=2,
        optimizer_nrestarts=1,
        # heavy migration, so the cross-shard mixing check has teeth
        fraction_replaced=0.3,
        save_to_file=False,
        turbo=turbo,
        **extra,
    )


def _build(n_island_shards: int, n_data_shards: int = 1, turbo: bool = False,
           mesh_runtime: bool = True, sharded_dedup: bool = True, expression_spec=None,
           **opt_extra):
    from ..core.dataset import make_dataset
    from ..evolve import rng
    from .engine import make_engine
    from .plan import MeshPlan

    options = _options(n_island_shards, turbo, expression_spec=expression_spec, **opt_extra)
    X, y = make_dryrun_problem(512)
    ds = make_dataset(X, y, device="cpu")
    ds.update_baseline_loss(options.elementwise_loss)
    plan = MeshPlan.build(n_island_shards=n_island_shards, n_data_shards=n_data_shards,
                          sharded_dedup=sharded_dedup)
    engine = make_engine(options, ds.nfeatures, device="cpu", plan=plan,
                         mesh_runtime=mesh_runtime)
    data = plan.place_data(ds.data)
    state = engine.init_state(rng.key(0), data, options.populations)
    return engine, state, data, options


def _iterate(engine, state, data, options, n: int = 2):
    for _ in range(n):
        state = engine.run_iteration(state, data, options.maxsize)
    return state


def check_populations(engine, state, options) -> None:
    import numpy as np

    from ..api.hall_of_fame import HallOfFame

    full = engine.plan.gather_state(state)
    cost = full.pops.cost.cpu().numpy()
    assert not np.isnan(cost).any(), "NaN costs after mesh iteration"
    assert not np.isnan(full.pops.loss.cpu().numpy()).any(), "NaN losses after mesh iteration"
    assert np.isfinite(cost).mean() > 0.5, f"only {np.isfinite(cost).mean():.0%} finite costs"
    exists = full.hof.exists.cpu().numpy()
    assert exists.any(), "hall of fame empty after the mesh iterations"
    hof = HallOfFame.from_device(full.hof, options.operators, template=engine.template)
    assert len(hof.entries) == int(exists.sum()), "hall of fame does not decode"
    assert np.isfinite(full.hof.cost.cpu().numpy()[exists]).all(), "non-finite HoF costs"


def check_migration_mixed(engine, state, options) -> None:
    """Identical non-trivial trees on islands of different shards after
    2 heavy-migration iterations: the pool's all-gather moved genomes
    across the mesh."""
    full = engine.plan.gather_state(state)
    tr = full.pops.trees
    per_shard = options.populations // engine.n_island_shards
    arity, op, feat, length = (t.cpu().numpy() for t in (tr.arity, tr.op, tr.feat, tr.length))
    by_tree: Dict[tuple, set] = {}
    for i in range(arity.shape[0]):
        for p in range(arity.shape[1]):
            n = int(length[i, p])
            if n <= 1:
                continue   # single leaves collide by chance
            key = (tuple(arity[i, p][:n].tolist()), tuple(op[i, p][:n].tolist()),
                   tuple(feat[i, p][:n].tolist()))
            by_tree.setdefault(key, set()).add(i // per_shard)
    crossed = sum(1 for shards in by_tree.values() if len(shards) > 1)
    assert crossed > 0, ("no identical non-trivial trees shared across island shards: "
                         "mesh migration does not mix across the mesh")


def _same_bits(a, b) -> bool:
    """Every tensor of two state trees equal bit for bit."""
    import torch

    from ..api.checkpoint import map_arrays

    la, lb = [], []
    map_arrays(a, la.append)
    map_arrays(b, lb.append)
    bits = lambda t: t.contiguous().reshape(-1).view(torch.uint8)
    return len(la) == len(lb) and all(x.dtype == y.dtype and x.shape == y.shape
                                      and torch.equal(bits(x), bits(y)) for x, y in zip(la, lb))


def _leg_jnp(n: int) -> None:
    engine, state, data, options = _build(n, turbo=False)
    state = _iterate(engine, state, data, options)
    check_populations(engine, state, options)
    if n > 1:
        check_migration_mixed(engine, state, options)


def _leg_turbo_dedup(n: int) -> None:
    engine, state, data, options = _build(n, turbo=True)
    assert engine.cfg.turbo, "the turbo leg must run the kernel path"
    assert engine._use_dedup(), "the mesh runtime keeps finalize dedup under sharding"
    state = _iterate(engine, state, data, options)
    check_populations(engine, state, options)
    # dedup on/off is result-neutral: the same search with it off, bit for bit
    engine2, state2, data2, _ = _build(n, turbo=True, sharded_dedup=False)
    assert not engine2._use_dedup() or n == 1
    state2 = _iterate(engine2, state2, data2, options)
    assert _same_bits(_core(state), _core(state2)), (
        "sharded finalize dedup changed the search result")
    print("dryrun dedup on/off: bit-identical", flush=True)
    ex = engine.dedup_exchange(state)
    assert ex["global_unique"] <= ex["shard_unique"] <= ex["rows"], ex
    assert ex["rows"] == options.populations * options.population_size, ex
    assert ex["rows"] == ex["shard_unique"] + ex["local_dup"], ex
    print(f"dryrun dedup exchange: {ex['rows']} rows, {ex['shard_unique']} shard-unique, "
          f"{ex['global_unique']} global-unique, {ex['exchanged_bytes']} B in "
          f"{ex['exchange_time_s']:.3f}s", flush=True)


def _core(state):
    """The state's populations, hall of fame, counters and statistics."""
    return (state.pops, state.hof, state.birth, state.ref, state.stats, state.num_evals)


def _leg_staged(n: int) -> None:
    engine, state, data, options = _build(n, turbo=True, staged_eval=True,
                                          staged_sample_fraction=0.25, rescore_fraction=0.3)
    assert engine.cfg.staged_eval, "the staged leg must run the staged path"
    state = _iterate(engine, state, data, options)
    check_populations(engine, state, options)
    if n > 1:
        check_migration_mixed(engine, state, options)


def _leg_cache(n: int) -> None:
    from .aot import compile_iteration, executable_cache_stats

    executable_cache_stats(clear=True)
    engine, state, data, options = _build(n, turbo=False)
    ex = compile_iteration(engine, state, data)
    fresh, state2, _, _ = _build(n, turbo=False)
    ex2 = compile_iteration(fresh, state2, data)
    stats = executable_cache_stats()
    assert ex2 is ex and ex.engine is engine and stats["hits"] == 1 and stats["misses"] == 1, \
        stats
    out = ex.run(state, data, options.maxsize)
    ref = fresh.run_iteration(state2, data, options.maxsize)
    assert _same_bits(_core(out), _core(ref)), (
        "an iteration through the cached engine differs from a fresh engine's")
    print(f"dryrun cache: one build, one hit (key {ex.cache_key[:12]})", flush=True)


def _run_legacy(n: int, *, mode: str) -> None:
    from ..models import template_spec

    spec = template_spec(expressions=("f", "g"))(
        lambda f, g, x1, x2, x3, x4, x5: f(x1, x2) + g(x3))
    if mode == "turbo":
        engine, state, data, options = _build(n, turbo=True, mesh_runtime=False)
        assert engine.cfg.turbo, "the legacy turbo leg must run the kernel path"
    elif mode == "template":
        engine, state, data, options = _build(n, turbo=True, mesh_runtime=False,
                                              expression_spec=spec)
    else:
        if n < 4 or n % 2:
            return
        # the (island, data) grid on the kernel path: rows split over the
        # data axis, each launch's row sums added in shard order; a plain
        # and a template search
        _datagrid(n, None)
        _datagrid(n, spec)
        return
    state = _iterate(engine, state, data, options)
    check_populations(engine, state, options)


def _datagrid(n: int, expression_spec) -> None:
    engine, state, data, options = _build(n // 2, n_data_shards=2, turbo=True,
                                          mesh_runtime=False, expression_spec=expression_spec)
    assert engine.cfg.turbo and data.row_shard is not None
    state = _iterate(engine, state, data, options)
    check_populations(engine, state, options)


def _leg_legacy_turbo(n: int) -> None:
    _run_legacy(n, mode="turbo")


def _leg_legacy_template(n: int) -> None:
    _run_legacy(n, mode="template")


def _leg_legacy_datagrid(n: int) -> None:
    _run_legacy(n, mode="datagrid")


def run_legs(fast: bool = False) -> List[Tuple[str, float]]:
    """One rank's part: every leg on this rank's group (each rank of the
    run makes the call). Returns [(leg, seconds)]; a leg over its budget
    aborts the rank (exit code 3) with a thread dump."""
    import torch

    from ..parallel import multihost
    from ..shield.watchdog import Watchdog

    torch.set_num_threads(1)
    n = multihost.process_count()

    def abort(dump: str) -> None:
        sys.stderr.write(dump)
        sys.stderr.flush()
        os._exit(3)

    budget = _leg_budget_s()
    wd = Watchdog(on_timeout=abort)
    timings: List[Tuple[str, float]] = []
    try:
        for name, leg in _legs(fast):
            t0 = time.time()
            with wd.phase(name, budget):
                leg(n)
            dt = time.time() - t0
            timings.append((name, dt))
            print(f"dryrun leg {name}: {dt:.1f}s (budget {budget:.0f}s)", flush=True)
    finally:
        wd.stop()
    return timings


def run_dryrun(n_devices: int = 8, fast: bool = False, out: Optional[str] = None) -> Dict:
    """Run the dryrun on ``n_devices`` gloo CPU ranks and return the
    MULTICHIP artifact record (``out`` is written by ``main``)."""
    from ..parallel.launch import RankFailure, run_ranks

    del out
    rec: Dict = {"n_devices": n_devices, "rc": 0, "ok": True, "skipped": False, "tail": "",
                 "legs": {}}
    logs: List[str] = []
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")
    try:
        res = run_ranks("symbolicregression_jl_tpu_torch.mesh.dryrun:run_legs", n_devices,
                        kwargs={"fast": fast}, backend="gloo",
                        timeout_s=_total_budget_s(fast), env=env, logs=logs)
        rec["legs"] = dict(res[0])
        rec["tail"] = logs[0][-500:] if logs else ""
    except RankFailure as e:
        msg = str(e)
        rc = 124 if "deadline" in msg.splitlines()[0] else 1
        rec.update(rc=rc, ok=False, tail=msg[-2000:])
    for line in (logs[0] if logs else "").splitlines():
        if line.startswith("dryrun "):
            print(line, flush=True)
    return rec


def _write_artifact(path: str, rec: Dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m symbolicregression_jl_tpu_torch.mesh.dryrun",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--devices", type=int, default=8, help="gloo CPU ranks to spawn")
    ap.add_argument("--out", default=None, help="write the MULTICHIP artifact JSON here")
    ap.add_argument("--fast", action="store_true", help="the mesh-jnp leg only")
    args = ap.parse_args(argv)
    rec = run_dryrun(args.devices, fast=args.fast, out=args.out)
    if args.out:
        _write_artifact(args.out, rec)
        print(f"wrote {args.out}")
    status = "green" if rec["ok"] else f"RED rc={rec['rc']}"
    print(f"mesh dryrun: {rec['n_devices']} device(s) [{status}]")
    if not rec["ok"]:
        sys.stderr.write(rec["tail"] + "\n")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
