"""The multi-device tooling: the dryrun's fast tier, GL008, the executable
and engine caches under a plan, trend's multi-chip and mesh-scaling rows,
the projection's refusal and ``bench run --baseline-out``."""

import json
import os

import numpy as np
import pytest

import symbolicregression_jl_tpu_torch as srt
from symbolicregression_jl_tpu_torch.bench import __main__ as SB
from symbolicregression_jl_tpu_torch.bench import gate as G
from symbolicregression_jl_tpu_torch.bench import projection
from symbolicregression_jl_tpu_torch.bench.trend import build_trend, format_trend
from symbolicregression_jl_tpu_torch.evolve import rng
from symbolicregression_jl_tpu_torch.lint import lint_paths, lint_source
from symbolicregression_jl_tpu_torch.mesh import MeshPlan, aot
from symbolicregression_jl_tpu_torch.mesh import dryrun
from symbolicregression_jl_tpu_torch.mesh.engine import make_engine
from symbolicregression_jl_tpu_torch.serve.cache import ExecutableCache

from torch_parity import problem

PKG = os.path.dirname(os.path.abspath(srt.__file__))


def test_dryrun_fast_tier_writes_a_green_artifact(tmp_path):
    out = tmp_path / "MULTICHIP.json"
    assert dryrun.main(["--devices", "2", "--fast", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["ok"] is True and rec["rc"] == 0 and rec["n_devices"] == 2
    assert list(rec["legs"]) == ["mesh-jnp"]
    trend = build_trend([str(out)])
    assert trend["multichip"][0]["ok"] and trend["red_count"] == 0
    assert "multi-chip dryrun" in format_trend(trend)


def test_gl008_fires_on_rank_branched_collectives_and_not_on_the_mesh_modules():
    bad = (
        "import torch.distributed as dist\n"
        "def f(t, group, out, rank):\n"
        "    if rank == 0:\n"
        "        dist.broadcast(t, 0, group=group)\n"
        "    a = all_gather_islands(t, group=group)\n"
        "    n = a.sum().item()\n"
        "    b = ordered_sum(t, group)\n"
        "    return a, b, n\n")
    found = [f for f in lint_source(bad, "symbolicregression_jl_tpu_torch/mesh/x.py")
             if f.rule_id == "GL008"]
    assert [f.line for f in found] == [4, 6]
    assert not [f for f in lint_source(bad, "symbolicregression_jl_tpu_torch/ops/x.py")
                if f.rule_id == "GL008"]
    mine = lint_paths([os.path.join(PKG, "mesh"), os.path.join(PKG, "parallel")])
    assert [f for f in mine if f.rule_id == "GL008"] == []


def test_executable_and_engine_caches_take_the_plan():
    X, y = problem(0, n=64)
    o = srt.Options(binary_operators=["+", "*"], unary_operators=["cos"], maxsize=8,
                    populations=2, population_size=8, tournament_selection_n=4,
                    ncycles_per_iteration=2, save_to_file=False)
    ds = srt.make_dataset(X, y, device="cpu")
    ds.update_baseline_loss(o.elementwise_loss)
    plan = MeshPlan.build([0])
    aot.executable_cache_stats(clear=True)
    first = make_engine(o, 3, device="cpu", plan=plan, mesh_runtime=True)
    ex = aot.compile_iteration(first, data=ds.data)
    second = make_engine(o, 3, device="cpu", plan=plan, mesh_runtime=True)
    assert aot.compile_iteration(second, data=ds.data) is ex and ex.engine is first
    assert aot.executable_cache_stats()["hits"] == 1 and ex.n_devices == 1
    s0 = first.init_state(rng.key(1), ds.data, 2)
    a = ex.run(s0, ds.data, o.maxsize)
    b = second.run_iteration(second.init_state(rng.key(1), ds.data, 2), ds.data, o.maxsize)
    assert np.array_equal(a.pops.cost.numpy(), b.pops.cost.numpy(), equal_nan=True)
    assert np.array_equal(a.pops.trees.op.numpy(), b.pops.trees.op.numpy())

    cache = ExecutableCache()
    kw = dict(nfeatures=3, dtype="float32", n_params=0, n_classes=0, device="cpu", rows=64)
    e1 = cache.get_engine(o, plan=plan, mesh_runtime=True, **kw)
    assert cache.get_engine(o, plan=plan, mesh_runtime=True, **kw) is e1
    assert type(e1).__name__ == "MeshEngine"
    e2 = cache.get_engine(o, plan=plan, mesh_runtime=False, **kw)
    e3 = cache.get_engine(o, plan=plan.replace(sharded_dedup=False), mesh_runtime=True, **kw)
    e4 = cache.get_engine(o, **kw)
    assert len({id(e) for e in (e1, e2, e3, e4)}) == 4 and e4.plan is None
    assert cache.hits == 1 and cache.misses == 4


def test_trend_folds_mesh_scaling_and_red_dryruns(tmp_path):
    (tmp_path / "scaling.json").write_text(json.dumps({
        "schema": "graftmesh.scaling.v1", "matrix": "mini",
        "points": [{"shards": 1, "evals_per_sec": 10.0}, {"shards": 2, "error": "boom"}]}))
    (tmp_path / "MULTICHIP_r09.json").write_text(json.dumps(
        {"n_devices": 4, "rc": 124, "ok": False, "legs": {}}))
    trend = build_trend([str(tmp_path)])
    assert trend["mesh_scaling"][0]["red"] and "shards=2" in trend["mesh_scaling"][0]["note"]
    assert trend["multichip"][0]["red"] and trend["multichip"][0]["round"] == 9
    assert trend["red_count"] == 2
    assert "measured mesh scaling" in format_trend(trend)


def test_projection_refuses_the_tpu_model():
    with pytest.raises(NotImplementedError, match="TPU v5e"):
        projection.v5e8_comm_efficiency(1.0)
    with pytest.raises(NotImplementedError, match="TPU v5e"):
        projection.load_ici_model()


def test_baseline_out(tmp_path, capsys):
    committed = os.path.join(os.path.dirname(PKG), "benchmarks", "baseline.json")
    before = open(committed, "rb").read()
    assert SB.main(["run", "--variants", "plain", "--seeds", "0", "--device", "cpu",
                    "--baseline-out", committed]) == 2
    assert "refusing to write over the committed" in capsys.readouterr().err
    assert open(committed, "rb").read() == before
    cell = lambda v: {"cell_id": "plain/seed0", "variant": "plain", "seed": 0,
                      "metrics": {"best_loss": v, "pareto_volume": 0.3, "evals_per_sec": 100.0}}
    runs = [G.make_result([cell(v)], matrix="mini", platform="cpu") for v in (1.0, 1.2, 1.1)]
    bands = G.calibrate_bands(runs)
    assert bands["best_loss"].rel >= 2 * 0.2 / 1.1 - 1e-9
    base = G.make_baseline(runs, bands)
    assert base["schema"] == G.BASELINE_SCHEMA and base["repeats"] == 3
    assert base["cells"]["plain/seed0"]["metrics"]["best_loss"] == 1.1
    path = tmp_path / "pinned.json"
    path.write_text(json.dumps(base))
    assert G.load_baseline(str(path))["cells"].keys() == {"plain/seed0"}
    with pytest.raises(ValueError, match="non-finite best_loss"):
        G.make_baseline([G.make_result([cell(float("nan"))], matrix="mini", platform="cpu")])
