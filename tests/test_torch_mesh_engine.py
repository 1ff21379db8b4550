"""The port's island mesh against its own unsharded engine.

- N island shards (2 and 4 gloo ranks) are bit-identical to the unsharded
  run with the constant optimizer off, on the mesh runtime and on the
  legacy sharded runtime, turbo on and off (the kernels' plain versions
  on the CPU): every draw is global and sliced, and each tree's result is
  independent of the other trees in its launch.
- A 1-shard mesh is bit-identical to the plain Engine with the optimizer
  on, on both runtimes.
- Per-shard finalize dedup on and off are bit-identical; the dedup-key
  exchange's invariants hold; the duplication counters are summed over
  the shards on the mesh runtime and zero on the legacy one.
"""

import dataclasses
import os

import numpy as np
import pytest

import symbolicregression_jl_tpu_torch as srt
from symbolicregression_jl_tpu_torch.api.checkpoint import map_arrays
from symbolicregression_jl_tpu_torch.mesh import MeshEngine, MeshPlan
from symbolicregression_jl_tpu_torch.parallel.launch import run_ranks
from symbolicregression_jl_tpu_torch.parallel.mesh import make_mesh

from torch_parity import problem

TESTS = os.path.dirname(os.path.abspath(__file__))
OPTIONS = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos"], maxsize=10,
               populations=4, population_size=16, ncycles_per_iteration=3,
               tournament_selection_n=8, save_to_file=False, fraction_replaced=0.3)


def _leaves(state):
    out = []
    map_arrays(state, out.append)
    return out


def assert_bits_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        bits = lambda a: np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        assert np.array_equal(bits(x), bits(y)), f"leaf {i} differs"


def _ranks(tmp_path, n, **kw):
    return run_ranks("torch_mesh_workers:run_engine", n, kwargs=kw, sys_path=[TESTS],
                     timeout_s=110, workdir=str(tmp_path / f"ranks{n}"))


@pytest.mark.parametrize("n,mesh_runtime,turbo", [(2, True, False), (4, True, True),
                                                  (2, False, True), (4, False, False)])
def test_n_shards_bit_identical_to_unsharded(n, mesh_runtime, turbo, tmp_path):
    import torch_mesh_workers as W

    X, y = problem(1)
    kw = dict(OPTIONS, optimizer_probability=0.0, turbo=turbo, telemetry=True)
    ref = W.run_engine(X, y, kw, 1, 2, telemetry=True)
    out = _ranks(tmp_path, n, X=X, y=y, options_kw=kw, seed=1, niter=2, plan_kw={},
                 mesh_runtime=mesh_runtime, telemetry=True)
    strip = lambda st: dataclasses.replace(st, telem=None)   # compared below
    for r in range(n):
        assert_bits_equal(strip(ref["state"]), strip(out[r]["state"]))
    # the cycles' counters and histograms are the unsharded ones; the
    # duplication counters are summed per shard (mesh) or zero (legacy)
    for a, b in zip(ref["telem"], out[0]["telem"]):
        assert_bits_equal(a.cycle, b.cycle)
        assert np.array_equal(a.loss_hist, b.loss_hist)
        assert np.array_equal(a.cx_hist, b.cx_hist)
        if mesh_runtime:
            assert int(b.finalize_rows) == int(a.finalize_rows) == 4 * 16
            assert int(a.finalize_unique) <= int(b.finalize_unique) <= int(b.finalize_rows)
        else:
            assert int(b.finalize_rows) == int(b.finalize_unique) == 0
    if mesh_runtime:
        ex = out[0]["exchange"]
        assert ex["rows"] == 4 * 16 == ex["shard_unique"] + ex["local_dup"]
        assert ex["global_unique"] <= ex["shard_unique"] <= ex["rows"]
        assert len(ex["per_shard_unique"]) == n and sum(ex["per_shard_unique"]) == ex["shard_unique"]


@pytest.mark.parametrize("mesh_runtime", [True, False])
@pytest.mark.parametrize("turbo", [False, True])
def test_one_shard_mesh_bit_identical_to_engine_optimizer_on(mesh_runtime, turbo):
    """No process group: a 1-rank mesh whose collectives are the identity."""
    import torch_mesh_workers as W

    X, y = problem(2)
    kw = dict(OPTIONS, optimizer_probability=0.5, optimizer_iterations=3, turbo=turbo)
    ref = W.run_engine(X, y, kw, 2, 2)
    out = W.run_engine(X, y, kw, 2, 2, plan_kw={}, mesh_runtime=mesh_runtime)
    assert_bits_equal(ref["state"], out["state"])


def test_sharded_dedup_bit_neutral_and_optimizer_on_runs(tmp_path):
    import torch_mesh_workers as W

    X, y = problem(3)
    kw = dict(OPTIONS, optimizer_probability=0.0, turbo=True)
    on = _ranks(tmp_path / "on", 2, X=X, y=y, options_kw=kw, seed=3, niter=2,
                plan_kw={"sharded_dedup": True}, mesh_runtime=True)
    off = _ranks(tmp_path / "off", 2, X=X, y=y, options_kw=kw, seed=3, niter=2,
                 plan_kw={"sharded_dedup": False}, mesh_runtime=True)
    assert_bits_equal(on[0]["state"], off[0]["state"])
    assert on[0]["exchange"]["sharded_dedup"] and not off[0]["exchange"]["sharded_dedup"]
    # the optimizer on, 2 shards: the restart keys are per shard (not the
    # unsharded bits), the populations finite, the hall of fame filled
    kw = dict(OPTIONS, optimizer_probability=0.5, optimizer_iterations=3, turbo=True)
    opt = _ranks(tmp_path / "opt", 2, X=X, y=y, options_kw=kw, seed=3, niter=2, plan_kw={},
                 mesh_runtime=True)
    st = opt[0]["state"]
    assert not np.isnan(st.pops.cost).any() and np.isfinite(st.pops.cost).mean() > 0.5
    assert st.hof.exists.any() and np.isfinite(st.hof.cost[st.hof.exists]).all()
    assert_bits_equal(st, opt[1]["state"])


def test_mesh_engine_refuses_data_shards():
    X, y = problem(0)
    plan = MeshPlan.build([0, 1], n_island_shards=1, n_data_shards=2)
    with pytest.raises(NotImplementedError, match="MeshEngine shards the island axis only"):
        MeshEngine(srt.Options(**OPTIONS), X.shape[1], plan, device="cpu")
    with pytest.raises(ValueError, match=r"mesh shape 3x2 != 8 devices"):
        make_mesh(list(range(8)), n_island_shards=3, n_data_shards=2)
