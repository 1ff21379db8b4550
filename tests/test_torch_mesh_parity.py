"""The port's 2-shard MeshEngine against the JAX package's 2-shard
MeshEngine (turbo off, the constant optimizer off).

One JAX MeshEngine iteration runs on the conftest's virtual CPU mesh
(2 devices); the port runs the same iteration on 2 gloo ranks, each from
its block of the same JAX state (``MeshPlan.place_state``). Integer
structures (tree encodings, ``exists``, the hall of fame's structure,
``num_evals``) must be exactly equal; costs and losses within rtol 1e-5
with inf in the same places (the packages sum rows in different orders).
The setup is tests/test_torch_evolve.py::test_run_iteration_equal's at 4
islands, with seeds whose unsharded iterations agree between the
packages. Seed 0 parts in one member's padding between the two packages'
unsharded engines already (a 2-ULP cost tie in the hall-of-fame merge,
tests/test_torch_island_tie.py), and seeds 1, 2 and 4 with annealing on
a temperature-0 tie, so their meshes part there too: the JAX mesh equals
the JAX unsharded engine at every seed, and the port's mesh the port's
unsharded engine (tests/test_torch_mesh_engine.py).
"""

import os

import jax
import numpy as np
import pytest

import symbolicregression_jl_tpu as J
from symbolicregression_jl_tpu.mesh import MeshEngine as JMeshEngine
from symbolicregression_jl_tpu.mesh import MeshPlan as JMeshPlan
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.parallel.launch import run_ranks

from torch_parity import assert_close, assert_pops_equal, numpy_state, problem, to_np

TESTS = os.path.dirname(os.path.abspath(__file__))
MAXSIZE = 15
OPTIONS = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
               maxsize=MAXSIZE, should_optimize_constants=False, save_to_file=False,
               populations=4, population_size=16, ncycles_per_iteration=3,
               tournament_selection_n=8, turbo=False)


@pytest.mark.parametrize("annealing,seed", [(True, 3), (False, 2)])
def test_two_shard_mesh_engine_matches_jax(annealing, seed, tmp_path):
    import torch_mesh_workers as W

    X, y = problem(seed)
    options = dict(OPTIONS, annealing=annealing)
    jo = J.Options(**options)
    jds = J.make_dataset(X, y)
    jds.update_baseline_loss(jo.elementwise_loss)
    plan = JMeshPlan.build(jax.devices()[:2], n_island_shards=2)
    je = JMeshEngine(jo, X.shape[1], plan)
    data = plan.place_data(jds.data)
    js = plan.place_state(je.init_state(jax.random.key(seed), data, jo.populations))
    start = W.to_numpy(interop.search_state(numpy_state(js), device="cpu"))
    js2 = jax.device_get(je.run_iteration(js, data, MAXSIZE))

    ranks = run_ranks("torch_mesh_workers:run_engine", 2,
                      kwargs=dict(X=X, y=y, options_kw=options, seed=seed, niter=1, plan_kw={},
                                  mesh_runtime=True, state=start),
                      sys_path=[TESTS], timeout_s=110, workdir=str(tmp_path / "ranks"))
    ss = ranks[0]["state"]
    assert_pops_equal(js2.pops, ss.pops)
    assert np.array_equal(to_np(js2.hof.exists), ss.hof.exists)
    ex = to_np(js2.hof.exists)
    for f in ("arity", "op", "feat", "length"):
        assert np.array_equal(to_np(getattr(js2.hof.trees, f))[ex],
                              getattr(ss.hof.trees, f)[ex]), f"hof {f}"
    assert np.array_equal(to_np(js2.hof.complexity)[ex], ss.hof.complexity[ex])
    assert_close(to_np(js2.hof.cost)[ex], ss.hof.cost[ex], 1e-5, "hof cost")
    assert float(js2.num_evals) == float(ss.num_evals)
    assert np.array_equal(to_np(js2.birth), ss.birth)
    assert np.array_equal(to_np(js2.ref), ss.ref)
    assert np.array_equal(to_np(jax.random.key_data(js2.key)).view(np.uint32),
                          ss.key.view(np.uint32))
    # both ranks hold the same global state
    assert np.array_equal(ranks[1]["state"].hof.cost, ss.hof.cost, equal_nan=True)
