"""One engine iteration at 4 islands (tests/test_torch_evolve.py's
``test_run_iteration_equal`` setup: 16 members an island, 3 cycles,
``turbo=False``, the optimizer off), the port started from the JAX
package's state.

Seed 0 parts between the packages in one member's padding, and nowhere
else: the tie below. Each package's own runs are consistent; the parting
comes from starting the port on costs the JAX package computed. The
other seeds agree in every field.
"""

import jax
import numpy as np
import pytest

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine
from symbolicregression_jl_tpu_torch.evolve.step import eval_cost_batch

from torch_parity import assert_close, assert_pops_equal, numpy_state, problem, to_np

MAXSIZE = 15
ISLANDS = 4


@pytest.fixture(scope="module")
def engines():
    cache = {}

    def get(annealing):
        if annealing not in cache:
            kw = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
                      maxsize=MAXSIZE, should_optimize_constants=False, save_to_file=False,
                      populations=ISLANDS, population_size=16, ncycles_per_iteration=3,
                      tournament_selection_n=8, annealing=annealing, turbo=False)
            jo, so = J.Options(**kw), S.Options(**kw)
            cache[annealing] = (jo, so, JEngine(jo, 3), SEngine(so, 3, device="cpu"))
        return cache[annealing]

    return get


def _iterate(engines, annealing, seed):
    jo, so, je, se = engines(annealing)
    X, y = problem(seed)
    jds = J.make_dataset(X, y)
    jds.update_baseline_loss(jo.elementwise_loss)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    js = je.init_state(jax.random.key(seed), jds.data, ISLANDS)
    ss = interop.search_state(numpy_state(js), device="cpu")
    return je.run_iteration(js, jds.data, MAXSIZE), se.run_iteration(ss, sd, MAXSIZE), so, se, sd


@pytest.mark.parametrize("annealing,seed", [(False, 3), (False, 6), (True, 6)])
def test_run_iteration_equal_four_islands(engines, annealing, seed):
    """Every field equal (costs within rtol 1e-5); seed 6 agrees, with and
    without annealing."""
    js2, ss2, *_ = _iterate(engines, annealing, seed)
    assert_pops_equal(js2.pops, ss2.pops)
    ex = to_np(js2.hof.exists)
    assert np.array_equal(ex, to_np(ss2.hof.exists))
    for f in ("arity", "op", "feat", "length"):
        assert np.array_equal(to_np(getattr(js2.hof.trees, f))[ex],
                              to_np(getattr(ss2.hof.trees, f))[ex]), f
    assert_close(to_np(js2.hof.cost)[ex], to_np(ss2.hof.cost)[ex], 1e-5, "hof cost")
    assert float(js2.num_evals) == float(ss2.num_evals)
    assert np.array_equal(to_np(js2.birth), to_np(ss2.birth))


def _ulps(a, b) -> int:
    return abs(int(np.float32(a).view(np.int32)) - int(np.float32(b).view(np.int32)))


@pytest.mark.parametrize("annealing", [False, True])
def test_seed0_parting_is_a_cost_tie_in_padding(engines, annealing):
    """Seed 0: the hall of fame's complexity-7 slot holds one tree in both
    packages, but two copies of it compete for the slot: the cycles' copy,
    whose cost came with the JAX package's initial state, and the
    finalize's copy, re-scored by each package. The JAX package's re-score
    equals the carried cost bit for bit, and the merge's strict ``<``
    keeps the cycles' copy; the port's re-score is 2 ULP lower (its row
    sums run in another order), so it takes the finalize's copy. The two
    copies differ only in the slots past the tree's length (a mutation
    leaves stale words there), and hall-of-fame migration copies the
    pick into island 2's member 14. Every active slot, cost, count and
    key agrees."""
    js2, ss2, so, se, sd = _iterate(engines, annealing, 0)
    L = to_np(js2.pops.trees.length)
    live = np.arange(MAXSIZE)[None, None, :] < L[..., None]
    for f in ("arity", "op", "feat"):
        a, b = to_np(getattr(js2.pops.trees, f)), to_np(getattr(ss2.pops.trees, f))
        assert np.array_equal(np.where(live, a, 0), np.where(live, b, 0)), f
    jop, sop = to_np(js2.pops.trees.op), to_np(ss2.pops.trees.op)
    assert [tuple(i) for i in np.argwhere((jop != sop).any(-1))] == [(2, 14)]
    assert_close(to_np(js2.pops.cost), to_np(ss2.pops.cost), 1e-5, "cost")

    e = 6                                              # complexity 7
    jh, sh = js2.hof, ss2.hof
    hl = int(to_np(jh.trees.length)[e])
    assert hl == int(to_np(sh.trees.length)[e]) == 7
    hj, hs = to_np(jh.trees.op)[e], to_np(sh.trees.op)[e]
    assert np.array_equal(hj[:hl], hs[:hl])            # one tree
    assert hj[hl:].any() and not hs[hl:].any()         # the cycles' copy / the finalize's
    assert np.array_equal(jop[2, 14], hj) and np.array_equal(sop[2, 14], hs)
    bad = (to_np(jh.trees.op) != to_np(sh.trees.op)).any(-1)
    assert np.flatnonzero(bad).tolist() == [e]

    # the costs: the JAX pick keeps the carried cost, the port's re-score
    # of the same tree is 2 ULP below it
    cj, cs = float(to_np(jh.cost)[e]), float(to_np(sh.cost)[e])
    assert _ulps(cj, cs) == 2 and cs < cj
    tree = interop.tree_batch(jax.tree.map(lambda a: np.asarray(a)[e:e + 1], jh.trees),
                              device="cpu")
    rescored, _, _ = eval_cost_batch(tree, sd, so.elementwise_loss, se.tables,
                                     se.cfg.operators, se.cfg.parsimony)
    assert float(rescored[0]) == cs
