"""The port's evolution modules against the JAX package.

Randomness first: the port's threefry2x32 must give jax.random's bits.
Then tournament selection, constant folding, one generation step and one
engine iteration, each started in both packages from the same population
and key (carried across with ``interop``): tree integer fields equal,
costs within rtol 1e-5. Everything runs on the CPU with the eager
interpreter (``turbo=False``), the JAX package's jitted.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.evolve import rng as JR
from symbolicregression_jl_tpu.evolve import step as JS
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu.evolve.population import init_population as j_init_population
from symbolicregression_jl_tpu.evolve.simplify import fold_constants_batch as j_fold
from symbolicregression_jl_tpu.evolve.tournament import tournament_select as j_tournament
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.evolve import rng as SR
from symbolicregression_jl_tpu_torch.evolve import step as SS
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine
from symbolicregression_jl_tpu_torch.evolve.population import init_population as s_init_population
from symbolicregression_jl_tpu_torch.evolve.simplify import fold_constants_batch as s_fold
from symbolicregression_jl_tpu_torch.evolve.tournament import tournament_select as s_tournament

from torch_parity import (assert_close, assert_pops_equal, assert_trees_equal, numpy_state,
                          port_key, problem, to_np)

KEYS = [0, 1, 42, 2**31 - 1, 123456789]
MAXSIZE = 15


def _bits(x):
    """32-bit words as uint32 (keys and raw bits are int32 in the port)."""
    return to_np(x).view(np.uint32)


# ---------------------------------------------------------------------------
# threefry2x32
# ---------------------------------------------------------------------------


def test_threefry_is_the_partitionable_variant():
    """The port implements jax's default generator: threefry2x32 with
    ``jax_threefry_partitionable`` on (the default since jax 0.5)."""
    assert jax.config.jax_threefry_partitionable
    assert jax.random.key_impl(jax.random.key(0)) == "threefry2x32"


@pytest.mark.parametrize("seed", KEYS)
def test_split_fold_in_bits_equal_jax(seed):
    jk, sk = jax.random.key(seed), SR.key(seed)
    assert np.array_equal(to_np(jax.random.key_data(jk)), _bits(sk))
    for num in (2, 3, 7):
        assert np.array_equal(to_np(jax.random.key_data(jax.random.split(jk, num))),
                              _bits(SR.split(sk, num)))
    for d in (0, 1, 5, 2**31 + 3):
        assert np.array_equal(to_np(jax.random.key_data(jax.random.fold_in(jk, d))),
                              _bits(SR.fold_in(sk, d)))
    # batched keys split and fold like vmapped jax calls
    jks = jax.random.split(jk, 4)
    sks = SR.split(sk, 4)
    assert np.array_equal(to_np(jax.random.key_data(jax.vmap(lambda k: jax.random.split(k, 3))(jks))),
                          _bits(SR.split(sks, 3)))
    assert np.array_equal(
        to_np(jax.random.key_data(jax.vmap(lambda k: jax.random.fold_in(k, 9))(jks))),
        _bits(SR.fold_in(sks, 9)))


@pytest.mark.parametrize("seed", KEYS)
def test_draws_bits_equal_jax(seed):
    jk, sk = jax.random.key(seed), SR.key(seed)
    for shape in ((1,), (5,), (3, 7), (1000,)):
        assert np.array_equal(to_np(jax.random.bits(jk, shape, jnp.uint32)),
                              _bits(SR.random_bits(sk, shape)))
        assert np.array_equal(to_np(jax.random.uniform(jk, shape)).view(np.uint32),
                              _bits(SR.uniform(sk, shape)))
    assert np.array_equal(to_np(jax.random.uniform(jk, (64,), minval=-2.0, maxval=3.0)),
                          to_np(SR.uniform(sk, (64,), minval=-2.0, maxval=3.0)))
    assert np.array_equal(to_np(jax.random.bernoulli(jk, 0.3, (257,))),
                          to_np(SR.bernoulli(sk, 0.3, (257,))))
    logits = np.log(np.random.default_rng(seed % 97).uniform(0.01, 1, (4, 9))).astype(np.float32)
    logits[1, 3] = -np.inf
    assert np.array_equal(to_np(jax.random.categorical(jk, jnp.asarray(logits))),
                          to_np(SR.categorical(sk, torch.from_numpy(logits))))
    assert np.array_equal(to_np(jax.random.categorical(jk, jnp.asarray(logits[0]), shape=(6,))),
                          to_np(SR.categorical(sk, torch.from_numpy(logits[0]), shape=(6,))))
    for n in (1, 16, 300):
        assert np.array_equal(to_np(jax.random.permutation(jk, n)),
                              to_np(SR.permutation(sk, n)))
    # u_normal: bits equal on the central branch; the tails go through
    # log, where the two CPU backends differ by an ULP.
    u = to_np(jax.random.uniform(jk, (2000,))).copy()
    want, got = to_np(JR.u_normal(jnp.asarray(u))), to_np(SR.u_normal(torch.from_numpy(u)))
    central = np.minimum(u, 1 - u) > np.float32(np.exp(-2.0))
    assert np.array_equal(want[central], got[central])
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# Population, tournament, folding
# ---------------------------------------------------------------------------


def _config(**kw):
    base = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
                maxsize=MAXSIZE, should_optimize_constants=False, save_to_file=False)
    base.update(kw)
    return J.Options(**base), S.Options(**base)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_init_population_equal(seed):
    jo, so = _config()
    jcfg = JS.evolve_config_from_options(jo, 3)
    scfg = SS.evolve_config_from_options(so, 3, torch.device("cpu"))
    jt = j_init_population(jax.random.key(seed), 64, jcfg.mctx, jnp.float32)
    st = s_init_population(SR.key(seed)[None], 64, scfg.mctx)
    assert_trees_equal(jt, st.reshape(64), const_rtol=3e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("p", [0.982, 1.0])
def test_tournament_select_equal(seed, p):
    rng = np.random.default_rng(seed)
    P, maxsize = 32, MAXSIZE
    cost = rng.uniform(0.5, 3.0, P).astype(np.float32)
    cost[rng.integers(0, P, 3)] = np.nan
    cx = rng.integers(1, maxsize + 3, P).astype(np.int32)
    nf = rng.dirichlet(np.ones(maxsize)).astype(np.float32)
    kw = dict(tournament_n=8, p=p, use_frequency=True, adaptive_parsimony_scaling=1040.0,
              maxsize=maxsize)
    keys = jax.random.split(jax.random.key(seed), 40)
    want = jax.vmap(lambda k: j_tournament(k, jnp.asarray(cost), jnp.asarray(cx),
                                           jnp.asarray(nf), **kw))(keys)
    got = s_tournament(port_key(keys), torch.from_numpy(cost), torch.from_numpy(cx),
                       torch.from_numpy(nf), **kw)
    assert np.array_equal(to_np(want), to_np(got))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_constants_equal(seed):
    jo, so = _config(unary_operators=["cos", "exp", "abs"])
    jcfg = JS.evolve_config_from_options(jo, 3)
    jt = j_init_population(jax.random.key(seed), 64, jcfg.mctx, jnp.float32, nlength=7)
    st = interop.tree_batch(jax.tree.map(np.asarray, jt), device="cpu")
    assert_trees_equal(j_fold(jt, jcfg.operators), s_fold(st, so.operators))


# ---------------------------------------------------------------------------
# One generation step, one engine iteration
# ---------------------------------------------------------------------------


def _setup(seed: int, n_islands: int, ncycles: int, annealing: bool):
    X, y = problem(seed)
    jo, so = _config(populations=n_islands, population_size=16, ncycles_per_iteration=ncycles,
                     tournament_selection_n=8, annealing=annealing, turbo=False)
    jds = J.make_dataset(X, y)
    jds.update_baseline_loss(jo.elementwise_loss)
    return jo, so, jds, interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")


@pytest.fixture(scope="module")
def step_fn():
    """The JAX package's generation_step, jitted once per configuration."""
    cache = {}

    def get(jo, je):
        key = id(jo)
        if key not in cache:
            cache[key] = jax.jit(lambda k, pop, data, nf, temp, birth, ref, marks:
                                 JS.generation_step(k, pop, data, nf, temp, MAXSIZE, birth, ref,
                                                    je.cfg, jo, je.tables, jo.elementwise_loss,
                                                    marks=marks))
        return cache[key]

    return get


@pytest.fixture(scope="module")
def gen_setup():
    jo, so, jds, sd = _setup(0, 1, 1, annealing=True)
    je, se = JEngine(jo, 3), SEngine(so, 3, device="cpu")
    return jo, so, jds, sd, je, se


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_generation_step_equal(seed, gen_setup, step_fn):
    """One generation step of one island from the same population and
    key: every member field equal, costs within rtol 1e-5."""
    jo, so, jds, sd, je, se = gen_setup
    js = je.init_state(jax.random.key(seed), jds.data, 1)
    pop = jax.tree.map(lambda x: x[0], js.pops)
    nf = js.stats.normalized_frequencies
    k = jax.random.fold_in(jax.random.key(seed + 100), 0)
    marks = (jnp.zeros(16, bool), jnp.zeros(16, bool))
    temp = jnp.float32(0.5)
    jp, jn, jb, jr, jm = step_fn(jo, je)(k, pop, jds.data, nf, temp, jnp.int32(16),
                                         jnp.int32(16), marks)

    sp = interop.population_state(jax.tree.map(lambda x: np.asarray(x)[None], pop), device="cpu")
    smarks = (torch.zeros((1, 16), dtype=torch.bool), torch.zeros((1, 16), dtype=torch.bool))
    out = SS.generation_step(port_key(k)[None], sp, sd, torch.from_numpy(to_np(nf).copy()),
                             torch.tensor(0.5), MAXSIZE, torch.tensor([16], dtype=torch.int32),
                             torch.tensor([16], dtype=torch.int32), se.cfg, so, se.tables,
                             so.elementwise_loss, smarks)
    pp, pn, pb, pr, pm = out
    assert_pops_equal(jax.tree.map(lambda x: np.asarray(x)[None], jp), pp)
    assert float(jn) == float(pn[0])
    assert int(jb) == int(pb[0]) and int(jr) == int(pr[0])
    for a, b in zip(jm, pm):
        assert np.array_equal(to_np(a), to_np(b)[0])


@pytest.fixture(scope="module")
def engines():
    """JAX and port engines (2 islands x 16 members, 3 cycles), built once
    per annealing setting so the JAX side compiles once."""
    cache = {}

    def get(annealing):
        if annealing not in cache:
            jo, so, _, _ = _setup(0, 2, 3, annealing)
            cache[annealing] = (JEngine(jo, 3), SEngine(so, 3, device="cpu"))
        return cache[annealing]

    return get


# With annealing the last cycle runs at temperature 0, where a candidate
# whose cost ties its parent's is accepted and one an ULP worse is not.
# Row sums run in another order in the two packages, so an exact tie in
# one can be a 1-ULP difference in the other, and the runs part there
# (seeds 1 and 4 of this setup; ROADMAP.md queue 3). Without annealing
# those seeds agree.
@pytest.mark.parametrize("annealing,seed", [(True, 0), (True, 2), (True, 3),
                                            (False, 1), (False, 4)])
def test_run_iteration_equal(engines, annealing, seed):
    """One Engine.run_iteration (2 islands x 16 members, 3 cycles,
    turbo=False) from the same state and key: populations, hall of fame,
    statistics, counters and the next key."""
    je, se = engines(annealing)
    _, _, jds, sd = _setup(seed, 2, 3, annealing)
    jkey = jax.random.key(seed)
    js = je.init_state(jkey, jds.data, 2)
    ss_init = se.init_state(port_key(jkey), sd, 2)
    assert_pops_equal(js.pops, ss_init.pops)

    ss = interop.search_state(numpy_state(js), device="cpu")   # before run_iteration donates js
    js2 = je.run_iteration(js, jds.data, MAXSIZE)
    ss2 = se.run_iteration(ss, sd, MAXSIZE)
    assert_pops_equal(js2.pops, ss2.pops)
    assert np.array_equal(to_np(js2.hof.exists), to_np(ss2.hof.exists))
    ex = to_np(js2.hof.exists)
    assert_close(to_np(js2.hof.cost)[ex], to_np(ss2.hof.cost)[ex], 1e-5, "hof cost")
    assert np.array_equal(to_np(js2.hof.trees.length)[ex], to_np(ss2.hof.trees.length)[ex])
    assert float(js2.num_evals) == float(ss2.num_evals)
    assert np.array_equal(to_np(js2.birth), to_np(ss2.birth))
    assert np.array_equal(to_np(js2.ref), to_np(ss2.ref))
    assert np.array_equal(to_np(jax.random.key_data(js2.key)), _bits(ss2.key))
    np.testing.assert_allclose(to_np(js2.stats.frequencies), to_np(ss2.stats.frequencies),
                               rtol=1e-6)
