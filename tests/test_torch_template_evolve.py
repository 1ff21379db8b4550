"""Template members' evolution in the port against the JAX package, on
the CPU: one generation step, the joint constant optimizer (fused through
kernels #4 and #5, or not) and one engine iteration, each started in both
packages from the same members and key (split out of
tests/test_torch_template.py, which holds the evaluation and its kernels,
so that ``--dist loadfile`` spreads them). Each tolerance is stated where
it is used.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.api import hall_of_fame as JH
from symbolicregression_jl_tpu.evolve import constant_opt as JC
from symbolicregression_jl_tpu.evolve import step as JS
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu.models import template as JT
from symbolicregression_jl_tpu.ops import encoding as JE
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.evolve import constant_opt as SC
from symbolicregression_jl_tpu_torch.evolve import rng as SR
from symbolicregression_jl_tpu_torch.evolve import step as SS
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine
from symbolicregression_jl_tpu_torch.ops.encoding import TreeBatch

from test_torch_template import BINARY, MAXSIZE, UNARY, _np_tree, _specs, _template_problem
from torch_parity import (POP_INT_FIELDS, TREE_FIELDS, assert_close, assert_pops_equal,
                          numpy_state, port_key, to_np)


def _engine_options(name: str, **kw):
    js, ss = _specs(name)
    base = dict(binary_operators=BINARY, unary_operators=UNARY, maxsize=MAXSIZE,
                populations=2, population_size=16, ncycles_per_iteration=2,
                tournament_selection_n=8, turbo=False, save_to_file=False)
    base.update(kw)
    jo = J.Options(expression_spec=js, **base)
    so = S.Options(expression_spec=ss, **base)
    return js, ss, jo, so


def _data(seed, jo, n=80):
    X, y = _template_problem(seed, n)
    jds = J.make_dataset(X, y)
    jds.update_baseline_loss(jo.elementwise_loss)
    return jds, interop.device_data(_np_tree(jds.data), device="cpu")


@pytest.mark.parametrize("name,seed", [("square_plus", 0), ("square_plus", 1), ("compose", 2)])
def test_template_generation_step_equal(name, seed):
    """One generation step of one island from the same population and key
    (so the same uniforms ``u``, template key draws included): every member
    field equal, costs within rtol 1e-5."""
    js, ss, jo, so = _engine_options(name, populations=1, should_optimize_constants=False)
    jds, sd = _data(seed, jo)
    je = JEngine(jo, 2, template=js.structure)
    se = SEngine(so, 2, device="cpu")
    jstate = je.init_state(jax.random.key(seed), jds.data, 1)
    pop = jax.tree.map(lambda x: x[0], jstate.pops)
    nf = jstate.stats.normalized_frequencies
    k = jax.random.fold_in(jax.random.key(seed + 100), 0)
    P = 16
    marks = (jnp.zeros(P, bool), jnp.zeros(P, bool))
    step = jax.jit(lambda k, pop, data, nf, marks: JS.generation_step(
        k, pop, data, nf, jnp.float32(0.5), MAXSIZE, jnp.int32(P), jnp.int32(P), je.cfg, jo,
        je.tables, jo.elementwise_loss, marks=marks))
    jp, jn, jb, jr, jm = step(k, pop, jds.data, nf, marks)
    sp = interop.population_state(jax.tree.map(lambda x: np.asarray(x)[None], pop), device="cpu")
    smarks = (torch.zeros((1, P), dtype=torch.bool), torch.zeros((1, P), dtype=torch.bool))
    pp, pn, pb, pr, pm = SS.generation_step(
        port_key(k)[None], sp, sd, torch.from_numpy(to_np(nf).copy()), torch.tensor(0.5),
        MAXSIZE, torch.tensor([P], dtype=torch.int32), torch.tensor([P], dtype=torch.int32),
        se.cfg, so, se.tables, so.elementwise_loss, smarks)
    assert_pops_equal(jax.tree.map(lambda x: np.asarray(x)[None], jp), pp)
    assert float(jn) == float(pn[0])
    assert int(jb) == int(pb[0]) and int(jr) == int(pr[0])
    for a, b in zip(jm, pm):
        assert np.array_equal(to_np(a), to_np(b)[0])


# Template members whose constants are identifiable (no c1 * c2 products
# or c1 + c2 sums, along which any split gives the same loss).
TEMPLATE_MEMBERS = [
    ("1.3 * #1", "cos(1.8 * #1)"),
    ("#1 * 1.6", "cos(#1 + #1) * 0.7"),
    ("#1", "cos(2.2 * #1) + 0.1"),
    ("0.9 * #1", "#1"),
    ("#1", "#1"),
]


def _template_members(name: str):
    js, ss = _specs(name)
    jops, sops = J.OperatorSet(BINARY, UNARY), S.OperatorSet(BINARY, UNARY)
    hosts = [JT.template_from_dict(dict(f=f, g=g), js.structure, jops)
             for f, g in TEMPLATE_MEMBERS]
    encs = [h.encode(MAXSIZE) for h in hosts]
    jt = JE.TreeBatch(*(jnp.stack([getattr(e, f) for e in encs])
                        for f in ("arity", "op", "feat", "const", "length")))
    return js, ss, jops, sops, jt, interop.tree_batch(_np_tree(jt), device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_optimize_constants_template_matches_jax(fused):
    """The joint L-BFGS over both subexpressions' constants against the
    JAX package's, fused (its interpret-mode kernels #4 and #5) or not:
    f_calls and improved equal; constants within rtol 1e-3 and losses
    within rtol 1e-5 or 1e-7 absolute (L-BFGS carries the ULP differences
    of two row-sum orders through eight iterations; on losses it has
    driven near zero, 1e-4 against 2.6 for the variance of y, that is a
    relative 1e-4)."""
    js, ss, jops, sops, jt, st = _template_members("square_plus")
    X, y = _template_problem(6, n=60)
    jds = J.make_dataset(X, y)
    sd = interop.device_data(_np_tree(jds.data), device="cpu")
    do_opt = np.ones(len(TEMPLATE_MEMBERS), bool)
    do_opt[2] = False
    key = jax.random.key(8)
    el = J.Options(save_to_file=False).elementwise_loss
    jc, ji, jl, jf, _ = JC.optimize_constants_template(
        key, jt, jnp.asarray(do_opt), jds.data, el, jops, JC.OptimizerConfig(), js.structure,
        fused=fused, interpret=True)
    sc, si, sl, sf = SC.optimize_constants_template(
        port_key(key), st, torch.from_numpy(do_opt), sd,
        S.Options(save_to_file=False).elementwise_loss, sops, SC.OptimizerConfig(),
        ss.structure, fused=fused)
    assert tuple(sc.shape) == tuple(jc.shape)
    assert np.array_equal(to_np(jf), to_np(sf))
    assert np.array_equal(to_np(ji), to_np(si))
    assert to_np(si)[[0, 1]].all() and not to_np(si)[2]
    np.testing.assert_allclose(to_np(sl), to_np(jl), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(to_np(sc), to_np(jc), rtol=1e-3, atol=1e-6)


def test_optimize_constants_template_islands_draw_per_island():
    """With [I, P, K, L] members and one key per island, island i's
    restarts are those of a call on island i alone with key i."""
    js, ss, jops, sops, jt, st = _template_members("square_plus")
    X, y = _template_problem(6, n=40)
    sd = interop.device_data(_np_tree(J.make_dataset(X, y).data), device="cpu")
    el = S.Options(save_to_file=False).elementwise_loss
    cfg = SC.OptimizerConfig(iterations=2)
    keys = SR.split(SR.key(9), 2)
    two = TreeBatch(*(torch.stack([f[:4], f[1:]]) for f in st.fields()))
    do = torch.ones((2, 4), dtype=torch.bool)
    both = SC.optimize_constants_template(keys, two, do, sd, el, sops, cfg, ss.structure)
    one = SC.optimize_constants_template(keys[1], two[1], do[1], sd, el, sops, cfg,
                                         ss.structure)
    for a, b in zip(both, one):
        assert torch.equal(a[1], b)


# Seeds where one iteration agrees. Elsewhere the packages part on ULP
# ties (ROADMAP.md queue 3): "square_plus" seed 2 without the optimizer
# parts in the hall of fame, where two clones (the same live trees, other
# bits in their unused slots) tie on cost in one package and differ by an
# ULP in the other, which sums rows in another order; hall-of-fame
# migration then carries the other clone into the population.
@pytest.mark.parametrize("name,seed,optimize", [("square_plus", 0, True),
                                                ("square_plus", 3, False),
                                                ("compose", 1, False),
                                                ("compose", 2, True)])
def test_template_run_iteration_equal(name, seed, optimize):
    """One Engine.run_iteration (2 islands x 16 members, 2 cycles,
    turbo=False) from the same template state and key: populations
    (integer fields equal, costs and losses within rtol 1e-5, constants
    within rtol 1e-5, or 1e-4 with the constant optimizer on, which
    carries the ULP differences of the two packages' loss sums through
    L-BFGS), hall of fame with its key axis, counters and the next key."""
    js, ss, jo, so = _engine_options(name, should_optimize_constants=optimize)
    jds, sd = _data(seed, jo)
    je = JEngine(jo, 2, template=js.structure)
    se = SEngine(so, 2, device="cpu")
    jkey = jax.random.key(seed)
    jstate = je.init_state(jkey, jds.data, 2)
    ss0 = se.init_state(port_key(jkey), sd, 2)
    assert_pops_equal(jstate.pops, ss0.pops)
    state = interop.search_state(numpy_state(jstate), device="cpu")
    assert tuple(state.hof.trees.arity.shape) == (MAXSIZE, 2, MAXSIZE)
    js2 = je.run_iteration(jstate, jds.data, MAXSIZE)
    ss2 = se.run_iteration(state, sd, MAXSIZE)
    for f in TREE_FIELDS:
        assert np.array_equal(to_np(getattr(js2.pops.trees, f)),
                              to_np(getattr(ss2.pops.trees, f))), f
    for f in POP_INT_FIELDS:
        assert np.array_equal(to_np(getattr(js2.pops, f)), to_np(getattr(ss2.pops, f))), f
    assert_close(to_np(js2.pops.trees.const), to_np(ss2.pops.trees.const),
                 1e-4 if optimize else 1e-5, "const")
    assert_close(to_np(js2.pops.cost), to_np(ss2.pops.cost), 1e-5, "cost")
    assert_close(to_np(js2.pops.loss), to_np(ss2.pops.loss), 1e-5, "loss")
    ex = to_np(js2.hof.exists)
    assert np.array_equal(ex, to_np(ss2.hof.exists))
    assert_close(to_np(js2.hof.cost)[ex], to_np(ss2.hof.cost)[ex], 1e-5, "hof cost")
    assert np.array_equal(to_np(js2.hof.trees.length)[ex], to_np(ss2.hof.trees.length)[ex])
    assert float(js2.num_evals) == float(ss2.num_evals)
    assert np.array_equal(to_np(jax.random.key_data(js2.key)), to_np(ss2.key).view(np.uint32))
    # The hall of fame decodes to the JAX package's strings.
    jh = JH.HallOfFame.from_device(js2.hof, jo.operators, template=js.structure)
    sh = S.HallOfFame.from_device(ss2.hof, so.operators, template=ss.structure)
    assert [e.equation_string() for e in jh.entries] == [e.equation_string()
                                                        for e in sh.entries]
