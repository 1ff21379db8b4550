"""The port's template parameters against the JAX package, on the CPU.

Template parameters are ParamVec vectors riding the member parameter bank.
These cases were split out of tests/test_torch_template.py, unchanged, so
that a run with ``--dist loadfile`` can put the two files on two workers.
Inputs are made with numpy from a seed (or carried across with
``interop``) and handed to both packages; on the JAX side the predict
kernel #4 runs in Pallas interpret mode, on the port's side the kernel
wrappers run their plain PyTorch versions. Each tolerance is stated where
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
from symbolicregression_jl_tpu.evolve.population import (
    init_template_population as j_init_template)
from symbolicregression_jl_tpu.models import template as JT
from symbolicregression_jl_tpu.ops import encoding as JE
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.evolve import constant_opt as SC
from symbolicregression_jl_tpu_torch.evolve import step as SS
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine
from symbolicregression_jl_tpu_torch.models import template as ST
from symbolicregression_jl_tpu_torch.ops.encoding import TreeBatch, encode_population

from test_torch_template import BINARY, MAXSIZE, UNARY, _near, _np_tree
from torch_parity import (POP_INT_FIELDS, TREE_FIELDS, assert_close, assert_pops_equal,
                          numpy_state, port_key, to_np)

PARAM_COMBINERS = {
    # test_template.py's cases: a parameter passed into a subexpression,
    # a member-dependent gather p[f(x1)], iteration over p; and the
    # search's structure.
    "into_arg": (("f",), {"p": 1}, lambda f, x1, x2, p: f(x1, p[0]) + x2),
    "gather": (("f",), {"p": 2}, lambda f, x1, x2, p: p[f(x1)] + x2),
    "iterate": (("f",), {"p": 3}, lambda f, x1, x2, p: f(x1) + sum(v for v in p) * x2),
    "linear": (("f",), {"p": 2}, lambda f, x1, x2, p: f(x1) + p[0] * x2 + p[1]),
}


def _param_specs(name):
    keys, params, fn = PARAM_COMBINERS[name]
    return (JT.template_spec(expressions=keys, parameters=params)(fn),
            ST.template_spec(expressions=keys, parameters=params)(fn))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", sorted(PARAM_COMBINERS))
def test_eval_template_batch_params_matches_jax(name, fused):
    """eval_template_batch(params=) against the JAX package's (its
    interpret-mode kernel #4 when ``fused``), members [2, 8] with random
    trees and parameter vectors: validity bit-equal, predictions within
    the eager interpreter's rule (rtol 1e-5 on 99% of the valid members'
    rows)."""
    js, ss = _param_specs(name)
    st_j, st_s = js.structure, ss.structure
    assert st_s.total_params == st_j.total_params and st_s.num_features == st_j.num_features
    cfg = JS.evolve_config_from_options(
        J.Options(binary_operators=BINARY, unary_operators=UNARY, maxsize=MAXSIZE,
                  save_to_file=False), 2, template=st_j)
    jt = j_init_template(jax.random.key(3), 16, st_j, cfg.mctx, jnp.float32)
    jt = jax.tree.map(lambda x: x.reshape((2, 8) + x.shape[1:]), jt)
    st = interop.tree_batch(_np_tree(jt), device="cpu")
    rng = np.random.default_rng(4)
    X = rng.uniform(-1.5, 1.5, (2, 40)).astype(np.float32)
    p = rng.uniform(-2, 2, (2, 8, st_s.total_params)).astype(np.float32)
    jops, sops = J.OperatorSet(BINARY, UNARY), S.OperatorSet(BINARY, UNARY)
    jy, jv = JT.eval_template_batch(jt, jnp.asarray(X), st_j, jops, jnp.asarray(p),
                                    fused=fused, interpret=fused)
    sy, sv = ST.eval_template_batch(st, torch.from_numpy(X), st_s, sops,
                                    params=torch.from_numpy(p), fused=fused)
    assert tuple(sy.shape) == (2, 8, 40)
    assert np.array_equal(to_np(jv), to_np(sv))
    v = to_np(sv)
    _near(to_np(jy)[v], to_np(sy)[v], 1e-5)


def test_batched_param_vec_cases():
    """test_template.py's three _BatchedParamVec cases, by value: a [M, 1]
    column passed into a subexpression, p[f(x1)] gathered per member, and
    `for v in p` ending after len(p) values."""
    sops = S.OperatorSet(BINARY, UNARY)

    def trees(exprs, names):
        enc = encode_population([S.parse_expression(e, sops, names) for e in exprs], 8, sops,
                                device="cpu")
        return TreeBatch(*(f[:, None] for f in enc.fields()))

    into = ST.template_spec(expressions=("f",), parameters={"p": 1})(
        lambda f, x1, p: f(x1, p[0])).structure
    X = np.random.default_rng(0).normal(size=(1, 25)).astype(np.float32)
    for fused in (False, True):
        y, valid = ST.eval_template_batch(trees(["x1 * x2"], ["x1", "x2"]), torch.from_numpy(X),
                                          into, sops, params=torch.tensor([[3.0]]), fused=fused)
        assert bool(valid[0])
        np.testing.assert_allclose(to_np(y[0]), X[0] * 3.0, rtol=1e-5)
    gather = ST.template_spec(expressions=("f",), parameters={"p": 2})(
        lambda f, x1, p: p[f(x1)]).structure
    y, _ = ST.eval_template_batch(trees(["x1", "x1 + 1.0"], ["x1"]),
                                  torch.tensor([[0.0, 1.0, 0.0, 1.0]]), gather, sops,
                                  params=torch.tensor([[10.0, 20.0], [30.0, 40.0]]))
    np.testing.assert_allclose(to_np(y[0]), [10.0, 20.0, 10.0, 20.0])
    np.testing.assert_allclose(to_np(y[1]), [40.0, 40.0, 40.0, 40.0])
    it = ST.template_spec(expressions=("f",), parameters={"p": 3})(
        lambda f, x1, p: f(x1) + sum(v for v in p)).structure
    y, _ = ST.eval_template_batch(trees(["x1"], ["x1"]), torch.ones((1, 5)), it, sops,
                                  params=torch.tensor([[1.0, 2.0, 3.0]]))
    np.testing.assert_allclose(to_np(y[0]), np.full(5, 7.0), rtol=1e-6)
    with pytest.raises(ValueError, match="parameters"):
        ST.eval_template_batch(trees(["x1"], ["x1"]), torch.ones((1, 5)), it, sops)


def test_template_params_strings_round_trip():
    """Parse and print with parameter vectors as the JAX package does:
    ``f = ...; p = [v1, v2]``; dict form; and host evaluation with them."""
    js, ss = _param_specs("linear")
    jops, sops = J.OperatorSet(BINARY, UNARY), S.OperatorSet(BINARY, UNARY)
    text = "f = #1 * #1; p = [3, -0.5]"
    jh = JT.parse_template_expression(text, js.structure, jops)
    sh = ST.parse_template_expression(text, ss.structure, sops)
    assert jh.string() == sh.string() == "f = #1 * #1; p = [3, -0.5]"
    assert ST.template_from_dict({"f": "#1 * #1", "p": [3.0, -0.5]}, ss.structure,
                                 sops).string() == sh.string()
    assert ST.parse_template_expression("f = #1", ss.structure, sops).params is None
    with pytest.raises(ValueError, match="expects 2"):
        ST.parse_template_expression("f = #1; p = [1]", ss.structure, sops)
    X = np.random.default_rng(1).uniform(-2, 2, (30, 2)).astype(np.float32)
    np.testing.assert_allclose(sh(X, device="cpu"), X[:, 0] ** 2 + 3 * X[:, 1] - 0.5,
                               rtol=1e-5)


def _param_engine(seed, **kw):
    js, ss = _param_specs("linear")
    base = dict(binary_operators=BINARY, unary_operators=UNARY, maxsize=MAXSIZE,
                populations=2, population_size=16, ncycles_per_iteration=2,
                tournament_selection_n=8, turbo=False, save_to_file=False)
    base.update(kw)
    jo = J.Options(expression_spec=js, **base)
    so = S.Options(expression_spec=ss, **base)
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (80, 2)).astype(np.float32)
    y = (X[:, 0] ** 2 + 3.0 * X[:, 1] - 0.5).astype(np.float32)
    jds = J.make_dataset(X, y)
    jds.update_baseline_loss(jo.elementwise_loss)
    je = JEngine(jo, 2, template=js.structure)
    se = SEngine(so, 2, device="cpu")
    assert (se.cfg.n_params, se.cfg.n_classes) == (je.cfg.n_params, je.cfg.n_classes) == (2, 1)
    return js, ss, jo, so, jds, interop.device_data(_np_tree(jds.data), device="cpu"), je, se


@pytest.mark.parametrize("seed", [0, 1])
def test_template_params_generation_step_equal(seed):
    """Three chained generation steps of one island with parameter
    vectors (crossover probability 0.3, so banks are exchanged, and
    mutate_constant's parameter-row branch): members equal, costs and
    parameter vectors within rtol 1e-5."""
    js, ss, jo, so, jds, sd, je, se = _param_engine(seed, populations=1,
                                                    crossover_probability=0.3)
    jstate = je.init_state(jax.random.key(seed), jds.data, 1)
    pop = jax.tree.map(lambda x: x[0], jstate.pops)
    nf = jstate.stats.normalized_frequencies
    P = 16
    step = jax.jit(lambda k, pop, data, nf, marks: JS.generation_step(
        k, pop, data, nf, jnp.float32(0.5), MAXSIZE, jnp.int32(P), jnp.int32(P), je.cfg, jo,
        je.tables, jo.elementwise_loss, marks=marks))
    for c in range(3):
        k = jax.random.fold_in(jax.random.key(seed + 100), c)
        jp = step(k, pop, jds.data, nf, (jnp.zeros(P, bool), jnp.zeros(P, bool)))[0]
        sp = interop.population_state(jax.tree.map(lambda x: np.asarray(x)[None], pop),
                                      device="cpu")
        pp = SS.generation_step(
            port_key(k)[None], sp, sd, torch.from_numpy(to_np(nf).copy()), torch.tensor(0.5),
            MAXSIZE, torch.tensor([P], dtype=torch.int32), torch.tensor([P], dtype=torch.int32),
            se.cfg, so, se.tables, so.elementwise_loss,
            (torch.zeros((1, P), dtype=torch.bool), torch.zeros((1, P), dtype=torch.bool)))[0]
        assert_pops_equal(jax.tree.map(lambda x: np.asarray(x)[None], jp), pp)
        assert_close(to_np(jp.params)[None], to_np(pp.params), 1e-5, "params")
        pop = jp


def test_optimize_constants_template_params_matches_jax():
    """The joint L-BFGS over the constants and the parameter vector
    against the JAX package's (f(x1) + p[0] x2 + p[1] on y = x1^2 + 3 x2
    - 0.5): f_calls and improved equal, losses within rtol 1e-5 or 1e-7
    absolute, constants and parameters within rtol 1e-3 (the tolerances
    of test_optimize_constants_template_matches_jax)."""
    js, ss, jo, so, jds, sd, _, _ = _param_engine(0)
    jops, sops = J.OperatorSet(BINARY, UNARY), S.OperatorSet(BINARY, UNARY)
    exprs = ["#1 * #1", "#1 * (#1 * 1.1)", "cos(#1) + 0.5", "#1"]
    hosts = [JT.template_from_dict({"f": e}, js.structure, jops) for e in exprs]
    encs = [h.encode(MAXSIZE) for h in hosts]
    jt = JE.TreeBatch(*(jnp.stack([getattr(e, f) for e in encs])
                        for f in ("arity", "op", "feat", "const", "length")))
    st = interop.tree_batch(_np_tree(jt), device="cpu")
    p = np.random.default_rng(2).normal(size=(4, 2, 1)).astype(np.float32)
    do_opt = np.array([True, True, False, True])
    key = jax.random.key(9)
    jc, ji, jl, jf, jp = JC.optimize_constants_template(
        key, jt, jnp.asarray(do_opt), jds.data, jo.elementwise_loss, jops,
        JC.OptimizerConfig(), js.structure, params=jnp.asarray(p))
    sc, si, sl, sf, sp = SC.optimize_constants_template(
        port_key(key), st, torch.from_numpy(do_opt), sd, so.elementwise_loss, sops,
        SC.OptimizerConfig(), ss.structure, params=torch.from_numpy(p))
    assert tuple(sp.shape) == (4, 2, 1)
    assert np.array_equal(to_np(jf), to_np(sf)) and np.array_equal(to_np(ji), to_np(si))
    assert to_np(si)[[0, 1, 3]].all() and not to_np(si)[2]
    np.testing.assert_allclose(to_np(sl), to_np(jl), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(to_np(sc), to_np(jc), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(to_np(sp), to_np(jp), rtol=1e-3, atol=1e-6)
    assert np.array_equal(to_np(sp)[2], p[2])


# Seeds where one iteration agrees. Elsewhere the packages part on ULP
# ties (ROADMAP.md queue 3): seeds 1 and 3 at the last cycle's annealing
# temperature 0 (both agree with annealing off), seed 2 at a hall-of-fame
# tie between two clones that differ only in their unused slots.
@pytest.mark.parametrize("seed,optimize", [(0, False), (4, False), (5, False), (0, True),
                                           (2, True)])
def test_template_params_run_iteration_equal(seed, optimize):
    """One Engine.run_iteration of a template with a parameter vector (2
    islands x 16 members, 2 cycles, turbo=False): integer fields equal,
    costs and losses within rtol 1e-5, counters (f_calls included) equal.
    Without the optimizer constants and parameter vectors agree within
    rtol 1e-5 and the hall of fame decodes to the same strings. With it,
    f(x1) + p[0] x2 + p[1] has a flat direction (a constant added in f
    against p[1]) along which L-BFGS carries the ULP differences of the
    loss sums to other splits of the same loss, so constants and
    parameters are not compared there."""
    kw = dict(should_optimize_constants=optimize)
    if optimize:
        kw["optimizer_probability"] = 0.3
    js, ss, jo, so, jds, sd, je, se = _param_engine(seed, **kw)
    jkey = jax.random.key(seed)
    jstate = je.init_state(jkey, jds.data, 2)
    ss0 = se.init_state(port_key(jkey), sd, 2)
    assert_pops_equal(jstate.pops, ss0.pops)
    assert_close(to_np(jstate.pops.params), to_np(ss0.pops.params), 3e-7, "initial params")
    state = interop.search_state(numpy_state(jstate), device="cpu")
    js2 = je.run_iteration(jstate, jds.data, MAXSIZE)
    ss2 = se.run_iteration(state, sd, MAXSIZE)
    for f in TREE_FIELDS:
        assert np.array_equal(to_np(getattr(js2.pops.trees, f)),
                              to_np(getattr(ss2.pops.trees, f))), f
    for f in POP_INT_FIELDS:
        assert np.array_equal(to_np(getattr(js2.pops, f)), to_np(getattr(ss2.pops, f))), f
    assert_close(to_np(js2.pops.cost), to_np(ss2.pops.cost), 1e-5, "cost")
    assert_close(to_np(js2.pops.loss), to_np(ss2.pops.loss), 1e-5, "loss")
    ex = to_np(js2.hof.exists)
    assert np.array_equal(ex, to_np(ss2.hof.exists))
    assert_close(to_np(js2.hof.cost)[ex], to_np(ss2.hof.cost)[ex], 1e-5, "hof cost")
    assert float(js2.num_evals) == float(ss2.num_evals)
    jh = JH.HallOfFame.from_device(js2.hof, jo.operators, template=js.structure)
    sh = S.HallOfFame.from_device(ss2.hof, so.operators, template=ss.structure)
    assert len(jh.entries) == len(sh.entries) > 0
    assert all(e.template_expr.params.shape == (2,) for e in sh.entries)
    assert all("; p = [" in e.equation_string() for e in sh.entries)
    if not optimize:
        assert_close(to_np(js2.pops.trees.const), to_np(ss2.pops.trees.const), 1e-5, "const")
        assert_close(to_np(js2.pops.params), to_np(ss2.pops.params), 1e-5, "params")
        assert [e.equation_string() for e in jh.entries] == [e.equation_string()
                                                            for e in sh.entries]


def test_template_search_with_parameters_recovers():
    """test_template.py's search with parameters (f(x1) + p[0] x2 + p[1]
    on y = x1^2 + 3 x2 - 0.5; 4 islands x 20 members, 8 cycles, 8
    iterations, optimizer probability 0.3): the best loss is below 1e-6,
    its parameters are [3, -0.5] within 1e-2, and its host prediction
    matches the data within 1e-2."""
    _, ss = _param_specs("linear")
    rng = np.random.default_rng(1)
    X = rng.uniform(-2, 2, (200, 2)).astype(np.float32)
    y = (X[:, 0] ** 2 + 3.0 * X[:, 1] - 0.5).astype(np.float32)
    o = S.Options(binary_operators=BINARY, unary_operators=[], maxsize=8, populations=4,
                  population_size=20, ncycles_per_iteration=8, optimizer_probability=0.3,
                  expression_spec=ss, save_to_file=False)
    hof = S.equation_search(X, y, options=o, niterations=8, seed=0, device="cpu")
    best = min(hof.entries, key=lambda e: e.loss)
    assert best.loss < 1e-6, best.equation_string()
    np.testing.assert_allclose(sorted(best.template_expr.params), [-0.5, 3.0], atol=1e-2)
    np.testing.assert_allclose(best.template_expr(X, device="cpu"), y, atol=1e-2)
