"""Custom whole-prediction losses (``loss_function``,
``loss_function_expression``) in the port against the JAX package.

A custom loss is called per tree as ``loss_function(pred, y, w, valid)``
(the JAX package's ``_loss_from_pred``); a NaN or an invalid tree gives
inf, and turbo is off for it, in both packages: the population's
predictions come from the eager interpreter. The port's constant
optimizer differentiates through the custom loss with torch.autograd (the
JAX package's optimizer keeps the elementwise loss; ROADMAP.md queue 3),
so on an identifiable tree both recover the true constants. Inputs are
made with numpy from a seed; costs agree within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.evolve import constant_opt as JC
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.evolve import constant_opt as SC
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine

from torch_parity import assert_close, port_key, problem, to_np

RTOL = 1e-5


def j_mae15(pred, y, w, valid):
    return jnp.mean(jnp.abs(pred - y) ** 1.5)


def s_mae15(pred, y, w, valid):
    return torch.mean(torch.abs(pred - y) ** 1.5)


def j_wmse(pred, y, w, valid):
    return jnp.sum(w * (pred - y) ** 2) / jnp.sum(w)


def s_wmse(pred, y, w, valid):
    return torch.sum(w * (pred - y) ** 2) / torch.sum(w)


def _options(pkg, **kw):
    base = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
                maxsize=15, populations=2, population_size=16, ncycles_per_iteration=2,
                tournament_selection_n=8, save_to_file=False)
    base.update(kw)
    return pkg.Options(**base)


@pytest.mark.parametrize("slot", ["loss_function", "loss_function_expression"])
@pytest.mark.parametrize("seed", [0, 1])
def test_population_costs_match_jax(slot, seed):
    """init_state with a custom loss (turbo requested, and turned off by
    the custom loss in both packages): the same random population from
    the same key, costs and losses within rtol 1e-5, inf in the same
    places."""
    X, y = problem(seed)
    jo = _options(J, turbo=True, **{slot: j_mae15})
    so = _options(S, turbo=True, **{slot: s_mae15})
    assert so.resolved_loss_function is s_mae15
    jds = J.make_dataset(X, y)
    jds.update_baseline_loss(jo.elementwise_loss)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    je, se = JEngine(jo, 3), SEngine(so, 3, device="cpu")
    assert not je.cfg.turbo and not se.cfg.turbo
    js = je.init_state(jax.random.key(seed), jds.data, 2)
    ss = se.init_state(port_key(jax.random.key(seed)), sd, 2)
    assert np.array_equal(to_np(js.pops.trees.op), to_np(ss.pops.trees.op))
    assert_close(to_np(js.pops.loss), to_np(ss.pops.loss), RTOL, "loss")
    assert_close(to_np(js.pops.cost), to_np(ss.pops.cost), RTOL, "cost")


def test_weighted_custom_loss_and_invalid_trees():
    """The hook sees the weights; NaN from the hook and invalid trees give
    inf, as in the JAX package (eval_cost_batch on one batch of trees)."""
    from symbolicregression_jl_tpu.evolve.step import eval_cost_batch as j_eval_cost
    from symbolicregression_jl_tpu_torch.evolve.step import eval_cost_batch as s_eval_cost

    X, y = problem(2)
    w = np.random.default_rng(2).uniform(0.1, 2.0, y.shape[0]).astype(np.float32)
    exprs = ["x1 * x1 + cos(x2)", "x1 / (x2 - x2)", "exp(exp(exp(x1 * 30.0)))", "x3", "0.5"]
    jo, so = _options(J, loss_function=j_wmse), _options(S, loss_function=s_wmse)
    from symbolicregression_jl_tpu.ops import encoding as JE
    jt = JE.encode_population([J.parse_expression(e, jo.operators, ["x1", "x2", "x3"])
                               for e in exprs], 15, jo.operators)
    jds = J.make_dataset(X, y, weights=w)
    jds.update_baseline_loss(jo.elementwise_loss)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    je, se = JEngine(jo, 3), SEngine(so, 3, device="cpu")
    jc, jl, jx = j_eval_cost(jt, jds.data, jo.elementwise_loss, je.tables, jo.operators,
                             jo.parsimony, loss_function=jo.resolved_loss_function)
    st = interop.tree_batch(jax.tree.map(np.asarray, jt), device="cpu")
    sc, sl, sx = s_eval_cost(st, sd, so.elementwise_loss, se.tables, so.operators, so.parsimony,
                             loss_function=so.resolved_loss_function)
    assert np.array_equal(to_np(jx), to_np(sx))
    # The first tree is the truth: its loss is round-off (near 1e-15), so it
    # compares absolutely.
    for j, s_, what in ((jl, sl, "loss"), (jc, sc, "cost")):
        j, s_ = to_np(j), to_np(s_)
        assert np.array_equal(np.isinf(j), np.isinf(s_)), what
        f = np.isfinite(j)
        np.testing.assert_allclose(s_[f], j[f], rtol=RTOL, atol=1e-12, err_msg=what)
    assert np.isinf(to_np(sl)[1]) and np.isinf(to_np(sl)[2])


def test_optimizer_recovers_identifiable_constants():
    """The constant optimizer with a custom loss, on trees whose constants
    the data identify exactly: the port's (torch.autograd through the
    custom loss) and the JAX package's (its elementwise loss) both land on
    the true constants within rtol 1e-3, and improve every optimized
    member."""
    from symbolicregression_jl_tpu.ops import encoding as JE

    rng = np.random.default_rng(5)
    X = rng.uniform(-2, 2, (96, 3)).astype(np.float32)
    y = (2.5 * np.cos(1.3 * X[:, 1]) + 0.7 * X[:, 0]).astype(np.float32)
    jo, so = _options(J, loss_function=j_mae15), _options(S, loss_function=s_mae15)
    start = ["2.0 * cos(1.1 * x2) + 0.5 * x1", "1.0 * cos(1.2 * x2) + 1.0 * x1"]
    jt = JE.encode_population([J.parse_expression(e, jo.operators, ["x1", "x2", "x3"])
                               for e in start], 15, jo.operators)
    st = interop.tree_batch(jax.tree.map(np.asarray, jt), device="cpu")
    jds = J.make_dataset(X, y)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    key = jax.random.key(0)
    do = np.ones(len(start), bool)
    cfg = dict(iterations=40)
    jr = JC.optimize_constants_batch(key, jt, jnp.asarray(do), jds.data, jo.elementwise_loss,
                                     jo.operators, JC.OptimizerConfig(**cfg))
    sr = SC.optimize_constants_batch(port_key(key), st, torch.from_numpy(do), sd,
                                     so.elementwise_loss, so.operators, SC.OptimizerConfig(**cfg),
                                     loss_function=so.resolved_loss_function)
    assert to_np(jr[1]).all() and to_np(sr[1]).all()
    live = to_np(st.arity) == 0
    live &= to_np(st.op) == 0
    live &= np.arange(15)[None, :] < to_np(st.length)[:, None]
    jc, sc = to_np(jr[0])[live], to_np(sr[0])[live]
    np.testing.assert_allclose(sc, jc, rtol=1e-3)
    truth = np.sort(np.abs([2.5, 1.3, 0.7]))
    for row in range(len(start)):
        got = np.sort(np.abs(to_np(sr[0])[row][live[row]]))
        np.testing.assert_allclose(got, truth, rtol=1e-3)
    assert float(sr[2].max()) < 1e-4


def test_search_with_custom_loss():
    """equation_search with a custom loss (CPU, turbo requested: no
    refusal, the eager path): every hall-of-fame loss is the hook's value
    on that equation's predictions."""
    X, y = problem(3, n=96)
    o = _options(S, loss_function=s_mae15, turbo=True)
    hof = S.equation_search(X, y, options=o, niterations=2, seed=0, device="cpu")
    from symbolicregression_jl_tpu_torch.ops.eval import eval_tree_batch
    from symbolicregression_jl_tpu_torch.ops.encoding import encode_population

    for e in hof.entries:
        t = encode_population([e.tree], 15, o.operators, device="cpu")
        pred, valid = eval_tree_batch(t, torch.from_numpy(X.T.copy()), o.operators)
        want = float(s_mae15(pred[0], torch.from_numpy(y), None, valid[0]))
        np.testing.assert_allclose(e.loss, want, rtol=RTOL)


def test_at_most_one_loss():
    with pytest.raises(ValueError, match="at most one"):
        _options(S, elementwise_loss="l1", loss_function=s_mae15)
    o = _options(S, loss_function_expression=s_wmse)
    assert o.resolved_loss_function is s_wmse
