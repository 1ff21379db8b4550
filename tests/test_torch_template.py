"""The port's template expressions against the JAX package, on the CPU.

Inputs are made with numpy from a seed (or carried across with
``interop``) and handed to both packages. On the JAX side the predict
kernels (#4 ``fused_predict_program``, #5 ``_fused_predict_vjp_program``)
run in Pallas interpret mode, and its unfused path runs the vmapped
interpreter; on the port's side the kernel wrappers run their plain
PyTorch versions. Each tolerance is stated where it is used.
"""

import dataclasses

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
from symbolicregression_jl_tpu.evolve.population import init_population as j_init_population
from symbolicregression_jl_tpu.evolve.population import (
    init_template_population as j_init_template)
from symbolicregression_jl_tpu.models import composable as JM
from symbolicregression_jl_tpu.models import template as JT
from symbolicregression_jl_tpu.ops import encoding as JE
from symbolicregression_jl_tpu.ops import fused_eval as JF
from symbolicregression_jl_tpu.ops import program as JP
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.evolve import constant_opt as SC
from symbolicregression_jl_tpu_torch.evolve import rng as SR
from symbolicregression_jl_tpu_torch.evolve import step as SS
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine
from symbolicregression_jl_tpu_torch.evolve.population import (
    init_template_population as s_init_template)
from symbolicregression_jl_tpu_torch.models import composable as SM
from symbolicregression_jl_tpu_torch.models import template as ST
from symbolicregression_jl_tpu_torch.ops import fused_eval as SF
from symbolicregression_jl_tpu_torch.ops import program as SP
from symbolicregression_jl_tpu_torch.ops.encoding import TreeBatch, encode_population

from torch_parity import (POP_INT_FIELDS, TREE_FIELDS, assert_close, assert_pops_equal,
                          assert_trees_equal, numpy_state, port_key, to_np)

BINARY, UNARY = ["+", "-", "*"], ["cos"]
WIDE_BINARY, WIDE_UNARY = ["+", "-", "*", "/"], ["cos", "exp"]
MAXSIZE = 12

# The structures the tests run, by name: the bench cell's, a composition
# whose inner call's output feeds the outer call (per-member X), and one
# with a D call site.
COMBINERS = {
    "square_plus": lambda f, g, x1, x2: f(x1) * f(x1) + g(x2),
    "compose": lambda f, g, x1, x2: g(f(x1), x2),
    "deriv": lambda f, g, x1, x2: JT.D(f, 1)(x1) + g(x2),
}
PORT_COMBINERS = {
    "square_plus": COMBINERS["square_plus"],
    "compose": COMBINERS["compose"],
    "deriv": lambda f, g, x1, x2: ST.D(f, 1)(x1) + g(x2),
}


def _specs(name):
    return (JT.template_spec(expressions=("f", "g"))(COMBINERS[name]),
            ST.template_spec(expressions=("f", "g"))(PORT_COMBINERS[name]))


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _template_problem(seed: int, n: int = 120):
    """examples/template_expression.py's law: y = (1.5 x1)^2 + cos(2 x2)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (n, 2)).astype(np.float32)
    y = ((1.5 * X[:, 0]) ** 2 + np.cos(2.0 * X[:, 1])).astype(np.float32)
    return X, y


def _near(a, b, rtol, share=0.99):
    """Within ``rtol`` on at least ``share`` of the entries, finite in the
    same places (the eager interpreter's rule, tests/test_torch_ops.py:
    the two CPU backends' transcendentals differ by an ULP, which deep
    random trees amplify through cancellation on a few rows)."""
    a, b = np.asarray(a), np.asarray(b)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    f = np.isfinite(a)
    if not f.any():
        return
    near = np.abs(a[f] - b[f]) <= rtol * np.abs(a[f])
    assert near.mean() >= share, near.mean()


# ---------------------------------------------------------------------------
# ValidVector algebra and structure inference
# ---------------------------------------------------------------------------


def test_validvector_arithmetic_and_safe_domains():
    """The dunders and the named functions give the JAX package's values
    (rtol 1e-6) and validity, NaN domains included."""
    rng = np.random.default_rng(0)
    a_np = rng.uniform(-3, 3, 9).astype(np.float32)
    b_np = rng.uniform(-3, 3, 9).astype(np.float32)
    b_np[2] = 0.0
    ja, jb = (JM.ValidVector(jnp.asarray(v), jnp.bool_(True)) for v in (a_np, b_np))
    sa, sb = (SM.ValidVector(torch.from_numpy(v), torch.tensor(True)) for v in (a_np, b_np))
    cases = [
        lambda M, a, b: a * b + 1.0,
        lambda M, a, b: 2.0 - a,
        lambda M, a, b: a / b,                 # b has a zero: invalid
        lambda M, a, b: (a + b) ** 2,
        lambda M, a, b: -abs(a) % 1.5,
        lambda M, a, b: M.cos(a) * M.exp(b),
        lambda M, a, b: M.log(a),              # negatives: invalid
        lambda M, a, b: M.sqrt(abs(a)) + M.sqrt(b),   # b < 0: invalid
        lambda M, a, b: M.__getattr__("max")(a, b),
    ]
    for case in cases:
        jo, so = case(JM, ja, jb), case(SM, sa, sb)
        assert bool(jo.valid) == bool(so.valid)
        assert_close(to_np(jo.x), to_np(so.x), 1e-6)
    # validity propagates through later operations
    assert not bool((sa / sb + 1.0).valid)
    # member-batched data reduces over the last axis only
    m = SM.ValidVector(torch.tensor([[1.0, 2.0], [0.0, 1.0]]), torch.tensor(True))
    assert to_np((1.0 / m).valid).tolist() == [True, False]


def test_composable_expression_composes_and_evaluates():
    """Calling on ComposableExpressions splices trees; calling on data
    evaluates (invalid gives NaN), as in the JAX package. The symbolic
    derivative comes with a later slice."""
    jops, sops = J.OperatorSet(BINARY, UNARY), S.OperatorSet(BINARY, UNARY)
    jf = JM.ComposableExpression(J.parse_expression("cos(x1) * x2", jops), jops, 2)
    sf = SM.ComposableExpression(S.parse_expression("cos(x1) * x2", sops), sops, 2, device="cpu")
    jg = JM.ComposableExpression(J.parse_expression("x1 + 1.5", jops), jops, 1)
    sg = SM.ComposableExpression(S.parse_expression("x1 + 1.5", sops), sops, 1, device="cpu")
    assert jf(jg, jg).string() == sf(sg, sg).string() == "cos(#1 + 1.5) * (#1 + 1.5)"
    a = np.linspace(-2, 2, 7).astype(np.float32)
    np.testing.assert_allclose(to_np(sf(a, 2.0)), to_np(jf(a, 2.0)), rtol=1e-6)
    assert sf(0.5, 2.0) == pytest.approx(jf(0.5, 2.0), rel=1e-6)
    vv = sf(SM.ValidVector(torch.from_numpy(a), torch.tensor(True)), 1.0)
    assert bool(vv.valid)
    with pytest.raises(NotImplementedError, match="PyTorch port"):
        sf.derivative(1)


@pytest.mark.parametrize("name", ["square_plus", "compose", "deriv"])
def test_template_spec_inference_equal(name):
    js, ss = _specs(name)
    for f in ("expr_keys", "num_features", "n_variables", "uses_deriv", "param_keys"):
        assert getattr(js.structure, f) == getattr(ss.structure, f), f
    # the explicit-arity path probes for D call sites only
    jst = JT.make_template_structure(js.structure.combine, expressions=("f", "g"),
                                     num_features=dict(f=1, g=js.structure.num_features[1]),
                                     n_variables=2)
    sst = ST.make_template_structure(ss.structure.combine, expressions=("f", "g"),
                                     num_features=dict(f=1, g=ss.structure.num_features[1]),
                                     n_variables=2)
    assert jst.uses_deriv == sst.uses_deriv == (name == "deriv")


def test_template_strings_round_trip():
    _, ss = _specs("compose")
    ops = S.OperatorSet(BINARY, UNARY)
    h = ST.parse_template_expression("f = #1 * 1.5; g = #1 * cos(#2)", ss.structure, ops)
    assert h.string() == "f = #1 * 1.5; g = #1 * cos(#2)"
    d = ST.template_from_dict({"f": "#1 * 1.5", "g": "#1 * cos(#2)"}, ss.structure, ops)
    assert d.string() == h.string()
    X = np.random.default_rng(1).uniform(-2, 2, (16, 2)).astype(np.float32)
    np.testing.assert_allclose(h(X, device="cpu"), 1.5 * X[:, 0] * np.cos(X[:, 1]), rtol=1e-6)
    with pytest.raises(ValueError, match="missing"):
        ST.parse_template_expression("f = #1", ss.structure, ops)


# ---------------------------------------------------------------------------
# Kernels #4 and #5: plain versions against the JAX package's interpret mode
# ---------------------------------------------------------------------------


def _random_programs(seed: int, T: int, F: int):
    """T random trees over F arguments in both packages, compiled."""
    jo = J.Options(binary_operators=WIDE_BINARY, unary_operators=WIDE_UNARY, maxsize=MAXSIZE,
                   save_to_file=False)
    cfg = JS.evolve_config_from_options(jo, F)
    jt = j_init_population(jax.random.key(seed), T, cfg.mctx, jnp.float32, nlength=4)
    st = interop.tree_batch(_np_tree(jt), device="cpu")
    nb = len(WIDE_BINARY)
    return (cfg.operators, S.OperatorSet(WIDE_BINARY, WIDE_UNARY), jt, st,
            JP.compile_program(jt, F, nb), SP.compile_program(st, F, nb))


def _inputs(seed, T, F, n, per_member):
    rng = np.random.default_rng(seed)
    shape = (T, F, n) if per_member else (F, n)
    X = rng.uniform(-3, 3, shape).astype(np.float32)
    ct = rng.normal(size=(T, n)).astype(np.float32)
    return X, ct


@pytest.mark.parametrize("per_member", [False, True])
def test_predict_plain_matches_jax(per_member):
    """Kernel #4's plain version: validity bit-equal, predictions
    non-finite in the same places and within the eager interpreter's rule
    (rtol 1e-6 on 99% of the valid trees' rows)."""
    T, F, n = 48, 2, 65
    jops, sops, _, _, jprog, sprog = _random_programs(7, T, F)
    jprog = dataclasses.replace(jprog, const_ok=jprog.const_ok.at[::5].set(False))
    sprog.const_ok[::5] = False
    X, _ = _inputs(0, T, F, n, per_member)
    jp, jv = JF.fused_predict_program(jprog, jnp.asarray(X), F, jops, tree_block=8,
                                      interpret=True)
    sp, sv = SF.fused_predict_program(sprog, torch.from_numpy(X), F, sops)
    assert np.array_equal(to_np(jv), to_np(sv))
    assert 0 < to_np(sv).sum() < T
    v = to_np(sv)
    _near(to_np(jp)[v], to_np(sp)[v], 1e-6)
    if not per_member:   # the TreeBatch entry point, batch dims kept
        _, _, jt, st, _, _ = _random_programs(7, T, F)
        jp2, jv2 = JF.fused_predict(jt.reshape(4, T // 4), jnp.asarray(X), jops, interpret=True)
        sp2, sv2 = SF.fused_predict(st.reshape(4, T // 4), torch.from_numpy(X), sops)
        assert tuple(sp2.shape) == (4, T // 4, n)
        assert np.array_equal(to_np(jv2), to_np(sv2))
        _near(to_np(jp2)[to_np(sv2)], to_np(sp2)[to_np(sv2)], 1e-6)


@pytest.mark.parametrize("per_member", [False, True])
def test_predict_vjp_plain_matches_jax(per_member):
    """Kernel #5's plain version with random cotangents: the constants'
    gradients within 1e-4 of the sum of the absolute per-row terms (the
    rows are summed in another order), zeroed where non-finite as in the
    JAX package; gx (per-member) raw, non-finite in the same places and
    within rtol 1e-5 on 99% of the valid trees' entries."""
    T, F, n = 48, 2, 65
    jops, sops, _, _, jprog, sprog = _random_programs(11, T, F)
    X, ct = _inputs(1, T, F, n, per_member)
    jg, jx = JF._fused_predict_vjp_program(jprog, jnp.asarray(X), jnp.asarray(ct), F, jops,
                                           interpret=True)
    sg, sx = SF.fused_predict_vjp_program(sprog, torch.from_numpy(X), torch.from_numpy(ct), F,
                                          sops)
    args = SF._predict_inputs(sprog, torch.from_numpy(X), F, sops)
    _, _, gabs = SF.program_predict_vjp_plain(args[0], args[1], sprog.nconst, args[2], args[3],
                                              torch.from_numpy(ct), sops, return_abs=True)
    jg, sg, gabs = to_np(jg), to_np(sg), to_np(gabs)
    assert np.isfinite(sg).all()
    fin = np.isfinite(gabs)   # elsewhere the raw sum is non-finite: both zeroed
    assert not sg[~fin].any() and not jg[~fin].any()
    assert (np.abs(jg - sg) <= 1e-4 * gabs)[fin].all()
    assert (jx is None) == (sx is None) == (not per_member)
    if per_member:
        _, sv = SF.fused_predict_program(sprog, torch.from_numpy(X), F, sops)
        v = to_np(sv)
        _near(to_np(jx)[v], to_np(sx)[v], 1e-5)


def _hand_programs(exprs, F: int):
    names = [f"x{i + 1}" for i in range(F)]
    jops, sops = J.OperatorSet(BINARY, UNARY), S.OperatorSet(BINARY, UNARY)
    jt = JE.encode_population([J.parse_expression(e, jops, names) for e in exprs], 8, jops)
    st = interop.tree_batch(_np_tree(jt), device="cpu")
    return jops, sops, jt, st


def test_predict_vjp_accumulates_repeated_arguments():
    """An argument read at several leaves accumulates its adjoint:
    d(x1 * x1) = 2 x1 ct, d(x1 + x1) = 2 ct, d(x1 - x1) = 0, bit-equal to
    the JAX package's kernel and to the analytic values."""
    exprs = ["x1 * x1", "x1 + x1", "x1 - x1", "x1 * x2 * x1", "cos(x1) * x1", "x2"]
    jops, sops, jt, st = _hand_programs(exprs, 2)
    T, n = len(exprs), 33
    X, ct = _inputs(3, T, 2, n, per_member=True)
    jprog, sprog = JP.compile_program(jt, 2, 3), SP.compile_program(st, 2, 3)
    _, jx = JF._fused_predict_vjp_program(jprog, jnp.asarray(X), jnp.asarray(ct), 2, jops,
                                          interpret=True)
    _, sx = SF.fused_predict_vjp_program(sprog, torch.from_numpy(X), torch.from_numpy(ct), 2,
                                         sops)
    jx, sx = to_np(jx), to_np(sx)
    x1, x2 = X[:, 0], X[:, 1]
    assert np.array_equal(sx[0, 0], 2 * x1[0] * ct[0])
    assert np.array_equal(sx[1, 0], 2 * ct[1])
    assert np.array_equal(sx[2, 0], np.zeros(n, np.float32))
    np.testing.assert_allclose(sx[3, 0], 2 * x1[3] * x2[3] * ct[3], rtol=1e-6)
    assert np.array_equal(sx[:3], jx[:3])
    np.testing.assert_allclose(sx, jx, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("per_member", [False, True])
def test_fused_predict_ad_gradients_match_jax_vjp(per_member):
    """torch.autograd through ``fused_predict_ad`` against jax.vjp of the
    JAX package's: the constants' gradients in slot order and, for
    per-member X, d/dX (zeros for shared X); valid trees, rtol 1e-4 (atol
    1e-5 for components that cancel to near zero)."""
    T, F, n = 24, 2, 40
    jops, sops, jt, st, _, _ = _random_programs(5, T, F)
    X, ct = _inputs(2, T, F, n, per_member)

    def jf(c, x):
        trees = JE.TreeBatch(jt.arity, jt.op, jt.feat, c, jt.length)
        return JF.fused_predict_ad(trees, x, jops, interpret=True)[0]

    _, vjp = jax.vjp(jf, jt.const, jnp.asarray(X))
    jgc, jgx = vjp(jnp.asarray(ct))
    c = st.const.clone().requires_grad_(True)
    x = torch.from_numpy(X).requires_grad_(True)
    pred, valid = SF.fused_predict_ad(TreeBatch(st.arity, st.op, st.feat, c, st.length), x, sops)
    assert not valid.requires_grad
    sgc, sgx = torch.autograd.grad(pred, [c, x], torch.from_numpy(ct))
    v = to_np(valid)
    np.testing.assert_allclose(to_np(sgc)[v], to_np(jgc)[v], rtol=1e-4, atol=1e-5)
    if per_member:
        gj, gs = to_np(jgx)[v], to_np(sgx)[v]
        assert np.array_equal(np.isfinite(gj), np.isfinite(gs))
        np.testing.assert_allclose(gs[np.isfinite(gs)], gj[np.isfinite(gj)], rtol=1e-4,
                                   atol=1e-5)
    else:
        assert not to_np(sgx).any() and not to_np(jgx).any()


# ---------------------------------------------------------------------------
# Batched template evaluation and populations
# ---------------------------------------------------------------------------


def _template_trees(name: str, seed: int, P: int):
    js, ss = _specs(name)
    jo = J.Options(binary_operators=BINARY, unary_operators=UNARY, maxsize=MAXSIZE,
                   save_to_file=False)
    cfg = JS.evolve_config_from_options(jo, 2, template=js.structure)
    jt = j_init_template(jax.random.key(seed), P, js.structure, cfg.mctx, jnp.float32,
                         nlength=4)
    return js, ss, cfg.operators, S.OperatorSet(BINARY, UNARY), jt, interop.tree_batch(
        _np_tree(jt), device="cpu")


@pytest.mark.parametrize("name", ["square_plus", "compose", "deriv"])
def test_eval_template_batch_matches_jax(name):
    """The batched evaluator against the JAX package's fused (interpret)
    and unfused paths: validity bit-equal; outputs within rtol 1e-5 on 99%
    of the valid members' rows (D: the JAX unfused path differentiates
    forward, the port backward, so their products round apart)."""
    js, ss, jops, sops, jt, st = _template_trees(name, 3, 24)
    X, _ = _template_problem(4, n=50)
    Xt = np.ascontiguousarray(X.T)
    outs = [JT.eval_template_batch(jt, jnp.asarray(Xt), js.structure, jops, fused=fused,
                                   interpret=True) for fused in (True, False)]
    for fused in (True, False):
        sy, sv = ST.eval_template_batch(st, torch.from_numpy(Xt), ss.structure, sops,
                                        fused=fused)
        for jy, jv in outs:
            assert np.array_equal(to_np(jv), to_np(sv))
            v = to_np(sv)
            assert v.any()
            _near(to_np(jy)[v], to_np(sy)[v], 1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_init_template_population_equal(seed):
    """Each key's trees from its own argument count and ``fold_in(key,
    k)``: integer fields equal, constants within rtol 3e-7 (rng.normal's
    tails, ROADMAP.md queue 3)."""
    js, ss = _specs("compose")
    jo = J.Options(binary_operators=BINARY, unary_operators=UNARY, maxsize=MAXSIZE,
                   save_to_file=False)
    so = S.Options(binary_operators=BINARY, unary_operators=UNARY, maxsize=MAXSIZE,
                   save_to_file=False)
    jcfg = JS.evolve_config_from_options(jo, 2, template=js.structure)
    scfg = SS.evolve_config_from_options(so, 2, torch.device("cpu"), template=ss.structure)
    keys = jax.random.split(jax.random.key(seed), 3)
    jt = jax.vmap(lambda k: j_init_template(k, 32, js.structure, jcfg.mctx, jnp.float32))(keys)
    st = s_init_template(port_key(keys), 32, ss.structure, scfg.mctx)
    assert tuple(st.arity.shape) == (3, 32, 2, MAXSIZE)
    assert_trees_equal(jt, st, const_rtol=3e-7)
    # g of the composition takes two arguments, f one
    assert to_np(st.feat)[:, :, 0].max() == 0 and to_np(st.feat)[:, :, 1].max() == 1


# ---------------------------------------------------------------------------
# Evolution: one generation step, the optimizer, one engine iteration
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# A whole template search
# ---------------------------------------------------------------------------


SEARCH_SEEDS = (0, 1)


def _search_options(ss, **kw):
    base = dict(binary_operators=BINARY, unary_operators=UNARY, maxsize=16, populations=4,
                population_size=32, ncycles_per_iteration=20, tournament_selection_n=8,
                expression_spec=ss, save_to_file=False)
    base.update(kw)
    return S.Options(**base)


@pytest.fixture(scope="module")
def template_searches():
    _, ss = _specs("square_plus")
    X, y = _template_problem(0, n=200)
    return {seed: S.equation_search(X, y, options=_search_options(ss), niterations=3, seed=seed,
                                    device="cpu")
            for seed in SEARCH_SEEDS}


@pytest.mark.parametrize("seed", SEARCH_SEEDS)
def test_template_search_reaches_stated_loss(template_searches, seed):
    """examples/template_expression.py's problem (200 rows of y = (1.5
    x1)^2 + cos(2 x2), structure f(x1) * f(x1) + g(x2)) at 4 islands x 32
    members, 20 cycles, 3 iterations, the constant optimizer on: the best
    mean squared error is at most 0.05, against 8.0 for the variance of
    y. The JAX package with the same options, data and seeds reaches
    4.43e-11 (seed 0) and 1.28e-3 (seed 1); the port 1.7e-15 and 5.4e-3
    (the trajectories part on ULPs, so the two are compared on quality
    only)."""
    hof = template_searches[seed]
    best = min(hof.entries, key=lambda e: e.loss)
    assert np.isfinite(best.loss) and best.loss <= 0.05, best.equation_string()
    assert best.template_expr is not None
    assert best.equation_string().startswith("f = ") and "; g = " in best.equation_string()
    front = hof.pareto_frontier()
    assert [e.complexity for e in front] == sorted(e.complexity for e in front)


def test_template_search_one_seed_one_hall_of_fame():
    _, ss = _specs("compose")
    X, y = _template_problem(1, n=64)
    o = _search_options(ss, ncycles_per_iteration=4, should_optimize_constants=False)
    runs = [S.equation_search(X, y, options=o, niterations=2, seed=3, device="cpu")
            for _ in range(2)]
    summary = lambda h: [(e.complexity, e.loss, e.equation_string()) for e in h.entries]
    assert summary(runs[0]) == summary(runs[1]) and len(runs[0].entries) > 0


def test_template_search_checks_variable_count():
    _, ss = _specs("square_plus")
    X = np.zeros((8, 3), np.float32)
    o = S.Options(binary_operators=BINARY, unary_operators=UNARY, expression_spec=ss,
                  should_optimize_constants=False, save_to_file=False)
    with pytest.raises(ValueError, match="consumes 2 variables"):
        S.equation_search(X, X[:, 0], options=o, niterations=1, device="cpu")
