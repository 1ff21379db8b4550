"""The last dtype forms of the port against the JAX package.

- kernels #4 and #5 in float64 (their ``double`` forms; here, on the CPU,
  their plain versions) against the JAX package's fused predict and its
  VJP under ``jax.enable_x64``, and a float64 template search against a
  float64 numpy evaluation (the JAX engine's run_iteration fails under x64,
  ROADMAP.md queue 3);
- float64 data on a bf16 value buffer (kernels 1b and 2b with a float64
  loss spine) against the JAX package's bf16 kernels under x64;
- bf16 data (``eval_dtype="bfloat16"``, kernels 1b and 2b with a bf16 loss
  spine) against the JAX fused ops on the same bf16 inputs and against a
  float32 numpy evaluation of the bf16-rounded data; the JAX package's own
  equation_search with bf16 data runs with turbo off and fails with turbo
  on (ROADMAP.md queue 3);
- a user elementwise loss in a parametric, a float64 and a bf16 search
  (kernel #4's per-member, ``double`` and bf16 forms, #5's ``double``
  form) against the eager path.

The JAX side runs inside ``jax.enable_x64(True)`` where it needs float64.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.core import losses as JL
from symbolicregression_jl_tpu.evolve.population import init_population as j_init_population
from symbolicregression_jl_tpu.evolve.step import evolve_config_from_options as j_cfg
from symbolicregression_jl_tpu.ops import fused_eval as JF
from symbolicregression_jl_tpu.ops import program as JP
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.core import losses as SL
from symbolicregression_jl_tpu_torch.ops import fused_eval as SF
from symbolicregression_jl_tpu_torch.ops import program as SP
from symbolicregression_jl_tpu_torch.ops.eval import eval_tree_batch

from torch_parity import assert_close, problem, to_np

MAXSIZE = 15
RTOL64 = 1e-10
RTOL = 1e-5
EXACT = (["+", "-", "*", "/"], [])
TRANSCENDENTAL = (["+", "-", "*", "/"], ["cos", "exp"])


def _trees(seed, T, F, binary, unary, n_params=0):
    jo = J.Options(binary_operators=binary, unary_operators=unary, maxsize=MAXSIZE,
                   save_to_file=False)
    cfg = j_cfg(jo, F)
    mctx = cfg.mctx._replace(n_params=n_params) if n_params else cfg.mctx
    jt = j_init_population(jax.random.key(seed), T, mctx, jnp.float32, nlength=4)
    st = interop.tree_batch(jax.tree.map(np.asarray, jt), device="cpu")
    return cfg.operators, S.OperatorSet(binary, unary), jt, st


def _data(F, n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (F, n))
    y = rng.normal(size=n)
    w = rng.uniform(0.2, 2.0, n)
    w[::9] = 0.0
    return X, y, w


def _counting(monkeypatch, *names):
    """Counts calls of the named kernel wrappers of ops/fused_eval.py."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        kernel = getattr(SF, name)

        def run(*a, _k=kernel, _n=name, **kw):
            calls[_n] += 1
            return _k(*a, **kw)

        monkeypatch.setattr(SF, name, run)
    return calls


# ---------------------------------------------------------------------------
# #4 and #5 in float64
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_member", [False, True], ids=["shared", "per_member"])
def test_double_predict_and_vjp_match_jax_x64(per_member, monkeypatch):
    """fused_predict_program and fused_predict_vjp_program on float64 X take
    the ``double`` wrappers (PROGRAM_PREDICT_F64, PROGRAM_PREDICT_VJP_F64;
    their plain versions here) and agree with the JAX package's under x64
    within rtol 1e-10: validity bit-equal, predictions on valid trees, the
    constants' gradients (zeroed where non-finite in both), gx per member."""
    F, n, T = 2, 33, 16
    jops, sops, jt, st = _trees(5, T, F, *TRANSCENDENTAL)
    rng = np.random.default_rng(2)
    X = rng.uniform(-2, 2, (T, F, n) if per_member else (F, n))
    ct = rng.normal(size=(T, n))
    calls = _counting(monkeypatch, "PROGRAM_PREDICT_F64", "PROGRAM_PREDICT_VJP_F64")
    sprog = SP.compile_program(st, F, 4)
    sprog.cvals = sprog.cvals.double()
    sp, sv = SF.fused_predict_program(sprog, torch.from_numpy(X), F, sops)
    sg, sx = SF.fused_predict_vjp_program(sprog, torch.from_numpy(X), torch.from_numpy(ct), F,
                                          sops)
    assert calls == {"PROGRAM_PREDICT_F64": 1, "PROGRAM_PREDICT_VJP_F64": 1}
    assert sp.dtype == sg.dtype == torch.float64
    with jax.enable_x64(True):
        jprog = JP.compile_program(jt, F, 4)
        jprog = dataclasses.replace(jprog, cvals=jnp.asarray(np.asarray(jprog.cvals),
                                                             jnp.float64))
        jp, jv = JF.fused_predict_program(jprog, jnp.asarray(X), F, jops, tree_block=8,
                                          interpret=True)
        jg, jx = JF._fused_predict_vjp_program(jprog, jnp.asarray(X), jnp.asarray(ct), F, jops,
                                               interpret=True)
        jp, jv, jg = np.asarray(jp), np.asarray(jv), np.asarray(jg)
        jx = None if jx is None else np.asarray(jx)
    assert jp.dtype == np.float64
    v = to_np(sv)
    assert np.array_equal(jv, v) and v.sum() > 0
    np.testing.assert_allclose(to_np(sp)[v], jp[v], rtol=RTOL64, atol=1e-12)
    sg = to_np(sg)
    assert np.array_equal(sg == 0, jg == 0)
    np.testing.assert_allclose(sg, jg, rtol=1e-9, atol=1e-9 * np.abs(jg).max())
    if per_member:
        np.testing.assert_allclose(to_np(sx)[v], jx[v], rtol=RTOL64, atol=1e-12)


def _template_loss(entry, X64, y64):
    """The mean squared error of f(x1) * f(x1) + g(x2) in float64 numpy."""
    def go(node, cols):
        if node.degree == 0:
            return np.full(cols.shape[0], node.val) if node.constant else cols[:, node.feature]
        a = [go(c, cols) for c in node.children]
        with np.errstate(all="ignore"):
            return {"+": lambda: a[0] + a[1], "-": lambda: a[0] - a[1],
                    "*": lambda: a[0] * a[1], "cos": lambda: np.cos(a[0])}[node.op.name]()
    t = entry.template_expr.trees
    f = go(t["f"], X64[:, :1])
    return float(np.mean((f * f + go(t["g"], X64[:, 1:2]) - y64) ** 2))


def test_float64_template_search_matches_numpy(monkeypatch):
    """A float64 template search with turbo on and the constant optimizer:
    #4 and #5 in their ``double`` forms (every call site and the
    optimizer's backward), a float64 state, every hall-of-fame loss equal to
    a float64 numpy evaluation of its expressions within rtol 1e-9."""
    from symbolicregression_jl_tpu_torch.models import template_spec

    spec = template_spec(expressions=("f", "g"))(lambda f, g, x1, x2: f(x1) * f(x1) + g(x2))
    calls = _counting(monkeypatch, "PROGRAM_PREDICT", "PROGRAM_PREDICT_F64",
                      "PROGRAM_PREDICT_VJP_F64")
    X, y = problem(6, n=80, nfeatures=2)
    opts = S.Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=16,
                     populations=2, population_size=16, ncycles_per_iteration=3,
                     tournament_selection_n=8, expression_spec=spec, eval_dtype="float64",
                     optimizer_probability=0.5, turbo=True, save_to_file=False)
    state, hof = S.equation_search(X, y, options=opts, niterations=2, seed=0, device="cpu",
                                   return_state=True)
    assert state.device_states[0].pops.cost.dtype == torch.float64
    assert calls["PROGRAM_PREDICT_F64"] > 0 and calls["PROGRAM_PREDICT_VJP_F64"] > 0
    assert calls["PROGRAM_PREDICT"] == 0
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    for e in hof.entries:
        np.testing.assert_allclose(e.loss, _template_loss(e, X64, y64), rtol=1e-9)


# ---------------------------------------------------------------------------
# float64 data on a bf16 value buffer: a float64 loss spine
# ---------------------------------------------------------------------------


def _exact(st):
    live = np.arange(st.arity.shape[1])[None, :] < to_np(st.length)[:, None]
    return ~(live & (to_np(st.arity) == 1)).any(axis=1)


def _bf16_agrees(want, got, exact, tol):
    """Trees of + - * /: within rtol 1e-5; the others within ``tol``;
    non-finite in the same places."""
    want, got = np.asarray(want), np.asarray(got)
    assert np.array_equal(np.isfinite(want), np.isfinite(got))
    assert_close(want[exact], got[exact], RTOL, "+ - * / trees")
    f = np.isfinite(want) & ~exact
    np.testing.assert_allclose(got[f], want[f], rtol=tol)


@pytest.mark.parametrize("ops", ["exact", "transcendental"])
def test_float64_spine_bf16_forms_match_jax_x64(ops, monkeypatch):
    """fused_cost, fused_loss and fused_loss_multi with float64 data and
    bf16=True take kernels 1b and 2b's float64-spine forms (their plain
    versions here) and agree with the JAX package's bf16 kernels under x64:
    validity bit-equal, within rtol 1e-5 on + - * / and 1e-2 with a
    transcendental, the loss in float64."""
    binary, unary = EXACT if ops == "exact" else TRANSCENDENTAL
    F, n, T = 3, 65, 24
    jops, sops, jt, st = _trees(7, T, F, binary, unary)
    X, y, w = _data(F, n)
    exact = _exact(st)
    tol = RTOL if ops == "exact" else 1e-2
    calls = _counting(monkeypatch, "PROGRAM_EVAL_BF16_F64", "PROGRAM_MULTI_BF16_F64")
    cx = np.random.default_rng(1).integers(1, MAXSIZE, T).astype(np.int32)
    t = lambda a: torch.from_numpy(np.asarray(a))
    kw = dict(baseline_loss=torch.tensor(1.7, dtype=torch.float64),
              use_baseline=torch.tensor(True), parsimony=0.0032)
    sc, sl, sv = SF.fused_cost(st, t(X), t(y), t(w), t(cx), sops, SL.l2_dist_loss, bf16=True,
                               **kw)
    sp = SP.compile_program(st, F, len(binary))
    V = 3
    cv = np.asarray(to_np(sp.cvals), np.float64)[:, None, :] * (
        1.0 + 0.3 * np.random.default_rng(2).normal(size=(T, V, sp.cmax)))
    ml, mv = SF.fused_loss_multi(sp, t(cv), t(X), t(y), t(w), F, sops, SL.l2_dist_loss,
                                 bf16=True)
    assert calls == {"PROGRAM_EVAL_BF16_F64": 1, "PROGRAM_MULTI_BF16_F64": 1}
    assert sl.dtype == ml.dtype == torch.float64
    with jax.enable_x64(True):
        j = lambda a: jnp.asarray(a, jnp.float64)
        jc, jl, jv = JF.fused_cost(jt, j(X), j(y), j(w), jnp.asarray(cx), jops,
                                   JL.l2_dist_loss, baseline_loss=j(1.7),
                                   use_baseline=jnp.bool_(True), parsimony=0.0032,
                                   interpret=True, bf16=True, tree_block=1)
        jp = JP.compile_program(jt, F, len(binary))
        jml, jmv = JF.fused_loss_multi(jp, j(cv), j(X), j(y), j(w), F, jops, JL.l2_dist_loss,
                                       interpret=True, bf16=True, tree_block=1)
        jc, jl, jv, jml, jmv = (np.asarray(a) for a in (jc, jl, jv, jml, jmv))
    assert jl.dtype == np.float64
    assert np.array_equal(jv, to_np(sv)) and np.array_equal(jmv, to_np(mv))
    _bf16_agrees(jl, to_np(sl), exact, tol)
    _bf16_agrees(jc, to_np(sc), exact, tol)
    ex = np.repeat(exact[:, None], V, axis=1).reshape(-1)
    _bf16_agrees(jml.reshape(-1), to_np(ml).reshape(-1), ex, tol)


# ---------------------------------------------------------------------------
# bf16 data
# ---------------------------------------------------------------------------


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def test_bf16_data_forms_match_jax_fused_ops_and_numpy(monkeypatch):
    """bf16 data (eval_dtype="bfloat16": X, y and w rounded to bf16): the
    cost form and the line search take kernels 1b and 2b's bf16-data forms
    (their plain versions here): every loss a bf16 value; against the JAX
    fused ops on the same bf16 inputs validity bit-equal and the losses
    within 2e-2 (bf16 sums in another order); against a float32 numpy
    evaluation of the bf16-rounded data, whose steps are not rounded to
    bf16 as the value buffer's are, the rank contract of
    tests/test_torch_staged.py (finite verdicts agree, median relative
    error below 0.02, top-quartile overlap at least 75%)."""
    F, n, T = 3, 97, 48
    jops, sops, jt, st = _trees(3, T, F, *EXACT)
    X, y, w = (_bf16(a) for a in _data(F, n))
    calls = _counting(monkeypatch, "PROGRAM_EVAL_BF16_DATA", "PROGRAM_MULTI_BF16_DATA")
    t = torch.from_numpy
    kw = dict(baseline_loss=torch.tensor(1.0), use_baseline=torch.tensor(True), parsimony=0.0)
    sc, sl, sv = SF.fused_cost(st, t(X), t(y), t(w), torch.ones(T, dtype=torch.int32), sops,
                               SL.l2_dist_loss, bf16="data", **kw)
    sp = SP.compile_program(st, F, 4)
    ml, mv = SF.fused_loss_multi(sp, sp.cvals[:, None], t(X), t(y), t(w), F, sops,
                                 SL.l2_dist_loss, bf16="data")
    assert calls == {"PROGRAM_EVAL_BF16_DATA": 1, "PROGRAM_MULTI_BF16_DATA": 1}
    sl, ml = to_np(sl), to_np(ml)[:, 0]
    f = np.isfinite(sl)
    assert f.sum() >= 8 and np.array_equal(_bf16(sl[f]), sl[f])
    assert np.array_equal(np.isfinite(ml), f)
    np.testing.assert_allclose(ml[f], sl[f], rtol=1e-2)
    b = lambda a: jnp.asarray(a, jnp.bfloat16)
    jl, jv = JF.fused_loss(jt, b(X), b(y), b(w), jops, JL.l2_dist_loss, interpret=True,
                           tree_block=1)
    jl = np.asarray(jl.astype(jnp.float32))
    assert np.array_equal(np.asarray(jv), to_np(sv))
    np.testing.assert_allclose(sl[f], jl[f], rtol=2e-2)
    pred, valid = eval_tree_batch(st, t(X), sops)
    host = np.sum((to_np(pred) - y) ** 2 * w, axis=-1) / w.sum()
    ok = np.isfinite(host) & f
    assert (np.isfinite(host) == f).mean() >= 0.9
    rel = np.abs(sl[ok] - host[ok]) / (np.abs(host[ok]) + 1e-6)
    assert np.median(rel) < 0.02
    k = max(1, int(ok.sum()) // 4)
    top = lambda a: set(np.argsort(np.where(ok, a, np.inf))[:k])
    assert len(top(host) & top(sl)) >= 0.75 * k


def test_bf16_data_search_runs_as_the_jax_package_does():
    """equation_search(eval_dtype="bfloat16"), which the JAX package runs
    with turbo off (with turbo on its engine's epilogue fails on bf16 data,
    ROADMAP.md queue 3): the port's runs with turbo on and off, a float32
    state whose losses are bf16 values, its best loss within 3e-2 of a
    float32 numpy evaluation of its expression on the bf16-rounded data."""
    from symbolicregression_jl_tpu_torch.ops.encoding import encode_population

    X, y = problem(8, n=64, nfeatures=2)
    base = dict(binary_operators=["+", "-", "*"], unary_operators=[], maxsize=10,
                populations=2, population_size=16, ncycles_per_iteration=3,
                tournament_selection_n=8, eval_dtype="bfloat16", save_to_file=False)
    ops = S.OperatorSet(base["binary_operators"], [])
    for turbo in (True, False):
        state, hof = S.equation_search(X, y, options=S.Options(turbo=turbo, **base),
                                       niterations=1, seed=0, device="cpu", return_state=True)
        loss = to_np(state.device_states[0].pops.loss).reshape(-1)
        f = np.isfinite(loss)
        assert np.array_equal(_bf16(loss[f]), loss[f])
        best = min(hof.entries, key=lambda e: e.loss)
        Xb, yb = _bf16(X), _bf16(y)
        pred = to_np(eval_tree_batch(encode_population([best.tree], MAXSIZE, ops, device="cpu"),
                                     torch.from_numpy(Xb.T.copy()), ops)[0])[0]
        np.testing.assert_allclose(best.loss, np.mean((pred - yb) ** 2), rtol=3e-2)


# ---------------------------------------------------------------------------
# A user elementwise loss in a parametric, a float64 and a bf16 search
# ---------------------------------------------------------------------------

USER = lambda p, t: abs(p - t)   # noqa: E731


@pytest.mark.parametrize("form", ["parametric", "float64", "bf16"])
def test_user_loss_routes_match_the_eager_path(form, monkeypatch):
    """A user elementwise callable through fused_loss (and, in float64,
    fused_grad_multi) with turbo on takes kernel #4's per-member, ``double``
    or bf16 form (#5's ``double`` form for the gradient) and agrees with the
    eager path on the same trees: validity bit-equal, losses within rtol
    1e-5 (the bf16 form within 1e-2 of the eager bf16 mirror), the float64
    gradient within 1e-9 of the library L1's kernel gradient."""
    F, n, T = 2, 81, 40
    NP, NC = 2, 3
    jops, sops, jt, st = _trees(9, T, F, *TRANSCENDENTAL,
                                n_params=NP if form == "parametric" else 0)
    X, y, w = _data(F, n)
    dt = torch.float64 if form == "float64" else torch.float32
    Xt, yt, wt = (torch.from_numpy(a).to(dt) for a in (X, y, w))
    if form == "parametric":
        calls = _counting(monkeypatch, "PROGRAM_PREDICT")
        cls = torch.from_numpy(np.random.default_rng(4).integers(0, NC, n).astype(np.int32))
        bank = torch.from_numpy(np.random.default_rng(5).normal(size=(T, NP, NC))).float()
        sl, sv = SF.fused_loss(st, Xt, yt, wt, sops, USER, params=bank, class_idx=cls)
        assert calls["PROGRAM_PREDICT"] >= 1
        rows = bank[..., cls.long()]
        pred, valid = eval_tree_batch(st, Xt, sops, params=rows)
        want = SL.aggregate_loss(USER, pred, yt, valid, wt)
        ref_valid = valid & torch.isfinite(want)
        assert torch.equal(sv & torch.isfinite(sl), ref_valid)
        assert_close(to_np(want), to_np(sl), RTOL, "parametric user loss")
        return
    if form == "float64":
        calls = _counting(monkeypatch, "PROGRAM_PREDICT_F64", "PROGRAM_PREDICT_VJP_F64")
        st = st.__class__(*(f.double() if f.is_floating_point() else f for f in st.fields()))
        sl, sv = SF.fused_loss(st, Xt, yt, wt, sops, USER)
        pred, valid = eval_tree_batch(st, Xt, sops)
        want = SL.aggregate_loss(USER, pred, yt, valid, wt)
        assert sl.dtype == torch.float64
        assert torch.equal(sv & torch.isfinite(sl), valid & torch.isfinite(want))
        assert_close(to_np(want), to_np(sl), 1e-12, "float64 user loss")
        sp = SP.compile_program(st, F, 4)
        cv = sp.cvals[:, None].double()
        gl, gv, gg = SF.fused_grad_multi(sp, cv, Xt, yt, wt, F, sops, USER)
        kl, kv, kg = SF.fused_grad_multi(sp, cv, Xt, yt, wt, F, sops, SL.l1_dist_loss)
        assert calls["PROGRAM_PREDICT_F64"] >= 2 and calls["PROGRAM_PREDICT_VJP_F64"] >= 1
        assert torch.equal(gv, kv)
        np.testing.assert_allclose(to_np(gl), to_np(kl), rtol=1e-12)
        np.testing.assert_allclose(to_np(gg), to_np(kg), rtol=1e-9,
                                   atol=1e-9 * float(kg.abs().max()))
        return
    calls = _counting(monkeypatch, "PROGRAM_PREDICT_BF16")
    sl, sv = SF.fused_loss(st, Xt, yt, wt, sops, USER, bf16=True)
    ml, mv = SF.fused_loss_multi(SP.compile_program(st, F, 4), SP.compile_program(
        st, F, 4).cvals[:, None], Xt, yt, wt, F, sops, USER, bf16=True)
    assert calls["PROGRAM_PREDICT_BF16"] == 2
    trees_b = st.__class__(*(f.bfloat16() if f.is_floating_point() else f for f in st.fields()))
    pred, valid = eval_tree_batch(trees_b, Xt.bfloat16(), sops)
    want = SL.aggregate_loss(USER, pred.float(), yt, valid, wt)
    assert torch.equal(sv & torch.isfinite(sl), valid & torch.isfinite(want))
    f = to_np(valid & torch.isfinite(want))
    np.testing.assert_allclose(to_np(sl)[f], to_np(want)[f], rtol=1e-2)
    assert torch.equal(ml[:, 0], sl) and torch.equal(mv[:, 0], sv)
