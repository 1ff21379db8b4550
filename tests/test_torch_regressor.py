"""The port's SRRegressor and MultitargetSRRegressor on the CPU.

``fit`` and ``predict`` agree with a float64 host evaluation of the chosen
equation (rtol 1e-5, with an absolute floor of 1e-5 of the predictions'
RMS where rows cancel to near 0); ``choose_best`` and ``compute_scores``
return what the JAX package's do on identical entries; ``category=``
routes each row to its class's parameters; warm refits run only the
iterations not yet run; export and units refuse, naming their slices.
"""

import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.api import hall_of_fame as JH
from symbolicregression_jl_tpu.api import regressor as JR
from symbolicregression_jl_tpu_torch.api import hall_of_fame as SH
from symbolicregression_jl_tpu_torch.api import regressor as SRG

from torch_parity import cap_torch_threads

cap_torch_threads()

SMALL = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=12,
             populations=2, population_size=16, ncycles_per_iteration=4,
             tournament_selection_n=4, save_to_file=False, device="cpu")


def _problem(n=128, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    y = (X[:, 0] * X[:, 0] + np.cos(X[:, 1])).astype(np.float32)
    return X, y


def _host(node, X, params=None, cls=None):
    """A tree's predictions in float64 on the host; a parameter leaf reads
    ``params[p, cls[row]]``."""
    if node.degree == 0:
        if node.is_parameter:
            return torch.from_numpy(params[node.parameter][cls].astype(np.float64))
        if node.constant:
            return torch.full((X.shape[0],), float(node.val), dtype=torch.float64)
        return torch.from_numpy(X[:, node.feature].astype(np.float64))
    return node.op.fn(*[_host(c, X, params, cls) for c in node.children])


def _assert_predicts(pred, want):
    want = np.asarray(want, np.float64)
    atol = 1e-5 * float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(pred, want, rtol=1e-5, atol=atol)


def test_fit_predict_agree_with_host_evaluation():
    X, y = _problem()
    model = S.SRRegressor(niterations=3, seed=0, **SMALL).fit(X, y)
    assert not model.device_scaled_           # device_scale applies on CUDA only
    best = model.get_best()
    Xh = _problem(64, seed=1)[0]
    _assert_predicts(model.predict(Xh), _host(best.tree, Xh).numpy())
    for i, rec in enumerate(model.equations_):
        _assert_predicts(model.predict(Xh, idx=i), _host(rec.tree, Xh).numpy())
    p = model.predict(X).astype(np.float64)
    r2 = 1.0 - np.sum((y - p) ** 2) / np.sum((y - np.mean(y)) ** 2)
    assert model.score(X, y) == pytest.approx(r2, rel=1e-6) and r2 > 0
    # A DataFrame-like dict of columns is reordered by the fitted names.
    cols = {"x2": Xh[:, 1], "x1": Xh[:, 0]}
    np.testing.assert_array_equal(model.predict(cols), model.predict(Xh))


def test_choose_best_and_scores_match_jax():
    """On identical entries both packages' compute_scores and choose_best
    agree, for both loss scales."""
    losses = [3.0, 1.0, 0.9, 0.2, 0.19, 0.18]
    cx = [1, 3, 4, 6, 9, 13]
    je = [JH.HallOfFameEntry(tree=None, loss=l, cost=l, complexity=c) for l, c in zip(losses, cx)]
    se = [SH.HallOfFameEntry(tree=None, loss=l, cost=l, complexity=c) for l, c in zip(losses, cx)]
    for scale in ("log", "linear"):
        js = JH.compute_scores(JH.calculate_pareto_frontier(je), scale)
        ss = SH.compute_scores(SH.calculate_pareto_frontier(se), scale)
        assert [e.score for e in js] == [e.score for e in ss]
        kw = dict(trees=[None] * len(js), losses=[e.loss for e in js],
                  scores=[e.score for e in js], complexities=[e.complexity for e in js])
        jo, so = J.Options(loss_scale=scale), S.Options(loss_scale=scale, save_to_file=False)
        assert JR.choose_best(options=jo, **kw) == SRG.choose_best(options=so, **kw)


def test_category_routes_classes():
    """A parametric fit predicts each row with its class's parameter;
    unseen classes and a missing category raise."""
    rng = np.random.default_rng(3)
    X = rng.uniform(-2, 2, (96, 2)).astype(np.float32)
    cat = rng.choice(np.array(["a", "b", "c"]), 96)
    offset = {"a": 1.0, "b": -2.0, "c": 0.5}
    y = (2.0 * X[:, 0] + np.array([offset[c] for c in cat])).astype(np.float32)
    model = S.SRRegressor(niterations=4, seed=1, expression_spec=S.ParametricExpressionSpec(
        max_parameters=1), optimizer_probability=0.5, optimizer_iterations=4,
        **dict(SMALL, binary_operators=["+", "*"], unary_operators=[]))
    model.fit(X, y, category=cat)
    best = model.get_best()
    cls = np.searchsorted(model.classes_, cat)
    _assert_predicts(model.predict(X, category=cat), _host(best.tree, X, best.params, cls))
    with pytest.raises(ValueError, match="category"):
        model.predict(X)
    with pytest.raises(ValueError, match="not seen"):
        model.predict(X[:2], category=np.array(["a", "z"]))


def test_warm_refit_runs_only_the_missing_iterations(monkeypatch):
    X, y = _problem()
    model = S.SRRegressor(niterations=2, seed=0, **SMALL).fit(X, y)
    assert model.fitted_iterations_ == 2
    calls = []
    real = SRG.equation_search
    monkeypatch.setattr(SRG, "equation_search", lambda *a, **k: calls.append(
        k["runtime_options"].niterations) or real(*a, **k))
    model.fit(X, y)                       # nothing left to run
    assert calls == []
    model.niterations = 3
    model.fit(X, y)
    assert calls == [1] and model.fitted_iterations_ == 3
    assert model.state_.num_evals > 0


def test_multitarget_returns_one_equation_per_output():
    X, y = _problem()
    Y = np.stack([y, 2.0 * X[:, 0]], axis=1)
    model = S.MultitargetSRRegressor(niterations=2, seed=0, **SMALL).fit(X, Y)
    best = model.get_best()
    assert len(best) == 2 and len(model.equations_) == 2
    pred = model.predict(X)
    assert pred.shape == (128, 2)
    for j in range(2):
        _assert_predicts(pred[:, j], _host(best[j].tree, X).numpy())


def test_initial_population_reaches_the_truth():
    """fit(initial_population=...) passes the seeds to equation_search: the
    truth among them is the best equation."""
    X, y = _problem()
    model = S.SRRegressor(niterations=1, seed=0, **SMALL)
    model.fit(X, y, initial_population=["x1 * x1 + cos(x2)", "x1", "cos(x2)"])
    assert min(r.loss for r in model.equations_) <= 1e-10


def test_export_and_units_refuse():
    """latex() and sympy() export the best equation (utils/export.py; held
    against the JAX package's in tests/test_torch_export.py); units came
    with the expression-plugin slice; bf16 data and float64 data on a bf16
    buffer, refused by earlier slices, fit and predict through the
    regressor."""
    X, y = _problem(32)
    model = S.SRRegressor(niterations=1, seed=0, **SMALL).fit(X, y)
    assert isinstance(model.latex(), str) and model.latex()
    try:
        import sympy  # noqa: F401
    except ImportError:
        pass
    else:
        assert str(model.sympy())
    for kw in (dict(eval_dtype="bfloat16"), dict(eval_dtype="float64", eval_precision="bf16")):
        fitted = S.SRRegressor(niterations=1, seed=0, **kw, **SMALL).fit(X, y)
        assert np.isfinite(fitted.get_best().loss)
        assert np.all(np.isfinite(fitted.predict(X)))
