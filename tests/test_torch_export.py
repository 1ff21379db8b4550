"""Expression export of the port (utils/export.py, SRRegressor.latex() and
.sympy()) against the JAX package's: the same LaTeX strings, SymPy
expressions and callable values from the same parsed trees. sympy cases
skip where sympy is not installed."""

import numpy as np
import pytest

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.models.template import HostTemplateExpression as JHost
from symbolicregression_jl_tpu.models.template import template_spec as j_template_spec
from symbolicregression_jl_tpu.utils import export as JX
from symbolicregression_jl_tpu_torch.models.template import HostTemplateExpression as SHost
from symbolicregression_jl_tpu_torch.models.template import template_spec as s_template_spec
from symbolicregression_jl_tpu_torch.utils import export as SX

BINARY = ["+", "-", "*", "/", "^", "max", "mod"]
UNARY = ["cos", "exp", "abs", "sqrt", "square", "cube", "neg", "inv", "log", "tanh", "sign",
         "gamma", "relu"]
EXPRS = [
    "cos(2.13 * x1) + 0.5 * x2",
    "x1 * x2 - exp(x3 / 2.0)",
    "(x1 + x2) * (x3 - 1.5)",
    "x1 - (x2 + x3)",
    "abs(x1) ^ 0.9 - sqrt(abs(x2))",
    "square(x1) + cube(x2) - neg(x3) * inv(x1)",
    "max(x1, x2) + mod(x3, 2.0)",
    "log(abs(x1) + 1.0) * tanh(x2)",
    "1.2345678e-7 * x1 + 3.4e12",
    "sign(x1) * gamma(abs(x2) + 1.0) + relu(x3)",
]
NAMES = ["x1", "x2", "x3"]


def _pair(expr: str):
    jops = J.OperatorSet(BINARY, UNARY)
    sops = S.OperatorSet(BINARY, UNARY)
    return (J.parse_expression(expr, jops, NAMES), S.parse_expression(expr, sops, NAMES))


@pytest.mark.parametrize("expr", EXPRS)
@pytest.mark.parametrize("names", [None, ["a", "b", "c"]], ids=["default", "named"])
def test_to_latex_matches_jax(expr, names):
    jt, st = _pair(expr)
    for precision in (4, 6):
        assert SX.to_latex(st, names, precision) == JX.to_latex(jt, names, precision)


@pytest.mark.parametrize("expr", EXPRS)
def test_to_sympy_matches_jax(expr):
    sp = pytest.importorskip("sympy")
    jt, st = _pair(expr)
    for names in (None, ["a", "b", "c"]):
        a, b = JX.to_sympy(jt, names), SX.to_sympy(st, names)
        assert sp.srepr(a) == sp.srepr(b)


@pytest.mark.parametrize("expr", EXPRS)
def test_to_callable_matches_jax(expr):
    """Float32 values within rtol 1e-5, or within 1e-5 of the largest
    |value| where terms cancel (the two packages' float32 math functions,
    lgamma among them, round an ULP apart); NaN and +-inf in the same
    places."""
    jt, st = _pair(expr)
    X = np.random.default_rng(0).uniform(-3, 3, (200, 3)).astype(np.float32)
    a = np.asarray(JX.to_callable(jt)(X))
    b = np.asarray(SX.to_callable(st)(X))
    assert b.dtype == np.float32
    assert np.array_equal(np.isnan(a), np.isnan(b)) and np.array_equal(np.isinf(a), np.isinf(b))
    f = np.isfinite(a)
    np.testing.assert_allclose(b[f], a[f], rtol=1e-5, atol=1e-5 * np.abs(a[f]).max())


def test_to_callable_parameters():
    """A parametric tree reads ``params``; without them it raises."""
    jops, sops = J.OperatorSet(["+", "*"], []), S.OperatorSet(["+", "*"], [])
    jt = J.Node(op=jops.binary[1], children=[J.Node(feature=0), J.Node(parameter=0, is_parameter=True)])
    st = S.Node(op=sops.binary[1], children=[S.Node(feature=0), S.Node(parameter=0, is_parameter=True)])
    X = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_allclose(SX.to_callable(st)(X, params=[2.5]),
                               np.asarray(JX.to_callable(jt)(X, params=[2.5])))
    assert SX.to_latex(st) == JX.to_latex(jt)
    with pytest.raises(ValueError, match="params"):
        SX.to_callable(st)(X)


@pytest.mark.parametrize("params", [None, np.array([1.25, -0.5], np.float32)], ids=["plain", "p"])
def test_template_to_latex_matches_jax(params):
    kw = dict(expressions=("f", "g"), parameters={"p": 2}) if params is not None else dict(
        expressions=("f", "g"))
    if params is None:
        jspec = j_template_spec(**kw)(lambda f, g, x1, x2: f(x1, x2) + g(x2))
        sspec = s_template_spec(**kw)(lambda f, g, x1, x2: f(x1, x2) + g(x2))
    else:
        jspec = j_template_spec(**kw)(lambda f, g, x1, x2, p: f(x1, x2) * p[0] + g(x2) + p[1])
        sspec = s_template_spec(**kw)(lambda f, g, x1, x2, p: f(x1, x2) * p[0] + g(x2) + p[1])
    jops, sops = J.OperatorSet(["+", "*", "-"], ["cos"]), S.OperatorSet(["+", "*", "-"], ["cos"])
    args = ["#1", "#2"]
    jtrees = {"f": J.parse_expression("cos(#1) * 2.5 - #2", jops, args),
              "g": J.parse_expression("#1 + 0.125", jops, args[:1])}
    strees = {"f": S.parse_expression("cos(#1) * 2.5 - #2", sops, args),
              "g": S.parse_expression("#1 + 0.125", sops, args[:1])}
    jh = JHost(trees=jtrees, structure=jspec.structure, operators=jops, params=params)
    sh = SHost(trees=strees, structure=sspec.structure, operators=sops, params=params)
    for precision in (4, 3):
        assert SX.template_to_latex(sh, precision) == JX.template_to_latex(jh, precision)


def test_regressor_latex_and_sympy():
    """SRRegressor.latex() and .sympy() give the JAX export of the fitted
    best equation (the same tree through the JAX package's export)."""
    sp = pytest.importorskip("sympy")
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (64, 2)).astype(np.float32)
    y = (2.0 * X[:, 0] + np.cos(X[:, 1])).astype(np.float32)
    model = S.SRRegressor(niterations=1, seed=0, device="cpu", binary_operators=["+", "*"],
                          unary_operators=["cos"], populations=2, population_size=16,
                          ncycles_per_iteration=4, save_to_file=False)
    model.fit(X, y, initial_population=["2.0 * x1 + cos(x2)"])
    best = model.get_best()
    jtree = J.parse_expression(best.equation, J.OperatorSet(["+", "*"], ["cos"]), ["x1", "x2"])
    assert model.latex() == JX.to_latex(jtree, ["x1", "x2"])
    assert sp.simplify(model.sympy() - JX.to_sympy(jtree, ["x1", "x2"])) == 0
    for i in range(len(model.equations_)):
        assert isinstance(model.latex(i), str)
