"""Differentiation in the PyTorch/CUDA port against the JAX package, on
the CPU: symbolic ``D`` (ops/diff.py), ``eval_diff_tree_array`` and
``eval_grad_tree_array`` (forward mode in both), ``eval_tree_array``,
``ComposableExpression.derivative``, the exported ``D`` dispatch, and the
constant optimizer of templates with ``D(...)`` call sites (the eager
interpreter's second-order path, as the JAX engine's interpreter path).

Tolerances: ``string_tree`` of a symbolic derivative equal; values and
derivatives within rtol 1e-5 on at least 99% of rows, finite in the same
places (the two CPU backends' transcendentals differ by an ULP,
tests/test_torch_ops.py); the ``D``-template optimizer's constants within
rtol 1e-3, its losses within rtol 1e-5 or 1e-7 absolute, ``f_calls`` and
``improved`` equal (tests/test_torch_template.py's rule for the
optimizer)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.evolve import constant_opt as JC
from symbolicregression_jl_tpu.models import composable as JM
from symbolicregression_jl_tpu.models import template as JT
from symbolicregression_jl_tpu.ops import diff as JDf
from symbolicregression_jl_tpu.ops import encoding as JE
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.evolve import constant_opt as SC
from symbolicregression_jl_tpu_torch.models import composable as SM
from symbolicregression_jl_tpu_torch.models import template as ST
from symbolicregression_jl_tpu_torch.ops import diff as SDf

from torch_parity import port_key, to_np

BINARY = ["+", "-", "*", "/", "^", "max", "min"]
UNARY = ["cos", "sin", "exp", "log", "sqrt", "tanh", "abs", "square", "cube", "inv", "atan",
         "neg"]


def _random_tree(rng, depth: int) -> str:
    if depth == 0 or rng.random() < 0.25:
        return (f"x{rng.integers(1, 3)}" if rng.random() < 0.6
                else f"{rng.choice([0.5, 2.0, 1.5, -1.25])}")
    if rng.random() < 0.45:
        return f"{rng.choice(UNARY)}({_random_tree(rng, depth - 1)})"
    op = rng.choice(BINARY)
    a, b = _random_tree(rng, depth - 1), _random_tree(rng, depth - 1)
    return f"{op}({a}, {b})" if op in ("max", "min") else f"({a} {op} {b})"


def _pairs(seed, n):
    rng = np.random.default_rng(seed)
    jops, sops = J.OperatorSet(BINARY, UNARY), S.OperatorSet(BINARY, UNARY)
    exprs = [_random_tree(rng, 3) for _ in range(n)]
    return jops, sops, [(J.parse_expression(e, jops), S.parse_expression(e, sops))
                        for e in exprs]


def _near(a, b, rtol, share=0.99):
    """Within ``rtol`` on ``share`` of the entries, finite in the same
    places; a derivative that cancels to zero in one package may keep an
    ULP-sized remainder in the other, so the floor is ``rtol`` times the
    array's largest finite magnitude."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    f = np.isfinite(a)
    if f.any():
        floor = rtol * np.max(np.abs(a[f]))
        near = np.abs(a[f] - b[f]) <= rtol * np.abs(a[f]) + floor
        assert near.mean() >= share, near.mean()


@pytest.mark.parametrize("seed", [0, 1])
def test_symbolic_D_same_string_tree(seed):
    _, _, pairs = _pairs(seed, 150)
    for jt, st in pairs:
        for f in (0, 1):
            jd, sd = JDf.D(jt, f), SDf.D(st, f)
            assert S.string_tree(sd) == J.string_tree(jd)
            assert S.string_tree(S.D(st, f)) == J.string_tree(J.D(jt, f))   # the exported D
    with pytest.raises(ValueError, match="No derivative rule"):
        SDf.D(S.parse_expression("mod(x1, 2.0)", S.OperatorSet(["mod"], [])), 0)


@pytest.mark.parametrize("seed", [2])
def test_eval_diff_and_grad_match_jax(seed):
    """eval_tree_array, eval_diff_tree_array (each feature) and
    eval_grad_tree_array (features and constants) within rtol 1e-5 on 99%
    of rows; validity equal. The symbolic derivative evaluated by the
    interpreter (its helper operators added by extend_operators_for) agrees
    with the forward-mode one where both are finite."""
    jops, sops, pairs = _pairs(seed, 5)
    # 256 rows, so that the 99% rule leaves room for the few rows where
    # XLA's CPU tanh (off by more than an ULP near saturation, ROADMAP
    # queue 3) is amplified by the 1 - tanh^2 of its derivative
    X = np.random.default_rng(seed).uniform(0.2, 2.0, (256, 2)).astype(np.float32)
    for jt, st in pairs:
        jy, jv = JDf.eval_tree_array(jt, X, jops)
        sy, sv = SDf.eval_tree_array(st, X, sops, device="cpu")
        assert bool(jv) == bool(sv)
        _near(to_np(jy), to_np(sy), 1e-5)
        for f in (0, 1):
            jy, jdy, jv = JDf.eval_diff_tree_array(jt, X, jops, f)
            sy, sdy, sv = SDf.eval_diff_tree_array(st, X, sops, f, device="cpu")
            assert bool(jv) == bool(sv)
            _near(to_np(jdy), to_np(sdy), 1e-5)
        for variable in (True, False):
            _, jg, jv = JDf.eval_grad_tree_array(jt, X, jops, variable=variable)
            _, sg, sv = SDf.eval_grad_tree_array(st, X, sops, variable=variable, device="cpu")
            assert tuple(sg.shape) == tuple(jg.shape) and bool(jv) == bool(sv)
            _near(to_np(jg), to_np(sg), 1e-5)
        sym = SDf.eval_tree_array(SDf.D(st, 0), X, sops, device="cpu")[0]
        fwd = SDf.eval_diff_tree_array(st, X, sops, 0, device="cpu")[1]
        both = np.isfinite(to_np(sym)) & np.isfinite(to_np(fwd))
        np.testing.assert_allclose(to_np(sym)[both], to_np(fwd)[both], rtol=1e-4, atol=1e-5)
    assert SDf.differentiable_eval_tree_array is SDf.eval_tree_array


def test_composable_derivative_matches_jax():
    """ComposableExpression.derivative: the same string (its operator set
    extended with the rules' helpers) and the same values within rtol 1e-5
    as the JAX package's."""
    jops, sops = J.OperatorSet(["+", "*", "-"], ["cos"]), S.OperatorSet(["+", "*", "-"], ["cos"])
    for expr, nf in (("cos(x1) * x2 * x2", 2), ("x1 * x1 * cos(x1)", 1), ("2.5 * x2 + x1", 2)):
        jf = JM.ComposableExpression(J.parse_expression(expr, jops), jops, nf)
        sf = SM.ComposableExpression(S.parse_expression(expr, sops), sops, nf, device="cpu")
        a = np.linspace(-2, 2, 9).astype(np.float32)
        for argnum in range(1, nf + 1):
            jd, sd = jf.derivative(argnum), sf.derivative(argnum)
            assert sd.string() == jd.string()
            assert sorted(o.name for o in sd.operators.unary) == \
                sorted(o.name for o in jd.operators.unary)
            args = [a] * nf
            np.testing.assert_allclose(to_np(sd(*args)), to_np(jd(*args)), rtol=1e-5,
                                       atol=1e-6)
        with pytest.raises(ValueError, match="out of range"):
            sf.derivative(nf + 1)
    # the exported D on a composable: a derivative callable (1-based slot)
    sf = SM.ComposableExpression(S.parse_expression("x1 * x1", sops), sops, 1, device="cpu")
    np.testing.assert_allclose(to_np(S.D(sf, 1)(np.float32([1.5, -2.0]))), [3.0, -4.0])


# ---------------------------------------------------------------------------
# The constant optimizer of templates with D(...) call sites
# ---------------------------------------------------------------------------

D_MEMBERS = ["0.8 * (#1 * #1) * cos(#1)", "cos(1.3 * #1) * 2.1", "#1 * #1 * 0.7",
             "#1 * cos(#1)", "1.1 * (#1 * cos(0.9 * #1))"]


def _d_problem(n=60):
    """y = -dV/dx1 for V = x1^2 cos(x1)."""
    x = np.random.default_rng(4).uniform(-2.0, 2.0, (n, 1)).astype(np.float32)
    x1 = x[:, 0].astype(np.float64)
    y = -(2 * x1 * np.cos(x1) - x1 * x1 * np.sin(x1))
    return x, y.astype(np.float32)


def test_D_template_constant_optimizer_matches_jax():
    """The JAX engine optimizes a structure with D call sites on its
    interpreter path (jax.grad through jax.jvp); the port takes the
    gradient on the eager interpreter's forward-mode derivative under
    autograd, and its line search on the interpreter (fused=False) or on
    the kernels (fused=True; their plain versions here). On identifiable
    members, both ways: f_calls and improved equal, constants within rtol
    1e-3, losses within rtol 1e-5 or 1e-7 absolute."""
    jops, sops = J.OperatorSet(["+", "-", "*"], ["cos"]), S.OperatorSet(["+", "-", "*"], ["cos"])
    js = JT.template_spec(expressions=("V",))(lambda V, x1: -JT.D(V, 1)(x1))
    ss = ST.template_spec(expressions=("V",))(lambda V, x1: -ST.D(V, 1)(x1))
    assert js.structure.uses_deriv and ss.structure.uses_deriv
    hosts = [JT.template_from_dict(dict(V=v), js.structure, jops) for v in D_MEMBERS]
    encs = [h.encode(12) for h in hosts]
    jt = JE.TreeBatch(*(jnp.stack([getattr(e, f) for e in encs])
                        for f in ("arity", "op", "feat", "const", "length")))
    st = interop.tree_batch(jax.tree.map(np.asarray, jt), device="cpu")
    X, y = _d_problem()
    jds = J.make_dataset(X, y)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    do_opt = np.ones(len(D_MEMBERS), bool)
    do_opt[3] = False
    key = jax.random.key(3)
    el = J.Options(save_to_file=False).elementwise_loss
    jc, ji, jl, jf, _ = JC.optimize_constants_template(
        key, jt, jnp.asarray(do_opt), jds.data, el, jops, JC.OptimizerConfig(), js.structure,
        fused=False, interpret=True)
    sc, si, sl, sf = SC.optimize_constants_template(
        port_key(key), st, torch.from_numpy(do_opt), sd,
        S.Options(save_to_file=False).elementwise_loss, sops, SC.OptimizerConfig(),
        ss.structure, fused=False)
    assert np.array_equal(to_np(jf), to_np(sf))
    assert np.array_equal(to_np(ji), to_np(si))
    assert to_np(si)[0] and not to_np(si)[3]
    np.testing.assert_allclose(to_np(sl), to_np(jl), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(to_np(sc), to_np(jc), rtol=1e-3, atol=1e-6)
    # member 0 lands on the true constant
    assert to_np(sl)[0] < 1e-8
    # the eager path's member chunks (D_CHUNK_BYTES) change no value
    chunked = SC.D_CHUNK_BYTES
    try:
        # two members a line-search chunk: 1 key x 12 slots x 60 rows x 4
        # bytes x R x C (the gradient's chunks hold C times as many)
        cfg = SC.OptimizerConfig()
        SC.D_CHUNK_BYTES = 12 * 60 * 4 * (cfg.nrestarts + 1) * cfg.max_linesearch * 2
        cc, ci, cl, cf = SC.optimize_constants_template(
            port_key(key), st, torch.from_numpy(do_opt), sd,
            S.Options(save_to_file=False).elementwise_loss, sops, SC.OptimizerConfig(),
            ss.structure, fused=False)
    finally:
        SC.D_CHUNK_BYTES = chunked
    assert torch.equal(cf, sf) and torch.equal(ci, si)
    np.testing.assert_allclose(to_np(cc), to_np(sc), rtol=1e-6, atol=1e-7)
    # fused: the line search on the kernels' plain versions, the gradient
    # still on the eager interpreter; the same optimum
    fc, fi, fl, ff = SC.optimize_constants_template(
        port_key(key), st, torch.from_numpy(do_opt), sd,
        S.Options(save_to_file=False).elementwise_loss, sops, SC.OptimizerConfig(),
        ss.structure, fused=True)
    assert np.array_equal(to_np(ff), to_np(jf)) and np.array_equal(to_np(fi), to_np(ji))
    np.testing.assert_allclose(to_np(fl), to_np(jl), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(to_np(fc), to_np(jc), rtol=1e-3, atol=1e-6)


def test_D_template_search_with_the_optimizer_on_the_cpu():
    """A D-template search with the constant optimizer on (refused before
    this slice), turbo on (call sites through the kernels' plain versions,
    the optimizer on the eager interpreter): it recovers V = x1^2 cos(x1)."""
    X, y = _d_problem(n=100)
    spec = ST.template_spec(expressions=("V",))(lambda V, x1: -S.D(V, 1)(x1))
    o = S.Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=10,
                  populations=3, population_size=24, ncycles_per_iteration=8,
                  tournament_selection_n=6, expression_spec=spec, turbo=True,
                  save_to_file=False)
    hof = S.equation_search(X, y, options=o, niterations=2, seed=0, device="cpu")
    best = min(hof.entries, key=lambda e: e.loss)
    assert np.isfinite(best.loss) and best.loss < 0.5 * float(np.var(y))
