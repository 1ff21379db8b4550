"""Units and dimensional analysis in the PyTorch/CUDA port against the JAX
package, on the CPU: ``core/units.py`` (a copy), the dims arrays of
``make_dataset``, ``ops/dims_eval.py``'s violations on random trees, the
penalized cost of ``evolve/step.py``, a units search, and the unit-typed
``predict``. Tolerances: violations, dims arrays and encodings bit-equal;
costs within rtol 1e-5 (the row sums run in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.core import units as JU
from symbolicregression_jl_tpu.core.dataset import make_dataset as j_make
from symbolicregression_jl_tpu.evolve import step as JS
from symbolicregression_jl_tpu.ops import dims_eval as JD
from symbolicregression_jl_tpu.ops.complexity import build_complexity_tables as j_tables
from symbolicregression_jl_tpu.ops.encoding import encode_population as j_encode
from symbolicregression_jl_tpu_torch.core import units as SU
from symbolicregression_jl_tpu_torch.core.dataset import make_dataset as s_make
from symbolicregression_jl_tpu_torch.evolve import step as SS
from symbolicregression_jl_tpu_torch.ops import dims_eval as SD
from symbolicregression_jl_tpu_torch.ops.complexity import build_complexity_tables as s_tables
from symbolicregression_jl_tpu_torch.ops.encoding import encode_population as s_encode

from torch_parity import assert_close, to_np

BINARY = ["+", "-", "*", "/", "^", "max", "greater"]
UNARY = ["cos", "sqrt", "square", "abs", "inv", "exp", "sign", "cube"]
SPECS = ["m/s^2", "kg*m^2/s^2", "m s^-1", "km", "g", "J", "N*m", "m^1//2", "Hz", "",
         "1", None, "mol/L", "kg^0.5", "uA*h", "deg", [1, 0, -2, 0, 0, 0, 0]]


@pytest.mark.parametrize("spec", SPECS, ids=[str(s) for s in SPECS])
def test_parse_unit_and_dims_arrays_bit_equal(spec):
    jq, sq = JU.parse_unit(spec), SU.parse_unit(spec)
    assert sq.scale == jq.scale
    assert sq.dims.exps == jq.dims.exps
    assert SU.pretty_dims(sq.dims) == JU.pretty_dims(jq.dims)
    a, b = JU.dims_to_array(jq.dims), SU.dims_to_array(sq.dims)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_dataset_dims_and_extra_match_jax():
    rng = np.random.default_rng(0)
    X = rng.uniform(1, 2, (20, 3)).astype(np.float32)
    y = X[:, 0].astype(np.float32)
    extra = {"class": rng.integers(0, 3, 20), "site": np.arange(20)}
    jd = j_make(X, y, X_units=["kg", "m/s", ""], y_units="J", extra=dict(extra))
    sd = s_make(X, y, X_units=["kg", "m/s", ""], y_units="J", extra=dict(extra), device="cpu")
    assert to_np(sd.data.x_dims).tobytes() == np.asarray(jd.data.x_dims).tobytes()
    assert to_np(sd.data.y_dims).tobytes() == np.asarray(jd.data.y_dims).tobytes()
    assert sd.display_variable_names == jd.display_variable_names
    assert sd.has_units and sd.X_units == jd.X_units and sd.y_units == jd.y_units
    assert sorted(sd.extra) == sorted(jd.extra)
    assert np.array_equal(sd.extra["site"], jd.extra["site"])
    assert np.array_equal(to_np(sd.data.class_idx), np.asarray(jd.data.class_idx))
    # the row the check reads survives a minibatch
    sub = sd.data.take_rows(torch.tensor([5, 7]))
    assert torch.equal(sub.dims_row, torch.from_numpy(X[0])) and sub.x_dims is sd.data.x_dims
    for X_units, y_units in ((None, "m"), (["m", "s", "kg"], None), (None, None)):
        jx, jy = JU.units_to_dims_arrays(X_units, 3, y_units)
        sx, sy = SU.units_to_dims_arrays(X_units, 3, y_units)
        for a, b in ((jx, sx), (jy, sy)):
            assert (a is None) == (b is None) and (a is None or a.tobytes() == b.tobytes())


def _random_tree(rng, depth: int) -> str:
    if depth == 0 or rng.random() < 0.25:
        r = rng.random()
        if r < 0.55:
            return f"x{rng.integers(1, 4)}"
        return f"{rng.choice([0.5, 2.0, 3.0, -1.5, 1.0])}"
    if rng.random() < 0.4:
        return f"{rng.choice(UNARY)}({_random_tree(rng, depth - 1)})"
    op = rng.choice(BINARY)
    a, b = _random_tree(rng, depth - 1), _random_tree(rng, depth - 1)
    if op in ("max", "greater"):
        return f"{op}({a}, {b})"
    return f"({a} {op} {b})"


def _trees(seed, n=300):
    rng = np.random.default_rng(seed)
    jops, sops = J.OperatorSet(BINARY, UNARY), S.OperatorSet(BINARY, UNARY)
    exprs = [_random_tree(rng, 4) for _ in range(n)]
    jt = [J.parse_expression(e, jops) for e in exprs]
    st = [S.parse_expression(e, sops) for e in exprs]
    L = max(t.count_nodes() for t in jt)
    jb, sb = j_encode(jt, L, jops), s_encode(st, L, sops, device="cpu")
    for f in ("arity", "op", "feat", "length"):
        assert np.array_equal(np.asarray(getattr(jb, f)), to_np(getattr(sb, f))), f
    return jops, sops, jb, sb


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dimensional_violations_bit_equal_on_random_trees(seed):
    jops, sops, jb, sb = _trees(seed)
    rng = np.random.default_rng(100 + seed)
    x = rng.uniform(0.5, 2.0, 3).astype(np.float32)
    x_dims = np.stack([SU.dims_to_array(SU.parse_unit(u).dims) for u in ("m", "s", "")])
    y_dims = SU.dims_to_array(SU.parse_unit("m/s").dims)
    assert np.array_equal(SD.classify_operators(sops)[0], JD.classify_operators(jops)[0])
    assert np.array_equal(SD.classify_operators(sops)[1], JD.classify_operators(jops)[1])
    mixed = []
    for check_y in (True, False):
        for wild in (True, False):
            jv = np.asarray(JD.dimensional_violations_batch(
                jb, jnp.asarray(x), jnp.asarray(x_dims), jnp.asarray(y_dims),
                jnp.bool_(check_y), jops, wildcard_constants=wild))
            sv = to_np(SD.dimensional_violations_batch(
                sb, torch.from_numpy(x), torch.from_numpy(x_dims), torch.from_numpy(y_dims),
                check_y, sops, wildcard_constants=wild))
            assert np.array_equal(sv, jv), np.flatnonzero(sv != jv)[:10]
            mixed.append(0 < sv.sum() < sv.size)
    assert any(mixed)


def test_penalized_cost_matches_jax():
    """eval_cost_batch on a dataset with units: cost + 1000 x violations,
    within rtol 1e-5 of the JAX package's (plain and custom penalty)."""
    jops, sops, jb, sb = _trees(3, n=200)
    rng = np.random.default_rng(7)
    X = rng.uniform(0.5, 2.0, (64, 3)).astype(np.float32)
    y = (X[:, 0] / X[:, 1]).astype(np.float32)
    kw = dict(binary_operators=BINARY, unary_operators=UNARY, maxsize=40, save_to_file=False)
    jo, so = J.Options(**kw), S.Options(**kw)
    units = dict(X_units=["m", "s", ""], y_units="m/s")
    jd = j_make(X, y, **units)
    sd = s_make(X, y, device="cpu", **units)
    for penalty, wild in ((1000.0, True), (12.5, False)):
        jc, jl, jx = JS.eval_cost_batch(jb, jd.data, jo.elementwise_loss, j_tables(jo, 3), jops,
                                        0.0032, dim_penalty=penalty, wildcard_constants=wild)
        sc, sl, sx = SS.eval_cost_batch(sb, sd.data, so.elementwise_loss,
                                        s_tables(so, 3, torch.device("cpu")), sops, 0.0032,
                                        dim_penalty=penalty, wildcard_constants=wild)
        assert np.array_equal(to_np(sx), np.asarray(jx))
        assert_close(np.asarray(jc), to_np(sc), 1e-5, "cost")
        assert_close(np.asarray(jl), to_np(sl), 1e-5, "loss")
        nounits = SS.eval_cost_batch(sb, s_make(X, y, device="cpu").data, so.elementwise_loss,
                                     s_tables(so, 3, torch.device("cpu")), sops, 0.0032)[0]
        finite = np.isfinite(to_np(sc))
        assert np.any(to_np(sc)[finite] - to_np(nounits)[finite] == np.float32(penalty))


def test_units_search_on_the_cpu_and_unit_typed_predict():
    """A units search whose truth is dimensionally sound (E = 0.5 m v^2 +
    g m h): its best equation violates nothing, by the port's check and by
    the JAX package's on the same tree; the options lift the refusal; the
    regressor predicts a QuantityArray carrying y_units."""
    rng = np.random.default_rng(0)
    m, v, h = rng.uniform(1, 10, 120), rng.uniform(-5, 5, 120), rng.uniform(0, 10, 120)
    X = np.stack([m, v, h], 1).astype(np.float32)
    y = (0.5 * m * v * v + 9.81 * m * h).astype(np.float32)
    units = dict(X_units=["kg", "m/s", "m"], y_units="J")
    o = S.Options(binary_operators=["+", "-", "*", "/"], unary_operators=["cos"], maxsize=12,
                  populations=3, population_size=24, ncycles_per_iteration=6,
                  tournament_selection_n=6, dimensional_constraint_penalty=1000.0,
                  optimizer_iterations=4, save_to_file=False)
    hof = S.equation_search(X, y, options=o, niterations=2, seed=0, device="cpu", **units)
    best = min(hof.entries, key=lambda e: e.loss)
    sds = s_make(X, y, device="cpu", **units)
    jds = j_make(X, y, **units)
    jo = J.Options(binary_operators=["+", "-", "*", "/"], unary_operators=["cos"])
    assert not SD.violates_dimensional_constraints(best.tree, sds, o)
    for e in hof.entries:
        jt = J.parse_expression(e.equation_string(), jo.operators)
        assert SD.violates_dimensional_constraints(e.tree, sds, o) == \
            JD.violates_dimensional_constraints(jt, jds, jo)
    model = S.SRRegressor(niterations=1, device="cpu", binary_operators=["+", "*"],
                          populations=2, population_size=16, ncycles_per_iteration=4,
                          tournament_selection_n=4, save_to_file=False)
    model.fit(X, y, **units)
    p = model.predict(X, with_units=True)
    assert isinstance(p, SU.QuantityArray) and p.unit == "J" and p.shape == (120,)
    assert not isinstance(model.predict(X), SU.QuantityArray)
