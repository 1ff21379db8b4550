"""The PyTorch port's host and eager modules against the JAX package.

Operators, parse/print/encode, program compilation and packing,
complexity and constraints, the eager interpreter, options, losses and
the dataset. Inputs come from numpy with a seed and go through both
packages on the CPU.
"""

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
from symbolicregression_jl_tpu.ops import complexity as JC
from symbolicregression_jl_tpu.ops import encoding as JE
from symbolicregression_jl_tpu.ops import eval as JV
from symbolicregression_jl_tpu.ops import fused_eval as JF
from symbolicregression_jl_tpu.ops import program as JP
from symbolicregression_jl_tpu.ops import tree as JT
from symbolicregression_jl_tpu.ops.operators import OPERATOR_REGISTRY as J_OPS
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.core import losses as SL
from symbolicregression_jl_tpu_torch.ops import complexity as SC
from symbolicregression_jl_tpu_torch.ops import encoding as SE
from symbolicregression_jl_tpu_torch.ops import eval as SV
from symbolicregression_jl_tpu_torch.ops import fused_eval as SF
from symbolicregression_jl_tpu_torch.ops import program as SP
from symbolicregression_jl_tpu_torch.ops import tree as ST
from symbolicregression_jl_tpu_torch.ops.operators import OPERATOR_REGISTRY as S_OPS

from torch_parity import assert_close, to_np

MAXSIZE = 15
BINARY = ["+", "-", "*", "/"]
UNARY = ["cos", "exp", "abs", "log"]
F32_TINY = np.finfo(np.float32).tiny

_SPECIAL = np.array(
    [0.0, -0.0, 1, -1, 2, -2, 0.5, -0.5, 3, -3, 1e-30, -1e-30, 1e30, -1e30, np.inf,
     -np.inf, np.nan, 88.7, 89.0, -88.0, 0.999, -0.999, 1.001, -1.001, 2.5, -2.5, 170.0,
     -170.5, 1e-3, 7.0], np.float32)


def _operands(arity: int):
    rng = np.random.default_rng(arity)
    if arity == 1:
        return (np.concatenate([_SPECIAL, rng.normal(0, 3, 400).astype(np.float32),
                                rng.uniform(-1.2, 1.2, 200).astype(np.float32)]),)
    b = np.concatenate([_SPECIAL, rng.normal(0, 3, 20).astype(np.float32)])
    A, B = np.meshgrid(_SPECIAL, b)
    return A.ravel(), B.ravel()


def _ordered(v: np.ndarray) -> np.ndarray:
    """float32 bits mapped to integers that order like the floats."""
    i = v.astype(np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def _flush(v: np.ndarray) -> np.ndarray:
    """XLA's CPU backend flushes subnormal results to zero."""
    return np.where(np.abs(v) < F32_TINY, np.float32(0), v).astype(np.float32)


@pytest.mark.parametrize("name", sorted(J_OPS))
def test_operator_matches_jax(name):
    """Each built-in operator: NaN and inf in the same places as the JAX
    package's; finite values within 1 ULP of it, or at least as close
    as it to the float64 value where XLA's CPU approximation is off."""
    assert name in S_OPS
    args = _operands(J_OPS[name].arity)
    got_j = _flush(np.asarray(J_OPS[name].fn(*[jnp.asarray(a) for a in args])))
    got_s = _flush(S_OPS[name].fn(*[torch.from_numpy(a.copy()) for a in args]).numpy())
    truth = S_OPS[name].fn(*[torch.from_numpy(a.astype(np.float64)) for a in args]).numpy()
    assert np.array_equal(np.isnan(got_j), np.isnan(got_s)), "NaN domains differ"
    assert np.array_equal(np.isinf(got_j), np.isinf(got_s)), "overflow differs"
    fin = np.isfinite(got_j)
    ulp = np.abs(_ordered(got_j[fin]) - _ordered(got_s[fin]))
    err_s = np.abs(got_s[fin].astype(np.float64) - truth[fin])
    err_j = np.abs(got_j[fin].astype(np.float64) - truth[fin])
    ok = (ulp <= 1) | (err_s <= err_j)
    assert ok.all(), [(a[fin][~ok][:3]) for a in args]


EXPRS = [
    "cos(2.13 * x1) + 0.5 * x2",
    "x1 * x2 - exp(x3 / 2.0)",
    "abs(x3) / (x1 - x1)",
    "log(abs(x2) + 1.0e-3) * -1.5",
    "1.5",
    "x2",
    "((x1 + x2) * (x3 - 0.25)) / cos(x1)",
]


@pytest.fixture(scope="module")
def opsets():
    return (J.OperatorSet(BINARY, UNARY), S.OperatorSet(BINARY, UNARY))


def test_parse_print_encode_equal(opsets):
    jops, sops = opsets
    names = ["x1", "x2", "x3"]
    jt = [J.parse_expression(e, jops, names) for e in EXPRS]
    st = [S.parse_expression(e, sops, names) for e in EXPRS]
    for a, b in zip(jt, st):
        assert JT.string_tree(a, names) == ST.string_tree(b, names)
    jb = JE.encode_population(jt, MAXSIZE, jops)
    sb = SE.encode_population(st, MAXSIZE, sops)
    for f in ("arity", "op", "feat", "length"):
        assert np.array_equal(to_np(getattr(jb, f)), to_np(getattr(sb, f))), f
    assert np.array_equal(to_np(jb.const).view(np.int32), to_np(sb.const).view(np.int32))
    for i in range(len(EXPRS)):
        dj = JE.decode_tree(*(np.asarray(getattr(jb, f))[i] for f in
                              ("arity", "op", "feat", "const", "length")), jops)
        ds = SE.decode_tree(*(getattr(sb, f)[i] for f in
                              ("arity", "op", "feat", "const", "length")), sops)
        assert JT.string_tree(dj) == ST.string_tree(ds)


def _random_trees(seed: int, binary, unary, n: int = 64, nfeatures: int = 3):
    opts = J.Options(binary_operators=binary, unary_operators=unary, maxsize=MAXSIZE,
                     save_to_file=False)
    cfg = j_cfg(opts, nfeatures)
    jt = j_init_population(jax.random.key(seed), n, cfg.mctx, jnp.float32, nlength=6)
    return opts, cfg, jt, interop.tree_batch(jax.tree.map(np.asarray, jt))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("binary,unary", [(BINARY, UNARY), (["*", "/", "-"], ["sin"]),
                                          (["+", "*"], ["cos", "sqrt"])])
def test_program_and_packed_words_equal(seed, binary, unary):
    """compile_program fields and `_pack_instr` words integer-equal, for
    the merged add/sub layout, the legacy layout (no '+') and '+'
    without '-'."""
    opts, cfg, jt, st = _random_trees(seed, binary, unary)
    F, B = 3, len(binary)
    jp = JP.compile_program(jt, F, B)
    sp = SP.compile_program(st, F, B)
    for f in ("code", "src1", "src2", "nsteps", "cslot", "nconst", "const_ok"):
        assert np.array_equal(to_np(getattr(jp, f)), to_np(getattr(sp, f))), f
    assert np.array_equal(to_np(jp.cvals).view(np.int32), to_np(sp.cvals).view(np.int32))
    assert tuple(JF._dispatch_plan(cfg.operators)) == tuple(SF._dispatch_plan(
        S.OperatorSet(binary, unary)))
    zero = F + jp.cmax + jp.max_steps
    jw = JF._pack_instr(jp, cfg.operators, zero)
    sw = SF._pack_instr(sp, S.OperatorSet(binary, unary), zero)
    assert np.array_equal(to_np(jw), to_np(sw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_complexity_and_constraints_equal(seed):
    kw = dict(binary_operators=BINARY, unary_operators=UNARY, maxsize=MAXSIZE,
              constraints={"/": (-1, 5), "cos": 4},
              nested_constraints={"cos": {"cos": 0}, "exp": {"exp": 0, "log": 1}},
              complexity_of_operators={"exp": 2}, complexity_of_constants=2,
              save_to_file=False)
    jo, so = J.Options(**kw), S.Options(**kw)
    _, _, jt, st = _random_trees(seed, BINARY, UNARY)
    jtab = JC.build_complexity_tables(jo, 3)
    stab = SC.build_complexity_tables(so, 3, torch.device("cpu"))
    assert np.array_equal(to_np(JC.compute_complexity_batch(jt, jtab)),
                          to_np(SC.compute_complexity_batch(st, stab)))
    for cur in (5, 10, MAXSIZE):
        assert np.array_equal(to_np(JC.check_constraints_batch(jt, jo, jtab, cur)),
                              to_np(SC.check_constraints_batch(st, so, stab, cur)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [257, 300])
def test_eval_tree_batch_matches(seed, n):
    """The eager interpreter: validity bit-equal, and predictions within
    rtol 1e-6 of the JAX package's on at least 99% of valid rows. (The
    two CPU backends' exp and log differ by an ULP, and XLA may fuse a
    multiply-add; deep random trees amplify that through cancellation on
    the remaining rows, where neither package is consistently the closer
    one to a float64 evaluation.)"""
    opts, cfg, jt, st = _random_trees(seed, BINARY, UNARY)
    X = np.random.default_rng(seed).uniform(-3, 3, (3, n)).astype(np.float32)
    jpred, jvalid = JV.eval_tree_batch(jt, jnp.asarray(X), cfg.operators)
    spred, svalid = SV.eval_tree_batch(st, torch.from_numpy(X), S.OperatorSet(BINARY, UNARY))
    assert np.array_equal(to_np(jvalid), to_np(svalid))
    v = to_np(jvalid)
    a, b = to_np(jpred)[v], to_np(spred)[v]
    assert np.isfinite(a).all() and np.isfinite(b).all()
    near = np.abs(a - b) <= 1e-6 * np.abs(a)
    assert near.mean() >= 0.99, near.mean()


def test_options_defaults_and_validation():
    jo, so = J.Options(should_optimize_constants=False), S.Options(should_optimize_constants=False)
    for f in ("maxsize", "maxdepth", "populations", "population_size", "ncycles_per_iteration",
              "tournament_selection_n", "tournament_selection_p", "parsimony", "alpha",
              "crossover_probability", "annealing", "fraction_replaced",
              "fraction_replaced_hof", "topn", "mutation_attempts", "perturbation_factor",
              "probability_negate_constant", "adaptive_parsimony_scaling",
              "warmup_maxsize_by", "use_frequency", "use_frequency_in_tournament",
              "skip_mutation_failures", "should_simplify", "migration", "hof_migration"):
        assert getattr(jo, f) == getattr(so, f), f
    assert tuple(jo.mutation_weights.as_vector()) == tuple(so.mutation_weights.as_vector())
    assert [o.name for o in jo.operators.binary] == [o.name for o in so.operators.binary]
    for bad in (dict(maxsize=3), dict(warmup_maxsize_by=-1.0),
                dict(population_size=10, tournament_selection_n=10),
                dict(loss_scale="cubic"), dict(eval_precision="f16"),
                dict(constraints={"nope": 1})):
        with pytest.raises(ValueError) as ej:
            J.Options(**bad)
        with pytest.raises(ValueError) as es:
            S.Options(**bad)
        assert str(ej.value) == str(es.value)


@pytest.mark.parametrize("loss", ["L2DistLoss", "L1DistLoss", "HuberLoss"])
def test_losses_and_cost_equal(loss):
    rng = np.random.default_rng(7)
    pred = rng.normal(size=(6, 257)).astype(np.float32)
    pred[2, 5] = np.nan
    y = rng.normal(size=257).astype(np.float32)
    w = rng.uniform(0, 2, 257).astype(np.float32)
    w[:20] = 0.0
    valid = np.isfinite(pred).all(-1)
    jf, sf = JL.LOSS_REGISTRY[loss], SL.LOSS_REGISTRY[loss]
    for weights in (None, w):
        jl = JL.aggregate_loss(jf, jnp.asarray(pred), jnp.asarray(y), jnp.asarray(valid),
                               None if weights is None else jnp.asarray(weights))
        sl = SL.aggregate_loss(sf, torch.from_numpy(pred), torch.from_numpy(y),
                               torch.from_numpy(valid),
                               None if weights is None else torch.from_numpy(weights))
        assert_close(to_np(jl), to_np(sl), 1e-6, "loss")
        cx = np.arange(1, 7, dtype=np.int32)
        for base, use in ((2.5, True), (1.0, False)):
            jc = JL.loss_to_cost(jl, jnp.float32(base), jnp.asarray(use), jnp.asarray(cx), 0.01)
            sc = SL.loss_to_cost(sl, torch.tensor(base), torch.tensor(use),
                                 torch.from_numpy(cx), 0.01)
            assert_close(to_np(jc), to_np(sc), 1e-6, "cost")


@pytest.mark.parametrize("weighted", [False, True])
def test_dataset_and_baseline_equal(weighted):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(257, 3)).astype(np.float32)
    y = rng.normal(size=257).astype(np.float32)
    w = rng.uniform(0.5, 2, 257).astype(np.float32) if weighted else None
    jd = J.make_dataset(X, y, weights=w)
    sd = S.make_dataset(X, y, weights=w, device="cpu")
    jd.update_baseline_loss(JL.l2_dist_loss)
    sd.update_baseline_loss(SL.l2_dist_loss)
    assert np.array_equal(np.asarray(jd.data.Xt), to_np(sd.data.Xt))
    assert np.isclose(jd.avg_y, sd.avg_y, rtol=1e-6)
    assert list(jd.display_variable_names) == list(sd.display_variable_names)
    assert_close(np.asarray(jd.data.baseline_loss), to_np(sd.data.baseline_loss), 1e-6)
    assert bool(jd.data.use_baseline) == bool(sd.data.use_baseline)
