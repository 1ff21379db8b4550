"""Every library elementwise loss of the port against the JAX package's.

The JAX package keeps ``turbo`` on with every elementwise loss and traces
the loss (and its VJP) into its kernels; the port's kernels #1-#3 take the
loss as a kind and a parameter (core/losses.py ``KernelLoss``,
csrc/interp.cuh ``LossSpec``). Here, on the CPU, the port's wrappers run
their plain versions and the JAX package's kernels run in interpret mode,
as its own tests run them. Inputs are made with numpy from a seed. Losses
agree within rtol 1e-5 with inf in the same places; gradients within 1e-4
of the sum of the absolute per-row terms (the rows are summed in another
order); the loss derivatives, at the ties too, within rtol 1e-5 of
``jax.vjp`` of the JAX function.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.core import losses as JL
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu.ops import fused_eval as JF
from symbolicregression_jl_tpu.ops.program import compile_program as j_compile
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.core import losses as SL
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine
from symbolicregression_jl_tpu_torch.ops import fused_eval as SF
from symbolicregression_jl_tpu_torch.ops import vjp as SV
from symbolicregression_jl_tpu_torch.ops.program import compile_program

from symbolicregression_jl_tpu.evolve import constant_opt as JC
from symbolicregression_jl_tpu_torch.evolve import constant_opt as SC

from test_torch_constant_opt import _fixed
from test_torch_fused_eval import _batch, _data, _j, _t, _variants
from torch_parity import (POP_INT_FIELDS, TREE_FIELDS, assert_close, numpy_state, port_key,
                          problem, to_np)

RTOL = 1e-5
GRAD_RTOL = 1e-4
# log-cosh and the logit distance subtract log(2) from a value near it, so
# one float32 ULP of that value (6e-8) is all of a small result: elementwise
# values and derivatives agree within rtol 1e-5 or this much absolute.
ATOL = 1e-6
TWO_PI = 2 * math.pi

# Every loss of the JAX LOSS_REGISTRY, and each factory at two parameters:
# (id, JAX loss, port loss).
CASES = ([(name, JL.LOSS_REGISTRY[name], SL.LOSS_REGISTRY[name]) for name in JL.LOSS_REGISTRY]
         + [("huber(0.5)", JL.huber_loss(0.5), SL.huber_loss(0.5)),
            ("huber(2)", JL.huber_loss(2.0), SL.huber_loss(2.0)),
            ("periodic(2pi)", JL.periodic_l2_loss(TWO_PI), SL.periodic_l2_loss(TWO_PI)),
            ("periodic(1)", JL.periodic_l2_loss(1.0), SL.periodic_l2_loss(1.0)),
            ("sigmoid_ce", JL.sigmoid_cross_entropy_loss, SL.sigmoid_cross_entropy_loss)])
IDS = [c[0] for c in CASES]


def _table_close(want, got, what):
    """NaN and +-inf in the same places; finite values within RTOL or ATOL."""
    want, got = np.asarray(want), np.asarray(got)
    assert np.array_equal(np.isnan(want), np.isnan(got)), what
    assert np.array_equal(np.isinf(want), np.isinf(got)), what
    assert np.array_equal(want[np.isinf(want)], got[np.isinf(got)]), what
    f = np.isfinite(want)
    np.testing.assert_allclose(got[f], want[f], rtol=RTOL, atol=ATOL, err_msg=what)


def test_registry_names_and_kinds():
    """The registries hold the same names; each port loss names a kernel
    kind, and a factory called twice gives equal losses."""
    assert set(SL.LOSS_REGISTRY) == set(JL.LOSS_REGISTRY)
    for name, fn in SL.LOSS_REGISTRY.items():
        assert SL.kernel_loss(fn) is fn, name
    assert SL.huber_loss(2.0) == SL.huber_loss(2.0) != SL.huber_loss(1.0)
    assert SL.periodic_l2_loss() == SL.periodic_l2_loss(TWO_PI)
    assert SL.resolve_loss("HuberLoss()") == SL.huber_loss(1.0)
    assert SL.kernel_loss(lambda p, t: p - t) is None


def _ties(case: str):
    """(pred, target) grids with the ties of each loss: d = 0, pred = 0
    (sigmoid's maximum), |d| = delta (Huber), the periodic wrap point
    d = c / 2 + k c, and large, tiny and non-finite values."""
    edges = np.array([-100, -10, -3, -2, -1, -0.5, -1e-30, -0.0, 0.0, 1e-30, 0.3, 0.5, 1, 2,
                      2.5, 3, 10, 88, 100, np.inf, -np.inf, np.nan], np.float32)
    p, t = np.meshgrid(edges, np.array([-2, -1, 0, 0.5, 1, 3], np.float32), indexing="ij")
    extra = []
    for delta in (0.5, 1.0, 2.0):
        extra += [(delta, 0.0), (-delta, 0.0), (1.0 + delta, 1.0), (1.0 - delta, 1.0)]
    for c in (TWO_PI, 1.0):
        for k in (-1, 0, 1):
            extra += [(np.float32(c / 2 + k * c), 0.0), (np.float32(-c / 2 + k * c), 0.0)]
    ep = np.array([e[0] for e in extra], np.float32)
    et = np.array([e[1] for e in extra], np.float32)
    return (np.concatenate([p.ravel(), ep]), np.concatenate([t.ravel(), et]))


@pytest.mark.parametrize("case", IDS)
def test_loss_values_match_jax(case):
    """The elementwise values, formula for formula: within rtol 1e-5 (or
    ATOL), NaN and +-inf in the same places."""
    _, jf, sf = CASES[IDS.index(case)]
    p, t = _ties(case)
    want = to_np(jf(jnp.asarray(p), jnp.asarray(t)))
    got = to_np(sf(_t(p), _t(t)))
    _table_close(want, got, case)


@pytest.mark.parametrize("case", IDS)
def test_loss_vjp_matches_jax(case):
    """The loss derivative (the kernels' seed cotangent) against jax.vjp of
    the JAX function, ties included, cotangents 1, 0 (a weight-0 row) and
    -2.5: NaN and +-inf in the same places, finite values within rtol 1e-5
    (or ATOL)."""
    _, jf, sf = CASES[IDS.index(case)]
    p, t = _ties(case)
    for ct in (1.0, 0.0, -2.5):
        c = np.full_like(p, ct)
        (want,) = jax.vjp(lambda q: jf(q, jnp.asarray(t)), jnp.asarray(p))[1](jnp.asarray(c))
        got = SV.loss_vjp(sf)(_t(p), _t(t), _t(c))
        _table_close(to_np(want), to_np(got), f"{case} ct={ct}")


def _exact_trees(st, sops) -> np.ndarray:
    """[T] bool: no live node applies cos or exp, whose float32 values the
    two packages' math libraries may round an ULP apart."""
    names = [op.name for op in sops.unary]
    bad = [names.index(n) for n in ("cos", "exp") if n in names]
    live = np.arange(st.max_nodes)[None, :] < to_np(st.length)[:, None]
    un = (to_np(st.arity) == 1) & np.isin(to_np(st.op), bad) & live
    return ~un.any(axis=1)


@pytest.mark.parametrize("case", IDS)
def test_fused_loss_and_cost_match_jax(case):
    """fused_loss (plain and dedup) and fused_cost (the cost epilogue) on
    random and hand-written trees, weighted rows with zeros: validity
    bit-equal, loss and cost within rtol 1e-5 with inf in the same places.
    The periodic L2 is discontinuous at its wrap point, where an ULP of the
    prediction moves a row's loss by up to c^2 / 4, so its losses compare
    on the trees whose predictions both packages compute bit for bit
    (no cos or exp)."""
    _, jf, sf = CASES[IDS.index(case)]
    jops, sops, jt, st = _batch("merged", 3, T=24)
    X, y, w = _data(97, True, 3)
    keep = _exact_trees(st, sops) if case.startswith("periodic") else np.ones(
        st.length.shape[0], bool)
    assert keep.sum() >= 8
    jl, jv = JF.fused_loss(jt, _j(X), _j(y), _j(w), jops, jf, interpret=True)
    sl, sv = SF.fused_loss(st, _t(X), _t(y), _t(w), sops, sf)
    assert np.array_equal(to_np(jv), to_np(sv))
    assert_close(to_np(jl)[keep], to_np(sl)[keep], RTOL, "loss")
    dl, dv = SF.fused_loss(st, _t(X), _t(y), _t(w), sops, sf, dedup=True)
    assert torch.equal(dl, sl) and torch.equal(dv, sv)
    cx = np.random.default_rng(3).integers(1, 10, jt.length.shape[0]).astype(np.int32)
    kw = dict(baseline_loss=1.7, use_baseline=True, parsimony=0.01)
    jc, jl2, jv2 = JF.fused_cost(jt, _j(X), _j(y), _j(w), _j(cx), jops, jf, interpret=True,
                                 baseline_loss=jnp.float32(1.7), use_baseline=jnp.bool_(True),
                                 parsimony=0.01)
    sc, sl2, sv2 = SF.fused_cost(st, _t(X), _t(y), _t(w), _t(cx), sops, sf,
                                 baseline_loss=torch.tensor(kw["baseline_loss"]),
                                 use_baseline=torch.tensor(True), parsimony=kw["parsimony"])
    assert np.array_equal(to_np(jv2), to_np(sv2))
    assert_close(to_np(jl2)[keep], to_np(sl2)[keep], RTOL, "cost-form loss")
    assert_close(to_np(jc)[keep], to_np(sc)[keep], RTOL, "cost")


@pytest.mark.parametrize("case", IDS)
def test_fused_multi_and_grad_match_jax(case):
    """Kernels #2 and #3 (plain versions) against the JAX package's
    interpret-mode kernels with this loss: validity bit-equal, losses
    within rtol 1e-5 with inf in the same places, #3's loss bit-equal to
    #2's, gradients zeroed in the same places and otherwise within 1e-4 of
    the sum of the absolute per-row terms."""
    _, jf, sf = CASES[IDS.index(case)]
    jops, sops, jt, st = _batch("merged", 4, T=12)
    X, y, w = _data(64, True, 4)
    jp = j_compile(jt, 3, len(jops.binary))
    sp = compile_program(st, 3, len(sops.binary))
    cv = _variants(jp, 3, 4)
    args_j = (jp, _j(cv), _j(X), _j(y), _j(w), 3, jops, jf)
    args_s = (sp, _t(cv), _t(X), _t(y), _t(w), 3, sops, sf)
    jl, jv = JF.fused_loss_multi(*args_j, interpret=True)
    sl, sv = SF.fused_loss_multi(*args_s)
    assert np.array_equal(to_np(jv), to_np(sv))
    assert_close(to_np(jl), to_np(sl), RTOL, "loss")
    jgl, jgv, jg = JF.fused_grad_multi(*args_j, interpret=True)
    sgl, sgv, sg = SF.fused_grad_multi(*args_s)
    assert np.array_equal(to_np(jgv), to_np(sgv))
    assert_close(to_np(jgl), to_np(sgl), RTOL, "grad-kernel loss")
    assert np.array_equal(to_np(sgl).view(np.int32), to_np(sl).view(np.int32))
    instr = SF._pack_instr(sp, sops, 3 + sp.cmax + sp.max_steps)
    *_, gabs = SF.program_grad_plain(instr, sp.nsteps, sp.nconst, _t(cv), _t(X), _t(y), _t(w),
                                     sops, sf, return_abs=True)
    scale = to_np(gabs) / float(w.sum())
    jg, sg = to_np(jg), to_np(sg)
    assert np.array_equal(jg == 0, sg == 0), case
    live = jg != 0
    assert np.all(np.abs(jg - sg)[live] <= GRAD_RTOL * scale[live] + 1e-30), case


# Seeds where the two packages agree. With seed 0 they part at a near-tie:
# log-cosh's log1p and exp round an ULP apart in the two math libraries, so
# one member's cost is 1.2442228 in the JAX package and 1.2442225 here, and a
# comparison of two candidates goes the other way (with and without
# annealing; L2 on the same seed agrees, its rows have no transcendental).
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_run_iteration_logcosh_turbo_equal(seed):
    """One Engine.run_iteration with elementwise_loss="logcosh" and turbo
    on (the port's kernel wrappers on their plain versions, the JAX
    package's kernels in interpret mode), from the same state and key:
    integer member fields equal, constants, costs and losses within rtol
    1e-5, the hall of fame and the counters equal. The constant optimizer
    is off here: L-BFGS carries the ULP differences of two row-sum orders
    into the constants (tests/test_torch_constant_opt.py), and its logcosh
    run is held against the JAX package's below."""
    X, y = problem(seed)
    kw = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"], maxsize=15,
              populations=2, population_size=16, ncycles_per_iteration=2,
              tournament_selection_n=8, turbo=True, elementwise_loss="logcosh",
              should_optimize_constants=False, save_to_file=False)
    jo, so = J.Options(eval_tree_block=1, **kw), S.Options(**kw)
    jds = J.make_dataset(X, y)
    jds.update_baseline_loss(jo.elementwise_loss)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    je, se = JEngine(jo, 3), SEngine(so, 3, device="cpu")
    assert je.cfg.turbo and se.cfg.turbo
    js = je.init_state(jax.random.key(seed), jds.data, 2)
    ss = interop.search_state(numpy_state(js), device="cpu")
    js2 = je.run_iteration(js, jds.data, 15)
    ss2 = se.run_iteration(ss, sd, 15)
    for f in TREE_FIELDS:
        assert np.array_equal(to_np(getattr(js2.pops.trees, f)),
                              to_np(getattr(ss2.pops.trees, f))), f
    for f in POP_INT_FIELDS:
        assert np.array_equal(to_np(getattr(js2.pops, f)), to_np(getattr(ss2.pops, f))), f
    assert_close(to_np(js2.pops.trees.const), to_np(ss2.pops.trees.const), RTOL, "const")
    assert_close(to_np(js2.pops.cost), to_np(ss2.pops.cost), RTOL, "cost")
    assert_close(to_np(js2.pops.loss), to_np(ss2.pops.loss), RTOL, "loss")
    ex = to_np(js2.hof.exists)
    assert np.array_equal(ex, to_np(ss2.hof.exists))
    assert_close(to_np(js2.hof.cost)[ex], to_np(ss2.hof.cost)[ex], RTOL, "hof cost")
    assert float(js2.num_evals) == float(ss2.num_evals)


def test_optimize_constants_fused_logcosh_matches_jax():
    """The fused L-BFGS (kernels #2 and #3 on their plain versions, the
    JAX package's in interpret mode) with logcosh on identifiable trees:
    as tests/test_torch_constant_opt.py holds it with L2."""
    jops, sops, jt, st, jds, sd, do_opt = _fixed()
    key = jax.random.key(3)
    jr = JC.optimize_constants_fused(key, jt, jnp.asarray(do_opt), jds.data,
                                     JL.LOSS_REGISTRY["logcosh"], jops, JC.OptimizerConfig(),
                                     interpret=True)
    sr = SC.optimize_constants_fused(port_key(key), st, torch.from_numpy(do_opt), sd,
                                     SL.LOSS_REGISTRY["logcosh"], sops, SC.OptimizerConfig())
    jc, ji, jl, jf = (to_np(a) for a in jr)
    sc, si, sl, sf = (to_np(a) for a in sr)
    assert np.array_equal(jf, sf) and np.array_equal(ji, si)
    assert ji[[0, 2, 3, 4]].all() and not ji[1]
    assert np.array_equal(np.isfinite(jl), np.isfinite(sl))
    # The exact fit's loss is round-off: each row's log-cosh of a residual
    # near 0 subtracts log(2) from a value near it (ATOL); constants within
    # rtol 1e-3, as tests/test_torch_constant_opt.py holds L2's.
    np.testing.assert_allclose(sl, jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sc, jc, rtol=1e-3, atol=1e-6)


_USER_LOSS = dict(elementwise_loss=lambda p, t: (p - t) ** 4)
_USER_OP = dict(unary_operators=[S.Op("twice", 1, lambda x: 2 * x)])


@pytest.mark.parametrize("kw", [_USER_LOSS, _USER_OP], ids=["user_loss", "user_op"])
def test_turbo_refuses_user_callables_up_front(kw):
    """A user elementwise callable runs with turbo on: the engine keeps
    turbo and drops the cost epilogue (the callable takes kernel #4's
    user-loss route, tests/test_torch_user_loss.py). A traceable user
    operator, once refused, runs with turbo on too (ops/user_ops.py); an
    untraceable one is refused when the engine (or the search) is built,
    naming its function and turbo=False. With turbo=False, and with
    turbo=None on the CPU, both run on the eager path."""
    base = dict(binary_operators=["+", "*"], maxsize=10, populations=2, population_size=16,
                ncycles_per_iteration=2, tournament_selection_n=8, save_to_file=False)
    base.update(kw)
    X, y = problem(0, n=64)
    if kw is _USER_LOSS:
        engine = SEngine(S.Options(turbo=True, **base), 3, device="cpu")
        assert engine.cfg.turbo and not engine.cfg.fuse_cost
        hof = S.equation_search(X, y, options=S.Options(turbo=True, **base), niterations=1,
                                seed=0, device="cpu")
        assert any(np.isfinite(e.loss) for e in hof.entries)
    else:
        engine = SEngine(S.Options(turbo=True, **base), 3, device="cpu")
        assert engine.cfg.turbo and engine.cfg.fuse_cost
        hof = S.equation_search(X, y, options=S.Options(turbo=True, **base), niterations=1,
                                seed=0, device="cpu")
        assert any(np.isfinite(e.loss) for e in hof.entries)
        bad = dict(base, unary_operators=[S.Op("sh", 1, lambda x: torch.sinh(x))])
        with pytest.raises(NotImplementedError, match="torch.sinh.*turbo=False"):
            SEngine(S.Options(turbo=True, **bad), 3, device="cpu")
        with pytest.raises(NotImplementedError, match="torch.sinh"):
            S.equation_search(X, y, options=S.Options(turbo=True, **bad), niterations=1,
                              device="cpu")
    for turbo in (False, None):
        hof = S.equation_search(X, y, options=S.Options(turbo=turbo, **base), niterations=1,
                                seed=0, device="cpu")
        assert any(np.isfinite(e.loss) for e in hof.entries)
