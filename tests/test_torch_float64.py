"""float64 in the port against the JAX package under x64.

``eval_dtype="float64"`` (or ``equation_search(dtype=np.float64)``) runs
the search in double: the data, the constants, the costs, the hall of
fame, the bulk uniforms the evolution draws (64 random bits each, as
``jax.random.uniform`` draws its default dtype under x64), and kernels
#1, #1p, #2 and #3 in their float64 forms (here, on the CPU, their plain
versions). The JAX side runs inside the ``jax.enable_x64(True)`` context
manager, never the global flag: pytest-xdist runs many files in one
worker. Losses agree within rtol 1e-9; the float64 uniforms bit for bit.
The JAX engine's ``run_iteration`` fails under x64 (its scan carries int32
tree fields that come back int64; ROADMAP.md queue 3), so the port's
float64 iteration is held against a float64 numpy evaluation of every
member instead.
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
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu.ops import fused_eval as JF
from symbolicregression_jl_tpu.ops.eval import eval_tree_batch as j_eval
from symbolicregression_jl_tpu.ops.program import compile_program as j_compile
from symbolicregression_jl_tpu_torch.core import losses as SL
from symbolicregression_jl_tpu_torch.evolve import rng as SR
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine
from symbolicregression_jl_tpu_torch.ops import fused_eval as SF
from symbolicregression_jl_tpu_torch.ops.encoding import decode_population
from symbolicregression_jl_tpu_torch.ops.eval import eval_tree_batch as s_eval
from symbolicregression_jl_tpu_torch.ops.program import compile_program

from test_torch_fused_eval import _batch, _data
from torch_parity import TREE_FIELDS, assert_close, problem, to_np

RTOL64 = 1e-9
MAXSIZE = 15


def _x64():
    return jax.enable_x64(True)


def _t64(a):
    return None if a is None else torch.from_numpy(np.asarray(a, np.float64).copy())


def _j64(a):
    return None if a is None else jnp.asarray(a, jnp.float64)


def _trees64(jt, st):
    """The same trees with float64 constants in both packages."""
    return (dataclasses.replace(jt, const=jnp.asarray(np.asarray(jt.const), jnp.float64)),
            dataclasses.replace(st, const=st.const.double()))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_float64_draws_match_jax(seed):
    """uniform: bit-equal (64 random bits per value); bernoulli and
    categorical (Gumbel in the logits' float64): equal; normal (its
    erf_inv is torch's, not XLA's polynomial): within rtol 1e-13; ndtri
    (the evolution's u_normal) within 1e-14 absolute."""
    from symbolicregression_jl_tpu.evolve import rng as JR

    with _x64():
        k = jax.random.key(seed)
        ju = to_np(jax.random.uniform(k, (5000,)))
        assert ju.dtype == np.float64
        pu = to_np(SR.uniform(SR.key(seed), (5000,), dtype=torch.float64))
        assert np.array_equal(ju.view(np.int64), pu.view(np.int64))
        keys = jax.random.split(k, 3)
        jb = to_np(jax.vmap(lambda kk: jax.random.uniform(kk, (7,)))(keys))
        pb = to_np(SR.uniform(SR.split(SR.key(seed), 3), (7,), dtype=torch.float64))
        assert np.array_equal(jb.view(np.int64), pb.view(np.int64))
        assert np.array_equal(to_np(jax.random.bernoulli(k, 0.3, (4000,))),
                              to_np(SR.bernoulli(SR.key(seed), 0.3, (4000,), torch.float64)))
        logits = np.log(np.linspace(0.1, 1.0, 7))
        assert np.array_equal(to_np(jax.random.categorical(k, jnp.asarray(logits), shape=(300,))),
                              to_np(SR.categorical(SR.key(seed), torch.from_numpy(logits),
                                                   shape=(300,))))
        jn = to_np(jax.random.normal(k, (4000,)))
        pn = to_np(SR.normal(SR.key(seed), (4000,), torch.float64))
        np.testing.assert_allclose(pn, jn, rtol=1e-13, atol=0)
        jq = to_np(JR.u_normal(jnp.asarray(ju)))
        pq = to_np(SR.u_normal(torch.from_numpy(ju.copy())))
        np.testing.assert_allclose(pq, jq, rtol=0, atol=1e-14)


@pytest.mark.parametrize("layout", ["merged", "legacy"])
def test_eval_tree_batch_float64_matches_jax(layout):
    """The eager interpreter on float64 X and constants: validity equal,
    predictions within rtol 1e-9 with NaN and +-inf in the same places."""
    jops, sops, jt, st = _batch(layout, 5, T=24)
    X, _, _ = _data(64, False, 5)
    with _x64():
        jt64, st64 = _trees64(jt, st)
        jp, jv = j_eval(jt64, _j64(X), jops)
        assert jp.dtype == jnp.float64
    sp, sv = s_eval(st64, _t64(X), sops)
    assert sp.dtype == torch.float64
    assert np.array_equal(to_np(jv), to_np(sv))
    v = to_np(jv)
    assert_close(to_np(jp)[v], to_np(sp)[v], RTOL64, "pred")


LOSSES = [("l2", JL.l2_dist_loss, SL.l2_dist_loss),
          ("logcosh", JL.LOSS_REGISTRY["logcosh"], SL.LOSS_REGISTRY["logcosh"]),
          ("huber(2)", JL.huber_loss(2.0), SL.huber_loss(2.0))]


@pytest.mark.parametrize("loss", [c[0] for c in LOSSES])
def test_fused_ops_float64_match_jax(loss):
    """fused_loss, fused_cost, fused_loss_multi and fused_grad_multi in
    float64 (the port's f64 wrappers on their plain versions, the JAX
    package's kernels in interpret mode under x64): float64 outputs,
    validity bit-equal, losses and costs within rtol 1e-9 with inf in the
    same places, gradients zeroed in the same places and otherwise within
    1e-9 of the sum of the absolute per-row terms."""
    _, jf, sf = next(c for c in LOSSES if c[0] == loss)
    jops, sops, jt, st = _batch("merged", 6, T=16)
    X, y, w = _data(80, True, 6)
    cx = np.random.default_rng(6).integers(1, 10, jt.length.shape[0]).astype(np.int32)
    with _x64():
        jt64, st64 = _trees64(jt, st)
        jl, jv = JF.fused_loss(jt64, _j64(X), _j64(y), _j64(w), jops, jf, interpret=True)
        jc, jl2, jv2 = JF.fused_cost(jt64, _j64(X), _j64(y), _j64(w), jnp.asarray(cx), jops, jf,
                                     interpret=True, baseline_loss=jnp.float64(1.7),
                                     use_baseline=jnp.bool_(True), parsimony=0.01)
        jp = j_compile(jt64, 3, len(jops.binary))
        rng = np.random.default_rng(7)
        cv = np.asarray(jp.cvals)[:, None, :] * (
            1 + 0.3 * rng.normal(size=(jp.cvals.shape[0], 3, jp.cmax)))
        jml, jmv = JF.fused_loss_multi(jp, _j64(cv), _j64(X), _j64(y), _j64(w), 3, jops, jf,
                                       interpret=True)
        jgl, jgv, jg = JF.fused_grad_multi(jp, _j64(cv), _j64(X), _j64(y), _j64(w), 3, jops, jf,
                                           interpret=True)
        assert jl.dtype == jc.dtype == jml.dtype == jg.dtype == jnp.float64
    sl, sv = SF.fused_loss(st64, _t64(X), _t64(y), _t64(w), sops, sf)
    sc, sl2, sv2 = SF.fused_cost(st64, _t64(X), _t64(y), _t64(w), torch.from_numpy(cx), sops, sf,
                                 baseline_loss=torch.tensor(1.7, dtype=torch.float64),
                                 use_baseline=torch.tensor(True), parsimony=0.01)
    assert sl.dtype == sc.dtype == torch.float64
    assert np.array_equal(to_np(jv), to_np(sv)) and np.array_equal(to_np(jv2), to_np(sv2))
    assert_close(to_np(jl), to_np(sl), RTOL64, "loss")
    assert_close(to_np(jl2), to_np(sl2), RTOL64, "cost-form loss")
    assert_close(to_np(jc), to_np(sc), RTOL64, "cost")
    sp = compile_program(st64, 3, len(sops.binary))
    sml, smv = SF.fused_loss_multi(sp, _t64(cv), _t64(X), _t64(y), _t64(w), 3, sops, sf)
    sgl, sgv, sg = SF.fused_grad_multi(sp, _t64(cv), _t64(X), _t64(y), _t64(w), 3, sops, sf)
    assert sml.dtype == sg.dtype == torch.float64
    assert np.array_equal(to_np(jmv), to_np(smv)) and np.array_equal(to_np(jgv), to_np(sgv))
    assert_close(to_np(jml), to_np(sml), RTOL64, "multi loss")
    assert_close(to_np(jgl), to_np(sgl), RTOL64, "grad-kernel loss")
    instr = SF._pack_instr(sp, sops, 3 + sp.cmax + sp.max_steps)
    *_, gabs = SF.program_grad_plain(instr, sp.nsteps, sp.nconst, _t64(cv), _t64(X), _t64(y),
                                     _t64(w), sops, sf, return_abs=True)
    scale = to_np(gabs) / float(w.sum())
    jg, sg = to_np(jg), to_np(sg)
    assert np.array_equal(jg == 0, sg == 0)
    live = jg != 0
    assert np.all(np.abs(jg - sg)[live] <= RTOL64 * scale[live] + 1e-300)


def test_f64_wrappers_run_their_plain_versions_on_cpu():
    """The float64 kernels' wrappers, given CPU tensors, run the plain
    versions (no launch counted) and keep float64."""
    _, sops, _, st = _batch("merged", 8, T=8)
    X, y, _ = _data(32, False, 8)
    sp = compile_program(dataclasses.replace(st, const=st.const.double()), 3,
                         len(sops.binary))
    args = SF._launch_inputs(sp, _t64(X), _t64(y), None, 3, sops)
    before = SF.PROGRAM_EVAL_F64.launches
    got = SF.PROGRAM_EVAL_F64(*args, sops, SL.l2_dist_loss)
    want = SF.program_eval_plain(*args, sops, SL.l2_dist_loss)
    assert got[0].dtype == torch.float64
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert SF.PROGRAM_EVAL_F64.launches == before


def _options(pkg, **kw):
    base = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
                maxsize=MAXSIZE, populations=2, population_size=16, ncycles_per_iteration=2,
                tournament_selection_n=8, eval_dtype="float64", save_to_file=False)
    base.update(kw)
    return pkg.Options(**base)


@pytest.mark.parametrize("seed", [0, 1])
def test_init_state_float64_matches_jax(seed):
    """init_state in float64: the random trees (drawn from 64-bit uniforms)
    equal, constants and costs within rtol 1e-9, everything float64."""
    X, y = problem(seed)
    with _x64():
        jo = _options(J)
        jds = J.make_dataset(X.astype(np.float64), y.astype(np.float64), dtype=np.float64)
        jds.update_baseline_loss(jo.elementwise_loss)
        js = JEngine(jo, 3, dtype=jnp.float64).init_state(jax.random.key(seed), jds.data, 2)
        assert js.pops.cost.dtype == jnp.float64
        jtrees, jcost = js.pops.trees, to_np(js.pops.cost)
    so = _options(S)
    sd = S.make_dataset(X.astype(np.float64), y.astype(np.float64), device="cpu",
                        dtype=torch.float64)
    sd.update_baseline_loss(so.elementwise_loss)
    se = SEngine(so, 3, device="cpu")
    assert se.dtype == torch.float64 and se.cfg.dtype == torch.float64
    ss = se.init_state(SR.key(seed), sd.data, 2)
    assert ss.pops.cost.dtype == ss.pops.trees.const.dtype == ss.hof.cost.dtype == torch.float64
    for f in TREE_FIELDS:
        assert np.array_equal(to_np(getattr(jtrees, f)), to_np(getattr(ss.pops.trees, f))), f
    assert_close(to_np(jtrees.const), to_np(ss.pops.trees.const), RTOL64, "const")
    assert_close(jcost, to_np(ss.pops.cost), RTOL64, "cost")


def _numpy_loss(tree, X64, y64) -> float:
    """Mean squared error of a decoded tree, evaluated in float64 numpy."""
    def go(n):
        if n.degree == 0:
            return np.full(X64.shape[0], n.val) if n.constant else X64[:, n.feature]
        args = [go(c) for c in n.children]
        name = n.op.name
        with np.errstate(all="ignore"):
            if name == "+":
                return args[0] + args[1]
            if name == "-":
                return args[0] - args[1]
            if name == "*":
                return args[0] * args[1]
            if name == "/":
                return args[0] / args[1]
            return {"cos": np.cos, "exp": np.exp}[name](args[0])

    p = go(tree)
    if not np.all(np.isfinite(p)):
        return np.inf
    return float(np.mean((p - y64) ** 2))


@pytest.mark.parametrize("turbo", [False, True])
def test_run_iteration_float64_against_numpy(turbo):
    """One float64 Engine.run_iteration with the constant optimizer on
    (turbo: the fused L-BFGS and #1-#3's f64 wrappers on their plain
    versions): every population member's loss and the hall of fame's
    equal a float64 numpy evaluation of the decoded tree within rtol 1e-9,
    and the state stays float64."""
    X, y = problem(3)
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    so = _options(S, turbo=turbo)
    sd = S.make_dataset(X64, y64, device="cpu", dtype=torch.float64)
    sd.update_baseline_loss(so.elementwise_loss)
    se = SEngine(so, 3, device="cpu")
    ss = se.run_iteration(se.init_state(SR.key(3), sd.data, 2), sd.data, MAXSIZE)
    assert ss.pops.cost.dtype == ss.pops.trees.const.dtype == torch.float64
    trees = decode_population(ss.pops.trees, so.operators)
    loss = to_np(ss.pops.loss).reshape(-1)
    host = np.array([_numpy_loss(t, X64, y64) for t in trees])
    assert np.array_equal(np.isfinite(host), np.isfinite(loss))
    f = np.isfinite(host)
    np.testing.assert_allclose(loss[f], host[f], rtol=RTOL64)
    ex = to_np(ss.hof.exists)
    htrees = decode_population(ss.hof.trees, so.operators)
    hhost = np.array([_numpy_loss(t, X64, y64) for t in htrees])[ex]
    np.testing.assert_allclose(to_np(ss.hof.loss)[ex], hhost, rtol=RTOL64)


def test_float64_search_runs():
    """equation_search with Options(eval_dtype="float64") and with
    dtype=np.float64: float64 state, the best loss equal to a float64
    numpy evaluation of the best tree within rtol 1e-9."""
    X, y = problem(4, n=96)
    for kw in (dict(options=_options(S)), dict(options=_options(S, eval_dtype="float32"),
                                               dtype=np.float64)):
        state, hof = S.equation_search(X, y, niterations=2, seed=0, device="cpu",
                                       return_state=True, **kw)
        assert state.device_states[0].pops.cost.dtype == torch.float64
        best = min(hof.entries, key=lambda e: e.loss)
        host = _numpy_loss(best.tree, X.astype(np.float64), y.astype(np.float64))
        np.testing.assert_allclose(best.loss, host, rtol=RTOL64)


@pytest.mark.parametrize("case", ["bfloat16_data", "f64_with_bf16_buffer", "f64_with_template"])
def test_float64_refusals(case):
    """eval_dtype="bfloat16", float64 with eval_precision="bf16" and
    float64 with template expressions, refused by earlier slices, build an
    engine with turbo on and run a search (the kernels' plain versions on
    the CPU). The best loss against numpy: bf16 data against a float32
    evaluation of the bf16-rounded data within 3e-2 (a bf16 value buffer
    and a bf16 loss); float64 data on a bf16 buffer against a float64
    evaluation within 3e-2 (the buffer's rounding, a float64 loss spine);
    the float64 template against a float64 evaluation within rtol 1e-9."""
    from symbolicregression_jl_tpu_torch.models import template_spec

    kw = {"bfloat16_data": dict(eval_dtype="bfloat16"),
          "f64_with_bf16_buffer": dict(eval_precision="bf16"),
          "f64_with_template": dict(expression_spec=template_spec(expressions=("f",))(
              lambda f, x1, x2: f(x1) + x2), maxsize=2 * MAXSIZE)}[case]
    opts = _options(S, turbo=True, **kw)
    assert SEngine(opts, 2, device="cpu").cfg.turbo
    X, y = problem(4, n=96, nfeatures=2)
    state, hof = S.equation_search(X, y, options=opts, niterations=2, seed=0, device="cpu",
                                   return_state=True)
    pops = state.device_states[0].pops
    best = min(hof.entries, key=lambda e: e.loss)
    if case == "bfloat16_data":
        assert pops.cost.dtype == torch.float32
        r = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()
        loss = to_np(pops.loss).reshape(-1)
        f = np.isfinite(loss)
        assert np.array_equal(r(loss[f]), loss[f])   # every loss a bf16 value
        host = _numpy_loss(best.tree, r(X).astype(np.float64), r(y).astype(np.float64))
        np.testing.assert_allclose(best.loss, np.float32(host), rtol=3e-2)
        return
    assert pops.cost.dtype == torch.float64
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    if case == "f64_with_bf16_buffer":
        np.testing.assert_allclose(best.loss, _numpy_loss(best.tree, X64, y64), rtol=3e-2)
    else:
        f = best.template_expr.trees["f"]
        host = _numpy_loss(f, X64[:, :1], y64 - X64[:, 1])
        np.testing.assert_allclose(best.loss, host, rtol=RTOL64)
