"""The port's program-kernel entry points against the JAX package's.

On the CPU the port's kernel wrapper runs its plain PyTorch version; the
JAX functions run their Pallas kernel in interpret mode, as
tests/test_fused_eval.py runs them. Validity is bit-equal, loss and cost
agree within rtol 1e-5 with inf in the same places. The CUDA kernel is
held against the plain version on a card in tests/test_torch_cuda.py.
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
from symbolicregression_jl_tpu.ops import encoding as JE
from symbolicregression_jl_tpu.ops import fused_eval as JF
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.core import losses as SL
from symbolicregression_jl_tpu_torch.ops import encoding as SE
from symbolicregression_jl_tpu_torch.ops import fused_eval as SF
from symbolicregression_jl_tpu_torch.ops.program import compile_program, scatter_const_grads

from torch_parity import assert_close, to_np

RTOL = 1e-5
MAXSIZE = 15
UNARY = ["cos", "abs", "exp"]
LAYOUTS = {
    "merged": (["+", "-", "*", "/"], UNARY),   # add/sub share the sign-bit branch
    "legacy": (["*", "/", "-"], UNARY),        # no '+': identity, binaries, unaries
}
EXPRS = [
    "cos(2.13 * x1) + 0.5 * x2",
    "x1 * x2 - exp(x3 / 2.0)",
    "abs(x3) / (x1 - x1)",            # 0/0 on every row: invalid
    "x1 / (x2 - 2.0)",                # inf only on the rows where x2 == 2 (weight 0)
    "1.5",
    "x2",
    "exp(exp(exp(x1 * 3.0)))",        # overflows on some rows
]


def _data(n: int, weighted: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (3, n)).astype(np.float32)
    X[1, :5] = 2.0
    y = rng.normal(size=n).astype(np.float32)
    w = None
    if weighted:
        w = rng.uniform(0.2, 2.0, n).astype(np.float32)
        w[:5] = 0.0
        w[rng.random(n) < 0.1] = 0.0
    return X, y, w


def _batch(layout: str, seed: int, T: int = 56):
    """Random trees plus the hand-written expressions, in both packages."""
    binary, unary = LAYOUTS[layout]
    opts = J.Options(binary_operators=binary, unary_operators=unary, maxsize=MAXSIZE,
                     save_to_file=False)
    cfg = j_cfg(opts, 3)
    rand = j_init_population(jax.random.key(seed), T, cfg.mctx, jnp.float32)
    names = ["x1", "x2", "x3"]
    exprs = [e for e in EXPRS if "+" in binary or "+" not in e]
    hand = JE.encode_population([J.parse_expression(e, cfg.operators, names) for e in exprs],
                                MAXSIZE, cfg.operators)
    jt = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), rand, hand)
    return cfg.operators, S.OperatorSet(binary, unary), jt, interop.tree_batch(
        jax.tree.map(np.asarray, jt), device="cpu")


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,seed", [(257, 0), (300, 1)])
def test_fused_loss_matches_jax(layout, weighted, n, seed):
    jops, sops, jt, st = _batch(layout, seed)
    X, y, w = _data(n, weighted, seed)
    jl, jv = JF.fused_loss(jt, _j(X), _j(y), _j(w), jops, JL.l2_dist_loss, interpret=True)
    sl, sv = SF.fused_loss(st, _t(X), _t(y), _t(w), sops, SL.l2_dist_loss)
    assert np.array_equal(to_np(jv), to_np(sv))
    assert_close(to_np(jl), to_np(sl), RTOL, "loss")
    # x1 / (x2 - 2) is non-finite only on rows of weight 0, and invalid.
    assert not to_np(sv)[-4]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", [0, 2])
def test_fused_cost_matches_jax(layout, weighted, seed):
    """The cost epilogue: (cost, loss, valid) per tree."""
    jops, sops, jt, st = _batch(layout, seed)
    X, y, w = _data(257, weighted, seed)
    cx = np.random.default_rng(seed).integers(1, MAXSIZE, jt.length.shape).astype(np.int32)
    base, use = np.float32(1.7), np.bool_(True)
    jc, jl, jv = JF.fused_cost(jt, _j(X), _j(y), _j(w), _j(cx), jops, JL.l1_dist_loss,
                               baseline_loss=_j(base), use_baseline=_j(use), parsimony=0.0032,
                               interpret=True)
    sc, sl, sv = SF.fused_cost(st, _t(X), _t(y), _t(w), _t(cx), sops, SL.l1_dist_loss,
                               baseline_loss=torch.tensor(base), use_baseline=torch.tensor(use),
                               parsimony=0.0032)
    assert np.array_equal(to_np(jv), to_np(sv))
    assert_close(to_np(jl), to_np(sl), RTOL, "loss")
    assert_close(to_np(jc), to_np(sc), RTOL, "cost")


def _duplicated(jt, seed: int):
    """Three copies of every tree, one with its constants perturbed, in a
    shuffled order."""
    rng = np.random.default_rng(seed)
    pert = dataclasses.replace(jt, const=jt.const * jnp.asarray(
        1.0 + 0.3 * rng.normal(size=jt.const.shape).astype(np.float32)))
    cat = jax.tree.map(lambda a, b, c: jnp.concatenate([a, b, c]), jt, jt, pert)
    perm = jnp.asarray(rng.permutation(cat.length.shape[0]))
    return jax.tree.map(lambda x: jnp.take(x, perm, axis=0), cat)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_loss_dedup(seed):
    """dedup=True is bit-equal to dedup=False in the port, and matches the
    JAX package's dedup path; structure-only duplicates do not merge."""
    jops, sops, jt, _ = _batch("merged", seed, T=24)
    jt = _duplicated(jt, seed)
    st = interop.tree_batch(jax.tree.map(np.asarray, jt), device="cpu")
    X, y, w = _data(257, True, seed)
    l_nd, v_nd = SF.fused_loss(st, _t(X), _t(y), _t(w), sops, SL.l2_dist_loss, dedup=False)
    l_dd, v_dd = SF.fused_loss(st, _t(X), _t(y), _t(w), sops, SL.l2_dist_loss, dedup=True)
    assert torch.equal(v_nd, v_dd)
    assert torch.equal(l_nd.view(torch.int32), l_dd.view(torch.int32))
    jl, jv = JF.fused_loss(jt, _j(X), _j(y), _j(w), jops, JL.l2_dist_loss, interpret=True,
                           dedup=True)
    assert np.array_equal(to_np(jv), to_np(v_dd))
    assert_close(to_np(jl), to_np(l_dd), RTOL, "loss")


def test_dedup_keeps_nonfinite_constants_invalid():
    sops = S.OperatorSet(*LAYOUTS["merged"])
    names = ["x1", "x2", "x3"]
    exprs = ["2.0 * x1 + 1.0", "2.0 * x1 + 1.0", "3.0 * x1 + 1.0", "x2"]
    batch = SE.encode_population([S.parse_expression(e, sops, names) for e in exprs],
                                 MAXSIZE, sops, device="cpu")
    const = batch.const.clone()
    const[0] = torch.where(batch.arity[0] == 0, torch.nan, const[0])
    batch = dataclasses.replace(batch, const=const)
    X, y, _ = _data(257, False)
    l, v = SF.fused_loss(batch, _t(X), _t(y), None, sops, SL.l2_dist_loss, dedup=True)
    l2, v2 = SF.fused_loss(batch, _t(X), _t(y), None, sops, SL.l2_dist_loss)
    assert v.tolist() == [False, True, True, True] == v2.tolist()
    assert torch.equal(l.view(torch.int32), l2.view(torch.int32))


def _launch_args(seed: int, n: int = 257, device="cpu"):
    _, sops, _, st = _batch("merged", seed)
    X, y, w = _data(n, True, seed)
    Xt, yt, wt = (_t(a).to(device) for a in (X, y, w))
    st = st.map(lambda a: a.to(device))
    prog = compile_program(st, 3, len(sops.binary))
    args = SF._launch_inputs(prog, Xt, yt, wt, 3, sops)
    cx = torch.arange(1, prog.nsteps.shape[0] + 1, dtype=torch.float32, device=device)
    scal = torch.tensor([float(w.sum()), 1.7, 0.0032], device=device)
    return sops, args, cx, scal


@pytest.mark.parametrize("seed", [0, 1])
def test_cost_form_is_plain_form_plus_loss_to_cost(seed):
    """The epilogue computes loss_to_cost's operations in its order: bit
    for bit what the plain form plus core.losses.loss_to_cost gives."""
    sops, args, cx, scal = _launch_args(seed)
    total, valid = SF.program_eval_plain(*args, sops, SL.l2_dist_loss)
    loss_c, valid_c, cost_c = SF.program_eval_plain(*args, sops, SL.l2_dist_loss, cx=cx,
                                                    scal=scal)
    mean = total / scal[0]
    loss = torch.where(valid & torch.isfinite(mean), mean, torch.inf)
    cost = SL.loss_to_cost(loss, torch.tensor(1.7), torch.tensor(True), cx, 0.0032)
    assert torch.equal(valid, valid_c)
    assert torch.equal(loss.view(torch.int32), loss_c.view(torch.int32))
    assert torch.equal(cost.view(torch.int32), cost_c.view(torch.int32))


def test_plain_version_chunking_is_exact():
    """The plain version's tree chunks do not change any result."""
    sops, args, _, _ = _launch_args(0)
    whole = SF.program_eval_plain(*args, sops, SL.l2_dist_loss)
    chunked = SF.program_eval_plain(*args, sops, SL.l2_dist_loss, max_elems=1)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_wrapper_runs_plain_version_on_cpu_without_launching():
    sops, args, cx, scal = _launch_args(1)
    kernel = SF.ProgramEvalKernel()
    got = kernel(*args, sops, SL.l2_dist_loss, cx=cx, scal=scal)
    want = SF.program_eval_plain(*args, sops, SL.l2_dist_loss, cx=cx, scal=scal)
    assert kernel.launches == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_refuses_other_devices():
    sops, args, _, _ = _launch_args(0)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        SF.ProgramEvalKernel()(*meta, sops, SL.l2_dist_loss)



# ---------------------------------------------------------------------------
# Kernels #2 and #3: fused_loss_multi and fused_grad_multi
# ---------------------------------------------------------------------------

GRAD_RTOL = 1e-4


def _variants(jp, V: int, seed: int):
    """[T, V, CMAX] constant vectors: the trees' own constants perturbed,
    with a non-finite candidate constant in two pairs."""
    rng = np.random.default_rng(seed)
    cv = np.asarray(jp.cvals)[:, None, :] * (
        1.0 + 0.3 * rng.normal(size=(jp.cvals.shape[0], V, jp.cvals.shape[1])))
    cv = cv.astype(np.float32)
    used = np.arange(cv.shape[2])[None, :] < np.asarray(jp.nconst)[:, None]
    t = np.argwhere(used[:, 0])[:2, 0]
    cv[t[0], V - 1, 0] = np.inf
    cv[t[1], 0, 0] = np.nan
    return cv


def _assert_grad_close(jg, sg, scale, what):
    """Gradients: zeroed (non-finite or bad-pair) components in the same
    places; elsewhere within GRAD_RTOL of the sum of the absolute per-row
    terms. Each row's derivative agrees within a few ULP, but the rows are
    summed in another order and may cancel, so the error is bounded
    relative to that sum rather than to the (possibly small) gradient."""
    jg, sg, scale = np.asarray(jg), np.asarray(sg), np.asarray(scale)
    assert np.array_equal(jg == 0, sg == 0), what
    live = jg != 0
    assert np.all(np.abs(jg - sg)[live] <= GRAD_RTOL * scale[live]), (
        what, np.max(np.abs(jg - sg)[live] - GRAD_RTOL * scale[live], initial=0))


@pytest.mark.parametrize("layout,weighted,V,n", [("merged", True, 5, 64),
                                                 ("legacy", False, 1, 257)])
def test_fused_multi_and_grad_match_jax(layout, weighted, V, n):
    """Kernels #2 and #3 (plain versions here) against the JAX package's
    interpret-mode kernels, with weight-0 rows and non-finite candidate
    constants: validity and the zeroed-gradient pattern bit-equal, loss
    within rtol 1e-5 with inf in the same places, gradients as stated in
    _assert_grad_close."""
    from symbolicregression_jl_tpu.ops.program import compile_program as j_compile

    jops, sops, jt, st = _batch(layout, 0, T=16)
    X, y, w = _data(n, weighted, 0)
    jp = j_compile(jt, 3, len(jops.binary))
    sp = compile_program(st, 3, len(sops.binary))
    cv = _variants(jp, V, 1)
    args_j = (jp, _j(cv), _j(X), _j(y), _j(w), 3, jops, JL.l2_dist_loss)
    args_s = (sp, _t(cv), _t(X), _t(y), _t(w), 3, sops, SL.l2_dist_loss)
    jl, jv = JF.fused_loss_multi(*args_j, interpret=True)
    sl, sv = SF.fused_loss_multi(*args_s)
    assert np.array_equal(to_np(jv), to_np(sv))
    assert_close(to_np(jl), to_np(sl), RTOL, "loss")
    jgl, jgv, jg = JF.fused_grad_multi(*args_j, interpret=True)
    sgl, sgv, sg = SF.fused_grad_multi(*args_s)
    assert np.array_equal(to_np(jgv), to_np(sgv)) and np.array_equal(to_np(sgv), to_np(sv))
    assert_close(to_np(jgl), to_np(sgl), RTOL, "grad-kernel loss")
    assert np.array_equal(to_np(sgl).view(np.int32), to_np(sl).view(np.int32))
    instr = SF._pack_instr(sp, sops, 3 + sp.cmax + sp.max_steps)
    wt = torch.ones(n) if w is None else _t(w)
    *_, gabs = SF.program_grad_plain(instr, sp.nsteps, sp.nconst, _t(cv), _t(X), _t(y), wt,
                                     sops, SL.l2_dist_loss, return_abs=True)
    _assert_grad_close(to_np(jg), to_np(sg), to_np(gabs) / float(wt.sum()), "grad")


def test_grad_plain_matches_autograd_where_finite():
    """The adjoint sweep against torch.autograd of the multi-variant plain
    version, on pairs where both are finite (autograd's rules are not
    JAX's where the values are not): within 1e-5 of the sum of the
    absolute per-row terms, the two summing the rows in other orders."""
    _, sops, _, st = _batch("merged", 2, T=24)
    X, y, w = _data(128, True, 2)
    sp = compile_program(st, 3, len(sops.binary))
    instr = SF._pack_instr(sp, sops, 3 + sp.cmax + sp.max_steps)
    cv = _t(np.asarray(sp.cvals)[:, None, :].repeat(3, 1) * np.float32([1.0, 0.9, 1.1])[None, :,
                                                                                       None])
    cv = cv.clone().requires_grad_(True)
    loss, valid = SF.program_multi_plain(instr, sp.nsteps, cv, _t(X), _t(y), _t(w), sops,
                                         SL.l2_dist_loss)
    ok = valid & torch.isfinite(loss)
    (g_auto,) = torch.autograd.grad(torch.where(ok, loss, 0.0).sum(), cv)
    gl, gv, g, gabs = SF.program_grad_plain(instr, sp.nsteps, sp.nconst, cv.detach(), _t(X),
                                            _t(y), _t(w), sops, SL.l2_dist_loss, return_abs=True)
    assert torch.equal(gv, valid)
    assert torch.equal(gl.view(torch.int32), loss.detach().view(torch.int32))
    # The plain version evaluates every branch of the opcode switch and
    # selects; autograd sends a zero cotangent into the untaken branches,
    # where 0 / 0 can make NaN. Only pairs finite on both sides compare.
    ok = ok & torch.isfinite(g).all(-1) & torch.isfinite(g_auto).all(-1)
    assert ok.sum() > 20
    assert torch.all((g - g_auto).abs()[ok] <= 1e-5 * gabs[ok] + 1e-30)


def test_fused_grad_program_and_const_grad_scatter():
    """The single-variant views: fused_grad_program is V = 1 of
    fused_grad_multi; fused_loss_and_const_grad scatters it to slot order."""
    _, sops, _, st = _batch("merged", 1, T=16)
    X, y, w = _data(64, True, 1)
    sp = compile_program(st, 3, len(sops.binary))
    l1, v1, g1 = SF.fused_grad_program(sp, _t(X), _t(y), _t(w), 3, sops, SL.l2_dist_loss)
    lm, vm, gm = SF.fused_grad_multi(sp, sp.cvals[:, None], _t(X), _t(y), _t(w), 3, sops,
                                     SL.l2_dist_loss)
    assert torch.equal(l1, lm[:, 0]) and torch.equal(v1, vm[:, 0]) and torch.equal(g1, gm[:, 0])
    l2, v2, g2 = SF.fused_loss_and_const_grad(st, None, _t(X), _t(y), _t(w), sops,
                                              SL.l2_dist_loss)
    assert torch.equal(l2, l1) and torch.equal(v2, v1)
    assert torch.equal(g2, scatter_const_grads(sp, g1, st.max_nodes))


def test_multi_refusals():
    """Kernel #3's plain version takes the library losses only; the entry
    point sends a user callable to the user-loss route instead
    (tests/test_torch_user_loss.py). A user operator, once refused, runs:
    its rows take torch.autograd through its own function (bit-equal to
    the same operator written another way with the same derivative;
    tests/test_torch_user_ops.py holds them against the JAX package)."""
    _, sops, _, st = _batch("merged", 0, T=8)
    X, y, _ = _data(16, False)
    sp = compile_program(st, 3, len(sops.binary))
    quartic = lambda p, t: (p - t) ** 4  # noqa: E731
    instr = SF._pack_instr(sp, sops, 3 + sp.cmax + sp.max_steps)
    with pytest.raises(NotImplementedError, match="library elementwise losses"):
        SF.program_grad_plain(instr, sp.nsteps, sp.nconst, sp.cvals[:, None], _t(X), _t(y),
                              torch.ones(16), sops, quartic)
    loss, valid, grad = SF.fused_grad_multi(sp, sp.cvals[:, None], _t(X), _t(y), None, 3, sops,
                                            quartic)
    ref, ref_valid = SF.fused_loss(st, _t(X), _t(y), None, sops, quartic)
    assert torch.equal(valid[:, 0], ref_valid) and torch.equal(loss[:, 0], ref)
    assert grad.shape == (st.length.shape[0], 1, sp.cmax)
    from symbolicregression_jl_tpu_torch.evolve import rng as SR
    from symbolicregression_jl_tpu_torch.evolve.population import init_population
    from symbolicregression_jl_tpu_torch.evolve.step import evolve_config_from_options

    twice = S.Op("twice", 1, lambda x: 2 * x)
    twin = S.Op("twice", 1, lambda x: x + x)   # the same values and derivative
    cfg = evolve_config_from_options(S.Options(binary_operators=["+", "*"],
                                               unary_operators=[twice], maxsize=MAXSIZE,
                                               save_to_file=False), 3, "cpu")
    trees = init_population(SR.split(SR.key(4), 2), 8, cfg.mctx).reshape(-1)
    assert bool((trees.op[trees.arity == 1] == 0).any())   # twice is drawn
    outs = []
    for op in (twice, twin):
        ops = S.OperatorSet(["+", "*"], [op])
        prog = compile_program(trees, 3, 2)
        ins = SF._pack_instr(prog, ops, 3 + prog.cmax + prog.max_steps)
        outs.append(SF.program_grad_plain(ins, prog.nsteps, prog.nconst, prog.cvals[:, None],
                                          _t(X), _t(y), torch.ones(16), ops, SL.l2_dist_loss))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert bool(outs[0][1].any()) and bool(torch.isfinite(outs[0][2]).all())


# ---------------------------------------------------------------------------
# The derivative table, operator by operator
# ---------------------------------------------------------------------------

_ALL_UNARY = [n for n, o in J.ops.operators.OPERATOR_REGISTRY.items() if o.arity == 1]
_ALL_BINARY = [n for n, o in J.ops.operators.OPERATOR_REGISTRY.items() if o.arity == 2]
_EDGES = np.array([-100, -88, -10, -3, -2, -1.5, -1, -0.75, -0.5, -1e-30, -0.0, 0.0, 1e-30,
                   0.3, 0.5, 1, 1.5, 2, 2.5, 3, 10, 88, 100, 3e38], np.float32)
_CTS = np.array([1.0, 0.0, -2.5], np.float32)   # ct = 0: a weight-0 row's cotangent


def _table_close(want, got, rtol, what):
    """NaN and +-inf in the same places; finite values within rtol (and
    1e-30 absolute: XLA's CPU backend flushes subnormal results to 0)."""
    want, got = np.asarray(want), np.asarray(got)
    assert np.array_equal(np.isnan(want), np.isnan(got)), what
    assert np.array_equal(np.isinf(want), np.isinf(got)), what
    assert np.array_equal(want[np.isinf(want)], got[np.isinf(got)]), what
    f = np.isfinite(want)
    np.testing.assert_allclose(got[f], want[f], rtol=rtol, atol=1e-30, err_msg=what)


def test_derivative_table_matches_jax_vjp():
    """Every built-in operator's and loss's reverse-mode derivative against
    jax.vjp of the JAX package's operator, on a grid of domain edges x
    cotangents (0 included): non-finite values in the same places, finite
    ones within rtol 1e-4 (tanh's 1 - tanh(x)^2 near |x| = 3 turns the two
    backends' 1-ULP tanh difference into 2e-5)."""
    from symbolicregression_jl_tpu.core import losses as JLoss
    from symbolicregression_jl_tpu_torch.ops import vjp as SV

    x, ct = np.meshgrid(_EDGES, _CTS, indexing="ij")
    for name in _ALL_UNARY:
        fn = J.ops.operators.OPERATOR_REGISTRY[name].fn
        (want,) = jax.vjp(fn, jnp.asarray(x))[1](jnp.asarray(ct))
        got = SV.UNARY_VJP[name](_t(x), _t(ct))
        _table_close(to_np(want), to_np(got), 1e-4, name)
    a, b, ct3 = np.meshgrid(_EDGES, _EDGES, _CTS, indexing="ij")
    for name in _ALL_BINARY:
        fn = J.ops.operators.OPERATOR_REGISTRY[name].fn
        wa, wb = jax.vjp(fn, jnp.asarray(a), jnp.asarray(b))[1](jnp.asarray(ct3))
        ga, gb = SV.BINARY_VJP[name](_t(a), _t(b), _t(ct3))
        _table_close(to_np(wa), to_np(ga), 1e-4, name + " (first operand)")
        _table_close(to_np(wb), to_np(gb), 1e-4, name + " (second operand)")
    for jf, sf in ((JLoss.l2_dist_loss, SL.l2_dist_loss), (JLoss.l1_dist_loss, SL.l1_dist_loss),
                   (JLoss.huber_loss(1.0), SL.LOSS_REGISTRY["HuberLoss"])):
        (want,) = jax.vjp(lambda p: jf(p, jnp.asarray(b)), jnp.asarray(a))[1](jnp.asarray(ct3))
        _table_close(to_np(want), to_np(SV.loss_vjp(sf)(_t(a), _t(b), _t(ct3))), 1e-5,
                     sf.__name__)


def test_every_operator_gradient_matches_jax_kernel():
    """Kernel #3 (plain version) against the JAX package's interpret-mode
    kernel with every built-in operator in one operator set, one tree per
    operator, on rows at domain edges (0, +-1, ...) of which every fifth
    has weight 0: validity, the zeroed-gradient pattern and the gradients
    (as in _assert_grad_close) operator by operator."""
    from symbolicregression_jl_tpu.ops.program import compile_program as j_compile

    jops, sops = J.OperatorSet(_ALL_BINARY, _ALL_UNARY), S.OperatorSet(_ALL_BINARY, _ALL_UNARY)
    names = ["x1", "x2"]
    parse = lambda e: J.parse_expression(e, jops, names)
    exprs = ([f"{u}(x1 * 1.0)" for u in _ALL_UNARY] + [f"{u}(x2 * 1.0)" for u in _ALL_UNARY]
             + [f"{b}(x1 * 1.0, x2 + 0.0)" for b in _ALL_BINARY])
    trees = [parse(e) for e in exprs[:2 * len(_ALL_UNARY)]] + [
        J.ops.tree.Node(op=op, children=[parse("x1 * 1.0"), parse("x2 + 0.0")])
        for op in jops.binary]
    jt = JE.encode_population(trees, 8, jops)
    st = interop.tree_batch(jax.tree.map(np.asarray, jt), device="cpu")
    edges = np.array([-3, -2, -1.25, -1, -0.75, -0.5, -0.25, 0, 0.25, 0.5, 0.75, 1, 1.25, 2, 3],
                     np.float32)
    n = 64
    rng = np.random.default_rng(0)
    X = np.stack([np.resize(edges, n), rng.permutation(np.resize(edges[3:12], n))])
    y = rng.normal(size=n).astype(np.float32)
    w = rng.uniform(0.5, 2, n).astype(np.float32)
    w[::5] = 0.0
    jp, sp = j_compile(jt, 2, len(jops.binary)), compile_program(st, 2, len(sops.binary))
    cv = np.array(jp.cvals)[:, None, :]
    _, jv, jg = JF.fused_grad_multi(jp, _j(cv), _j(X), _j(y), _j(w), 2, jops, JL.l2_dist_loss,
                                    interpret=True)
    _, sv, sg = SF.fused_grad_multi(sp, _t(cv), _t(X), _t(y), _t(w), 2, sops, SL.l2_dist_loss)
    instr = SF._pack_instr(sp, sops, 2 + sp.cmax + sp.max_steps)
    *_, gabs = SF.program_grad_plain(instr, sp.nsteps, sp.nconst, _t(cv), _t(X), _t(y), _t(w),
                                     sops, SL.l2_dist_loss, return_abs=True)
    scale = to_np(gabs) / float(w.sum())
    for i, e in enumerate(exprs):
        assert to_np(jv)[i] == to_np(sv)[i], e
        _assert_grad_close(to_np(jg)[i], to_np(sg)[i], scale[i], e)
    assert to_np(sv).sum() > len(exprs) // 2
