"""Tests of the port's CUDA kernels; they need an NVIDIA card and skip
without one.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu_torch.core import losses as SL
from symbolicregression_jl_tpu_torch.evolve import rng
from symbolicregression_jl_tpu_torch.evolve.engine import Engine
from symbolicregression_jl_tpu_torch.evolve.population import init_population
from symbolicregression_jl_tpu_torch.evolve.step import evolve_config_from_options
from symbolicregression_jl_tpu_torch.ops import fused_eval as SF
from symbolicregression_jl_tpu_torch.ops.program import compile_program

sys.path.insert(0, str(Path(__file__).resolve().parent))
from kernel_trees import random_trees, with_written  # noqa: E402

RTOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _options(binary=("+", "-", "*", "/"), **kw):
    base = dict(binary_operators=list(binary), unary_operators=["cos", "abs", "exp"],
                maxsize=15, populations=4, population_size=32, ncycles_per_iteration=5,
                tournament_selection_n=8, should_optimize_constants=False, save_to_file=False)
    base.update(kw)
    return S.Options(**base)


def _launch_args(device, binary, n: int, T: int = 512):
    opts = _options(binary)
    cfg = evolve_config_from_options(opts, 3, device)
    trees = init_population(rng.split(rng.key(3, device=device), T // 64), 64,
                            cfg.mctx, nlength=5).reshape(-1)
    g = np.random.default_rng(0)
    X = torch.from_numpy(g.uniform(-3, 3, (3, n)).astype(np.float32)).to(device)
    y = torch.from_numpy(g.normal(size=n).astype(np.float32)).to(device)
    w = torch.from_numpy(np.where(g.random(n) < 0.1, 0.0, g.uniform(0.2, 2, n))
                         .astype(np.float32)).to(device)
    prog = compile_program(trees, 3, len(opts.operators.binary))
    args = SF._launch_inputs(prog, X, y, w, 3, opts.operators)
    cx = torch.arange(1, T + 1, dtype=torch.float32, device=device)
    scal = torch.stack([w.sum(), torch.tensor(1.7, device=device),
                        torch.tensor(0.0032, device=device)])
    return opts.operators, args, cx, scal


def _close(a, b):
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    assert torch.equal(fa, fb) and torch.equal(a[~fa], b[~fb])
    torch.testing.assert_close(a[fa], b[fb], rtol=RTOL, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [("+", "-", "*", "/"), ("*", "/", "-")])
@pytest.mark.parametrize("n", [257, 10_000])
@pytest.mark.parametrize("loss", [SL.l2_dist_loss, SL.l1_dist_loss])
def test_kernel_matches_plain_version(cuda_device, binary, n, loss):
    """Validity bit-equal, loss sum and cost within rtol 1e-5 with inf in
    the same places, two launches bit-identical, one count per launch."""
    ops, args, cx, scal = _launch_args(cuda_device, binary, n)
    kernel = SF.ProgramEvalKernel()
    lk, vk = kernel(*args, ops, loss)
    lk2, vk2 = kernel(*args, ops, loss)
    lck, vck, ck = kernel(*args, ops, loss, cx=cx, scal=scal)
    assert kernel.launches == 3
    lp, vp = SF.program_eval_plain(*args, ops, loss)
    lcp, vcp, cp = SF.program_eval_plain(*args, ops, loss, cx=cx, scal=scal)
    assert torch.equal(lk.view(torch.int32), lk2.view(torch.int32)) and torch.equal(vk, vk2)
    assert torch.equal(vk, vp) and torch.equal(vck, vcp)
    _close(torch.where(vp, lk, torch.inf), torch.where(vp, lp, torch.inf))
    _close(lck, lcp)
    _close(ck, cp)


def _param_args(device, binary, n: int, T: int = 512, NP: int = 2, NC: int = 3):
    """Random parametric trees (a mutation context with n_params = NP),
    their banks, a class column and hostile entries: every fifth tree's
    const_ok cleared, every 97th row's X at +-1e20, and every 11th tree's
    bank +inf for class 2 only."""
    opts = _options(binary)
    cfg = evolve_config_from_options(opts, 3, device, n_params=NP, n_classes=NC)
    trees = init_population(rng.split(rng.key(5, device=device), T // 64), 64,
                            cfg.mctx, nlength=5).reshape(-1)
    g = np.random.default_rng(2)
    Xn = g.uniform(-3, 3, (3, n)).astype(np.float32)
    Xn[:, ::97] = 1e20 * np.sign(g.normal(size=Xn[:, ::97].shape))
    X = torch.from_numpy(Xn).to(device)
    y = torch.from_numpy(g.normal(size=n).astype(np.float32)).to(device)
    w = torch.from_numpy(np.where(g.random(n) < 0.1, 0.0, g.uniform(0.2, 2, n))
                         .astype(np.float32)).to(device)
    bank = g.normal(size=(T, NP, NC)).astype(np.float32)
    bank[::11, :, 2] = np.inf
    cls = torch.from_numpy(g.integers(0, NC, n).astype(np.int32)).to(device)
    prog = compile_program(trees, 3, len(opts.operators.binary), n_params=NP)
    instr, nsteps, cvals, ok, Xc, yc, wc = SF._launch_inputs(prog, X, y, w, 3, opts.operators,
                                                             NP)
    ok = torch.where(torch.arange(T, device=device) % 5 == 0, 0, ok).to(torch.int32)
    return opts.operators, (instr, nsteps, cvals, ok, torch.from_numpy(bank).to(device), cls,
                            Xc, yc, wc)


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [("+", "-", "*", "/"), ("*", "/", "-")])
@pytest.mark.parametrize("n", [257, 10_000])
def test_param_kernel_matches_plain_version(cuda_device, binary, n):
    """Kernel #1's parametric form (``bank[t, p, class_idx[r]]``) against
    its plain version: validity bit-equal, loss sum within rtol 1e-5 with
    NaN and +-inf in the same places, two launches bit-identical, one count
    per launch; the plain form's count untouched."""
    ops, args = _param_args(cuda_device, binary, n)
    kernel = SF.ProgramEvalParamKernel()
    plain_before = SF.PROGRAM_EVAL.launches
    lk, vk = kernel(*args, ops, SL.l2_dist_loss)
    lk2, vk2 = kernel(*args, ops, SL.l2_dist_loss)
    assert kernel.launches == 2 and SF.PROGRAM_EVAL.launches == plain_before
    lp, vp = SF.program_eval_plain(*args[:4], *args[6:], ops, SL.l2_dist_loss, bank=args[4],
                                   class_idx=args[5])
    assert torch.equal(lk.view(torch.int32), lk2.view(torch.int32)) and torch.equal(vk, vk2)
    assert torch.equal(vk, vp) and 0 < int(vk.sum()) < vk.numel()
    _close(torch.where(vp, lk, torch.inf), torch.where(vp, lp, torch.inf))


@pytest.mark.cuda
def test_parametric_engine_launches_param_kernel(cuda_device):
    """A parametric search's candidate evals and finalize go through the
    parametric form only: one launch per cycle plus one per iteration."""
    opts = _options(expression_spec=S.ParametricExpressionSpec(max_parameters=1))
    g = np.random.default_rng(1)
    X = g.uniform(-3, 3, (300, 3)).astype(np.float32)
    cls = g.integers(0, 3, 300)
    y = (np.array([1.0, 2.0, 3.0])[cls] * np.cos(X[:, 0]) + X[:, 1]).astype(np.float32)
    ds = S.make_dataset(X, y, extra={"class": cls}, device=cuda_device)
    ds.update_baseline_loss(opts.elementwise_loss)
    engine = Engine(opts, 3, device=cuda_device, n_params=1, n_classes=3)
    state = engine.init_state(rng.key(0, device=cuda_device), ds.data, opts.populations)
    before = (SF.PROGRAM_EVAL.launches, SF.PROGRAM_EVAL_PARAM.launches)
    state = engine.run_iteration(state, ds.data, opts.maxsize)
    torch.cuda.synchronize()
    assert SF.PROGRAM_EVAL.launches == before[0]
    assert SF.PROGRAM_EVAL_PARAM.launches - before[1] == opts.ncycles_per_iteration + 1
    assert bool(torch.isfinite(state.hof.loss[state.hof.exists]).all())


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    ops, args, _, _ = _launch_args(cuda_device, ("+", "*"), 64, T=64)
    bad = list(args)
    bad[5] = args[5].cpu()   # y on the CPU, X on the card
    with pytest.raises(ValueError, match="y is on"):
        SF.PROGRAM_EVAL(*bad, ops, SL.l2_dist_loss)
    bad = list(args)
    bad[0] = args[0].to(torch.int64)
    with pytest.raises(TypeError, match="int32"):
        SF.PROGRAM_EVAL(*bad, ops, SL.l2_dist_loss)


@pytest.mark.cuda
def test_engine_iteration_launches_kernel(cuda_device):
    """Every candidate eval and the finalize go through the kernel: one
    launch per cycle plus one per iteration."""
    opts = _options()
    g = np.random.default_rng(1)
    X = g.uniform(-3, 3, (300, 3)).astype(np.float32)
    y = (X[:, 0] * X[:, 0] + np.cos(X[:, 1])).astype(np.float32)
    ds = S.make_dataset(X, y, device=cuda_device)
    ds.update_baseline_loss(opts.elementwise_loss)
    engine = Engine(opts, 3, device=cuda_device)
    assert engine.cfg.turbo and engine.cfg.fuse_cost
    state = engine.init_state(rng.key(0, device=cuda_device), ds.data, opts.populations)
    before = SF.PROGRAM_EVAL.launches
    state = engine.run_iteration(state, ds.data, opts.maxsize)
    torch.cuda.synchronize()
    assert SF.PROGRAM_EVAL.launches - before == opts.ncycles_per_iteration + 1
    assert bool(torch.isfinite(state.hof.loss[state.hof.exists]).all())


@pytest.mark.cuda
def test_search_on_card(cuda_device):
    g = np.random.default_rng(0)
    X = g.uniform(-3, 3, (200, 2)).astype(np.float32)
    y = (X[:, 0] * X[:, 0] + np.cos(X[:, 1])).astype(np.float32)
    a = S.equation_search(X, y, options=_options(), niterations=2, seed=0, device=cuda_device)
    b = S.equation_search(X, y, options=_options(), niterations=2, seed=0, device=cuda_device)
    assert np.isfinite(min(e.loss for e in a.entries))
    assert [(e.complexity, e.loss) for e in a.entries] == [(e.complexity, e.loss)
                                                          for e in b.entries]


def _multi_args(device, binary, n: int, V: int, T: int = 256):
    """Kernel inputs for T random trees with V perturbed constant vectors
    each (a few non-finite), plus the trees' nconst and own constants."""
    opts = _options(binary)
    cfg = evolve_config_from_options(opts, 3, device)
    trees = init_population(rng.split(rng.key(5, device=device), T // 64), 64,
                            cfg.mctx, nlength=5).reshape(-1)
    g = np.random.default_rng(2)
    X = torch.from_numpy(g.uniform(-3, 3, (3, n)).astype(np.float32)).to(device)
    y = torch.from_numpy(g.normal(size=n).astype(np.float32)).to(device)
    w = torch.from_numpy(np.where(g.random(n) < 0.1, 0.0, g.uniform(0.2, 2, n))
                         .astype(np.float32)).to(device)
    prog = compile_program(trees, 3, len(opts.operators.binary))
    instr, nsteps, cvals, _, X, y, w = SF._launch_inputs(prog, X, y, w, 3, opts.operators)
    gen = torch.Generator(device=device).manual_seed(1)
    cv = cvals[:, None, :] * (1.0 + 0.5 * torch.randn((T, V, cvals.shape[1]), generator=gen,
                                                      device=device))
    cv[::17, -1, 0] = torch.inf
    nconst = prog.nconst.to(torch.int32).contiguous()
    return opts.operators, instr, nsteps, nconst, cv.contiguous(), X, y, w, cvals


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [("+", "-", "*", "/"), ("*", "/", "-")])
@pytest.mark.parametrize("loss", [SL.l2_dist_loss, SL.l1_dist_loss, SL.LOSS_REGISTRY["huber"]])
def test_multi_and_grad_kernels_match_plain_versions(cuda_device, binary, loss):
    """Kernel #2: validity bit-equal, loss sums within rtol 1e-5 with inf
    in the same places, V = 1 bit-equal to kernel #1's plain form. Kernel
    #3: validity bit-equal, loss bit-equal to #2's, gradients non-finite
    in the same places and within 1e-4 of the absolute row sums; two
    launches bit-identical."""
    ops, instr, nsteps, nconst, cv, X, y, w, cvals = _multi_args(cuda_device, binary, 1000, 5)
    T = instr.shape[0]
    multi, grad = SF.ProgramMultiKernel(), SF.ProgramGradKernel()
    lk, vk = multi(instr, nsteps, cv, X, y, w, ops, loss)
    lp, vp = SF.program_multi_plain(instr, nsteps, cv, X, y, w, ops, loss)
    assert torch.equal(vk, vp)
    _close(torch.where(vp, lk, torch.inf), torch.where(vp, lp, torch.inf))
    ones = torch.ones(T, dtype=torch.int32, device=cuda_device)
    l1, v1 = multi(instr, nsteps, cvals[:, None, :].contiguous(), X, y, w, ops, loss)
    l1e, v1e = SF.ProgramEvalKernel()(instr, nsteps, cvals, ones, X, y, w, ops, loss)
    assert torch.equal(l1[:, 0].view(torch.int32), l1e.view(torch.int32))
    assert torch.equal(v1[:, 0], v1e)
    gl, gv, gg = grad(instr, nsteps, nconst, cv, X, y, w, ops, loss)
    gl2, gv2, gg2 = grad(instr, nsteps, nconst, cv, X, y, w, ops, loss)
    assert multi.launches == 2 and grad.launches == 2
    assert torch.equal(gg.view(torch.int32), gg2.view(torch.int32))
    assert torch.equal(gv, vk) and torch.equal(gl.view(torch.int32), lk.view(torch.int32))
    pl, pv, pg, pabs = SF.program_grad_plain(instr, nsteps, nconst, cv, X, y, w, ops, loss,
                                             return_abs=True)
    assert torch.equal(gv, pv)
    live = pv[..., None].expand_as(pg)
    assert torch.equal(torch.isfinite(gg)[live], torch.isfinite(pg)[live])
    both = live & torch.isfinite(gg) & torch.isfinite(pg)
    assert bool(((gg - pg).abs()[both] <= 1e-4 * pabs[both]).all())


@pytest.mark.cuda
def test_engine_iteration_launches_optimizer_kernels(cuda_device):
    """With the constant optimizer on, one iteration launches kernel #2
    once per L-BFGS iteration and kernel #3 once more than that."""
    opts = _options(should_optimize_constants=True)
    g = np.random.default_rng(1)
    X = g.uniform(-3, 3, (300, 3)).astype(np.float32)
    y = (X[:, 0] * X[:, 0] + np.cos(X[:, 1])).astype(np.float32)
    ds = S.make_dataset(X, y, device=cuda_device)
    ds.update_baseline_loss(opts.elementwise_loss)
    engine = Engine(opts, 3, device=cuda_device)
    state = engine.init_state(rng.key(0, device=cuda_device), ds.data, opts.populations)
    before = (SF.PROGRAM_EVAL.launches, SF.PROGRAM_MULTI.launches, SF.PROGRAM_GRAD.launches)
    state = engine.run_iteration(state, ds.data, opts.maxsize)
    torch.cuda.synchronize()
    after = (SF.PROGRAM_EVAL.launches, SF.PROGRAM_MULTI.launches, SF.PROGRAM_GRAD.launches)
    iters = opts.optimizer_iterations
    assert [a - b for a, b in zip(after, before)] == [opts.ncycles_per_iteration + 1, iters,
                                                      iters + 1]
    assert bool(torch.isfinite(state.hof.loss[state.hof.exists]).all())


def _predict_args(device, n: int, F: int, per_member: bool, T: int = 256,
                  overflow: bool = False):
    """Random programs over F arguments, their X (shared [F, n] or
    per-member [T, F, n]) and random row cotangents. ``overflow`` sets
    every 97th row to +-1e20 (x * x overflows, inf - inf gives NaN): in
    every tree's X when shared, in every seventh tree's when per-member."""
    opts = _options(("+", "-", "*"), unary_operators=["cos"])
    cfg = evolve_config_from_options(opts, F, device)
    trees = init_population(rng.split(rng.key(7, device=device), T // 64), 64, cfg.mctx,
                            nlength=5).reshape(-1)
    prog = compile_program(trees, F, len(opts.operators.binary))
    g = np.random.default_rng(3)
    X = g.uniform(-3, 3, (T, F, n) if per_member else (F, n)).astype(np.float32)
    if overflow:
        big = X[::7, :, ::97] if per_member else X[:, ::97]
        big[...] = np.where(big < 0, -1e20, 1e20)
    X = torch.from_numpy(X).to(device)
    ct = torch.from_numpy(g.normal(size=(T, n)).astype(np.float32)).to(device)
    return opts.operators, prog, X, ct


def _nonfinite_match(a, b):
    """NaN in the same places, +-inf in the same places with the same sign."""
    ia, ib = torch.isinf(a), torch.isinf(b)
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(ia, ib) and torch.equal(a[ia], b[ib])


def _pred_close(a, b):
    """Non-finite in the same places; finite values within 1e-5 of the
    tree's largest |pred| (rtol 1e-5 where no cancellation happens)."""
    _nonfinite_match(a, b)
    fb = torch.isfinite(b)
    scale = torch.where(fb, b.abs(), 0.0).amax(dim=-1, keepdim=True).expand_as(b)
    assert bool(((a - b).abs()[fb] <= 1e-5 * scale[fb]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("per_member,F,overflow", [(False, 1, False), (False, 1, True),
                                                    (True, 2, True)])
def test_predict_kernels_match_plain_versions(cuda_device, per_member, F, overflow):
    """Every fifth tree's const_ok cleared. Kernel #4: validity bit-equal
    (some trees valid, some not), predictions close (``_pred_close``).
    Kernel #5 with random cotangents: gcomp NaN and +-inf in the same
    places and otherwise within 1e-4 of the absolute row sums, gx
    (per-member) non-finite in the same places and within 1e-5 of its
    largest |gx| per tree. Two launches of each bit-identical."""
    ops, prog, X, ct = _predict_args(cuda_device, 1000, F, per_member, overflow=overflow)
    instr, nsteps, cvals, Xc = SF._predict_inputs(prog, X, F, ops)
    ok = prog.const_ok.clone()
    ok[::5] = False
    ok = ok.to(torch.int32).contiguous()
    nconst = prog.nconst.to(torch.int32).contiguous()
    k4, k5 = SF.ProgramPredictKernel(), SF.ProgramPredictVjpKernel()
    pk, vk = k4(instr, nsteps, cvals, ok, Xc, ops)
    pk2, vk2 = k4(instr, nsteps, cvals, ok, Xc, ops)
    pp, vp = SF.program_predict_plain(instr, nsteps, cvals, ok, Xc, ops)
    assert torch.equal(pk.view(torch.int32), pk2.view(torch.int32)) and torch.equal(vk, vk2)
    assert torch.equal(vk, vp) and 0 < int(vk.sum()) < vk.numel()
    assert overflow == bool((~torch.isfinite(pk)).any())
    _pred_close(pk, pp)
    gk, xk = k5(instr, nsteps, nconst, cvals, Xc, ct, ops)
    gk2, xk2 = k5(instr, nsteps, nconst, cvals, Xc, ct, ops)
    assert k4.launches == 2 and k5.launches == 2
    gp, xp, gabs = SF.program_predict_vjp_plain(instr, nsteps, nconst, cvals, Xc, ct, ops,
                                                return_abs=True)
    assert torch.equal(gk.view(torch.int32), gk2.view(torch.int32))
    _nonfinite_match(gk, gp)
    both = torch.isfinite(gabs) & torch.isfinite(gk)
    assert bool(((gk - gp).abs()[both] <= 1e-4 * gabs[both]).all())
    assert (xk is None) == (not per_member)
    if per_member:
        assert torch.equal(xk.view(torch.int32), xk2.view(torch.int32))
        _pred_close(xk.reshape(xk.shape[0], -1), xp.reshape(xp.shape[0], -1))


@pytest.mark.cuda
def test_predict_vjp_kernel_accumulates_repeated_arguments(cuda_device):
    """d(x1 * x1) = 2 x1 ct, d(x1 + x1) = 2 ct, d(x1 - x1) = 0 on the card."""
    ops = S.OperatorSet(["+", "-", "*"], ["cos"])
    exprs = ["x1 * x1", "x1 + x1", "x1 - x1"]
    from symbolicregression_jl_tpu_torch.ops.encoding import encode_population

    trees = encode_population([S.parse_expression(e, ops, ["x1"]) for e in exprs], 4, ops,
                              device=cuda_device)
    prog = compile_program(trees, 1, 3)
    g = np.random.default_rng(4)
    X = torch.from_numpy(g.normal(size=(3, 1, 300)).astype(np.float32)).to(cuda_device)
    ct = torch.from_numpy(g.normal(size=(3, 300)).astype(np.float32)).to(cuda_device)
    _, gx = SF.fused_predict_vjp_program(prog, X, ct, 1, ops)
    assert torch.equal(gx[0, 0], 2 * X[0, 0] * ct[0])
    assert torch.equal(gx[1, 0], 2 * ct[1])
    assert not bool(gx[2].any())


def _template_engine(device, **kw):
    from symbolicregression_jl_tpu_torch.models import template_spec

    spec = template_spec(expressions=("f", "g"))(lambda f, g, x1, x2: f(x1) * f(x1) + g(x2))
    opts = _options(("+", "-", "*"), unary_operators=["cos"], expression_spec=spec, turbo=True,
                    **kw)
    g = np.random.default_rng(5)
    X = g.uniform(-2, 2, (300, 2)).astype(np.float32)
    y = ((1.5 * X[:, 0]) ** 2 + np.cos(2 * X[:, 1])).astype(np.float32)
    ds = S.make_dataset(X, y, device=device)
    ds.update_baseline_loss(opts.elementwise_loss)
    return opts, ds, Engine(opts, 2, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("optimize", [False, True])
def test_template_iteration_launches_predict_kernels(cuda_device, optimize):
    """A template iteration scores candidates and the finalize through
    kernel #4 (three call sites per evaluation), and its constant
    optimizer differentiates through kernel #5 (three per gradient pass,
    nine passes); kernels #1-#3 do not run."""
    opts, ds, engine = _template_engine(cuda_device, should_optimize_constants=optimize)
    assert engine.cfg.turbo and engine.template is not None
    state = engine.init_state(rng.key(0, device=cuda_device), ds.data, opts.populations)
    kernels = (SF.PROGRAM_EVAL, SF.PROGRAM_MULTI, SF.PROGRAM_GRAD, SF.PROGRAM_PREDICT,
               SF.PROGRAM_PREDICT_VJP)
    before = [k.launches for k in kernels]
    state = engine.run_iteration(state, ds.data, opts.maxsize)
    torch.cuda.synchronize()
    d = [k.launches - b for k, b in zip(kernels, before)]
    passes = opts.optimizer_iterations + 1
    assert d[:3] == [0, 0, 0]
    assert d[4] == (3 * passes if optimize else 0)
    extra = 3 * (passes + opts.optimizer_iterations) if optimize else 0
    assert d[3] == 3 * (opts.ncycles_per_iteration + 1) + extra
    assert bool(torch.isfinite(state.hof.loss[state.hof.exists]).all())


@pytest.mark.cuda
def test_template_composition_search_on_card(cuda_device):
    """g(f(x1), x2) runs kernels #4 and #5 in per-member mode; one seed
    gives one hall of fame."""
    from symbolicregression_jl_tpu_torch.models import template_spec

    spec = template_spec(expressions=("f", "g"))(lambda f, g, x1, x2: g(f(x1), x2))
    opts = _options(("+", "-", "*"), unary_operators=["cos"], expression_spec=spec,
                    should_optimize_constants=True)
    g = np.random.default_rng(6)
    X = g.uniform(-2, 2, (200, 2)).astype(np.float32)
    y = (np.cos(1.5 * X[:, 0]) * X[:, 1]).astype(np.float32)
    runs = [S.equation_search(X, y, options=opts, niterations=2, seed=0, device=cuda_device)
            for _ in range(2)]
    assert np.isfinite(min(e.loss for e in runs[0].entries))
    assert [e.equation_string() for e in runs[0].entries] == [e.equation_string()
                                                            for e in runs[1].entries]


def _inexact(instr, nsteps, ops):
    """[T] bool: a live step applies a unary operator other than abs, whose
    float32 value two implementations may round an ULP apart."""
    tab = torch.tensor(SF._optab_list(ops), device=instr.device)
    mask = 0x3F if SF._dispatch_plan(ops).merged else 0x7F
    entry = tab[((instr >> 24) & mask).long()]
    live = torch.arange(instr.shape[1], device=instr.device)[None, :] < nsteps[:, None]
    unary = ((entry >> 8) == SF._K_UNARY) & ((entry & 0xFF) != SF._KERNEL_OP_IDS["abs"])
    return (live & unary).any(dim=1)


def _bf16_close(a, b, inexact):
    """bf16 results: NaN and +-inf in the same places; trees of exact
    operators (+ - * / abs) within rtol 1e-5, since both sides store the
    same bf16 bits and only the row sums' order differs; the others with a
    median relative error below 1e-4 and every one within 1e-2, since an
    ULP of a transcendental can flip one bf16 rounding (2^-8 relative)."""
    _nonfinite_match(a, b)
    ex = ~inexact.reshape(inexact.shape + (1,) * (a.dim() - 1)).expand_as(a)
    fin = torch.isfinite(b)
    torch.testing.assert_close(a[fin & ex], b[fin & ex], rtol=RTOL, atol=0)
    sel = fin & ~ex
    rel = ((a - b).abs() / b.abs().clamp(min=1e-30))[sel]
    if rel.numel():
        assert float(rel.median()) < 1e-4 and float(rel.max()) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [("+", "-", "*", "/"), ("*", "/", "-")])
@pytest.mark.parametrize("n", [257, 10_000])
def test_bf16_kernels_match_plain_versions(cuda_device, binary, n):
    """Kernel 1b (cost, plain and parametric forms) and 2b against their
    plain bf16 versions on the card: validity bit-equal, results within
    ``_bf16_close``, two launches bit-identical, one count per launch on
    their own wrappers; 2b with V = 1 bit-equal to 1b's plain form."""
    ops, args, cx, scal = _launch_args(cuda_device, binary, n)
    args = args[:4] + (SF._bf16_rows(args[4]),) + args[5:]
    inexact = _inexact(args[0], args[1], ops)
    k1b = SF.ProgramEvalBf16Kernel()
    before = SF.PROGRAM_EVAL.launches
    lk, vk = k1b(*args, ops, SL.l2_dist_loss)
    lk2, vk2 = k1b(*args, ops, SL.l2_dist_loss)
    lck, vck, ck = k1b(*args, ops, SL.l2_dist_loss, cx=cx, scal=scal)
    assert k1b.launches == 3 and SF.PROGRAM_EVAL.launches == before
    lp, vp = SF.program_eval_plain(*args, ops, SL.l2_dist_loss, bf16=True)
    lcp, vcp, cp = SF.program_eval_plain(*args, ops, SL.l2_dist_loss, cx=cx, scal=scal,
                                         bf16=True)
    assert torch.equal(lk.view(torch.int32), lk2.view(torch.int32)) and torch.equal(vk, vk2)
    assert torch.equal(vk, vp) and torch.equal(vck, vcp)
    _bf16_close(torch.where(vp, lk, torch.inf), torch.where(vp, lp, torch.inf), inexact)
    _bf16_close(lck, lcp, inexact)
    _bf16_close(ck, cp, inexact)

    pops, pargs = _param_args(cuda_device, binary, n)
    pargs = pargs[:6] + (SF._bf16_rows(pargs[6]),) + pargs[7:]
    kp = SF.ProgramEvalParamBf16Kernel()
    pk, pv = kp(*pargs, pops, SL.l2_dist_loss)
    pk2, _ = kp(*pargs, pops, SL.l2_dist_loss)
    assert kp.launches == 2
    qk, qv = SF.program_eval_plain(*pargs[:4], *pargs[6:], pops, SL.l2_dist_loss, bank=pargs[4],
                                   class_idx=pargs[5], bf16=True)
    assert torch.equal(pk.view(torch.int32), pk2.view(torch.int32)) and torch.equal(pv, qv)
    _bf16_close(torch.where(qv, pk, torch.inf), torch.where(qv, qk, torch.inf),
                _inexact(pargs[0], pargs[1], pops))

    mops, instr, nsteps, _, cv, X, y, w, cvals = _multi_args(cuda_device, binary, n, 5)
    Xb = SF._bf16_rows(X)
    k2b = SF.ProgramMultiBf16Kernel()
    mk, mv = k2b(instr, nsteps, cv, Xb, y, w, mops, SL.l2_dist_loss)
    mk2, _ = k2b(instr, nsteps, cv, Xb, y, w, mops, SL.l2_dist_loss)
    mp, mvp = SF.program_multi_plain(instr, nsteps, cv, Xb, y, w, mops, SL.l2_dist_loss,
                                     bf16=True)
    assert torch.equal(mk.view(torch.int32), mk2.view(torch.int32)) and torch.equal(mv, mvp)
    _bf16_close(torch.where(mvp, mk, torch.inf), torch.where(mvp, mp, torch.inf),
                _inexact(instr, nsteps, mops))
    ones = torch.ones(instr.shape[0], dtype=torch.int32, device=cuda_device)
    l1, v1 = k2b(instr, nsteps, cvals[:, None, :].contiguous(), Xb, y, w, mops, SL.l2_dist_loss)
    l1e, v1e = SF.ProgramEvalBf16Kernel()(instr, nsteps, cvals, ones, Xb, y, w, mops,
                                          SL.l2_dist_loss)
    assert torch.equal(l1[:, 0].view(torch.int32), l1e.view(torch.int32))
    assert torch.equal(v1[:, 0], v1e) and k2b.launches == 3


@pytest.mark.cuda
def test_graftstage_engine_launches_bf16_kernels(cuda_device):
    """Staged bf16 candidate evals are a screen and a rescore per cycle on
    kernel 1b, plus the finalize's plain form (no dedup under bf16); the
    bf16 line search is kernel 2b once per L-BFGS iteration, its gradient
    kernel #3 as before; kernels #1 and #2 do not run."""
    opts = _options(should_optimize_constants=True, staged_eval=True, eval_precision="bf16",
                    optimizer_bf16_linesearch=True)
    g = np.random.default_rng(1)
    X = g.uniform(-3, 3, (3000, 3)).astype(np.float32)
    y = (X[:, 0] * X[:, 0] + np.cos(X[:, 1])).astype(np.float32)
    ds = S.make_dataset(X, y, device=cuda_device)
    ds.update_baseline_loss(opts.elementwise_loss)
    engine = Engine(opts, 3, device=cuda_device)
    assert engine.opt_cfg.ls_bf16 and engine.cfg.staged_eval and engine.cfg.eval_bf16
    state = engine.init_state(rng.key(0, device=cuda_device), ds.data, opts.populations)
    kernels = (SF.PROGRAM_EVAL, SF.PROGRAM_EVAL_BF16, SF.PROGRAM_MULTI, SF.PROGRAM_MULTI_BF16,
               SF.PROGRAM_GRAD)
    before = [k.launches for k in kernels]
    state = engine.run_iteration(state, ds.data, opts.maxsize)
    torch.cuda.synchronize()
    iters = opts.optimizer_iterations
    assert [k.launches - b for k, b in zip(kernels, before)] == [
        0, 2 * opts.ncycles_per_iteration + 1, 0, iters, iters + 1]
    assert bool(torch.isfinite(state.hof.loss[state.hof.exists]).all())


# ---------------------------------------------------------------------------
# The tile interpreter of kernels #1 and #2 (csrc/interp.cuh): the edges of
# its row tiles and the bit contracts the lane order keeps.
# ---------------------------------------------------------------------------

TILE_CASES = {
    # n not a multiple of the lanes (256) or of the rows per thread (4)
    "ragged": dict(n=1001, nlength=6),
    # fewer rows than lanes: one partial tile, most lanes empty
    "n_below_lanes": dict(n=100, nlength=6),
    # a minibatch (batch_size 50, the Options default) and a single row
    "batch_50": dict(n=50, nlength=6),
    "one_row": dict(n=1, nlength=6),
    # graftstage's screening sample of a 10,000-row dataset
    "sample_1250": dict(n=1250, nlength=8),
    # one step per tree: its result is the root, nothing is stored
    "one_step": dict(n=512, nlength=1),
    "zero_weights": dict(n=300, nlength=6, zero_weights=True),
    # every seventh tree's first constant inf, every thirteenth's NaN
    "nonfinite_const": dict(n=777, nlength=6, nonfinite_const=True),
}


def _tile_args(device, n: int, nlength: int, zero_weights=False, nonfinite_const=False,
               T: int = 256):
    """Random trees of + - * / abs (exact operators, so the bf16 forms agree
    with their plain versions within rtol 1e-5) over 3 features, every 97th
    row's X at +-1e20, a tenth of the weights 0 (all of them with
    ``zero_weights``)."""
    opts = S.Options(binary_operators=["+", "-", "*", "/"], unary_operators=["abs"], maxsize=30,
                     populations=4, population_size=32, tournament_selection_n=8,
                     should_optimize_constants=False, save_to_file=False)
    cfg = evolve_config_from_options(opts, 3, device)
    trees = init_population(rng.split(rng.key(11, device=device), T // 64), 64, cfg.mctx,
                            nlength=nlength).reshape(-1)
    g = np.random.default_rng(n)
    Xn = g.uniform(-3, 3, (3, n)).astype(np.float32)
    Xn[:, ::97] = 1e20 * np.sign(g.normal(size=Xn[:, ::97].shape))
    wn = np.where(g.random(n) < 0.1, 0.0, g.uniform(0.2, 2, n)).astype(np.float32)
    if zero_weights:
        wn[:] = 0.0
    X = torch.from_numpy(Xn).to(device)
    y = torch.from_numpy(g.normal(size=n).astype(np.float32)).to(device)
    w = torch.from_numpy(wn).to(device)
    prog = compile_program(trees, 3, len(opts.operators.binary))
    instr, nsteps, cvals, ok, X, y, w = SF._launch_inputs(prog, X, y, w, 3, opts.operators)
    if nonfinite_const:
        cvals = cvals.clone()
        cvals[::7, 0] = torch.inf
        cvals[::13, 0] = torch.nan
        ok = torch.isfinite(cvals).all(dim=1).to(torch.int32)
    cx = torch.arange(1, T + 1, dtype=torch.float32, device=device)
    scal = torch.stack([w.sum().clamp(min=1.0), torch.tensor(1.7, device=device),
                        torch.tensor(0.0032, device=device)])
    return opts.operators, prog, (instr, nsteps, cvals, ok, X, y, w), cx, scal


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_tile_kernels_hold_their_contracts(cuda_device, case):
    """Kernels #1, 1b, #2 and 2b (the tile interpreter) on the tiles'
    edges: each against its plain version (validity bit-equal; sums within
    rtol 1e-5 with NaN and +-inf in the same places, the rows being summed
    in another order); two launches bit-identical; #1's cost form equal to
    its plain form + loss_to_cost's operations, bit for bit; #2 with V = 1
    equal to #1's plain form and 2b with V = 1 equal to 1b's, bit for bit;
    #3's loss equal to #2's on the same constant vectors, bit for bit."""
    ops, prog, args, cx, scal = _tile_args(cuda_device, **TILE_CASES[case])
    instr, nsteps, cvals, ok, X, y, w = args
    T = instr.shape[0]
    loss = SL.l2_dist_loss
    k1, k1b, k2, k2b = (SF.ProgramEvalKernel(), SF.ProgramEvalBf16Kernel(),
                        SF.ProgramMultiKernel(), SF.ProgramMultiBf16Kernel())

    lk, vk = k1(*args, ops, loss)
    lk2, vk2 = k1(*args, ops, loss)
    lck, vck, ck = k1(*args, ops, loss, cx=cx, scal=scal)
    assert k1.launches == 3
    assert torch.equal(_bits(lk), _bits(lk2)) and torch.equal(vk, vk2)
    lp, vp = SF.program_eval_plain(*args, ops, loss)
    lcp, vcp, cp = SF.program_eval_plain(*args, ops, loss, cx=cx, scal=scal)
    assert torch.equal(vk, vp) and torch.equal(vck, vcp)
    _nonfinite_match(lk, lp)
    _close(torch.where(vp, lk, torch.inf), torch.where(vp, lp, torch.inf))
    _close(lck, lcp)
    _close(ck, cp)
    mean = lk / scal[0]
    loss_ref = torch.where(vk & torch.isfinite(mean), mean, torch.inf)
    assert torch.equal(_bits(lck), _bits(loss_ref))
    assert torch.equal(_bits(ck), _bits(loss_ref / scal[1] + scal[2] * cx))

    argsb = args[:4] + (SF._bf16_rows(X),) + args[5:]
    inexact = torch.zeros(T, dtype=torch.bool, device=cuda_device)
    bk, bv = k1b(*argsb, ops, loss)
    bk2, bv2 = k1b(*argsb, ops, loss)
    assert torch.equal(_bits(bk), _bits(bk2)) and torch.equal(bv, bv2)
    bp, bvp = SF.program_eval_plain(*argsb, ops, loss, bf16=True)
    assert torch.equal(bv, bvp)
    _bf16_close(torch.where(bvp, bk, torch.inf), torch.where(bvp, bp, torch.inf), inexact)

    ones = torch.ones(T, dtype=torch.int32, device=cuda_device)
    l1e, v1e = k1(instr, nsteps, cvals, ones, X, y, w, ops, loss)
    b1e, bv1e = k1b(instr, nsteps, cvals, ones, argsb[4], y, w, ops, loss)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for V in (1, 24):
        cv = (cvals[:, None, :] * (1.0 + 0.5 * torch.randn((T, V, cvals.shape[1]), generator=gen,
                                                           device=cuda_device))).contiguous()
        if V == 1:
            cv = cvals[:, None, :].contiguous()
        else:
            cv[::5, 3, 0] = torch.nan
        mk, mv = k2(instr, nsteps, cv, X, y, w, ops, loss)
        mk2, mv2 = k2(instr, nsteps, cv, X, y, w, ops, loss)
        assert torch.equal(_bits(mk), _bits(mk2)) and torch.equal(mv, mv2)
        mp, mvp = SF.program_multi_plain(instr, nsteps, cv, X, y, w, ops, loss)
        assert torch.equal(mv, mvp)
        _close(torch.where(mvp, mk, torch.inf), torch.where(mvp, mp, torch.inf))
        nk, nv = k2b(instr, nsteps, cv, argsb[4], y, w, ops, loss)
        np_, nvp = SF.program_multi_plain(instr, nsteps, cv, argsb[4], y, w, ops, loss, bf16=True)
        assert torch.equal(nv, nvp)
        _bf16_close(torch.where(nvp, nk, torch.inf), torch.where(nvp, np_, torch.inf), inexact)
        if V == 1:
            assert torch.equal(_bits(mk[:, 0]), _bits(l1e)) and torch.equal(mv[:, 0], v1e)
            assert torch.equal(_bits(nk[:, 0]), _bits(b1e)) and torch.equal(nv[:, 0], bv1e)
    cv3 = (cvals[:, None, :] * (1.0 + 0.5 * torch.randn((T, 3, cvals.shape[1]), generator=gen,
                                                        device=cuda_device))).contiguous()
    gl, gv, _ = SF.ProgramGradKernel()(instr, nsteps, prog.nconst.to(torch.int32).contiguous(),
                                       cv3, X, y, w, ops, loss)
    ml, mv3 = k2(instr, nsteps, cv3, X, y, w, ops, loss)
    assert torch.equal(_bits(gl), _bits(ml)) and torch.equal(gv, mv3)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 1001, 1250])
def test_tile_param_kernel_with_nonfinite_bank(cuda_device, n):
    """#1p and its bf16 form on the tiles' edges, every eleventh tree's bank
    +inf for class 2 only (and class indices outside [0, NC) clipped):
    validity bit-equal to the plain version, sums NaN and +-inf in the same
    places and within rtol 1e-5 on valid trees; two launches bit-identical."""
    ops, args = _param_args(cuda_device, ("+", "-", "*", "/"), n)
    args = list(args)
    g = np.random.default_rng(n)
    args[5] = torch.from_numpy(g.integers(-1, 4, n).astype(np.int32)).to(cuda_device)
    kernel = SF.ProgramEvalParamKernel()
    lk, vk = kernel(*args, ops, SL.l2_dist_loss)
    lk2, vk2 = kernel(*args, ops, SL.l2_dist_loss)
    assert torch.equal(_bits(lk), _bits(lk2)) and torch.equal(vk, vk2)
    lp, vp = SF.program_eval_plain(*args[:4], *args[6:], ops, SL.l2_dist_loss, bank=args[4],
                                   class_idx=args[5])
    assert torch.equal(vk, vp) and 0 < int(vk.sum()) < vk.numel()
    _nonfinite_match(lk, lp)
    _close(torch.where(vp, lk, torch.inf), torch.where(vp, lp, torch.inf))
    bargs = args[:6] + [SF._bf16_rows(args[6])] + args[7:]
    kb = SF.ProgramEvalParamBf16Kernel()
    bk, bv = kb(*bargs, ops, SL.l2_dist_loss)
    bk2, _ = kb(*bargs, ops, SL.l2_dist_loss)
    assert torch.equal(_bits(bk), _bits(bk2))
    bp, bvp = SF.program_eval_plain(*bargs[:4], *bargs[6:], ops, SL.l2_dist_loss,
                                    bank=bargs[4], class_idx=bargs[5], bf16=True)
    assert torch.equal(bv, bvp)
    _bf16_close(torch.where(bvp, bk, torch.inf), torch.where(bvp, bp, torch.inf),
                _inexact(bargs[0], bargs[1], ops))


@pytest.mark.cuda
def test_tile_bf16_overflow_at_the_store(cuda_device):
    """A step whose float32 value is finite but past bf16's rounding edge
    (3.3961e38) stores inf with the step still finite: at the root it
    surfaces in the loss, under `- x1` in the next step. 1b and 2b (V = 1
    and V = 24) give their plain versions' validity, and float32 keeps all
    four trees valid."""
    from symbolicregression_jl_tpu_torch.ops.encoding import encode_population
    from symbolicregression_jl_tpu_torch.ops.tree import parse_expression

    ops = S.OperatorSet(["+", "-", "*"], ["cos"])
    exprs = ["x1 * 2.84375", "(x1 * 2.84375) - x1", "x1 * x2", "cos(x1) + 0.5"]
    trees = encode_population([parse_expression(e, ops, ["x1", "x2"]) for e in exprs], 8, ops,
                              device=cuda_device)
    g = np.random.default_rng(4)
    Xn = g.uniform(-2, 2, (2, 300)).astype(np.float32)
    Xn[0, 5] = np.float32(1.40625 * 2.0 ** 126)
    X = torch.from_numpy(Xn).to(cuda_device)
    y = torch.from_numpy(g.normal(size=300).astype(np.float32)).to(cuda_device)
    prog = compile_program(trees, 2, 3)
    args = SF._launch_inputs(prog, X, y, None, 2, ops, bf16=True)
    lk, vk = SF.ProgramEvalBf16Kernel()(*args, ops, SL.l1_dist_loss)
    lp, vp = SF.program_eval_plain(*args, ops, SL.l1_dist_loss, bf16=True)
    assert vk.tolist() == vp.tolist() == [False, False, True, True]
    _nonfinite_match(lk, lp)
    instr, nsteps, cvals, _, Xb, yc, w = args
    for V in (1, 24):
        cv = cvals[:, None, :].expand(-1, V, -1).contiguous()
        mk, mv = SF.ProgramMultiBf16Kernel()(instr, nsteps, cv, Xb, yc, w, ops, SL.l1_dist_loss)
        assert mv.tolist() == [[False] * V, [False] * V, [True] * V, [True] * V]
        assert torch.equal(_bits(mk[:, 0]), _bits(lk))
    args32 = SF._launch_inputs(prog, X, y, None, 2, ops)
    _, v32 = SF.ProgramEvalKernel()(*args32, ops, SL.l1_dist_loss)
    assert v32.tolist() == [True] * 4


# ---------------------------------------------------------------------------
# Kernels #3 and #4 on the tile interpreter (csrc/program_grad.cu,
# csrc/program_predict.cu): the tiles' edges, V = 1 and 24, per-member X,
# constant-only trees and one-step programs.
# ---------------------------------------------------------------------------

GRAD_CASES = {
    # n not a multiple of the lanes (256) or of the rows per thread (4)
    "ragged": dict(n=1001, nlength=6),
    # fewer rows than lanes: one partial tile
    "n_below_lanes": dict(n=100, nlength=6),
    # a minibatch (batch_size 50, the Options default) and a single row
    "batch_50": dict(n=50, nlength=6),
    "one_row": dict(n=1, nlength=(2, 8, 16)),
    # one step per tree: its result is the root
    "one_step": dict(n=512, nlength=1),
    # trees of every step-count class of csrc/program_grad.cu in one call
    # (m <= 4, 5-12 and 13 or more steps)
    "step_classes": dict(n=777, nlength=(2, 8, 16)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_tile_grad_kernel_holds_its_contracts(cuda_device, case):
    """Kernel #3 (the tile interpreter with its reverse sweep) at V = 1, 3
    and 24 on random and written trees (+ - * / cos abs exp, every 97th
    row's X at +-1e20, a tenth of the weights 0, a few constants NaN):
    validity bit-equal to the plain version; loss sums within rtol 1e-5
    with NaN and +-inf in the same places; gradients of valid pairs
    non-finite in the same places (but where the finite terms' absolute sum
    overflows, which the order of the sum decides) and otherwise within
    1e-4 of the sum of the absolute per-row terms; loss and validity equal
    to kernel #2's on the same constant vectors, bit for bit; two launches
    bit-identical."""
    spec = GRAD_CASES[case]
    n = spec["n"]
    opts = _options(maxsize=30)
    ops, loss = opts.operators, SL.l2_dist_loss
    cfg = evolve_config_from_options(opts, 3, cuda_device)
    trees = with_written(random_trees(13, 4, 64, cfg.mctx, spec["nlength"], cuda_device), ops, 3)
    T = trees.arity.shape[0]
    g = np.random.default_rng(n)
    Xn = g.uniform(-3, 3, (3, n)).astype(np.float32)
    Xn[:, ::97] = 1e20 * np.sign(g.normal(size=Xn[:, ::97].shape))
    wn = np.where(g.random(n) < 0.1, 0.0, g.uniform(0.2, 2, n)).astype(np.float32)
    prog = compile_program(trees, 3, len(ops.binary))
    instr, nsteps, cvals, _, X, y, w = SF._launch_inputs(
        prog, torch.from_numpy(Xn).to(cuda_device),
        torch.from_numpy(g.normal(size=n).astype(np.float32)).to(cuda_device),
        torch.from_numpy(wn).to(cuda_device), 3, ops)
    nconst = prog.nconst.to(torch.int32).contiguous()
    k2, k3 = SF.ProgramMultiKernel(), SF.ProgramGradKernel()
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for V in (1, 3, 24):
        cv = cvals[:, None, :].expand(-1, V, -1).contiguous()
        if V > 1:
            cv = (cv * (1.0 + 0.5 * torch.randn(cv.shape, generator=gen, device=cuda_device)))
            cv[::5, V // 2, 0] = torch.nan
            cv = cv.contiguous()
        gl, gv, gg = k3(instr, nsteps, nconst, cv, X, y, w, ops, loss)
        gl2, gv2, gg2 = k3(instr, nsteps, nconst, cv, X, y, w, ops, loss)
        assert torch.equal(_bits(gl), _bits(gl2)) and torch.equal(gv, gv2)
        assert torch.equal(_bits(gg), _bits(gg2))
        ml, mv = k2(instr, nsteps, cv, X, y, w, ops, loss)
        assert torch.equal(_bits(gl), _bits(ml)) and torch.equal(gv, mv)
        pl, pv, pg, pabs = SF.program_grad_plain(instr, nsteps, nconst, cv, X, y, w, ops, loss,
                                                 return_abs=True)
        assert torch.equal(gv, pv) and 0 < int(pv.sum()) < pv.numel()
        _close(torch.where(pv, gl, torch.inf), torch.where(pv, pl, torch.inf))
        live = pv[..., None].expand_as(pg)
        fin_k, fin_p = torch.isfinite(gg), torch.isfinite(pg)
        # Where the absolute per-row terms of a component sum past float32's
        # range (pabs inf) while every term is finite, the order of the terms
        # decides whether the sum overflows: one side may be +-inf where the
        # other is finite. Everywhere else finiteness must agree.
        order = torch.isinf(pabs) & (torch.isinf(gg) ^ torch.isinf(pg))
        order &= ~(torch.isnan(gg) | torch.isnan(pg))
        assert torch.equal(fin_k[live & ~order], fin_p[live & ~order])
        both = live & fin_k & fin_p
        assert bool(((gg - pg).abs()[both] <= 1e-4 * pabs[both]).all())
    assert k3.launches == 6 and T > 256


PREDICT_TILE_CASES = {
    "shared_ragged": dict(n=1001, F=1, per_member=False),
    "shared_n_below_lanes": dict(n=100, F=3, per_member=False),
    "per_member_ragged": dict(n=203, F=2, per_member=True),
    "per_member_aligned": dict(n=512, F=2, per_member=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PREDICT_TILE_CASES))
def test_tile_predict_kernel_holds_its_contracts(cuda_device, case):
    """Kernel #4 on the tile interpreter, random and written trees of + - *
    cos, every fifth tree's const_ok cleared, every 97th row's X at +-1e20
    (in every seventh tree's X when per-member): validity bit-equal to the
    plain version; predictions close (``_pred_close``); two launches
    bit-identical."""
    spec = PREDICT_TILE_CASES[case]
    n, F, per_member = spec["n"], spec["F"], spec["per_member"]
    opts = _options(("+", "-", "*"), unary_operators=["cos"], maxsize=30)
    ops = opts.operators
    cfg = evolve_config_from_options(opts, F, cuda_device)
    trees = with_written(random_trees(17, 4, 64, cfg.mctx, 5, cuda_device), ops, F)
    T = trees.arity.shape[0]
    prog = compile_program(trees, F, len(ops.binary))
    g = np.random.default_rng(n + F)
    Xn = g.uniform(-2, 2, (T, F, n) if per_member else (F, n)).astype(np.float32)
    big = Xn[::7, :, ::97] if per_member else Xn[:, ::97]
    big[...] = np.where(big < 0, -1e20, 1e20)
    instr, nsteps, cvals, X = SF._predict_inputs(prog, torch.from_numpy(Xn).to(cuda_device), F,
                                                 ops)
    ok = prog.const_ok.to(torch.int32).clone()
    ok[::5] = 0
    k4 = SF.ProgramPredictKernel()
    pk, vk = k4(instr, nsteps, cvals, ok, X, ops)
    pk2, vk2 = k4(instr, nsteps, cvals, ok, X, ops)
    assert torch.equal(_bits(pk), _bits(pk2)) and torch.equal(vk, vk2)
    pp, vp = SF.program_predict_plain(instr, nsteps, cvals, ok, X, ops)
    assert torch.equal(vk, vp) and 0 < int(vp.sum()) < T
    _pred_close(pk, pp)
    assert k4.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("per_member,F", [(False, 1), (True, 2)])
def test_tile_predict_vjp_kernel_on_step_classes(cuda_device, per_member, F):
    """Kernel #5 on the tile interpreter's reverse sweep, on random trees of
    + - * cos in all three step-count classes (m <= 4, 5-12 and 13 or more
    steps) and the written ones, every 97th row's X at +-1e20 (in every
    seventh tree's X when per-member), random cotangents: gcomp non-finite
    in the same places as the plain version's (but where the absolute terms
    overflow, which the order of the sum decides) and otherwise within 1e-4
    of the absolute row sums; gx close
    (``_pred_close``); two launches bit-identical; one launch count per
    call."""
    n = 777
    opts = _options(("+", "-", "*"), unary_operators=["cos"], maxsize=30)
    ops = opts.operators
    cfg = evolve_config_from_options(opts, F, cuda_device)
    trees = with_written(random_trees(23, 4, 64, cfg.mctx, (2, 8, 16), cuda_device), ops, F)
    T = trees.arity.shape[0]
    prog = compile_program(trees, F, len(ops.binary))
    g = np.random.default_rng(n + F)
    Xn = g.uniform(-2, 2, (T, F, n) if per_member else (F, n)).astype(np.float32)
    big = Xn[::7, :, ::97] if per_member else Xn[:, ::97]
    big[...] = np.where(big < 0, -1e20, 1e20)
    instr, nsteps, cvals, X = SF._predict_inputs(prog, torch.from_numpy(Xn).to(cuda_device), F,
                                                 ops)
    ct = torch.from_numpy(g.normal(size=(T, n)).astype(np.float32)).to(cuda_device)
    nconst = prog.nconst.to(torch.int32).contiguous()
    m = nsteps.cpu()
    assert bool((m <= 4).any()) and bool(((m > 4) & (m <= 12)).any()) and bool((m > 12).any())
    k5 = SF.ProgramPredictVjpKernel()
    gk, xk = k5(instr, nsteps, nconst, cvals, X, ct, ops)
    gk2, xk2 = k5(instr, nsteps, nconst, cvals, X, ct, ops)
    assert k5.launches == 2
    assert torch.equal(_bits(gk), _bits(gk2))
    gp, xp, gabs = SF.program_predict_vjp_plain(instr, nsteps, nconst, cvals, X, ct, ops,
                                                return_abs=True)
    # Where the absolute per-row terms overflow (gabs inf), the order of the
    # sum decides between finite, +-inf and NaN; everywhere else the
    # non-finite places agree.
    order = torch.isinf(gabs)
    assert torch.equal(torch.isfinite(gk)[~order], torch.isfinite(gp)[~order])
    assert torch.equal(torch.isnan(gk)[~order], torch.isnan(gp)[~order])
    assert bool(torch.isfinite(gk).any())
    both = torch.isfinite(gabs) & torch.isfinite(gk)
    assert bool(((gk - gp).abs()[both] <= 1e-4 * gabs[both]).all())
    assert (xk is None) == (not per_member)
    if per_member:
        assert torch.equal(_bits(xk), _bits(xk2))
        _pred_close(xk.reshape(T, -1), xp.reshape(T, -1))
