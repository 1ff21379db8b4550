"""Tests of the port's CUDA kernels; they need an NVIDIA card and skip
without one.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

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
