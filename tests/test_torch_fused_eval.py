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
from symbolicregression_jl_tpu_torch.ops.program import compile_program

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
        jax.tree.map(np.asarray, jt))


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
    st = interop.tree_batch(jax.tree.map(np.asarray, jt))
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
                                 MAXSIZE, sops)
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

