"""graftstage in the port against the JAX package, on the CPU.

Staged sample-then-rescore evaluation and bf16 value buffers
(``docs/PRECISION.md``). Inputs are made with numpy from a seed (or carried
across with ``interop``) and handed to both packages. On the JAX side the
Pallas kernels run in interpret mode (with one tree per block, a smaller
kernel to compile); on the port's side the kernel
wrappers run their plain PyTorch versions (kernels 1b and 2b are held
against those on a card in tests/test_torch_cuda.py). Each tolerance is
stated where it is used.

bf16 is rank-reliable, not bit-exact: both packages compute every step in
float32 and round the stored value to bf16 (round to nearest even), so on
trees of ``+ - * /`` (correctly rounded in both) the stored values are the
same bits and only the row sums' order differs (rtol 1e-5). A
transcendental that differs by an ULP in float32 can flip one bf16
rounding, so such trees are held to the rank contract of
tests/test_staged_eval.py and a looser stated tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.core import losses as JL
from symbolicregression_jl_tpu.evolve import constant_opt as JC
from symbolicregression_jl_tpu.evolve import step as JS
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu.evolve.population import init_population as j_init_population
from symbolicregression_jl_tpu.models import ParametricExpressionSpec as JSpec
from symbolicregression_jl_tpu.ops import encoding as JE
from symbolicregression_jl_tpu.ops import fused_eval as JF
from symbolicregression_jl_tpu.ops import program as JP
from symbolicregression_jl_tpu.ops.complexity import build_complexity_tables as j_tables
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.core import losses as SL
from symbolicregression_jl_tpu_torch.evolve import constant_opt as SC
from symbolicregression_jl_tpu_torch.evolve import rng as SR
from symbolicregression_jl_tpu_torch.evolve import step as SS
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine
from symbolicregression_jl_tpu_torch.models import ParametricExpressionSpec as SSpec
from symbolicregression_jl_tpu_torch.ops import fused_eval as SF
from symbolicregression_jl_tpu_torch.ops import program as SP
from symbolicregression_jl_tpu_torch.ops.complexity import build_complexity_tables as s_tables

from torch_parity import assert_close, assert_pops_equal, port_key, problem, to_np

RTOL = 1e-5
MAXSIZE = 15
BINARY, UNARY = ["+", "-", "*", "/"], ["cos", "exp"]
NP, NC = 2, 3


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# Sample geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(10_000, 1250), (7, 100), (257, 64), (1000, 999), (5, 1)])
def test_strided_sample_indices_equal_jax(n, k):
    want = JF.strided_sample_indices(n, k)
    got = SF.strided_sample_indices(n, k)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(want, got)


def _cfgs(**kw):
    base = dict(binary_operators=["+", "*"], unary_operators=["cos"], maxsize=10,
                save_to_file=False)
    base.update(kw)
    return (JS.evolve_config_from_options(J.Options(**base), 2),
            SS.evolve_config_from_options(S.Options(**base), 2, torch.device("cpu")))


@pytest.mark.parametrize("kw", [
    dict(staged_eval=True),
    dict(staged_eval=True, staged_sample_fraction=0.01),     # the floor of 64 rows
    dict(staged_eval=True, staged_sample_rows=777),          # explicit size
    dict(staged_eval=True, staged_sample_rows=5000, eval_tile_rows=2048),  # the tile cap
    dict(staged_eval=True, staged_sample_fraction=0.5, eval_tile_rows=100),
    dict(staged_eval=True, staged_sample_fraction=1.0),
])
def test_resolve_sample_rows_equal_jax(kw):
    jcfg, scfg = _cfgs(**kw)
    assert scfg.eval_tile_rows == jcfg.eval_tile_rows
    for n in (1, 32, 63, 64, 100, 257, 1000, 4096, 10_000, 100_000):
        assert SS.resolve_sample_rows(scfg, n) == JS.resolve_sample_rows(jcfg, n), n
    assert SS.MIN_SAMPLE_ROWS == JS.MIN_SAMPLE_ROWS


@pytest.mark.parametrize("fraction", [0.01, 0.25, 0.3, 1.0])
def test_rescore_count_equal_jax(fraction):
    jcfg, scfg = _cfgs(staged_eval=True, rescore_fraction=fraction)
    for n in (1, 2, 3, 7, 16, 17, 64, 257, 4096):
        assert SS.rescore_count(scfg, n) == JS.rescore_count(jcfg, n), n


def test_evolve_config_carries_graftstage_fields():
    jcfg, scfg = _cfgs(eval_precision="bf16", staged_eval=True, staged_sample_rows=300,
                       staged_sample_fraction=0.2, rescore_fraction=0.4)
    for f in ("eval_bf16", "staged_eval", "staged_sample_rows", "staged_sample_fraction",
              "rescore_fraction", "eval_tile_rows"):
        assert getattr(scfg, f) == getattr(jcfg, f), f
    jcfg, scfg = _cfgs()
    assert not scfg.eval_bf16 and not scfg.staged_eval and scfg.staged_sample_rows == 0


# ---------------------------------------------------------------------------
# Kernel 1b's plain version against the JAX kernel's bf16 form
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_batch():
    """64 random trees over + - * / cos exp (maxsize 15) and data, in both
    packages; ``exact`` marks the trees without a unary operator."""
    jo = J.Options(binary_operators=BINARY, unary_operators=UNARY, maxsize=MAXSIZE,
                   save_to_file=False)
    cfg = JS.evolve_config_from_options(jo, 3)
    jt = j_init_population(jax.random.key(11), 64, cfg.mctx, jnp.float32)
    st = interop.tree_batch(jax.tree.map(np.asarray, jt), device="cpu")
    live = np.arange(MAXSIZE)[None, :] < to_np(jt.length)[:, None]
    exact = ~(live & (to_np(jt.arity) == 1)).any(axis=1)
    rng = np.random.default_rng(3)
    X = rng.uniform(-3, 3, (3, 257)).astype(np.float32)
    y = rng.normal(size=257).astype(np.float32)
    w = rng.uniform(0.2, 2.0, 257).astype(np.float32)
    w[::9] = 0.0
    return cfg.operators, S.OperatorSet(BINARY, UNARY), jt, st, exact, X, y, w


def _assert_bf16_agrees(want, got, exact, what):
    """Trees of + - * /: within RTOL (the row sums' order). Transcendental
    trees: finite in the same places, median relative error below 1e-4
    and every one within 1e-2 (a flipped bf16 rounding moves a step by
    2^-8 relative at most, and the trees here hold a few transcendental
    steps)."""
    want, got = np.asarray(want), np.asarray(got)
    assert_close(want[exact], got[exact], RTOL, what + " (+ - * / trees)")
    a, b = want[~exact], got[~exact]
    assert np.array_equal(np.isfinite(a), np.isfinite(b)), what
    ok = np.isfinite(a)
    rel = np.abs(a[ok] - b[ok]) / np.maximum(np.abs(a[ok]), 1e-30)
    assert np.median(rel) < 1e-4 and rel.max() < 1e-2, (what, np.median(rel), rel.max())


def _rank_contract(f32, b16):
    """tests/test_staged_eval.py's contract of bf16 against f32: finite
    verdicts agree on 90%, median relative error below 0.02, top-quartile
    overlap at least 75%."""
    a, b = np.asarray(f32), np.asarray(b16)
    ok = np.isfinite(a) & np.isfinite(b)
    assert ok.sum() >= 0.9 * len(a)
    rel = np.abs(b[ok] - a[ok]) / (np.abs(a[ok]) + 1e-6)
    assert np.median(rel) < 0.02
    k = max(1, int(ok.sum()) // 4)
    top32 = set(np.argsort(np.where(ok, a, np.inf))[:k])
    top16 = set(np.argsort(np.where(ok, b, np.inf))[:k])
    assert len(top32 & top16) >= 0.75 * k


def test_bf16_plain_form_matches_jax(bf16_batch):
    jops, sops, jt, st, exact, X, y, w = bf16_batch
    assert exact.sum() >= 8 and (~exact).sum() >= 8
    jl, jv = JF.fused_loss(jt, _j(X), _j(y), _j(w), jops, JL.l2_dist_loss, interpret=True,
                           bf16=True, tree_block=1)
    sl, sv = SF.fused_loss(st, _t(X), _t(y), _t(w), sops, SL.l2_dist_loss, bf16=True)
    assert np.array_equal(to_np(jv), to_np(sv))
    _assert_bf16_agrees(to_np(jl), to_np(sl), exact, "loss")
    # dedup does not apply under bf16 (the JAX package takes the plain
    # launch too): the same bits with and without it.
    dl, dv = SF.fused_loss(st, _t(X), _t(y), _t(w), sops, SL.l2_dist_loss, bf16=True,
                           dedup=True)
    assert torch.equal(dl, sl) and torch.equal(dv, sv)
    f32, _ = SF.fused_loss(st, _t(X), _t(y), _t(w), sops, SL.l2_dist_loss)
    _rank_contract(to_np(f32), to_np(sl))


def test_bf16_cost_form_matches_jax(bf16_batch):
    jops, sops, jt, st, exact, X, y, w = bf16_batch
    cx = np.random.default_rng(1).integers(1, MAXSIZE, 64).astype(np.int32)
    base, use = np.float32(1.7), np.bool_(True)
    jc, jl, jv = JF.fused_cost(jt, _j(X), _j(y), None, _j(cx), jops, JL.l1_dist_loss,
                               baseline_loss=_j(base), use_baseline=_j(use), parsimony=0.0032,
                               interpret=True, bf16=True, tree_block=1)
    kw = dict(baseline_loss=torch.tensor(base), use_baseline=torch.tensor(use),
              parsimony=0.0032)
    sc, sl, sv = SF.fused_cost(st, _t(X), _t(y), None, _t(cx), sops, SL.l1_dist_loss,
                               bf16=True, **kw)
    assert np.array_equal(to_np(jv), to_np(sv))
    _assert_bf16_agrees(to_np(jl), to_np(sl), exact, "loss")
    _assert_bf16_agrees(to_np(jc), to_np(sc), exact, "cost")
    # The cost form is the plain form plus loss_to_cost, bit for bit.
    pl, pv = SF.fused_loss(st, _t(X), _t(y), None, sops, SL.l1_dist_loss, bf16=True)
    assert torch.equal(pl, sl) and torch.equal(pv, sv)
    c32, _, _ = SF.fused_cost(st, _t(X), _t(y), None, _t(cx), sops, SL.l1_dist_loss, **kw)
    _rank_contract(to_np(c32), to_np(sc))


def test_bf16_parametric_form_matches_jax():
    """Kernel 1b's parametric form on finite banks (where the JAX kernel's
    class one-hot sum and the port's gather read the same values)."""
    jo = J.Options(binary_operators=BINARY, unary_operators=UNARY, maxsize=MAXSIZE,
                   save_to_file=False)
    cfg = JS.evolve_config_from_options(jo, 2)
    jt = j_init_population(jax.random.key(5), 48, cfg.mctx._replace(n_params=NP), jnp.float32,
                           nlength=5)
    st = interop.tree_batch(jax.tree.map(np.asarray, jt), device="cpu")
    live = np.arange(MAXSIZE)[None, :] < to_np(jt.length)[:, None]
    exact = ~(live & (to_np(jt.arity) == 1)).any(axis=1)
    rng = np.random.default_rng(2)
    X = rng.uniform(-2, 2, (2, 300)).astype(np.float32)
    y = rng.normal(size=300).astype(np.float32)
    cls = rng.integers(0, NC, 300).astype(np.int32)
    bank = rng.normal(size=(48, NP, NC)).astype(np.float32)
    jl, jv = JF.fused_loss(jt, _j(X), _j(y), None, cfg.operators, JL.l2_dist_loss,
                           params=_j(bank), class_idx=_j(cls), interpret=True, bf16=True,
                           tree_block=1)
    sl, sv = SF.fused_loss(st, _t(X), _t(y), None, S.OperatorSet(BINARY, UNARY),
                           SL.l2_dist_loss, params=_t(bank), class_idx=_t(cls), bf16=True)
    assert np.array_equal(to_np(jv), to_np(sv))
    _assert_bf16_agrees(to_np(jl), to_np(sl), exact, "parametric loss")


# Overflow at the bf16 store: on the marked row x1 = 1.40625 * 2^126 and
# x1 * 2.84375 = 1.99951 * 2^127 = 3.4020e38, finite in float32 (below
# 3.4028e38) but past bf16's rounding edge (3.3961e38), so it stores as
# inf while the step's `ok` stays true. At the root the inf surfaces in
# the loss (L1, one marked row: float32's loss stays finite); under
# `- x1` in the next step it surfaces there (inf - x1 is not finite).
OVERFLOW_EXPRS = ["x1 * 2.84375", "(x1 * 2.84375) - x1", "x1 * x2", "cos(x1) + 0.5"]
MARKED_X1 = np.float32(1.40625 * 2.0 ** 126)


def test_bf16_overflow_at_the_store_matches_jax():
    names = ["x1", "x2"]
    jops, sops = J.OperatorSet(["+", "-", "*"], ["cos"]), S.OperatorSet(["+", "-", "*"], ["cos"])
    jt = JE.encode_population([J.parse_expression(e, jops, names) for e in OVERFLOW_EXPRS],
                              8, jops)
    st = interop.tree_batch(jax.tree.map(np.asarray, jt), device="cpu")
    rng = np.random.default_rng(4)
    X = rng.uniform(-2, 2, (2, 64)).astype(np.float32)
    y = rng.normal(size=64).astype(np.float32)
    Xo = X.copy()
    Xo[0, 5] = MARKED_X1
    for data, want_valid in ((X, [True] * 4), (Xo, [False, False, True, True])):
        jl, jv = JF.fused_loss(jt, _j(data), _j(y), None, jops, JL.l1_dist_loss,
                               interpret=True, bf16=True, tree_block=1)
        sl, sv = SF.fused_loss(st, _t(data), _t(y), None, sops, SL.l1_dist_loss, bf16=True)
        assert to_np(sv).tolist() == to_np(jv).tolist() == want_valid
        assert_close(to_np(jl), to_np(sl), RTOL, "loss")
    # float32 has room: all four trees are valid there.
    _, v32 = SF.fused_loss(st, _t(Xo), _t(y), None, sops, SL.l1_dist_loss)
    assert to_np(v32).tolist() == [True] * 4
    # The stored root of the first tree is inf on the marked row with every
    # step finite in float32; the second tree's last step is not.
    prog = SP.compile_program(st, 2, 2)
    args = SF._launch_inputs(prog, _t(Xo), _t(y), None, 2, sops, bf16=True)
    buf, vmask, _ = SF._plain_forward(args[0], args[1], args[2], args[4], sops, bf16=True)
    root = SF._root(buf, args[1], 2 + prog.cmax)
    assert bool(torch.isposinf(root[0, 5])) and bool(vmask[0].all())
    assert not bool(vmask[1, 5]) and int((~vmask[1]).sum()) == 1


# ---------------------------------------------------------------------------
# Kernel 2b's plain version against the JAX kernel's bf16 form
# ---------------------------------------------------------------------------


def test_bf16_multi_matches_jax(bf16_batch):
    """V = 20 constant vectors per tree (the JAX package chunks them by 16;
    the port launches once), a NaN and an inf variant among them, weighted
    rows with some of weight 0."""
    jops, sops, jt, st, exact, X, y, w = bf16_batch
    jp = JP.compile_program(jt, 3, len(BINARY))
    sp = SP.compile_program(st, 3, len(BINARY))
    V = 20
    rng = np.random.default_rng(6)
    cv = (np.asarray(jp.cvals)[:, None, :]
          * (1.0 + 0.3 * rng.normal(size=(64, V, jp.cvals.shape[1])))).astype(np.float32)
    used = np.arange(cv.shape[2])[None, :] < np.asarray(jp.nconst)[:, None]
    t = np.argwhere(used[:, 0])[:2, 0]
    cv[t[0], V - 1, 0] = np.inf
    cv[t[1], 0, 0] = np.nan
    jl, jv = JF.fused_loss_multi(jp, _j(cv), _j(X), _j(y), _j(w), 3, jops, JL.l2_dist_loss,
                                 interpret=True, bf16=True, tree_block=1)
    sl, sv = SF.fused_loss_multi(sp, _t(cv), _t(X), _t(y), _t(w), 3, sops, SL.l2_dist_loss,
                                 bf16=True)
    assert np.array_equal(to_np(jv), to_np(sv))
    assert not to_np(sv)[t[0], V - 1] and not to_np(sv)[t[1], 0]
    ex = np.repeat(exact[:, None], V, axis=1)
    _assert_bf16_agrees(to_np(jl).reshape(-1), to_np(sl).reshape(-1), ex.reshape(-1), "loss")
    # With V = 1 it is kernel 1b's plain form.
    l1, v1 = SF.fused_loss_multi(sp, sp.cvals[:, None], _t(X), _t(y), _t(w), 3, sops,
                                 SL.l2_dist_loss, bf16=True)
    le, ve = SF.fused_loss_program(sp, _t(X), _t(y), _t(w), 3, sops, SL.l2_dist_loss,
                                   bf16=True)
    assert torch.equal(l1[:, 0], le) and torch.equal(v1[:, 0], ve)


def test_bf16_false_is_the_f32_path(bf16_batch):
    """bf16=False is the default and the float32 path, bit for bit."""
    jops, sops, jt, st, exact, X, y, w = bf16_batch
    a = SF.fused_loss(st, _t(X), _t(y), _t(w), sops, SL.l2_dist_loss)
    b = SF.fused_loss(st, _t(X), _t(y), _t(w), sops, SL.l2_dist_loss, bf16=False)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    sp = SP.compile_program(st, 3, len(BINARY))
    args = SF._launch_inputs(sp, _t(X), _t(y), _t(w), 3, sops)
    assert args[4].dtype == torch.float32
    a = SF.program_eval_plain(*args, sops, SL.l2_dist_loss)
    b = SF.program_eval_plain(*args, sops, SL.l2_dist_loss, bf16=False)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_bf16_wrappers_run_their_plain_versions_on_cpu(bf16_batch):
    """On CPU tensors the 1b and 2b wrappers run the plain versions and
    count no launch; they take X as bfloat16, rounded once per dataset."""
    jops, sops, jt, st, exact, X, y, w = bf16_batch
    sp = SP.compile_program(st, 3, len(BINARY))
    Xt = _t(X)
    args = SF._launch_inputs(sp, Xt, _t(y), _t(w), 3, sops, bf16=True)
    assert args[4].dtype == torch.bfloat16
    assert SF._launch_inputs(sp, Xt, _t(y), _t(w), 3, sops, bf16=True)[4] is args[4]
    k1, k2 = SF.ProgramEvalBf16Kernel(), SF.ProgramMultiBf16Kernel()
    got = k1(*args, sops, SL.l2_dist_loss)
    want = SF.program_eval_plain(*args, sops, SL.l2_dist_loss, bf16=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cv = args[2][:, None, :].expand(-1, 3, -1).contiguous()
    got = k2(args[0], args[1], cv, args[4], args[5], args[6], sops, SL.l2_dist_loss)
    want_v = SF.program_multi_plain(args[0], args[1], cv, args[4], args[5], args[6], sops,
                                    SL.l2_dist_loss, bf16=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want_v))
    assert k1.launches == k2.launches == 0
    # Rounded once: the same values as rounding inside the plain version.
    f32 = SF.program_eval_plain(*(args[:4] + (Xt,) + args[5:]), sops, SL.l2_dist_loss,
                                bf16=True)
    assert all(torch.equal(a, b) for a, b in zip(f32, want))


# ---------------------------------------------------------------------------
# The bf16 line search
# ---------------------------------------------------------------------------

# Trees whose constants are identifiable (as tests/test_torch_constant_opt.py's).
OPT_EXPRS = [
    "0.8 * (x1 * x1) + 1.3 * cos(x2)",
    "x1 * x1 + cos(1.4 * x2)",
    "2.1 * exp(0.3 * x1)",
    "x1 / (x2 + 3.5)",
    "cos((0.9 * x1) + 0.2) * 1.7",
    "x3",
    "(x1 * x1) - (0.7 * x3)",
]


def test_optimize_constants_fused_ls_bf16_matches_jax():
    """L-BFGS with the bf16 line search (kernel 2b's plain version): a
    member takes new constants only where their float32 loss beats its
    start, some improve, and the result agrees with the JAX package's
    interpret-mode run to tests/test_torch_constant_opt.py's tolerances
    (loss rtol 1e-5, constants rtol 1e-3, f_calls and improved equal).
    The exact fit (the first tree, y = x1 * x1 + cos(x2)) ends near a
    float32 loss of 7e-9, where its candidates' bf16 losses are rounding
    noise (the prediction stored to 2^-9 relative) and a step picked on
    another row-sum order ends elsewhere in that noise: it is held to
    1e-9 absolute and its constants to 1e-3 absolute."""
    names = ["x1", "x2", "x3"]
    jops, sops = J.OperatorSet(BINARY, UNARY), S.OperatorSet(BINARY, UNARY)
    jt = JE.encode_population([J.parse_expression(e, jops, names) for e in OPT_EXPRS],
                              MAXSIZE, jops)
    st = interop.tree_batch(jax.tree.map(np.asarray, jt), device="cpu")
    X, y = problem(0, n=64)
    jds = J.make_dataset(X, y)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    do_opt = np.ones(len(OPT_EXPRS), bool)
    do_opt[1] = False
    key = jax.random.key(3)
    el = S.Options(save_to_file=False).elementwise_loss
    # tree_block=1: a smaller interpret-mode kernel for JAX to compile (the
    # port has no tree blocks).
    jr = JC.optimize_constants_fused(key, jt, jnp.asarray(do_opt), jds.data,
                                     J.Options(save_to_file=False).elementwise_loss, jops,
                                     JC.OptimizerConfig(ls_bf16=True, tree_block=1),
                                     interpret=True)
    sr = SC.optimize_constants_fused(port_key(key), st, torch.from_numpy(do_opt), sd, el, sops,
                                     SC.OptimizerConfig(ls_bf16=True))
    jc, ji, jl, jf = (to_np(a) for a in jr)
    sc, si, sl, sf = (to_np(a) for a in sr)
    assert np.array_equal(jf, sf) and np.array_equal(ji, si)
    assert si.any() and not si[1]
    np.testing.assert_allclose(sl[1:], jl[1:], rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(sc[1:], jc[1:], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(sl[0], jl[0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(sc[0], jc[0], rtol=0, atol=1e-3)
    # Never above the start: the start's float32 loss (the gradient
    # kernel's, summed in the same order as fused_loss's) is the bound.
    start = to_np(SF.fused_loss(st, sd.Xt, sd.y, None, sops, el)[0])
    assert (sl <= start * (1 + 1e-6)).all()
    assert (sl[si] < start[si]).all()


# ---------------------------------------------------------------------------
# The interpreter path's bf16 mirror
# ---------------------------------------------------------------------------


def test_interpreter_bf16_mirror_matches_jax(bf16_batch):
    """eval_cost_batch(turbo=False, bf16=True): bf16 X and constants through
    the interpreter, the prediction back in float32 before the loss.
    Validity is decided on the bf16 values in both packages. XLA's CPU
    path may keep float32 inside a fusion where the port rounds every
    operation to bf16, so the two agree to the rank contract and within
    2e-2 on every finite loss (a few bf16 ULP), not to rtol 1e-5."""
    jops, sops, jt, st, exact, X, y, w = bf16_batch
    jo = J.Options(binary_operators=BINARY, unary_operators=UNARY, maxsize=MAXSIZE,
                   save_to_file=False)
    so = S.Options(binary_operators=BINARY, unary_operators=UNARY, maxsize=MAXSIZE,
                   save_to_file=False)
    jds = J.make_dataset(X.T, y)
    jds.update_baseline_loss(jo.elementwise_loss)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    jt_, st_ = j_tables(jo, 3), s_tables(so, 3, torch.device("cpu"))
    jc, jl, jx = JS.eval_cost_batch(jt, jds.data, jo.elementwise_loss, jt_, jops, 0.0032,
                                    turbo=False, bf16=True)
    sc, sl, sx = SS.eval_cost_batch(st, sd, so.elementwise_loss, st_, sops, 0.0032, turbo=False,
                                    bf16=True)
    assert np.array_equal(to_np(jx), to_np(sx))
    a, b = to_np(jl), to_np(sl)
    fin = np.isfinite(a) & np.isfinite(b)
    assert fin.sum() >= 0.9 * len(a)
    rel = np.abs(a[fin] - b[fin]) / np.abs(a[fin])
    assert rel.max() < 2e-2, rel.max()
    _rank_contract(a, b)
    # The mirror against kernel 1b's plain version (turbo=True on the CPU).
    kc, kl, _ = SS.eval_cost_batch(st, sd, so.elementwise_loss, st_, sops, 0.0032, turbo=True,
                                   fuse_cost=True, bf16=True)
    _rank_contract(to_np(kl), b)


# ---------------------------------------------------------------------------
# One staged generation step against the JAX package's
# ---------------------------------------------------------------------------


def _staged_options(parametric: bool, **kw):
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=12,
                populations=1, population_size=16, ncycles_per_iteration=2,
                tournament_selection_n=4, turbo=False, should_optimize_constants=False,
                staged_eval=True, staged_sample_fraction=0.25, rescore_fraction=0.3,
                save_to_file=False)
    base.update(kw)
    if parametric:
        return (J.Options(expression_spec=JSpec(max_parameters=NP), **base),
                S.Options(expression_spec=SSpec(max_parameters=NP), **base))
    return J.Options(**base), S.Options(**base)


def _staged_data(seed: int, parametric: bool):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (300, 2)).astype(np.float32)
    cls = rng.integers(0, NC, 300)
    y = (X[:, 0] * X[:, 1] + 1.0 + (np.array([0.5, -1.0, 2.0])[cls] if parametric else 0.0))
    extra = {"class": cls} if parametric else None
    jds = J.make_dataset(X, y.astype(np.float32), extra=extra)
    return jds


@pytest.fixture(scope="module")
def staged_engines():
    """Per expression kind: both packages' options and engines, and the JAX
    package's generation_step jitted once."""
    cache = {}

    def get(parametric):
        if parametric not in cache:
            jo, so = _staged_options(parametric, crossover_probability=0.2)
            kw = dict(n_params=NP, n_classes=NC) if parametric else {}
            je, se = JEngine(jo, 2, **kw), SEngine(so, 2, device="cpu", **kw)
            P = so.population_size
            step = jax.jit(lambda k, pop, data, nf, marks: JS.generation_step(
                k, pop, data, nf, jnp.float32(0.5), 12, jnp.int32(P), jnp.int32(P), je.cfg,
                jo, je.tables, jo.elementwise_loss, marks=marks))
            cache[parametric] = (jo, so, je, se, step)
        return cache[parametric]

    return get


# The listed seeds give equal populations. The promotion boundary sits on
# screened costs, where a 1-ULP difference of the two packages' row sums
# could move a candidate across it and part the steps (none does here).
@pytest.mark.parametrize("parametric,seed", [(False, 0), (False, 1), (False, 2), (True, 0),
                                             (True, 1)])
def test_staged_generation_step_equal(staged_engines, parametric, seed):
    """One staged generation step of one island (screen on 75 of 300 rows,
    rescore ceil(0.3 N) candidates) from the same population and key:
    every member field equal, costs within rtol 1e-5."""
    jo, so, je, se, step = staged_engines(parametric)
    jds = _staged_data(seed, parametric)
    jds.update_baseline_loss(jo.elementwise_loss)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    assert se.cfg.staged_eval and SS.resolve_sample_rows(se.cfg, 300) == 75
    js = je.init_state(jax.random.key(seed), jds.data, 1)
    pop = jax.tree.map(lambda x: x[0], js.pops)
    nf = js.stats.normalized_frequencies
    k = jax.random.fold_in(jax.random.key(seed + 100), 0)
    P = so.population_size
    jp, jn, jb, jr, jm = step(k, pop, jds.data, nf, (jnp.zeros(P, bool), jnp.zeros(P, bool)))
    sp = interop.population_state(jax.tree.map(lambda x: np.asarray(x)[None], pop), device="cpu")
    smarks = (torch.zeros((1, P), dtype=torch.bool), torch.zeros((1, P), dtype=torch.bool))
    pp, pn, pb, pr, pm = SS.generation_step(
        port_key(k)[None], sp, sd, torch.from_numpy(to_np(nf).copy()), torch.tensor(0.5), 12,
        torch.tensor([P], dtype=torch.int32), torch.tensor([P], dtype=torch.int32), se.cfg, so,
        se.tables, so.elementwise_loss, smarks)
    jnp_pop = jax.tree.map(lambda x: np.asarray(x)[None], jp)
    assert_pops_equal(jnp_pop, pp)
    if parametric:
        assert_close(to_np(jnp_pop.params), to_np(pp.params), RTOL, "params")
    assert float(jn) == float(pn[0])
    for a, b in zip(jm, pm):
        assert np.array_equal(to_np(a), to_np(b)[0])


@pytest.mark.parametrize("bf16", [False, True])
def test_staged_step_screens_then_rescores_through_the_kernel(monkeypatch, bf16):
    """With turbo on, one staged step is one screen and one rescore
    through the interpreter kernel's cost form (#1, or 1b under bf16), of
    every candidate on the sample rows and of ceil(0.3 N) of them on
    every row; each island promotes its own best."""
    _, so = _staged_options(False, turbo=True, populations=3, eval_precision=(
        "bf16" if bf16 else "f32"))
    jds = _staged_data(0, False)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    se = SEngine(so, 2, device="cpu")
    state = se.init_state(SR.key(0), sd, 3)
    calls = []
    kernel = SF.PROGRAM_EVAL_BF16 if bf16 else SF.PROGRAM_EVAL
    real = type(kernel).__call__

    def counting(self, *a, **kw):
        calls.append((self.name, a[4].shape[1], a[0].shape[0]))
        return real(self, *a, **kw)

    monkeypatch.setattr(type(kernel), "__call__", counting)
    P = so.population_size
    born = torch.full((3,), P, dtype=torch.int32)
    SS.generation_step(SR.split(SR.key(1), 3), state.pops, sd,
                       state.stats.normalized_frequencies, torch.tensor(0.5), 12, born, born,
                       se.cfg, so, se.tables, so.elementwise_loss,
                       (torch.zeros((3, P), dtype=torch.bool),) * 2)
    (n1, rows1, t1), (n2, rows2, t2) = calls
    assert n1 == n2 == kernel.name
    N = t1 // 3
    assert rows1 == 75 and rows2 == 300
    assert t2 == 3 * SS.rescore_count(se.cfg, N)


# ---------------------------------------------------------------------------
# The port's own engine
# ---------------------------------------------------------------------------


def _run(so, seed=0, iters=2, parametric=False):
    jds = _staged_data(seed, parametric)
    ds = S.make_dataset(np.array(jds.data.Xt).T, np.array(jds.data.y), device="cpu",
                        extra={"class": np.array(jds.data.class_idx)} if parametric else None)
    ds.update_baseline_loss(so.elementwise_loss)
    sd = ds.data
    kw = dict(n_params=NP, n_classes=NC) if parametric else {}
    eng = SEngine(so, 2, device="cpu", **kw)
    state = eng.init_state(SR.key(seed), sd, so.populations)
    for _ in range(iters):
        state = eng.run_iteration(state, sd, so.maxsize)
    return eng, state, sd


@pytest.mark.parametrize("kw,parametric", [
    (dict(), False),
    (dict(eval_precision="bf16"), False),
    (dict(eval_precision="bf16", turbo=True), False),
    (dict(), True),
])
def test_staged_population_costs_are_full_data(kw, parametric):
    """Only full-data costs reach the population: after two staged
    iterations every member's cost equals an unstaged re-eval of it at the
    same precision within rtol 1e-5 (tests/test_staged_eval.py's check)."""
    _, so = _staged_options(parametric, populations=2, ncycles_per_iteration=3, **kw)
    eng, state, sd = _run(so, parametric=parametric)
    assert eng.cfg.staged_eval
    cost = to_np(state.pops.cost).reshape(-1)
    assert np.isfinite(cost).all()
    I, P = state.pops.cost.shape
    flat = state.pops.trees.reshape(-1)
    params = state.pops.params.reshape(I * P, *state.pops.params.shape[2:])
    c_ref, _, _ = eng._eval(flat, params, sd, fuse_cost=eng.cfg.fuse_cost)
    np.testing.assert_allclose(cost, to_np(c_ref), rtol=1e-5, atol=1e-6)


def test_defaults_off_bit_identical():
    """Options() and Options(eval_precision="f32", staged_eval=False,
    optimizer_bf16_linesearch=False) give bit-identical trajectories."""
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=12,
                populations=2, population_size=16, ncycles_per_iteration=3,
                tournament_selection_n=4, optimizer_probability=0.3, save_to_file=False)
    _, a, _ = _run(S.Options(**base))
    _, b, _ = _run(S.Options(eval_precision="f32", staged_eval=False,
                             optimizer_bf16_linesearch=False, **base))
    for name in ("cost", "loss", "complexity", "birth", "ref"):
        assert np.array_equal(to_np(getattr(a.pops, name)), to_np(getattr(b.pops, name)),
                              equal_nan=True), name
    for x, y_ in zip(a.pops.trees.fields(), b.pops.trees.fields()):
        assert np.array_equal(to_np(x), to_np(y_), equal_nan=True)
    assert np.array_equal(to_np(a.hof.cost), to_np(b.hof.cost), equal_nan=True)


def test_line_search_bf16_only_where_the_kernels_run():
    """optimizer_bf16_linesearch takes kernel 2b only with turbo on the
    card; on the CPU the line search stays float32 (the JAX package's
    interpret mode keeps f32 too), and the search runs."""
    so = S.Options(binary_operators=["+", "*"], optimizer_bf16_linesearch=True, turbo=True,
                   save_to_file=False)
    assert not SEngine(so, 2, device="cpu").opt_cfg.ls_bf16
    X, y = problem(1, n=64, nfeatures=2)
    so = S.Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=10,
                   populations=2, population_size=16, ncycles_per_iteration=3,
                   tournament_selection_n=4, optimizer_bf16_linesearch=True,
                   eval_precision="bf16", staged_eval=True, turbo=True, save_to_file=False)
    hof = S.equation_search(X, y, options=so, niterations=2, seed=0, device="cpu")
    assert np.isfinite(min(e.loss for e in hof.entries))
