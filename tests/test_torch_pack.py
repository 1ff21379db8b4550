"""The port's graftpack (pack/) against the JAX package's, and zero-weight
padding on the plain versions of kernels #1-#3.

Host-level modules only: ``pad_to_bucket`` is bit-equal for both fills,
``pack_group_key``/``packable``/``slot_cap`` agree, and a cohort's barrier
and occupancy record run the JAX package's sequence. The kernels' padding
contract (pack/padding.py): a request padded to its bucket with replica
rows at weight 0 gets bit-identical loss sums, costs, gradients and
validity from kernels #1 (cost and plain forms), #2 and #3 — here their
plain versions on the CPU (the CUDA kernels are held to it in
``chip_smoke.py`` phase 31) — and agrees within rtol 1e-5 with the JAX
package's ``fused_loss``/``fused_cost``/``fused_loss_multi``/
``fused_grad_multi`` in interpret mode on the same padded input.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu import pack as JP
from symbolicregression_jl_tpu.core import losses as JL
from symbolicregression_jl_tpu.evolve.population import init_population as j_init_population
from symbolicregression_jl_tpu.evolve.step import evolve_config_from_options as j_cfg
from symbolicregression_jl_tpu.ops import fused_eval as JF
from symbolicregression_jl_tpu.ops.program import compile_program as j_compile
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch import pack as SP
from symbolicregression_jl_tpu_torch.core import losses as SL
from symbolicregression_jl_tpu_torch.ops import fused_eval as SF
from symbolicregression_jl_tpu_torch.ops.program import compile_program

from torch_parity import assert_close, to_np

RTOL = 1e-5


# ---------------------------------------------------------------------------
# pack/padding.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fill", ["cyclic", "edge"])
@pytest.mark.parametrize("n,rows,dtype", [(300, 512, np.float32), (97, 256, np.float64),
                                          (256, 256, np.float32), (5, 1024, np.int32)])
def test_pad_to_bucket_bit_equal_to_jax(fill, n, rows, dtype):
    rng = np.random.default_rng(n)
    X = (rng.normal(size=(n, 3)) * 100).astype(dtype)
    y = (rng.normal(size=n) * 100).astype(dtype)
    got = SP.pad_to_bucket(X, y, rows=rows, fill=fill)
    want = JP.pad_to_bucket(X, y, rows=rows, fill=fill)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    Xp, yp, wp = got
    assert Xp.shape == (rows, 3) and float(wp[:n].sum()) == n and not wp[n:].any()


@pytest.mark.parametrize("kw", [dict(rows=10), dict(rows=512, fill="zeros"),
                                dict(rows=8, empty=True)])
def test_pad_to_bucket_refuses_as_jax(kw):
    kw = dict(kw)
    n = 0 if kw.pop("empty", False) else 20
    X, y = np.ones((n, 2), np.float32), np.ones(n, np.float32)
    with pytest.raises(ValueError) as js:
        JP.pad_to_bucket(X, y, **kw)
    with pytest.raises(ValueError) as ss:
        SP.pad_to_bucket(X, y, **kw)
    assert str(js.value) == str(ss.value)


# ---------------------------------------------------------------------------
# pack/scheduler.py and pack/cohort.py
# ---------------------------------------------------------------------------


def test_scheduler_agrees_with_jax():
    opts = [None, {}, {"maxsize": 12, "binary_operators": ["+", "*"]},
            {"batching": True, "batch_size": 50}, {"batching": False}]
    for o in opts:
        assert SP.packable(o) == JP.packable(o)
        for bucket in [(256, 2, 1), (8192, 5, 1)]:
            assert SP.pack_group_key(bucket, o) == JP.pack_group_key(bucket, o)
    for policy_kw in [{}, {"max_tenants": 1}, {"max_tenants": 8}]:
        sp, jp = SP.PackPolicy(**policy_kw), JP.PackPolicy(**policy_kw)
        for advice in [None, {}, {"predicted_bytes": 100, "headroom_bytes": 250},
                       {"predicted_bytes": 100, "headroom_bytes": -5},
                       {"predicted_bytes": 0, "headroom_bytes": 1000},
                       {"predicted_bytes": "x", "headroom_bytes": 1},
                       {"predicted_bytes": 10, "headroom_bytes": None}]:
            assert SP.slot_cap(sp, advice) == JP.slot_cap(jp, advice)


def _cohort_run(mod):
    """Two tenants through three lockstep rounds, a third joining late and
    the first leaving early; returns the occupancy record."""
    c = mod.PackedCohort("g", slot_cap=3, barrier_timeout_s=5.0)
    a, b = c.join("a"), c.join("b")
    rounds = {"a": 2, "b": 3}

    def tenant(slot, name):
        for _ in range(rounds[name]):
            c.arrive(slot)
        c.leave(slot)

    ts = [threading.Thread(target=tenant, args=(s, n)) for s, n in ((a, "a"), (b, "b"))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert [c.join(k) for k in "cdef"] == [2, 3, 4, None]
    return c.occupancy()


def test_cohort_barrier_and_occupancy_match_jax():
    got, want = _cohort_run(SP), _cohort_run(JP)
    assert got == want
    assert got["tenants_total"] == 5 and got["peak_tenants"] == 3 and got["rounds"] == 3


# ---------------------------------------------------------------------------
# Zero-weight padding on kernels #1-#3 (their plain versions on the CPU)
# ---------------------------------------------------------------------------

BINARY, UNARY = ["+", "-", "*", "/"], ["cos", "abs", "exp"]
N_REAL, BUCKET = 300, 512


# Invalid on some real row (and so on its replica): the trees' validity
# must come out of the padded launch as it does out of the unpadded one.
INVALID = ["abs(x3) / (x1 - x1)", "exp(exp(exp(x1 * 3.0)))", "x1 / (x2 - x2) + cos(x3)"]


def _trees(T: int = 48, seed: int = 3):
    """Random trees plus INVALID, in both packages."""
    from symbolicregression_jl_tpu.ops import encoding as JE

    opts = J.Options(binary_operators=BINARY, unary_operators=UNARY, maxsize=15,
                     save_to_file=False)
    cfg = j_cfg(opts, 3)
    rand = j_init_population(jax.random.key(seed), T, cfg.mctx, jnp.float32)
    hand = JE.encode_population([J.parse_expression(e, cfg.operators, ["x1", "x2", "x3"])
                                 for e in INVALID], 15, cfg.operators)
    jt = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), rand, hand)
    return cfg.operators, S.OperatorSet(BINARY, UNARY), jt, interop.tree_batch(
        jax.tree.map(np.asarray, jt), device="cpu")


def _padded(fill: str):
    """(unpadded X [F, n], y, w) and the same rows padded to BUCKET."""
    rng = np.random.default_rng(11)
    X = rng.uniform(-3, 3, (N_REAL, 3)).astype(np.float32)
    y = (np.cos(2.1 * X[:, 0]) + X[:, 1] * X[:, 2]).astype(np.float32)
    Xp, yp, wp = SP.pad_to_bucket(X, y, rows=BUCKET, fill=fill)
    real = (np.ascontiguousarray(X.T), y, np.ones(N_REAL, np.float32))
    return real, (np.ascontiguousarray(Xp.T), yp, wp)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x) -> bytes:
    return to_np(x).tobytes()


@pytest.mark.parametrize("fill", ["cyclic", "edge"])
def test_kernel1_padding_bit_inert_and_matches_jax(fill):
    jops, sops, jt, st = _trees(T=32)
    real, pad = _padded(fill)
    cx = np.random.default_rng(0).integers(1, 15, jt.length.shape).astype(np.int32)
    base, use = np.float32(1.7), np.bool_(True)
    outs = []
    for X, y, w in (real, pad):
        loss, valid = SF.fused_loss(st, _t(X), _t(y), _t(w), sops, SL.l2_dist_loss)
        cost, closs, cvalid = SF.fused_cost(
            st, _t(X), _t(y), _t(w), _t(cx), sops, SL.l2_dist_loss,
            baseline_loss=torch.tensor(base), use_baseline=torch.tensor(use), parsimony=0.0032)
        outs.append((loss, valid, cost, closs, cvalid))
    for a, b in zip(*outs):
        assert _bits(a) == _bits(b)
    loss, valid = outs[1][:2]
    assert 0 < int(valid.sum()) < len(valid)
    if fill != "cyclic":   # the JAX side once: its interpret-mode trace dominates
        return
    X, y, w = (jnp.asarray(a) for a in pad)
    jl, jv = JF.fused_loss(jt, X, y, w, jops, JL.l2_dist_loss, interpret=True)
    assert np.array_equal(to_np(jv), to_np(valid))
    assert_close(to_np(jl), to_np(loss), RTOL, "loss")
    jc, _, _ = JF.fused_cost(jt, X, y, w, jnp.asarray(cx), jops, JL.l2_dist_loss,
                             baseline_loss=jnp.asarray(base), use_baseline=jnp.asarray(use),
                             parsimony=0.0032, interpret=True)
    assert_close(to_np(jc), to_np(outs[1][2]), RTOL, "cost")


@pytest.mark.parametrize("fill", ["cyclic", "edge"])
def test_kernels2_3_padding_bit_inert_and_match_jax(fill):
    jops, sops, jt, st = _trees(T=16, seed=5)
    real, pad = _padded(fill)
    jp = j_compile(jt, 3, len(jops.binary))
    sp = compile_program(st, 3, len(sops.binary))
    rng = np.random.default_rng(2)
    cv = (np.asarray(jp.cvals)[:, None, :]
          * (1.0 + 0.3 * rng.normal(size=(jp.cvals.shape[0], 3, jp.cvals.shape[1]))))
    cv = cv.astype(np.float32)
    outs = []
    for X, y, w in (real, pad):
        args = (sp, _t(cv), _t(X), _t(y), _t(w), 3, sops, SL.l2_dist_loss)
        outs.append(SF.fused_loss_multi(*args) + SF.fused_grad_multi(*args))
    for a, b in zip(*outs):
        assert _bits(a) == _bits(b)
    ml, mv, gl, gv, g = outs[1]
    assert 0 < int(mv.sum()) < mv.numel()
    if fill != "cyclic":
        return
    X, y, w = (jnp.asarray(a) for a in pad)
    args_j = (jp, jnp.asarray(cv), X, y, w, 3, jops, JL.l2_dist_loss)
    jl, jv = JF.fused_loss_multi(*args_j, interpret=True)
    assert np.array_equal(to_np(jv), to_np(mv))
    assert_close(to_np(jl), to_np(ml), RTOL, "multi loss")
    jgl, jgv, jg = JF.fused_grad_multi(*args_j, interpret=True)
    assert np.array_equal(to_np(jgv), to_np(gv))
    assert_close(to_np(jgl), to_np(gl), RTOL, "grad loss")
    # gradients: zeroed components alike, the rest within 1e-4 of the
    # absolute row sums (the two packages sum the rows in other orders)
    instr = SF._pack_instr(sp, sops, 3 + sp.cmax + sp.max_steps)
    *_, gabs = SF.program_grad_plain(instr, sp.nsteps, sp.nconst, _t(cv), _t(pad[0]),
                                     _t(pad[1]), _t(pad[2]), sops, SL.l2_dist_loss,
                                     return_abs=True)
    jg, sg, scale = to_np(jg), to_np(g), to_np(gabs) / N_REAL
    assert np.array_equal(jg == 0, sg == 0)
    live = jg != 0
    assert np.all(np.abs(jg - sg)[live] <= 1e-4 * scale[live])


def test_plain_sums_leave_out_trailing_zero_weight_rows():
    """ops/fused_eval.py ``_weighted_rows``: the plain versions sum up to
    the last row of positive weight, so zero-weight rows appended change
    no bit, and zero weights before the last positive one stay in."""
    assert SF._weighted_rows(torch.tensor([1.0, 0.0, 2.0, 0.0, 0.0])) == 3
    assert SF._weighted_rows(torch.zeros(4)) == 0
    assert SF._weighted_rows(torch.ones(6)) == 6
