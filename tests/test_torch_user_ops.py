"""User operators on the kernels: the tracer, its emitters, and the
kernels' plain versions against the JAX package's fused ops.

Each user operator is written twice, in jnp for the JAX package and in
torch for the port. The JAX package traces it into its Pallas kernels
(run here in interpret mode); the port traces it into a small IR
(ops/user_ops.py) whose torch emitter is held bit-equal to the operator's
own function and whose adjoint is held bit-equal to ``torch.autograd``; on
the CPU the kernel wrappers run their plain versions, which call the
operator's function and differentiate it with ``torch.autograd``. The CUDA
text the IR generates is compiled for the host in
tests/test_torch_tile_host.py and on the card in chip_smoke.py phase 37.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.core import losses as JL
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu.evolve.population import init_population as j_init_population
from symbolicregression_jl_tpu.evolve.step import evolve_config_from_options as j_cfg
from symbolicregression_jl_tpu.ops import fused_eval as JF
from symbolicregression_jl_tpu.ops import program as JP
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.core import losses as SL
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine
from symbolicregression_jl_tpu_torch.ops import cuda_build
from symbolicregression_jl_tpu_torch.ops import fused_eval as SF
from symbolicregression_jl_tpu_torch.ops import program as SP
from symbolicregression_jl_tpu_torch.ops import user_ops as UO
from symbolicregression_jl_tpu_torch.ops.operators import safe_log, safe_sqrt

from torch_parity import assert_close, assert_pops_equal, numpy_state, problem, to_np

RTOL = 1e-5
GRAD_RTOL = 1e-4
MAXSIZE = 15

# Each user operator in torch (the port) and in jnp (the JAX package).
TORCH_OPS = {
    "gauss": (1, lambda x: torch.exp(-x * x)),
    "softplus": (1, lambda x: torch.log1p(torch.exp(x))),
    "pdiv": (2, lambda a, b: torch.where(b == 0, 0, a / b)),
    "mix": (2, lambda a, b: torch.tanh(a) * torch.sigmoid(b) + torch.clamp(a, -1, 2)
            - torch.maximum(a, b) ** 2),
    "slog": (1, lambda x: safe_log(x * x + 1.5) + 2.0 * x - (x > 0).to(x.dtype)),
    "recip": (1, lambda x: 1.0 / (x.abs() + 0.5) - torch.erf(x) + safe_sqrt(x) / 3.0 + x ** 3),
}
JAX_OPS = {
    "gauss": lambda x: jnp.exp(-x * x),
    "softplus": lambda x: jnp.log1p(jnp.exp(x)),
    "pdiv": lambda a, b: jnp.where(b == 0, 0.0, a / b),
}
_OPS = {}


def sop(name):
    """The port's Op (one object per name, so its operator set's user-op
    set is traced once)."""
    if name not in _OPS:
        arity, fn = TORCH_OPS[name]
        _OPS[name] = S.Op(name, arity, fn)
    return _OPS[name]


def jop(name):
    return J.Op(name, TORCH_OPS[name][0], JAX_OPS[name])


# ---------------------------------------------------------------------------
# The tracer and its emitters
# ---------------------------------------------------------------------------


def _edge_inputs(arity, dtype, seed):
    """Seeded normal values with 0, +-inf and NaN among them."""
    rng = np.random.default_rng(seed)
    xs = []
    for j in range(arity):
        a = (rng.normal(size=600) * 3).astype(np.float64)
        a[:6] = [0.0, np.inf, -np.inf, np.nan, -0.0, 2.0]
        a[6 + j::7] = 0.0   # b == 0 rows for pdiv
        xs.append(torch.from_numpy(a).to(dtype))
    return xs


def _bits_equal(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, 1.0, 2.0, 3.0), torch.nan_to_num(b, 1.0, 2.0, 3.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(TORCH_OPS))
def test_ir_emitters_match_fn_and_autograd(name, dtype):
    """The IR's torch emitter is bit-equal to op.fn, and its reverse sweep
    to torch.autograd through op.fn, on inputs with 0, +-inf and NaN (in
    float32 and float64). A port operator function the operator calls
    (safe_sqrt) is one node with the built-in operator's derivative (the
    kernels' table, ops/vjp.py), not autograd through its body: there the
    adjoint is non-finite in the same places and within rtol 1e-6."""
    op = sop(name)
    ir = UO.trace_op(op)
    xs = _edge_inputs(op.arity, dtype, 3)
    assert _bits_equal(op.fn(*xs), ir.torch_forward(*xs))
    ct = torch.from_numpy(np.random.default_rng(4).normal(size=600)).to(dtype)
    req = [x.clone().requires_grad_(True) for x in xs]
    want = torch.autograd.grad(op.fn(*req), req, ct, allow_unused=True)
    want = [torch.zeros_like(ct) if g is None else g for g in want]
    builtin = any(nd.op == "builtin" and nd.param == "sqrt" for nd in ir.nodes)
    assert builtin == (name == "recip")
    for w, g in zip(want, ir.torch_vjp(xs, ct)):
        if not builtin:
            assert _bits_equal(w, g)
            continue
        w, g = to_np(w), to_np(g)
        assert np.array_equal(np.isnan(w), np.isnan(g))
        assert np.array_equal(np.isinf(w), np.isinf(g))
        f = np.isfinite(w)
        np.testing.assert_allclose(g[f], w[f], rtol=1e-6)


def test_pdiv_unselected_branch_stays_nan():
    """where's adjoint sends the cotangent to the selected branch only: at
    b = 0 pdiv's value is 0, the divide's branch gets a zero cotangent and
    its 0 / 0 and 0 x inf stay NaN in both operands' cotangents, as
    jax.vjp leaves them; elsewhere they agree with jax.vjp."""
    ir = UO.trace_op(sop("pdiv"))
    a, b, ct = (torch.tensor([2.0, 3.0]), torch.tensor([0.0, 1.5]), torch.ones(2))
    da, db = ir.torch_vjp([a, b], ct)
    assert float(ir.torch_forward(a, b)[0]) == 0.0
    assert bool(torch.isnan(da[0])) and bool(torch.isnan(db[0]))
    ja, jb = jax.vjp(JAX_OPS["pdiv"], jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))[1](
        jnp.ones(2, jnp.float32))
    assert np.isnan(np.asarray(jb)[0]) and np.isnan(np.asarray(ja)[0])
    np.testing.assert_allclose(to_np(da)[1:], np.asarray(ja)[1:], rtol=1e-6)
    np.testing.assert_allclose(to_np(db)[1:], np.asarray(jb)[1:], rtol=1e-6)


@pytest.mark.parametrize("fn,what", [
    (lambda x: torch.sinh(x), "torch.sinh"),
    (lambda x: x if x > 0 else -x, "bool()"),
    (lambda x: torch.nn.functional.softplus(x), "torch.softplus"),
    (lambda x: x ** x, "** by a tensor"),
    (lambda x: x.exp().numpy(), ".numpy"),
], ids=["sinh", "branch", "softplus_fn", "pow_tensor", "numpy"])
def test_untraceable_operator_refused_by_name(fn, what):
    """An operator whose trace meets a function outside the table is
    refused when the engine (or the search) is built with turbo on, the
    refusal naming the function and turbo=False; turbo=False runs it."""
    op = S.Op("bad", 1, fn)
    with pytest.raises(UO.UntraceableOperator, match=what.replace("*", r"\*").replace("(", r"\(")
                       .replace(")", r"\)")):
        UO.trace_op(op)
    opts = dict(binary_operators=["+", "*"], unary_operators=[op], populations=2,
                population_size=8, ncycles_per_iteration=1, tournament_selection_n=4,
                save_to_file=False)
    with pytest.raises(NotImplementedError, match="turbo=False"):
        SEngine(S.Options(turbo=True, **opts), 2, device="cpu")
    SEngine(S.Options(turbo=False, **opts), 2, device="cpu")


def test_generated_cuda_deterministic_and_stub():
    """The generated header is the same text every time an operator set is
    traced, names each user operator's id in SR_USER_OPS_CASES, and goes
    into the library's hash (a library per operator set, in build/kernels/);
    with no user operators there is no header and every built-in library
    keeps the name and nvcc input it had: the source, csrc's headers and
    the flags, and nothing else."""
    import hashlib

    ops = S.OperatorSet(["+", "*", sop("pdiv")], ["exp", sop("gauss"), sop("softplus")])
    uset = UO.user_op_set(ops)
    fresh = [S.Op(o.name, o.arity, o.fn) for o in (sop("pdiv"), sop("gauss"), sop("softplus"))]
    again = UO.user_op_set(S.OperatorSet(["+", "*", fresh[0]], ["exp", fresh[1], fresh[2]]))
    assert uset.header == again.header and uset.digest == again.digest
    assert "BIN(96, user_binary_0, user_binary_vjp_0)" in uset.header
    assert "UN(113, user_unary_1, user_unary_vjp_1)" in uset.header
    assert SF._optab_list(ops)[-2:] == (2 << 8 | 112, 2 << 8 | 113)
    assert UO.user_op_set(S.OperatorSet(["+", "*"], ["exp", "cos"])) is None
    for name in cuda_build.SOURCES:
        src = cuda_build.source_path(name)
        h = hashlib.sha256(src.read_bytes())
        for header in sorted(src.parent.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(cuda_build.NVCC_FLAGS).encode())
        path, digest = cuda_build._target(src)
        assert digest == h.hexdigest()[:16] and path.parent == cuda_build.build_dir()
        upath, udigest = cuda_build._target(src, uset.header)
        assert udigest != digest and upath.parent == cuda_build.build_dir()
    assert cuda_build._user_flags(None) == []
    # interp.cuh's own stub: with no header the user cases expand to nothing
    assert "#else\n#define SR_USER_OPS_CASES(BIN, UN)\n#endif" in \
        cuda_build.source_path("interp.cuh").read_text()


# ---------------------------------------------------------------------------
# The kernels' plain versions against the JAX package's fused ops
# ---------------------------------------------------------------------------

BINARY = ["+", "-", "*", "pdiv"]
UNARY = ["exp", "gauss", "softplus"]


def _opsets():
    jb = [jop(o) if o in JAX_OPS else o for o in BINARY]
    ju = [jop(o) if o in JAX_OPS else o for o in UNARY]
    sb = [sop(o) if o in JAX_OPS else o for o in BINARY]
    su = [sop(o) if o in JAX_OPS else o for o in UNARY]
    return jb, ju, S.OperatorSet(sb, su)


def _trees(seed, T, F, n_params=0):
    jb, ju, sops = _opsets()
    jo = J.Options(binary_operators=jb, unary_operators=ju, maxsize=MAXSIZE, save_to_file=False)
    cfg = j_cfg(jo, F)
    mctx = cfg.mctx._replace(n_params=n_params) if n_params else cfg.mctx
    jt = j_init_population(jax.random.key(seed), T, mctx, jnp.float32, nlength=4)
    st = interop.tree_batch(jax.tree.map(np.asarray, jt), device="cpu")
    return cfg.operators, sops, jt, st


def _data(F, n, seed=0):
    """Rows on [-3, 3] with x2 == 0 on every fifth row (pdiv's b = 0) and a
    few large values (exp and softplus overflow)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (F, n)).astype(np.float32)
    X[-1, ::5] = 0.0
    X[0, 3::17] = 95.0
    y = rng.normal(size=n).astype(np.float32)
    w = rng.uniform(0.2, 2.0, n).astype(np.float32)
    w[::9] = 0.0
    return X, y, w


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("kernel", ["eval", "param", "multi", "grad", "predict", "vjp"])
def test_plain_kernels_match_jax(kernel):
    """#1 (cost form), #1p, #2, #3, #4 and #5 with the user operators
    gauss, softplus and pdiv: the port's plain versions against the JAX
    package's fused ops in interpret mode. Validity bit-equal; losses and
    costs within rtol 1e-5 and gradients within 1e-4 (of the constants'
    absolute row sums), with inf and NaN in the same places (pdiv's b = 0
    rows give the divide's 0 x inf there)."""
    F, n, T = 2, 65, 40
    jops, sops, jt, st = _trees(11, T, F, n_params=2 if kernel == "param" else 0)
    X, y, w = _data(F, n)
    jX, jy, jw = jnp.asarray(X), jnp.asarray(y), jnp.asarray(w)
    sX, sy, sw = _t(X), _t(y), _t(w)
    nb = len(BINARY)
    if kernel == "eval":
        cx = np.random.default_rng(3).integers(1, 10, T).astype(np.int32)
        jc, jl, jv = JF.fused_cost(jt, jX, jy, jw, jnp.asarray(cx), jops, JL.l2_dist_loss,
                                   interpret=True, baseline_loss=jnp.float32(1.7),
                                   use_baseline=jnp.bool_(True), parsimony=0.01)
        sc, sl, sv = SF.fused_cost(st, sX, sy, sw, _t(cx), sops, SL.l2_dist_loss,
                                   baseline_loss=torch.tensor(1.7),
                                   use_baseline=torch.tensor(True), parsimony=0.01)
        assert np.array_equal(to_np(jv), to_np(sv)) and 0 < to_np(sv).sum() < T
        assert_close(to_np(jl), to_np(sl), RTOL, "loss")
        assert_close(to_np(jc), to_np(sc), RTOL, "cost")
    elif kernel == "param":
        NC = 3
        cls = np.random.default_rng(5).integers(0, NC, n).astype(np.int32)
        bank = np.random.default_rng(6).normal(size=(T, 2, NC)).astype(np.float32)
        jl, jv = JF.fused_loss(jt, jX, jy, jw, jops, JL.l2_dist_loss, params=jnp.asarray(bank),
                               class_idx=jnp.asarray(cls), interpret=True)
        sl, sv = SF.fused_loss(st, sX, sy, sw, sops, SL.l2_dist_loss, params=_t(bank),
                               class_idx=_t(cls))
        assert np.array_equal(to_np(jv), to_np(sv)) and to_np(sv).any()
        assert_close(to_np(jl), to_np(sl), RTOL, "parametric loss")
    elif kernel in ("multi", "grad"):
        jprog, sprog = JP.compile_program(jt, F, nb), SP.compile_program(st, F, nb)
        V = 3
        cv = np.asarray(jprog.cvals)[:, None, :] * (
            1.0 + 0.3 * np.random.default_rng(8).normal(size=(T, V, jprog.cmax)))
        cv = cv.astype(np.float32)
        if kernel == "multi":
            jl, jv = JF.fused_loss_multi(jprog, jnp.asarray(cv), jX, jy, jw, F, jops,
                                         JL.l2_dist_loss, interpret=True)
            sl, sv = SF.fused_loss_multi(sprog, _t(cv), sX, sy, sw, F, sops, SL.l2_dist_loss)
            assert np.array_equal(to_np(jv), to_np(sv)) and to_np(sv).any()
            assert_close(to_np(jl), to_np(sl), RTOL, "line-search loss")
        else:
            jl, jv, jg = JF.fused_grad_multi(jprog, jnp.asarray(cv), jX, jy, jw, F, jops,
                                             JL.l2_dist_loss, interpret=True)
            sl, sv, sg = SF.fused_grad_multi(sprog, _t(cv), sX, sy, sw, F, sops,
                                             SL.l2_dist_loss)
            assert np.array_equal(to_np(jv), to_np(sv)) and to_np(sv).any()
            assert_close(to_np(jl), to_np(sl), RTOL, "gradient's loss")
            ins = SF._pack_instr(sprog, sops, F + sprog.cmax + sprog.max_steps)
            *_, raw, gabs = SF.program_grad_plain(ins, sprog.nsteps, sprog.nconst, _t(cv), sX,
                                                  sy, sw, sops, SL.l2_dist_loss, return_abs=True)
            jg, sg = to_np(jg), to_np(sg)
            scale = to_np(gabs) / float(w.sum())
            assert not np.isfinite(to_np(raw)).all()    # pdiv's 0 x inf reaches a gradient
            fin = np.isfinite(scale)
            assert (np.abs(jg - sg) <= GRAD_RTOL * scale + 1e-30)[fin].all()
            assert np.array_equal(jg[~fin] == 0, sg[~fin] == 0)
    else:
        jprog, sprog = JP.compile_program(jt, F, nb), SP.compile_program(st, F, nb)
        if kernel == "predict":
            jpred, jv = JF.fused_predict_program(jprog, jX, F, jops, tree_block=8,
                                                 interpret=True)
            spred, sv = SF.fused_predict_program(sprog, sX, F, sops)
            assert np.array_equal(to_np(jv), to_np(sv)) and 0 < to_np(sv).sum() < T
            # Valid trees' rows (XLA's CPU backend flushes subnormal results
            # to 0, so an invalid tree's 1 / subnormal may differ).
            v = to_np(sv)
            jp, sp = to_np(jpred)[v], to_np(spred)[v]
            assert np.isfinite(sp).all() and np.isfinite(jp).all()
            np.testing.assert_allclose(sp, jp, rtol=RTOL, atol=1e-6)
        else:
            ct = np.random.default_rng(9).normal(size=(T, n)).astype(np.float32)
            jg, _ = JF._fused_predict_vjp_program(jprog, jX, jnp.asarray(ct), F, jops,
                                                  interpret=True)
            sg, _ = SF.fused_predict_vjp_program(sprog, sX, _t(ct), F, sops)
            args = SF._predict_inputs(sprog, sX, F, sops)
            raw, _, gabs = SF.program_predict_vjp_plain(args[0], args[1], sprog.nconst,
                                                        args[2], args[3], _t(ct), sops,
                                                        return_abs=True)
            jg, sg, gabs = to_np(jg), to_np(sg), to_np(gabs)
            assert not np.isfinite(to_np(raw)).all()
            fin = np.isfinite(gabs)
            assert not sg[~fin].any() and not jg[~fin].any()
            assert (np.abs(jg - sg) <= GRAD_RTOL * gabs)[fin].all()


# ---------------------------------------------------------------------------
# One engine iteration with a user operator, turbo on
# ---------------------------------------------------------------------------


def test_run_iteration_with_user_ops_matches_jax():
    """One Engine.run_iteration (2 islands x 16 members, 3 cycles, the
    constant optimizer off) with gauss and pdiv and turbo on in both
    packages (the JAX kernels in interpret mode, the port's plain
    versions), from the same state and key: populations, hall of fame and
    counters, as tests/test_torch_evolve.py holds the turbo-off path."""
    X, y = problem(2)
    base = dict(maxsize=MAXSIZE, should_optimize_constants=False, save_to_file=False,
                populations=2, population_size=16, ncycles_per_iteration=3,
                tournament_selection_n=8, turbo=True)
    jo = J.Options(binary_operators=["+", "*", jop("pdiv")],
                   unary_operators=["cos", jop("gauss")], **base)
    so = S.Options(binary_operators=["+", "*", sop("pdiv")],
                   unary_operators=["cos", sop("gauss")], **base)
    jds = J.make_dataset(X, y)
    jds.update_baseline_loss(jo.elementwise_loss)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    je, se = JEngine(jo, 3), SEngine(so, 3, device="cpu")
    assert se.cfg.turbo
    jkey = jax.random.key(5)
    js = je.init_state(jkey, jds.data, 2)
    ss = interop.search_state(numpy_state(js), device="cpu")
    js2 = je.run_iteration(js, jds.data, MAXSIZE)
    ss2 = se.run_iteration(ss, sd, MAXSIZE)
    assert_pops_equal(js2.pops, ss2.pops)
    ex = to_np(js2.hof.exists)
    assert np.array_equal(ex, to_np(ss2.hof.exists))
    assert_close(to_np(js2.hof.cost)[ex], to_np(ss2.hof.cost)[ex], RTOL, "hof cost")
    assert float(js2.num_evals) == float(ss2.num_evals)
    names = {op.name for op in se.options.operators.unary + se.options.operators.binary}
    assert {"gauss", "pdiv"} <= names


def test_a_covering_library_serves_a_subset(monkeypatch):
    """A kernel wrapper that has loaded the library of an operator set
    binds it for a set whose user operators it covers (the same code under
    the same ids, as + - * / gauss softplus under + - * pdiv gauss
    softplus), loading nothing more; a set it does not cover loads its
    own. (No library is built here: the load is counted, not run.)"""
    from types import SimpleNamespace

    loads = []

    def fake_load(name, user_header=None):
        loads.append((name, user_header))
        entry = SimpleNamespace()
        return SimpleNamespace(sr_program_eval=entry, sr_program_eval_smem=SimpleNamespace())

    monkeypatch.setattr(cuda_build, "load_library", fake_load)
    with_pdiv = S.OperatorSet(["+", "-", "*", sop("pdiv")], ["exp", sop("gauss"),
                                                             sop("softplus")])
    with_div = S.OperatorSet(["+", "-", "*", "/"], ["exp", sop("gauss"), sop("softplus")])
    other = S.OperatorSet(["+", "*"], ["exp", sop("softplus"), sop("gauss")])
    a, b, c = (UO.user_op_set(o) for o in (with_pdiv, with_div, other))
    assert a.covers(b) and not b.covers(a) and not a.covers(c)
    kernel = SF.ProgramEvalKernel()
    lib = kernel.library(with_pdiv)
    assert kernel.library(with_div) is lib and len(loads) == 1
    assert kernel.library(other) is not lib and len(loads) == 2
    assert loads[0][1] == a.header and loads[1][1] == c.header
