"""User elementwise losses with turbo on: the port's user-loss route
against the JAX package's kernels.

The JAX package traces a user callable ``elementwise_loss(pred, target)``
into its kernels #1-#3. The port's kernels take library losses only, so
a user callable takes the user-loss route of ``ops/fused_eval.py``:
kernel #4's predictions in chunks of trees, the callable in PyTorch, and
for the gradient ``torch.autograd`` through it with kernel #5 in the
backward. Here, on the CPU, #4 and #5 run their plain versions and the
JAX package's kernels run in interpret mode. Each loss below is written
once and called on jnp arrays and torch tensors alike. Losses and costs
agree within rtol 1e-5 with validity bit-equal and inf in the same places;
gradients within 1e-4 of the sum of the absolute per-row terms (the rows
are summed in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.evolve import constant_opt as JC
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu.ops import fused_eval as JF
from symbolicregression_jl_tpu.ops.program import compile_program as j_compile
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.evolve import constant_opt as SC
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine
from symbolicregression_jl_tpu_torch.ops import fused_eval as SF
from symbolicregression_jl_tpu_torch.ops.program import compile_program

from test_torch_constant_opt import _assert_optimizer_equal, _fixed
from test_torch_fused_eval import _assert_grad_close, _batch, _data, _j, _t, _variants
from torch_parity import POP_INT_FIELDS, TREE_FIELDS, assert_close, numpy_state, port_key, \
    problem, to_np

RTOL = 1e-5

LOSSES = {
    "quartic": lambda p, t: (p - t) ** 4,
    "abs": lambda p, t: abs(p - t),
    "scaled": lambda p, t: (p - t) ** 2 / (1.0 + abs(t)),
}
IDS = sorted(LOSSES)


class _Calls:
    """Counts a kernel wrapper's calls and forbids others: the route must
    reach kernel #4 (and #5), never #1-#3."""

    def __init__(self, monkeypatch):
        self.n = {"predict": 0, "vjp": 0}
        for name in ("PROGRAM_EVAL", "PROGRAM_MULTI", "PROGRAM_GRAD"):
            monkeypatch.setattr(SF, name, self._forbid(name))
        for name, key in (("PROGRAM_PREDICT", "predict"), ("PROGRAM_PREDICT_VJP", "vjp")):
            monkeypatch.setattr(SF, name, self._count(getattr(SF, name), key))

    @staticmethod
    def _forbid(name):
        def run(*a, **k):
            raise AssertionError(f"{name} saw a user loss")
        return run

    def _count(self, kernel, key):
        def run(*a, **k):
            self.n[key] += 1
            return kernel(*a, **k)
        return run


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", IDS)
def test_user_loss_and_cost_match_jax(case, weighted, monkeypatch):
    """fused_loss (plain and dedup) and fused_cost with a user callable:
    validity bit-equal, loss and cost within rtol 1e-5 with inf in the
    same places; the dedup'd loss bit-equal to the plain one; only kernel
    #4 runs."""
    calls = _Calls(monkeypatch)
    loss_fn = LOSSES[case]
    jops, sops, jt, st = _batch("merged", 5, T=24)
    X, y, w = _data(97, weighted, 5)
    jl, jv = JF.fused_loss(jt, _j(X), _j(y), _j(w), jops, loss_fn, interpret=True)
    sl, sv = SF.fused_loss(st, _t(X), _t(y), _t(w), sops, loss_fn)
    assert np.array_equal(to_np(jv), to_np(sv))
    assert to_np(sv).sum() >= 8 and not to_np(sv).all()
    assert_close(to_np(jl), to_np(sl), RTOL, "loss")
    dl, dv = SF.fused_loss(st, _t(X), _t(y), _t(w), sops, loss_fn, dedup=True)
    assert torch.equal(dl, sl) and torch.equal(dv, sv)
    cx = np.random.default_rng(3).integers(1, 10, jt.length.shape[0]).astype(np.int32)
    jc, jl2, jv2 = JF.fused_cost(jt, _j(X), _j(y), _j(w), _j(cx), jops, loss_fn, interpret=True,
                                 baseline_loss=jnp.float32(1.7), use_baseline=jnp.bool_(True),
                                 parsimony=0.01)
    sc, sl2, sv2 = SF.fused_cost(st, _t(X), _t(y), _t(w), _t(cx), sops, loss_fn,
                                 baseline_loss=torch.tensor(1.7), use_baseline=torch.tensor(True),
                                 parsimony=0.01)
    assert np.array_equal(to_np(jv2), to_np(sv2))
    assert_close(to_np(jl2), to_np(sl2), RTOL, "cost-form loss")
    assert_close(to_np(jc), to_np(sc), RTOL, "cost")
    assert calls.n["predict"] == 3 and calls.n["vjp"] == 0


def test_zero_weight_rows_are_inert(monkeypatch):
    """A loss that is NaN or inf on the zero-weight rows leaves the other
    rows' sum alone, in both packages, and the targets of those rows do not
    move the loss by a bit."""
    monkeypatch.setattr(SF, "USER_LOSS_CHUNK_BYTES", 1 << 12)   # several chunks
    loss_fn = lambda p, t: (p - t) ** 2 / (t - 5.0)  # noqa: E731
    jops, sops, jt, st = _batch("merged", 6, T=24)
    X, y, w = _data(97, True, 6)
    y = np.where(w > 0, np.minimum(y, 4.0), 5.0).astype(np.float32)
    jl, jv = JF.fused_loss(jt, _j(X), _j(y), _j(w), jops, loss_fn, interpret=True)
    sl, sv = SF.fused_loss(st, _t(X), _t(y), _t(w), sops, loss_fn)
    assert np.array_equal(to_np(jv), to_np(sv)) and to_np(sv).sum() >= 8
    assert_close(to_np(jl), to_np(sl), RTOL, "loss")
    y2 = np.where(w > 0, y, -7.0).astype(np.float32)
    sl2, sv2 = SF.fused_loss(st, _t(X), _t(y2), _t(w), sops, loss_fn)
    assert torch.equal(sl2, sl) and torch.equal(sv2, sv)


@pytest.mark.parametrize("case", IDS)
def test_user_loss_multi_and_grad_match_jax(case, monkeypatch):
    """The line search's and the gradient's routes against the JAX
    package's kernels #2 and #3 with the callable traced in: validity
    bit-equal, losses within rtol 1e-5 with inf in the same places, the
    gradient route's loss bit-equal to the line search's, gradients
    zeroed in the same places and otherwise within 1e-4 of the sum of the
    absolute per-row terms. The route runs in several chunks here."""
    monkeypatch.setattr(SF, "USER_LOSS_CHUNK_BYTES", 1 << 13)
    calls = _Calls(monkeypatch)
    loss_fn = LOSSES[case]
    jops, sops, jt, st = _batch("merged", 4, T=12)
    X, y, w = _data(64, True, 4)
    jp = j_compile(jt, 3, len(jops.binary))
    sp = compile_program(st, 3, len(sops.binary))
    cv = _variants(jp, 3, 4)
    args_j = (jp, _j(cv), _j(X), _j(y), _j(w), 3, jops, loss_fn)
    args_s = (sp, _t(cv), _t(X), _t(y), _t(w), 3, sops, loss_fn)
    jl, jv = JF.fused_loss_multi(*args_j, interpret=True)
    sl, sv = SF.fused_loss_multi(*args_s)
    assert np.array_equal(to_np(jv), to_np(sv))
    assert_close(to_np(jl), to_np(sl), RTOL, "loss")
    jgl, jgv, jg = JF.fused_grad_multi(*args_j, interpret=True)
    sgl, sgv, sg = SF.fused_grad_multi(*args_s)
    assert np.array_equal(to_np(jgv), to_np(sgv))
    assert np.array_equal(to_np(sgl).view(np.int32), to_np(sl).view(np.int32))
    assert calls.n["predict"] > 2 and calls.n["vjp"] == calls.n["predict"] // 2
    # The absolute per-row terms: kernel #5's plain version seeded with the
    # rows' loss cotangents, summing |adjoint| per constant.
    T, V, CM = cv.shape
    instr = SF._pack_instr(sp, sops, 3 + CM + sp.max_steps)
    rows = torch.arange(T).repeat_interleave(V)
    c = _t(cv).reshape(T * V, CM)
    ok = torch.ones(T * V, dtype=torch.int32)
    pred, _ = SF.program_predict_plain(instr[rows], sp.nsteps[rows], c, ok, _t(X), sops)
    p = pred.clone().requires_grad_(True)
    (dp,) = torch.autograd.grad(loss_fn(p, _t(y)), p, _t(w).expand_as(p))
    ct = torch.where(_t(w) > 0, dp, 0.0)
    *_, gabs = SF.program_predict_vjp_plain(instr[rows], sp.nsteps[rows], sp.nconst[rows], c,
                                            _t(X), ct, sops, return_abs=True)
    scale = to_np(gabs).reshape(T, V, CM) / float(w.sum())
    _assert_grad_close(to_np(jg), to_np(sg), scale, case)


@pytest.mark.parametrize("case", ["square", "quartic"])
def test_optimize_constants_fused_user_loss_matches_jax(case, monkeypatch):
    """The fused L-BFGS with a user callable (the port's user-loss route,
    the JAX package's kernels #2 and #3 in interpret mode) on identifiable
    trees, as tests/test_torch_constant_opt.py holds it with L2: f_calls
    and improved equal, losses within rtol 1e-5, constants within rtol
    1e-3."""
    calls = _Calls(monkeypatch)
    loss_fn = (lambda p, t: (p - t) ** 2) if case == "square" else LOSSES["quartic"]
    jops, sops, jt, st, jds, sd, do_opt = _fixed()
    key = jax.random.key(3)
    jr = JC.optimize_constants_fused(key, jt, jnp.asarray(do_opt), jds.data, loss_fn, jops,
                                     JC.OptimizerConfig(), interpret=True)
    sr = SC.optimize_constants_fused(port_key(key), st, torch.from_numpy(do_opt), sd, loss_fn,
                                     sops, SC.OptimizerConfig())
    _assert_optimizer_equal(jr, sr)
    # 8 line searches, and 9 gradients with kernel #5 in each backward.
    assert calls.n["vjp"] == 9 and calls.n["predict"] == 8 + 9


# Seed 1 with annealing parts at a temperature-0 tie: one candidate's cost
# is an ULP apart in the two row-sum orders (ROADMAP queue 3, "Annealing at
# temperature 0"); without annealing it agrees member for member.
@pytest.mark.parametrize("seed,annealing", [(1, False), (2, True), (3, True), (4, True)])
def test_run_iteration_user_loss_turbo_equal(seed, annealing):
    """One Engine.run_iteration with a user callable and turbo on, from
    the same state and key, the constant optimizer off (as the log-cosh
    iteration in tests/test_torch_losses.py): integer member fields equal,
    constants, costs and losses within rtol 1e-5, the hall of fame equal.
    The port's engine runs no cost epilogue for the callable."""
    X, y = problem(seed)
    loss_fn = LOSSES["scaled"]
    kw = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"], maxsize=15,
              populations=2, population_size=16, ncycles_per_iteration=2,
              tournament_selection_n=8, turbo=True, elementwise_loss=loss_fn,
              should_optimize_constants=False, save_to_file=False, annealing=annealing)
    jo, so = J.Options(eval_tree_block=1, **kw), S.Options(**kw)
    jds = J.make_dataset(X, y)
    jds.update_baseline_loss(jo.elementwise_loss)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    je, se = JEngine(jo, 3), SEngine(so, 3, device="cpu")
    assert je.cfg.turbo and se.cfg.turbo and not se.cfg.fuse_cost
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


def test_turbo_search_with_user_loss_runs_on_cpu(monkeypatch):
    """equation_search with turbo=True and a user callable runs to its end
    on the CPU through kernels #4 and #5's plain versions (the optimizer
    on, its default), never #1-#3; the best member's reported loss is the
    callable's mean over the rows of its decoded expression."""
    calls = _Calls(monkeypatch)
    loss_fn = LOSSES["abs"]
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, (200, 2)).astype(np.float32)
    y = (2.5 * np.cos(1.3 * X[:, 1]) + X[:, 0]).astype(np.float32)
    o = S.Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=12,
                  populations=4, population_size=32, ncycles_per_iteration=10,
                  tournament_selection_n=8, save_to_file=False, turbo=True,
                  elementwise_loss=loss_fn)
    hof = S.equation_search(X, y, options=o, niterations=2, seed=0, device="cpu", verbosity=0)
    assert calls.n["predict"] > 0 and calls.n["vjp"] > 0
    best = min(hof.entries, key=lambda e: e.loss)
    pred = np.array([best.tree.eval_scalar(row) for row in X.astype(np.float64)])
    np.testing.assert_allclose(best.loss, np.mean(np.abs(pred - y)), rtol=1e-4)
    assert best.loss < np.mean(np.abs(y - y.mean()))
