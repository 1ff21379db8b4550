"""Data-row shards on the kernel path against the JAX package's data-sharded
evaluation.

The port runs N gloo CPU ranks (``parallel/launch.run_ranks``), one island
shard and N data shards: each rank holds a block of the rows and calls
the kernel wrappers (their plain versions here, ``turbo`` on), which add
every shard's row sums, denominators and validity before the mean
(``ops/fused_eval._row_totals``). The JAX package evaluates the same
members on the conftest's virtual CPU devices with the rows placed on its
mesh's data axis (``MeshPlan.place_data``): its interpreter and loss under
GSPMD, which is what its engine runs with ``n_data_shards > 1``. Losses
and costs agree within rtol 1e-5 with inf in the same places, validity
is bit-equal, and every rank returns the same bits.

Kernel #3's gradient follows the JAX kernel's derivative rules, so it is
held against the JAX package's ``fused_grad_multi`` (interpret mode, every
row), and against the sharded interpreter's ``jax.grad`` wherever that
is finite: the interpreter's guarded operators give NaN where the kernel
rules give a finite value (the first constant of ``x2 * cos(c / x3)``
here). Gradients agree within 1e-5 of the sum of the absolute per-row
terms (the packages add the rows in other orders, and the terms may
cancel).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import symbolicregression_jl_tpu as J
from symbolicregression_jl_tpu.core import losses as JL
from symbolicregression_jl_tpu.evolve import step as JS
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu.evolve.population import init_params as j_init_params
from symbolicregression_jl_tpu.evolve.population import init_population as j_init_population
from symbolicregression_jl_tpu.evolve.population import (
    init_template_population as j_init_template)
from symbolicregression_jl_tpu.mesh import MeshPlan as JMeshPlan
from symbolicregression_jl_tpu.models import template as JT
from symbolicregression_jl_tpu.ops import encoding as JE
from symbolicregression_jl_tpu.ops import fused_eval as JF
from symbolicregression_jl_tpu.ops.eval import eval_tree_batch as j_eval
from symbolicregression_jl_tpu.ops.program import compile_program as j_compile
from symbolicregression_jl_tpu_torch.ops import fused_eval as SF
from symbolicregression_jl_tpu_torch.ops.program import compile_program
from symbolicregression_jl_tpu_torch.parallel.launch import run_ranks

from torch_parity import assert_close, to_np
import torch_row_shard_workers as W

TESTS = os.path.dirname(os.path.abspath(__file__))
RTOL = 1e-5
N_ROWS = 260          # 130 rows a shard with 2, 65 with 4
MAXSIZE = 12
V = 4


def _problem():
    rng = np.random.default_rng(17)
    X = rng.uniform(-2, 2, (N_ROWS, 3)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + np.cos(X[:, 2])).astype(np.float32)
    w = rng.uniform(0.5, 2.0, N_ROWS).astype(np.float32)
    w[rng.random(N_ROWS) < 0.1] = 0.0
    classes = rng.integers(0, 3, N_ROWS)
    return X, y, w, classes


@pytest.fixture(scope="module")
def members():
    """Plain members with perturbed constant vectors (one inf and one NaN
    candidate), parametric members with their banks, template members; the
    JAX engine whose tables and operators both sides share."""
    jo = J.Options(**W.OPERATORS, maxsize=MAXSIZE, save_to_file=False)
    je = JEngine(jo, 3)
    cfg = je.cfg
    rand = j_init_population(jax.random.key(3), 20, cfg.mctx, jnp.float32)
    hand = JE.encode_population(
        [J.parse_expression(e, cfg.operators, ["x1", "x2", "x3"])
         for e in ("x1 * x2 - cos(x3)", "x1 / (x2 - x2)", "exp(exp(exp(x3 * 3.0)))",
                   "2.5 * x1 - x3")], MAXSIZE, cfg.operators)
    plain = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), rand, hand)
    jp = j_compile(plain, 3, len(cfg.operators.binary))
    rng = np.random.default_rng(4)
    cv = (np.asarray(jp.cvals)[:, None, :] * (
        1.0 + 0.3 * rng.normal(size=(jp.cvals.shape[0], V, jp.cvals.shape[1])))).astype(
        np.float32)
    used = np.arange(cv.shape[2])[None, :] < np.asarray(jp.nconst)[:, None]
    t = np.argwhere(used[:, 0])[:2, 0]
    cv[t[0], V - 1, 0] = np.inf
    cv[t[1], 0, 0] = np.nan

    pcfg = JS.evolve_config_from_options(jo, 3, n_params=2, n_classes=3)
    ptrees = j_init_population(jax.random.key(5), 12, pcfg.mctx, jnp.float32)
    params = j_init_params(jax.random.key(6), (12,), 2, 3, jnp.float32)

    spec = JT.template_spec(expressions=("f", "g"))(
        lambda f, g, x1, x2, x3: f(x1, x2) + g(x3))
    tcfg = JS.evolve_config_from_options(jo, 3, template=spec.structure)
    ttrees = j_init_template(jax.random.key(7), 12, spec.structure, tcfg.mctx, jnp.float32)
    return dict(je=je, plain=plain, jp=jp, cv=cv, ptrees=ptrees, params=params,
                spec=spec, ttrees=ttrees)


def _np(tree):
    return {f: np.asarray(getattr(tree, f)) for f in ("arity", "op", "feat", "const", "length")}


def _slot_consts(plain, jp, cv):
    """[T * V, L] slot-space constants of every (tree, vector) pair."""
    T, L = plain.const.shape
    c = np.repeat(np.asarray(plain.const)[:, None, :], V, axis=1).copy()
    cslot, nconst = np.asarray(jp.cslot), np.asarray(jp.nconst)
    for ti in range(T):
        for k in range(int(nconst[ti])):
            c[ti, :, cslot[ti, k]] = cv[ti, :, k]
    return c.reshape(T * V, L)


def _jax_reference(m, n_shards, X, y, w, classes):
    """The JAX package's data-sharded evaluation of the same members."""
    je, plain, jp, cv = m["je"], m["plain"], m["jp"], m["cv"]
    ops = je.cfg.operators
    el = JL.l2_dist_loss
    plan = JMeshPlan.build(jax.devices()[:n_shards], n_island_shards=1,
                           n_data_shards=n_shards)

    def placed(**kw):
        ds = J.make_dataset(X, y, **kw)
        ds.update_baseline_loss(el)
        return plan.place_data(ds.data)

    data, pdata, tdata = placed(weights=w), placed(extra={"class": classes}), placed()
    T, L = plain.const.shape
    rep = lambda a: jnp.repeat(a, V, axis=0)

    def pair_loss(c):
        t = JE.TreeBatch(rep(plain.arity), rep(plain.op), rep(plain.feat), c, rep(plain.length))
        pred, valid = j_eval(t, data.Xt, ops)
        return JL.aggregate_loss(el, pred, data.y, valid, data.weights)

    finite_sum = lambda f: lambda c: jnp.sum(jnp.where(jnp.isfinite(f(c)), f(c), 0.0))
    c = jnp.asarray(_slot_consts(plain, jp, cv))
    out = {"loss_multi": jax.jit(pair_loss)(c).reshape(T, V)}
    g = np.asarray(jax.jit(jax.grad(finite_sum(pair_loss)))(c)).reshape(T, V, L)
    cslot = np.minimum(np.asarray(jp.cslot), L - 1)
    gc = np.take_along_axis(g, np.broadcast_to(cslot[:, None, :], (T, V, cslot.shape[1])), 2)
    used = np.arange(cslot.shape[1])[None, None, :] < np.asarray(jp.nconst)[:, None, None]
    out["grad"] = np.where(used & np.isfinite(gc), gc, 0.0)
    out["grad_kernel"] = JF.fused_grad_multi(jp, jnp.asarray(cv), jnp.asarray(X.T),
                                             jnp.asarray(y), jnp.asarray(w), 3, ops, el,
                                             interpret=True)[2]
    cost, loss, _ = jax.jit(lambda d: JS.eval_cost_batch(plain, d, el, je.tables, ops,
                                                         je.cfg.parsimony))(data)
    out["cost"], out["loss"] = cost, loss
    pcost, ploss, _ = jax.jit(lambda d: JS.eval_cost_batch(
        m["ptrees"], d, el, je.tables, ops, je.cfg.parsimony,
        member_params=m["params"]))(pdata)
    out["param_cost"], out["param_loss"] = pcost, ploss
    structure = m["spec"].structure
    tt = m["ttrees"]
    tcost, tloss, _ = jax.jit(lambda d: JS.eval_cost_batch(
        tt, d, el, je.tables, ops, je.cfg.parsimony, template=structure))(tdata)
    out["tmpl_cost"], out["tmpl_loss"] = tcost, tloss

    def tmpl_loss(const):
        member = JE.TreeBatch(tt.arity, tt.op, tt.feat, const, tt.length)
        pred, valid = JT.eval_template_batch(member, tdata.Xt, structure, ops)
        return JL.aggregate_loss(el, pred, tdata.y, valid, tdata.weights)

    tg = np.asarray(jax.jit(jax.grad(finite_sum(tmpl_loss)))(tt.const))
    out["tmpl_grad"] = np.where(np.isfinite(tg), tg, 0.0)
    return {k: to_np(v) for k, v in out.items()}


def _grad_scale(m, X, y, w):
    """Each pair's sum of the absolute per-row gradient terms over every
    row, from the port's unsharded plain version of #3."""
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch import interop

    ops = Options(**W.OPERATORS, save_to_file=False).operators
    st = interop.tree_batch(jax.tree.map(np.asarray, m["plain"]), device="cpu")
    sp = compile_program(st, 3, len(ops.binary))
    instr = SF._pack_instr(sp, ops, 3 + sp.cmax + sp.max_steps)
    wt = torch.from_numpy(w)
    *_, gabs = SF.program_grad_plain(instr, sp.nsteps, sp.nconst, torch.from_numpy(m["cv"]),
                                     torch.from_numpy(np.ascontiguousarray(X.T)),
                                     torch.from_numpy(y), wt,
                                     ops, Options(save_to_file=False).elementwise_loss,
                                     return_abs=True)
    return to_np(gabs) / float(wt.sum())


def _within(jg, sg, scale, what):
    """Zeroed components in the same places; elsewhere within RTOL of
    ``scale``."""
    assert np.array_equal(jg == 0, sg == 0), what
    live = jg != 0
    err = np.abs(jg - sg)[live] - RTOL * scale[live]
    assert np.all(err <= 0), (what, float(np.max(err, initial=0)))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_kernels_on_row_shards_match_jax_sharded_eval(n_shards, members, tmp_path):
    X, y, w, classes = _problem()
    m = members
    ranks = run_ranks("torch_row_shard_workers:parity", n_shards, kwargs=dict(
        X=X, y=y, w=w, plain=_np(m["plain"]), cv=m["cv"], classes=classes,
        param_trees=_np(m["ptrees"]), params=np.asarray(m["params"]),
        tmpl_trees=_np(m["ttrees"]), n_shards=n_shards),
        sys_path=[TESTS], timeout_s=110, workdir=str(tmp_path / "ranks"))
    # each rank held its block, and every rank holds the same results
    assert [int(r["rows"]) for r in ranks] == [N_ROWS // n_shards] * n_shards
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if k != "rows":
                assert np.array_equal(np.asarray(v).view(np.uint8),
                                      np.asarray(r[k]).view(np.uint8)), k
    s = ranks[0]
    j = _jax_reference(m, n_shards, X, y, w, classes)
    finite = np.isfinite(j["loss_multi"])
    assert not finite.all() and finite.any()
    for k in ("valid_multi", "valid_grad"):
        assert np.array_equal(s[k], finite), k
    assert_close(j["loss_multi"], s["loss_multi"], RTOL, "loss_multi")
    assert np.array_equal(s["loss_grad"].view(np.int32), s["loss_multi"].view(np.int32))
    scale = _grad_scale(m, X, y, w)
    _within(j["grad_kernel"], s["grad"], scale, "grad")
    finite = j["grad"] != 0     # the interpreter's NaN components are zeroed
    assert finite.sum() > 0.9 * (s["grad"] != 0).sum()
    _within(j["grad"][finite], s["grad"][finite], scale[finite], "interpreter grad")
    for k in ("loss", "cost"):
        assert_close(j[k], s[k], RTOL, k)
    assert np.array_equal(s["valid"], np.isfinite(j["loss"]))
    # the dedup finalize and the engine's loss are the plain launch's bits
    for k in ("loss_dedup", "cost_loss"):
        assert np.array_equal(s[k].view(np.int32), s["loss"].view(np.int32)), k
    assert np.array_equal(s["valid_dedup"], s["valid"])
    for k in ("param_cost", "param_loss", "tmpl_cost", "tmpl_loss"):
        assert np.isfinite(j[k]).any(), k
        assert_close(j[k], s[k], RTOL, k)
    tg, sg = j["tmpl_grad"], s["tmpl_grad"]
    assert np.array_equal(tg == 0, sg == 0)
    # the template's per-row terms: within RTOL of each member's largest
    # component (the rows of one member's call sites are summed in other
    # orders)
    scale = np.max(np.abs(tg), axis=(1, 2), keepdims=True)
    assert np.all(np.abs(tg - sg) <= RTOL * np.broadcast_to(scale, tg.shape) + 1e-7)
