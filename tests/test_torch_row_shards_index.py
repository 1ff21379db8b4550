"""ValidVector indexing in template combiners, unsharded and under data-row
shards, against the JAX package.

What ``v[idx]`` indexes depends on the operand's shape, in both packages: a
dataset column in a combiner is the shared rows [n], so ``x1[0]`` reads
row 0; a subexpression's output is member-batched [M, n] (the combiner is
traced once over the batch), so ``g(x2)[0]`` reads member 0's rows, and
``eval_template_single`` (the M = 1 wrapper) reads the member's own. The
port keeps this as the JAX package has it.

Under data-row shards (2 gloo CPU ranks, ``parallel/launch.run_ranks``;
the kernels' plain versions, ``turbo`` on), an index that reaches the rows
gathers every rank's rows, indexes the whole array and keeps this rank's
block (or the whole result, when it is shorter: a scalar row); its
gradient adds every rank's cotangent in rank order. For an int, a
negative int, a reversing slice and a permutation of a column's rows, a
subexpression's members and a subexpression's rows:

- template losses within rtol 1e-5 of the unsharded port's and of the JAX
  package's evaluation, inf in the same places;
- the constants' gradient (#5 backward, the shards' partials added)
  within rtol 1e-4 of the unsharded port's;
- an engine's initial losses within rtol 1e-5 of the unsharded engine's,
  and one iteration with the template optimizer from one seed twice
  bit-identical.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import symbolicregression_jl_tpu as J
from symbolicregression_jl_tpu.core import losses as JL
from symbolicregression_jl_tpu.evolve import step as JS
from symbolicregression_jl_tpu.evolve.population import (
    init_template_population as j_init_template)
from symbolicregression_jl_tpu.models import template as JT
import symbolicregression_jl_tpu_torch as srt
from symbolicregression_jl_tpu_torch.evolve import rng
from symbolicregression_jl_tpu_torch.evolve.engine import Engine
from symbolicregression_jl_tpu_torch.evolve.step import eval_cost_batch
from symbolicregression_jl_tpu_torch.models import template as ST
from symbolicregression_jl_tpu_torch.ops.encoding import TreeBatch
from symbolicregression_jl_tpu_torch.ops.eval import eval_tree_batch
from symbolicregression_jl_tpu_torch.parallel.launch import run_ranks

from torch_parity import assert_close, to_np
import torch_row_shard_workers as W

TESTS = os.path.dirname(os.path.abspath(__file__))
NAMES = tuple(W.INDEX_COMBINERS)
ENGINE_NAMES = ("int", "output_rows")
SEED = 3


def _problem():
    rs = np.random.default_rng(21)
    X = rs.uniform(-2, 2, (W.INDEX_ROWS, 2)).astype(np.float32)
    y = (1.5 * np.cos(X[:, 0]) * X[:, 1][::-1] - X[0, 0]).astype(np.float32)
    return X, y


def _jax_members():
    """Template members drawn by the JAX package, and its options."""
    jo = J.Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=10,
                   save_to_file=False)
    spec = JT.template_spec(expressions=("f", "g"))(W.INDEX_COMBINERS["int"])
    cfg = JS.evolve_config_from_options(jo, 2, template=spec.structure)
    return jo, j_init_template(jax.random.key(7), 12, spec.structure, cfg.mctx, jnp.float32)


def _np(tree):
    return {f: np.asarray(getattr(tree, f)) for f in ("arity", "op", "feat", "const", "length")}


def _port(tree) -> TreeBatch:
    return TreeBatch(*(torch.from_numpy(np.asarray(getattr(tree, f)).copy())
                       for f in ("arity", "op", "feat", "const", "length")))


def _jax_loss(jo, jt, X, y, name):
    spec = JT.template_spec(expressions=("f", "g"))(W.INDEX_COMBINERS[name])
    pred, valid = JT.eval_template_batch(jt, jnp.asarray(X.T), spec.structure, jo.operators)
    return np.asarray(JL.aggregate_loss(JL.l2_dist_loss, pred, jnp.asarray(y), valid))


def _full_data(X, y, options):
    ds = srt.make_dataset(X, y, device="cpu")
    ds.update_baseline_loss(options.elementwise_loss)
    return ds.data


def test_index_reads_rows_of_a_column_and_members_of_an_output():
    """The same combiner indexes a column's rows and a subexpression's
    members, in both packages; one member alone reads its own output."""
    X, _ = _problem()
    jo, jt = _jax_members()
    pt = _port(jt)
    ops = srt.Options(binary_operators=["+", "-", "*"], unary_operators=["cos"]).operators
    Xt = torch.from_numpy(X.T.copy())

    def both(fn, trees_j, trees_p, single=False):
        spec_j = JT.template_spec(expressions=("f", "g"))(fn)
        spec_p = srt.models.template_spec(expressions=("f", "g"))(fn)
        if single:
            yj, vj = JT.eval_template_single(trees_j, jnp.asarray(X.T), spec_j.structure,
                                             jo.operators)
            yp, vp = ST.eval_template_single(trees_p, Xt, spec_p.structure, ops)
        else:
            yj, vj = JT.eval_template_batch(trees_j, jnp.asarray(X.T), spec_j.structure,
                                            jo.operators)
            yp, vp = ST.eval_template_batch(trees_p, Xt, spec_p.structure, ops)
        assert np.array_equal(to_np(vj), to_np(vp))
        # Predictions row by row: within 1e-5, or a few float32 ULPs of
        # the operands (about 2) where a sum cancels.
        a, b = to_np(yj), to_np(yp)
        assert np.array_equal(np.isfinite(a), np.isfinite(b))
        ok = np.isfinite(a)
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-5, atol=1e-6)
        return b

    quirk = lambda f, g, x1, x2: f(x1)[0] + x1[0] * g(x2)
    sub = lambda k, col: eval_tree_batch(TreeBatch(*(f[:, k] for f in pt.fields())),
                                         Xt[col:col + 1], ops)[0].numpy()
    F, G = sub(0, 0), sub(1, 1)     # f of x1 and g of x2, per member
    batched = both(quirk, jt, pt)
    ok = np.isfinite(batched)
    np.testing.assert_allclose(batched[ok], (F[0][None, :] + X[0, 0] * G)[ok], rtol=1e-5,
                               atol=1e-6)
    m = 5
    one = both(quirk, jax.tree.map(lambda a: a[m], jt), TreeBatch(*(f[m] for f in pt.fields())),
               single=True)
    np.testing.assert_allclose(one, F[m] + X[0, 0] * G[m], rtol=1e-5, atol=1e-6)


def test_index_under_row_shards(tmp_path):
    X, y = _problem()
    jo, jt = _jax_members()
    pt = _port(jt)
    ranks = run_ranks("torch_row_shard_workers:index_checks", 2, kwargs=dict(
        X=X, y=y, tmpl_trees=_np(jt), n_shards=2, names=NAMES, engine_names=ENGINE_NAMES,
        seed=SEED), sys_path=[TESTS], timeout_s=200, workdir=str(tmp_path / "ranks"))
    for name in NAMES:
        options = W.index_options(name)
        data = _full_data(X, y, options)
        engine = Engine(options, 2, device="cpu")
        cost, loss, _ = eval_cost_batch(pt, data, options.elementwise_loss, engine.tables,
                                        engine.cfg.operators, options.parsimony, turbo=True,
                                        template=engine.template)
        grad = W.template_grad(pt, data, engine.template)
        assert np.isfinite(loss.numpy()).sum() >= 6, name
        assert_close(_jax_loss(jo, jt, X, y, name), loss.numpy(), 1e-5, f"{name}: JAX loss")
        for r in ranks:
            assert_close(loss.numpy(), r[f"{name}_loss"], 1e-5, f"{name}: loss")
            assert_close(cost.numpy(), r[f"{name}_cost"], 1e-5, f"{name}: cost")
            assert_close(grad.numpy(), r[f"{name}_grad"], 1e-4, f"{name}: gradient")
        assert np.array_equal(ranks[0][f"{name}_loss"], ranks[1][f"{name}_loss"])
    # a gradient that crosses ranks: g's constants get rows of both blocks
    assert np.abs(ranks[0]["output_rows_grad"]).sum() > 0
    for name in ENGINE_NAMES:
        options = W.index_options(name)
        engine = Engine(options, 2, device="cpu")
        st = engine.init_state(rng.key(SEED), _full_data(X, y, options), options.populations)
        for r in ranks:
            assert_close(st.pops.loss.numpy(), r[f"{name}_init_loss"], 1e-5, f"{name}: init")
            assert r[f"{name}_repeat_equal"], name
        assert np.array_equal(ranks[0][f"{name}_iter_loss"], ranks[1][f"{name}_iter_loss"])
