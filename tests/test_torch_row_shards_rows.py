"""Which rows a data-row shard reads: minibatches, graftstage's screening
sample, custom whole-prediction losses, a rank that holds none of a
minibatch's rows, and one seed run twice (2 gloo CPU ranks,
``parallel/launch.run_ranks``; the kernels' plain versions, ``turbo`` on).

- The minibatch is drawn over the whole dataset's rows, as the JAX package
  draws it (``jax.random.randint``); each rank takes the draws in its
  block, and the ranks' parts cover the batch once. The loss of the
  batch on 2 shards equals the loss on 1 within rtol 1e-6 (the row sums
  are added in another order).
- The screening rows of the ranks are the unsharded strided sample.
- A custom whole-prediction loss sees the whole prediction (gathered in
  row order), so its loss is bit-identical to the unsharded one: the
  operators here (+ - * /) round the same on any row count.
- A minibatch whose rows all lie in the first block: the other rank adds
  zero partials and "all valid" without running a kernel over zero rows,
  so every result is the first rank's own, bit-identical to one shard.
- One seed and layout twice (minibatches, the screening sample and the
  optimizer on): bit-identical states.
"""

import os

import jax
import numpy as np
import torch

import symbolicregression_jl_tpu_torch as srt
from symbolicregression_jl_tpu_torch.evolve import rng
from symbolicregression_jl_tpu_torch.evolve.engine import Engine
from symbolicregression_jl_tpu_torch.evolve.population import (init_population,
                                                               init_template_population)
from symbolicregression_jl_tpu_torch.evolve.step import eval_cost_batch
from symbolicregression_jl_tpu_torch.ops.fused_eval import (fused_grad_multi, fused_loss,
                                                            fused_loss_multi,
                                                            strided_sample_indices)
from symbolicregression_jl_tpu_torch.ops.program import compile_program
from symbolicregression_jl_tpu_torch.parallel.launch import run_ranks

from torch_parity import assert_close
import torch_row_shard_workers as W

TESTS = os.path.dirname(os.path.abspath(__file__))
N_ROWS, BATCH, SAMPLE, SEED = 203, 48, 64, 11    # blocks of 102 and 101 rows


def _np(t):
    return {f: getattr(t, f).numpy() for f in ("arity", "op", "feat", "const", "length")}


def test_minibatch_sample_custom_loss_and_empty_rank(tmp_path):
    rs = np.random.default_rng(2)
    X = rs.uniform(-2, 2, (N_ROWS, 3)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] - 0.5 * X[:, 2]).astype(np.float32)
    options = W.feature_options("batching", batch_size=BATCH,
                                binary_operators=["+", "-", "*", "/"], unary_operators=[])
    ops, el = options.operators, options.elementwise_loss
    engine = Engine(options, 3, device="cpu")
    trees = init_population(rng.split(rng.key(3), 1), 16, engine.cfg.mctx)
    trees = trees.reshape(16)
    tengine = Engine(W.feature_options("template"), 3, device="cpu")
    tmpl = init_template_population(rng.split(rng.key(4), 1), 6, W.template_structure().structure,
                                    tengine.cfg.mctx)
    tmpl = type(tmpl)(*(f[0] for f in tmpl.fields()))
    miss = np.sort(rs.integers(0, 100, 40))
    ranks = run_ranks("torch_row_shard_workers:rows_checks", 2, kwargs=dict(
        X=X, y=y, n_shards=2, seed=SEED, batch_size=BATCH, sample_rows=SAMPLE,
        trees=_np(trees), tmpl_trees=_np(tmpl), miss_rows=miss),
        sys_path=[TESTS], timeout_s=110, workdir=str(tmp_path / "ranks"))
    ds = srt.make_dataset(X, y, device="cpu")
    ds.update_baseline_loss(el)
    data = ds.data

    # the minibatch: JAX's draw over every row, each draw taken once
    idx = np.asarray(jax.random.randint(jax.random.key(SEED), (BATCH,), 0, N_ROWS))
    for r in ranks:
        assert np.array_equal(r["batch_idx"], idx)
    pos = np.concatenate([r["batch_positions"] for r in ranks])
    assert np.array_equal(np.sort(pos), np.arange(BATCH))
    assert all(0 < len(r["batch_positions"]) < BATCH for r in ranks)
    for r in ranks:
        assert np.array_equal(r["batch_X"], X.T[:, idx[r["batch_positions"]]])
    one = data.take_rows(torch.from_numpy(idx.copy()))
    loss1, valid1 = fused_loss(trees, one.Xt, one.y, one.weights, ops, el)
    assert np.array_equal(ranks[0]["batch_valid"], valid1.numpy())
    assert_close(loss1.numpy(), ranks[0]["batch_loss"], 1e-6, "batch loss")
    assert np.array_equal(ranks[0]["batch_loss"], ranks[1]["batch_loss"])

    # the screening rows: the unsharded strided sample
    strided = strided_sample_indices(N_ROWS, SAMPLE)
    pos = np.concatenate([r["sample_positions"] for r in ranks])
    assert np.array_equal(pos, np.arange(SAMPLE))
    for r in ranks:
        assert np.array_equal(r["sample_X"], X.T[:, strided[r["sample_positions"]]])

    # a custom loss: bit-identical to one shard
    cost1, loss1, _ = eval_cost_batch(trees, data, el, engine.tables, ops, options.parsimony,
                                      loss_function=W.abs_mean)
    for r in ranks:
        assert np.array_equal(r["custom_loss"].view(np.int32), loss1.numpy().view(np.int32))
        assert np.array_equal(r["custom_cost"].view(np.int32), cost1.numpy().view(np.int32))

    # every row in the first block: the second rank runs no kernel
    assert int(ranks[0]["miss_rows"]) == len(miss) and int(ranks[1]["miss_rows"]) == 0
    assert sum(ranks[1]["plain_calls"].values()) == 0
    assert all(ranks[0]["plain_calls"][k] > 0 for k in W.PLAIN_VERSIONS)
    sub = data.take_rows(torch.from_numpy(miss))
    F = 3
    prog = compile_program(trees, F, len(ops.binary))
    cv = torch.stack([prog.cvals, prog.cvals * 1.25], dim=1)
    ref = {"miss_loss": fused_loss(trees, sub.Xt, sub.y, sub.weights, ops, el)[0],
           "miss_multi": fused_loss_multi(prog, cv, sub.Xt, sub.y, sub.weights, F, ops, el)[0],
           "miss_grad": fused_grad_multi(prog, cv, sub.Xt, sub.y, sub.weights, F, ops, el)[2],
           "miss_tmpl_cost": eval_cost_batch(tmpl, sub, el, tengine.tables,
                                             tengine.cfg.operators, options.parsimony, turbo=True,
                                             template=W.template_structure().structure)[0],
           "miss_tmpl_grad": W.template_grad(tmpl, sub),
           "miss_custom_loss": eval_cost_batch(trees, sub, el, engine.tables, ops,
                                               options.parsimony, loss_function=W.abs_mean)[1]}
    for k, v in ref.items():
        for r in ranks:
            assert np.array_equal(r[k].view(np.uint8), v.numpy().view(np.uint8)), k

    # the first block's rows of the minibatch's screening sample: all of it
    sample = sub.strided_sample(8).Xt.numpy()
    assert np.array_equal(ranks[0]["miss_sample_X"], sample)
    assert ranks[1]["miss_sample_X"].shape == (3, 0)

    # one seed and layout twice
    assert all(r["repeat_equal"] for r in ranks)
