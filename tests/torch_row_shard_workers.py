"""Rank functions of the data-row shard tests (tests/test_torch_row_shards*.py).

Each runs in a process of its own, one rank of a gloo group that
``parallel/launch.run_ranks`` made, imports no JAX, and builds what cannot
be pickled (a template combiner, a custom loss) from a feature name.
Every rank holds the rows of its block (``MeshPlan.place_data`` with one
island shard) and returns numpy arrays.
"""

import numpy as np
import torch

import symbolicregression_jl_tpu_torch as srt
from symbolicregression_jl_tpu_torch.core.losses import loss_from_pred
from symbolicregression_jl_tpu_torch.evolve import rng
from symbolicregression_jl_tpu_torch.evolve.engine import Engine
from symbolicregression_jl_tpu_torch.mesh import MeshPlan
from symbolicregression_jl_tpu_torch.models import template_spec
from symbolicregression_jl_tpu_torch.models.template import eval_template_batch
from symbolicregression_jl_tpu_torch.ops.encoding import TreeBatch, encode_population
from symbolicregression_jl_tpu_torch.ops.fused_eval import (fused_grad_multi, fused_loss,
                                                            fused_loss_multi)
from symbolicregression_jl_tpu_torch.ops.program import compile_program
from symbolicregression_jl_tpu_torch.parallel.collectives import row_shard, sum_over_row_shards

torch.set_num_threads(1)

OPERATORS = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"])


def template_structure():
    """f(x1, x2) + g(x3): two call sites of kernel #4, a row-wise combiner."""
    return template_spec(expressions=("f", "g"))(lambda f, g, x1, x2, x3: f(x1, x2) + g(x3))


def abs_mean(pred, y, w, valid):
    """A custom whole-prediction loss: the mean absolute error."""
    return torch.mean(torch.abs(pred - y))


def abs_diff(pred, y):
    """A user elementwise loss (the user-loss route: kernel #4, the
    callable, kernel #5)."""
    return torch.abs(pred - y)


def feature_options(feature: str, **kw):
    """The search options of one feature under data-row shards."""
    base = dict(OPERATORS, maxsize=10, populations=4, population_size=12,
                tournament_selection_n=4, ncycles_per_iteration=3, save_to_file=False,
                turbo=True, optimizer_iterations=4)
    base.update({"template": dict(expression_spec=template_structure()),
                 "loss": dict(loss_function=abs_mean),
                 "user_loss": dict(elementwise_loss=abs_diff),
                 "batching": dict(batching=True, batch_size=32),
                 "staged": dict(staged_eval=True, staged_sample_rows=64),
                 "plain": {}}[feature])
    base.update(kw)
    return srt.Options(**base)


def _tree(t) -> TreeBatch:
    return TreeBatch(*(torch.from_numpy(np.asarray(t[f])) for f in
                       ("arity", "op", "feat", "const", "length")))


def _data(X, y, n_shards, weights=None, extra=None, elementwise_loss=None):
    ds = srt.make_dataset(X, y, weights=weights, extra=extra, device="cpu")
    if elementwise_loss is not None:
        ds.update_baseline_loss(elementwise_loss)
    plan = MeshPlan.build(n_island_shards=1, n_data_shards=n_shards)
    return plan.place_data(ds.data)


def template_grad(tt: TreeBatch, data):
    """The gradient of template members' summed finite losses in every
    subexpression's constants (#4 forward, #5 backward), the row shards'
    partials added, as the template optimizer's gradient pass takes it."""
    structure = template_structure().structure
    options = srt.Options(**OPERATORS)
    const = tt.const.clone().requires_grad_(True)
    with row_shard(data.row_shard), torch.enable_grad():
        member = TreeBatch(tt.arity, tt.op, tt.feat, const, tt.length)
        pred, valid = eval_template_batch(member, data.Xt, structure, options.operators,
                                          fused=True)
        loss = loss_from_pred(pred, valid, data.y, data.weights, options.elementwise_loss)
        (g,) = torch.autograd.grad(torch.where(torch.isfinite(loss), loss, 0.0).sum(), const)
        return sum_over_row_shards(g)


def parity(X, y, w, plain, cv, classes, param_trees, params, tmpl_trees, n_shards):
    """Every kernel wrapper on this rank's block of the rows, for the
    tests' comparison with the JAX package's data-sharded evaluation:

    - plain members (weights ``w``): ``fused_loss_multi`` and
      ``fused_grad_multi`` of every (tree, constant vector ``cv`` [T, V,
      CMAX]) pair, ``fused_loss`` with and without dedup, and the engine's
      costs (``eval_cost_batch``, turbo on);
    - parametric members (#1p, classes ``classes``): the engine's costs;
    - template members (#4 forward, #5 backward): the engine's costs, and
      the gradient of the summed finite losses in every subexpression's
      constants, the shards' partials added, as the template optimizer's
      gradient pass takes it."""
    from symbolicregression_jl_tpu_torch.evolve.step import eval_cost_batch

    out = {}
    options = srt.Options(**OPERATORS, save_to_file=False, turbo=True)
    ops, el = options.operators, options.elementwise_loss
    data = _data(X, y, n_shards, weights=w, elementwise_loss=el)
    engine = Engine(options, X.shape[1], device="cpu")
    t = _tree(plain)
    F = data.Xt.shape[0]
    prog = compile_program(t, F, len(ops.binary))
    cvt = torch.from_numpy(np.asarray(cv))
    with row_shard(data.row_shard):
        out["loss_multi"], out["valid_multi"] = fused_loss_multi(
            prog, cvt, data.Xt, data.y, data.weights, F, ops, el)
        out["loss_grad"], out["valid_grad"], out["grad"] = fused_grad_multi(
            prog, cvt, data.Xt, data.y, data.weights, F, ops, el)
        out["loss"], out["valid"] = fused_loss(t, data.Xt, data.y, data.weights, ops, el)
        out["loss_dedup"], out["valid_dedup"] = fused_loss(t, data.Xt, data.y, data.weights,
                                                           ops, el, dedup=True)
    out["cost"], out["cost_loss"], _ = eval_cost_batch(
        t, data, el, engine.tables, ops, options.parsimony, turbo=True, dedup=True)

    popt = srt.Options(**OPERATORS, save_to_file=False, turbo=True,
                       expression_spec=srt.ParametricExpressionSpec(max_parameters=params.shape[1]))
    pdata = _data(X, y, n_shards, extra={"class": classes}, elementwise_loss=el)
    out["param_cost"], out["param_loss"], _ = eval_cost_batch(
        _tree(param_trees), pdata, el, engine.tables, ops, options.parsimony,
        member_params=torch.from_numpy(np.asarray(params)), turbo=True)

    structure = template_structure().structure
    tdata = _data(X, y, n_shards, elementwise_loss=el)
    tt = _tree(tmpl_trees)
    out["tmpl_cost"], out["tmpl_loss"], _ = eval_cost_batch(
        tt, tdata, el, engine.tables, ops, options.parsimony, turbo=True, template=structure)
    out["tmpl_grad"] = template_grad(tt, tdata)
    out["rows"] = torch.tensor(data.n)
    return {k: v.detach().numpy() for k, v in out.items()}


def _counting(names):
    """Count the calls of the kernels' plain versions (what a wrapper runs
    on the CPU where it would launch on the card)."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as SF

    counts = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(SF, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        setattr(SF, name, counted)
    return counts


PLAIN_VERSIONS = ("program_eval_plain", "program_multi_plain", "program_grad_plain",
                  "program_predict_plain", "program_predict_vjp_plain")


def rows_checks(X, y, n_shards, seed, batch_size, sample_rows, trees, tmpl_trees, miss_rows):
    """This rank's part of a minibatch, a screening sample and a custom
    loss; the kernels on a minibatch that misses this rank (``miss_rows``,
    rows of the first block only); one engine iteration twice from one
    seed. Returns numpy arrays and the plain versions' call counts."""
    from symbolicregression_jl_tpu_torch.api.checkpoint import map_arrays
    from symbolicregression_jl_tpu_torch.evolve.step import eval_cost_batch

    out = {}
    options = feature_options("batching", batch_size=batch_size)
    ops, el = options.operators, options.elementwise_loss
    data = _data(X, y, n_shards, elementwise_loss=el)
    plan = MeshPlan.build(n_island_shards=1, n_data_shards=n_shards)
    engine = Engine(options, X.shape[1], device="cpu", plan=plan)
    t = _tree(trees)
    # the minibatch: global draws, this rank's rows of them
    key = rng.key(seed)
    batch = engine.draw_batch(key, data)
    out["batch_idx"] = rng.randint(key, (batch_size,), 0, data.n_global)
    out["batch_positions"] = batch.row_shard.local_positions("cpu")
    out["batch_X"] = batch.Xt
    with row_shard(batch.row_shard):
        out["batch_loss"], out["batch_valid"] = fused_loss(t, batch.Xt, batch.y, batch.weights,
                                                           ops, el)
    # graftstage's screening rows
    sample = data.strided_sample(sample_rows)
    out["sample_positions"] = sample.row_shard.local_positions("cpu")
    out["sample_X"] = sample.Xt
    # a custom whole-prediction loss sees the whole prediction
    out["custom_cost"], out["custom_loss"], _ = eval_cost_batch(
        t, data, el, engine.tables, ops, options.parsimony, loss_function=abs_mean)
    # a minibatch with no row on the other ranks: no launch over zero rows
    miss = data.take_rows(torch.as_tensor(miss_rows))
    counts = _counting(PLAIN_VERSIONS)
    F = X.shape[1]
    prog = compile_program(t, F, len(ops.binary))
    cv = torch.stack([prog.cvals, prog.cvals * 1.25], dim=1)
    structure = template_structure().structure
    with row_shard(miss.row_shard):
        out["miss_loss"], out["miss_valid"] = fused_loss(t, miss.Xt, miss.y, miss.weights, ops,
                                                         el)
        out["miss_multi"], _ = fused_loss_multi(prog, cv, miss.Xt, miss.y, miss.weights, F,
                                                ops, el)
        _, _, out["miss_grad"] = fused_grad_multi(prog, cv, miss.Xt, miss.y, miss.weights, F,
                                                  ops, el)
    out["miss_tmpl_cost"], _, _ = eval_cost_batch(_tree(tmpl_trees), miss, el, engine.tables,
                                                  ops, options.parsimony, turbo=True,
                                                  template=structure)
    out["miss_tmpl_grad"] = template_grad(_tree(tmpl_trees), miss)
    _, out["miss_custom_loss"], _ = eval_cost_batch(t, miss, el, engine.tables, ops,
                                                    options.parsimony, loss_function=abs_mean)
    miss_sample = miss.strided_sample(8)
    out["miss_sample_X"] = miss_sample.Xt
    out["miss_rows"] = torch.tensor(miss.n)
    res = {k: v.detach().numpy() for k, v in out.items()}
    res["plain_calls"] = dict(counts)
    # one iteration with minibatches and the screening sample, twice
    opts = feature_options("batching", batch_size=batch_size, staged_eval=True,
                           staged_sample_rows=sample_rows // 2)
    digests = []
    for _ in range(2):
        eng = Engine(opts, X.shape[1], device="cpu", plan=plan)
        st = eng.init_state(rng.key(seed), data, opts.populations)
        st = eng.run_iteration(st, data, opts.maxsize)
        bits = []
        map_arrays(st, lambda a: bits.append(a.detach().numpy().tobytes()))
        digests.append(b"".join(bits))
    res["repeat_equal"] = digests[0] == digests[1]
    return res


def search_feature(X, y, feature, niterations, seed, n_data_shards):
    """``equation_search`` of one feature on this rank (every rank makes
    the same call). Returns the hall of fame's (complexity, loss,
    equation) rows and the full state's bits digest."""
    import hashlib

    from symbolicregression_jl_tpu_torch.api.checkpoint import map_arrays
    from symbolicregression_jl_tpu_torch.api.search import RuntimeOptions

    options = feature_options(feature)
    ropt = RuntimeOptions(niterations=niterations, seed=seed, verbosity=0,
                          n_data_shards=n_data_shards)
    state, hof = srt.equation_search(X, y, options=options, runtime_options=ropt,
                                     return_state=True, device="cpu")
    h = hashlib.sha256()
    map_arrays(state.device_states[0], lambda t: h.update(t.detach().cpu().numpy().tobytes()))
    return {"hof": [(e.complexity, float(e.loss), e.equation_string()) for e in hof.entries],
            "digest": h.hexdigest()}
