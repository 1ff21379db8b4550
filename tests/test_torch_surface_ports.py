"""The names the surface audit (tests/test_torch_surface.py) found missing,
each held against the JAX package's function on the same inputs.

Draws and integer structures are bit-equal: ``search_key``, the
``randint_dyn``/``masked_choice``/``categorical_from_weights`` draws,
``gen_random_tree_fixed_size``'s trees, ``postfix_valid`` and the state
that ``Engine.init_state(initial_trees=, initial_params=)`` seeds. The
generated trees' constants go through the inverse normal CDF, whose
float32 tails sit an ULP from XLA's here and there (evolve/rng.py
``ndtri``): they agree within 1e-6. Losses and other floats agree within
rtol 1e-5. Everything runs on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.bench import extract as JX
from symbolicregression_jl_tpu.bench import gate as JG
from symbolicregression_jl_tpu.bench import trend as JTR
from symbolicregression_jl_tpu.core import losses as JL
from symbolicregression_jl_tpu.evolve import mutation as JM
from symbolicregression_jl_tpu.evolve import pieces as JP
from symbolicregression_jl_tpu.evolve import rng as JR
from symbolicregression_jl_tpu.evolve import step as JS
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu.evolve.population import init_population as j_init_population
from symbolicregression_jl_tpu.mesh import plan as JMP
from symbolicregression_jl_tpu.ops import encoding as JE
from symbolicregression_jl_tpu.ops import eval as JV
from symbolicregression_jl_tpu.ops import operators as JO
from symbolicregression_jl_tpu.parallel import mesh as JPM
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.api import search as SA
from symbolicregression_jl_tpu_torch.bench import __main__ as SB
from symbolicregression_jl_tpu_torch.bench import extract as SX
from symbolicregression_jl_tpu_torch.bench import gate as SG
from symbolicregression_jl_tpu_torch.bench import trend as STR
from symbolicregression_jl_tpu_torch.core import losses as SL
from symbolicregression_jl_tpu_torch.evolve import mutation as SM
from symbolicregression_jl_tpu_torch.evolve import pieces as SP
from symbolicregression_jl_tpu_torch.evolve import rng as SR
from symbolicregression_jl_tpu_torch.evolve import step as SS
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine
from symbolicregression_jl_tpu_torch.mesh import plan as SMP
from symbolicregression_jl_tpu_torch.models import template as ST
from symbolicregression_jl_tpu_torch.ops import encoding as SE
from symbolicregression_jl_tpu_torch.ops import eval as SV
from symbolicregression_jl_tpu_torch.ops import operators as SO
from symbolicregression_jl_tpu_torch.parallel import mesh as SPM
from symbolicregression_jl_tpu_torch.serve.cache import ExecutableCache

from torch_parity import assert_close, assert_pops_equal, numpy_state, port_key, problem, to_np

SEEDS = [0, 1, 42, 2**31 - 1, 123456789]
MAXSIZE = 12


def _options(**kw):
    base = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
                maxsize=MAXSIZE, populations=2, population_size=8, tournament_selection_n=4,
                should_optimize_constants=False, save_to_file=False, turbo=False)
    base.update(kw)
    return J.Options(**base), S.Options(**base)


def _u32(x):
    return to_np(x).astype(np.int32).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_search_key_and_rng_helpers_bit_equal(seed):
    jk = J.search_key(seed)
    sk = S.search_key(seed)
    assert np.array_equal(np.asarray(jax.random.key_data(jk), np.uint32), _u32(sk))
    for i, n in enumerate((1, 7, 1000)):
        k = jax.random.fold_in(jk, i)
        assert np.array_equal(to_np(JR.randint_dyn(k, jnp.int32(n), (33,))),
                              to_np(SR.randint_dyn(port_key(k), n, (33,))))
    rs = np.random.default_rng(seed % 1000)
    for i in range(4):
        k = jax.random.fold_in(jk, 10 + i)
        mask = rs.random(9) < 0.4
        ji, jh = JR.masked_choice(k, jnp.asarray(mask))
        si, sh = SR.masked_choice(port_key(k), torch.from_numpy(mask))
        assert int(ji) == int(si) and bool(jh) == bool(sh)
        w = np.where(rs.random(6) < 0.3, 0.0, rs.random(6)).astype(np.float32)
        assert int(JR.categorical_from_weights(k, jnp.asarray(w))) == int(
            SR.categorical_from_weights(port_key(k), torch.from_numpy(w)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gen_random_tree_fixed_size_and_postfix_valid(seed):
    jo, so = _options()
    jcfg = JS.evolve_config_from_options(jo, 3)
    scfg = SS.evolve_config_from_options(so, 3, torch.device("cpu"))
    keys = jax.random.split(jax.random.key(seed), 16)
    sizes = np.arange(16) % MAXSIZE + 1
    jt = jax.vmap(lambda k, c: JM.gen_random_tree_fixed_size(k, c, jcfg.mctx, jnp.float32))(
        keys, jnp.asarray(sizes, jnp.int32))
    skeys = SR.split(port_key(jax.random.key(seed)), 16)
    st = SM.gen_random_tree_fixed_size(skeys, torch.from_numpy(sizes), scfg.mctx)
    for f in ("arity", "op", "feat", "length"):
        assert np.array_equal(to_np(getattr(jt, f)), to_np(getattr(st, f))), f
    assert_close(to_np(jt.const), to_np(st.const), 1e-6, "const")
    one = SM.gen_random_tree_fixed_size(skeys[3], int(sizes[3]), scfg.mctx)
    assert torch.equal(one.arity, st.arity[3]) and int(one.length) == int(st.length[3])
    assert SM.gen_random_tree_fixed_size(skeys[3], 5, scfg.mctx,
                                         dtype=torch.float64).const.dtype == torch.float64
    # postfix_valid on the trees and on corrupted copies
    arity, length = to_np(jt.arity).copy(), to_np(jt.length).copy()
    arity[1, 0] = 2                     # a leaf slot made binary: underflow
    arity[2, MAXSIZE - 1] = 1           # padding that is not a leaf
    length[3] = 0
    length[4] = MAXSIZE + 1
    arity[5, int(length[5]) - 1] = 3    # arity out of range
    jv = JE.postfix_valid(jnp.asarray(arity), jnp.asarray(length))
    sv = SE.postfix_valid(torch.from_numpy(arity), torch.from_numpy(length))
    assert np.array_equal(to_np(jv), to_np(sv))
    assert to_np(sv)[0] and not to_np(sv)[1:6].any()
    # make_tree / tree_fields
    fields = SP.tree_fields(st)
    again = SP.make_tree(*fields, st.length)
    assert all(a is b for a, b in zip(SP.tree_fields(again), fields))
    assert len(JP.tree_fields(jt)) == len(fields)


def test_erf_erfc_and_losses():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    for name in ("erf", "erfc"):
        assert_close(to_np(getattr(JO, name)(jnp.asarray(x))),
                     to_np(getattr(SO, name)(torch.from_numpy(x))), 1e-5, name)
    rs = np.random.default_rng(0)
    pred = rs.normal(size=(4, 30)).astype(np.float32)
    pred[1, 3] = np.nan
    y = rs.normal(size=30).astype(np.float32)
    w = rs.uniform(0.5, 2, 30).astype(np.float32)
    mask = rs.random(30) < 0.6
    valid = np.array([True, True, False, True])
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        sw = None if weights is None else torch.from_numpy(weights)
        assert_close(to_np(JL.aggregate_loss(JL.l2_dist_loss, jnp.asarray(pred), jnp.asarray(y),
                                             jnp.asarray(valid), jw, jnp.asarray(mask))),
                     to_np(SL.aggregate_loss(SL.resolve_loss("L2DistLoss"), torch.from_numpy(pred),
                                             torch.from_numpy(y), torch.from_numpy(valid), sw,
                                             torch.from_numpy(mask))), 1e-5, "row_mask")
    for b in (0.001, 0.5):
        for use in (True, False):
            j = JL.baseline_normalization(jnp.float32(b), jnp.bool_(use), jnp.float32)
            s = SL.baseline_normalization(torch.tensor(b, dtype=torch.float32),
                                          torch.tensor(use), torch.float32)
            assert float(j) == float(s)
    assert SL.baseline_normalization(torch.tensor(0.5), torch.tensor(True),
                                     torch.float64).dtype == torch.float64
    assert set(S.LOSS_REGISTRY) == set(J.LOSS_REGISTRY)
    assert S.resolve_loss("L1DistLoss") is not None and S.ComplexityMapping is not None


def test_eval_single_tree_with_child_table():
    jo, so = _options()
    names = ["x1", "x2", "x3"]
    X, _ = problem(0, n=40)
    for expr in ("x1 * cos(x2) - 0.5", "exp(x3) / (x1 + 2.0)"):
        jt = JE.encode_population([J.parse_expression(expr, jo.operators, names)], MAXSIZE,
                                  jo.operators)
        t = jax.tree.map(lambda a: a[0], jt)
        child, _, _ = JE.tree_structure_arrays(t)
        jy, jv = JV.eval_single_tree(t.arity, t.op, t.feat, t.const, t.length, child,
                                     jnp.asarray(X.T), jo.operators)
        st = interop.tree_batch(jax.tree.map(np.asarray, t), device="cpu")
        sy, sv = SV.eval_single_tree(st.arity, st.op, st.feat, st.const, st.length,
                                     torch.from_numpy(np.asarray(child)),
                                     torch.from_numpy(X.T.copy()), so.operators)
        assert bool(jv) == bool(sv)
        assert_close(to_np(jy), to_np(sy), 1e-5, expr)


@pytest.fixture(scope="module")
def engines():
    jo, so = _options()
    X, y = problem(3, n=64)
    jds = J.make_dataset(X, y)
    jds.update_baseline_loss(jo.elementwise_loss)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    return jo, so, JEngine(jo, 3), SEngine(so, 3, device="cpu"), jds, sd


@pytest.mark.parametrize("seed", [0, 5])
def test_init_state_with_initial_trees_bit_equal(engines, seed):
    """The seeded state (trees, births, lineages, key, hall of fame) equals
    the JAX engine's from the same key; costs within rtol 1e-5."""
    jo, so, je, se, jds, sd = engines
    jcfg = je.cfg
    trees = j_init_population(jax.random.key(seed + 50), 2 * 8, jcfg.mctx, jnp.float32)
    trees = jax.tree.map(lambda a: a.reshape((2, 8) + a.shape[1:]), trees)
    params = jnp.zeros((2, 8, 0, 0), jnp.float32)
    key = jax.random.key(seed)
    js = numpy_state(je.init_state(key, jds.data, 2, initial_trees=trees,
                                   initial_params=params))
    ss = se.init_state(port_key(key), sd, 2,
                       initial_trees=interop.tree_batch(jax.tree.map(np.asarray, trees),
                                                        device="cpu"),
                       initial_params=torch.zeros((2, 8, 0, 0)))
    assert_pops_equal(js.pops, ss.pops)
    assert np.array_equal(js.key, _u32(ss.key))
    for f in ("birth", "ref"):
        assert np.array_equal(getattr(js, f), to_np(getattr(ss, f)))
    assert float(js.num_evals) == float(ss.num_evals)
    # n_params / n_classes, and one member of the population
    assert (je.n_params, je.n_classes) == (se.n_params, se.n_classes) == (0, 0)
    jm = jax.tree.map(np.asarray, je.init_state(key, jds.data, 2).pops.member(3))
    sm = se.init_state(port_key(key), sd, 2).pops.member(3)
    assert_pops_equal(jm, sm)
    assert sm.trees.arity.shape == (2, MAXSIZE)


def test_initial_population_goes_through_init_state(engines):
    """The API's ``initial_population`` seeding is ``init_state`` with the
    seeds tiled over the members: the same bits as seeding a random state
    in place (the JAX package's way)."""
    jo, so, je, se, jds, sd = engines
    seeds = [S.parse_expression(e, so.operators, ["x1", "x2", "x3"]) for e in
             ("x1 * x2", "cos(x3) + 1.5", "x1 - 0.25")]
    key = SR.key(9)
    tiled = SA._initial_state(se, key, sd, 2, seeds)
    ref = SA._seed_population(se, se.init_state(key, sd, 2), seeds, sd, mode="tile")
    for a, b in zip(tiled.pops.trees.fields(), ref.pops.trees.fields()):
        assert torch.equal(a, b)
    for f in ("cost", "loss", "complexity", "birth", "ref", "params"):
        assert torch.equal(getattr(tiled.pops, f), getattr(ref.pops, f)), f
    assert torch.equal(tiled.key, ref.key)


def test_update_hof_pop_generation_candidates_and_batch_idx(engines):
    jo, so, je, se, jds, sd = engines
    js = je.init_state(jax.random.key(1), jds.data, 1)
    jpop = jax.tree.map(lambda a: a[0], js.pops)
    jh = JS.update_hof(JS.empty_hof(MAXSIZE, MAXSIZE, jnp.float32), jpop, MAXSIZE)
    spop = interop.population_state(jax.tree.map(lambda a: np.asarray(a)[0], js.pops),
                                    device="cpu")
    empty = SS.empty_hof((), MAXSIZE, MAXSIZE, torch.device("cpu"))
    for sh in (SS.update_hof(empty, pop=spop, maxsize=MAXSIZE),
               SS.update_hof(empty, spop.trees, spop.cost, spop.loss, spop.complexity, MAXSIZE,
                             params=spop.params)):
        assert np.array_equal(to_np(jh.exists), to_np(sh.exists))
        assert_close(to_np(jh.cost), to_np(sh.cost), 1e-5, "hof cost")
        assert np.array_equal(to_np(jh.trees.arity), to_np(sh.trees.arity))
    # the evaluated candidates of a generation step, and batch_idx
    ss = se.init_state(SR.key(1), sd, 1)
    nf = ss.stats.normalized_frequencies
    marks = (torch.zeros((1, 8), dtype=torch.bool),) * 2
    args = (SR.key(2)[None], ss.pops, sd, nf, torch.tensor(0.5), MAXSIZE, ss.birth, ss.ref,
            se.cfg, so, se.tables, so.elementwise_loss, marks)
    out = SS.generation_step(*args, return_candidates=True)
    plain = SS.generation_step(*args)
    cand = out[-1]
    assert len(out) == len(plain) + 1 and cand.arity.shape[0] == 1
    assert cand.arity.shape[1] in (se.cfg.n_slots, 2 * se.cfg.n_slots) or (
        se.cfg.n_slots < cand.arity.shape[1] < 2 * se.cfg.n_slots)
    for a, b in zip(out[0].trees.fields(), plain[0].trees.fields()):
        assert torch.equal(a, b)
    idx = torch.tensor([3, 1, 4, 1, 5, 9, 2, 6])
    trees = ss.pops.trees.reshape(-1)
    a = SS.eval_cost_batch(trees, sd, so.elementwise_loss, se.tables, so.operators,
                           so.parsimony, batch_idx=idx)
    b = SS.eval_cost_batch(trees, sd.take_rows(idx), so.elementwise_loss, se.tables,
                           so.operators, so.parsimony)
    jt = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), js.pops.trees)
    j = JS.eval_cost_batch(jt, jds.data, jo.elementwise_loss, je.tables, jo.operators,
                           jo.parsimony, batch_idx=jnp.asarray(idx.numpy()))
    s = SS.eval_cost_batch(interop.tree_batch(jax.tree.map(np.asarray, jt), device="cpu"), sd,
                           so.elementwise_loss, se.tables, so.operators, so.parsimony,
                           batch_idx=idx)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert_close(to_np(j[1]), to_np(s[1]), 1e-5, "batch loss")


def test_optimizer_diag_matches_jax():
    """``return_diag``: the live rows of each L-BFGS iteration, as the
    JAX package's fused optimizer counts them (early exit on)."""
    from symbolicregression_jl_tpu.evolve import constant_opt as JC
    from symbolicregression_jl_tpu_torch.evolve import constant_opt as SC

    jo, so = _options()
    names = ["x1", "x2", "x3"]
    exprs = ["0.8 * (x1 * x1) + 1.3 * cos(x2)", "x3", "2.1 * exp(0.3 * x1)", "x1 / (x2 + 3.5)"]
    jt = JE.encode_population([J.parse_expression(e, jo.operators, names) for e in exprs],
                              MAXSIZE, jo.operators)
    X, y = problem(0, n=32)
    jds = J.make_dataset(X, y)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    do_opt = np.ones(4, bool)
    key = jax.random.key(3)
    cfg = dict(early_exit=True, iterations=4)
    jr = JC.optimize_constants_fused(key, jt, jnp.asarray(do_opt), jds.data, jo.elementwise_loss,
                                     jo.operators, JC.OptimizerConfig(**cfg), interpret=True,
                                     return_diag=True)
    sr = SC.optimize_constants_fused(port_key(key), interop.tree_batch(
        jax.tree.map(np.asarray, jt), device="cpu"), torch.from_numpy(do_opt), sd,
        so.elementwise_loss, so.operators, SC.OptimizerConfig(**cfg), return_diag=True)
    assert np.array_equal(to_np(jr[-1]), to_np(sr[-1]))
    assert len(sr) == 5 and to_np(sr[-1])[0] < 4 * (SC.OptimizerConfig().nrestarts + 1)


def test_template_single_interpret_encode_and_engine_template():
    so = S.Options(binary_operators=["+", "*"], unary_operators=["cos"], save_to_file=False)
    spec = ST.template_spec(expressions=("f", "g"))(lambda f, g, x1, x2: f(x1) * g(x2))
    host = ST.HostTemplateExpression(
        {"f": S.parse_expression("x1 * 2.5", so.operators, ["x1"]),
         "g": S.parse_expression("cos(x1) + 0.5", so.operators, ["x1"])},
        spec.structure, so.operators)
    enc = host.encode(6, dtype=np.float64, device="cpu")
    assert enc.const.dtype == torch.float64
    enc = host.encode(6, device="cpu")
    X = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 20)).astype(np.float32))
    one, v1 = ST.eval_template_single(enc, X, spec.structure, so.operators)
    batch = enc.map(lambda t: t[None])
    fused, vf = ST.eval_template_batch(batch, X, spec.structure, so.operators, fused=True,
                                       interpret=True)
    plain, vp = ST.eval_template_batch(batch, X, spec.structure, so.operators)
    assert torch.equal(fused[0], plain[0]) and torch.equal(one, plain[0]) and bool(v1)
    engine = SEngine(so, 2, device="cpu", template=spec.structure)
    assert engine.template is spec.structure and engine.n_params == 0
    assert ExecutableCache().get_engine(so, nfeatures=2, dtype=torch.float32, n_params=0,
                                        n_classes=0, device="cpu", rows=20,
                                        template=spec.structure) is None


def test_mesh_specs_replicated_and_layouts(engines):
    jo, so, je, se, jds, sd = engines
    jmesh = JPM.make_mesh(jax.devices()[:1], n_island_shards=1, n_data_shards=1)
    smesh = SPM.make_mesh([0], n_island_shards=1, n_data_shards=1)
    assert tuple(JPM.replicated(jmesh).spec) == SPM.replicated(smesh).spec == ()
    jplan = JMP.MeshPlan.build(jax.devices()[:1], n_island_shards=1, n_data_shards=1)
    splan = SMP.MeshPlan.build([0], n_island_shards=1, n_data_shards=1)
    assert tuple(jplan.island_spec()) == splan.island_spec()
    assert tuple(jplan.replicated_spec()) == splan.replicated_spec()
    js = je.init_state(jax.random.key(0), jds.data, 2)
    jspecs = jplan.state_specs(js)
    sspecs = splan.state_specs(se.init_state(SR.key(0), sd, 2))
    for f in ("birth", "ref", "num_evals", "key"):
        assert tuple(getattr(jspecs, f)) == getattr(sspecs, f), f
    assert tuple(jspecs.pops.cost) == sspecs.pops.cost and tuple(jspecs.hof.cost) == \
        sspecs.hof.cost
    assert tuple(jplan.data_specs(jds.data).Xt) == splan.data_specs(sd).Xt
    cfg = SS.evolve_config_from_options(S.Options(turbo=True, save_to_file=False), 3,
                                        torch.device("cpu"), n_data_shards=2,
                                        n_island_shards=2)
    assert cfg.turbo and not cfg.fuse_cost


def test_bench_names_trend_and_findings(tmp_path, monkeypatch):
    assert SX.GATE_METRIC_KEYS == JX.GATE_METRIC_KEYS
    assert SG.CPU_THROUGHPUT_BAND_FACTOR == JG.CPU_THROUGHPUT_BAND_FACTOR
    from symbolicregression_jl_tpu.bench import matrix as JMX
    from symbolicregression_jl_tpu_torch.bench import matrix as SMX

    assert SMX.RESULT_SCHEMA == JMX.RESULT_SCHEMA and callable(SMX.library_provenance)
    findings_j = [JG.Finding("plain/seed0", "best_loss", "ok", 1.0, 1.0, 1.1),
                  JG.Finding("plain/seed0", "pareto_volume", "regression", 2.0, 1.0, 1.8)]
    findings_s = [SG.Finding(**vars(f)) for f in findings_j]
    for verbose in (False, True):
        j = JG.format_findings(findings_j, verbose=verbose).splitlines()
        s = SG.format_findings(findings_s, verbose=verbose).splitlines()
        assert len(j) == len(s) and [x.split()[0] for x in j[:-1]] == [x.split()[0]
                                                                         for x in s[:-1]]
    hist = tmp_path / "benchmarks" / "history"
    hist.mkdir(parents=True)
    res = {"schema": SG.RESULT_SCHEMA, "matrix": "mini", "platform": "cpu",
           "cells": {"plain/seed0": {"metrics": {"evals_per_sec": 500.0}}},
           "failures": {"template/seed0": "rc=1"}, "gate": {"failed": True, "findings": []}}
    (hist / "gate_r01.json").write_text(json.dumps(res))
    extra = tmp_path / "extra.json"
    extra.write_text(json.dumps(dict(res, failures={}, gate={"failed": False,
                                                              "findings": []})))
    jt = JTR.build_trend(str(tmp_path), gate_paths=[str(extra)])
    st = STR.build_trend(str(tmp_path), gate_paths=[str(extra)])
    assert jt["red_count"] == st["red_count"] == 1
    assert [g["red"] for g in jt["gates"]] == [g["red"] for g in st["gates"]]
    assert STR.build_trend([str(hist)])["red_count"] == 1
    seen = []
    monkeypatch.setattr("symbolicregression_jl_tpu_torch.bench.load.main",
                        lambda argv: seen.append(list(argv)) or 0)
    assert SB.main(["load", "--requests", "2"]) == 0 and SB.cmd_load(["--packed"]) == 0
    assert seen == [["--requests", "2"], ["--packed"]]
