"""The port's telemetry against the JAX package's.

Device counters: one generation step (plain and staged) and one engine
iteration, each started in both packages from the same population and
key, give equal integer counters; the member hashes are bit-equal on
plain and template trees with -0.0, NaN and huge constants; the
duplicate count and the loss histogram are equal, zero, negative, inf and
NaN losses included. The port's search is bit-identical with telemetry on
and off and with chunked and single-chunk iterations; its JSONL stream
validates under both packages' validators, and both packages' reports
read it alike. Everything runs on the CPU (``turbo=False``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.evolve import step as JS
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu.ops.encoding import TreeBatch as JTreeBatch
from symbolicregression_jl_tpu.telemetry import counters as JC
from symbolicregression_jl_tpu.telemetry import report as JR
from symbolicregression_jl_tpu.telemetry import schema as JSchema
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.api.checkpoint import map_arrays
from symbolicregression_jl_tpu_torch.evolve import step as SS
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine
from symbolicregression_jl_tpu_torch.telemetry import counters as SC
from symbolicregression_jl_tpu_torch.telemetry import hub as SH
from symbolicregression_jl_tpu_torch.telemetry import report as SR
from symbolicregression_jl_tpu_torch.telemetry import schema as SSchema

from torch_parity import numpy_state, port_key, problem, to_np

MAXSIZE = 15
CYCLE_FIELDS = [f.name for f in dataclasses.fields(SC.CycleTelemetry)]


def _config(**kw):
    base = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
                maxsize=MAXSIZE, should_optimize_constants=False, save_to_file=False,
                turbo=False)
    base.update(kw)
    return J.Options(**base), S.Options(**base)


def _assert_cycle_equal(jt, st):
    """JAX CycleTelemetry (numpy) == the port's, field by field, exactly
    (the port's one island, where it has an island axis)."""
    for f in CYCLE_FIELDS:
        a, b = np.asarray(getattr(jt, f)), to_np(getattr(st, f))
        assert b.dtype == np.int32 and b.size == a.size, f
        assert np.array_equal(a, b.reshape(a.shape)), (f, a, b)


# ---------------------------------------------------------------------------
# One generation step
# ---------------------------------------------------------------------------


def _step_case(jo, so, seed, nfeatures, data_fn):
    je, se = JEngine(jo, nfeatures), SEngine(so, nfeatures, device="cpu")
    jcfg = je.cfg._replace(collect_telemetry=True, record_events=True)
    scfg = se.cfg._replace(collect_telemetry=True, record_events=True)
    jds = data_fn(seed)
    jds.update_baseline_loss(jo.elementwise_loss)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    js = je.init_state(jax.random.key(seed), jds.data, 1)
    pop = jax.tree.map(lambda x: x[0], js.pops)
    nf = js.stats.normalized_frequencies
    P = so.population_size
    k = jax.random.fold_in(jax.random.key(seed + 100), 0)
    out_j = jax.jit(lambda k, pop, data, nf: JS.generation_step(
        k, pop, data, nf, jnp.float32(0.5), MAXSIZE, jnp.int32(P), jnp.int32(P), jcfg, jo,
        je.tables, jo.elementwise_loss, marks=(jnp.zeros(P, bool), jnp.zeros(P, bool))))(
            k, pop, jds.data, nf)
    sp = interop.population_state(jax.tree.map(lambda x: np.asarray(x)[None], pop), device="cpu")
    out_s = SS.generation_step(
        port_key(k)[None], sp, sd, torch.from_numpy(to_np(nf).copy()), torch.tensor(0.5),
        MAXSIZE, torch.tensor([P], dtype=torch.int32), torch.tensor([P], dtype=torch.int32),
        scfg, so, se.tables, so.elementwise_loss,
        (torch.zeros((1, P), dtype=torch.bool), torch.zeros((1, P), dtype=torch.bool)))
    return out_j, out_s, scfg


def _plain_data(seed):
    X, y = problem(seed)
    return J.make_dataset(X, y)


def _staged_data(seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (300, 2)).astype(np.float32)
    return J.make_dataset(X, (X[:, 0] * X[:, 1] + 1.0).astype(np.float32))


# The seeds on which test_torch_evolve.py::test_generation_step_equal and
# test_torch_staged.py::test_staged_generation_step_equal agree.
@pytest.mark.parametrize("staged,seed", [(False, 0), (False, 1), (False, 3), (True, 0),
                                         (True, 1)])
def test_step_counters_and_events_equal_jax(staged, seed):
    """One generation step's CycleTelemetry equal to the JAX package's
    (every field, exactly; staged: the screen and rescore counts too), and
    its CycleEvents equal (integers exactly, cost deltas within rtol
    1e-5)."""
    if staged:
        jo, so = _config(binary_operators=["+", "-", "*"], unary_operators=["cos"],
                         populations=1, population_size=16, tournament_selection_n=4,
                         crossover_probability=0.2, staged_eval=True,
                         staged_sample_fraction=0.25, rescore_fraction=0.3)
        out_j, out_s, scfg = _step_case(jo, so, seed, 2, _staged_data)
    else:
        jo, so = _config(populations=1, population_size=16, tournament_selection_n=8)
        out_j, out_s, scfg = _step_case(jo, so, seed, 3, _plain_data)
    jt, st = jax.device_get(out_j[5]), out_s[5]
    _assert_cycle_equal(jt, st)
    assert int(to_np(st.screen_launches)[0]) == (1 if staged else 0)
    assert int(to_np(st.eval_launches)[0]) == (2 if staged else 1)
    if staged:
        n = int(to_np(st.screen_rows)[0])
        assert int(to_np(st.rescore_rows)[0]) == SS.rescore_count(scfg, n) < n
    je, se = jax.device_get(out_j[6]), out_s[6]
    for f in je._fields:
        a, b = np.asarray(getattr(je, f)), to_np(getattr(se, f))[0]
        if f == "cost_delta":
            fa = np.isfinite(a)
            assert np.array_equal(fa, np.isfinite(b))
            np.testing.assert_allclose(a[fa], b[fa], rtol=1e-5, atol=1e-6)
        else:
            assert np.array_equal(a, b), (f, a, b)


def test_counters_do_not_change_the_step():
    """The step with counters and events on returns the same population
    as with them off, bit for bit."""
    jo, so = _config(populations=2, population_size=16, tournament_selection_n=8)
    X, y = problem(0)
    ds = S.make_dataset(X, y, device="cpu")
    ds.update_baseline_loss(so.elementwise_loss)
    se = SEngine(so, 3, device="cpu")
    from symbolicregression_jl_tpu_torch.evolve import rng

    state = se.init_state(rng.key(0), ds.data, 2)
    args = (rng.split(rng.key(5), 2), state.pops, ds.data, state.stats.normalized_frequencies,
            torch.tensor(0.5), MAXSIZE, state.birth, state.ref)
    marks = (torch.zeros((2, 16), dtype=torch.bool), torch.zeros((2, 16), dtype=torch.bool))
    off = SS.generation_step(*args, se.cfg, so, se.tables, so.elementwise_loss, marks)
    on = SS.generation_step(*args, se.cfg._replace(collect_telemetry=True, record_events=True),
                            so, se.tables, so.elementwise_loss, marks)
    assert len(off) == 5 and len(on) == 7
    for a, b in zip(_tensors(off[0]), _tensors(on[0])):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)


def _tensors(obj):
    out = []
    map_arrays(obj, lambda t: out.append(t) or t)
    return out


# ---------------------------------------------------------------------------
# One engine iteration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("annealing,seed", [(True, 0), (False, 1)])
def test_iteration_counters_equal_jax(annealing, seed):
    """One Engine.run_iteration with Options(telemetry=True) (2 islands x 16
    members, 3 cycles) from the same state and key: every counter of
    IterationTelemetry equal to the JAX package's, exactly. Seeds where
    test_torch_evolve.py::test_run_iteration_equal agrees."""
    X, y = problem(seed)
    jo, so = _config(populations=2, population_size=16, ncycles_per_iteration=3,
                     tournament_selection_n=8, annealing=annealing, telemetry=True)
    jds = J.make_dataset(X, y)
    jds.update_baseline_loss(jo.elementwise_loss)
    sd = interop.device_data(jax.tree.map(np.asarray, jds.data), device="cpu")
    je, se = JEngine(jo, 3), SEngine(so, 3, device="cpu")
    assert je.cfg.collect_telemetry and se.cfg.collect_telemetry
    js = je.init_state(jax.random.key(seed), jds.data, 2)
    ss = interop.search_state(numpy_state(js), device="cpu")
    jt = jax.device_get(je.run_iteration(js, jds.data, MAXSIZE).telem)
    st = se.run_iteration(ss, sd, MAXSIZE).telem
    _assert_cycle_equal(jt.cycle, st.cycle)
    for f in ("finalize_rows", "finalize_unique", "loss_hist", "cx_hist"):
        a, b = np.asarray(getattr(jt, f)), to_np(getattr(st, f))
        assert b.dtype == np.int32 and np.array_equal(a, b), (f, a, b)
    # The JAX package's identities: one launch per island and cycle plus
    # the finalize; every member in the finalize's rows.
    assert int(st.cycle.eval_launches) == 2 * 3 + 1
    assert int(st.finalize_rows) == 2 * 16
    assert int(st.cycle.proposed.sum()) == int(st.cycle.reject_reasons.sum()) == 2 * 2 * 3


def test_chunked_iteration_bit_identical_with_counters():
    """Chunks [3, 3, 2] of an 8-cycle iteration give the single-chunk
    iteration's state bit for bit, counters included; a stop after the
    first chunk runs 3 cycles and the epilogue once."""
    _, so = _config(populations=2, population_size=12, ncycles_per_iteration=8,
                    tournament_selection_n=4, telemetry=True)
    X, y = problem(2)
    ds = S.make_dataset(X, y, device="cpu")
    ds.update_baseline_loss(so.elementwise_loss)
    se = SEngine(so, 3, device="cpu")
    from symbolicregression_jl_tpu_torch.evolve import rng

    s0 = se.init_state(rng.key(7), ds.data, 2)
    one = se.run_iteration(s0, ds.data, MAXSIZE)
    chunked = se.run_iteration(s0, ds.data, MAXSIZE, chunk_sizes=[3, 3, 2],
                               should_stop=lambda pending: False)
    for a, b in zip(_tensors(one), _tensors(chunked)):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b.view(torch.int32) if b.dtype == torch.float32 else b)
    polls = []
    stopped = se.run_iteration(s0, ds.data, MAXSIZE, chunk_sizes=[3, 5],
                               should_stop=lambda pending: polls.append(pending()) or True)
    assert int(stopped.telem.cycle.eval_launches) == 2 * 3 + 1
    assert polls and polls[0] > 0


# ---------------------------------------------------------------------------
# Member hashes, duplicate count, loss histogram
# ---------------------------------------------------------------------------


def _random_trees(seed: int, shape, L: int = 10):
    rng = np.random.default_rng(seed)
    length = rng.integers(1, L + 1, shape).astype(np.int32)
    fields = dict(arity=rng.integers(0, 3, shape + (L,)).astype(np.int32),
                  op=rng.integers(0, 6, shape + (L,)).astype(np.int32),
                  feat=rng.integers(0, 4, shape + (L,)).astype(np.int32),
                  const=rng.normal(size=shape + (L,)).astype(np.float32) * 10,
                  length=length)
    c = fields["const"].reshape(-1)
    special = np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf, 3.0e38, -3.4e38, 1e-45],
                       np.float32)
    pos = rng.choice(c.size, 200, replace=False)
    c[pos] = special[rng.integers(0, len(special), pos.size)]
    # duplicates: copy some members (all their subexpressions) over others
    flat = {k: v.reshape((shape[0] * shape[1],) + v.shape[2:]) for k, v in fields.items()}
    n = flat["length"].shape[0]
    src, dst = rng.integers(0, n, n // 3), rng.integers(0, n, n // 3)
    for v in flat.values():
        v[dst] = v[src]
    return fields


@pytest.mark.parametrize("template", [False, True])
def test_member_hash_keys_bit_equal_jax(template):
    shape = (3, 20, 2) if template else (4, 25)
    f = _random_trees(11 + template, shape)
    jt = JTreeBatch(**{k: jnp.asarray(v) for k, v in f.items()})
    st = interop.tree_batch(type("Trees", (), f), device="cpu")
    jk = [np.asarray(k) for k in JC.member_hash_keys(jt)]
    sk = [to_np(k) for k in SC.member_hash_keys(st)]
    for a, b in zip(jk, sk):
        assert b.dtype == np.int32 and np.array_equal(a, b)
    assert int(JC.unique_key_count(JC.member_hash_keys(jt))) == int(
        SC.unique_key_count(SC.member_hash_keys(st)))
    jr, ju = JC.member_dup_stats(jt)
    sr, su = SC.member_dup_stats(st)
    assert (int(jr), int(ju)) == (int(sr), int(su)) and int(su) < int(sr)


def test_loss_histogram_equal_jax():
    rng = np.random.default_rng(3)
    loss = (10.0 ** rng.uniform(-12, 12, 4000)).astype(np.float32)
    loss[:40] = [0.0, -1.0, -0.0, np.inf, -np.inf, np.nan, 1e-30, 1e-45, 3e38, 1.0] * 4
    loss[40:60] = 10.0 ** np.arange(-10, 10, dtype=np.float32)   # bin edges
    rng.shuffle(loss)
    a = np.asarray(JC.loss_histogram(jnp.asarray(loss.reshape(40, 100))))
    b = to_np(SC.loss_histogram(torch.from_numpy(loss.reshape(40, 100))))
    assert b.dtype == np.int32 and np.array_equal(a, b)
    assert b.sum() == np.isfinite(loss).sum()


# ---------------------------------------------------------------------------
# The search, its stream and its reports
# ---------------------------------------------------------------------------


def _search_opts(tmp_path, **kw):
    base = dict(binary_operators=["+", "*"], unary_operators=["cos"], maxsize=10,
                populations=2, population_size=12, tournament_selection_n=4,
                ncycles_per_iteration=3, should_optimize_constants=False,
                output_directory=str(tmp_path))
    base.update(kw)
    return S.Options(**base)


def _search(tmp_path, run_id, niterations=2, **kw):
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (64, 2)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + 1.0).astype(np.float32)
    state, _ = S.equation_search(X, y, options=_search_opts(tmp_path, **kw),
                                 niterations=niterations, seed=0, run_id=run_id, verbosity=0,
                                 return_state=True, device="cpu")
    return state, os.path.join(str(tmp_path), run_id, "telemetry.jsonl")


def test_search_bit_identical_with_telemetry_on_off(tmp_path):
    on, path = _search(tmp_path, "on", telemetry=True)
    off, _ = _search(tmp_path, "off", telemetry=False)
    assert on.device_states[0].telem is not None and off.device_states[0].telem is None
    ta = _tensors(dataclasses.replace(on.device_states[0], telem=None))
    tb = _tensors(off.device_states[0])
    assert len(ta) == len(tb)
    for a, b in zip(ta, tb):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)
    assert [e.equation_string() for e in on.hofs[0].entries] == [
        e.equation_string() for e in off.hofs[0].entries]


def test_stream_valid_under_both_validators_and_reports_agree(tmp_path, capsys):
    _, path = _search(tmp_path, "run", niterations=3, telemetry=True)
    with open(path) as f:
        lines = f.readlines()
    assert SSchema.validate_lines(lines) == [] and JSchema.validate_lines(lines) == []
    events = [json.loads(l) for l in lines]
    # graftgauge's events ride the stream by default: a memory sample
    # each iteration, the watermarks and the dispatch latency at the end
    gauge = [e["kind"] for e in events if e["event"] == "gauge"]
    assert gauge == ["memory"] * 3 + ["watermark", "dispatch_latency"]
    events = [e for e in events if e["event"] != "gauge"]
    assert [e["event"] for e in events] == ["run_start"] + ["iteration"] * 3 + ["run_end"]
    assert events[0]["schema"] == SSchema.SCHEMA_VERSION == JSchema.SCHEMA_VERSION
    assert events[0]["backend"] == "cpu" and events[0]["engines"][0]["collect_telemetry"]
    c = events[1]["outputs"][0]["counters"]
    from symbolicregression_jl_tpu_torch.core.options import MUTATION_KINDS

    assert set(c["proposed"]) == set(MUTATION_KINDS) | {"crossover"}
    assert sum(c["proposed"].values()) == 2 * 3 * 3       # I * B * C
    assert c["eval_launches"] == 2 * 3 + 1 and c["dedup"]["rows"] == 2 * 12
    assert events[-1]["stop_reason"] == "niterations"
    assert events[-1]["recompiles_total"] == {"traces": 0, "backend_compiles": 0}
    # both packages' reports read the port's stream alike
    js, ss = JR.summarize(events), SR.summarize(events)
    assert json.dumps(js, sort_keys=True) == json.dumps(ss, sort_keys=True)
    assert JR.metrics_view(js) == SR.metrics_view(ss)
    assert SR.format_report(ss) == JR.format_report(js)
    # the CLI: validate, report, and a bare path
    assert SR.main(["validate", path]) == 0
    assert SR.main([path]) == 0
    out = capsys.readouterr().out
    assert "acceptance by kind" in out and "host-fraction" in out
    # the timeline of the run directory (ledger/timeline.py) is a valid
    # Chrome trace under both packages' checks
    from symbolicregression_jl_tpu.ledger.timeline import validate_chrome_trace as jvalid
    from symbolicregression_jl_tpu_torch.ledger.timeline import validate_chrome_trace

    out_json = str(tmp_path / "t.json")
    assert SR.main(["timeline", os.path.dirname(path), "--out", out_json]) == 0
    with open(out_json) as f:
        doc = json.load(f)
    assert validate_chrome_trace(doc) == [] and jvalid(doc) == []
    assert sum(e["name"].startswith("iteration ") for e in doc["traceEvents"]) == 3


def test_telemetry_interval_accumulates(tmp_path):
    _, path = _search(tmp_path, "int", niterations=3, telemetry=True, telemetry_interval=2)
    with open(path) as f:
        events = [json.loads(l) for l in f if l.strip()]
    iters = [e for e in events if e["event"] == "iteration"]
    assert [e["iteration"] for e in iters] == [2, 3]
    assert sum(iters[0]["outputs"][0]["counters"]["proposed"].values()) == 2 * (2 * 3 * 3)
    assert sum(iters[1]["outputs"][0]["counters"]["proposed"].values()) == 2 * 3 * 3


def test_kernel_builds_and_loads_count_as_compile_events(tmp_path):
    """The hub's recompile counters count ops/cuda_build.py's library
    loads (traces) and nvcc builds (backend_compiles); a closed hub stops
    listening."""
    from symbolicregression_jl_tpu_torch.ops import cuda_build

    hub = SH.Telemetry(_search_opts(tmp_path, telemetry=True), run_id="c", out_dir=str(tmp_path),
                       niterations=1, nout=1, backend="cpu")
    cuda_build._notify("build", "program_eval.cu", 3.0)
    cuda_build._notify("load", "program_eval.cu", 0.01)
    cuda_build._notify("load", "program_multi.cu", 0.01)
    assert hub._compiles.snapshot() == {"traces": 2, "backend_compiles": 1,
                                        "transfer_guard_hits": 0}
    hub.close()
    cuda_build._notify("load", "program_grad.cu", 0.01)
    assert hub._compiles.snapshot()["traces"] == 2
