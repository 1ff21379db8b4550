"""The port's default-on diagnostics (ledger/, pulse/, gauge/) against the
JAX package's validators and host-level modules, and their wiring in the
port's ``equation_search``.

Against the JAX package: ``PromText`` output and ``histogram_quantile``
text- and value-equal; cost accounts, folds, fingerprints and rollups
equal on the same inputs; the port's ``ledger.jsonl``, its ``gauge``,
``pulse`` and ``anomaly`` events, its pulse bundle and its timeline valid
under the JAX package's validators. Within the port: the hall of fame
bit-identical with ledger, pulse and gauge on and off; an injected fault
dumps the bundle; a ``torch.profiler`` window lands in the run
directory, and a broken profiler disables itself without raising; the
anomaly detector's ``recompiles`` rule reads the hub's kernel-load
counter; the footprint probe, the headroom degrader and the engine cache
run through ``RuntimeOptions``.
"""

import dataclasses
import json
import os
import types

import numpy as np
import torch

from symbolicregression_jl_tpu.gauge import latency as JLat
from symbolicregression_jl_tpu.ledger import ledger as JLedger
from symbolicregression_jl_tpu.ledger import rollup as JRollup
from symbolicregression_jl_tpu.ledger import timeline as JTimeline
from symbolicregression_jl_tpu.ledger.context import mint_trace as j_mint_trace
from symbolicregression_jl_tpu.pulse import metrics as JMetrics
from symbolicregression_jl_tpu.pulse import recorder as JRecorder
from symbolicregression_jl_tpu.telemetry import schema as JSchema
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu_torch.api.checkpoint import map_arrays
from symbolicregression_jl_tpu_torch.gauge import latency as SLat
from symbolicregression_jl_tpu_torch.gauge import sampler as SSampler
from symbolicregression_jl_tpu_torch.ledger import ledger as SLedger
from symbolicregression_jl_tpu_torch.ledger import rollup as SRollup
from symbolicregression_jl_tpu_torch.ledger import timeline as STimeline
from symbolicregression_jl_tpu_torch.ledger.context import mint_run_trace, mint_trace
from symbolicregression_jl_tpu_torch.pulse import AnomalyDetector, TraceCapture
from symbolicregression_jl_tpu_torch.pulse import capture as SCapture
from symbolicregression_jl_tpu_torch.pulse import metrics as SMetrics
from symbolicregression_jl_tpu_torch.serve import ExecutableCache
from symbolicregression_jl_tpu_torch.shield import faults as SFaults
from symbolicregression_jl_tpu_torch.telemetry import report as SReport
from symbolicregression_jl_tpu_torch.telemetry import schema as SSchema
from symbolicregression_jl_tpu_torch.telemetry.hub import Telemetry

import torch_parity  # noqa: F401  (caps torch's threads per xdist worker)


# ---------------------------------------------------------------------------
# Host-level modules against the JAX package's
# ---------------------------------------------------------------------------


def _fill_prom(M, lat):
    p = M.PromText("graftserve")
    p.gauge("queue_depth", 3, "Requests queued or running")
    p.gauge("ratio", 0.125, 'a "quoted"\nhelp', labels={"bucket": 'x"y\\z'})
    p.counter("hits_total", 7.0, "hits", labels={"b": "1", "a": "2"})
    p.histogram("lat_seconds", [0.1, 1.0, 10.0], [1, 2, 0, 4], 12.5, "latency",
                labels={"request": "r1"})
    lat.render(p)
    return p.render()


def test_promtext_and_quantiles_match_jax():
    sl, jl = SLat.DispatchLatency(), JLat.DispatchLatency()
    for v in (0.0001, 0.003, 0.003, 0.5, 2.0, 400.0, -1.0):
        sl.observe(v)
        jl.observe(v)
    assert _fill_prom(SMetrics, sl) == _fill_prom(JMetrics, jl)
    assert sl.to_detail() == jl.to_detail()
    # a sample that is no number renders as NaN (the JAX package's raises)
    assert SMetrics.PromText("g").gauge("x", "n/a").render().endswith("g_x nan\n")
    for le, counts in (([0.1, 1.0], [0, 0, 0]), ([0.1, 1.0], [3, 0, 1]),
                       ([0.5, 1.0, 2.0], [0, 2, 2, 0]), ([], [1])):
        for q in (0.0, 0.5, 0.9, 0.99, 1.0, 1.5):
            assert (SMetrics.histogram_quantile(le, counts, q)
                    == JMetrics.histogram_quantile(le, counts, q))


def _segment(L, path, trace, iters, stop="niterations", rid="req-1"):
    led = L.CostLedger(path, run_id="det", trace=trace, request_id=rid)
    for i in iters:
        led.on_iteration(types.SimpleNamespace(iteration=i, num_evals=100.0 * i,
                                               elapsed=1.0 * i, device_s=0.5 * i,
                                               host_s=0.1))
    led.note_phase("checkpoint", 0.25)
    led.note_checkpoint(4096)
    led.on_end({"stop_reason": stop, "elapsed_s": 9.0, "num_evals": 100.0 * max(iters)})
    return led


def _wall_free(acct):
    a = dict(acct, wall=dict(acct["wall"]))
    a["wall"].pop("t_start")
    a["wall"].pop("t_end")
    return a


def test_ledger_accounts_and_rollups_match_jax(tmp_path):
    trace = mint_trace("req-1", seed=7, niterations=4)
    assert trace == type(trace).from_dict(j_mint_trace("req-1", seed=7,
                                                       niterations=4).to_dict())
    roots = {}
    for name, L, R in (("port", SLedger, SRollup), ("jax", JLedger, JRollup)):
        root = tmp_path / name
        for rid, parts in (("req-a", [[1, 2], [3, 4]]), ("req-b", [[1, 2, 3]])):
            d = root / "requests" / rid / rid
            d.mkdir(parents=True)
            for k, iters in enumerate(parts):
                stop = "preempted" if k < len(parts) - 1 else "niterations"
                acct = _segment(L, str(d / "ledger.jsonl"), mint_trace(rid, seed=0,
                                niterations=4), iters, stop, rid).account()
                assert SLedger.validate_account(acct) == JLedger.validate_account(acct) == []
        roots[name] = str(root)
    for rid in ("req-a", "req-b"):
        paths = [os.path.join(roots[n], "requests", rid, rid, "ledger.jsonl")
                 for n in ("port", "jax")]
        sa, ja = SLedger.load_accounts(paths[0]), JLedger.load_accounts(paths[1])
        assert [_wall_free(a) for a in sa] == [_wall_free(a) for a in ja]
        assert SLedger.fold_accounts(sa) == JLedger.fold_accounts(ja)
        # each package fingerprints the other's file alike
        assert (SLedger.ledger_fingerprint(paths[0]) == JLedger.ledger_fingerprint(paths[0])
                == JLedger.ledger_fingerprint(paths[1]))
    sr, jr = SRollup.build_rollup(roots["port"]), JRollup.build_rollup(roots["jax"])
    sr.pop("root")
    jr.pop("root")
    assert sr == jr and sr["requests"]["req-a"]["segments"] == 2
    assert SRollup.write_rollup(roots["port"]) and JRollup.load_rollup(roots["port"])


# ---------------------------------------------------------------------------
# The search's diagnostics
# ---------------------------------------------------------------------------


def _problem(n=120, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + np.cos(X[:, 0])).astype(np.float32)
    return X, y


def _search(tmp_path, run_id, niterations=3, ropt=None, **kw):
    base = dict(binary_operators=["+", "*"], unary_operators=["cos"], maxsize=10,
                populations=2, population_size=12, tournament_selection_n=4,
                ncycles_per_iteration=3, output_directory=str(tmp_path))
    base.update(kw)
    ropt = dict(ropt or {})
    state, hof = S.equation_search(
        *_problem(), options=S.Options(**base), seed=0, device="cpu",
        runtime_options=S.RuntimeOptions(niterations=niterations, run_id=run_id, verbosity=0,
                                         return_state=True, **ropt))
    return state, hof, os.path.join(str(tmp_path), run_id)


def _bits(state):
    out = []
    map_arrays(dataclasses.replace(state, telem=None),
               lambda t: out.append(t.view(torch.int32) if t.dtype == torch.float32 else t))
    return out


def test_hof_bit_identical_with_diagnostics_on_and_off(tmp_path):
    off = dict(ledger=False, pulse=False, gauge=False)
    runs = [_search(tmp_path, f"r{i}", ropt=(off if i in (0, 3) else {}), telemetry=True)
            for i in range(4)]
    ref = _bits(runs[0][0].device_states[0])
    for state, hof, run_dir in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(ref, _bits(state.device_states[0])))
        assert [e.equation_string() for e in hof.entries] == [
            e.equation_string() for e in runs[0][1].entries]
    assert "ledger.jsonl" not in os.listdir(runs[0][2])
    # on: the ledger validates under the JAX package; gauge and the rest of
    # the stream validate under both schemas
    run_dir = runs[1][2]
    accts = JLedger.load_accounts(os.path.join(run_dir, "ledger.jsonl"))
    assert len(accts) == 1 and accts[0]["deterministic"]["iterations"] == 3
    assert set(accts[0]["wall"]["phases"]) >= {"hof_decode", "checkpoint", "sinks"}
    assert accts[0]["trace"] == mint_run_trace("r1").to_dict()
    with open(os.path.join(run_dir, "telemetry.jsonl")) as f:
        lines = f.readlines()
    assert SSchema.validate_lines(lines) == [] and JSchema.validate_lines(lines) == []
    gauge = [json.loads(l) for l in lines if '"gauge"' in l]
    assert [g["kind"] for g in gauge] == ["memory"] * 3 + ["watermark", "dispatch_latency"]
    # the CPU has no allocator to ask: the sampler degrades, stats None
    assert gauge[0]["detail"]["live_bytes"] == 0 and "bytes_in_use" not in gauge[0]["detail"]
    assert gauge[-1]["detail"]["count"] == 3
    off_lines = open(os.path.join(runs[0][2], "telemetry.jsonl")).read()
    assert '"gauge"' not in off_lines


def test_injected_fault_dumps_a_bundle_valid_under_jax(tmp_path):
    SFaults.install(SFaults.FaultInjector(SFaults.FaultPlan(
        raise_on_dispatch=2, raise_count=1, raise_message="CUDA out of memory")))
    try:
        _, _, run_dir = _search(tmp_path, "f", telemetry=True)
    finally:
        SFaults.clear()
    path = os.path.join(run_dir, "pulse_bundle.json")
    with open(path) as f:
        bundle = json.load(f)
    assert JRecorder.validate_bundle(bundle) == []
    assert bundle["trigger"]["reason"] == "fault"
    assert bundle["run_id"] == "f" and bundle["trace"] == mint_run_trace("f").to_dict()
    assert JRecorder.bundle_fingerprint(path)
    events = [json.loads(l) for l in open(os.path.join(run_dir, "telemetry.jsonl"))]
    assert JSchema.validate_lines([json.dumps(e) for e in events]) == []
    assert any(e["event"] == "pulse" and e["kind"] == "bundle_dump" for e in events)


def test_profiler_window_and_timeline(tmp_path):
    _, _, run_dir = _search(tmp_path, "p", telemetry=True,
                            ropt=dict(pulse_trace_on=True, pulse_trace_iterations=1))
    trace = os.path.join(run_dir, "pulse_traces", "capture01", SCapture.TRACE_FILE)
    with open(trace) as f:
        assert "traceEvents" in json.load(f)
    kinds = [json.loads(l).get("kind") for l in open(os.path.join(run_dir, "telemetry.jsonl"))]
    assert kinds.count("capture_start") == 1 and kinds.count("capture_stop") == 1
    # the timeline of the run directory: valid under both packages, and
    # the two packages' exporters agree on it
    out = str(tmp_path / "t.json")
    assert SReport.main(["timeline", run_dir, "--out", out]) == 0
    doc = json.load(open(out))
    assert JTimeline.validate_chrome_trace(doc) == [] == STimeline.validate_chrome_trace(doc)
    assert doc == JTimeline.build_timeline(run_dir)
    names = {e["name"] for e in doc["traceEvents"]}
    assert "ledger segment 0" in names and "iteration 3" in names


def test_broken_profiler_disables_not_raises(tmp_path, monkeypatch):
    def broken(_):
        raise RuntimeError("profiler broken")

    monkeypatch.setattr(SCapture, "_start_profiler", broken)
    seen = []
    hub = types.SimpleNamespace(pulse=lambda kind, iteration=0, **d: seen.append((kind, d)))
    cap = TraceCapture(str(tmp_path), hub=hub)
    assert cap.arm("anomaly", 1)
    assert not cap.maybe_start(2)
    assert cap.disabled and not cap.arm("anomaly", 3)
    assert [k for k, _ in seen] == ["capture_armed", "capture_failed"]
    assert "profiler broken" in seen[-1][1]["error"]


def test_anomaly_recompiles_reads_kernel_loads(tmp_path):
    """The ``recompiles`` rule fires on a kernel library load after the
    warmup (the hub counts ops/cuda_build.py's loads as ``traces``)."""
    hub = Telemetry(S.Options(telemetry=True, telemetry_file=str(tmp_path / "a.jsonl")),
                    run_id="a", out_dir=str(tmp_path), niterations=9, nout=1, backend="cpu")
    try:
        det = AnomalyDetector(hub)
        for i in range(1, 8):
            if i == 7:
                hub._compiles._active = True
                hub._compiles._on_event("load", "program_eval.cu", 0.25)
            det.on_iteration(types.SimpleNamespace(iteration=i, num_evals=100.0 * i,
                                                   elapsed=1.0 * i, host_fraction=0.01,
                                                   counters=()))
        hub.gauge("memory", iteration=7, live_bytes=1, live_arrays=1)
    finally:
        hub.close()
    assert hub.anomaly_counts == {"recompiles": 1}
    assert hub.compile_seconds_snapshot()["trace_s"] == 0.25
    lines = open(tmp_path / "a.jsonl").readlines()
    assert JSchema.validate_lines(lines) == [] and SSchema.validate_lines(lines) == []
    assert [json.loads(l)["event"] for l in lines] == ["run_start", "anomaly", "gauge"]


def test_footprint_degrader_and_engine_cache_through_runtime_options(tmp_path):
    from symbolicregression_jl_tpu_torch.gauge import global_ledger

    global_ledger().clear()
    cache = ExecutableCache()
    a, _, run_dir = _search(tmp_path, "c0", telemetry=True, ropt=dict(
        engine_cache=cache, gauge_footprint=True, gauge_headroom_fraction=0.5,
        gauge_limit_bytes=1))
    b, _, _ = _search(tmp_path, "c1", ropt=dict(engine_cache=cache))
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 1
    events = [json.loads(l) for l in open(os.path.join(run_dir, "telemetry.jsonl"))]
    foot = [e for e in events if e["event"] == "gauge" and e["kind"] == "footprint"]
    assert len(foot) == 1 and foot[0]["detail"]["summary"]["total_bytes"] > 0
    # no allocator on the CPU: the watermark is live bytes (0) against a
    # 1-byte limit, under the line
    assert not [e for e in events if e["event"] == "fault"]
    assert JSchema.validate_lines([json.dumps(e) for e in events]) == []
    # the probe iteration is thrown away: the search is the plain one's
    c, _, _ = _search(tmp_path, "c2")
    assert all(torch.equal(x, y) for x, y in zip(_bits(a.device_states[0]),
                                                 _bits(c.device_states[0])))


def test_sampler_reads_the_allocator_when_there_is_one(monkeypatch):
    """On the CPU the sampler asks nothing; given a CUDA device it reads
    torch.cuda's allocator (faked here) in the JAX package's three fields."""
    assert SSampler.device_memory_stats() is None
    assert SSampler.live_array_bytes() == {"live_bytes": 0, "live_arrays": 0}
    fake = {"allocated_bytes.all.current": 300, "allocated_bytes.all.peak": 900,
            "active.all.current": 4}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev=None: fake)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: 300)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev=None: types.SimpleNamespace(total_memory=8000))
    dev = torch.device("cuda", 0)
    assert SSampler.device_memory_stats(dev) == {"bytes_in_use": 300, "peak_bytes_in_use": 900,
                                                 "bytes_limit": 8000}
    assert SSampler.live_array_bytes(dev) == {"live_bytes": 300, "live_arrays": 4}
