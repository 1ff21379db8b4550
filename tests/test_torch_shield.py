"""graftshield in the PyTorch port, held to the JAX package's
tests/test_shield.py cases at a small size on the CPU.

Transient failures retry and end bit-identical to a clean run, the rest
raise at once, exhausted retries step the engine down; the classifier
takes ``torch.cuda.OutOfMemoryError`` and refuses the sticky CUDA errors;
a NaN storm is quarantined (and left alone with the quarantine off); the
watchdog fires with a dump (rc 124 in a subprocess), stays quiet within
budget and ignores unbudgeted phases; the preemption guard sets its flag,
restores handlers, nests and chains unattended signals; a SIGTERM at
iteration k ends in an emergency checkpoint whose ``resume="auto"`` is
bit-identical to an uninterrupted run; the quarantine's primitives are
bit-equal to the JAX engine's; every ``fault`` record validates; a failed
attempt leaves its input state alone.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.evolve.engine import Engine as JEngine
from symbolicregression_jl_tpu.shield import degrade as JD
from symbolicregression_jl_tpu.shield import faults as JFaults
from symbolicregression_jl_tpu_torch import interop
from symbolicregression_jl_tpu_torch.evolve import engine as engine_mod
from symbolicregression_jl_tpu_torch.evolve.engine import Engine as SEngine
from symbolicregression_jl_tpu_torch.shield import faults
from symbolicregression_jl_tpu_torch.shield.degrade import ShieldRunner, is_transient_failure
from symbolicregression_jl_tpu_torch.shield.signals import PreemptionGuard
from symbolicregression_jl_tpu_torch.shield.watchdog import Watchdog, WatchdogTimeout
from symbolicregression_jl_tpu_torch.telemetry.schema import validate_event

from torch_parity import numpy_state, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _problem(n=200, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    y = (2.0 * X[:, 0] + X[:, 1] * X[:, 1]).astype(np.float32)
    return X, y


_BASE = dict(binary_operators=["+", "-", "*"], unary_operators=[], maxsize=10, populations=2,
             population_size=12, tournament_selection_n=4, ncycles_per_iteration=4)


def _options(tmp_path, **kw):
    base = dict(_BASE, save_to_file=True, output_directory=str(tmp_path))
    base.update(kw)
    return S.Options(**base)


def _search(tmp_path, run_id, niterations, seed=1, **kw):
    """A search's state and hall of fame (CPU, quiet)."""
    opt_kw = {k: kw.pop(k) for k in list(kw) if k not in ("resume",)}
    return S.equation_search(*_problem(), options=_options(tmp_path, **opt_kw),
                             niterations=niterations, seed=seed, run_id=run_id, verbosity=0,
                             device="cpu", return_state=True, **kw)


@pytest.fixture(autouse=True)
def _clear_injector():
    yield
    faults.clear()


def _events(run_dir, event="fault"):
    with open(os.path.join(run_dir, "telemetry.jsonl")) as f:
        evs = [json.loads(line) for line in f]
    for e in evs:
        assert validate_event(e) == [], e
    return [e for e in evs if e["event"] == event]


def _state_tensors(state):
    """Every tensor of a SearchDeviceState, by its path."""
    out = {}

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            out[path] = x
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{path}.{f.name}")

    walk(state, "state")
    return out


def _assert_states_equal(a, b, skip=()):
    """Every tensor bit for bit but the telemetry counters (on in one run
    of a pair, off in the other)."""
    ta, tb = (_state_tensors(dataclasses.replace(s, telem=None)) for s in (a, b))
    assert ta.keys() == tb.keys()
    for k in ta:
        if k in skip:
            continue
        x, y = ta[k], tb[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.is_floating_point():
            assert torch.equal(x.view(torch.int32 if x.element_size() == 4 else torch.int64),
                               y.view(torch.int32 if y.element_size() == 4 else torch.int64)), k
        else:
            assert torch.equal(x, y), k


# ---------------------------------------------------------------------------
# retry / degradation
# ---------------------------------------------------------------------------


def test_shield_on_off_and_transient_retry_bit_identical(tmp_path):
    """With no fault, the shield on and off give the same state bit for
    bit; two injected CUDA out-of-memory failures of the second attempt
    retry (two retry records) and end bit-identical to the clean run."""
    sA, _ = _search(tmp_path, "off", 3, shield=False)
    sB, _ = _search(tmp_path, "on", 3)
    _assert_states_equal(sA.device_states[0], sB.device_states[0])
    faults.install(faults.FaultInjector(faults.FaultPlan(
        raise_on_dispatch=2, raise_count=2,
        raise_message="CUDA out of memory. Tried to allocate 2.00 GiB")))
    sC, _ = _search(tmp_path, "retry", 3, telemetry=True, retry_backoff=0.0)
    _assert_states_equal(sA.device_states[0], sC.device_states[0])
    evs = _events(os.path.join(tmp_path, "retry"))
    retries = [e for e in evs if e["kind"] == "retry"]
    assert [e["detail"]["attempt"] for e in retries] == [1, 2]
    assert all(e["iteration"] == 2 for e in retries)
    assert [e["detail"]["fault"] for e in evs if e["kind"] == "injected"] == [
        "raise_on_dispatch"] * 2


@pytest.mark.parametrize("message", ["INVALID_ARGUMENT: genuinely broken",
                                     "CUDA error: an illegal memory access was encountered "
                                     "(out of memory while recovering)"])
def test_nontransient_failure_raises_immediately(tmp_path, message):
    inj = faults.install(faults.FaultInjector(faults.FaultPlan(raise_on_dispatch=1,
                                                               raise_message=message)))
    with pytest.raises(faults.InjectedFault, match=message[:20]):
        _search(tmp_path, "bad", 1, save_to_file=False)
    assert inj.dispatches == 1


def test_retry_exhaustion_degrades_eval_tile_rows():
    opts = S.Options(binary_operators=["+", "*"], unary_operators=[], maxsize=8, populations=2,
                     population_size=8, tournament_selection_n=4, ncycles_per_iteration=2,
                     eval_tile_rows=2048, save_to_file=False)
    engine = SEngine(opts, 2, device="cpu")
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 3:   # 1 try + 2 retries, all out of memory -> degrade
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 1 GiB")
        return "ok"

    runner = ShieldRunner(max_retries=2, backoff=0.0)
    assert runner.run(flaky, engine=engine) == "ok"
    assert runner.retries_total == 2 and runner.degrades_total == 1
    assert engine.cfg.eval_tile_rows == 1024

    def always_oom():
        raise RuntimeError("RESOURCE_EXHAUSTED: injected")

    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        ShieldRunner(max_retries=0, backoff=0.0).run(always_oom, engine=engine)
    assert engine.cfg.eval_tile_rows == 512   # stepped down to the floor first
    assert engine.degrade_eval_tile_rows() is None


_TEXTS = ["RESOURCE_EXHAUSTED: oom", "UNAVAILABLE: link down", "Failed to deserialize cache entry",
          "INVALID_ARGUMENT: shape", "Array has been deleted (donated)",
          "Resource exhausted: Out of memory while trying to allocate 8 bytes"]


def test_transient_classifier():
    """The JAX package's cases classify alike; a CUDA out-of-memory is
    transient by its type whatever its text; the sticky CUDA errors and a
    failed kernel build never are."""
    for text in _TEXTS:
        assert is_transient_failure(RuntimeError(text)) == JD.is_transient_failure(
            RuntimeError(text)), text
    assert is_transient_failure(torch.cuda.OutOfMemoryError("allocator gave up"))
    assert is_transient_failure(RuntimeError("CUDA out of memory. Tried to allocate 20 MiB"))
    for text in ("CUDA error: an illegal memory access was encountered",
                 "CUDA error: device-side assert triggered",
                 "CUDA error: unspecified launch failure",
                 "program_eval kernel launch failed: cudaErrorLaunchFailure",
                 "nvcc failed on program_eval.cu: out of memory"):
        assert not is_transient_failure(RuntimeError(text)), text
    assert not is_transient_failure(
        torch.cuda.OutOfMemoryError("CUDA error: an illegal memory access was encountered"))


# ---------------------------------------------------------------------------
# quarantine
# ---------------------------------------------------------------------------


def test_nan_storm_island_is_quarantined(tmp_path):
    faults.install(faults.FaultInjector(faults.FaultPlan(nan_poison_island=(0, 1))))
    state, hof = _search(tmp_path, "qrt", 3, telemetry=True)
    q = [e for e in _events(os.path.join(tmp_path, "qrt")) if e["kind"] == "quarantine"]
    assert q and q[0]["detail"]["islands"] == [0] and q[0]["iteration"] == 1
    assert q[0]["detail"]["invalid_fractions"][0] == 1.0
    loss = to_np(state.device_states[0].pops.loss)
    assert np.isfinite(loss[0]).mean() > 0.5
    assert len(hof.entries) > 0


def test_quarantine_off_leaves_storm_alone(tmp_path):
    faults.install(faults.FaultInjector(faults.FaultPlan(nan_poison_island=(0, 2))))
    state, _ = _search(tmp_path, "noq", 2, save_to_file=False, island_quarantine=False)
    assert not np.isfinite(to_np(state.device_states[0].pops.loss)[0]).any()


def _jax_state_with_hof(seed: int = 0):
    X, y = _problem(64, seed)
    kw = dict(_BASE, populations=3, save_to_file=False)
    jo = J.Options(**kw)
    jds = J.make_dataset(X, y)
    jds.update_baseline_loss(jo.elementwise_loss)
    je = JEngine(jo, 2)
    js = je.run_iteration(je.init_state(jax.random.key(seed), jds.data, 3), jds.data, 10)
    return je, js, S.Options(**kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_quarantine_primitives_bit_equal_to_jax(seed):
    """island_invalid_fractions and reseed_islands on a JAX state carried
    across: every field of the reseeded state bit-equal to the JAX
    engine's, with islands 0 and 2 reseeded; an empty hall of fame leaves
    the state as it was."""
    je, js, so = _jax_state_with_hof(seed)
    js = JFaults.poison_island(js, 0)
    ss = interop.search_state(numpy_state(js), device="cpu")
    se = SEngine(so, 2, device="cpu")
    assert np.array_equal(to_np(je.island_invalid_fractions(js)),
                          to_np(se.island_invalid_fractions(ss)))
    assert to_np(se.island_invalid_fractions(ss))[0] == 1.0
    mask = np.array([True, False, True])
    jr = je.reseed_islands(js, jax.numpy.asarray(mask))
    sr = se.reseed_islands(ss, torch.from_numpy(mask))
    want = interop.search_state(numpy_state(jr), device="cpu")
    _assert_states_equal(dataclasses.replace(want, telem=None), dataclasses.replace(sr, telem=None))
    empty = dataclasses.replace(ss, hof=dataclasses.replace(
        ss.hof, exists=torch.zeros_like(ss.hof.exists)))
    _assert_states_equal(se.reseed_islands(empty, torch.from_numpy(mask)), empty)


# ---------------------------------------------------------------------------
# a failed attempt leaves its input alone
# ---------------------------------------------------------------------------


def test_failed_attempt_leaves_input_state_unchanged(monkeypatch):
    """An out-of-memory raised in the epilogue's migration, after the
    cycles, the optimizer, the finalize and the hall-of-fame merge wrote
    their results: every tensor of the input state keeps its bits, and the
    retry from it equals a run that never failed."""
    X, y = _problem(64)
    so = S.Options(**dict(_BASE, populations=3, save_to_file=False, telemetry=True))
    se = SEngine(so, 2, device="cpu")
    data = S.make_dataset(X, y, device="cpu").data
    state = se.init_state(interop.key(np.array([0, 7], np.uint32), device="cpu"), data, 3)
    state = se.run_iteration(state, data, 10)
    before = {k: v.clone() for k, v in _state_tensors(state).items()}
    real = engine_mod._migrate

    def failing(*a, **k):
        real(*a, **k)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory in the epilogue")

    monkeypatch.setattr(engine_mod, "_migrate", failing)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        se.run_iteration(state, data, 10)
    for k, v in _state_tensors(state).items():
        assert torch.equal(v, before[k]) or (v.is_floating_point() and torch.equal(
            torch.isnan(v), torch.isnan(before[k])) and torch.equal(
            torch.nan_to_num(v), torch.nan_to_num(before[k]))), k
    monkeypatch.setattr(engine_mod, "_migrate", real)
    runner = ShieldRunner(max_retries=1, backoff=0.0)
    calls = {"n": 0}

    def attempt():
        calls["n"] += 1
        if calls["n"] == 1:
            monkeypatch.setattr(engine_mod, "_migrate", failing)
        else:
            monkeypatch.setattr(engine_mod, "_migrate", real)
        return se.run_iteration(state, data, 10)

    retried = runner.run(attempt)
    clean = se.run_iteration(state, data, 10)
    assert runner.retries_total == 1
    _assert_states_equal(retried, clean)


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------


def test_watchdog_fires_with_diagnostic_dump(tmp_path):
    import time

    dumps = []
    wd = Watchdog(on_timeout=dumps.append, poll_interval=0.02,
                  dump_path=str(tmp_path / "dump.txt"))
    with pytest.raises(WatchdogTimeout, match="hang-phase"):
        with wd.phase("hang-phase", budget=0.05, iteration=3):
            time.sleep(0.5)
    wd.stop()
    assert len(dumps) == 1
    dump = dumps[0]
    assert "hang-phase" in dump and "iteration  : 3" in dump
    assert "(main)" in dump
    assert "test_watchdog_fires_with_diagnostic_dump" in dump
    assert os.path.exists(tmp_path / "dump.txt")


def test_watchdog_quiet_within_budget():
    wd = Watchdog(on_timeout=lambda d: pytest.fail("fired"), poll_interval=0.02)
    for i in range(3):
        with wd.phase("fast", budget=5.0, iteration=i):
            pass
    wd.stop()
    assert not wd.fired


def test_watchdog_unbudgeted_phase_is_noop():
    import time

    wd = Watchdog(on_timeout=lambda d: pytest.fail("fired"))
    with wd.phase("unsupervised", budget=None):
        time.sleep(0.05)
    wd.stop()
    assert wd._thread is None


def _run_script(body: str, tmp_path, env_extra=None, timeout=300):
    """Run a search script in a fresh CPU process from the repository root."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **(env_extra or {}))
    script = textwrap.dedent('''
        import numpy as np, sys, torch
        torch.set_num_threads(1)
        import symbolicregression_jl_tpu_torch as S
        rng = np.random.default_rng(0)
        X = rng.uniform(-2, 2, (200, 2)).astype(np.float32)
        y = (2.0 * X[:, 0] + X[:, 1] * X[:, 1]).astype(np.float32)
        base = dict(binary_operators=["+", "-", "*"], unary_operators=[], maxsize=10,
                    populations=2, population_size=12, tournament_selection_n=4,
                    ncycles_per_iteration=4, save_to_file=True, output_directory=sys.argv[1])
    ''') + textwrap.dedent(body)
    return subprocess.run([sys.executable, "-c", script, str(tmp_path)], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_watchdog_deadline_exits_124_with_dump(tmp_path):
    """An armed iteration_deadline against a hang in the second iteration
    attempt: the process exits with code 124 within the deadline's reach,
    with the dump on stderr and in the run directory, naming the phase;
    the watchdog_timeout record is in the stream."""
    proc = _run_script('''
        o = S.Options(telemetry=True, iteration_deadline=1.0, **base)
        S.equation_search(X, y, options=o, niterations=3, seed=1, run_id="wd", verbosity=0,
                          device="cpu")
        print("finished")
    ''', tmp_path, {"SR_FAULT_PLAN": json.dumps({"hang_on_dispatch": [2, 60]})})
    assert proc.returncode == 124, proc.stderr[-2000:]
    assert "finished" not in proc.stdout
    assert "phase deadline exceeded" in proc.stderr and "phase      : iteration" in proc.stderr
    assert "(main)" in proc.stderr
    dump = open(tmp_path / "wd" / "watchdog_dump.txt").read()
    assert "iteration  : 2" in dump
    kinds = [e["kind"] for e in _events(tmp_path / "wd")]
    assert kinds[:2] == ["injected", "watchdog_timeout"]


# ---------------------------------------------------------------------------
# preemption: SIGTERM -> emergency checkpoint -> resume bit-identical
# ---------------------------------------------------------------------------


def test_sigterm_resume_auto_bit_identical(tmp_path):
    """A real SIGTERM at the end of iteration 2 (in its own process) stops
    the search with stop_reason "preempted" and an emergency checkpoint;
    resume="auto" (another seed, which must not matter) then runs
    iterations 3 and 4 and ends with every state tensor and the hall of
    fame bit-identical to an uninterrupted 4-iteration run."""
    sA, hA = _search(tmp_path / "a", "ref", 4, seed=7)
    proc = _run_script('''
        o = S.Options(telemetry=True, **base)
        S.equation_search(X, y, options=o, niterations=4, seed=7, run_id="pre", verbosity=0,
                          device="cpu")
    ''', tmp_path / "b", {"SR_FAULT_PLAN": json.dumps({"sigterm_at_iteration": 2})})
    assert proc.returncode == 0, proc.stderr[-2000:]
    run_dir = tmp_path / "b" / "pre"
    kinds = {e["kind"] for e in _events(run_dir)}
    assert {"injected", "preempt_signal", "emergency_checkpoint"} <= kinds
    end = _events(run_dir, "run_end")[0]
    assert end["stop_reason"] == "preempted" and end["iterations"] == 2
    assert end["faults_total"]["preempt_signal"] == 1
    sC, hC = _search(tmp_path / "b", "res", 4, seed=99, resume="auto", telemetry=True)
    assert sC.iterations_done == 4
    # The device evaluation counter restarts on resume; the totals agree.
    _assert_states_equal(sA.device_states[0], sC.device_states[0], skip=("state.num_evals",))
    assert sC.num_evals == pytest.approx(sA.num_evals, rel=1e-6)
    assert [(e.loss, e.complexity) for e in hA.entries] == [(e.loss, e.complexity)
                                                           for e in hC.entries]
    res = _events(tmp_path / "b" / "res")
    assert [e["kind"] for e in res] == ["resume"] and res[0]["detail"]["iterations_done"] == 2


def test_resume_past_corrupt_checkpoint_leaves_fault_record(tmp_path):
    """A resume that passes over a corrupt newest checkpoint emits a
    checkpoint_corrupt record naming it, then resume for the one used."""
    S.equation_search(*_problem(), options=_options(tmp_path), seed=1, device="cpu",
                      runtime_options=S.RuntimeOptions(niterations=2, run_id="r", verbosity=0,
                                                       checkpoint_every_n=1))
    newest = os.path.join(tmp_path, "r", "search_state.pkl")
    faults.flip_byte(newest)
    with pytest.warns(UserWarning, match="corrupt"):
        state, _ = _search(tmp_path, "r2", 3, resume="auto", telemetry=True)
    assert state.iterations_done == 3
    evs = _events(tmp_path / "r2")
    assert [e["kind"] for e in evs] == ["checkpoint_corrupt", "resume"]
    assert evs[0]["detail"]["path"] == newest and evs[0]["iteration"] == 1
    assert evs[1]["detail"]["path"] == newest + ".1"


def test_hub_counts_faults_with_the_stream_off(tmp_path):
    from symbolicregression_jl_tpu_torch.telemetry.hub import Telemetry

    hub = Telemetry(_options(tmp_path, save_to_file=False), run_id="x", out_dir=None,
                    niterations=1, nout=1, backend="cpu")
    ev = hub.fault("retry", iteration=3, attempt=1, error=None)
    assert ev == {"event": "fault", "kind": "retry", "iteration": 3, "detail": {"attempt": 1}}
    hub.fault("retry", iteration=4)
    assert hub.fault_counts == {"retry": 2} and hub.path is None
    hub.close()


# ---------------------------------------------------------------------------
# signals / plan plumbing
# ---------------------------------------------------------------------------


def test_preemption_guard_sets_flag_and_restores_handlers():
    import signal

    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as g:
        assert g.installed and not g.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.requested and g.signal_name == "SIGTERM"
    assert signal.getsignal(signal.SIGTERM) is before


def test_preemption_guard_refcounted_nesting():
    import signal

    before = signal.getsignal(signal.SIGTERM)
    outer = PreemptionGuard().install()
    ours = signal.getsignal(signal.SIGTERM)
    inner = PreemptionGuard().install()
    assert signal.getsignal(signal.SIGTERM) is ours
    inner.uninstall()
    assert signal.getsignal(signal.SIGTERM) is ours
    inner2 = PreemptionGuard().install()
    os.kill(os.getpid(), signal.SIGTERM)
    assert outer.requested and inner2.requested
    inner2.uninstall()
    assert outer.requested
    outer.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before
    with PreemptionGuard() as g:
        assert not g.requested


def test_preemption_guard_worker_thread_observes_main_install():
    import signal
    import threading

    seen = {}

    def worker(ready, fired):
        g = PreemptionGuard().install()
        seen["installed_handlers"] = g.installed
        ready.set()
        fired.wait(timeout=5)
        seen["requested"] = g.requested
        g.uninstall()

    with PreemptionGuard():
        ready, fired = threading.Event(), threading.Event()
        t = threading.Thread(target=worker, args=(ready, fired))
        t.start()
        assert ready.wait(timeout=5)
        os.kill(os.getpid(), signal.SIGTERM)
        fired.set()
        t.join(timeout=5)
    assert seen["requested"] is True


def test_unattended_signal_chains_to_original_disposition():
    import signal
    import threading
    import time

    before = signal.getsignal(signal.SIGINT)
    g = PreemptionGuard().install()
    t = threading.Thread(target=g.uninstall)
    t.start()
    t.join(timeout=5)
    assert signal.getsignal(signal.SIGINT) is not before
    with pytest.raises(KeyboardInterrupt):
        os.kill(os.getpid(), signal.SIGINT)
        for _ in range(100):
            time.sleep(0.01)
    assert signal.getsignal(signal.SIGINT) is before
    with PreemptionGuard() as g2:
        assert not g2.requested
    assert signal.getsignal(signal.SIGINT) is before


def test_fault_plan_env_roundtrip(monkeypatch):
    plan = faults.FaultPlan(raise_on_dispatch=3, raise_count=2, nan_poison_island=(1, 4),
                            hang_on_dispatch=(2, 0.5))
    text = json.dumps({"raise_on_dispatch": 3, "raise_count": 2, "nan_poison_island": [1, 4],
                       "hang_on_dispatch": [2, 0.5]})
    assert faults.FaultPlan.from_json(text) == plan
    assert dataclasses.asdict(plan) == dataclasses.asdict(JFaults.FaultPlan.from_json(text))
    monkeypatch.setenv("SR_FAULT_PLAN", text)
    inj = faults.active_injector()
    assert inj is not None and inj.plan == plan
    monkeypatch.delenv("SR_FAULT_PLAN")
    assert faults.active_injector() is None
