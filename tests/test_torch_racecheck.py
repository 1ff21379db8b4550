"""graftwarden's runtime side in the PyTorch/CUDA port
(``symbolicregression_jl_tpu_torch.lint.racecheck``).

- The three replay scenarios give the JAX package's outcomes
  (tests/test_racecheck.py pins them there): each passes on the current
  code, and the reverted shims of cancel-vs-submit and
  cancel-overlapping-preemption fail with the same signatures. They run in
  a child process, because the stale-guard scenario sends the process a
  SIGTERM. The stale-guard shim waits out a 60 s request timeout and is
  not replayed here.
- ``SearchServer(debug_checks=True)`` (and ``SR_RACECHECK=1``) instruments
  the server and the kernel launch path's process-wide locks, and serves a
  mini request to completion with every observed edge inside the blessed
  manifest.
- The instrumented lock behaves as the JAX package's.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from symbolicregression_jl_tpu.lint import racecheck as JRC
from symbolicregression_jl_tpu_torch.lint import racecheck as SRC
from symbolicregression_jl_tpu_torch.lint.lock_order import BLESSED_EDGES, blessed_closure

import torch_parity  # noqa: F401  (caps torch's threads per xdist worker)

ROOT = Path(__file__).resolve().parent.parent

# The JAX package's outcomes of the replays (tests/test_racecheck.py).
JAX_OUTCOMES = {
    ("cancel_vs_submit", False): (True, {"replayed_state": "cancelled"}),
    ("cancel_vs_submit", True): (False, {"replayed_state": "queued"}),
    ("cancel_overlapping_preemption", False): (True, {"state": "cancelled",
                                                      "cancel_reason": "cancelled"}),
    ("cancel_overlapping_preemption", True): (False, {"state": "queued"}),
    ("stale_guard_restart", False): (True, {"state": "done"}),
}


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    SRC.clear_race_plan()
    yield
    SRC.clear_race_plan()


def test_replays_give_the_jax_packages_outcomes(tmp_path):
    code = (
        "import json, sys\n"
        "from symbolicregression_jl_tpu_torch.lint.racecheck import replay_scenario\n"
        "out = []\n"
        f"for i, (name, shim) in enumerate({sorted(JAX_OUTCOMES)!r}):\n"
        f"    r = replay_scenario(name, {str(tmp_path)!r} + f'/{{i}}', shim=shim,"
        " device='cpu')\n"
        "    out.append([name, shim, r['ok'], r['detail']])\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, SYMBOLIC_REGRESSION_IS_TESTING="true")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(rows) == len(JAX_OUTCOMES)
    for name, shim, ok, detail in rows:
        want_ok, want_detail = JAX_OUTCOMES[(name, shim)]
        assert ok is want_ok, (name, shim, detail)
        for k, v in want_detail.items():
            assert detail[k] == v, (name, shim, detail)
    assert set(SRC.SCENARIOS) == set(JRC.SCENARIOS)
    with pytest.raises(KeyError):
        SRC.replay_scenario("nope", str(tmp_path))


def test_debug_server_serves_a_mini_request_inside_the_manifest(tmp_path):
    from symbolicregression_jl_tpu_torch.ops import cuda_build, fused_eval
    from symbolicregression_jl_tpu_torch.serve.server import SearchServer

    srv = SearchServer(str(tmp_path / "root"), capacity=4, workers=1, debug_checks=True,
                       device="cpu").start()
    for lk in (srv._lock, srv.journal._lock, srv.admission._lock, srv.log._lock,
               srv.cache._lock, cuda_build._LOCK, fused_eval._BF16_LOCK,
               fused_eval._WEIGHTED_LOCK, fused_eval.PROGRAM_EVAL._lock):
        assert isinstance(lk, SRC.InstrumentedLock), lk
    inner = srv._lock.inner
    SRC.instrument_server(srv)   # idempotent: no double wrap
    assert srv._lock.inner is inner
    X = np.random.default_rng(0).normal(size=(64, 2)).astype(np.float32)
    rid = srv.submit(X, (2.0 * X[:, 0]).astype(np.float32), options=dict(
        binary_operators=["+", "*"], unary_operators=[], maxsize=8, populations=2,
        population_size=8, ncycles_per_iteration=2, tournament_selection_n=4,
        optimizer_probability=0.0, turbo=True), niterations=1, seed=0)
    snap = srv.wait(rid, timeout=120)
    srv.stop(drain=True, timeout=30)
    assert snap["state"] == "done", snap
    rec = SRC.global_recorder()
    assert rec.violations == []
    closure = blessed_closure(BLESSED_EDGES)
    for (a, b) in rec.edges:
        assert a not in closure.get(b, ()), f"inverted edge {a} -> {b}"


def test_sr_racecheck_env_instruments(tmp_path, monkeypatch):
    from symbolicregression_jl_tpu_torch.serve.server import SearchServer

    monkeypatch.setenv("SR_RACECHECK", "1")
    srv = SearchServer(str(tmp_path / "r"), workers=0, device="cpu")
    assert srv.debug_checks and isinstance(srv._lock, SRC.InstrumentedLock)


@pytest.mark.parametrize("pkg", [JRC, SRC], ids=["jax", "port"])
def test_instrumented_lock_semantics_match(pkg):
    """Blessed nesting passes, an inversion raises before the inner lock is
    taken, a Condition works over the wrapped lock, a race window fires on
    its nth matching acquire only — the same in both packages."""
    rec = pkg.LockRecorder()
    srv = pkg.InstrumentedLock("SearchServer._lock", recorder=rec)
    adm = pkg.InstrumentedLock("AdmissionController._lock", recorder=rec)
    with srv:
        with adm:
            pass
    with pytest.raises(pkg.LockOrderViolation):
        with adm:
            with srv:
                pass
    assert not srv.inner._is_owned() and rec.held() == []
    cond = threading.Condition(srv)
    with cond:
        cond.wait(timeout=0.01)
    plan = pkg.install_race_plan(pkg.RacePlan.from_dict({"windows": [{
        "lock": "SearchServer._lock", "op": "acquire", "caller": "target", "nth": 2,
        "pause_s": 0.01}]}))

    def target():
        with srv:
            pass

    target()
    assert not plan.windows[0].entered.is_set()
    target()
    assert plan.windows[0].entered.is_set()
    pkg.clear_race_plan()
