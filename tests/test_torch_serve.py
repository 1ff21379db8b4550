"""The port's graftserve (serve/) on the CPU, and its host-level modules
against the JAX package's.

Against the JAX package (host-level modules only; no JAX search or
server runs): ``shape_bucket``, admission decisions and the overload
ladder's levels and sheds over one sequence; journals read across, each
package reading the other's file digest for digest, a torn tail and a
corrupt middle record handled alike; the serve stream validates under
both schemas. Within the port: submit, poll, cancel and deadline; two
packed tenants bit-identical to their solo runs; a server SIGKILLed in a
child process after its first checkpoint replays to the unkilled
fingerprints; ``debug_checks=True`` refused by name; the load bench at
its storm options. Sizes are the load bench's storm options (2 islands x
8 members, maxsize 8, 2 cycles) on a few hundred rows.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from symbolicregression_jl_tpu.serve import admission as JA
from symbolicregression_jl_tpu.serve import journal as JJ
from symbolicregression_jl_tpu.shield import degrade as JD
from symbolicregression_jl_tpu.telemetry import schema as JSchema
from symbolicregression_jl_tpu_torch.bench import load as SLoad
from symbolicregression_jl_tpu_torch.pack import PackPolicy
from symbolicregression_jl_tpu_torch.serve import SearchServer, ServerSaturated
from symbolicregression_jl_tpu_torch.serve import admission as SA
from symbolicregression_jl_tpu_torch.serve import journal as SJ
from symbolicregression_jl_tpu_torch.shield import degrade as SD
from symbolicregression_jl_tpu_torch.shield.faults import flip_byte
from symbolicregression_jl_tpu_torch.telemetry import schema as SSchema

import torch_parity  # noqa: F401  (caps torch's threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = SLoad._storm_options()


def _problem(n=200, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (n, 2)).astype(np.float32)
    y = (X[:, 0] * 2.0 + X[:, 1] * X[:, 1]).astype(np.float32)
    return X, y


def _server(root, **kw):
    return SearchServer(str(root), device="cpu", **kw)


# ---------------------------------------------------------------------------
# Host-level modules against the JAX package's
# ---------------------------------------------------------------------------


def test_shape_bucket_and_admission_sequence_match_jax():
    seq = [(10, 2, 1), (256, 2, 1), (257, 3, 1), (5000, 5, 1), (8192, 5, 1), (8193, 5, 2)]
    for args in seq:
        assert SA.shape_bucket(*args) == JA.shape_bucket(*args)
    # one admission sequence: fills the queue through every ladder level,
    # releases, observes service times, then rejects on a full bucket
    steps = [("admit", 900, 0), ("admit", 100, 0), ("admit", 300, 1), ("service", 2.5),
             ("admit", 700, 0), ("admit", 50, 2), ("release", 0), ("admit", 512, 0),
             ("admit", 4000, 1), ("release", 1), ("admit", 64, 0), ("admit", 9000, 0)]

    def run(A, D):
        ctl = A.AdmissionController(4, bucket_capacity=3, ladder=D.OverloadLadder())
        out, buckets = [], []
        for step in steps:
            if step[0] == "admit":
                try:
                    d = ctl.admit(n_rows=step[1], nfeatures=2, priority=step[2],
                                  request_id=f"r{len(out)}")
                    buckets.append(d.bucket)
                    out.append(("ok", d.bucket, d.priority, d.sample_rows, d.level,
                                d.utilization))
                except Exception as e:  # the structured reject
                    out.append(("reject", type(e).__name__, e.to_dict()))
            elif step[0] == "release":
                ctl.release(buckets[step[1]])
            else:
                ctl.observe_service_time(step[1])
        return out, ctl.ladder.sheds_total, ctl.ladder.rejects_total, ctl.depth

    got, want = run(SA, SD), run(JA, JD)
    assert got == want
    assert any(o[0] == "reject" for o in got[0]) and got[1] > 0


def test_overload_ladder_levels_and_sheds_match_jax():
    kw = dict(shed_sample_at=0.25, shed_priority_at=0.5, reject_at=0.9, sample_fraction=0.3,
              min_sample_rows=40)
    s, j = SD.OverloadLadder(**kw), JD.OverloadLadder(**kw)
    for u in (0.0, 0.24, 0.25, 0.4, 0.5, 0.75, 0.89, 0.9, 1.3):
        for n in (10, 40, 100, 10_000):
            assert s.apply(u, n_rows=n, priority=1) == j.apply(u, n_rows=n, priority=1)
    assert (s.sheds_total, s.rejects_total) == (j.sheds_total, j.rejects_total)
    with pytest.raises(ValueError):
        SD.OverloadLadder(shed_sample_at=0.8, shed_priority_at=0.5)


def _write_journal(J, path):
    X, y = _problem(30)
    jr = J.RequestJournal(str(path))
    jr.append("submit", "req00001", {"X": J.encode_array(X), "y": J.encode_array(y),
                                     "niterations": 2, "seed": 3})
    jr.append("start", "req00001", {"resumed": False})
    jr.append("submit", "req00002", {"X": J.encode_array(X[:7].astype(np.float64)),
                                     "y": J.encode_array(y[:7]), "niterations": 1, "seed": 4})
    jr.append("cancel", "req00002", {"reason": "cancelled"})
    jr.append("done", "req00001", {"result": {"fingerprint": "ab", "iterations": 2}})
    return X


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journals_read_across_packages(tmp_path, writer):
    W, R = (JJ, SJ) if writer == "jax" else (SJ, JJ)
    path = tmp_path / "requests.jsonl"
    X = _write_journal(W, path)
    recs_w, bad_w = W.RequestJournal(str(path)).replay()
    recs_r, bad_r = R.RequestJournal(str(path)).replay()
    assert recs_r == recs_w and bad_r == bad_w == [] and len(recs_r) == 5
    assert [r["sha256"] for r in recs_r] == [r["sha256"] for r in recs_w]
    got = R.decode_array(recs_r[0]["detail"]["X"])
    assert got.dtype == X.dtype and got.tobytes() == X.tobytes()
    # the reader appends, and the writer reads that back
    R.RequestJournal(str(path)).append("failed", "req00003", {"error": "x"})
    recs, bad = W.RequestJournal(str(path)).replay()
    assert bad == [] and recs[-1]["event"] == "failed" and recs[-1]["seq"] == 6
    # a corrupt middle record and a torn tail: skipped and noted alike
    offsets = [0]
    with open(path, "rb") as f:
        for line in f:
            offsets.append(offsets[-1] + len(line))
    flip_byte(str(path), offsets[2] + 40)
    with open(path, "ab") as f:
        f.write(b'{"schema": "graftserve.v1", "seq": 7, "ev')
    js, jb = JJ.RequestJournal(str(path)).replay()
    ss, sb = SJ.RequestJournal(str(path)).replay()
    assert ss == js and sb == jb
    assert [b["torn_tail"] for b in sb] == [False, True] and len(ss) == 5


def test_debug_checks_refused_by_name(tmp_path):
    """``debug_checks=True`` instruments the server (lint/racecheck.py,
    tests/test_torch_racecheck.py); a request with bf16 data, refused by an
    earlier slice with the NotImplementedError that named it, now runs to
    its end under the instrumented locks."""
    srv = _server(tmp_path / "r", debug_checks=True, workers=1).start()
    X = np.random.default_rng(0).normal(size=(32, 2)).astype(np.float32)
    rid = srv.submit(X, X[:, 0], options=dict(
        binary_operators=["+", "*"], populations=2, population_size=8,
        ncycles_per_iteration=2, tournament_selection_n=4, eval_dtype="bfloat16"),
        niterations=1)
    snap = srv.wait(rid, timeout=120)
    srv.stop()
    assert snap["state"] == "done", snap


# ---------------------------------------------------------------------------
# The server within the port
# ---------------------------------------------------------------------------


def test_submit_poll_cancel_deadline(tmp_path):
    X, y = _problem()
    srv = _server(tmp_path / "root", capacity=4, workers=1)
    # queued cancel (no worker running yet), then the rest
    rq = srv.submit(X, y, options=OPTS, niterations=2, seed=1)
    assert srv.poll(rq)["state"] == "queued" and srv.cancel(rq)
    assert srv.poll(rq)["state"] == "cancelled" and not srv.cancel(rq)
    with pytest.raises(KeyError):
        srv.poll("nope")
    srv.start()
    try:
        r1 = srv.submit(X, y, options=OPTS, niterations=2, seed=5)
        rd = srv.submit(X, y, options=OPTS, niterations=10_000, seed=6, deadline_s=0.5)
        rc = srv.submit(X, y, options=OPTS, niterations=10_000, seed=7)
        s1 = srv.wait(r1, timeout=120)
        sd = srv.wait(rd, timeout=120)
        while srv.poll(rc)["state"] == "queued":
            srv.wait(rc, timeout=0.05)
        assert srv.cancel(rc, reason="client_gave_up")
        sc = srv.wait(rc, timeout=120)
    finally:
        srv.stop(drain=True, timeout=60)
    assert s1["state"] == "done" and s1["result"]["iterations"] == 2
    assert s1["result"]["equations"] and len(s1["result"]["fingerprint"]) == 64
    assert sd["state"] == "cancelled" and sd["cancel_reason"] == "deadline"
    assert sc["state"] == "cancelled" and sc["cancel_reason"] == "client_gave_up"
    with pytest.raises(ServerSaturated):
        srv.submit(X, y, options=OPTS)
    # the serve stream validates under both schemas; the request ran its
    # search with the default diagnostics (ledger, telemetry)
    with open(tmp_path / "root" / "serve_telemetry.jsonl") as f:
        lines = f.readlines()
    assert SSchema.validate_lines(lines) == [] and JSchema.validate_lines(lines) == []
    kinds = [json.loads(l)["kind"] for l in lines]
    assert {"accept", "start", "done", "cancel", "cache_miss", "cache_hit"} <= set(kinds)
    run_dir = tmp_path / "root" / "requests" / r1 / r1
    assert {"ledger.jsonl", "telemetry.jsonl", "search_state.pkl"} <= set(os.listdir(run_dir))
    assert srv.cache.stats()["hits"] >= 1


def test_metrics_text_and_endpoint(tmp_path):
    """serve/metrics.py: metrics_text() renders the Prometheus text body
    (the JAX package's families) and a MetricsServer on an ephemeral
    localhost port serves it at /metrics and /healthz."""
    import urllib.request

    X, y = _problem()
    srv = _server(tmp_path / "root", capacity=4, workers=1, metrics_port=0,
                  pack=PackPolicy(coalesce_window_s=0.0))
    srv.start()
    try:
        rid = srv.submit(X, y, options=OPTS, niterations=1, seed=3)
        assert srv.wait(rid, timeout=120)["state"] == "done"
        base = f"http://127.0.0.1:{srv.metrics.port}"
        body = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
        ok = urllib.request.urlopen(base + "/healthz", timeout=10).read()
    finally:
        srv.stop(drain=True, timeout=60)
    assert ok == b"ok\n" and not srv.metrics.running
    for family in ("graftserve_queue_depth", "graftserve_cache_misses_total",
                   "graftserve_pack_launches_total", 'graftserve_requests{state="done"} 1',
                   "graftserve_request_device_seconds_total",
                   "graftserve_dispatch_latency_seconds_count"):
        assert family in body, family
    assert srv.metrics_text().count("# TYPE graftserve_queue_depth gauge") == 1


def _fingerprints(root, reqs, pack=None):
    srv = _server(root, capacity=8, workers=1, pack=pack)
    ids = [srv.submit(X, y, options=OPTS, niterations=2, seed=s) for X, y, s in reqs]
    srv.start()
    try:
        snaps = [srv.wait(r, timeout=180) for r in ids]
    finally:
        srv.stop(drain=True, timeout=60)
    assert all(s["state"] == "done" for s in snaps), snaps
    return [s["result"]["fingerprint"] for s in snaps], srv


def test_packed_tenants_bit_identical_to_solo(tmp_path):
    """Two requests of one bucket (200 and 230 rows, padded to 256) run as
    one cohort; each one's fingerprint equals its run alone on a fresh
    packed server."""
    (Xa, ya), (Xb, yb) = _problem(200, 1), _problem(230, 2)
    reqs = [(Xa, ya, 11), (Xb, yb, 12)]
    packed, srv = _fingerprints(tmp_path / "packed", reqs, pack=PackPolicy(coalesce_window_s=0.2))
    events = [json.loads(l) for l in open(tmp_path / "packed" / "serve_telemetry.jsonl")]
    launches = [e for e in events if e["kind"] == "pack_launch"]
    assert len(launches) == 1 and len(launches[0]["detail"]["tenants"]) == 2
    assert srv.poll(srv.requests()[0]["request_id"])["pad_rows"] == 56
    for i, r in enumerate(reqs):
        solo, _ = _fingerprints(tmp_path / f"solo{i}", [r], pack=PackPolicy())
        assert solo[0] == packed[i]


_CHILD = textwrap.dedent("""
    import os, signal, sys, threading, time
    import numpy as np
    sys.path.insert(0, {repo!r})
    from symbolicregression_jl_tpu_torch.bench.load import _storm_options
    from symbolicregression_jl_tpu_torch.serve import SearchServer
    root = sys.argv[1]
    rng = np.random.default_rng(0)
    X = rng.uniform(-2.0, 2.0, (200, 2)).astype(np.float32)
    y = (X[:, 0] * 2.0 + X[:, 1] * X[:, 1]).astype(np.float32)
    srv = SearchServer(root, capacity=8, workers=1, device="cpu")
    ids = [srv.submit(X, y, options=_storm_options(), niterations=4, seed=s) for s in (21, 22)]
    def kill_after_first_checkpoint():
        ck = os.path.join(root, "requests", ids[0], ids[0], "search_state.pkl")
        while not os.path.exists(ck):
            time.sleep(0.005)
        os.kill(os.getpid(), signal.SIGKILL)
    threading.Thread(target=kill_after_first_checkpoint, daemon=True).start()
    srv.start()
    time.sleep(120)
""")


def test_sigkilled_server_replays_to_unkilled_fingerprints(tmp_path):
    root = str(tmp_path / "killed")
    proc = subprocess.run([sys.executable, "-c", _CHILD.format(repo=REPO), root],
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == -9, proc.stderr[-2000:]
    srv = _server(root, capacity=8, workers=1).start()
    try:
        snaps = [srv.wait(r, timeout=180) for r in ("req00001", "req00002")]
    finally:
        srv.stop(drain=True, timeout=60)
    assert [s["state"] for s in snaps] == ["done", "done"] and snaps[0]["resumed"]
    X, y = _problem()
    want, _ = _fingerprints(tmp_path / "unkilled", [(X, y, 21), (X, y, 22)])
    # _fingerprints runs 2 iterations; the killed requests ran 4: compare
    # with an unkilled 4-iteration server
    srv2 = _server(tmp_path / "unkilled4", capacity=8, workers=1)
    ids = [srv2.submit(X, y, options=OPTS, niterations=4, seed=s) for s in (21, 22)]
    srv2.start()
    try:
        ref = [srv2.wait(r, timeout=180) for r in ids]
    finally:
        srv2.stop(drain=True, timeout=60)
    assert [s["result"]["fingerprint"] for s in snaps] == [
        s["result"]["fingerprint"] for s in ref]
    assert want[0] != ref[0]["result"]["fingerprint"]   # 2 and 4 iterations differ


def test_load_bench_storm_on_the_cpu(tmp_path):
    """bench/load.py ``run_load``: every submitted request ends, the four
    numbers are reported, repeats hit the engine cache."""
    rep = SLoad.run_load(str(tmp_path / "load"), requests=4, workers=2, capacity=2, rows=160,
                         niterations=1, log=lambda *a: None, device="cpu")
    assert rep["ok"] and rep["completed"] == 4 and rep["requests_per_sec"] > 0
    assert rep["poll_latency_s"]["p99"] is not None and rep["cache_hit_rate"] >= 0.5
    assert rep["shed_fraction"] is not None
