"""The port's host observability utilities, mirrored on the JAX package's
tests of them: the genealogy recorder (verbosity 1 and 2, with the
``.stream`` spill), the progress bar, the SRLogger sink, the resource
monitor's warning and re-arm, the stdin quit (an injected stream stops the
search with ``user_quit``), ``timeout_in_seconds=0`` stopping within the
first chunk of cycles, and ``pareto_volume``/``convex_hull`` against the
JAX package's on golden and random fronts. Everything runs on the CPU.
"""

import io
import json
import math
import os
import time

import numpy as np
import pytest

import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu.utils import logging as JL
from symbolicregression_jl_tpu_torch.core.options import MUTATION_KINDS
from symbolicregression_jl_tpu_torch.utils import logging as SL
from symbolicregression_jl_tpu_torch.utils.monitor import ResourceMonitor
from symbolicregression_jl_tpu_torch.utils.progress import ProgressBar
from symbolicregression_jl_tpu_torch.utils.stdin_quit import StdinQuitWatcher

import torch_parity  # noqa: F401  (caps torch's threads per xdist worker)


def _problem(n=64):
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    y = (X[:, 0] * 2.0 + X[:, 1]).astype(np.float32)
    return X, y


def _options(tmp_path, **kw):
    base = dict(binary_operators=["+", "*"], unary_operators=[], maxsize=8, populations=2,
                population_size=16, ncycles_per_iteration=8, tournament_selection_n=4,
                optimizer_probability=0.0, output_directory=str(tmp_path))
    base.update(kw)
    return S.Options(**base)


def _read_recorder(tmp_path, run_id):
    with open(os.path.join(str(tmp_path), run_id, "rec.json")) as f:
        return json.load(f)


def test_recorder_writes_genealogy_and_event_stream(tmp_path):
    """use_recorder=True: lineage arrays per island, the hall of fame with
    equation strings, and the per-mutation event stream whose parents
    chain onto earlier children (the JAX package's
    test_recorder_event_stream_reconstructs_lineage)."""
    X, y = _problem()
    S.equation_search(X, y, options=_options(tmp_path, use_recorder=True,
                                             recorder_file="rec.json",
                                             ncycles_per_iteration=30),
                      niterations=2, verbosity=0, run_id="rec", seed=3, device="cpu")
    rec = _read_recorder(tmp_path, "rec")
    assert rec["final_state"]["stop_reason"] == "niterations"
    assert len(rec["iterations"]) == 2
    first = rec["iterations"][0]
    assert len(first["islands"]) == 2 and len(first["islands"][0]["ref"]) == 16
    assert all(isinstance(e["equation"], str) for e in first["hall_of_fame"])
    block = first["events"][0]
    acc = block["accepted"]
    assert len(acc) > 10 and "rejected" not in block
    names = set(MUTATION_KINDS) | {"crossover"}
    chained = 0
    for isl in {e["island"] for e in acc}:
        seen = set()
        for e in sorted((e for e in acc if e["island"] == isl), key=lambda e: e["cycle"]):
            assert e["type"] in names and e["child"] >= 0 and e["died"] >= 0
            if e["type"] == "crossover":
                assert "parent2" in e
            chained += e["parent"] in seen
            seen.add(e["child"])
            is_initial = e["died"] >= 1_000_000 or e["died"] < 16
            assert is_initial or e["died"] < e["child"], e
    assert chained > 0
    assert isinstance(block["rejected_counts"], dict)


def test_recorder_verbosity2_rejection_events_and_spill(tmp_path):
    X, y = _problem()
    S.equation_search(X, y, options=_options(tmp_path, use_recorder=True,
                                             recorder_file="rec.json", recorder_verbosity=2,
                                             ncycles_per_iteration=30),
                      niterations=1, verbosity=0, run_id="rec2", seed=3, device="cpu")
    block = _read_recorder(tmp_path, "rec2")["iterations"][0]["events"][0]
    rej = block["rejected"]
    assert len(rej) > 0
    for e in rej:
        assert e["type"] in set(MUTATION_KINDS) | {"crossover"}
        assert e["reason"] in {"constraint", "invalid", "annealing", "none"}
    assert sum(block["rejected_counts"].values()) == len(rej)
    assert not os.path.exists(os.path.join(str(tmp_path), "rec2", "rec.json.stream"))


def test_progress_bar_logger_and_regressor_progress(tmp_path):
    """progress=True draws a bar, a logger gets every log_every_n-th
    iteration with host_fraction, and SRRegressor(progress=True) fits."""
    X, y = _problem()
    logger = SL.SRLogger()
    S.equation_search(X, y, options=_options(tmp_path, save_to_file=False), device="cpu",
                      runtime_options=S.RuntimeOptions(niterations=4, progress=True, seed=0,
                                                       verbosity=0, logger=logger,
                                                       log_every_n=2))
    assert [r["iteration"] for r in logger.records] == [2, 4]
    assert all(0.0 <= r["host_fraction"] <= 1.0 for r in logger.records)
    out = logger.records[-1]["outputs"][0]
    assert out["pareto_volume"] >= 0.0 and len(out["complexity_histogram"]) == 8
    stream = io.StringIO()
    bar = ProgressBar(3, stream=stream)
    bar.update(2, best_loss=0.5, evals_per_sec=10.0, host_fraction=0.25)
    assert "2/3" in stream.getvalue() and "host 25%" in stream.getvalue()
    model = S.SRRegressor(niterations=1, seed=0, device="cpu", binary_operators=["+", "*"],
                          populations=2, population_size=8, ncycles_per_iteration=2,
                          tournament_selection_n=4, should_optimize_constants=False,
                          save_to_file=False, progress=True).fit(X, y)
    assert np.isfinite(model.get_best().loss)


def test_resource_monitor_warns_and_rearms(capsys):
    m = ResourceMonitor(window=2, warn_fraction=0.2)
    m.record(1.0, 1.0)
    m.record(1.0, 1.0)
    assert abs(m.estimate_work_fraction() - 0.5) < 1e-9
    assert m.check_and_warn(verbosity=1)
    assert not m.check_and_warn(verbosity=1)      # latched while high
    assert "host bookkeeping" in capsys.readouterr().out
    m.record(1.0, 0.01)
    m.record(1.0, 0.01)
    assert not m.check_and_warn(verbosity=1)      # recovered: re-arms
    assert "recovered" in capsys.readouterr().out
    m.record(1.0, 1.0)
    m.record(1.0, 1.0)
    assert m.check_and_warn(verbosity=1)          # a later excursion warns again


def test_stdin_watcher_and_user_quit(tmp_path):
    w = StdinQuitWatcher(io.StringIO("q"), force=True)
    deadline = time.time() + 5
    while not w.check() and time.time() < deadline:
        time.sleep(0.01)
    assert w.check()
    assert not StdinQuitWatcher().active           # pytest's stdin is no TTY
    assert not StdinQuitWatcher.disabled().check()
    X, y = _problem()
    state, hof = S.equation_search(
        X, y, options=_options(tmp_path, telemetry=True), device="cpu", return_state=True,
        runtime_options=S.RuntimeOptions(niterations=200, verbosity=0, seed=0, run_id="quit",
                                         input_stream=io.StringIO("q")))
    with open(os.path.join(str(tmp_path), "quit", "telemetry.jsonl")) as f:
        end = [json.loads(l) for l in f][-1]
    assert end["event"] == "run_end" and end["stop_reason"] == "user_quit"
    assert state.iterations_done < 200 and len(hof.entries) > 0


def test_timeout_zero_stops_within_the_first_chunk(tmp_path):
    """timeout_in_seconds=0: the poll after the first chunk of cycles stops
    the search; the epilogue still runs once (its finalize launch is
    counted), and the iteration ran 16 of its 64 cycles (4 chunks in the
    first iteration)."""
    X, y = _problem()
    state, _ = S.equation_search(
        X, y, options=_options(tmp_path, timeout_in_seconds=0.0, ncycles_per_iteration=64,
                               telemetry=True),
        device="cpu", return_state=True,
        runtime_options=S.RuntimeOptions(niterations=1000, verbosity=0, seed=0, run_id="t0"))
    assert state.iterations_done == 1
    with open(os.path.join(str(tmp_path), "t0", "telemetry.jsonl")) as f:
        events = [json.loads(l) for l in f]
    assert events[-1]["stop_reason"] == "timeout"
    c = events[1]["outputs"][0]["counters"]
    assert c["eval_launches"] == 2 * 16 + 1
    assert sum(c["proposed"].values()) == 2 * 4 * 16


def test_chunk_sizes_match_the_jax_rule():
    from symbolicregression_jl_tpu_torch.api.search import _chunk_sizes

    assert _chunk_sizes(100, 4) == [25] * 4
    assert _chunk_sizes(8, 4) == [2] * 4
    assert _chunk_sizes(13, 4) == [4, 3, 3, 3]
    assert _chunk_sizes(30, 1) == [30]
    for nc in range(1, 80):
        for n in (1, 2, 4, 8, 16):
            sizes = _chunk_sizes(nc, n)
            assert sum(sizes) == nc and len(sizes) <= 2 * n


# ---------------------------------------------------------------------------
# pareto_volume and convex_hull (the quality check's pareto volume)
# ---------------------------------------------------------------------------


def test_pareto_volume_golden_values():
    assert SL.pareto_volume([1.0, 0.1], [1, 3], maxsize=7) == pytest.approx(
        math.log10(8.0) / 2.0, rel=1e-9)
    assert SL.pareto_volume([], [], maxsize=10) == 0.0
    assert SL.pareto_volume([0.0, -1.0], [1, 2], maxsize=10) == 0.0
    assert SL.pareto_volume([np.inf, np.nan], [1, 2], maxsize=10) == 0.0
    assert SL.pareto_volume([1.0], [1], maxsize=7) == pytest.approx(
        math.log10(8.0) / 2.0, rel=1e-9)
    assert SL.pareto_volume([1.0, 0.5], [2, 2], maxsize=7) == pytest.approx(
        (math.log10(8.0) - math.log10(2.0)) * math.log10(2.0) / 2.0, rel=1e-9)
    assert SL.pareto_volume([1.0, 0.1, 0.1], [1, 3, 3], maxsize=7) == pytest.approx(
        SL.pareto_volume([1.0, 0.1], [1, 3], maxsize=7), rel=1e-9)
    vol = SL.pareto_volume([1.0, 0.0], [1, 3], maxsize=7, use_linear_scaling=True)
    assert np.isfinite(vol) and vol > 0.0
    square = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0], [0.5, 0.5], [0.0, 0.0]])
    assert {tuple(p) for p in SL.convex_hull(square)} == {(0.0, 0.0), (1.0, 0.0), (1.0, 1.0),
                                                          (0.0, 1.0)}


@pytest.mark.parametrize("seed", range(4))
def test_pareto_volume_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    losses = list(10.0 ** rng.uniform(-6, 2, n))
    cx = list(rng.integers(1, 20, n))
    if seed == 3:
        losses[0] = np.inf
    for linear in (False, True):
        a = SL.pareto_volume(losses, cx, 20, use_linear_scaling=linear)
        b = JL.pareto_volume(losses, cx, 20, use_linear_scaling=linear)
        assert a == b
