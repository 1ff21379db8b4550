"""The port's bench CLI (``python -m symbolicregression_jl_tpu_torch.bench``):
``run`` through the matrix runner (each cell a subprocess, here on the
CPU), ``gate`` on its result against ``benchmarks/baseline.json``,
``trend`` over files the test writes, and the result schema against the
JAX package's (its ``bench/matrix.py`` result keys, and its own gate
reading the port's result)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from symbolicregression_jl_tpu.bench import gate as JG
from symbolicregression_jl_tpu_torch.bench import __main__ as SB
from symbolicregression_jl_tpu_torch.bench import gate as SG
from symbolicregression_jl_tpu_torch.bench import matrix as SMX
from symbolicregression_jl_tpu_torch.bench import trend as ST

import torch_parity  # noqa: F401  (caps torch's threads per xdist worker)

ROOT = Path(__file__).resolve().parent.parent
BASELINE = str(ROOT / "benchmarks" / "baseline.json")
CELLS = ["plain", "template"]


def _cli(*args, cwd=ROOT):
    env = dict(os.environ, SYMBOLIC_REGRESSION_IS_TESTING="true")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    return subprocess.run([sys.executable, "-m", "symbolicregression_jl_tpu_torch.bench", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench")
    out = d / "result.json"
    proc = _cli("run", "--variants", *CELLS, "--seeds", "0", "--device", "cpu",
                "--workdir", str(d / "work"), "--out", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    return d, json.loads(out.read_text())


def _jax_result_keys():
    """The keys of the dict the JAX package's run_matrix returns."""
    src = (ROOT / "symbolicregression_jl_tpu" / "bench" / "matrix.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "run_matrix")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)][-1]
    return {k.value for k in ret.value.keys}


def test_run_writes_the_jax_result_schema(result):
    _, res = result
    assert res["schema"] == JG.RESULT_SCHEMA == SG.RESULT_SCHEMA == "graftbench.result.v1"
    assert set(res) == _jax_result_keys()
    assert res["matrix"] == "mini" and res["platform"] == "cpu" and not res["failures"]
    assert sorted(res["cells"]) == ["plain/seed0", "template/seed0"]
    for rec in res["cells"].values():
        assert {"cell_id", "variant", "seed", "n_devices", "backend", "wall_s", "telemetry",
                "metrics"} <= set(rec)
        assert rec["backend"] == "cpu" and rec["subprocess_wall_s"] > 0
        assert rec["metrics"]["best_loss"] is not None
        assert rec["launches"] == {}   # kernels launch only on CUDA tensors
    prov = res["provenance"]
    assert {"torch", "numpy", "cuda", "driver", "device"} <= set(prov)
    # the JAX package's gate reads the port's result without a schema finding
    fnd = JG.diff_result(res, JG.load_baseline(BASELINE),
                         cells_filter=["plain/seed0", "template/seed0"])
    assert not [f for f in fnd if f.status == "schema"]


def test_gate_on_the_result_and_its_exit_codes(result):
    d, _ = result
    gated = d / "gated.json"
    proc = _cli("gate", "--result", str(d / "result.json"), "--variants", *CELLS,
                "--seeds", "0", "--baseline", BASELINE, "--out", str(gated))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PARTIAL" in proc.stdout and "PASS" in proc.stdout
    payload = json.loads(gated.read_text())
    assert payload["gate"]["failed"] is False
    cells = {f["cell"] for f in payload["gate"]["findings"]}
    assert {"plain/seed0", "template/seed0"} <= cells
    # a result missing a requested cell fails the gate
    res = json.loads((d / "result.json").read_text())
    del res["cells"]["template/seed0"]
    (d / "short.json").write_text(json.dumps(res))
    proc = _cli("gate", "--result", str(d / "short.json"), "--variants", *CELLS,
                "--seeds", "0", "--baseline", BASELINE)
    assert proc.returncode == 1 and "FAIL" in proc.stdout
    assert _cli("gate", "--baseline", str(d / "nope.json"), "--result",
                str(d / "result.json")).returncode == 2


def test_sharded_variants_refused_by_name():
    """The island-sharded variants are in the port's matrix now; what it
    refuses by name is a variant it does not know."""
    assert SMX.matrix_cells(["sharded", "sharded-mesh"], [0]) == [
        ("sharded/seed0", "sharded", 0), ("sharded-mesh/seed0", "sharded-mesh", 0)]
    assert "sharded" in SMX.PORT_VARIANTS and "plain" in SMX.PORT_VARIANTS
    with pytest.raises(ValueError, match="unknown variants \\['meshy'\\]"):
        SMX.matrix_cells(["meshy"], [0])


def test_trend_folds_only_what_it_is_given(tmp_path, capsys):
    """trend reads the named files and the *.json of named directories: a
    green headline pair (flat), a gate result, a red artifact and an
    unreadable file; the repo's TPU BENCH/MULTICHIP files never enter a
    trend they were not named in."""
    hist = tmp_path / "hist"
    hist.mkdir()
    line = {"metric": "full_dataset_expr_evals_per_sec_10k_rows", "unit": "evals/s",
            "n_devices": 1}
    (hist / "head_r01.json").write_text(json.dumps(dict(line, value=100000.0)))
    (hist / "head_r02.json").write_text(json.dumps(
        {"rc": 0, "tail": "noise\n" + json.dumps(dict(line, value=102000.0))}))
    (hist / "head_r03.json").write_text(json.dumps({"rc": 124, "tail": ""}))
    res = {"schema": SG.RESULT_SCHEMA, "matrix": "mini", "platform": "cpu",
           "cells": {"plain/seed0": {"metrics": {"evals_per_sec": 500.0, "anomalies": 0,
                                                 "peak_live_bytes": 1024}}},
           "failures": {}, "gate": {"failed": False, "findings": []}}
    (tmp_path / "gate.json").write_text(json.dumps(res))
    (tmp_path / "bad.json").write_text("{not json")
    tr = ST.build_trend([str(hist), str(tmp_path / "gate.json"), str(tmp_path / "bad.json")])
    assert [r["file"] for r in tr["bench"]] == ["head_r01.json", "head_r02.json",
                                                "head_r03.json"]
    assert [r["red"] for r in tr["bench"]] == [False, False, True]
    assert tr["bench"][1]["evals_per_sec"] == 102000.0
    assert tr["flat_note"] and "+2.0%" in tr["flat_note"]
    assert [g["red"] for g in tr["gates"]] == [False, True]
    assert tr["red_count"] == 2
    text = ST.format_trend(tr)
    assert "RED rc=124" in text and "2 red artifact(s)" in text
    assert all(not f.startswith(("BENCH_r", "MULTICHIP_r"))
               for f in [r["file"] for r in tr["bench"] + tr["gates"]])
    assert SB.main(["trend", str(tmp_path / "gate.json")]) == 0
    assert SB.main(["trend", "--strict", str(hist)]) == 1
    assert SB.main(["trend", "--json", str(tmp_path / "gate.json")]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["red_count"] == 0
