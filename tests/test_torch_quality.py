"""The mini matrix's quality check on the port, on the CPU.

The port's ``bench/cell.py`` runs the JAX package's cells (same data from
seed 1234, same Options) and reads their metrics from the port's
telemetry JSONL; its ``bench/gate.py`` holds them against
``benchmarks/baseline.json`` under the library-drift rule: band
excursions are soft findings, the backstops (best_loss above 10x the
baseline's, pareto_volume below 0.1x) fail. The card runs all twelve
non-sharded cells (``chip_smoke.py`` phase 24); here plain/seed0 and
template/seed0.
"""

import copy
import os

import pytest

from symbolicregression_jl_tpu.bench import cell as JCell
from symbolicregression_jl_tpu.bench import gate as JGate
from symbolicregression_jl_tpu.bench.matrix import RESULT_SCHEMA as J_RESULT_SCHEMA
from symbolicregression_jl_tpu_torch.bench import cell as C
from symbolicregression_jl_tpu_torch.bench import gate as G

import torch_parity  # noqa: F401  (caps torch's threads per xdist worker)

BASELINE = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "baseline.json")


def test_cells_and_gate_constants_are_the_jax_packages():
    assert C.MINI == JCell.MINI and C.FULL == JCell.FULL and C.VARIANTS == JCell.VARIANTS
    for v in C.VARIANTS:
        for a, b in zip(C._problem(C.MINI, v), JCell._problem(JCell.MINI, v)):
            if isinstance(a, dict):
                assert (a["class"] == b["class"]).all()
            elif a is not None:
                assert (a == b).all()
    assert G.RESULT_SCHEMA == J_RESULT_SCHEMA and G.BASELINE_SCHEMA == JGate.BASELINE_SCHEMA
    assert G.GATED_METRICS == {k: G.Band(**vars(b)) for k, b in JGate.GATED_METRICS.items()}
    assert (G.COLLAPSE_FLOOR_FRACTION, G.BLOWUP_CEILING_FACTOR) == (
        JGate.COLLAPSE_FLOOR_FRACTION, JGate.BLOWUP_CEILING_FACTOR)


@pytest.mark.parametrize("cell_id", ["plain/seed0", "template/seed0"])
def test_mini_cell_passes_the_quality_rule(tmp_path, cell_id):
    variant, seed = cell_id.split("/seed")
    rec = C.run_cell({"variant": variant, "seed": int(seed), "shape": C.MINI,
                      "cell_id": cell_id, "out_dir": str(tmp_path)}, device="cpu")
    assert rec["backend"] == "cpu" and rec["metrics"]["iterations"] == C.MINI["niterations"]
    baseline = G.load_baseline(BASELINE)
    result = G.make_result([rec], matrix="mini", platform="cpu")
    findings = G.diff_result(result, baseline, cells_filter=[cell_id])
    assert findings[0].metric == "provenance" and "jax" in findings[0].note
    gated = [f for f in findings if f.cell == cell_id]
    assert {f.metric for f in gated} == {"best_loss", "pareto_volume"}
    assert not G.gate_failed(findings), G.format_findings(findings)


def test_gate_rule_soft_bands_and_hard_backstops():
    baseline = G.load_baseline(BASELINE)
    base = baseline["cells"]["plain/seed0"]["metrics"]

    def findings(best, pv):
        m = dict(base, best_loss=best, pareto_volume=pv)
        rec = {"cell_id": "plain/seed0", "variant": "plain", "seed": 0, "metrics": m}
        return G.diff_result(G.make_result([rec], matrix="mini", platform="gpu"), baseline,
                             cells_filter=["plain/seed0"])

    ok = findings(base["best_loss"], base["pareto_volume"])
    assert not G.gate_failed(ok) and {f.status for f in ok if f.cell != "*"} == {"ok"}
    soft = findings(base["best_loss"] * 2, base["pareto_volume"] * 0.5)
    assert not G.gate_failed(soft)
    assert [f.status for f in soft if f.cell != "*"] == ["soft", "soft"]
    assert G.gate_failed(findings(base["best_loss"] * 11, base["pareto_volume"]))
    assert G.gate_failed(findings(base["best_loss"], base["pareto_volume"] * 0.09))
    assert G.gate_failed(findings(float("nan"), base["pareto_volume"]))
    # without library drift, a band excursion fails, as in the JAX package
    same = copy.deepcopy(baseline)
    same["provenance"] = G.library_provenance()
    m = dict(base, best_loss=base["best_loss"] * 2)
    res = G.make_result([{"cell_id": "plain/seed0", "variant": "plain", "seed": 0,
                          "metrics": m}], matrix="mini", platform="gpu")
    assert G.gate_failed(G.diff_result(res, same, cells_filter=["plain/seed0"]))
    missing = G.diff_result(G.make_result([], matrix="mini", platform="gpu"), baseline,
                            cells_filter=["plain/seed0"])
    assert G.gate_failed(missing) and missing[-1].status == "missing_cell"


def test_sharded_cells_name_their_slice(tmp_path):
    """The island-sharded cells run on MINI's 2 spawned gloo ranks (the
    legacy and the mesh runtime) and report their devices and metrics."""
    for v in C.SHARDED_VARIANTS:
        rec = C.run_cell({"variant": v, "seed": 0, "shape": C.MINI, "cell_id": f"{v}/seed0",
                          "out_dir": str(tmp_path)}, device="cpu")
        assert rec["variant"] == v and rec["n_devices"] == C.MINI["shards"] == 2
        assert rec["metrics"]["best_loss"] < 10.0 and rec["backend"] == "cpu"
