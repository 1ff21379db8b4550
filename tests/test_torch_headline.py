"""The port's headline bench (``bench/headline.py``) on a 4-island CPU
configuration (the module's configuration constants set smaller): it
parses its flags and prints one JSON line with the metric's name and the
provenance fields of the JAX package's line. The headline number itself
is the defaults on the card (chip_smoke.py phase 28); a CPU run gives no
device number."""

import json

import pytest

from symbolicregression_jl_tpu_torch.bench import headline

SMALL = dict(POPULATIONS=4, POPULATION_SIZE=32, TOURNAMENT=8, NCYCLES=2, N_ROWS=200)


@pytest.mark.parametrize("flags", [[], ["--staged", "--bf16", "--sample-fraction", "0.25",
                                        "--rescore-fraction", "0.5"]], ids=["f32", "staged-bf16"])
def test_headline_prints_one_json_line(flags, capsys, monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(headline, name, value)
    rec = headline.main(flags, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out == json.loads(json.dumps(rec))
    assert out["metric"] == "full_dataset_expr_evals_per_sec_10k_rows"
    assert out["unit"] == "evals/s" and out["value"] > 0 and out["n_devices"] == 1
    assert out["device"] == "cpu" and out["card"] is None
    assert out["populations"] == 4 and out["rows"] == 200
    for key in ("fuse_cost_epilogue", "eval_precision", "staged_eval", "staged_sample_rows",
                "rescore_fraction", "telemetry", "vs_baseline"):
        assert key in out
    if flags:
        assert out["staged_eval"] and out["eval_precision"] == "bf16"
        assert out["rescore_fraction"] == 0.5 and out["staged_sample_rows"] == 64
    else:
        assert not out["staged_eval"] and out["eval_precision"] == "f32"
        assert out["staged_sample_rows"] is None


def test_headline_defaults_are_the_optimizer_cell():
    """The module's configuration is the JAX module's: 512 x 256,
    tournament 16, 100 cycles, 10,000 rows x 5 features from seed 0, one
    warm-up and three measured iterations."""
    assert (headline.POPULATIONS, headline.POPULATION_SIZE, headline.TOURNAMENT,
            headline.NCYCLES) == (512, 256, 16, 100)
    assert headline.N_ROWS == 10_000 and headline.N_FEATURES == 5
    assert headline.WARMUP_ITERS == 1 and headline.MEASURE_ITERS == 3
    X, y = headline.bench_problem()
    assert X.shape == (10_000, 5) and y.shape == (10_000,)
