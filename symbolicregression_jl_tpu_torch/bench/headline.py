"""Headline benchmark: full-dataset expression evaluations per second.

    python -m symbolicregression_jl_tpu_torch.bench.headline [--staged] [--bf16]
        [--sample-fraction F] [--rescore-fraction F]

Port of ``symbolicregression_jl_tpu/bench/headline.py``: the reference's
primary live metric, "full dataset evaluations per second"
(Δnum_evals / Δt), on the reference benchmark problem (5 features,
``+ - * /`` and ``exp abs cos``, maxsize 30, target
cos(2.13 x1) + 0.5 x2 |x3|^0.9 - 0.3 |x4|^1.5 + noise) at 10,000 rows
from seed 0, 512 islands x 256 members, tournament 16, 100 cycles an
iteration, the constant optimizer on (the default). One warm-up
iteration, then three measured ones through ``Engine.run_iteration``;
``torch.cuda.synchronize()`` closes the timed window.

Prints ONE JSON line: ``metric``, ``value`` (evaluations per second,
the constant optimizer's f_calls included, as the JAX package counts
them), ``unit``, ``vs_baseline`` (against the JAX module's measured
8-core CPU rate, a CPU figure), the candidate-evaluation path's
provenance (``fuse_cost_epilogue``, ``eval_precision``, ``staged_eval``,
``staged_sample_rows``, ``rescore_fraction``, ``telemetry``),
``n_devices`` (1), and the card's name and power limit as ``nvidia-smi``
reports them. The JAX module's TPU projection fields have no counterpart
here.

``main(device="cpu")`` runs the same code on the CPU; the tests do so
with the module's configuration constants set smaller. The headline
number is the defaults on one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Optional, Sequence

import numpy as np

MEASURED_CPU_EVALS_PER_SEC = 6.5e4   # the JAX module's 8-core CPU extrapolation
LEGACY_CPU_EVALS_PER_SEC = 1.0e4     # its round-1 estimate (1-2 cores)

N_ROWS = 10_000
N_FEATURES = 5
POPULATIONS = 512
POPULATION_SIZE = 256
TOURNAMENT = 16
NCYCLES = 100
WARMUP_ITERS = 1
MEASURE_ITERS = 3


def bench_problem(n_rows: int = N_ROWS):
    """The benchmark data: ``n_rows`` x 5 features from seed 0."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-3.0, 3.0, (n_rows, N_FEATURES)).astype(np.float32)
    y = (
        np.cos(2.13 * X[:, 0])
        + 0.5 * X[:, 1] * np.abs(X[:, 2]) ** 0.9
        - 0.3 * np.abs(X[:, 3]) ** 1.5
        + 1e-1 * rng.standard_normal(n_rows)
    ).astype(np.float32)
    return X, y


def card() -> Optional[str]:
    """The card's name and power limit (``nvidia-smi``), or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def main(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    import torch

    from ..core.dataset import make_dataset
    from ..core.options import Options
    from ..device import resolve_device
    from ..evolve import rng
    from ..evolve.engine import Engine
    from ..evolve.step import resolve_sample_rows
    from ..telemetry.schema import SCHEMA_VERSION

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--staged", action="store_true",
                    help="staged sample-then-rescore candidate eval")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 value buffer for candidate evals (float32 loss)")
    ap.add_argument("--sample-fraction", type=float, default=0.125,
                    help="screening sample fraction (staged mode)")
    ap.add_argument("--rescore-fraction", type=float, default=0.25,
                    help="full-eval rescore fraction (staged mode)")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    X, y = bench_problem(N_ROWS)
    options = Options(
        binary_operators=["+", "-", "*", "/"],
        unary_operators=["exp", "abs", "cos"],
        maxsize=30,
        populations=POPULATIONS,
        population_size=POPULATION_SIZE,
        tournament_selection_n=TOURNAMENT,
        ncycles_per_iteration=NCYCLES,
        save_to_file=False,
        eval_precision="bf16" if args.bf16 else "f32",
        staged_eval=args.staged,
        staged_sample_fraction=args.sample_fraction,
        rescore_fraction=args.rescore_fraction,
    )
    ds = make_dataset(X, y, device=dev)
    ds.update_baseline_loss(options.elementwise_loss)
    engine = Engine(options, ds.nfeatures, device=dev)
    data = ds.data
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    state = engine.init_state(rng.key(0, device=dev), data, options.populations)
    for _ in range(WARMUP_ITERS):
        state = engine.run_iteration(state, data, options.maxsize)
    sync()
    evals_before = float(state.num_evals)
    t0 = time.perf_counter()
    for _ in range(MEASURE_ITERS):
        state = engine.run_iteration(state, data, options.maxsize)
    sync()
    elapsed = time.perf_counter() - t0

    evals = float(state.num_evals) - evals_before
    rate = evals / elapsed
    rec = {
        "metric": "full_dataset_expr_evals_per_sec_10k_rows",
        "value": rate,
        "unit": "evals/s",
        "vs_baseline": round(rate / MEASURED_CPU_EVALS_PER_SEC, 3),
        "vs_baseline_legacy_1e4": round(rate / LEGACY_CPU_EVALS_PER_SEC, 3),
        "n_devices": 1,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": card() if dev.type == "cuda" else None,
        "seconds_per_iteration": elapsed / MEASURE_ITERS,
        "populations": options.populations,
        "population_size": options.population_size,
        "ncycles_per_iteration": options.ncycles_per_iteration,
        "rows": N_ROWS,
        "fuse_cost_epilogue": bool(engine.cfg.fuse_cost),
        "turbo": bool(engine.cfg.turbo),
        "eval_precision": "bf16" if engine.cfg.eval_bf16 else "f32",
        "staged_eval": bool(engine.cfg.staged_eval),
        "staged_sample_rows": (resolve_sample_rows(engine.cfg, N_ROWS)
                               if engine.cfg.staged_eval else None),
        "rescore_fraction": engine.cfg.rescore_fraction if engine.cfg.staged_eval else None,
        "telemetry": {"schema": SCHEMA_VERSION,
                      "counters_enabled": bool(engine.cfg.collect_telemetry)},
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
