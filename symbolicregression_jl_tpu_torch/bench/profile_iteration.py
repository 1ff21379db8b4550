"""Where one engine iteration spends its time on the GPU.

    python -m symbolicregression_jl_tpu_torch.bench.profile_iteration [--ncycles N]

Builds the benchmark configuration (512 islands x 256 members, 10,000 rows
x 5 features, maxsize 30, no constant optimizer), runs one warm-up
iteration, then one iteration under ``torch.profiler``. Prints the
iteration's host-clock time, the summed device time of all kernels and
of the interpreter kernel, the device's busy and idle shares, the number
of kernel launches, and the ten kernels with the most device time.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch.evolve import rng
from symbolicregression_jl_tpu_torch.evolve.engine import Engine


def bench_data(n_rows: int = 10_000, n_features: int = 5):
    """The benchmark problem from seed 0 (bench/headline.py's data)."""
    g = np.random.default_rng(0)
    X = g.uniform(-3.0, 3.0, (n_rows, n_features)).astype(np.float32)
    y = (np.cos(2.13 * X[:, 0]) + 0.5 * X[:, 1] * np.abs(X[:, 2]) ** 0.9
         - 0.3 * np.abs(X[:, 3]) ** 1.5 + 1e-1 * g.standard_normal(n_rows)).astype(np.float32)
    return X, y


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ncycles", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_iteration: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    options = sr.Options(
        binary_operators=["+", "-", "*", "/"], unary_operators=["exp", "abs", "cos"],
        maxsize=30, populations=512, population_size=256, tournament_selection_n=16,
        ncycles_per_iteration=args.ncycles, should_optimize_constants=False,
        save_to_file=False)
    X, y = bench_data()
    ds = sr.make_dataset(X, y, device=dev)
    ds.update_baseline_loss(options.elementwise_loss)
    engine = Engine(options, X.shape[1], device=dev)
    state = engine.init_state(rng.key(0, device=dev), ds.data, options.populations)
    state = engine.run_iteration(state, ds.data, options.maxsize)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state = engine.run_iteration(state, ds.data, options.maxsize)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in events if e.device_time_total > 0]
    device_us = sum(e.device_time_total for e in kernels)
    interp_us = sum(e.device_time_total for e in kernels if "program_eval" in e.name)
    print(f"ncycles_per_iteration {args.ncycles}: iteration {wall:.3f} s (host clock)")
    print(f"device kernel time {device_us / 1e6:.3f} s over {len(kernels)} kernel launches; "
          f"busy {device_us / 1e6 / wall:.1%}, idle {1 - device_us / 1e6 / wall:.1%}")
    print(f"interpreter kernel {interp_us / 1e6:.4f} s "
          f"({interp_us / max(device_us, 1):.1%} of device time)")
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time_total, c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {t / 1e3:10.2f} ms  {c:7d}x  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
