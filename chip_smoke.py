#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--ncycles N]

Phases (any failure exits nonzero and prints no result line):

1. Require CUDA (no CPU fallback); print the card's name and power limit.
2. Build the interpreter kernel (csrc/program_eval.cu) from the checkout.
3. Hold the kernel against its plain PyTorch version at the benchmark
   shapes: 16,384 random trees (maxsize 30, + - * / exp abs cos), 5
   features, 10,000 rows. Validity bit-equal; loss and cost within rtol
   1e-5 (the row sums run in another order); inf in the same places; the
   cost form equal to the plain form + loss_to_cost bit for bit;
   dedup=True equal to dedup=False bit for bit; two launches identical.
   Times the kernel (CUDA events) and the plain version.
4. Main path: `Engine` at 512 islands x 256 members x 10,000 rows x 5
   features, tournament 16, maxsize 30, no constant optimizer:
   init_state, one warm-up iteration, two timed iterations. Prints
   evals/s, seconds per iteration, kernel launches, peak memory.
5. `equation_search(..., niterations=3, device="cuda")` on the same data.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

N_ROWS = 10_000
N_FEATURES = 5
RTOL = 1e-5
H100_FP32_FLOPS = 67e12     # non-tensor-core FP32 peak, H100 SXM data sheet
H100_HBM_BYTES_S = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet


def bench_data():
    """The benchmark problem: 10,000 rows x 5 features from seed 0."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-3.0, 3.0, (N_ROWS, N_FEATURES)).astype(np.float32)
    y = (np.cos(2.13 * X[:, 0]) + 0.5 * X[:, 1] * np.abs(X[:, 2]) ** 0.9
         - 0.3 * np.abs(X[:, 3]) ** 1.5
         + 1e-1 * rng.standard_normal(N_ROWS)).astype(np.float32)
    return X, y


def bench_options(sr, ncycles: int, populations: int = 512):
    return sr.Options(
        binary_operators=["+", "-", "*", "/"], unary_operators=["exp", "abs", "cos"],
        maxsize=30, populations=populations, population_size=256,
        tournament_selection_n=16, ncycles_per_iteration=ncycles,
        should_optimize_constants=False, save_to_file=False)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(torch, sr, dev):
    """Phase 3: the kernel against its plain version at the bench shapes."""
    from symbolicregression_jl_tpu_torch.core.losses import loss_to_cost
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.population import init_population
    from symbolicregression_jl_tpu_torch.evolve.step import evolve_config_from_options
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.ops.complexity import (build_complexity_tables,
                                                                compute_complexity_batch)
    from symbolicregression_jl_tpu_torch.ops.program import compile_program

    options = bench_options(sr, 1)
    X, y = bench_data()
    ds = sr.make_dataset(X, y, device=dev)
    ds.update_baseline_loss(options.elementwise_loss)
    data = ds.data
    cfg = evolve_config_from_options(options, N_FEATURES, dev)
    trees = init_population(rng.split(rng.key(1, device=dev), 64), 256, cfg.mctx).reshape(-1)
    T = trees.length.shape[0]
    tables = build_complexity_tables(options, N_FEATURES, dev)
    cx = compute_complexity_batch(trees, tables)
    ops, el = options.operators, options.elementwise_loss

    prog = compile_program(trees, N_FEATURES, len(ops.binary))
    args = FE._launch_inputs(prog, data.Xt, data.y, data.weights, N_FEATURES, ops)
    denom = FE._denominator(data.weights, data.Xt)
    norm = FE.baseline_normalization(data.baseline_loss, data.use_baseline)
    scal = torch.stack([denom, norm, torch.tensor(options.parsimony, dtype=torch.float32,
                                                  device=dev)]).contiguous()
    cxf = cx.to(torch.float32).contiguous()

    kernel = FE.PROGRAM_EVAL
    loss_k, valid_k = kernel(*args, ops, el)
    loss_k2, valid_k2 = kernel(*args, ops, el)
    lossc_k, validc_k, cost_k = kernel(*args, ops, el, cx=cxf, scal=scal)
    torch.cuda.synchronize()
    loss_p, valid_p = FE.program_eval_plain(*args, ops, el)
    lossc_p, validc_p, cost_p = FE.program_eval_plain(*args, ops, el, cx=cxf, scal=scal)
    torch.cuda.synchronize()

    failures = []

    def same(a, b):
        """Bit-for-bit equality (NaN payloads included)."""
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return bool(torch.equal(a, b))

    def check(name, ok):
        print(f"  check {name}: {'ok' if ok else 'FAILED'}")
        if not ok:
            failures.append(name)

    def close(a, b):
        """Within rtol where finite, inf exactly where the other has inf."""
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        same_inf = bool(torch.equal(fa, fb)) and bool(torch.equal(a[~fa], b[~fb]))
        err = (a[fa] - b[fb]).abs()
        within = bool((err <= RTOL * b[fb].abs()).all()) if same_inf else False
        rel = float((err / b[fb].abs().clamp(min=1e-30)).max()) if same_inf and err.numel() else 0.0
        return same_inf, within, rel, float(err.max()) if same_inf and err.numel() else 0.0

    check("two launches bit-identical", same(loss_k, loss_k2) and same(valid_k, valid_k2))
    check("validity bit-equal (plain form)", same(valid_k, valid_p))
    check("validity bit-equal (cost form)", same(validc_k, validc_p))
    # The plain form's loss sum is only meaningful for valid trees.
    same_inf, within, rel_sum, _ = close(torch.where(valid_p, loss_k, torch.inf),
                                         torch.where(valid_p, loss_p, torch.inf))
    check(f"loss sum within rtol {RTOL} (max rel err {rel_sum:.3g})", within)
    same_inf, within, rel_loss, abs_loss = close(lossc_k, lossc_p)
    check("inf where the plain version has inf (loss)", same_inf)
    check(f"loss within rtol {RTOL} (max rel err {rel_loss:.3g})", within)
    same_inf, within, rel_cost, _ = close(cost_k, cost_p)
    check("inf where the plain version has inf (cost)", same_inf)
    check(f"cost within rtol {RTOL} (max rel err {rel_cost:.3g})", within)

    # Cost form == plain form + loss_to_cost, bit for bit (both kernel).
    mean = loss_k / denom
    loss_from_plain = torch.where(valid_k & torch.isfinite(mean), mean, torch.inf)
    cost_from_plain = loss_to_cost(loss_from_plain, data.baseline_loss, data.use_baseline,
                                   cx, options.parsimony)
    check("cost form == plain form + loss_to_cost (bit)",
          same(lossc_k, loss_from_plain) and same(cost_k, cost_from_plain))
    l_dd, v_dd = FE.fused_loss(trees, data.Xt, data.y, data.weights, ops, el, dedup=True)
    l_nd, v_nd = FE.fused_loss(trees, data.Xt, data.y, data.weights, ops, el, dedup=False)
    check("dedup=True == dedup=False (bit)", same(l_dd, l_nd) and same(v_dd, v_nd))

    ms = cuda_ms(torch, lambda: kernel(*args, ops, el, cx=cxf, scal=scal), reps=10)
    t0 = time.perf_counter()
    FE.program_eval_plain(*args, ops, el, cx=cxf, scal=scal)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    n = N_ROWS
    L, CMAX = args[0].shape[1], args[2].shape[1]
    step_rows = float(prog.nsteps.to(torch.float64).sum()) * n
    ops_count = step_rows + 4.0 * n * T        # one op per step and row; loss d*d*w + sum
    bytes_moved = 4.0 * (T * L + T + T * CMAX + T + N_FEATURES * n + 2 * n + T + 3
                         + 3 * T)              # inputs once, loss/valid/cost out
    bound_ops = ops_count / H100_FP32_FLOPS * 1e3
    bound_bytes = bytes_moved / H100_HBM_BYTES_S * 1e3
    print(f"  kernel vs plain at T={T} trees, F={N_FEATURES}, n={n}, L={L}, CMAX={CMAX}: "
          f"{int(valid_k.sum())} valid, mean steps {step_rows / n / T:.3f}")
    print(f"  kernel {ms:.4f} ms (cost form, CUDA events, mean of 10), plain {plain_ms:.1f} ms, "
          f"bound {max(bound_ops, bound_bytes):.4f} ms "
          f"({'operations' if bound_ops >= bound_bytes else 'bytes'}: {ops_count:.4g} FP32 ops, "
          f"{bytes_moved:.4g} bytes)")
    if failures:
        raise RuntimeError(f"kernel checks failed: {failures}")
    return {
        "name": kernel.name, "route": "cuda", "source": kernel.source,
        "replaces": kernel.replaces, "launches": None, "max_abs_err": abs_loss,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": None,
    }


def phase_main_path(torch, sr, dev, ncycles: int):
    """Phase 4: Engine.run_iteration at the bench config's full width."""
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.engine import Engine
    from symbolicregression_jl_tpu_torch.ops.fused_eval import PROGRAM_EVAL

    options = bench_options(sr, ncycles)
    X, y = bench_data()
    ds = sr.make_dataset(X, y, device=dev)
    ds.update_baseline_loss(options.elementwise_loss)
    engine = Engine(options, N_FEATURES, device=dev)
    print(f"  islands {options.populations} x members {options.population_size}, "
          f"rows {N_ROWS} x features {N_FEATURES}, ncycles_per_iteration {ncycles}, "
          f"turbo {engine.cfg.turbo}, fused cost {engine.cfg.fuse_cost}")
    t0 = time.perf_counter()
    state = engine.init_state(rng.key(0, device=dev), ds.data, options.populations)
    state = engine.run_iteration(state, ds.data, options.maxsize)
    torch.cuda.synchronize()
    print(f"  init + warm-up iteration: {time.perf_counter() - t0:.2f} s")

    evals0 = float(state.num_evals)
    torch.cuda.reset_peak_memory_stats()
    PROGRAM_EVAL.launches = 0
    t0 = time.perf_counter()
    iters = 2
    for _ in range(iters):
        state = engine.run_iteration(state, ds.data, options.maxsize)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = PROGRAM_EVAL.launches
    evals = float(state.num_evals) - evals0
    expected = iters * (ncycles + 1)   # one candidate eval per cycle + the finalize
    print(f"  {iters} timed iterations: {elapsed / iters:.3f} s/iteration, "
          f"{evals / elapsed:.6g} evals/s ({evals:.0f} evals)")
    print(f"  program_eval launches {launches} (expected {expected}: one per cycle plus the "
          f"finalize, per iteration)")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    costs = state.pops.cost
    if launches == 0 or launches != expected:
        raise RuntimeError(f"main path launched the kernel {launches} times, expected {expected}")
    if not bool(torch.isfinite(state.hof.loss[state.hof.exists]).all()) \
            or not bool(state.hof.exists.any()):
        raise RuntimeError("hall of fame holds no finite entry")
    if costs.shape != (options.populations, options.population_size):
        raise RuntimeError(f"population cost has shape {tuple(costs.shape)}")
    return launches


def phase_search(sr, dev):
    """Phase 5: equation_search on the bench data."""
    X, y = bench_data()
    options = bench_options(sr, 20, populations=64)
    t0 = time.perf_counter()
    hof = sr.equation_search(X, y, options=options, niterations=3, seed=0, device=dev)
    best = min(hof.entries, key=lambda e: e.loss)
    print(f"  {time.perf_counter() - t0:.2f} s, best loss {best.loss:.6g} at complexity "
          f"{best.complexity}: {best.equation_string()}")
    if not np.isfinite(best.loss):
        raise RuntimeError("equation_search returned no finite loss")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ncycles", type=int, default=100,
                    help="ncycles_per_iteration of the main path (depth only)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import symbolicregression_jl_tpu_torch as sr
    from symbolicregression_jl_tpu_torch.ops import cuda_build
    from symbolicregression_jl_tpu_torch.ops.fused_eval import PROGRAM_EVAL

    dev = torch.device("cuda")
    print("[1] device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    print("[2] build")
    t0 = time.perf_counter()
    PROGRAM_EVAL.library()
    print(f"  program_eval.cu: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {cuda_build.build_seconds('program_eval.cu'):.2f} s)")

    print("[3] kernel against plain version")
    row = phase_kernel(torch, sr, dev)

    print("[4] main path")
    row["launches"] = phase_main_path(torch, sr, dev, args.ncycles)

    print("[5] equation_search")
    phase_search(sr, dev)

    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
