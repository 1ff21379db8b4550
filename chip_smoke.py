#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--ncycles N] [--ncycles-plain N] [--ncycles-stage N]

Phases (any failure exits nonzero and prints no result line):

1. Require CUDA (no CPU fallback); print the card's name and power limit.
2. Build the kernels' five sources (csrc/program_eval.cu, which holds
   #1, its parametric form #1p and their bf16 forms 1b, program_multi.cu
   with #2 and its bf16 form 2b, program_grad.cu,
   program_predict.cu, program_predict_vjp.cu) from the checkout, one
   nvcc per source, all started together. Prints ptxas's registers,
   stack and spills of every instantiation of #1-#5 (the tile
   interpreter of csrc/interp.cuh).
3. Hold kernel #1 against its plain PyTorch version at the benchmark
   shapes: 16,384 random trees (maxsize 30, + - * / exp abs cos), 5
   features, 10,000 rows. Validity bit-equal; loss and cost within rtol
   1e-5 (the row sums run in another order); inf in the same places; the
   cost form equal to the plain form + loss_to_cost bit for bit;
   dedup=True equal to dedup=False bit for bit; two launches identical.
   Times the kernel (CUDA events) and the plain version.
4. Hold kernels #2 and #3 against their plain versions at the constant
   optimizer's bench shapes: 18,432 trees (512 islands x 36 selected),
   V = 24 line-search variants for #2 and V = 3 restarts for #3, 10,000
   rows. Validity bit-equal; loss within rtol 1e-5 with inf in the same
   places; #2 with V = 1 bit-equal to #1's plain form; #3's loss bit-equal
   to #2's on the same variants; gradients non-finite in the same pairs
   and otherwise within 1e-4 of the sum of the absolute per-row terms;
   two launches bit-identical. #3's checks run again on 18,432 trees whose
   step counts span its three launch classes (MIXED_NLENGTHS). Times both
   kernels (CUDA events, #3 on both inputs) and reckons their bounds.
   Prints a digest of #3's output bits on each input
   (bench/kernel_turns.py compares two checkouts' digests).
5. Main path: `Engine` at the headline configuration, 512 islands x 256
   members x 10,000 rows x 5 features, tournament 16, maxsize 30, the
   constant optimizer on (the default): init_state, one warm-up
   iteration, two timed iterations. Prints evals/s (the optimizer's
   f_calls included), seconds per iteration, launches per kernel (per
   iteration: ncycles + 1 of #1, 8 of #2, 9 of #3), peak memory.
6. The same without the constant optimizer (the first slice's path) at a
   cut depth: launches of #1 only.
7. `equation_search(X, y, niterations=2, device="cuda")` with the default
   Options on the same data; two iterations keep the whole script well
   within its time limit.
8. Hold kernels #4 and #5 against their plain versions at the template
   cycle's shapes: 16,384 random trees (maxsize 30, + - * cos), 10,000
   rows, random cotangents for #5, every fifth tree's const_ok cleared;
   four inputs: shared X (F = 1), the same with overflow rows (every 97th
   row +-1e20, so x * x overflows and inf - inf gives NaN), per-member
   X (F = 2) with overflow rows in every seventh tree's X, and shared X
   (F = 1) on trees whose step counts span #5's three launch classes
   (MIXED_NLENGTHS, 32 trees an island). Validity
   bit-equal; predictions, gcomp and gx NaN in the same places and +-inf
   in the same places, and otherwise predictions and gx within rtol 1e-5,
   or within 1e-5 of the tree's largest finite |value| where the rows
   cancel, and gcomp within 1e-4 of the sum of the absolute per-row
   terms; two launches bit-identical. Prints each input's valid trees,
   non-finite predictions, step-count classes and a digest of #4's and
   #5's output bits. Times both (CUDA events; the shared, per-member and
   mixed-step inputs) and reckons their bounds.
9. Template main path: `Engine` at the JAX package's chip-sized template
   cell (bench/cell.py FULL, variant "template": 512 islands x 256
   members, tournament 16, maxsize 30, + - * cos, 10,000 rows x 2
   features from seed 1234, structure f(x1) * f(x1) + g(x2),
   optimizer_probability 0, 100 cycles): init_state, one warm-up
   iteration, two timed iterations. Launches of #4 must be 3 x (ncycles +
   1) per iteration,
   none of #1-#3 or #5; the best hall-of-fame member's loss is recomputed
   on the host from its decoded expression.
10. The template constant optimizer: the same structure at 64 islands x
   256 (the default optimizer_probability 0.14; at 512 islands the
   line search's 442,368 members would need 17.7 GB per [members, rows]
   tensor), cut to TEMPLATE_OPT_CYCLES = 10 cycles (the optimizer runs
   once per iteration whatever the depth, so the cut saves the evolution
   cycles' time within the time limit and leaves the optimizer's launches
   as they are). Launches of #5 must be 27 per iteration (9
   gradient passes x 3 call sites); prints #4's launches and the
   optimizer's share of the evaluations (f_calls).
11. A composition structure g(f(x1), x2) through
   `equation_search(..., device="cuda")`: kernels #4 and #5 in per-member
   mode. Prints the best loss and its string.
12. Hold kernel #1's parametric form (#1p, ``bank[t, p, class[r]]`` per
   parameter leaf) against its plain version: 16,384 random parametric
   trees (F = 2, NP = 2, NC = 3), 10,000 rows, every fifth tree's
   const_ok cleared, every 97th row's X at +-1e20, every 11th tree's bank
   +inf for class 2 only. Validity bit-equal; loss sums NaN and +-inf in
   the same places and within rtol 1e-5 on valid trees; two launches
   bit-identical. Times it (CUDA events), the plain version, and #1 on
   the same trees with their parameter leaves read as constants.
13. Parametric main path: `Engine` at the JAX package's chip-sized
   parametric cell (bench/cell.py FULL, variant "parametric": 512 islands
   x 256 members, tournament 16, maxsize 30, + - * cos, 10,000 rows x 2
   features from seed 1234, class = integers(0, 3), y = amp[class] cos(x1)
   + x2, max_parameters 1, optimizer_probability 0, 100 cycles): launches
   of #1p must be ncycles + 1 per iteration, none of the other kernels;
   prints the best member with its (1, 3) bank.
14. The parametric constant optimizer (eager BFGS over constants and
   banks, torch.autograd through the interpreter): the same problem at 64
   islands x 256, the default optimizer_probability 0.14, cut to
   TEMPLATE_OPT_CYCLES = 10 cycles; prints the f_calls share and the peak
   memory.
15. `equation_search(..., device="cuda")` on tests/test_parametric.py's
   per-class-offset problem (extra={"class": ...}) and on
   tests/test_template.py's template with parameters f(x1) + p[0] x2 +
   p[1]; fails past those tests' thresholds.

16. Hold kernel 1b (#1 with a bf16 value buffer) against its plain bf16
   version on phase 3's inputs (cost and plain forms) and phase 12's
   (parametric form), and kernel 2b (#2 with a bf16 buffer) on phase 4's
   (V = 24): validity bit-equal, NaN and +-inf in the same places, trees of
   + - * / abs within rtol 1e-5 (both sides store the same bf16 bits), the
   others with a median relative error below 1e-4 and every one below 1e-2
   (an ULP of a transcendental in float32 can flip one bf16 rounding); two
   launches bit-identical; 2b with V = 1 bit-equal to 1b's plain form; and
   against #1/#1p/#2 in float32 on the same inputs, the rank contract of
   tests/test_staged_eval.py (finite verdicts agree on 90%, median relative
   error below 0.02, top-quartile overlap at least 75%). Times each kernel
   and its float32 counterpart (CUDA events) and reckons the bounds.
17. The JAX package's graftstage cells at full width (bench/cell.py FULL,
   variants plain, plain-staged, plain-bf16, plain-staged-bf16: 512 islands
   x 256, tournament 16, maxsize 30, + - * cos, 10,000 rows x 2 features
   from seed 1234, y = cos(2.13 x1) + 0.5 x2, optimizer_probability 0,
   sample fraction 0.125, rescore fraction 0.25) at --ncycles-stage cycles
   (30): launches per iteration exactly ncycles + 1 of #1 / 1b, or 2 x
   ncycles + 1 staged (a screen and a rescore per cycle, the finalize
   without dedup under bf16); after the staged runs every population cost
   equals an unstaged re-eval at the same precision within rtol 1e-5.
18. Phase 5's configuration with optimizer_bf16_linesearch at
   STAGE_LS_CYCLES = 10 cycles: 8 launches of 2b and 9 of #3 per
   iteration, none of #2; the f_calls share and the best loss beside
   phase 5's.
19. equation_search with staged_eval, eval_precision="bf16" and the bf16
   line search on the plain cell's problem (16 islands x 64) and on phase
   15's parametric problem: kernels 1b, 2b and 1b's parametric form only;
   the best member's loss recomputed on the host in float64 from its
   decoded expression within the bf16 tolerance BF16_SEARCH_TOL.
20. Phase 5's configuration with minibatches (batching=True, batch_size
   50, the Options default) at BATCH_CYCLES = 10 cycles: per iteration
   exactly 10 launches of #1 over 50 rows and 1 (the finalize) over 10,000,
   8 of #2 and 9 of #3 over 50 rows, read from every launch's row count;
   #1-#3 replayed on the path's own first 50-row inputs against their plain
   versions (phases 3-4's checks) and timed (CUDA events) beside phases 3
   and 4's 10,000-row times, with their bounds; evals/s counts an
   evaluation as batch_size / n of one, as the JAX package does; the best
   member of the last finalize's population (scored on every row; the hall
   of fame also keeps the cycles' best with their batch losses, and
   migration copies them into the islands, as in the JAX package)
   recomputed on the host in float64 within rtol 1e-5.
21. equation_search at phase 20's configuration without minibatches,
   writing CSVs and a checkpoint every iteration into a temporary
   directory: 3 iterations straight through against 2, then resume="auto"
   to 3 under the same run_id; then the newest checkpoint corrupted and the
   resume repeated from the one before. Every state tensor bit-equal (the
   device evaluation counter restarts at 0 on resume, as in the JAX
   package, so the totals are compared), the CSVs byte-equal. Prints the
   checkpoint's bytes and write seconds.
22. SRRegressor(niterations=2) with the default device_scale="auto" (512
   x 256, tournament 16, 100 cycles: pinning ncycles_per_iteration would
   turn the scale off, as in the JAX package) on phase 5's X with a target
   the bench operators express, seeded with an initial population that
   holds it: predict on 2,000 held-out rows against a float64 host
   evaluation of get_best() within rtol 1e-5 (or 1e-5 of the predictions'
   RMS where rows cancel); MultitargetSRRegressor on two targets at 64
   islands x 256, 10 cycles, returns two equations.

Every file a phase writes goes to a temporary directory, removed at the
end. The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

N_ROWS = 10_000
N_FEATURES = 5
ISLANDS = 512               # the headline and template cells' width
TEMPLATE_CYCLES = 100       # the template cell's ncycles_per_iteration (bench/cell.py FULL)
TEMPLATE_OPT_CYCLES = 10    # the template optimizer phase's cut depth (phase 10)
RTOL = 1e-5
H100_FP32_FLOPS = 67e12     # non-tensor-core FP32 peak, H100 SXM data sheet
H100_HBM_BYTES_S = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet
# PR 5's times of the kernels PR 6 redesigned (PERF.md section 6, chip_smoke.py
# on an NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's.
PR5_MS = {"program_eval": 1.7189, "program_eval_param": 2.6702, "program_eval_bf16": 1.7574,
          "program_eval_param_bf16": 2.7767, "program_multi": 46.5144,
          "program_multi_bf16": 46.0428}
# The times of kernels #3, #4 and #5 as per-row kernels, before their tile
# redesign (PERF.md section 6, chip_smoke.py on an NVIDIA H100 80GB HBM3 at
# 700 W), printed beside this run's; #4 and #5 at the shared and the
# per-member input.
PER_ROW_MS = {"program_grad": 18.0438, "program_predict shared": 2.1888,
              "program_predict per-member": 2.4685, "program_predict_vjp shared": 7.4891,
              "program_predict_vjp per-member": 9.3743}


def bench_data():
    """The benchmark problem: 10,000 rows x 5 features from seed 0."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-3.0, 3.0, (N_ROWS, N_FEATURES)).astype(np.float32)
    y = (np.cos(2.13 * X[:, 0]) + 0.5 * X[:, 1] * np.abs(X[:, 2]) ** 0.9
         - 0.3 * np.abs(X[:, 3]) ** 1.5
         + 1e-1 * rng.standard_normal(N_ROWS)).astype(np.float32)
    return X, y


def bench_options(sr, ncycles: int, populations: int = 0, optimize: bool = True, **kw):
    """The headline configuration; ``populations`` 0 means ISLANDS. No
    files unless ``kw`` asks for them."""
    populations = populations or ISLANDS
    kw.setdefault("save_to_file", False)
    return sr.Options(
        binary_operators=["+", "-", "*", "/"], unary_operators=["exp", "abs", "cos"],
        maxsize=30, populations=populations, population_size=256,
        tournament_selection_n=16, ncycles_per_iteration=ncycles,
        should_optimize_constants=optimize, **kw)


def was(name: str) -> str:
    """A redesigned kernel's time before its redesign, for the line that
    prints this run's."""
    if name in PER_ROW_MS:
        return f" (per-row kernel: {PER_ROW_MS[name]:.4f} ms)"
    return f" (PR 5: {PR5_MS[name]:.4f} ms)"


def digest(*ts) -> str:
    """The first 16 hex digits of a SHA-256 over the tensors' bytes (None
    skipped): two runs whose outputs differ in any bit differ here."""
    import hashlib

    h = hashlib.sha256()
    for t in ts:
        if t is not None:
            h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ptxas_report(log: str, kernel: str):
    """(instantiation, registers, stack bytes, spill stores, spill loads) of
    each entry function whose name contains ``kernel``, from nvcc's
    ``-Xptxas -v`` report; names demangled where cu++filt or c++filt is
    installed."""
    import re
    import shutil

    rows, name, stack = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, stack = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            stack = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and kernel in name:
            rows.append((name, int(m.group(1))) + (stack or (0, 0, 0)))
            name = None
    filt = shutil.which("cu++filt") or shutil.which("/usr/local/cuda/bin/cu++filt") \
        or shutil.which("c++filt")
    if filt and rows:
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows), capture_output=True,
                             text=True).stdout.splitlines()
        if len(out) == len(rows):
            # "void <unnamed>::k<float, (int)0, true, false>(int const*, ...)"
            # -> "k<float, 0, true, false>"; "void <unnamed>::k(int const*, ...)" -> "k"
            short = [re.sub(r"\(int\)", "", o.split("::", 1)[-1]) for o in out]
            rows = [(o[:o.rfind(">(") + 1] if ">(" in o else o.split("(", 1)[0],) + r[1:]
                    for o, r in zip(short, rows)]
    return rows


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


def same(torch, a, b):
    """Bit-for-bit equality (NaN payloads included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def nonfinite_match(torch, a, b):
    """NaN in the same places, and +-inf in the same places with the same
    sign (NaN compares unequal to itself, so the masks are compared)."""
    ia, ib = torch.isinf(a), torch.isinf(b)
    return (bool(torch.equal(torch.isnan(a), torch.isnan(b))) and bool(torch.equal(ia, ib))
            and bool(torch.equal(a[ia], b[ib])))


def close(torch, a, b):
    """Within rtol where finite, non-finite exactly where the other is.
    Returns (same_inf, within, max rel err, max abs err)."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    same_inf = nonfinite_match(torch, a, b)
    err = (a[fa] - b[fb]).abs()
    within = bool((err <= RTOL * b[fb].abs()).all()) if same_inf else False
    rel = float((err / b[fb].abs().clamp(min=1e-30)).max()) if same_inf and err.numel() else 0.0
    return same_inf, within, rel, float(err.max()) if same_inf and err.numel() else 0.0


class Checks:
    def __init__(self):
        self.failures = []

    def __call__(self, name, ok):
        print(f"  check {name}: {'ok' if ok else 'FAILED'}")
        if not ok:
            self.failures.append(name)

    def raise_if_failed(self, what):
        if self.failures:
            raise RuntimeError(f"{what} checks failed: {self.failures}")


def bound(ops_count: float, bytes_moved: float):
    """(bound ms, bound_by): the larger of the FP32-operation time and the
    byte time on the H100."""
    bound_ops = ops_count / H100_FP32_FLOPS * 1e3
    bound_bytes = bytes_moved / H100_HBM_BYTES_S * 1e3
    return max(bound_ops, bound_bytes), "operations" if bound_ops >= bound_bytes else "bytes"


def kernel1_inputs(torch, sr, dev):
    """Kernel #1's inputs at the bench shapes (phases 3 and 16): 16,384
    random trees (maxsize 30, + - * / exp abs cos) over the bench data."""
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
    tables = build_complexity_tables(options, N_FEATURES, dev)
    cx = compute_complexity_batch(trees, tables)
    ops = options.operators
    prog = compile_program(trees, N_FEATURES, len(ops.binary))
    args = FE._launch_inputs(prog, data.Xt, data.y, data.weights, N_FEATURES, ops)
    denom = FE._denominator(data.weights, data.Xt)
    norm = FE.baseline_normalization(data.baseline_loss, data.use_baseline)
    scal = torch.stack([denom, norm, torch.tensor(options.parsimony, dtype=torch.float32,
                                                  device=dev)]).contiguous()
    return options, data, trees, cx, prog, args, scal, cx.to(torch.float32).contiguous()


def phase_kernel(torch, sr, dev):
    """Phase 3: kernel #1 against its plain version at the bench shapes."""
    from symbolicregression_jl_tpu_torch.core.losses import loss_to_cost
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    options, data, trees, cx, prog, args, scal, cxf = kernel1_inputs(torch, sr, dev)
    T = trees.length.shape[0]
    ops, el = options.operators, options.elementwise_loss
    denom = scal[0]

    kernel = FE.PROGRAM_EVAL
    loss_k, valid_k = kernel(*args, ops, el)
    loss_k2, valid_k2 = kernel(*args, ops, el)
    lossc_k, validc_k, cost_k = kernel(*args, ops, el, cx=cxf, scal=scal)
    torch.cuda.synchronize()
    loss_p, valid_p = FE.program_eval_plain(*args, ops, el)
    lossc_p, validc_p, cost_p = FE.program_eval_plain(*args, ops, el, cx=cxf, scal=scal)
    torch.cuda.synchronize()

    check = Checks()
    _same = lambda a, b: same(torch, a, b)
    _close = lambda a, b: close(torch, a, b)

    check("two launches bit-identical", _same(loss_k, loss_k2) and _same(valid_k, valid_k2))
    check("validity bit-equal (plain form)", _same(valid_k, valid_p))
    check("validity bit-equal (cost form)", _same(validc_k, validc_p))
    # The plain form's loss sum is only meaningful for valid trees.
    same_inf, within, rel_sum, _ = _close(torch.where(valid_p, loss_k, torch.inf),
                                         torch.where(valid_p, loss_p, torch.inf))
    check(f"loss sum within rtol {RTOL} (max rel err {rel_sum:.3g})", within)
    same_inf, within, rel_loss, abs_loss = _close(lossc_k, lossc_p)
    check("inf where the plain version has inf (loss)", same_inf)
    check(f"loss within rtol {RTOL} (max rel err {rel_loss:.3g})", within)
    same_inf, within, rel_cost, _ = _close(cost_k, cost_p)
    check("inf where the plain version has inf (cost)", same_inf)
    check(f"cost within rtol {RTOL} (max rel err {rel_cost:.3g})", within)

    # Cost form == plain form + loss_to_cost, bit for bit (both kernel).
    mean = loss_k / denom
    loss_from_plain = torch.where(valid_k & torch.isfinite(mean), mean, torch.inf)
    cost_from_plain = loss_to_cost(loss_from_plain, data.baseline_loss, data.use_baseline,
                                   cx, options.parsimony)
    check("cost form == plain form + loss_to_cost (bit)",
          _same(lossc_k, loss_from_plain) and _same(cost_k, cost_from_plain))
    l_dd, v_dd = FE.fused_loss(trees, data.Xt, data.y, data.weights, ops, el, dedup=True)
    l_nd, v_nd = FE.fused_loss(trees, data.Xt, data.y, data.weights, ops, el, dedup=False)
    check("dedup=True == dedup=False (bit)", _same(l_dd, l_nd) and _same(v_dd, v_nd))

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
    bound_ms, bound_by = bound(ops_count, bytes_moved)
    print(f"  kernel vs plain at T={T} trees, F={N_FEATURES}, n={n}, L={L}, CMAX={CMAX}: "
          f"{int(valid_k.sum())} valid, mean steps {step_rows / n / T:.3f}")
    print(f"  kernel {ms:.4f} ms{was(kernel.name)} (cost form, CUDA events, mean of 10), plain "
          f"{plain_ms:.1f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {ops_count:.4g} FP32 ops, "
          f"{bytes_moved:.4g} bytes)")
    check.raise_if_failed("kernel #1")
    return {
        "name": kernel.name, "route": "cuda", "source": kernel.source,
        "replaces": kernel.replaces, "launches": None, "max_abs_err": abs_loss,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }


def opt_kernel_inputs(torch, sr, dev):
    """Kernels #2/#3's inputs at the constant optimizer's bench shapes
    (phases 4 and 16): 18,432 trees (512 islands x 36 selected), their
    constants perturbed V = 24 (line search) and V = 3 (gradient) ways."""
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.population import init_population
    from symbolicregression_jl_tpu_torch.evolve.step import evolve_config_from_options
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.ops.program import compile_program

    options = bench_options(sr, 1)
    X, y = bench_data()
    ds = sr.make_dataset(X, y, device=dev)
    data = ds.data
    cfg = evolve_config_from_options(options, N_FEATURES, dev)
    k_sel = round(options.population_size * options.optimizer_probability)   # 36
    trees = init_population(rng.split(rng.key(2, device=dev), options.populations), k_sel,
                            cfg.mctx).reshape(-1)
    T = trees.length.shape[0]
    ops, el = options.operators, options.elementwise_loss
    prog = compile_program(trees, N_FEATURES, len(ops.binary))
    instr, nsteps, cvals, const_ok, Xt, yt, w = FE._launch_inputs(
        prog, data.Xt, data.y, data.weights, N_FEATURES, ops)
    nconst = prog.nconst.to(torch.int32).contiguous()
    R = options.optimizer_nrestarts + 1
    C = 8                                               # max_linesearch
    V_ls = R * C
    g = torch.Generator(device=dev).manual_seed(0)

    def variants(V):
        """The trees' constants perturbed V ways, with a few non-finite."""
        cv = cvals[:, None, :] * (1.0 + 0.5 * torch.randn((T, V, cvals.shape[1]), generator=g,
                                                          device=dev))
        cv[::997, -1, 0] = torch.inf
        return cv.contiguous()

    cv_ls, cv_g = variants(V_ls), variants(R)
    return (options, trees, prog, (instr, nsteps, cvals, const_ok, Xt, yt, w), nconst, R, V_ls,
            cv_ls, cv_g)


# Phase 4's second input for #3: islands of 36 trees of a given number of
# operator draws (init_population's nlength), so that the trees' step
# counts m fall in csrc/program_grad.cu's launch classes (m <= 4, 5-12, 13
# or more) in the shares bench/profile_iteration.py counted for #3's trees
# in the optimizer cell's 10-cycle iteration (65.8%, 33.6%, 0.6%): 337
# islands of 1-4 draws, 172 of 5-12 and 3 of 16-18.
MIXED_NLENGTHS = ([1 + i % 4 for i in range(337)] + [5 + i % 8 for i in range(172)]
                  + [16, 17, 18])


def mixed_trees(torch, dev, mctx, seed: int, per_island: int):
    """Islands of ``per_island`` random trees (init_population) of
    MIXED_NLENGTHS operator draws each, flat, grouped by draw count."""
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.population import init_population
    from symbolicregression_jl_tpu_torch.ops.encoding import TreeBatch

    keys = rng.split(rng.key(seed, device=dev), len(MIXED_NLENGTHS))
    parts = []
    for nl in sorted(set(MIXED_NLENGTHS)):
        idx = torch.tensor([i for i, v in enumerate(MIXED_NLENGTHS) if v == nl], device=dev)
        parts.append(init_population(keys[idx], per_island, mctx, nlength=nl).reshape(-1))
    return TreeBatch(*(torch.cat(f) for f in zip(*(p.fields() for p in parts))))


def mixed_grad_inputs(torch, sr, dev):
    """Kernel #3's phase 4 arguments (instr, nsteps, nconst, cvals_v, X, y,
    w) on 512 x 36 trees of MIXED_NLENGTHS, their constants perturbed
    V = 3 ways with a few non-finite, and the operators and loss."""
    from symbolicregression_jl_tpu_torch.evolve.step import evolve_config_from_options
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.ops.program import compile_program

    options = bench_options(sr, 1)
    X, y = bench_data()
    data = sr.make_dataset(X, y, device=dev).data
    cfg = evolve_config_from_options(options, N_FEATURES, dev)
    trees = mixed_trees(torch, dev, cfg.mctx, 3, 36)
    ops, el = options.operators, options.elementwise_loss
    prog = compile_program(trees, N_FEATURES, len(ops.binary))
    instr, nsteps, cvals, _, Xt, yt, w = FE._launch_inputs(prog, data.Xt, data.y, data.weights,
                                                           N_FEATURES, ops)
    V = options.optimizer_nrestarts + 1
    g = torch.Generator(device=dev).manual_seed(1)
    cv = cvals[:, None, :] * (1.0 + 0.5 * torch.randn((cvals.shape[0], V, cvals.shape[1]),
                                                      generator=g, device=dev))
    cv[::997, -1, 0] = torch.inf
    nconst = prog.nconst.to(torch.int32).contiguous()
    return (instr, nsteps, nconst, cv.contiguous(), Xt, yt, w), ops, el


def grad_checks(torch, check, tag, args, ops, el):
    """Kernel #3 on ``args`` against its plain version and kernel #2 (the
    checks of phase 4, named with ``tag``). Returns (largest gradient error,
    plain version's ms, valid pairs)."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    instr, nsteps, nconst, cv, Xt, yt, w = args
    _same = lambda a, b: same(torch, a, b)
    gl, gv, gg = FE.PROGRAM_GRAD(*args, ops, el)
    gl2, gv2, gg2 = FE.PROGRAM_GRAD(*args, ops, el)
    lm, vm = FE.PROGRAM_MULTI(instr, nsteps, cv, Xt, yt, w, ops, el)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pl, pv, pg, pabs = FE.program_grad_plain(*args, ops, el, return_abs=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(f"#3{tag} two launches bit-identical",
          _same(gl, gl2) and _same(gv, gv2) and _same(gg, gg2))
    print(f"  bits #3{tag}: {digest(gl, gv, gg)}")
    check(f"#3{tag} validity bit-equal", _same(gv, pv))
    check(f"#3{tag} loss == #2's on the same variants (bit)", _same(gl, lm) and _same(gv, vm))
    same_inf, within, rel3, _ = close(torch, torch.where(pv, gl, torch.inf),
                                      torch.where(pv, pl, torch.inf))
    check(f"#3{tag} loss sum within rtol {RTOL} (max rel err {rel3:.3g})", same_inf and within)
    # Gradients: a valid pair's gradient is non-finite in the same
    # components; finite ones agree within 1e-4 of the sum of the absolute
    # per-row terms (each row's derivative agrees within a few ULP; the
    # rows are summed in another order and may cancel).
    live = pv[..., None].expand_as(pg)
    fin_k, fin_p = torch.isfinite(gg), torch.isfinite(pg)
    check(f"#3{tag} gradients non-finite in the same places",
          bool(torch.equal(fin_k[live], fin_p[live])))
    both = live & fin_k & fin_p
    gerr = (gg - pg).abs()[both]
    gtol = 1e-4 * pabs[both]
    check(f"#3{tag} gradients within 1e-4 of the absolute row sums (max err / scale "
          f"{float((gerr / pabs[both].clamp(min=1e-30)).max()):.3g})", bool((gerr <= gtol).all()))
    return (float(gerr.max()) if gerr.numel() else 0.0), plain_ms, int(gv.sum())


def grad_bound(torch, args):
    """(bound ms, bound_by, operations, bytes) of kernel #3 on ``args``: the
    forward's operations, then per step and row the derivative and one more
    operation per operand, the loss derivative and the constants' sums."""
    instr, nsteps, nconst, cv, Xt, yt, w = args
    T, V, CMAX = cv.shape
    L, n = instr.shape[1], Xt.shape[1]
    steps = float(nsteps.to(torch.float64).sum())
    nc = float(nconst.to(torch.float64).sum())
    ops3 = (3.0 * steps + 8.0 * T + nc) * V * n
    bytes3 = 4.0 * (T * L + 2 * T + T * V * CMAX + Xt.shape[0] * n + 2 * n + 2 * T * V
                    + T * V * CMAX)
    return bound(ops3, bytes3) + (ops3, bytes3)


def phase_opt_kernels(torch, sr, dev):
    """Phase 4: kernels #2 and #3 against their plain versions at the
    constant optimizer's bench shapes."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    (options, trees, prog, (instr, nsteps, cvals, const_ok, Xt, yt, w), nconst, R, V_ls, cv_ls,
     cv_g) = opt_kernel_inputs(torch, sr, dev)
    T = trees.length.shape[0]
    ops, el = options.operators, options.elementwise_loss
    check = Checks()
    _same = lambda a, b: same(torch, a, b)
    _close = lambda a, b: close(torch, a, b)
    multi, grad = FE.PROGRAM_MULTI, FE.PROGRAM_GRAD

    # kernel #2
    lk, vk = multi(instr, nsteps, cv_ls, Xt, yt, w, ops, el)
    lk2, vk2 = multi(instr, nsteps, cv_ls, Xt, yt, w, ops, el)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp, vp = FE.program_multi_plain(instr, nsteps, cv_ls, Xt, yt, w, ops, el)
    torch.cuda.synchronize()
    plain_ms_multi = (time.perf_counter() - t0) * 1e3
    check("#2 two launches bit-identical", _same(lk, lk2) and _same(vk, vk2))
    check("#2 validity bit-equal", _same(vk, vp))
    same_inf, within, rel2, abs2 = _close(torch.where(vp, lk, torch.inf),
                                          torch.where(vp, lp, torch.inf))
    check("#2 inf where the plain version has inf", same_inf)
    check(f"#2 loss sum within rtol {RTOL} (max rel err {rel2:.3g})", within)
    ones = torch.ones(T, dtype=torch.int32, device=dev)
    l1, v1 = multi(instr, nsteps, cvals[:, None, :].contiguous(), Xt, yt, w, ops, el)
    l1e, v1e = FE.PROGRAM_EVAL(instr, nsteps, cvals, ones, Xt, yt, w, ops, el)
    check("#2 with V = 1 == #1's plain form (bit)", _same(l1[:, 0], l1e) and _same(v1[:, 0], v1e))

    # kernel #3, on phase 4's trees and on trees of every launch class
    gargs = (instr, nsteps, nconst, cv_g, Xt, yt, w)
    abs3, plain_ms_grad, gvalid = grad_checks(torch, check, "", gargs, ops, el)
    margs, mops, mel = mixed_grad_inputs(torch, sr, dev)
    abs3m, plain_ms_mixed, mvalid = grad_checks(torch, check, " (mixed steps)", margs, mops, mel)
    abs3 = max(abs3, abs3m)

    ms_multi = cuda_ms(torch, lambda: multi(instr, nsteps, cv_ls, Xt, yt, w, ops, el), reps=5)
    ms_grad = cuda_ms(torch, lambda: grad(*gargs, ops, el), reps=5)
    ms_mixed = cuda_ms(torch, lambda: grad(*margs, mops, mel), reps=5)
    n = N_ROWS
    L, CMAX = instr.shape[1], cvals.shape[1]
    steps = float(nsteps.to(torch.float64).sum())
    nc = float(nconst.to(torch.float64).sum())
    # #2: one operation per step and row, four for the loss term and sum.
    ops2 = (steps + 4.0 * T) * V_ls * n
    bytes2 = 4.0 * (T * L + T + T * V_ls * CMAX + N_FEATURES * n + 2 * n + 2 * T * V_ls)
    b3, by3, ops3, bytes3 = grad_bound(torch, gargs)
    b3m, by3m, ops3m, bytes3m = grad_bound(torch, margs)
    mm = margs[1].to(torch.float64)
    b2, by2 = bound(ops2, bytes2)
    print(f"  {T} trees (mean steps {steps / T:.3f}, mean constants {nc / T:.3f}), {n} rows; "
          f"{int(vk.sum())} of {T * V_ls} line-search pairs valid, "
          f"{gvalid} of {T * R} gradient pairs valid")
    print(f"  mixed steps: {mm.numel()} trees (mean steps {float(mm.mean()):.3f}; m <= 4 "
          f"{int((mm <= 4).sum())}, 5-12 {int(((mm > 4) & (mm <= 12)).sum())}, 13 or more "
          f"{int((mm > 12).sum())}), {mvalid} of {mm.numel() * R} gradient pairs valid")
    print(f"  #2 program_multi: {ms_multi:.4f} ms{was(multi.name)} (V={V_ls}, CUDA events, "
          f"mean of 5), plain "
          f"{plain_ms_multi:.1f} ms, bound {b2:.4f} ms ({by2}: {ops2:.4g} ops, {bytes2:.4g} B)")
    print(f"  #3 program_grad: {ms_grad:.4f} ms{was(grad.name)} (V={R}, CUDA events, mean of "
          f"5), plain "
          f"{plain_ms_grad:.1f} ms, bound {b3:.4f} ms ({by3}: {ops3:.4g} ops, {bytes3:.4g} B)")
    print(f"  #3 program_grad, mixed steps: {ms_mixed:.4f} ms (V={R}, CUDA events, mean of 5), "
          f"plain {plain_ms_mixed:.1f} ms, bound {b3m:.4f} ms ({by3m}: {ops3m:.4g} ops, "
          f"{bytes3m:.4g} B)")
    check.raise_if_failed("kernels #2 and #3")
    row = lambda k, err, ms, plain, b, by: {
        "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b,
        "bound_by": by, "library_ms": None}
    return [row(multi, abs2, ms_multi, plain_ms_multi, b2, by2),
            row(grad, abs3, ms_grad, plain_ms_grad, b3, by3)]


KERNEL_NAMES = ("PROGRAM_EVAL", "PROGRAM_MULTI", "PROGRAM_GRAD", "PROGRAM_PREDICT",
                "PROGRAM_PREDICT_VJP", "PROGRAM_EVAL_PARAM", "PROGRAM_EVAL_BF16",
                "PROGRAM_EVAL_PARAM_BF16", "PROGRAM_MULTI_BF16")


def kernels():
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    return [getattr(FE, k) for k in KERNEL_NAMES]


def run_engine(torch, sr, dev, options, iters: int = 2, data=None, on_engine=None, extra=None):
    """init_state, one warm-up iteration, then ``iters`` timed iterations
    with every kernel's launch count set to 0 just before them. ``data``
    is (X, y), the bench problem by default; ``extra`` its class column
    for parametric options; ``on_engine`` sees the engine before the
    timed iterations. Returns (launches by kernel name, state, engine,
    evaluations in the timed iterations)."""
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.engine import Engine

    X, y = bench_data() if data is None else data
    ds = sr.make_dataset(X, y, extra=extra, device=dev)
    ds.update_baseline_loss(options.elementwise_loss)
    n_params = n_classes = 0
    if isinstance(options.expression_spec, sr.ParametricExpressionSpec):
        n_params, n_classes = options.expression_spec.max_parameters, ds.n_classes
    engine = Engine(options, X.shape[1], device=dev, n_params=n_params, n_classes=n_classes)
    print(f"  islands {options.populations} x members {options.population_size}, "
          f"rows {X.shape[0]} x features {X.shape[1]}, ncycles_per_iteration "
          f"{options.ncycles_per_iteration}, constant optimizer "
          f"{options.should_optimize_constants} (probability {options.optimizer_probability}), "
          f"template {engine.template is not None}, parameter banks "
          f"{engine.cfg.n_params} x {engine.cfg.n_classes}, turbo {engine.cfg.turbo}, fused cost "
          f"{engine.cfg.fuse_cost}")
    t0 = time.perf_counter()
    state = engine.init_state(rng.key(0, device=dev), ds.data, options.populations)
    state = engine.run_iteration(state, ds.data, options.maxsize)
    torch.cuda.synchronize()
    print(f"  init + warm-up iteration: {time.perf_counter() - t0:.2f} s")
    if on_engine is not None:
        on_engine(engine)

    evals0 = float(state.num_evals)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels():
        k.launches = 0
    t0 = time.perf_counter()
    for _ in range(iters):
        state = engine.run_iteration(state, ds.data, options.maxsize)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels()}
    evals = float(state.num_evals) - evals0
    print(f"  {iters} timed iterations: {elapsed / iters:.3f} s/iteration, "
          f"{evals / elapsed:.6g} evals/s ({evals:.0f} evals)")
    print(f"  launches {launches}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not bool(torch.isfinite(state.hof.loss[state.hof.exists]).all()) \
            or not bool(state.hof.exists.any()):
        raise RuntimeError("hall of fame holds no finite entry")
    if state.pops.cost.shape != (options.populations, options.population_size):
        raise RuntimeError(f"population cost has shape {tuple(state.pops.cost.shape)}")
    return launches, state, engine, evals


def expect(launches, **counts):
    """The launch counts a path must show: ``counts``, every other kernel 0."""
    expected = dict.fromkeys(launches, 0)
    expected.update(counts)
    return expected


def best_loss(state) -> float:
    """The hall of fame's best loss."""
    return float(state.hof.loss[state.hof.exists].min())


def phase_main_path(torch, sr, dev, ncycles: int):
    """Phase 5: the headline configuration, constant optimizer on. Returns
    the launches and the hall of fame's best loss."""
    options = bench_options(sr, ncycles)
    iters = 2
    launches, state, _, _ = run_engine(torch, sr, dev, options, iters)
    expected = expect(launches,
                      program_eval=iters * (ncycles + 1),              # each cycle + finalize
                      program_multi=iters * options.optimizer_iterations,     # line searches
                      program_grad=iters * (options.optimizer_iterations + 1))  # + the first
    print(f"  expected {expected}")
    if launches != expected or 0 in (launches[k] for k in ("program_eval", "program_multi",
                                                            "program_grad")):
        raise RuntimeError(f"main path launched {launches}, expected {expected}")
    print(f"  hall of fame best loss {best_loss(state):.6g}")
    return launches, best_loss(state)


def phase_no_optimizer(torch, sr, dev, ncycles: int):
    """Phase 6: the first slice's path (no constant optimizer), cut depth."""
    options = bench_options(sr, ncycles, optimize=False)
    launches, _, _, _ = run_engine(torch, sr, dev, options, iters=2)
    expected = expect(launches, program_eval=2 * (ncycles + 1))
    if launches != expected:
        raise RuntimeError(f"no-optimizer path launched {launches}, expected {expected}")


def phase_search(sr, dev, out_base):
    """Phase 7: equation_search with the default Options on the bench data;
    its files (save_to_file is on by default) go under ``out_base``."""
    X, y = bench_data()
    t0 = time.perf_counter()
    hof = sr.equation_search(X, y, options=sr.Options(output_directory=out_base), niterations=2,
                             seed=0, device=dev, verbosity=0)
    best = min(hof.entries, key=lambda e: e.loss)
    print(f"  default Options: {time.perf_counter() - t0:.2f} s, best loss {best.loss:.6g} at "
          f"complexity {best.complexity}: {best.equation_string()}")
    if not np.isfinite(best.loss):
        raise RuntimeError("equation_search returned no finite loss")


# ---------------------------------------------------------------------------
# Template expressions (kernels #4 and #5)
# ---------------------------------------------------------------------------


def template_data():
    """The JAX package's template cell data (bench/cell.py, variant
    "template"): 10,000 rows x 2 features from seed 1234 uniform on
    [-2, 2], y = (1.5 x1)^2 + cos(2 x2)."""
    rng = np.random.default_rng(1234)
    X = rng.uniform(-2.0, 2.0, (N_ROWS, 2)).astype(np.float32)
    y = ((1.5 * X[:, 0]) ** 2 + np.cos(2.0 * X[:, 1])).astype(np.float32)
    return X, y


def template_options(sr, ncycles: int, populations: int = 0, combiner=None, **kw):
    """bench/cell.py FULL with variant "template" (optimizer_probability 0
    unless given); ``populations`` 0 means ISLANDS."""
    populations = populations or ISLANDS
    from symbolicregression_jl_tpu_torch.models import template_spec

    combiner = combiner or (lambda f, g, x1, x2: f(x1) * f(x1) + g(x2))
    spec = template_spec(expressions=("f", "g"))(combiner)
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=30,
                populations=populations, population_size=256, tournament_selection_n=16,
                ncycles_per_iteration=ncycles, optimizer_probability=0.0,
                expression_spec=spec, save_to_file=False)
    base.update(kw)
    return sr.Options(**base)


def tree_close(torch, a, b, rtol=RTOL):
    """[T, ...] values: non-finite in the same places (``nonfinite_match``)
    and otherwise within ``rtol``, or within ``rtol`` of the tree's largest
    finite |b| where the rows cancel. Returns (ok, worst relative error,
    worst error over the tree's scale, worst absolute error)."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    fb = torch.isfinite(b)
    if not nonfinite_match(torch, a, b):
        return False, float("inf"), float("inf"), float("inf")
    scale = torch.where(fb, b.abs(), 0.0).amax(dim=-1, keepdim=True).expand_as(b)[fb]
    err = (a - b).abs()[fb]
    if not err.numel():
        return True, 0.0, 0.0, 0.0
    mag = b.abs()[fb]
    ok = bool(((err <= rtol * mag) | (err <= rtol * scale)).all())
    rel = float((err / mag.clamp(min=1e-30)).max())
    return ok, rel, float((err / scale.clamp(min=1e-30)).max()), float(err.max())


OVERFLOW = 1e20   # x * x overflows float32 at this |x|; x + c, x * c and cos(x) do not


def predict_inputs(torch, sr, dev, F: int, per_member: bool, overflow: bool, g,
                   mixed: bool = False):
    """Kernel #4/#5 inputs at the template cycle's shapes: 16,384 random
    trees over F arguments (every fifth tree's const_ok cleared), X on
    [-2, 2] (shared [F, n] or per-member [T, F, n]), random cotangents.
    ``overflow`` sets every 97th row to +-OVERFLOW: in every tree's X when
    shared, in every seventh tree's when per-member. ``mixed``: 512 islands
    of 32 trees of MIXED_NLENGTHS operator draws, so that their step counts
    fall in all three launch classes of #5, in place of 5 draws each."""
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.population import init_population
    from symbolicregression_jl_tpu_torch.evolve.step import evolve_config_from_options
    from symbolicregression_jl_tpu_torch.ops.program import compile_program

    options = template_options(sr, 1)
    T, n = ISLANDS * 2 * 16, N_ROWS   # the cycle's candidates: islands x 2 x ceil(256 / 16)
    cfg = evolve_config_from_options(options, F, dev)
    if mixed:
        trees = mixed_trees(torch, dev, cfg.mctx, 9, T // len(MIXED_NLENGTHS))
    else:
        trees = init_population(rng.split(rng.key(5 + F, device=dev), 64), T // 64, cfg.mctx,
                                nlength=5).reshape(-1)
    prog = compile_program(trees, F, len(options.operators.binary))
    X = torch.rand((T, F, n) if per_member else (F, n), generator=g, device=dev) * 4 - 2
    if overflow:
        big = X[::7, :, ::97] if per_member else X[:, ::97]
        big.copy_(torch.where(big < 0, -OVERFLOW, OVERFLOW))
    ct = torch.randn((T, n), generator=g, device=dev)
    ok = prog.const_ok.clone()
    ok[::5] = False
    return options.operators, prog, X, ct, ok.to(torch.int32).contiguous()


def phase_predict_kernels(torch, sr, dev):
    """Phase 8: kernels #4 and #5 against their plain versions at the
    template cycle's shapes, in both X modes and with overflow rows."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    check = Checks()
    _same = lambda a, b: same(torch, a, b)
    k4, k5 = FE.PROGRAM_PREDICT, FE.PROGRAM_PREDICT_VJP
    g = torch.Generator(device=dev).manual_seed(4)
    report, errs4, errs5 = {}, [], []
    for mode, F, per_member, overflow in (("shared", 1, False, False),
                                          ("shared, overflow rows", 1, False, True),
                                          ("per-member", 2, True, True),
                                          ("mixed steps", 1, False, False)):
        ops, prog, X, ct, ok = predict_inputs(torch, sr, dev, F, per_member, overflow, g,
                                              mixed=mode == "mixed steps")
        instr, nsteps, cvals, Xc = FE._predict_inputs(prog, X, F, ops)
        nconst = prog.nconst.to(torch.int32).contiguous()
        T, n = ct.shape

        pk, vk = k4(instr, nsteps, cvals, ok, Xc, ops)
        pk2, vk2 = k4(instr, nsteps, cvals, ok, Xc, ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pp, vp = FE.program_predict_plain(instr, nsteps, cvals, ok, Xc, ops)
        torch.cuda.synchronize()
        plain4 = (time.perf_counter() - t0) * 1e3
        check(f"#4 {mode}: two launches bit-identical", _same(pk, pk2) and _same(vk, vk2))
        check(f"#4 {mode}: validity bit-equal", _same(vk, vp))
        good, rel4, scl4, abs4 = tree_close(torch, pk, pp)
        check(f"#4 {mode}: predictions NaN and +-inf in the same places, otherwise within "
              f"rtol {RTOL} or {RTOL} of the tree's largest |pred| (worst relative error "
              f"{rel4:.3g}, worst over the tree's scale {scl4:.3g})", good)
        errs4.append(abs4)

        gk, xk = k5(instr, nsteps, nconst, cvals, Xc, ct, ops)
        gk2, xk2 = k5(instr, nsteps, nconst, cvals, Xc, ct, ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp, xp, gabs = FE.program_predict_vjp_plain(instr, nsteps, nconst, cvals, Xc, ct, ops,
                                                    return_abs=True)
        torch.cuda.synchronize()
        plain5 = (time.perf_counter() - t0) * 1e3
        check(f"#5 {mode}: two launches bit-identical",
              _same(gk, gk2) and (xk is None or _same(xk, xk2)))
        check(f"#5 {mode}: gcomp NaN and +-inf in the same places",
              nonfinite_match(torch, gk, gp))
        both = torch.isfinite(gabs) & torch.isfinite(gk) & torch.isfinite(gp)
        gerr = (gk - gp).abs()[both]
        gscale = float((gerr / gabs[both].clamp(min=1e-30)).max()) if gerr.numel() else 0.0
        check(f"#5 {mode}: gcomp within 1e-4 of the absolute row sums (worst error over "
              f"that scale {gscale:.3g})", bool((gerr <= 1e-4 * gabs[both]).all()))
        errs5.append(float(gerr.max()) if gerr.numel() else 0.0)
        if per_member:
            good, relx, sclx, absx = tree_close(torch, xk, xp)
            check(f"#5 {mode}: gx NaN and +-inf in the same places, otherwise within rtol "
                  f"{RTOL} or {RTOL} of the tree's largest |gx| (worst relative error "
                  f"{relx:.3g}, worst over the tree's scale {sclx:.3g})", good)
            errs5.append(absx)
        steps = float(nsteps.to(torch.float64).sum())
        nc = float(nconst.to(torch.float64).sum())
        mm = nsteps.to(torch.float64)
        print(f"  {mode} X (F = {F}): {T} trees, mean steps {steps / T:.3f} (m <= 4 "
              f"{int((mm <= 4).sum())}, 5-12 {int(((mm > 4) & (mm <= 12)).sum())}, 13 or more "
              f"{int((mm > 12).sum())}), mean constants "
              f"{nc / T:.3f}, {int(vk.sum())} of {T} valid ({int((ok == 0).sum())} with "
              f"const_ok cleared), {n} rows; {int((~torch.isfinite(pk)).sum())} of {pk.numel()} "
              f"predictions non-finite ({int(torch.isnan(pk).sum())} NaN), "
              f"{int((~torch.isfinite(gk)).sum())} of {gk.numel()} gcomp entries non-finite")
        print(f"  bits #4 {mode}: {digest(pk, vk)}")
        print(f"  bits #5 {mode}: {digest(gk, xk)}")

        if not overflow or per_member:
            ms4 = cuda_ms(torch, lambda: k4(instr, nsteps, cvals, ok, Xc, ops), reps=5)
            ms5 = cuda_ms(torch, lambda: k5(instr, nsteps, nconst, cvals, Xc, ct, ops), reps=5)
            L, CMAX = instr.shape[1], cvals.shape[1]
            xbytes = 4.0 * (T if per_member else 1) * F * n
            # #4: one operation per step and row; inputs once, pred and valid out.
            b4, by4 = bound(steps * n,
                            4.0 * (T * L + 2 * T + T * CMAX) + xbytes + 4.0 * T * (n + 1))
            # #5: the forward's, then per step and row the derivative and one more
            # operation per operand, and the constants' sums; ct in, gcomp (and gx) out.
            b5, by5 = bound((3.0 * steps + nc) * n,
                            4.0 * (T * L + 2 * T + 2 * T * CMAX + T * n) + xbytes
                            + (xbytes if per_member else 0.0))
            # The per-row kernels' times (none for the mixed-step input).
            before = lambda k: was(f"{k.name} {mode}") if f"{k.name} {mode}" in PER_ROW_MS else ""
            print(f"  #4 program_predict: {ms4:.4f} ms{before(k4)} (CUDA events, "
                  f"mean of 5), plain "
                  f"{plain4:.1f} ms, bound {b4:.4f} ms ({by4})")
            print(f"  #5 program_predict_vjp: {ms5:.4f} ms{before(k5)} (CUDA "
                  f"events, mean of 5), plain {plain5:.1f} ms, bound {b5:.4f} ms ({by5})")
            report[mode] = {k4: (ms4, plain4, b4, by4), k5: (ms5, plain5, b5, by5)}
        del pk, pk2, pp, gk, gk2, gp, gabs, xk, xk2, xp, X, ct
        torch.cuda.empty_cache()
    check.raise_if_failed("kernels #4 and #5")

    def row(k, errs):
        """Times of the shared input (the main path's call sites); the
        largest error of all three inputs."""
        ms, plain, b, by = report["shared"][k]
        return {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
                "launches": None, "max_abs_err": max(errs), "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by, "library_ms": None}

    return [row(k4, errs4), row(k5, errs5)]


def phase_template_main_path(torch, sr, dev):
    """Phase 9: the template cell at full width; kernel #4 only."""
    ncycles = TEMPLATE_CYCLES
    options = template_options(sr, ncycles)
    iters = 2
    launches, state, engine, _ = run_engine(torch, sr, dev, options, iters,
                                            data=template_data())
    expected = expect(launches, program_predict=iters * 3 * (ncycles + 1))
    print(f"  expected {expected}")
    if launches != expected:
        raise RuntimeError(f"template path launched {launches}, expected {expected}")
    # The best member's loss, recomputed on the host from its decoded expression.
    hof = sr.HallOfFame.from_device(state.hof, options.operators, template=engine.template)
    best = min(hof.entries, key=lambda e: e.loss)
    X, y = template_data()
    host = best.template_expr(X, device="cpu").astype(np.float64)
    mse = float(np.mean((host - y) ** 2))
    print(f"  best: loss {best.loss:.6g} at complexity {best.complexity}: "
          f"{best.equation_string()}; host recomputation {mse:.6g}")
    if not abs(mse - best.loss) <= 1e-4 * max(best.loss, 1e-6):
        raise RuntimeError(f"hall of fame loss {best.loss} but the host computes {mse}")
    return launches


def phase_template_optimizer(torch, sr, dev):
    """Phase 10: the template constant optimizer at 64 islands; kernel #5."""
    ncycles = TEMPLATE_OPT_CYCLES
    options = template_options(sr, ncycles, populations=ISLANDS // 8,
                               optimizer_probability=0.14)
    f_calls = []

    def record(engine):
        optimize = engine._optimize

        def recorded(*a, **kw):
            pops, calls = optimize(*a, **kw)
            f_calls.append(float(calls))
            return pops, calls

        engine._optimize = recorded

    iters = 1
    launches, state, engine, evals = run_engine(torch, sr, dev, options, iters,
                                                data=template_data(), on_engine=record)
    passes = options.optimizer_iterations + 1
    expected5 = iters * 3 * passes
    expected4 = iters * 3 * (ncycles + 1 + passes + options.optimizer_iterations)
    print(f"  expected program_predict_vjp {expected5}, program_predict {expected4}")
    if launches != expect(launches, program_predict_vjp=expected5, program_predict=expected4):
        raise RuntimeError(f"template optimizer launched {launches}")
    print(f"  launches in the optimizer: #5 {launches['program_predict_vjp']}, #4 "
          f"{launches['program_predict'] - iters * 3 * (ncycles + 1)}")
    print(f"  optimizer f_calls {sum(f_calls):.0f} of {evals:.0f} evaluations in {iters} "
          f"iteration(s): {sum(f_calls) / evals:.1%}")
    return launches


def phase_template_search(torch, sr, dev):
    """Phase 11: a composition structure through equation_search."""
    X, y = template_data()
    y = (np.cos(1.5 * X[:, 0]) * X[:, 1]).astype(np.float32)
    options = template_options(sr, 20, populations=32, population_size=64,
                               tournament_selection_n=8, optimizer_probability=0.14,
                               combiner=lambda f, g, x1, x2: g(f(x1), x2))
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    before = FE.PROGRAM_PREDICT_VJP.launches
    t0 = time.perf_counter()
    hof = sr.equation_search(X, y, options=options, niterations=2, seed=0, device=dev)
    best = min(hof.entries, key=lambda e: e.loss)
    print(f"  g(f(x1), x2) on y = cos(1.5 x1) x2: {time.perf_counter() - t0:.2f} s, best loss "
          f"{best.loss:.6g} at complexity {best.complexity}: {best.equation_string()}")
    if not np.isfinite(best.loss) or FE.PROGRAM_PREDICT_VJP.launches == before:
        raise RuntimeError("the composition search returned no finite loss or ran no #5")


# ---------------------------------------------------------------------------
# Parametric expressions (kernel #1's parametric form) and template
# parameters
# ---------------------------------------------------------------------------


def parametric_data():
    """The JAX package's parametric cell data (bench/cell.py, variant
    "parametric"): 10,000 rows x 2 features from seed 1234 uniform on
    [-2, 2], class = integers(0, 3), y = amp[class] cos(x1) + x2 with
    amp = [1, 2, 3]."""
    rng = np.random.default_rng(1234)
    X = rng.uniform(-2.0, 2.0, (N_ROWS, 2)).astype(np.float32)
    cls = rng.integers(0, 3, N_ROWS)
    y = (np.array([1.0, 2.0, 3.0], np.float32)[cls] * np.cos(X[:, 0]) + X[:, 1]).astype(
        np.float32)
    return X, y, cls


def parametric_options(sr, ncycles: int, populations: int = 0, **kw):
    """bench/cell.py FULL with variant "parametric": max_parameters 1,
    optimizer_probability 0 unless given; ``populations`` 0 means ISLANDS."""
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=30,
                populations=populations or ISLANDS, population_size=256,
                tournament_selection_n=16, ncycles_per_iteration=ncycles,
                optimizer_probability=0.0,
                expression_spec=sr.ParametricExpressionSpec(max_parameters=1),
                save_to_file=False)
    base.update(kw)
    return sr.Options(**base)


def param_kernel_inputs(torch, sr, dev):
    """Kernel #1p's inputs (phases 12 and 16): 16,384 random parametric
    trees (F = 2, NP = 2, NC = 3), 10,000 rows, every fifth tree's const_ok
    cleared, every 97th row's X at +-OVERFLOW, every 11th tree's bank +inf
    for class 2 only."""
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.population import init_population
    from symbolicregression_jl_tpu_torch.evolve.step import evolve_config_from_options
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.ops.program import compile_program

    F, NP, NC, n = 2, 2, 3, N_ROWS
    options = parametric_options(sr, 1)
    cfg = evolve_config_from_options(options, F, dev, n_params=NP, n_classes=NC)
    T = ISLANDS * 2 * 16      # the cycle's candidates: islands x 2 x ceil(256 / 16)
    trees = init_population(rng.split(rng.key(7, device=dev), 64), T // 64, cfg.mctx,
                            nlength=5).reshape(-1)
    ops, el = options.operators, options.elementwise_loss
    g = torch.Generator(device=dev).manual_seed(12)
    X = torch.rand((F, n), generator=g, device=dev) * 4 - 2
    big = X[:, ::97]
    big.copy_(torch.where(big < 0, -OVERFLOW, OVERFLOW))
    y = torch.randn(n, generator=g, device=dev)
    cls = torch.randint(0, NC, (n,), generator=g, device=dev, dtype=torch.int32)
    bank = torch.randn((T, NP, NC), generator=g, device=dev)
    bank[::11, :, 2] = torch.inf
    prog = compile_program(trees, F, len(ops.binary), n_params=NP)
    instr, nsteps, cvals, ok, Xc, yc, w = FE._launch_inputs(prog, X, y, None, F, ops, NP)
    ok = ok.clone()
    ok[::5] = 0
    return options, trees, X, y, (instr, nsteps, cvals, ok, bank, cls, Xc, yc, w)


def phase_param_kernel(torch, sr, dev):
    """Phase 12: kernel #1's parametric form against its plain version."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.ops.program import compile_program

    F, NP, NC, n = 2, 2, 3, N_ROWS
    options, trees, X, y, args = param_kernel_inputs(torch, sr, dev)
    instr, nsteps, cvals, ok, bank, cls, Xc, yc, w = args
    T = trees.length.shape[0]
    ops, el = options.operators, options.elementwise_loss

    kernel = FE.PROGRAM_EVAL_PARAM
    lk, vk = kernel(*args, ops, el)
    lk2, vk2 = kernel(*args, ops, el)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp, vp = FE.program_eval_plain(instr, nsteps, cvals, ok, Xc, yc, w, ops, el, bank=bank,
                                   class_idx=cls)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    check = Checks()
    check("two launches bit-identical", same(torch, lk, lk2) and same(torch, vk, vk2))
    check("validity bit-equal", same(torch, vk, vp))
    check("loss sums NaN and +-inf in the same places", nonfinite_match(torch, lk, lp))
    same_inf, within, rel, abs_err = close(torch, torch.where(vp, lk, torch.inf),
                                           torch.where(vp, lp, torch.inf))
    check(f"loss sum within rtol {RTOL} on valid trees (max rel err {rel:.3g})", within)
    ms = cuda_ms(torch, lambda: kernel(*args, ops, el), reps=10)

    # #1 (NP = 0) on the same trees: their parameter leaves alias constants.
    prog0 = compile_program(trees, F, len(ops.binary))
    args0 = FE._launch_inputs(prog0, X, y, None, F, ops)
    FE.PROGRAM_EVAL(*args0, ops, el)
    ms0 = cuda_ms(torch, lambda: FE.PROGRAM_EVAL(*args0, ops, el), reps=10)

    L, CMAX = instr.shape[1], cvals.shape[1]
    steps = float(nsteps.to(torch.float64).sum())
    ops_count = steps * n + 4.0 * n * T       # one op per step and row; loss d*d*w + sum
    bytes_moved = 4.0 * (T * L + 3 * T + T * CMAX + T * NP * NC + n + F * n + 2 * n + T)
    bound_ms, bound_by = bound(ops_count, bytes_moved)
    pleaf = ((trees.arity == 0) & (trees.op == 2)
             & (torch.arange(trees.max_nodes, device=dev) < trees.length[:, None])).any(-1)
    print(f"  {T} parametric trees (F = {F}, NP = {NP}, NC = {NC}), {n} rows, L = {L}, "
          f"mean steps {steps / T:.3f}, {int(pleaf.sum())} with parameter leaves; "
          f"{int(vk.sum())} of {T} valid ({int((ok == 0).sum())} with const_ok cleared, "
          f"{int((~torch.isfinite(bank).all(-1).all(-1)).sum())} with a non-finite bank entry)")
    print(f"  #1p program_eval_param: {ms:.4f} ms{was(kernel.name)} (CUDA events, mean of 10), "
          f"plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}: {ops_count:.4g} FP32 ops, "
          f"{bytes_moved:.4g} bytes); #1 (NP = 0, parameter leaves as constants) on the same "
          f"trees {ms0:.4f} ms")
    check.raise_if_failed("kernel #1p")
    return {"name": kernel.name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces, "launches": None, "max_abs_err": abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def phase_parametric_main_path(torch, sr, dev):
    """Phase 13: the parametric cell at full width; kernel #1p only."""
    ncycles = TEMPLATE_CYCLES
    options = parametric_options(sr, ncycles)
    X, y, cls = parametric_data()
    iters = 2
    launches, state, engine, _ = run_engine(torch, sr, dev, options, iters, data=(X, y),
                                            extra={"class": cls})
    expected = {name: 0 for name in launches}
    expected["program_eval_param"] = iters * (ncycles + 1)
    print(f"  expected {expected}")
    if launches != expected:
        raise RuntimeError(f"parametric path launched {launches}, expected {expected}")
    hof = sr.HallOfFame.from_device(state.hof, options.operators)
    best = min(hof.entries, key=lambda e: e.loss)
    print(f"  best: loss {best.loss:.6g} at complexity {best.complexity}: "
          f"{best.equation_string()}, bank {np.array2string(best.params, precision=5)}")
    if best.params is None or best.params.shape != (1, 3):
        raise RuntimeError("the best member carries no (1, 3) parameter bank")
    return launches


def phase_parametric_optimizer(torch, sr, dev):
    """Phase 14: the parametric constant optimizer (eager BFGS over the
    constants and the banks) at 64 islands and 10 cycles."""
    options = parametric_options(sr, TEMPLATE_OPT_CYCLES, populations=ISLANDS // 8,
                                 optimizer_probability=0.14)
    X, y, cls = parametric_data()
    f_calls = []

    def record(engine):
        optimize = engine._optimize

        def recorded(*a, **kw):
            pops, calls = optimize(*a, **kw)
            f_calls.append(float(calls))
            return pops, calls

        engine._optimize = recorded

    iters = 1
    t0 = time.perf_counter()
    launches, _, _, evals = run_engine(torch, sr, dev, options, iters, data=(X, y),
                                       extra={"class": cls}, on_engine=record)
    if launches["program_eval_param"] != iters * (TEMPLATE_OPT_CYCLES + 1) or any(
            v for k, v in launches.items() if k != "program_eval_param"):
        raise RuntimeError(f"parametric optimizer path launched {launches}")
    print(f"  optimizer f_calls {sum(f_calls):.0f} of {evals:.0f} evaluations in {iters} "
          f"iteration(s): {sum(f_calls) / evals:.1%}; phase {time.perf_counter() - t0:.1f} s")


def phase_plugin_searches(torch, sr, dev):
    """Phase 15: a parametric search and a template search with
    parameters through equation_search on the card."""
    from symbolicregression_jl_tpu_torch.models import template_spec
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    # tests/test_parametric.py:60-84: per-class offsets.
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (128, 2)).astype(np.float32)
    cls = rng.integers(0, 3, 128)
    y = (X[:, 0] * 1.5 + np.array([0.5, -1.0, 2.0])[cls]).astype(np.float32)
    o = sr.Options(binary_operators=["+", "*"], unary_operators=[], maxsize=8, populations=2,
                   population_size=12, ncycles_per_iteration=10, tournament_selection_n=4,
                   expression_spec=sr.ParametricExpressionSpec(max_parameters=1),
                   optimizer_probability=0.5, optimizer_iterations=4, save_to_file=False)
    before = FE.PROGRAM_EVAL_PARAM.launches
    t0 = time.perf_counter()
    hof = sr.equation_search(X, y, options=o, niterations=12, seed=0, extra={"class": cls},
                             device=dev)
    best = min(hof.entries, key=lambda e: e.loss)
    print(f"  parametric, y = 1.5 x1 + offset[class]: {time.perf_counter() - t0:.2f} s, best "
          f"loss {best.loss:.6g}: {best.equation_string()}, bank "
          f"{np.array2string(best.params, precision=5)}")
    if not best.loss < 0.05 or best.params is None or best.params.shape != (1, 3) \
            or FE.PROGRAM_EVAL_PARAM.launches == before:
        raise RuntimeError("the parametric search missed the test's threshold (loss < 0.05, "
                           "a (1, 3) bank) or ran no #1p")

    # tests/test_template.py:249-276: f(x1) + p[0] x2 + p[1].
    spec = template_spec(expressions=("f",), parameters={"p": 2})(
        lambda f, x1, x2, p: f(x1) + p[0] * x2 + p[1])
    rng = np.random.default_rng(1)
    X = rng.uniform(-2, 2, (200, 2)).astype(np.float32)
    y = (X[:, 0] ** 2 + 3.0 * X[:, 1] - 0.5).astype(np.float32)
    o = sr.Options(binary_operators=["+", "-", "*"], unary_operators=[], maxsize=8,
                   populations=4, population_size=20, ncycles_per_iteration=8,
                   optimizer_probability=0.3, expression_spec=spec, save_to_file=False)
    t0 = time.perf_counter()
    hof = sr.equation_search(X, y, options=o, niterations=8, seed=0, device=dev)
    best = min(hof.entries, key=lambda e: e.loss)
    params = best.template_expr.params
    print(f"  template with parameters, y = x1^2 + 3 x2 - 0.5: {time.perf_counter() - t0:.2f} "
          f"s, best loss {best.loss:.6g}: {best.equation_string()}")
    if not best.loss < 1e-6 or params is None or not np.allclose(sorted(params), [-0.5, 3.0],
                                                                   atol=1e-2):
        raise RuntimeError("the template search with parameters missed the test's thresholds "
                           "(loss < 1e-6, p = [3, -0.5] within 1e-2)")


# ---------------------------------------------------------------------------
# graftstage: bf16 value buffers (kernels 1b and 2b) and staged evaluation
# ---------------------------------------------------------------------------

STAGE_CELLS = ("plain", "plain-staged", "plain-bf16", "plain-staged-bf16")
STAGE_LS_CYCLES = 10                # phase 18's cut depth (the optimizer runs once per iteration)
BF16_TRANSCENDENTAL_MEDIAN = 1e-4   # kernel vs plain, trees with a transcendental step
BF16_TRANSCENDENTAL_MAX = 1e-2


def inexact_trees(torch, instr, nsteps, operators):
    """[T] bool: a live step applies a unary operator other than abs, whose
    float32 value the kernel and the plain version may round an ULP apart;
    such an ULP can flip one bf16 rounding (2^-8 relative)."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    tab = torch.tensor(FE._optab_list(operators), device=instr.device)
    mask = 0x3F if FE._dispatch_plan(operators).merged else 0x7F
    entry = tab[((instr >> 24) & mask).long()]
    live = torch.arange(instr.shape[1], device=instr.device)[None, :] < nsteps[:, None]
    unary = ((entry >> 8) == FE._K_UNARY) & ((entry & 0xFF) != FE._KERNEL_OP_IDS["abs"])
    return (live & unary).any(dim=1)


def bf16_close(torch, a, b, inexact):
    """Kernel 1b/2b against its plain bf16 version: NaN and +-inf in the
    same places; on trees of exact operators (+ - * / abs) within rtol
    1e-5 (the same stored bf16 bits, rows summed in another order); on the
    others a median relative error below BF16_TRANSCENDENTAL_MEDIAN and
    every one below BF16_TRANSCENDENTAL_MAX. Returns (ok, worst relative
    error on exact trees, median and worst on the others, worst absolute
    error)."""
    if not nonfinite_match(torch, a, b):
        return False, float("inf"), float("inf"), float("inf"), float("inf")
    ex = ~inexact.reshape(inexact.shape + (1,) * (a.dim() - 1)).expand_as(a)
    fin = torch.isfinite(b)
    err = (a - b).abs()
    rel = err / b.abs().clamp(min=1e-30)
    r_ex = rel[fin & ex]
    r_in = rel[fin & ~ex]
    worst_ex = float(r_ex.max()) if r_ex.numel() else 0.0
    med_in = float(r_in.median()) if r_in.numel() else 0.0
    worst_in = float(r_in.max()) if r_in.numel() else 0.0
    ok = (worst_ex <= RTOL and med_in < BF16_TRANSCENDENTAL_MEDIAN
          and worst_in < BF16_TRANSCENDENTAL_MAX)
    return ok, worst_ex, med_in, worst_in, float(err[fin].max()) if fin.any() else 0.0


def rank_contract(torch, f32, b16):
    """tests/test_staged_eval.py's contract of bf16 against f32 on the same
    inputs: finite verdicts agree on 90%, median relative error below 0.02,
    top-quartile overlap at least 75%. Returns (ok, median relative error,
    overlap fraction, finite-agreement fraction)."""
    a, b = f32.double(), b16.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    agree = float((fa == fb).double().mean())
    both = fa & fb
    rel = ((b - a).abs() / (a.abs() + 1e-6))[both]
    med = float(rel.median()) if rel.numel() else 0.0
    k = max(1, int(both.sum()) // 4)
    top_a = set(torch.argsort(torch.where(both, a, torch.inf))[:k].tolist())
    top_b = set(torch.argsort(torch.where(both, b, torch.inf))[:k].tolist())
    overlap = len(top_a & top_b) / k
    return agree >= 0.9 and med < 0.02 and overlap >= 0.75, med, overlap, agree


def phase_bf16_kernels(torch, sr, dev):
    """Phase 16: kernels 1b (cost, plain and parametric forms) and 2b
    against their plain bf16 versions at phases 3, 12 and 4's shapes, and
    against kernels #1/#1p/#2 in float32 on the same inputs (the rank
    contract)."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    check = Checks()
    _same = lambda a, b: same(torch, a, b)
    rows = []

    # 1b, cost and plain forms, on phase 3's inputs.
    options, data, trees, cx, prog, args, scal, cxf = kernel1_inputs(torch, sr, dev)
    ops, el = options.operators, options.elementwise_loss
    argsb = args[:4] + (FE._bf16_rows(args[4]),) + args[5:]
    T = trees.length.shape[0]
    n = N_ROWS
    inexact = inexact_trees(torch, args[0], args[1], ops)
    k1b = FE.PROGRAM_EVAL_BF16
    lk, vk = k1b(*argsb, ops, el)
    lk2, vk2 = k1b(*argsb, ops, el)
    lck, vck, ck = k1b(*argsb, ops, el, cx=cxf, scal=scal)
    lck2, vck2, ck2 = k1b(*argsb, ops, el, cx=cxf, scal=scal)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lcp, vcp, cp = FE.program_eval_plain(*argsb, ops, el, cx=cxf, scal=scal, bf16=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    lp, vp = FE.program_eval_plain(*argsb, ops, el, bf16=True)
    check("1b two launches bit-identical (plain and cost forms)",
          _same(lk, lk2) and _same(vk, vk2) and _same(lck, lck2) and _same(ck, ck2))
    check("1b validity bit-equal (plain and cost forms)", _same(vk, vp) and _same(vck, vcp))
    errs = []
    for what, a, b in (("plain-form loss sum", torch.where(vp, lk, torch.inf),
                        torch.where(vp, lp, torch.inf)),
                       ("cost-form loss", lck, lcp), ("cost", ck, cp)):
        ok, wex, med, win, aerr = bf16_close(torch, a, b, inexact)
        errs.append(aerr)
        check(f"1b {what}: non-finite in the same places; + - * / abs trees within rtol "
              f"{RTOL} (worst {wex:.3g}); {int(inexact.sum())} transcendental trees median "
              f"{med:.3g} < {BF16_TRANSCENDENTAL_MEDIAN:g}, worst {win:.3g} < "
              f"{BF16_TRANSCENDENTAL_MAX:g}", ok)
    l32, v32, c32 = FE.PROGRAM_EVAL(*args, ops, el, cx=cxf, scal=scal)
    ok, med, overlap, agree = rank_contract(torch, c32, ck)
    check(f"1b rank contract against #1 (cost): finite verdicts agree {agree:.4f} >= 0.9, "
          f"median relative error {med:.3g} < 0.02, top-quartile overlap {overlap:.4f} >= 0.75",
          ok)
    ms = cuda_ms(torch, lambda: k1b(*argsb, ops, el, cx=cxf, scal=scal), reps=10)
    ms32 = cuda_ms(torch, lambda: FE.PROGRAM_EVAL(*args, ops, el, cx=cxf, scal=scal), reps=10)
    L, CMAX = args[0].shape[1], args[2].shape[1]
    step_rows = float(prog.nsteps.to(torch.float64).sum()) * n
    ops_count = step_rows + 4.0 * n * T
    bytes_moved = (4.0 * (T * L + T + T * CMAX + T + 2 * n + T + 3 + 3 * T)
                   + 2.0 * N_FEATURES * n)          # X in bf16
    b1, by1 = bound(ops_count, bytes_moved)
    print(f"  1b program_eval_bf16 (cost form, {T} trees x {n} rows, "
          f"{int(vck.sum())} valid): {ms:.4f} ms{was(k1b.name)} (CUDA events, mean of 10), #1 "
          f"on the same "
          f"inputs {ms32:.4f} ms, plain {plain_ms:.1f} ms, bound {b1:.4f} ms ({by1})")
    rows.append({"name": k1b.name, "route": "cuda", "source": k1b.source,
                 "replaces": k1b.replaces, "launches": None, "max_abs_err": max(errs), "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b1, "bound_by": by1, "library_ms": None})
    del args, argsb
    torch.cuda.empty_cache()

    # 1b, parametric form, on phase 12's inputs.
    poptions, ptrees, X, y, pargs = param_kernel_inputs(torch, sr, dev)
    instr, nsteps, cvals, ok_, bank, cls, Xc, yc, w = pargs
    pops, pel = poptions.operators, poptions.elementwise_loss
    Xb = FE._bf16_rows(Xc)
    kp = FE.PROGRAM_EVAL_PARAM_BF16
    call = lambda: kp(instr, nsteps, cvals, ok_, bank, cls, Xb, yc, w, pops, pel)
    pk, pv = call()
    pk2, pv2 = call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qk, qv = FE.program_eval_plain(instr, nsteps, cvals, ok_, Xb, yc, w, pops, pel, bank=bank,
                                   class_idx=cls, bf16=True)
    torch.cuda.synchronize()
    pplain_ms = (time.perf_counter() - t0) * 1e3
    pin = inexact_trees(torch, instr, nsteps, pops)
    check("1b parametric: two launches bit-identical", _same(pk, pk2) and _same(pv, pv2))
    check("1b parametric: validity bit-equal", _same(pv, qv))
    ok, wex, med, win, perr = bf16_close(torch, torch.where(qv, pk, torch.inf),
                                         torch.where(qv, qk, torch.inf), pin)
    check(f"1b parametric loss sum: + - * trees within rtol {RTOL} (worst {wex:.3g}); "
          f"transcendental trees median {med:.3g}, worst {win:.3g}", ok)
    p32, pv32 = FE.PROGRAM_EVAL_PARAM(*pargs, pops, pel)
    ok, med, overlap, agree = rank_contract(torch, torch.where(pv32, p32, torch.inf),
                                            torch.where(pv, pk, torch.inf))
    check(f"1b parametric rank contract against #1p: agree {agree:.4f}, median {med:.3g}, "
          f"overlap {overlap:.4f}", ok)
    pms = cuda_ms(torch, call, reps=10)
    pms32 = cuda_ms(torch, lambda: FE.PROGRAM_EVAL_PARAM(*pargs, pops, pel), reps=10)
    PT, PL, PC = instr.shape[0], instr.shape[1], cvals.shape[1]
    steps = float(nsteps.to(torch.float64).sum())
    bp, byp = bound(steps * n + 4.0 * n * PT,
                    4.0 * (PT * PL + 3 * PT + PT * PC + PT * 2 * 3 + n + 2 * n + PT)
                    + 2.0 * 2 * n)
    print(f"  1b program_eval_param_bf16 ({PT} trees, {int(pv.sum())} valid): {pms:.4f} ms"
          f"{was(kp.name)} "
          f"(CUDA events, mean of 10), #1p on the same inputs {pms32:.4f} ms, plain "
          f"{pplain_ms:.1f} ms, bound {bp:.4f} ms ({byp})")
    rows.append({"name": kp.name, "route": "cuda", "source": kp.source, "replaces": kp.replaces,
                 "launches": None, "max_abs_err": perr, "ms": pms, "plain_ms": pplain_ms,
                 "bound_ms": bp, "bound_by": byp, "library_ms": None})
    del pargs, Xb
    torch.cuda.empty_cache()

    # 2b on phase 4's inputs.
    (moptions, mtrees, mprog, (instr, nsteps, cvals, _, Xt, yt, w), nconst, R, V_ls, cv_ls,
     _) = opt_kernel_inputs(torch, sr, dev)
    mops, mel = moptions.operators, moptions.elementwise_loss
    Xb = FE._bf16_rows(Xt)
    k2b = FE.PROGRAM_MULTI_BF16
    mk, mv = k2b(instr, nsteps, cv_ls, Xb, yt, w, mops, mel)
    mk2, mv2 = k2b(instr, nsteps, cv_ls, Xb, yt, w, mops, mel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mp, mvp = FE.program_multi_plain(instr, nsteps, cv_ls, Xb, yt, w, mops, mel, bf16=True)
    torch.cuda.synchronize()
    mplain_ms = (time.perf_counter() - t0) * 1e3
    MT = instr.shape[0]
    min_ = inexact_trees(torch, instr, nsteps, mops)
    check("2b two launches bit-identical", _same(mk, mk2) and _same(mv, mv2))
    check("2b validity bit-equal", _same(mv, mvp))
    ok, wex, med, win, merr = bf16_close(torch, torch.where(mvp, mk, torch.inf),
                                         torch.where(mvp, mp, torch.inf), min_)
    check(f"2b loss sums: + - * / abs trees within rtol {RTOL} (worst {wex:.3g}); "
          f"transcendental trees median {med:.3g}, worst {win:.3g}", ok)
    ones = torch.ones(MT, dtype=torch.int32, device=dev)
    l1, v1 = k2b(instr, nsteps, cvals[:, None, :].contiguous(), Xb, yt, w, mops, mel)
    l1e, v1e = k1b(instr, nsteps, cvals, ones, Xb, yt, w, mops, mel)
    check("2b with V = 1 == 1b's plain form (bit)", _same(l1[:, 0], l1e) and _same(v1[:, 0], v1e))
    m32, mv32 = FE.PROGRAM_MULTI(instr, nsteps, cv_ls, Xt, yt, w, mops, mel)
    ok, med, overlap, agree = rank_contract(
        torch, torch.where(mv32, m32, torch.inf).reshape(-1),
        torch.where(mv, mk, torch.inf).reshape(-1))
    check(f"2b rank contract against #2: agree {agree:.4f}, median {med:.3g}, overlap "
          f"{overlap:.4f}", ok)
    mms = cuda_ms(torch, lambda: k2b(instr, nsteps, cv_ls, Xb, yt, w, mops, mel), reps=5)
    mms32 = cuda_ms(torch, lambda: FE.PROGRAM_MULTI(instr, nsteps, cv_ls, Xt, yt, w, mops, mel),
                    reps=5)
    ML, MC = instr.shape[1], cvals.shape[1]
    msteps = float(nsteps.to(torch.float64).sum())
    b2, by2 = bound((msteps + 4.0 * MT) * V_ls * n,
                    4.0 * (MT * ML + MT + MT * V_ls * MC + 2 * n + 2 * MT * V_ls)
                    + 2.0 * N_FEATURES * n)
    print(f"  2b program_multi_bf16 ({MT} trees x V = {V_ls}, {int(mv.sum())} of {mv.numel()} "
          f"pairs valid): {mms:.4f} ms{was(k2b.name)} (CUDA events, mean of 5), #2 on the same "
          f"inputs "
          f"{mms32:.4f} ms, plain {mplain_ms:.1f} ms, bound {b2:.4f} ms ({by2})")
    rows.append({"name": k2b.name, "route": "cuda", "source": k2b.source,
                 "replaces": k2b.replaces, "launches": None, "max_abs_err": merr, "ms": mms,
                 "plain_ms": mplain_ms, "bound_ms": b2, "bound_by": by2, "library_ms": None})
    check.raise_if_failed("kernels 1b and 2b")
    return rows


def stage_data():
    """The JAX package's plain cell data (bench/cell.py, variant "plain"):
    10,000 rows x 2 features from seed 1234 uniform on [-2, 2],
    y = cos(2.13 x1) + 0.5 x2."""
    rng = np.random.default_rng(1234)
    X = rng.uniform(-2.0, 2.0, (N_ROWS, 2)).astype(np.float32)
    y = (np.cos(2.13 * X[:, 0]) + 0.5 * X[:, 1]).astype(np.float32)
    return X, y


def stage_options(sr, variant: str, ncycles: int, populations: int = 0, **kw):
    """bench/cell.py FULL with one of the plain variants: 512 islands x 256
    members, tournament 16, maxsize 30, + - * and cos, optimizer_probability
    0; staging at the default fraction 0.125 (1,250 sample rows) and
    rescore fraction 0.25."""
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=30,
                populations=populations or ISLANDS, population_size=256,
                tournament_selection_n=16, ncycles_per_iteration=ncycles,
                optimizer_probability=0.0,
                eval_precision="bf16" if variant.endswith("bf16") else "f32",
                staged_eval="staged" in variant, save_to_file=False)
    base.update(kw)
    return sr.Options(**base)


def phase_stage_cells(torch, sr, dev, ncycles: int):
    """Phase 17: the four graftstage cells at full width. Launches per
    iteration exact; after the staged runs every population cost equals an
    unstaged re-eval at the same precision within rtol 1e-5."""
    from symbolicregression_jl_tpu_torch.evolve.step import rescore_count, resolve_sample_rows

    iters = 2
    out = {}
    for variant in STAGE_CELLS:
        print(f"  -- {variant}")
        options = stage_options(sr, variant, ncycles)
        launches, state, engine, _ = run_engine(torch, sr, dev, options, iters,
                                                data=stage_data())
        staged = engine.cfg.staged_eval
        per_iter = (2 if staged else 1) * ncycles + 1
        kernel = "program_eval_bf16" if engine.cfg.eval_bf16 else "program_eval"
        expected = expect(launches, **{kernel: iters * per_iter})
        print(f"  expected {expected}")
        if launches != expected:
            raise RuntimeError(f"{variant} launched {launches}, expected {expected}")
        if staged:
            n_cand = 2 * engine.cfg.n_slots
            print(f"  screen {resolve_sample_rows(engine.cfg, N_ROWS)} of {N_ROWS} rows; "
                  f"rescore {rescore_count(engine.cfg, n_cand)} of up to {n_cand} candidates "
                  f"per island")
            I, P = state.pops.cost.shape
            ds = sr.make_dataset(*stage_data(), device=dev)
            ds.update_baseline_loss(options.elementwise_loss)
            flat = state.pops.trees.reshape(-1)
            params = state.pops.params.reshape(I * P, *state.pops.params.shape[2:])
            cost = state.pops.cost.reshape(-1)
            c_ref, _, _ = engine._eval(flat, params, ds.data, fuse_cost=engine.cfg.fuse_cost)
            fin = torch.isfinite(c_ref)
            good = nonfinite_match(torch, cost, c_ref) and bool(
                ((cost - c_ref).abs()[fin] <= 1e-5 * c_ref.abs()[fin]).all())
            print(f"  population costs == an unstaged re-eval at the same precision (rtol 1e-5; "
                  f"{int(fin.sum())} of {fin.numel()} finite): {'ok' if good else 'FAILED'}")
            if not good:
                raise RuntimeError(f"{variant}: a population cost is not its full-data cost")
        print(f"  hall of fame best loss {best_loss(state):.6g}")
        out[variant] = launches
        del state, engine
        torch.cuda.empty_cache()
    return out


def phase_bf16_line_search(torch, sr, dev, ncycles: int, f32_best: float):
    """Phase 18: phase 5's configuration with the bf16 line search, cut
    depth: 2b once per L-BFGS iteration, #3 once more, #2 never."""
    options = bench_options(sr, ncycles, optimizer_bf16_linesearch=True)
    f_calls = []

    def record(engine):
        if not engine.opt_cfg.ls_bf16:
            raise RuntimeError("the engine on the card did not take the bf16 line search")
        optimize = engine._optimize

        def recorded(*a, **kw):
            pops, calls = optimize(*a, **kw)
            f_calls.append(float(calls))
            return pops, calls

        engine._optimize = recorded

    iters = 2
    launches, state, _, evals = run_engine(torch, sr, dev, options, iters, on_engine=record)
    it = options.optimizer_iterations
    expected = expect(launches, program_eval=iters * (ncycles + 1),
                      program_multi_bf16=iters * it, program_grad=iters * (it + 1))
    print(f"  expected {expected}")
    if launches != expected:
        raise RuntimeError(f"bf16 line search launched {launches}, expected {expected}")
    print(f"  optimizer f_calls {sum(f_calls[-iters:]):.0f} of {evals:.0f} evaluations in "
          f"{iters} iterations: {sum(f_calls[-iters:]) / evals:.1%}")
    print(f"  hall of fame best loss {best_loss(state):.6g} ({ncycles} cycles, bf16 line "
          f"search); phase 5 (float32 line search, its depth) {f32_best:.6g}")
    return launches


def host_predict(torch, node, X64, params=None, cls=None):
    """A decoded tree's predictions in float64 on the host: X64 [n, F]; a
    parameter leaf reads ``params[p, cls[r]]``."""
    if node.degree == 0:
        if node.is_parameter:
            return torch.from_numpy(params[node.parameter][cls].astype(np.float64))
        if node.constant:
            return torch.full((X64.shape[0],), float(node.val), dtype=torch.float64)
        return torch.from_numpy(X64[:, node.feature])
    return node.op.fn(*[host_predict(torch, c, X64, params, cls) for c in node.children])


# The reported loss comes from the bf16 finalize, so it differs from the
# host's float64 loss by the bf16 storage error of the predictions p_b:
# |sqrt(reported) - sqrt(host)| <= RMS(p_b - p) (the triangle inequality in
# L2). A stored value is off by at most 2^-9 relative; allowing 16 such
# roundings through the tree, RMS(p_b - p) <= 2^-5 RMS(y) for the fits a
# search keeps. A broken path (another tree, other rows, a wrong root)
# misses by O(RMS(y)).
BF16_SEARCH_TOL = 2.0 ** -5


def check_host_loss(torch, best, X, y, what, cls=None):
    """Fails where the hall of fame's loss of ``best`` is off its float64
    host recomputation by more than BF16_SEARCH_TOL RMS(y) in root terms."""
    p = host_predict(torch, best.tree, X.astype(np.float64), best.params, cls).numpy()
    host = float(np.mean((p - y.astype(np.float64)) ** 2))
    gap = abs(np.sqrt(best.loss) - np.sqrt(host))
    tol = BF16_SEARCH_TOL * float(np.sqrt(np.mean(y.astype(np.float64) ** 2)))
    print(f"  {what}: reported loss {best.loss:.6g}, host float64 {host:.6g}; "
          f"|sqrt difference| {gap:.3g} <= {tol:.3g}")
    if not gap <= tol:
        raise RuntimeError(f"{what}: reported loss {best.loss} but the host computes {host}")


def phase_stage_search(torch, sr, dev):
    """Phase 19: equation_search with all three graftstage options on the
    plain cell's problem at a small size, and on phase 15's parametric
    problem (kernel 1b's parametric form)."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    X, y = stage_data()
    options = stage_options(sr, "plain-staged-bf16", 30, populations=16, population_size=64,
                            tournament_selection_n=8, optimizer_probability=0.14,
                            optimizer_bf16_linesearch=True)
    for k in kernels():
        k.launches = 0
    t0 = time.perf_counter()
    hof = sr.equation_search(X, y, options=options, niterations=3, seed=0, device=dev)
    launches = {k.name: k.launches for k in kernels()}
    best = min(hof.entries, key=lambda e: e.loss)
    print(f"  staged + bf16 + bf16 line search, 16 x 64, {N_ROWS} rows: "
          f"{time.perf_counter() - t0:.2f} s, best loss {best.loss:.6g} at complexity "
          f"{best.complexity}: {best.equation_string()}")
    print(f"  launches {launches}")
    if not (launches["program_eval_bf16"] and launches["program_multi_bf16"]) or \
            launches["program_eval"] or launches["program_multi"]:
        raise RuntimeError("the search did not run on kernels 1b and 2b alone")
    check_host_loss(torch, best, X, y, "plain")

    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (128, 2)).astype(np.float32)
    cls = rng.integers(0, 3, 128)
    y = (X[:, 0] * 1.5 + np.array([0.5, -1.0, 2.0])[cls]).astype(np.float32)
    o = sr.Options(binary_operators=["+", "*"], unary_operators=[], maxsize=8, populations=2,
                   population_size=12, ncycles_per_iteration=10, tournament_selection_n=4,
                   expression_spec=sr.ParametricExpressionSpec(max_parameters=1),
                   optimizer_probability=0.5, optimizer_iterations=4, staged_eval=True,
                   eval_precision="bf16", optimizer_bf16_linesearch=True, save_to_file=False)
    for k in kernels():
        k.launches = 0
    t0 = time.perf_counter()
    hof = sr.equation_search(X, y, options=o, niterations=12, seed=0, extra={"class": cls},
                             device=dev)
    plaunches = {k.name: k.launches for k in kernels()}
    best = min(hof.entries, key=lambda e: e.loss)
    print(f"  parametric, staged + bf16, y = 1.5 x1 + offset[class]: "
          f"{time.perf_counter() - t0:.2f} s, best loss {best.loss:.6g}: "
          f"{best.equation_string()}, bank {np.array2string(best.params, precision=5)}")
    print(f"  launches {plaunches}")
    if plaunches != expect(plaunches, program_eval_param_bf16=plaunches[
            "program_eval_param_bf16"]) or not plaunches["program_eval_param_bf16"]:
        raise RuntimeError("the parametric search did not run on kernel 1b's parametric form "
                           "alone")
    if not best.loss < 0.05:
        raise RuntimeError("the parametric search missed phase 15's threshold (loss < 0.05)")
    check_host_loss(torch, best, X, y, "parametric", cls=np.searchsorted(np.unique(cls), cls))
    return launches, plaunches


# ---------------------------------------------------------------------------
# The search API: minibatches, checkpoints and resume, SRRegressor
# ---------------------------------------------------------------------------

BATCH_SIZE = 50             # Options' default batch_size
BATCH_CYCLES = 10           # phases 20-21's cut depth (one optimizer run per iteration whatever it)
CKPT_ITERS = 3              # phase 21: the uninterrupted run's iterations; the killed run stops at 2


class RowRecorder:
    """Wraps the ``__call__`` of kernels #1-#3's wrappers: records the rows
    of every launch on the card and keeps a copy of the first launch's
    arguments at each row count (to replay the path's own inputs against
    the plain versions). ``close`` restores the wrappers."""

    X_ARG = {"program_eval": 4, "program_multi": 3, "program_grad": 4}
    device_type = "cuda"   # the device whose calls are launches

    def __init__(self, torch):
        from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

        self.rows = {name: [] for name in self.X_ARG}
        self.first = {}
        self._saved = {}
        copy = lambda v: v.clone() if torch.is_tensor(v) else v
        for k in (FE.PROGRAM_EVAL, FE.PROGRAM_MULTI, FE.PROGRAM_GRAD):
            cls = type(k)
            if cls in self._saved:
                continue
            orig = cls.__call__
            self._saved[cls] = orig

            def call(wrapper, *args, _orig=orig, **kw):
                at = self.X_ARG.get(wrapper.name)
                if at is not None and args[at].device.type == self.device_type:
                    n = int(args[at].shape[-1])
                    self.rows[wrapper.name].append(n)
                    if (wrapper.name, n) not in self.first:
                        self.first[(wrapper.name, n)] = (
                            [copy(a) for a in args], {k2: copy(v) for k2, v in kw.items()})
                return _orig(wrapper, *args, **kw)

            cls.__call__ = call

    def close(self):
        for cls, orig in self._saved.items():
            cls.__call__ = orig


def eval_bound(torch, args):
    """(bound ms, bound_by) of kernel #1's cost form on ``args`` (phase 3's
    count: one operation per step and row, four for the loss term and sum;
    inputs read once, loss, validity and cost written once)."""
    instr, nsteps, cvals, _, X, _, _ = args[:7]
    T, L = instr.shape
    F, n = X.shape
    CMAX = cvals.shape[1]
    ops_count = float(nsteps.to(torch.float64).sum()) * n + 4.0 * n * T
    bytes_moved = 4.0 * (T * L + T + T * CMAX + T + F * n + 2 * n + T + 3 + 3 * T)
    return bound(ops_count, bytes_moved)


def multi_bound(torch, args):
    """(bound ms, bound_by) of kernel #2 on ``args`` (phase 4's count)."""
    instr, nsteps, cv, X = args[:4]
    T, V, CMAX = cv.shape
    L, n = instr.shape[1], X.shape[1]
    ops2 = (float(nsteps.to(torch.float64).sum()) + 4.0 * T) * V * n
    return bound(ops2, 4.0 * (T * L + T + T * V * CMAX + X.shape[0] * n + 2 * n + 2 * T * V))


def phase_batched_main_path(torch, sr, dev, kernel_rows):
    """Phase 20: phase 5's configuration with minibatches of BATCH_SIZE
    rows, BATCH_CYCLES cycles. Per iteration: #1 once per cycle on the
    batch's rows and once in the finalize on every row, #2 8 times and #3
    9 times on the batch's rows. #1-#3 replayed on the path's own 50-row
    inputs against their plain versions and timed beside phases 3 and 4's
    10,000-row times. The best member of the last finalize's population
    (scored on every row) recomputed on the host in float64."""
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE
    from symbolicregression_jl_tpu_torch.ops.encoding import decode_tree

    options = bench_options(sr, BATCH_CYCLES, batching=True, batch_size=BATCH_SIZE)
    recorder = {}
    finalized = []

    def install(engine):
        if not engine.cfg.batching or engine.cfg.batch_size != BATCH_SIZE:
            raise RuntimeError("the engine did not take the minibatch options")
        finalize = engine._finalize_costs

        def kept(pops, data):
            out = finalize(pops, data)
            finalized[:] = [out]
            return out

        engine._finalize_costs = kept
        recorder["r"] = RowRecorder(torch)

    iters = 2
    try:
        launches, _, _, _ = run_engine(torch, sr, dev, options, iters, on_engine=install)
    finally:
        if "r" in recorder:
            recorder["r"].close()
    rec = recorder["r"]
    it = options.optimizer_iterations
    expected = expect(launches, program_eval=iters * (BATCH_CYCLES + 1),
                      program_multi=iters * it, program_grad=iters * (it + 1))
    print(f"  expected {expected}")
    if launches != expected:
        raise RuntimeError(f"batched main path launched {launches}, expected {expected}")
    want_rows = {"program_eval": ([BATCH_SIZE] * BATCH_CYCLES + [N_ROWS]) * iters,
                 "program_multi": [BATCH_SIZE] * (iters * it),
                 "program_grad": [BATCH_SIZE] * (iters * (it + 1))}
    print(f"  rows per launch: #1 {rec.rows['program_eval'][:BATCH_CYCLES + 1]} (each "
          f"iteration), #2 {sorted(set(rec.rows['program_multi']))}, #3 "
          f"{sorted(set(rec.rows['program_grad']))}")
    if rec.rows != want_rows:
        raise RuntimeError(f"batched launches read rows {rec.rows}, expected {want_rows}")

    check = Checks()
    ops, el = options.operators, options.elementwise_loss
    eargs, ekw = rec.first[("program_eval", BATCH_SIZE)]
    T1 = eargs[0].shape[0]
    lk, vk, ck = FE.PROGRAM_EVAL(*eargs, **ekw)
    lk2, vk2, ck2 = FE.PROGRAM_EVAL(*eargs, **ekw)
    lp, vp, cp = FE.program_eval_plain(*eargs, **ekw)
    check("#1 (50 rows) two launches bit-identical", same(torch, lk, lk2)
          and same(torch, vk, vk2) and same(torch, ck, ck2))
    check("#1 (50 rows) validity bit-equal", same(torch, vk, vp))
    same_inf, within, rel1, abs1 = close(torch, lk, lp)
    check(f"#1 (50 rows) loss within rtol {RTOL}, inf in the same places (max rel err "
          f"{rel1:.3g})", same_inf and within)
    same_inf, within, relc, _ = close(torch, ck, cp)
    check(f"#1 (50 rows) cost within rtol {RTOL} (max rel err {relc:.3g})", same_inf and within)
    margs, _ = rec.first[("program_multi", BATCH_SIZE)]
    ml, mv = FE.PROGRAM_MULTI(*margs)
    pl, pv = FE.program_multi_plain(*margs)
    check("#2 (50 rows) validity bit-equal", same(torch, mv, pv))
    same_inf, within, rel2, abs2 = close(torch, torch.where(pv, ml, torch.inf),
                                         torch.where(pv, pl, torch.inf))
    check(f"#2 (50 rows) loss sum within rtol {RTOL} (max rel err {rel2:.3g})",
          same_inf and within)
    gargs, _ = rec.first[("program_grad", BATCH_SIZE)]
    abs3, _, gvalid = grad_checks(torch, check, " (50 rows)", tuple(gargs[:7]), ops, el)
    check.raise_if_failed("kernels #1-#3 on the batched path's inputs")

    ms1 = cuda_ms(torch, lambda: FE.PROGRAM_EVAL(*eargs, **ekw), reps=20)
    ms2 = cuda_ms(torch, lambda: FE.PROGRAM_MULTI(*margs), reps=20)
    ms3 = cuda_ms(torch, lambda: FE.PROGRAM_GRAD(*gargs), reps=20)
    b1, by1 = eval_bound(torch, eargs)
    b2, by2 = multi_bound(torch, margs)
    b3, by3, _, _ = grad_bound(torch, tuple(gargs[:7]))
    full = {r["name"]: r["ms"] for r in kernel_rows}
    T2, V2 = margs[2].shape[:2]
    T3, V3 = gargs[3].shape[:2]
    print(f"  #1 per 50-row launch ({T1} trees, cost form): {ms1:.4f} ms, bound {b1:.4f} ms "
          f"({by1}); phase 3's 10,000-row launch {full['program_eval']:.4f} ms")
    print(f"  #2 per 50-row launch ({T2} trees x V = {V2}): {ms2:.4f} ms, bound {b2:.4f} ms "
          f"({by2}); phase 4's 10,000-row launch {full['program_multi']:.4f} ms")
    print(f"  #3 per 50-row launch ({T3} trees x V = {V3}, {gvalid} pairs valid): {ms3:.4f} ms, "
          f"bound {b3:.4f} ms ({by3}); phase 4's 10,000-row launch "
          f"{full['program_grad']:.4f} ms")
    print(f"  (CUDA events, mean of 20 on the path's own first 50-row inputs; max abs err "
          f"#1 {abs1:.3g}, #2 {abs2:.3g}, #3 {abs3:.3g})")

    # The last finalize's population, scored on every row. (After it, the
    # hall of fame keeps the cycles' best with their batch losses, and
    # migration copies hall-of-fame members into the islands, as in the JAX
    # package.)
    pops = finalized[0]
    flat = pops.loss.reshape(-1)
    i = int(torch.argmin(torch.where(torch.isfinite(flat), flat, torch.inf)))
    P = options.population_size
    fields = [f[i // P, i % P].cpu().numpy() for f in pops.trees.fields()]
    tree = decode_tree(*fields, ops)
    X, y = bench_data()
    p = host_predict(torch, tree, X.astype(np.float64)).numpy()
    host = float(np.mean((p - y.astype(np.float64)) ** 2))
    got = float(flat[i])
    print(f"  the last finalize's best member {sr.string_tree(tree)}: loss {got:.8g} (all "
          f"rows), host float64 {host:.8g}")
    if not abs(got - host) <= RTOL * abs(host):
        raise RuntimeError(f"the finalize's loss {got} is off the host's {host}")
    return launches


def state_tensors(torch, state):
    """The tensors of a SearchDeviceState, in field order."""
    from symbolicregression_jl_tpu_torch.api.checkpoint import map_arrays

    out = []
    map_arrays(state, lambda t: out.append(t) or t)
    return out


def phase_checkpoint_resume(torch, sr, dev, out_base):
    """Phase 21: equation_search at phase 20's configuration without
    minibatches, BATCH_CYCLES cycles, writing CSVs and a checkpoint every
    iteration under ``out_base``: CKPT_ITERS iterations straight through
    against CKPT_ITERS - 1 then resume="auto" to CKPT_ITERS under the same
    run_id; then the newest checkpoint corrupted and the resume repeated
    from the previous one. Every state tensor bit-equal (the device
    evaluation counter restarts at 0 on resume, so the totals are
    compared), the CSVs byte-equal."""
    import filecmp

    from symbolicregression_jl_tpu_torch.api import checkpoint as CK

    X, y = bench_data()
    run = dict(verbosity=0, run_id="smoke", device=dev)
    opts = lambda d: bench_options(sr, BATCH_CYCLES, save_to_file=True,
                                   output_directory=os.path.join(out_base, d))
    ropt = lambda n: sr.RuntimeOptions(niterations=n, checkpoint_every_n=1, seed=0,
                                       verbosity=0, run_id="smoke")
    writes = []
    save = CK.save_search_state

    def timed_save(path, state):
        t0 = time.perf_counter()
        save(path, state)
        writes.append((time.perf_counter() - t0, os.path.getsize(path)))

    CK.save_search_state = timed_save
    from symbolicregression_jl_tpu_torch.shield import checkpoints as shield

    shield.save_search_state = timed_save
    try:
        t0 = time.perf_counter()
        straight, _ = sr.equation_search(X, y, options=opts("straight"),
                                         runtime_options=ropt(CKPT_ITERS), return_state=True,
                                         device=dev)
        t1 = time.perf_counter()
        sr.equation_search(X, y, options=opts("killed"), runtime_options=ropt(CKPT_ITERS - 1),
                           device=dev)
        t2 = time.perf_counter()
        # The seed must not matter: the key comes from the checkpoint.
        resumed, _ = sr.equation_search(X, y, options=opts("killed"), niterations=CKPT_ITERS,
                                        resume="auto", return_state=True, seed=99, **run)
        t3 = time.perf_counter()
    finally:
        CK.save_search_state = save
        shield.save_search_state = save
    print(f"  straight {CKPT_ITERS} iterations {t1 - t0:.2f} s; killed after "
          f"{CKPT_ITERS - 1} {t2 - t1:.2f} s; resumed to {CKPT_ITERS} {t3 - t2:.2f} s")
    secs, sizes = zip(*writes)
    print(f"  {len(writes)} checkpoint writes: {sizes[0]} bytes each "
          f"({sizes[0] / 2**20:.1f} MiB), {min(secs):.3f}-{max(secs):.3f} s a write "
          f"(mean {sum(secs) / len(secs):.3f} s; digest, fsync, read-back, replace)")
    check = Checks()
    base_a = os.path.join(out_base, "straight", "smoke")
    base_b = os.path.join(out_base, "killed", "smoke")

    def compare(tag, state):
        ta, tb = state_tensors(torch, straight.device_states[0]), state_tensors(
            torch, state.device_states[0])
        nev = straight.device_states[0].num_evals
        diff = [k for k, (a, b) in enumerate(zip(ta, tb))
                if a is not nev and not same(torch, a, b)]
        check(f"{tag}: {len(ta) - 1} state tensors bit-equal", len(ta) == len(tb) and not diff)
        check(f"{tag}: iterations_done {state.iterations_done}, total evaluations "
              f"{state.num_evals:.9g} against {straight.num_evals:.9g}",
              state.iterations_done == CKPT_ITERS
              and abs(state.num_evals - straight.num_evals) <= 1e-6 * straight.num_evals)
        check(f"{tag}: hall-of-fame CSVs byte-equal",
              filecmp.cmp(os.path.join(base_a, "hall_of_fame.csv"),
                          os.path.join(base_b, "hall_of_fame.csv"), shallow=False))

    compare("resume", resumed)
    newest = os.path.join(base_b, "search_state.pkl")
    with open(newest, "r+b") as f:
        f.seek(-64, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fallback, _ = sr.equation_search(X, y, options=opts("killed"), niterations=CKPT_ITERS,
                                         resume="auto", return_state=True, seed=99, **run)
    check("corrupt newest checkpoint: resume warned and fell back",
          any("corrupt" in str(w.message) for w in caught))
    compare("resume past the corrupt checkpoint", fallback)
    check.raise_if_failed("checkpoint and resume")


def phase_regressor(torch, sr, dev):
    """Phase 22: SRRegressor with the default device_scale="auto" (512 x
    256, 100 cycles) on phase 5's X with a target the bench operators
    express, seeded with an initial population that holds it; predictions
    on held-out rows against a float64 host evaluation of get_best();
    MultitargetSRRegressor on two targets at 64 islands."""
    X, _ = bench_data()
    truth = "cos(2.13 * x1) + 0.5 * (x2 * abs(x3))"
    f = lambda A: (np.cos(np.float32(2.13) * A[:, 0]) + np.float32(0.5) * (A[:, 1] * np.abs(
        A[:, 2]))).astype(np.float32)
    y = f(X)
    held = np.random.default_rng(1).uniform(-3, 3, (2_000, N_FEATURES)).astype(np.float32)
    kw = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["exp", "abs", "cos"],
              maxsize=30, save_to_file=False)
    t0 = time.perf_counter()
    model = sr.SRRegressor(niterations=2, seed=0, device=dev, **kw)
    model.fit(X, y, initial_population=[truth, "cos(2.13 * x1)", "x2 * abs(x3)", "x1"])
    o = model.options_
    print(f"  SRRegressor: {time.perf_counter() - t0:.2f} s, device-scaled "
          f"{model.device_scaled_} ({o.populations} x {o.population_size}, tournament "
          f"{o.tournament_selection_n}, {o.ncycles_per_iteration} cycles)")
    scale = model._DEVICE_SCALE_CONFIG
    if not model.device_scaled_ or o.populations != scale["populations"] \
            or o.population_size != scale["population_size"]:
        raise RuntimeError("SRRegressor did not take the device scale on the card")
    best = model.get_best()
    print(f"  best: complexity {best.complexity}, loss {best.loss:.6g}: {best.equation}")
    pred = model.predict(held)
    host = host_predict(torch, best.tree, held.astype(np.float64)).numpy()
    atol = 1e-5 * float(np.sqrt(np.mean(host ** 2)))
    err = np.abs(pred - host)
    print(f"  predict on {held.shape[0]} held-out rows: max |err| {err.max():.3g} against "
          f"rtol 1e-5 or 1e-5 of the predictions' RMS ({atol:.3g}); R^2 on them "
          f"{model.score(held, f(held)):.6f}")
    if not np.all((err <= 1e-5 * np.abs(host)) | (err <= atol)):
        raise RuntimeError("SRRegressor.predict disagrees with the host evaluation")
    t0 = time.perf_counter()
    multi = sr.MultitargetSRRegressor(niterations=2, seed=0, device=dev, populations=64,
                                      population_size=256, tournament_selection_n=16,
                                      ncycles_per_iteration=BATCH_CYCLES, **kw)
    multi.fit(X, np.stack([y, X[:, 0] * X[:, 1]], axis=1))
    eqs = multi.get_best()
    print(f"  MultitargetSRRegressor (64 x 256, {BATCH_CYCLES} cycles): "
          f"{time.perf_counter() - t0:.2f} s; " + "; ".join(
              f"output {j + 1}: loss {e.loss:.6g}, {e.equation}" for j, e in enumerate(eqs)))
    if len(eqs) != 2 or multi.predict(held).shape != (held.shape[0], 2):
        raise RuntimeError("MultitargetSRRegressor did not return two equations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ncycles", type=int, default=100,
                    help="ncycles_per_iteration of the main path (depth only)")
    ap.add_argument("--ncycles-plain", type=int, default=30,
                    help="ncycles_per_iteration of the no-optimizer path (depth only)")
    ap.add_argument("--ncycles-stage", type=int, default=30,
                    help="ncycles_per_iteration of the four graftstage cells (depth only)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import symbolicregression_jl_tpu_torch as sr
    from symbolicregression_jl_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    # Every file a phase writes (hall-of-fame CSVs, checkpoints) goes here,
    # never into the checkout; removed on the way out.
    out_base = tempfile.mkdtemp(prefix="sr_chip_smoke_")
    try:
        return run_phases(args, torch, sr, cuda_build, dev, out_base)
    finally:
        shutil.rmtree(out_base, ignore_errors=True)


def run_phases(args, torch, sr, cuda_build, dev, out_base) -> int:
    print("[1] device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    print("[2] build")
    t0 = time.perf_counter()
    files = list(dict.fromkeys(k._file for k in kernels()))
    cuda_build.build_all(files)
    for k in kernels():
        k.library()
    print(f"  {', '.join(files)}: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {', '.join(f'{cuda_build.build_seconds(f):.2f}' for f in files)} "
          f"s, in parallel)")
    for f, kname in (("program_eval.cu", "program_eval_kernel"),
                     ("program_multi.cu", "program_multi_kernel"),
                     ("program_grad.cu", "program_grad_kernel"),
                     ("program_predict.cu", "program_predict_kernel"),
                     ("program_predict_vjp.cu", "program_predict_vjp_kernel")):
        report = ptxas_report(cuda_build.build_log(f), kname)
        if not report:
            raise RuntimeError(f"no ptxas report for {kname} in the build of {f}")
        for name, regs, stack, spill_st, spill_ld in report:
            print(f"  ptxas {name}: {regs} registers, stack {stack} B, spill stores "
                  f"{spill_st} B, spill loads {spill_ld} B")

    print("[3] kernel #1 against its plain version")
    rows = [phase_kernel(torch, sr, dev)]

    print("[4] kernels #2 and #3 against their plain versions")
    rows += phase_opt_kernels(torch, sr, dev)

    print("[5] main path (constant optimizer on)")
    launches, f32_best = phase_main_path(torch, sr, dev, args.ncycles)
    for row in rows:
        row["launches"] = launches[row["name"]]

    print("[6] no-optimizer path")
    phase_no_optimizer(torch, sr, dev, args.ncycles_plain)

    print("[7] equation_search")
    phase_search(sr, dev, out_base)

    print("[8] kernels #4 and #5 against their plain versions")
    rows += phase_predict_kernels(torch, sr, dev)

    print("[9] template main path")
    launches = phase_template_main_path(torch, sr, dev)
    rows[3]["launches"] = launches["program_predict"]

    print("[10] template constant optimizer")
    launches = phase_template_optimizer(torch, sr, dev)
    rows[4]["launches"] = launches["program_predict_vjp"]

    print("[11] template composition search")
    phase_template_search(torch, sr, dev)

    print("[12] kernel #1p (parametric form of #1) against its plain version")
    rows.append(phase_param_kernel(torch, sr, dev))

    print("[13] parametric main path")
    launches = phase_parametric_main_path(torch, sr, dev)
    rows[5]["launches"] = launches["program_eval_param"]

    print("[14] parametric constant optimizer")
    phase_parametric_optimizer(torch, sr, dev)

    print("[15] parametric search and template search with parameters")
    phase_plugin_searches(torch, sr, dev)

    print("[16] kernels 1b and 2b (bf16 value buffers) against their plain versions")
    bf16_rows = phase_bf16_kernels(torch, sr, dev)
    rows += bf16_rows

    print("[17] graftstage cells")
    cells = phase_stage_cells(torch, sr, dev, args.ncycles_stage)
    bf16_rows[0]["launches"] = cells["plain-staged-bf16"]["program_eval_bf16"]

    print("[18] bf16 line search")
    launches = phase_bf16_line_search(torch, sr, dev, STAGE_LS_CYCLES, f32_best)
    bf16_rows[2]["launches"] = launches["program_multi_bf16"]

    print("[19] equation_search with staged_eval, eval_precision='bf16' and the bf16 line search")
    _, plaunches = phase_stage_search(torch, sr, dev)
    bf16_rows[1]["launches"] = plaunches["program_eval_param_bf16"]

    print("[20] batched main path (batching=True, batch_size 50)")
    blaunches = phase_batched_main_path(torch, sr, dev, rows)
    print(f"  launches of the batched main path (2 iterations): {blaunches}")

    print("[21] checkpoints and resume at full width")
    phase_checkpoint_resume(torch, sr, dev, out_base)

    print("[22] SRRegressor and MultitargetSRRegressor on the card")
    phase_regressor(torch, sr, dev)

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
