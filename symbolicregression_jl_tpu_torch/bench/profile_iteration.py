"""Where one engine iteration spends its time on the GPU.

    python -m symbolicregression_jl_tpu_torch.bench.profile_iteration [--ncycles N]
        [--no-optimizer] [--template | --template-optimizer | --parametric |
        [--staged] [--bf16]]

Builds the headline configuration (512 islands x 256 members, 10,000 rows
x 5 features, maxsize 30, the constant optimizer on unless
``--no-optimizer``) or, with ``--template``, the template cell (the JAX
package's bench/cell.py FULL, variant "template": 512 islands x 256
members, 10,000 rows x 2 features from seed 1234, + - * cos, structure
f(x1) * f(x1) + g(x2), optimizer_probability 0) or, with
``--template-optimizer``, chip_smoke.py phase 10's template optimizer
(the same cell at 64 islands with the default optimizer_probability) or,
with ``--parametric``, the parametric cell (the same cell with variant
"parametric": class = integers(0, 3) from the same generator, y =
amp[class] cos(x1) + x2, max_parameters 1, optimizer_probability 0) or,
with ``--staged`` and/or ``--bf16``, the graftstage cells (the same cell
with variant "plain-staged", "plain-bf16" or "plain-staged-bf16": + - *
cos, 10,000 rows x 2 features from seed 1234, y = cos(2.13 x1) + 0.5 x2,
optimizer_probability 0, ``staged_eval`` at the default fractions,
``eval_precision="bf16"``),
runs one warm-up iteration, then one iteration under ``torch.profiler``.
Prints the iteration's host-clock time, the summed device time of all
kernels and of each of the port's kernels (#1's plain, parametric and
bf16 forms apart), the device's busy and idle shares, the
number of kernel launches, each named range (``sr:constant_optimizer``,
``sr:template_eval``: its span on the device summed over its occurrences,
the device time of the port's kernels in it, that of the eager ops in it
and the idle rest), the trees per launch and the mean steps per tree of
each of the port's kernels in the profiled iteration (and for #2, #3 and
#5 the share of trees in each step-count class: csrc/interp.cuh's
VEC_CAP0 and VEC_CAP1 for #2 and #3, launch_step_classes for #5), and the
ten kernels with the most device time.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time

import numpy as np
import torch

import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch.evolve import rng
from symbolicregression_jl_tpu_torch.evolve.engine import Engine
from symbolicregression_jl_tpu_torch.ops import fused_eval as FE


def bench_data(n_rows: int = 10_000, n_features: int = 5):
    """The benchmark problem from seed 0 (bench/headline.py's data)."""
    g = np.random.default_rng(0)
    X = g.uniform(-3.0, 3.0, (n_rows, n_features)).astype(np.float32)
    y = (np.cos(2.13 * X[:, 0]) + 0.5 * X[:, 1] * np.abs(X[:, 2]) ** 0.9
         - 0.3 * np.abs(X[:, 3]) ** 1.5 + 1e-1 * g.standard_normal(n_rows)).astype(np.float32)
    return X, y


def template_data(n_rows: int = 10_000):
    """The template cell's problem from seed 1234: y = (1.5 x1)^2 + cos(2 x2)."""
    g = np.random.default_rng(1234)
    X = g.uniform(-2.0, 2.0, (n_rows, 2)).astype(np.float32)
    return X, ((1.5 * X[:, 0]) ** 2 + np.cos(2.0 * X[:, 1])).astype(np.float32)


def plain_cell_data(n_rows: int = 10_000):
    """The plain cell's problem from seed 1234: y = cos(2.13 x1) + 0.5 x2."""
    g = np.random.default_rng(1234)
    X = g.uniform(-2.0, 2.0, (n_rows, 2)).astype(np.float32)
    return X, (np.cos(2.13 * X[:, 0]) + 0.5 * X[:, 1]).astype(np.float32)


def parametric_data(n_rows: int = 10_000):
    """The parametric cell's problem from seed 1234: y = amp[class] cos(x1) + x2."""
    g = np.random.default_rng(1234)
    X = g.uniform(-2.0, 2.0, (n_rows, 2)).astype(np.float32)
    cls = g.integers(0, 3, n_rows)
    y = (np.array([1.0, 2.0, 3.0], np.float32)[cls] * np.cos(X[:, 0]) + X[:, 1]).astype(
        np.float32)
    return X, y, cls


# Kernel names as the profiler reports them: the first two template
# arguments of program_eval_kernel and program_multi_kernel are the value
# buffer's storage (float, or __nv_bfloat16 for 1b and 2b) and the loss
# spine's type (float for both); #1's parametric form is the instantiation
# whose PARAM argument is true.
_KERNEL_PATTERNS = {
    "program_eval": r"program_eval_kernel<float, float, \d+, (true|false), false",
    "program_eval_param": r"program_eval_kernel<float, float, \d+, (true|false), true",
    "program_eval_bf16": r"program_eval_kernel<__nv_bfloat16, float, \d+, (true|false), false",
    "program_eval_param_bf16": r"program_eval_kernel<__nv_bfloat16, float, \d+, (true|false), "
                               r"true",
    "program_multi": r"program_multi_kernel<float, float", "program_grad": r"program_grad_kernel",
    "program_multi_bf16": r"program_multi_kernel<__nv_bfloat16, float",
    "program_predict": r"program_predict_kernel",
    "program_predict_vjp": r"program_predict_vjp_kernel",
    "vec_plan (#2 and #3's class lists)": r"vec_plan_kernel",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ncycles", type=int, default=10)
    ap.add_argument("--no-optimizer", action="store_true",
                    help="profile without the constant optimizer")
    cell = ap.add_mutually_exclusive_group()
    cell.add_argument("--template", action="store_true",
                      help="profile the template-expression cell instead")
    cell.add_argument("--template-optimizer", action="store_true",
                      help="profile the template cell's constant optimizer (64 islands)")
    cell.add_argument("--parametric", action="store_true",
                      help="profile the parametric-expression cell instead")
    ap.add_argument("--staged", action="store_true",
                    help="profile the plain cell with staged_eval (graftstage)")
    ap.add_argument("--bf16", action="store_true",
                    help='profile the plain cell with eval_precision="bf16" (graftstage)')
    args = ap.parse_args()
    stage = args.staged or args.bf16
    if stage and (args.template or args.template_optimizer or args.parametric):
        ap.error("--staged and --bf16 profile the plain cell, not a template or parametric one")
    if not torch.cuda.is_available():
        print("profile_iteration: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    if args.template or args.template_optimizer:
        from symbolicregression_jl_tpu_torch.models import template_spec

        spec = template_spec(expressions=("f", "g"))(lambda f, g, x1, x2: f(x1) * f(x1) + g(x2))
        opt = {} if args.template_optimizer else {"optimizer_probability": 0.0}
        options = sr.Options(
            binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=30,
            populations=64 if args.template_optimizer else 512, population_size=256,
            tournament_selection_n=16, ncycles_per_iteration=args.ncycles,
            should_optimize_constants=not args.no_optimizer, expression_spec=spec,
            save_to_file=False, **opt)
        X, y = template_data()
    elif args.parametric:
        options = sr.Options(
            binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=30,
            populations=512, population_size=256, tournament_selection_n=16,
            ncycles_per_iteration=args.ncycles, optimizer_probability=0.0,
            should_optimize_constants=not args.no_optimizer,
            expression_spec=sr.ParametricExpressionSpec(max_parameters=1), save_to_file=False)
        X, y, cls = parametric_data()
    elif stage:
        options = sr.Options(
            binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=30,
            populations=512, population_size=256, tournament_selection_n=16,
            ncycles_per_iteration=args.ncycles, optimizer_probability=0.0,
            should_optimize_constants=not args.no_optimizer, staged_eval=args.staged,
            eval_precision="bf16" if args.bf16 else "f32", save_to_file=False)
        X, y = plain_cell_data()
    else:
        options = sr.Options(
            binary_operators=["+", "-", "*", "/"], unary_operators=["exp", "abs", "cos"],
            maxsize=30, populations=512, population_size=256, tournament_selection_n=16,
            ncycles_per_iteration=args.ncycles, should_optimize_constants=not args.no_optimizer,
            save_to_file=False)
        X, y = bench_data()
    ds = sr.make_dataset(X, y, extra={"class": cls} if args.parametric else None, device=dev)
    ds.update_baseline_loss(options.elementwise_loss)
    engine = Engine(options, X.shape[1], device=dev, n_params=1 if args.parametric else 0,
                    n_classes=ds.n_classes)
    state = engine.init_state(rng.key(0, device=dev), ds.data, options.populations)
    state = engine.run_iteration(state, ds.data, options.maxsize)
    torch.cuda.synchronize()

    # Trees per launch: each wrapper class that defines __call__ records its
    # first argument's rows (instr [T, L]) by kernel name for this iteration.
    trees, steps, consts = {}, {}, {}
    wrapped = [c for c in {type(getattr(FE, n)) for n in FE.__all__ if n.isupper()}
               for c in c.__mro__ if "__call__" in c.__dict__ and c.__module__ == FE.__name__]
    originals = {c: c.__dict__["__call__"] for c in set(wrapped)}

    def recording(orig):
        def call(self, *a, **kw):
            trees.setdefault(self.name, []).append(int(a[0].shape[0]))
            steps.setdefault(self.name, []).append(a[1])   # nsteps, read after the profile
            if self.name == "program_grad":
                consts.setdefault(self.name, []).append(a[2])   # nconst
            return orig(self, *a, **kw)
        return call

    for c, orig in originals.items():
        c.__call__ = recording(orig)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            state = engine.run_iteration(state, ds.data, options.maxsize)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for c, orig in originals.items():
            c.__call__ = orig

    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # Named ranges (record_function) also appear on the device timeline as
    # annotations spanning the kernels they launched; they are not kernels.
    # (The kernels of csrc/interp.cuh's namespace start "sr::".)
    is_span = lambda e: e.name.startswith("sr:") and not e.name.startswith("sr::")
    spans = [e for e in events if is_span(e)]
    kernels = [e for e in events if e.device_time_total > 0 and not is_span(e)]
    device_us = sum(e.device_time_total for e in kernels)
    cell_name = ("template" if args.template else "template optimizer"
                 if args.template_optimizer else "parametric" if args.parametric
                 else "plain" + "-staged" * args.staged + "-bf16" * args.bf16 if stage
                 else "headline")
    print(f"{cell_name} cell, ncycles_per_iteration "
          f"{args.ncycles}, constant optimizer {options.should_optimize_constants} "
          f"(probability {options.optimizer_probability}): iteration {wall:.3f} s (host clock)")
    print(f"device kernel time {device_us / 1e6:.3f} s over {len(kernels)} kernel launches; "
          f"busy {device_us / 1e6 / wall:.1%}, idle {1 - device_us / 1e6 / wall:.1%}")
    ours = {}
    for kname, pattern in _KERNEL_PATTERNS.items():
        hits = [e for e in kernels if re.search(pattern, e.name)]
        us = sum(e.device_time_total for e in hits)
        ours[kname] = us
        print(f"{kname} kernel {us / 1e6:.4f} s over {len(hits)} launches "
              f"({us / max(device_us, 1):.1%} of device time)")
    for kname, sizes in sorted(trees.items()):
        sizes = sorted(sizes)
        m = torch.cat(steps[kname]).to(torch.float64)
        print(f"{kname}: {len(sizes)} calls, trees per call min {sizes[0]}, median "
              f"{sizes[len(sizes) // 2]}, max {sizes[-1]}, total {sum(sizes)}; mean steps per "
              f"tree {float(m.mean()):.3f}")
        if kname in ("program_multi", "program_grad", "program_predict_vjp"):
            print(f"  {kname} trees by step count: <= 4 {float((m <= 4).double().mean()):.1%}, "
                  f"5-12 {float(((m > 4) & (m <= 12)).double().mean()):.1%}, > 12 "
                  f"{float((m > 12).double().mean()):.1%}; of one step "
                  f"{float((m == 1).double().mean()):.1%}")
        if kname in consts:
            c = torch.cat(consts[kname]).to(torch.float64)
            print(f"  {kname} trees by constants: 0 {float((c == 0).double().mean()):.1%}, 1-4 "
                  f"{float(((c > 0) & (c <= 4)).double().mean()):.1%}, more "
                  f"{float((c > 4).double().mean()):.1%}")
    for name in sorted({e.name for e in spans}):
        # Every occurrence of a named range: its span on the device, the
        # port's kernels and the other (eager) kernels inside it, the idle rest.
        span_us = inside_us = eager_us = 0.0
        n_eager = 0
        for span in (e for e in spans if e.name == name):
            t0_us, t1_us = span.time_range.start, span.time_range.end
            inside = [e for e in kernels
                      if t0_us <= e.time_range.start and e.time_range.end <= t1_us]
            eager = [e for e in inside
                     if "program_" not in e.name and "vec_plan_kernel" not in e.name]
            span_us += t1_us - t0_us
            inside_us += sum(e.device_time_total for e in inside)
            eager_us += sum(e.device_time_total for e in eager)
            n_eager += len(eager)
        print(f"{name}: device span {span_us / 1e6:.4f} s ({span_us / 1e6 / wall:.1%} of the "
              f"iteration); the port's kernels {(inside_us - eager_us) / 1e6:.4f} s, eager ops "
              f"{eager_us / 1e6:.4f} s over {n_eager} launches, device idle in the span "
              f"{(span_us - inside_us) / 1e6:.4f} s")
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time_total, c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {t / 1e3:10.2f} ms  {c:7d}x  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
