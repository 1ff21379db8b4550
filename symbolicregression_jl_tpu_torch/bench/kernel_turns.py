"""Kernel times of two checkouts of the repository, in turns, on one GPU.

    python -m symbolicregression_jl_tpu_torch.bench.kernel_turns DIR_A DIR_B [--rounds N]

Runs each checkout's ``chip_smoke.py`` phases 3, 4, 12 and 16 (kernel #1's
cost form, #2 and #3, #1p, and the bf16 forms 1b and 2b, each held against
its plain version and timed with CUDA events on the inputs those phases
build) in fresh processes, in the order A, B, B, A for each round, and
prints every line they print with the checkout it came from, then each
kernel's times side by side. Each checkout builds its kernels into its own
``build/`` on first use. A is usually the parent (``git archive`` of it)
and B the change. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys

_PHASES = ("phase_kernel", "phase_opt_kernels", "phase_param_kernel", "phase_bf16_kernels")

# The line each phase prints for a kernel's time: (kernel, pattern).
_TIMES = (
    ("program_eval (#1, cost form)", r"^  kernel ([\d.]+) ms"),
    ("program_multi (#2)", r"#2 program_multi: ([\d.]+) ms"),
    ("program_grad (#3)", r"#3 program_grad: ([\d.]+) ms"),
    ("program_eval_param (#1p)", r"#1p program_eval_param: ([\d.]+) ms"),
    ("program_eval_bf16 (1b, cost form)", r"1b program_eval_bf16 \(.*\): ([\d.]+) ms"),
    ("program_eval_param_bf16 (1b parametric)", r"1b program_eval_param_bf16 \(.*\): ([\d.]+) ms"),
    ("program_multi_bf16 (2b)", r"2b program_multi_bf16 \(.*\): ([\d.]+) ms"),
)


def run_side(root: pathlib.Path) -> str:
    """One fresh process in ``root`` running the four phases; its output."""
    code = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as C; "
            "import symbolicregression_jl_tpu_torch as sr; dev = torch.device('cuda'); "
            + "; ".join(f"print('[{p}]', flush=True); C.{p}(torch, sr, dev)" for p in _PHASES))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=pathlib.Path)
    ap.add_argument("b", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    times = {}
    for rnd in range(args.rounds):
        for side, root in (("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)):
            out = run_side(root)
            for line in out.splitlines():
                print(f"{side}{rnd} {line}")
                for kernel, pattern in _TIMES:
                    m = re.search(pattern, line)
                    if m:
                        times.setdefault(kernel, {"A": [], "B": []})[side].append(float(m.group(1)))
    for kernel, by in times.items():
        a, b = by["A"], by["B"]
        ratio = (sum(a) / len(a)) / (sum(b) / len(b)) if a and b else float("nan")
        print(f"{kernel}: A {' '.join(f'{t:.4f}' for t in a)} ms; B "
              f"{' '.join(f'{t:.4f}' for t in b)} ms; A / B {ratio:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
