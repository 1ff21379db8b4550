"""Kernel times of two checkouts of the repository, in turns, on one GPU.

    python -m symbolicregression_jl_tpu_torch.bench.kernel_turns DIR_A DIR_B [--rounds N]

Runs ``chip_smoke.py`` phases 3, 4, 12, 16 and 8 (kernel #1's cost form,
#2 and #3 (#3 also on trees of mixed step counts), #1p, the bf16 forms 1b
and 2b, and #4 and #5 with shared and per-member X and on trees of mixed
step counts, each held against its plain version and timed with CUDA
events on the inputs those phases build) on each checkout's package in
fresh processes, in the order A, B, B, A for each round, and prints every
line they print with the checkout it came from, then each kernel's times
side by side, then whether the digests of #3's, #4's and #5's output bits
(phases 4 and 8) are the same on both sides. Both sides run the phases of
B's ``chip_smoke.py``, so both get the same inputs and checks. Each
checkout builds its kernels into its own ``build/`` on first use. A is
usually the parent (``git archive`` of it) and B the change. Exits 1 when
a digest differs between the two sides or between two runs of one side.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys

_PHASES = ("phase_kernel", "phase_opt_kernels", "phase_param_kernel", "phase_bf16_kernels",
           "phase_predict_kernels")

# The line each phase prints for a kernel's time: (kernel, pattern).
_TIMES = (
    ("program_eval (#1, cost form)", r"^  kernel ([\d.]+) ms"),
    ("program_multi (#2)", r"#2 program_multi: ([\d.]+) ms"),
    ("program_grad (#3)", r"#3 program_grad: ([\d.]+) ms"),
    ("program_grad (#3, mixed steps)", r"#3 program_grad, mixed steps: ([\d.]+) ms"),
    ("program_eval_param (#1p)", r"#1p program_eval_param: ([\d.]+) ms"),
    ("program_eval_bf16 (1b, cost form)", r"1b program_eval_bf16 \(.*\): ([\d.]+) ms"),
    ("program_eval_param_bf16 (1b parametric)", r"1b program_eval_param_bf16 \(.*\): ([\d.]+) ms"),
    ("program_multi_bf16 (2b)", r"2b program_multi_bf16 \(.*\): ([\d.]+) ms"),
    ("program_predict (#4, {X} X)", r"#4 program_predict: ([\d.]+) ms"),
    ("program_predict_vjp (#5, {X} X)", r"#5 program_predict_vjp: ([\d.]+) ms"),
)
# Phase 8 prints "  shared X (F = 1): ...", "  per-member X (F = 2): ..." or
# "  mixed steps X (F = 1): ..." before each input's #4 and #5 times; {X} in
# a kernel's label is that input.
_X_INPUT = r"^  (shared|per-member|mixed steps) X \(F = \d+\)"
# Phases 4 and 8 print "  bits <kernel and input>: <digest>" for the outputs
# of #3, #4 and #5.
_BITS = r"^  bits (.+): ([0-9a-f]{16})$"


def run_side(root: pathlib.Path, smoke: pathlib.Path) -> str:
    """One fresh process in ``root`` running the phases of the
    ``chip_smoke.py`` at ``smoke`` on ``root``'s package; its output."""
    code = ("import sys, torch, importlib.util as u; sys.path.insert(0, '.'); "
            f"s = u.spec_from_file_location('chip_smoke', {str(smoke.resolve())!r}); "
            "C = u.module_from_spec(s); s.loader.exec_module(C); "
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
    times, bits = {}, {}
    for rnd in range(args.rounds):
        for side, root in (("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)):
            out = run_side(root, args.b / "chip_smoke.py")
            x_input = ""
            for line in out.splitlines():
                print(f"{side}{rnd} {line}")
                m = re.search(_X_INPUT, line)
                if m:
                    x_input = m.group(1)
                m = re.search(_BITS, line)
                if m:
                    bits.setdefault(m.group(1), {"A": set(), "B": set()})[side].add(m.group(2))
                for kernel, pattern in _TIMES:
                    m = re.search(pattern, line)
                    if m:
                        label = kernel.format(X=x_input)
                        times.setdefault(label, {"A": [], "B": []})[side].append(float(m.group(1)))
    for kernel, by in times.items():
        a, b = by["A"], by["B"]
        ratio = (sum(a) / len(a)) / (sum(b) / len(b)) if a and b else float("nan")
        print(f"{kernel}: A {' '.join(f'{t:.4f}' for t in a)} ms; B "
              f"{' '.join(f'{t:.4f}' for t in b)} ms; A / B {ratio:.3f}")
    differ = 0
    for label, by in bits.items():
        same = len(by["A"]) == 1 and by["A"] == by["B"]
        differ += not same
        print(f"bits {label}: {'A == B' if same else 'DIFFERENT'} "
              f"(A {' '.join(sorted(by['A']))}; B {' '.join(sorted(by['B']))})")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
