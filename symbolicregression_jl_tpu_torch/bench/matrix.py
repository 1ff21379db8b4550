"""The fixed benchmark matrix: variants x seeds, one subprocess per cell
(port of ``bench/matrix.py``).

``run_matrix`` runs the plain / template / parametric / graftstage cells
at 2 seeds each (``MINI`` shapes by default; ``FULL``, the chip-sized
shapes, with ``bench run --full``), telemetry on, each cell in a clean
subprocess (``python -m symbolicregression_jl_tpu_torch.bench _cell``)
on one device, and collects the cells' metrics from their graftscope
JSONL (bench/cell.py + bench/extract.py). The result keeps the JAX
package's ``graftbench.result.v1`` schema, so bench/gate.py reads it as
it reads the JAX package's. The island-sharded cells spawn their ranks
(bench/cell.py).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .cell import CELL_SENTINEL, FULL, MINI, VARIANTS
from .gate import RESULT_SCHEMA, library_provenance

__all__ = ["RESULT_SCHEMA", "MATRIX_SHAPES", "PORT_VARIANTS", "DEFAULT_SEEDS",
           "library_provenance", "matrix_cells", "run_matrix"]

MATRIX_SHAPES = {"mini": MINI, "full": FULL}

# The variants the port runs: every variant of the JAX package's matrix.
PORT_VARIANTS = VARIANTS

DEFAULT_SEEDS = (0, 1)

# Per-cell subprocess budget: a hung cell fails the matrix, not the run.
CELL_TIMEOUT_S = float(os.environ.get("SR_BENCH_CELL_BUDGET", 600))


def matrix_cells(
    variants: Sequence[str] = PORT_VARIANTS,
    seeds: Sequence[int] = DEFAULT_SEEDS,
) -> List[Tuple[str, str, int]]:
    """[(cell_id, variant, seed)] for the requested matrix slice."""
    bad = [v for v in variants if v not in VARIANTS]
    if bad:
        raise ValueError(f"unknown variants {bad}; pick from {VARIANTS}")
    return [(f"{v}/seed{s}", v, s) for v in variants for s in seeds]


def _cell_env() -> Dict[str, str]:
    env = dict(os.environ)
    env.setdefault("SYMBOLIC_REGRESSION_IS_TESTING", "true")
    # the child imports this package from the same tree as the parent
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def _run_cell_subprocess(cell_id: str, variant: str, seed: int, shape: Dict[str, Any],
                         workdir: str, device: str) -> Dict[str, Any]:
    spec = {
        "cell_id": cell_id, "variant": variant, "seed": seed,
        "shape": shape, "out_dir": os.path.join(workdir, "cells"),
        "device": device,
    }
    cmd = [sys.executable, "-m", "symbolicregression_jl_tpu_torch.bench",
           "_cell", json.dumps(spec)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, env=_cell_env(),
                              timeout=CELL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return {"cell_id": cell_id, "variant": variant, "seed": seed,
                "error": f"cell timeout after {CELL_TIMEOUT_S:.0f}s"}
    wall = time.perf_counter() - t0
    line = next((ln for ln in reversed(proc.stdout.splitlines())
                 if ln.startswith(CELL_SENTINEL + " ")), None)
    if proc.returncode != 0 or line is None:
        return {"cell_id": cell_id, "variant": variant, "seed": seed,
                "error": (f"cell exited rc={proc.returncode} without a "
                          f"result line: {proc.stderr[-500:]}")}
    try:
        rec = json.loads(line[len(CELL_SENTINEL) + 1:])
    except json.JSONDecodeError as e:
        return {"cell_id": cell_id, "variant": variant, "seed": seed,
                "error": f"unparseable cell result line: {e}"}
    rec["subprocess_wall_s"] = round(wall, 2)
    return rec


def run_matrix(
    *,
    matrix: str = "mini",
    variants: Sequence[str] = PORT_VARIANTS,
    seeds: Sequence[int] = DEFAULT_SEEDS,
    workdir: Optional[str] = None,
    device=None,
    log=print,
) -> Dict[str, Any]:
    """Run the matrix on ``device`` (CUDA unless ``"cpu"``); returns the
    schema-versioned result record. Cells that fail land in ``failures``
    (with stderr tails) instead of ``cells``: the gate treats a baseline
    cell missing from a result as a hard regression, so a crashing
    variant cannot silently drop out of coverage."""
    from ..device import resolve_device

    dev = resolve_device(device)
    cell_list = matrix_cells(variants, seeds)
    shape = MATRIX_SHAPES[matrix]
    workdir = workdir or os.path.join(os.environ.get("TMPDIR", "/tmp"), "graftbench")
    os.makedirs(workdir, exist_ok=True)
    cells: Dict[str, Any] = {}
    failures: Dict[str, Any] = {}
    t0 = time.time()
    for cell_id, variant, seed in cell_list:
        rec = _run_cell_subprocess(cell_id, variant, seed, shape, workdir, dev.type)
        if "error" in rec:
            failures[cell_id] = rec
            log(f"  {cell_id:<24} FAILED: {rec['error'][:120]}")
        else:
            cells[cell_id] = rec
            m = rec["metrics"]
            bl = m.get("best_loss")
            log(f"  {cell_id:<24} evals/s={(m.get('evals_per_sec') or 0):.0f} "
                f"best_loss={'-' if bl is None else format(bl, '.4g')} "
                f"recompiles={m.get('recompiles')} ({rec['wall_s']:.1f}s)")
    # the platform the cells ran on ("gpu" or "cpu"), as bench/gate.py's
    # make_result names it
    return {
        "schema": RESULT_SCHEMA,
        "matrix": matrix,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "provenance": library_provenance(),
        "t": time.time(),
        "wall_s": round(time.time() - t0, 1),
        "shape": shape,
        "cells": cells,
        "failures": failures,
    }
