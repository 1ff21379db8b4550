"""One matrix cell: a small, fully specified search run with telemetry on.

Port of the JAX package's ``bench/cell.py``: the same shapes (``MINI``,
``FULL``), variants, data (fixed seed 1234) and Options, so a cell here
and the JAX package's cell of the same id run the same problem. A cell
runs in-process on the given device (``run_cell``), and its metrics come
from its graftscope telemetry JSONL through bench/extract.py — not from
ad-hoc timers — so the quality check measures what observability
reports. The island-sharded cells run on ``shape["shards"]`` ranks of a
``torch.distributed`` group: spawned gloo ranks (parallel/launch.py),
each with the cell on ``device``, or the caller's group when the process
is in one; "sharded" takes the legacy runtime and "sharded-mesh" the mesh
runtime (mesh/engine.MeshEngine). The matrix runner (bench/matrix.py) runs each cell in a clean
subprocess through :func:`cell_main` (``python -m
symbolicregression_jl_tpu_torch.bench _cell SPEC``), which prints the
record on a ``GRAFTBENCH_CELL`` line.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

# The prefix of the one stdout line that carries a subprocess cell's record.
CELL_SENTINEL = "GRAFTBENCH_CELL"

# Mini (CPU/CI) shapes and chip-sized shapes (the bench.py headline
# config), as in the JAX package.
MINI = dict(rows=128, populations=4, population_size=16,
            ncycles=8, maxsize=8, niterations=3,
            tournament_selection_n=4, shards=2)
FULL = dict(rows=10_000, populations=512,
            population_size=256, ncycles=100, maxsize=30, niterations=3,
            tournament_selection_n=16, shards=0)  # 0 = all devices

# "sharded" / "sharded-mesh" are the island-sharded runtimes (the legacy
# and the mesh runtime over the plain problem). The "plain-staged" / "plain-bf16" /
# "plain-staged-bf16" variants are the plain cell with the graftstage
# modes on (docs/PRECISION.md) — same problem, same shapes.
VARIANTS = ("plain", "template", "parametric", "sharded", "sharded-mesh",
            "plain-staged", "plain-bf16", "plain-staged-bf16")
SHARDED_VARIANTS = ("sharded", "sharded-mesh")


def _problem(shape: Dict[str, Any], variant: str):
    """Deterministic per-variant problem. The rng seed is FIXED (1234):
    the search seed varies across matrix cells, the data never does —
    quality deltas then attribute to the search, not the sample."""
    import numpy as np

    rng = np.random.default_rng(1234)
    n = int(shape["rows"])
    X = rng.uniform(-2.0, 2.0, (n, 2)).astype(np.float32)
    extra = None
    if variant == "template":
        # truth matches the template structure f(x1)^2 + g(x2)
        y = ((1.5 * X[:, 0]) ** 2 + np.cos(2.0 * X[:, 1])
             ).astype(np.float32)
    elif variant == "parametric":
        category = rng.integers(0, 3, n)
        amp = np.array([1.0, 2.0, 3.0], np.float32)[category]
        y = (amp * np.cos(X[:, 0]) + X[:, 1]).astype(np.float32)
        extra = {"class": category}
    else:  # plain / sharded share the problem; only the mesh differs
        y = (np.cos(2.13 * X[:, 0]) + 0.5 * X[:, 1]).astype(np.float32)
    return X, y, extra


def _options(shape: Dict[str, Any], variant: str, out_dir: str):
    from ..core.options import Options
    from ..models import template_spec
    from ..models.spec import ParametricExpressionSpec

    spec = None
    if variant == "template":
        spec = template_spec(expressions=("f", "g"))(
            lambda f, g, x1, x2: f(x1) * f(x1) + g(x2)
        )
    elif variant == "parametric":
        spec = ParametricExpressionSpec(max_parameters=1)
    staged = variant in ("plain-staged", "plain-staged-bf16")
    bf16 = variant in ("plain-bf16", "plain-staged-bf16")
    return Options(
        binary_operators=["+", "-", "*"],
        unary_operators=["cos"],
        maxsize=int(shape["maxsize"]),
        populations=int(shape["populations"]),
        population_size=int(shape["population_size"]),
        ncycles_per_iteration=int(shape["ncycles"]),
        tournament_selection_n=int(shape["tournament_selection_n"]),
        optimizer_probability=0.0,  # keep mini cells deterministic-fast
        expression_spec=spec,
        output_directory=out_dir,
        telemetry=True,
        eval_precision="bf16" if bf16 else "f32",
        staged_eval=staged,
    )


def _launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter (ops/fused_eval.py), by name."""
    from ..ops import fused_eval

    return {k.name: k.launches for k in vars(fused_eval).values()
            if isinstance(k, fused_eval._ProgramKernel)}


def run_cell(spec: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Run one cell per its spec (``variant``, ``seed``, ``shape``,
    ``cell_id``, ``out_dir``) on ``device`` (CUDA unless ``"cpu"``; a
    ``device`` key of the spec stands in for the argument); returns the
    cell result record, metrics extracted from the telemetry JSONL, and
    the kernel launches the cell made (``launches``, by kernel)."""
    from ..api.search import equation_search
    from ..device import resolve_device
    from ..telemetry.schema import load_events
    from .extract import extract_metrics

    from ..parallel import multihost

    variant = spec["variant"]
    shards = int(spec["shape"].get("shards") or 0) or 1
    if variant in SHARDED_VARIANTS and shards > 1 and not multihost.is_initialized():
        return _run_sharded_cell(spec, device, shards)
    dev = resolve_device(device if device is not None else spec.get("device"))
    seed = int(spec["seed"])
    shape = dict(spec["shape"])
    cell_id = spec["cell_id"]
    out_dir = spec["out_dir"]
    run_id = cell_id.replace("/", "_")

    X, y, extra = _problem(shape, variant)
    options = _options(shape, variant, out_dir)

    runtime_options = None
    if variant in SHARDED_VARIANTS:
        from ..api.search import RuntimeOptions

        runtime_options = RuntimeOptions(niterations=int(shape["niterations"]),
                                         mesh_runtime=variant == "sharded-mesh")
    before = _launch_counts()
    t0 = time.perf_counter()
    equation_search(
        X, y, options=options, extra=extra,
        niterations=int(shape["niterations"]), runtime_options=runtime_options,
        verbosity=0, run_id=run_id, seed=seed, device=dev,
    )
    wall_s = time.perf_counter() - t0
    launches = {k: n - before.get(k, 0) for k, n in _launch_counts().items()
                if n != before.get(k, 0)}

    telemetry_path = os.path.join(out_dir, run_id, "telemetry.jsonl")
    metrics = extract_metrics(load_events(telemetry_path))
    return {
        "cell_id": cell_id,
        "variant": variant,
        "seed": seed,
        "n_devices": multihost.process_count(),
        "backend": dev.type,
        "wall_s": round(wall_s, 2),
        "telemetry": telemetry_path,
        "metrics": metrics,
        "launches": launches,
    }


def _run_sharded_cell(spec: Dict[str, Any], device, shards: int) -> Dict[str, Any]:
    """An island-sharded cell on ``shards`` spawned gloo ranks (several
    ranks share one card under gloo); rank 0's record, with its wall time
    the whole cell's, rank start-up included."""
    from ..parallel.launch import run_ranks

    dev = device if device is not None else spec.get("device")
    t0 = time.perf_counter()
    recs = run_ranks("symbolicregression_jl_tpu_torch.bench.cell:run_cell", shards,
                     kwargs={"spec": dict(spec), "device": None if dev is None else str(dev)},
                     backend="gloo", timeout_s=float(os.environ.get("SR_BENCH_CELL_BUDGET",
                                                                    600)))
    rec = recs[0]
    rec["wall_s"] = round(time.perf_counter() - t0, 2)
    return rec


def cell_main(spec_json: str) -> int:
    """Subprocess entry: run the cell, print the sentinel result line."""
    rec = run_cell(json.loads(spec_json))
    print(f"{CELL_SENTINEL} {json.dumps(rec)}", flush=True)
    return 0
