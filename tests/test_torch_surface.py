"""The port's public surface against the JAX package's, module by module.

Both packages are read with ``ast`` only (neither is imported). For every
``.py`` module of ``symbolicregression_jl_tpu/``:

- each public top-level function, class and module constant (and each
  name a package ``__init__.py`` re-exports) has a counterpart of the same
  name in the port's module at the same relative path;
- each public function's or method's parameter names are a subset of the
  port's counterpart's (the port may add ``device`` and the like);
- each public method of a public class exists on the port's class.

``JAX_ONLY`` holds what the port leaves out on purpose: a qualified name
(``module.py:Name`` or ``module.py:Class.method``) or a (function,
parameter) pair, each with a reason that names the JAX, XLA, Pallas or
TPU mechanism it stands for. No entry may cover a user-facing module
(``api/``, ``core/options.py``, ``models/``, ``serve/``, ``bench/``'s CLI
and gate), and an entry whose name the JAX package no longer has, or that
the port now has, is stale.
"""

import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "symbolicregression_jl_tpu")
PORT_PKG = os.path.join(ROOT, "symbolicregression_jl_tpu_torch")

_PALLAS = "Pallas tiling and interpret mode (the port's wrappers take plain=)"
_TILING = ("tree_block", "tile_rows", "interpret")
_MULTI = ("tree_block", "interpret", "tile_budget", "v_chunk")

JAX_ONLY = {
    **{("ops/fused_eval.py:" + fn, p): _PALLAS
       for fn, params in {
           "fused_loss_program": _TILING, "fused_cost_program": _TILING,
           "fused_loss_dedup": _TILING, "fused_grad_program": _TILING, "fused_loss": _TILING,
           "fused_cost": _TILING, "fused_predict": _TILING,
           "fused_loss_and_const_grad": _TILING, "fused_loss_multi": _MULTI,
           "fused_grad_multi": _MULTI, "fused_predict_program": ("tree_block", "interpret"),
           "fused_predict_ad": ("interpret",)}.items()
       for p in params},
    ("ops/fused_eval.py:fused_loss_program", "class_oh"):
        "the TPU's one-hot class matmul (the port gathers each row's bank by class_idx)",
    ("evolve/constant_opt.py:optimize_constants_fused", "interpret"): _PALLAS,
    ("evolve/constant_opt.py:optimize_constants_template", "interpret"): _PALLAS,
    **{("evolve/step.py:eval_cost_batch", p): _PALLAS for p in _TILING},
    ("evolve/pieces.py:concat_pieces", "int_matmul"):
        "the TPU's one-hot-matmul integer takes (_INT_MATMUL)",
    ("evolve/pieces.py:splice_span", "int_matmul"):
        "the TPU's one-hot-matmul integer takes (_INT_MATMUL)",
    "mesh/aot.py:aot_serialization_supported":
        "XLA executable serialization (the port keeps only its executable cache)",
    "mesh/aot.py:save_executable": "XLA executable serialization (jax.export)",
    "mesh/aot.py:load_executable": "XLA executable serialization (jax.export)",
    "mesh/aot.py:MeshIterationExecutable.cost_analysis":
        "an XLA compiled executable's cost analysis",
    "mesh/aot.py:MeshIterationExecutable.memory_analysis":
        "an XLA compiled executable's memory analysis",
    "mesh/dryrun.py:virtual_cpu_mesh_env":
        "XLA's virtual CPU device count (the port's dryrun spawns gloo ranks)",
    "mesh/plan.py:MeshPlan.resolve_donation":
        "XLA buffer donation (a torch iteration builds new tensors)",
    "lint/analyzer.py:TRACER_CALLS":
        "jax.jit/vmap/grad tracing entry points (the port's lint restates its rules for torch)",
    "lint/analyzer.py:PALLAS_CALLS": "pl.pallas_call sites (no Pallas in the port)",
    "lint/analyzer.py:SHARD_MAP_CALLS":
        "jax shard_map entry points (the port's collectives are torch.distributed calls)",
    "lint/analyzer.py:ModuleAnalysis.in_pallas_kernel": "Pallas kernel bodies",
    "lint/analyzer.py:ModuleAnalysis.in_shard_map_body": "jax shard_map bodies",
    "lint/analyzer.py:ModuleAnalysis.is_traced":
        "code traced by jax.jit (the port's analysis marks hot loops, in_hot_loop)",
    "lint/analyzer.py:local_bindings":
        "the jax.jit captured-mutation rule's helper (check_captured_mutation)",
    "lint/concurrency.py:check_jax_under_lock":
        "JAX dispatch under a lock (restated for torch as check_device_under_lock)",
    "lint/rules.py:check_traced_sync":
        "host syncs inside jax.jit-traced code (restated as check_hot_loop_sync)",
    "lint/rules.py:check_recompile_hazard":
        "jax.jit retraces and XLA recompiles (restated as check_rebuild_hazard)",
    "lint/rules.py:check_captured_mutation":
        "mutation of values a jax.jit trace captured (restated as "
        "check_saved_tensor_mutation)",
    "lint/rules.py:check_shard_map_hazard":
        "collectives and host calls in jax shard_map bodies (restated as "
        "check_collective_hazard)",
}

USER_FACING = ("api/", "core/options.py", "models/", "serve/", "bench/__main__.py",
               "bench/gate.py")
MECHANISM = re.compile(r"\b(JAX|jax|XLA|Pallas|pl\.pallas_call|TPU|GSPMD|shard_map)\b")


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += ["*" + a.vararg.arg] if a.vararg else []
    names += ["**" + a.kwarg.arg] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


def _public(name: str) -> bool:
    return not name.startswith("_")


def _surface(path: str):
    """{name: (kind, info)}: functions with their parameters, classes with
    their public methods' parameters, constants, and imported names."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            out[node.name] = ("function", _params(node))
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out[node.name] = ("class", {
                b.name: _params(b) for b in node.body
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                and (_public(b.name) or b.name == "__init__")})
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                for n in ast.walk(target):
                    if isinstance(n, ast.Name) and _public(n.id):
                        out[n.id] = ("constant", None)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            if isinstance(node, ast.ImportFrom) and node.module == "__future__":
                continue
            for alias in node.names:
                name = (alias.asname or alias.name).split(".")[0]
                if _public(name):
                    out.setdefault(name, ("import", None))
    return out


def _modules():
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), JAX_PKG)


def _gaps():
    """Every name, parameter and method of the JAX package the port lacks."""
    gaps = set()
    for rel in _modules():
        jax_names = _surface(os.path.join(JAX_PKG, rel))
        port_path = os.path.join(PORT_PKG, rel)
        if not os.path.exists(port_path):
            gaps.add(rel)
            continue
        port_names = _surface(port_path)
        for name, (kind, info) in jax_names.items():
            if kind == "import" and os.path.basename(rel) != "__init__.py":
                continue                     # a module's own imports are not its surface
            if name not in port_names:
                gaps.add(f"{rel}:{name}")
                continue
            port_kind, port_info = port_names[name]
            if kind == "function" and port_kind == "function":
                gaps.update((f"{rel}:{name}", p) for p in info if p not in port_info)
            elif kind == "class" and port_kind == "class":
                for meth, params in info.items():
                    if meth not in port_info:
                        gaps.add(f"{rel}:{name}.{meth}")
                    else:
                        gaps.update((f"{rel}:{name}.{meth}", p) for p in params
                                    if p not in port_info[meth])
    return gaps


@pytest.fixture(scope="module")
def gaps():
    return _gaps()


def test_every_public_name_parameter_and_method_has_a_counterpart(gaps):
    missing = sorted(map(str, gaps - set(JAX_ONLY)))
    assert not missing, ("the port lacks these names, parameters or methods of the JAX "
                         f"package (port them, or list them in JAX_ONLY): {missing}")


def test_jax_only_entries_are_current(gaps):
    """An entry the JAX package no longer has, or the port now has, goes."""
    stale = sorted(map(str, set(JAX_ONLY) - gaps))
    assert not stale, f"stale JAX_ONLY entries: {stale}"


def test_jax_only_covers_no_user_facing_module_and_names_a_mechanism():
    for key, reason in JAX_ONLY.items():
        name = key[0] if isinstance(key, tuple) else key
        assert not name.startswith(USER_FACING), f"{key} is user-facing: port it"
        assert MECHANISM.search(reason), f"{key}: the reason names no JAX/XLA/Pallas/TPU mechanism"


def test_the_audit_reads_both_packages():
    """The audit sees the modules and names it compares (a broken walk
    would pass vacuously)."""
    mods = list(_modules())
    assert len(mods) > 100 and "evolve/engine.py" in mods and "ops/fused_eval.py" in mods
    port = _surface(os.path.join(PORT_PKG, "evolve", "engine.py"))
    assert port["Engine"][0] == "class"
    assert {"initial_trees", "initial_params"} <= set(port["Engine"][1]["init_state"])
