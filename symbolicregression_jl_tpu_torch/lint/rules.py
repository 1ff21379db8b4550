"""graftlint's rule catalog for the port (port of ``lint/rules.py``):
hazards of the PyTorch/CUDA search that pytest doesn't catch.

Each rule is a function ``check(mod: ModuleAnalysis) -> Iterator[Finding]``
registered in the table-driven :data:`RULES` registry via the
:func:`rule` decorator. Adding a rule is ~20 lines: write the checker,
decorate it with id/name/summary/rationale (and an optional ``scope`` of
directory names it applies to), and it participates in the CLI, the
suppression machinery, and ``--list-rules`` automatically.

GL001-GL005 keep the JAX package's codes and name the port's own form of
each hazard: reuse of a threefry key of ``evolve/rng.py``, host RNG in
``evolve/`` and ``ops/``, a host sync in the per-cycle hot loop, a kernel
build or a new launch-table key inside a loop, and an in-place write to
a tensor that autograd saved. GL006 and GL007 (debug hooks, signal
handlers) are the JAX package's rules; GL008 restates the JAX package's
``shard_map`` hazard for ``torch.distributed`` (a collective under a
rank-dependent branch, a host sync between one iteration's collectives,
in the mesh modules); GL009-GL014 live in :mod:`.concurrency`.

Suppression: append ``# graftlint: disable=GL003`` (or a bare
``# graftlint: disable``) to the *reported* line.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .analyzer import (
    FUNC_NODES,
    Finding,
    ModuleAnalysis,
    dotted_name,
    root_name,
    walk_pruned,
)

__all__ = ["Rule", "RULES", "rule", "run_rules"]


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    summary: str
    rationale: str
    # Directory names the rule is limited to (None = whole tree). A file
    # is in scope when any component of its path matches.
    scope: Optional[Tuple[str, ...]]
    check: Callable[[ModuleAnalysis], Iterator[Finding]]


RULES: Dict[str, Rule] = {}


def rule(
    id: str,
    name: str,
    summary: str,
    rationale: str = "",
    scope: Optional[Sequence[str]] = None,
):
    def decorator(fn):
        RULES[id] = Rule(
            id=id,
            name=name,
            summary=summary,
            rationale=rationale,
            scope=tuple(scope) if scope else None,
            check=fn,
        )
        return fn

    return decorator


def _in_scope(path: str, scope: Optional[Tuple[str, ...]]) -> bool:
    if scope is None:
        return True
    parts = path.replace("\\", "/").split("/")
    return any(p in scope for p in parts)


def run_rules(
    mod: ModuleAnalysis, select: Optional[Set[str]] = None
) -> List[Finding]:
    """All non-suppressed findings for a module, sorted by position."""
    out: List[Finding] = []
    for r in RULES.values():
        if select is not None and r.id not in select:
            continue
        if not _in_scope(mod.path, r.scope):
            continue
        for f in r.check(mod):
            if not mod.is_suppressed(f.rule_id, f.line):
                out.append(f)
    out.sort(key=lambda f: (f.line, f.col, f.rule_id))
    return out


def _finding(mod: ModuleAnalysis, rid: str, node: ast.AST, msg: str) -> Finding:
    return Finding(
        rule_id=rid,
        rule_name=RULES[rid].name if rid in RULES else rid,
        path=mod.path,
        line=getattr(node, "lineno", 1),
        col=getattr(node, "col_offset", 0),
        message=msg,
    )


# ---------------------------------------------------------------------------
# GL001 — threefry key reuse (evolve/rng.py)
# ---------------------------------------------------------------------------

# evolve/rng.py functions that CONSUME a key as their first argument.
# ``fold_in`` does not count: deriving many streams from one base key with
# distinct data (``fold_in(key, i)`` in a loop) is the idiom, as in
# jax.random; nor do ``key`` (a constructor) and the ``u_*`` helpers
# (they take uniforms, not keys).
_KEY_CONSUMING = {
    "split", "uniform", "randint", "bernoulli", "gumbel", "categorical",
    "permutation", "normal", "random_bits",
}


def _rng_prefixes(mod: ModuleAnalysis) -> Tuple[str, ...]:
    """Names denoting the port's ``evolve/rng.py`` here: ``rng`` when the
    module imports it (``from . import rng``, ``from ..evolve import
    rng``, ``import ...evolve.rng as r``), and any alias it takes. A bare
    ``rng`` that is not that module (a numpy Generator) is not a key."""
    prefixes: List[str] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == "rng" and (node.module or "").split(".")[-1] in ("", "evolve"):
                    prefixes.append(a.asname or "rng")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith("evolve.rng"):
                    prefixes.append(a.asname or a.name)
    return tuple(prefixes)


def _random_key_call(call: ast.Call, prefixes: Tuple[str, ...]) -> Optional[str]:
    """The consumed key's name if this is a key-consuming rng call with a
    plain-Name key, else None."""
    dn = dotted_name(call.func)
    if dn is None or "." not in dn:
        return None
    mod_, fn = dn.rsplit(".", 1)
    if mod_ not in prefixes or fn not in _KEY_CONSUMING:
        return None
    if call.args and isinstance(call.args[0], ast.Name):
        return call.args[0].id
    return None


@rule(
    "GL001",
    "key-reuse",
    "evolve/rng.py key consumed more than once without a split",
    "The port draws its randomness from threefry keys exactly as "
    "jax.random does (evolve/rng.py), so that one seed gives the JAX "
    "package's draws. Reusing a key yields identical 'random' draws: "
    "correlated mutations, duplicated restarts, a silently degraded "
    "search. Every consumption (samplers, split) must use a fresh key.",
)
def check_key_reuse(mod: ModuleAnalysis) -> Iterator[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[int, int, str]] = set()
    prefixes = _rng_prefixes(mod)
    if not prefixes:
        return

    def emit(node: ast.AST, name: str) -> None:
        key = (node.lineno, node.col_offset, name)
        if key not in seen:
            seen.add(key)
            findings.append(_finding(
                mod, "GL001", node,
                f"key `{name}` is consumed again without an intervening "
                f"rebind from `rng.split`/`rng.fold_in`"))

    def reset_target(t: ast.AST, env: Dict[str, bool]) -> None:
        if isinstance(t, ast.Name):
            env[t.id] = False
        elif isinstance(t, (ast.Tuple, ast.List)):
            for elt in t.elts:
                reset_target(elt, env)
        elif isinstance(t, ast.Starred):
            reset_target(t.value, env)

    def visit_expr(e: Optional[ast.AST], env: Dict[str, bool]) -> None:
        if e is None:
            return
        for node in walk_pruned(e):
            if isinstance(node, ast.Call):
                name = _random_key_call(node, prefixes)
                if name is not None:
                    if env.get(name, False):
                        emit(node, name)
                    env[name] = True

    def visit_stmts(stmts: Sequence[ast.stmt], env: Dict[str, bool]) -> None:
        for s in stmts:
            if isinstance(s, FUNC_NODES + (ast.ClassDef,)):
                continue  # separate scope
            if isinstance(s, ast.If):
                visit_expr(s.test, env)
                env_a, env_b = dict(env), dict(env)
                visit_stmts(s.body, env_a)
                visit_stmts(s.orelse, env_b)
                for k in set(env_a) | set(env_b):
                    env[k] = env_a.get(k, False) or env_b.get(k, False)
            elif isinstance(s, (ast.For, ast.AsyncFor, ast.While)):
                visit_expr(getattr(s, "iter", None), env)
                visit_expr(getattr(s, "test", None), env)
                # two passes: the second catches keys consumed every
                # iteration without a rebind (dedup keeps one finding)
                for _ in range(2):
                    body_env = dict(env)
                    if isinstance(s, (ast.For, ast.AsyncFor)):
                        reset_target(s.target, body_env)
                    visit_stmts(s.body, body_env)
                    env.update(body_env)
                visit_stmts(s.orelse, env)
            elif isinstance(s, ast.Try):
                visit_stmts(s.body, env)
                for h in s.handlers:
                    visit_stmts(h.body, dict(env))
                visit_stmts(s.orelse, env)
                visit_stmts(s.finalbody, env)
            elif isinstance(s, (ast.With, ast.AsyncWith)):
                for item in s.items:
                    visit_expr(item.context_expr, env)
                visit_stmts(s.body, env)
            else:
                for child in ast.iter_child_nodes(s):
                    if isinstance(child, ast.expr):
                        visit_expr(child, env)
                if isinstance(s, ast.Assign):
                    for t in s.targets:
                        reset_target(t, env)
                elif isinstance(s, (ast.AnnAssign, ast.AugAssign)):
                    reset_target(s.target, env)

    visit_stmts(list(mod.tree.body), {})
    for fn in mod.functions():
        if isinstance(fn, ast.Lambda):
            visit_expr(fn.body, {})
        else:
            visit_stmts(fn.body, {})
    yield from findings


# ---------------------------------------------------------------------------
# GL002 — host RNG in device-code directories
# ---------------------------------------------------------------------------

# torch's global-generator samplers: functions, and the in-place Tensor
# methods that draw from the same generator.
_TORCH_RNG_FNS = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial", "poisson",
}
_TORCH_RNG_METHODS = {
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
}


@rule(
    "GL002",
    "host-rng",
    "Python `random` / `np.random` / torch's global generator used in "
    "device-code directories",
    "The port's draws are bit-equal with the JAX package's because each "
    "comes from a threefry key of evolve/rng.py. A draw from numpy's, "
    "Python's or torch's global generator ignores the threaded keys: it "
    "breaks seeded reproducibility, the bit-equality with JAX, and the "
    "resume-is-bit-identical promise.",
    scope=("evolve", "ops"),
)
def check_host_rng(mod: ModuleAnalysis) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        dn = dotted_name(node.func)
        if dn is None:
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _TORCH_RNG_METHODS):
                yield _finding(
                    mod, "GL002", node,
                    f"`.{node.func.attr}(...)` draws from torch's global "
                    f"generator; use an evolve/rng.py key instead")
            continue
        last = dn.rsplit(".", 1)[-1]
        if dn.startswith(("np.random.", "numpy.random.")):
            yield _finding(
                mod, "GL002", node,
                f"`{dn}` draws from the host numpy RNG; use an "
                f"evolve/rng.py key instead")
        elif dn.startswith("random.") and not dn.startswith(("jax.random.",)):
            yield _finding(
                mod, "GL002", node,
                f"`{dn}` uses Python's global `random` module; use an "
                f"evolve/rng.py key instead")
        elif dn.startswith("torch.") and dn.count(".") == 1 and last in _TORCH_RNG_FNS:
            yield _finding(
                mod, "GL002", node,
                f"`{dn}` draws from torch's global generator; use an "
                f"evolve/rng.py key instead")
        elif "." in dn and last in _TORCH_RNG_METHODS:
            yield _finding(
                mod, "GL002", node,
                f"`{dn}` draws from torch's global generator; use an "
                f"evolve/rng.py key instead")


# ---------------------------------------------------------------------------
# GL003 — host sync in the per-cycle hot loop
# ---------------------------------------------------------------------------

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_CAST_CALLS = {"float", "int", "bool"}
# Tensor methods whose result is still a device tensor: casting one to a
# Python scalar waits for the device.
_TENSOR_REDUCTIONS = {
    "sum", "max", "min", "any", "all", "mean", "count_nonzero", "norm",
    "prod", "amax", "amin", "argmax", "argmin",
}
_STATIC_RESULT_FNS = {
    "len", "round", "ord", "hash", "id", "prod", "ceil", "floor", "sqrt",
}


def _reads_device_value(node: ast.AST) -> bool:
    """Whether an expression evidently holds a device tensor: it calls a
    ``torch.*`` function or a reduction method (``x.sum()``,
    ``mask.any()``). Host scalars (options fields, lengths) do not."""
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        dn = dotted_name(n.func)
        if dn is not None and dn.startswith("torch."):
            return True
        if isinstance(n.func, ast.Attribute) and n.func.attr in _TENSOR_REDUCTIONS:
            base = dotted_name(n.func.value)
            if base is None or base.split(".")[0] not in ("math", "np", "numpy"):
                return True
    return False


@rule(
    "GL003",
    "hot-loop-sync",
    "host sync (`.item()`/`.tolist()`/`.cpu()`/`float()` of a tensor) in "
    "the per-cycle hot loop",
    "The generation step (evolve/step.py, evolve/mutation.py) is bound by "
    "host launches: thousands of small kernels a cycle, queued ahead of "
    "the device. A host read of a device value drains that queue every "
    "cycle; PERF.md counts 237 syncs in a 10-cycle iteration already. "
    "Keep values on the device; read them once an iteration, outside the "
    "cycles. A read of a host value (an options field, a length) is "
    "legitimate: annotate the rare false positive with "
    "`# graftlint: disable=GL003`.",
)
def check_hot_loop_sync(mod: ModuleAnalysis) -> Iterator[Finding]:
    if not mod.hot:
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not mod.in_hot_loop(node):
            continue
        dn = dotted_name(node.func)
        if dn in _CAST_CALLS:
            if not node.args:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                continue
            if isinstance(arg, ast.Call):
                adn = dotted_name(arg.func)
                if adn and adn.rsplit(".", 1)[-1] in _STATIC_RESULT_FNS:
                    continue
            if _reads_device_value(arg):
                yield _finding(
                    mod, "GL003", node,
                    f"`{dn}(...)` of a tensor in the per-cycle hot loop "
                    f"waits for the device (a host sync every cycle)")
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _SYNC_METHODS and not node.args):
            yield _finding(
                mod, "GL003", node,
                f"`.{node.func.attr}()` in the per-cycle hot loop forces a "
                f"blocking device-to-host copy every cycle")


# ---------------------------------------------------------------------------
# GL004 — kernel build / new launch-table key in a loop
# ---------------------------------------------------------------------------

# ops/cuda_build.py entry points that build (nvcc) or load a kernel library.
_BUILD_CALLS = {"load_library", "build_all", "_build"}
# Constructors of the key the kernel wrappers cache their launch tables
# under (``_ProgramKernel._device_optab``): a fresh one per call is a
# fresh table upload per call.
_TABLE_KEY_CTORS = {"OperatorSet"}


@rule(
    "GL004",
    "rebuild-hazard",
    "kernel build/load, or a new launch-table key, inside a loop",
    "A kernel library is built once per source and loaded once per "
    "process (ops/cuda_build.py); a build or load call inside a loop "
    "pays nvcc or dlopen every iteration when its cache is defeated. "
    "The kernel wrappers keep one opcode table on the device per "
    "OperatorSet: an OperatorSet built inside a loop is a new key, so "
    "each iteration uploads a new table and the cache grows without "
    "bound. Build and construct once, outside the loop.",
)
def check_rebuild_hazard(mod: ModuleAnalysis) -> Iterator[Finding]:
    for loop in ast.walk(mod.tree):
        if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
            continue
        for stmt in loop.body + loop.orelse:
            for node in walk_pruned(stmt):
                if not isinstance(node, ast.Call):
                    continue
                dn = dotted_name(node.func)
                if dn is None:
                    continue
                last = dn.rsplit(".", 1)[-1]
                if last in _BUILD_CALLS:
                    yield _finding(
                        mod, "GL004", node,
                        f"`{dn}(...)` inside a loop builds or loads a kernel "
                        f"library per iteration; hoist it out of the loop")
                elif last in _TABLE_KEY_CTORS:
                    yield _finding(
                        mod, "GL004", node,
                        f"`{dn}(...)` inside a loop is a new launch-table key "
                        f"per iteration (a table upload each time); build "
                        f"it once outside the loop")


# ---------------------------------------------------------------------------
# GL005 — in-place write to a tensor autograd saved
# ---------------------------------------------------------------------------

# In-place Tensor methods (the trailing-underscore forms autograd checks
# with its version counter).
_INPLACE_METHODS = {
    "add_", "sub_", "mul_", "div_", "copy_", "zero_", "fill_", "clamp_",
    "clamp_min_", "clamp_max_", "masked_fill_", "masked_scatter_",
    "index_put_", "index_add_", "index_copy_", "index_fill_", "scatter_",
    "scatter_add_", "exp_", "log_", "neg_", "abs_", "sqrt_", "pow_",
    "addcmul_", "addcdiv_", "lerp_", "copysign_", "nan_to_num_", "t_",
    "squeeze_", "unsqueeze_", "transpose_", "resize_", "set_", "sigmoid_",
    "tanh_", "relu_", "where_",
}
# Markers of a function that records an autograd graph itself.
_GRAD_CALLS = {"torch.autograd.grad", "torch.enable_grad", "requires_grad_",
               "backward", "torch.func.jvp", "torch.func.vjp", "torch.func.grad"}


def _records_graph(fn: ast.AST) -> bool:
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        for n in walk_pruned(stmt):
            if isinstance(n, ast.Call):
                dn = dotted_name(n.func) or ""
                last = dn.rsplit(".", 1)[-1]
                if dn in _GRAD_CALLS or last in ("requires_grad_", "backward"):
                    return True
                if any(kw.arg == "requires_grad" and isinstance(kw.value, ast.Constant)
                       and kw.value.value is True for kw in n.keywords):
                    return True
            elif isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Attribute) and t.attr == "requires_grad":
                        return True
    return False


@rule(
    "GL005",
    "saved-tensor-mutation",
    "in-place write to a tensor an earlier operation of the same "
    "autograd-recording function read",
    "Autograd saves the inputs of the operations it records; an in-place "
    "write to one of them afterwards (`x.add_(...)`, `x[i] = ...`) either "
    "fails the backward with a version-counter error or, through a view "
    "autograd did not track, silently differentiates the wrong values. In "
    "a function that records a graph (`requires_grad_`, "
    "`torch.autograd.grad`, `backward`, `torch.func`), write to a fresh "
    "tensor (`torch.where`, `x.clone()`) instead.",
)
def check_saved_tensor_mutation(mod: ModuleAnalysis) -> Iterator[Finding]:
    for fn in mod.functions():
        if isinstance(fn, ast.Lambda) or not _records_graph(fn):
            continue
        read: Set[str] = set()
        for stmt in fn.body:
            if isinstance(stmt, FUNC_NODES + (ast.ClassDef,)):
                continue
            # statements in source order; a name read by an expression
            # before the write may have been saved for the backward
            for node in sorted(
                    (n for n in walk_pruned(stmt)
                     if isinstance(n, (ast.Call, ast.Assign, ast.AugAssign, ast.BinOp))),
                    key=lambda n: (n.lineno, n.col_offset)):
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                    base = root_name(node.func.value)
                    if node.func.attr in _INPLACE_METHODS and base in read:
                        yield _finding(
                            mod, "GL005", node,
                            f"`{base}.{node.func.attr}(...)` writes in place to a "
                            f"tensor an earlier recorded operation read")
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                    for t in targets:
                        if isinstance(t, ast.Subscript):
                            base = root_name(t)
                            if base in read:
                                yield _finding(
                                    mod, "GL005", node,
                                    f"subscript store on `{base}` writes in place "
                                    f"to a tensor an earlier recorded operation read")
                    value = node.value
                    for n in ast.walk(value):
                        if isinstance(n, ast.Name):
                            read.add(n.id)
                elif isinstance(node, (ast.Call, ast.BinOp)):
                    args = (list(node.args) + [k.value for k in node.keywords]
                            if isinstance(node, ast.Call) else [node.left, node.right])
                    for a in args:
                        for n in ast.walk(a):
                            if isinstance(n, ast.Name):
                                read.add(n.id)


# ---------------------------------------------------------------------------
# GL006 — debug prints / callbacks in non-debug paths
# ---------------------------------------------------------------------------

_DEBUG_CALLS = {
    "breakpoint", "pdb.set_trace", "torch.autograd.set_detect_anomaly",
    "jax.debug.print", "debug.print",
    "jax.debug.callback", "debug.callback",
    "jax.debug.breakpoint", "debug.breakpoint",
    "jax.debug.visualize_array_sharding",
}


@rule(
    "GL006",
    "stray-debug",
    "debug hook (`breakpoint`, `pdb.set_trace`, anomaly detection, "
    "`jax.debug.print`/`callback`) outside a guarded debug path",
    "Debug hooks stop or slow every call: a breakpoint halts a served "
    "search, anomaly detection re-checks every backward op, and a "
    "`jax.debug` callback serializes dispatch on the host round-trip. "
    "They belong behind an explicit debug flag or in *debug* modules "
    "only.",
)
def check_stray_debug(mod: ModuleAnalysis) -> Iterator[Finding]:
    import os

    base = os.path.basename(mod.path).lower()
    if "debug" in base:
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        dn = dotted_name(node.func)
        if dn not in _DEBUG_CALLS:
            continue
        # allowed when an enclosing function or guarding `if` mentions
        # debug (e.g. `if options.debug_checks:`)
        allowed = False
        cur = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if "debug" in cur.name.lower():
                    allowed = True
                    break
            if isinstance(cur, ast.If):
                try:
                    test_src = ast.unparse(cur.test)
                except Exception:  # pragma: no cover
                    test_src = ""
                if "debug" in test_src.lower():
                    allowed = True
                    break
            cur = mod.parents.get(cur)
        if not allowed:
            yield _finding(
                mod, "GL006", node,
                f"`{dn}` in a non-debug path stops or slows every call; "
                f"guard it behind a debug flag or move it to a debug "
                f"module",
            )


# ---------------------------------------------------------------------------
# GL007 — device/IO work inside a signal handler (graftshield)
# ---------------------------------------------------------------------------

# Dotted-name prefixes that mean "this handler touches the device, the
# filesystem, or heavyweight serialization" — none of which is
# async-signal-safe, and a device call from a handler that interrupted
# the runtime can deadlock the process it was meant to preempt gracefully.
_SIGNAL_HAZARD_PREFIXES = (
    "torch.", "jax.", "jnp.", "np.", "numpy.", "pickle.", "json.",
)
_SIGNAL_HAZARD_NAMES = {
    "open", "float", "int", "device_get", "block_until_ready",
    "synchronize", "item", "cpu", "tolist",
    "save_search_state", "load_search_state",
}


def _signal_handler_names(mod: ModuleAnalysis) -> Set[str]:
    """Function/method names registered via `signal.signal(sig, fn)`."""
    out: Set[str] = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        if dotted_name(node.func) != "signal.signal" or len(node.args) < 2:
            continue
        handler = node.args[1]
        if isinstance(handler, ast.Name):
            out.add(handler.id)
        elif isinstance(handler, ast.Attribute):
            out.add(handler.attr)
    return out


@rule(
    "GL007",
    "signal-unsafe-handler",
    "device sync / IO / serialization inside a signal handler",
    "A signal handler runs at an arbitrary bytecode boundary — possibly "
    "inside the CUDA runtime or mid-checkpoint. torch calls, device syncs, "
    "pickling, or file writes from it can deadlock or corrupt the very "
    "state graftshield exists to save. Handlers must only set flags "
    "(threading.Event / attributes); the emergency checkpoint happens "
    "later, at the iteration boundary, on the main thread "
    "(shield/signals.py is the reference implementation).",
)
def check_signal_unsafe_handler(mod: ModuleAnalysis) -> Iterator[Finding]:
    handlers = _signal_handler_names(mod)
    if not handlers:
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, FUNC_NODES) or node.name not in handlers:
            continue
        for inner in ast.walk(node):
            if not isinstance(inner, ast.Call):
                continue
            dn = dotted_name(inner.func)
            if dn is None:
                continue
            last = dn.rsplit(".", 1)[-1]
            if dn.startswith(_SIGNAL_HAZARD_PREFIXES) or (
                dn in _SIGNAL_HAZARD_NAMES or last in _SIGNAL_HAZARD_NAMES
            ):
                yield _finding(
                    mod, "GL007", inner,
                    f"`{dn}` inside signal handler `{node.name}` — "
                    f"handlers must only set flags; do the work at the "
                    f"next iteration boundary",
                )




# ---------------------------------------------------------------------------
# GL008 — collective hazards in the mesh modules (torch.distributed)
# ---------------------------------------------------------------------------

# torch.distributed's collectives and the port's collective layer
# (parallel/collectives.py, mesh/plan.py, mesh/engine.py): every rank of
# a group must make each of them, in the same order.
_COLLECTIVES = {
    "all_gather", "all_gather_into_tensor", "all_gather_single", "all_gather_object",
    "all_reduce", "reduce", "reduce_scatter", "reduce_scatter_tensor", "broadcast",
    "broadcast_object_list", "barrier", "all_to_all", "all_to_all_single", "new_group",
    "all_gather_islands", "all_gather_tree", "ordered_sum", "all_sum", "first_of_ranks",
    "shard_row_sum", "shard_all", "sum_over_row_shards", "gather_state", "dedup_exchange",
}
# Names whose value differs from rank to rank.
_RANK_NAMES = {"rank", "get_rank", "local_rank", "group_rank", "global_rank", "is_rank0",
               "process_index", "island_index", "data_index"}


def _call_name(call: ast.Call) -> Optional[str]:
    dn = dotted_name(call.func)
    return dn.rsplit(".", 1)[-1] if dn else None


def _is_collective(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and _call_name(node) in _COLLECTIVES


def _rank_dependent(test: ast.AST) -> bool:
    for n in ast.walk(test):
        name = (n.id if isinstance(n, ast.Name) else n.attr if isinstance(n, ast.Attribute)
                else None)
        if name is not None and (name in _RANK_NAMES or name.endswith("_rank")):
            return True
    return False


def _host_sync(call: ast.Call) -> bool:
    dn = dotted_name(call.func)
    if dn in _CAST_CALLS and call.args and not isinstance(call.args[0], ast.Constant):
        return _reads_device_value(call.args[0])
    return (isinstance(call.func, ast.Attribute) and call.func.attr in _SYNC_METHODS
            and not call.args)


@rule(
    "GL008",
    "collective-hazard",
    "a collective under a rank-dependent branch, or a host sync between one "
    "iteration's collectives, in the mesh modules",
    "Every rank of a torch.distributed group must make each collective, in "
    "the same order: a collective that only some ranks reach (it sits under "
    "`if rank == 0:` or any branch on a rank, island or data index) leaves "
    "the others waiting until the group's timeout, which is a deadlock. A "
    "host sync (`.item()`, `.cpu()`, `float(t)`) between the collectives of "
    "one iteration stalls every rank on the slowest's device queue. Decide "
    "on every rank alike (agree first with `first_of_ranks`), and read "
    "values back after the iteration's last collective "
    "(mesh/engine.py and evolve/engine.py's epilogue are the reference).",
    scope=("mesh", "parallel"),
)
def check_collective_hazard(mod: ModuleAnalysis) -> Iterator[Finding]:
    seen: Set[Tuple[int, int]] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.If, ast.While, ast.IfExp)) and _rank_dependent(node.test):
            parts = ([node.body, node.orelse] if isinstance(node, ast.IfExp)
                     else node.body + node.orelse)
            for part in parts:
                for inner in ast.walk(part):
                    if _is_collective(inner) and (inner.lineno, inner.col_offset) not in seen:
                        seen.add((inner.lineno, inner.col_offset))
                        yield _finding(
                            mod, "GL008", inner,
                            f"`{_call_name(inner)}(...)` under a rank-dependent branch: "
                            f"the ranks that skip it leave the others waiting (deadlock)")
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, FUNC_NODES):
            continue
        calls = [n for n in walk_pruned(fn, prune=FUNC_NODES) if isinstance(n, ast.Call)]
        lines = [c.lineno for c in calls if _is_collective(c)]
        if len(lines) < 2:
            continue
        first, last = min(lines), max(lines)
        for c in calls:
            if first < c.lineno < last and _host_sync(c):
                yield _finding(
                    mod, "GL008", c,
                    f"`{dotted_name(c.func) or 'call'}` syncs with the host between the "
                    f"collectives of `{getattr(fn, 'name', 'lambda')}`: every rank waits on the slowest device "
                    f"queue there; read it after the last collective")
