"""graftwarden — interprocedural lock-discipline analysis (GL009-GL014),
port of ``lint/concurrency.py``; the rules apply unchanged.

graftlint's GL001-GL007 are single-module AST checks; the serve/shield
thread fabric needs more: hazards such as journal fsyncs under the
server-wide lock, cancel racing submit's unlocked append, or stale
preemption-guard state are only visible when you know *which locks are
held at a call site, through calls*. This module builds that view over
the concurrent slice of the package — ``serve/``, ``shield/``,
``pack/`` (the cohort's tenant threads), ``pulse/``, ``telemetry/``,
and ``utils/stdin_quit.py``:

1. **lock inventory** — every ``self.X = threading.Lock/RLock/
   Condition`` attribute, with Condition-over-existing-lock ALIASING
   resolved (``SearchServer._cond`` *is* ``SearchServer._lock``), plus
   module-level shared instances (``shield.signals._STATE``);
2. **per-class call graph** — ``self.m()``, ``self.attr.m()`` through
   constructor-resolved attribute types (``self.admission =
   AdmissionController(...)``, ``self._guard =
   PreemptionGuard().install()``), module functions, and
   ``Ctor().m()`` builder chains;
3. **lock-context dataflow** — which locks are held at every statement
   (``with`` nesting, try/except de-scoping), propagated through the
   call graph as may-acquire / may-block / may-dispatch summaries with
   witness chains.

Rules emitted (same ``# graftlint: disable=RULE`` suppression and CLI
as GL001-GL008; docs/LINT.md "Concurrency rules" is the catalog):

- **GL009** blocking I/O (``open``/``os.fsync``/``time.sleep``/...)
  while holding a lock, directly or through a callee;
- **GL010** lock-order inversion: the derived global acquisition graph
  must be acyclic AND consistent with the blessed partial order
  committed in :mod:`.lock_order`;
- **GL011** unguarded shared mutation: an attribute written both from a
  ``threading.Thread(target=self.m)`` entry point's closure and from
  the class's other (public-path) methods, with any write lockless;
- **GL012** ``Condition.wait`` outside a ``while``-predicate loop
  (lost-wakeup / spurious-wakeup hazard);
- **GL013** device dispatch / device-blocking calls (``torch.*``, a
  search) while holding a lock (one tenant's kernel build or sync would
  serialize every other thread);
- **GL014** interprocedural GL007: anything transitively reachable
  from a registered signal handler must stay flag-only.

The runtime counterpart is :mod:`.racecheck`, which asserts the same
:mod:`.lock_order` manifest against *actual* acquisition order.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .analyzer import (
    FUNC_NODES,
    Finding,
    ModuleAnalysis,
    dotted_name,
)
from .lock_order import violates
from .rules import (
    RULES,
    _SIGNAL_HAZARD_NAMES,
    _SIGNAL_HAZARD_PREFIXES,
    rule,
)

__all__ = ["ConcurrencyAnalysis", "analysis_for"]

# Directory components (plus the one utils file) the warden analyzes —
# the concurrent slice of the package. The rule `scope=` uses the same
# tuple, so fixtures under pkg/serve/... exercise the rules too.
_SCOPE_DIRS = ("serve", "shield", "pack", "pulse", "telemetry")
_SCOPE_FILES = ("stdin_quit.py",)
_RULE_SCOPE = _SCOPE_DIRS + _SCOPE_FILES

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "Lock", "RLock"}
_COND_CTORS = {"threading.Condition", "Condition"}
_THREAD_CTORS = {"threading.Thread", "Thread"}

# Calls that block on I/O or the scheduler — poison under a lock every
# other thread contends for. `.join`/`.flush`/`write` are deliberately
# absent: flagging them would bury the true fsync/open findings in
# noise (a buffered write under a log lock is the working idiom).
_BLOCKING_CALLS = {
    "open", "os.fsync", "os.fdatasync", "os.replace", "os.rename",
    "os.remove", "os.unlink", "os.makedirs", "time.sleep",
    "json.dump", "pickle.dump", "np.save", "np.load",
    "numpy.save", "numpy.load", "shutil.rmtree", "shutil.copy",
    "shutil.copyfile", "shutil.move", "subprocess.run",
    "subprocess.Popen", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output",
}

# Device dispatch / device-blocking surface (GL013): a kernel build or a
# blocking sync under the server-wide lock stalls submit/poll/cancel for
# every tenant until the device returns. The JAX package's names stay, so
# its fixtures read the same here.
_DEVICE_PREFIXES = ("torch.", "jax.", "jnp.")
_DEVICE_NAMES = {
    "equation_search", "block_until_ready", "device_get", "device_put",
    "synchronize",
}


class _ClassInfo:
    def __init__(self, name: str, path: str) -> None:
        self.name = name
        self.path = path
        self.methods: Dict[str, ast.AST] = {}
        # attr -> canonical lock name ("Class.attr"); Condition aliases
        # resolve to their underlying lock's canonical name
        self.locks: Dict[str, str] = {}
        self.conds: Dict[str, str] = {}
        self.attr_types: Dict[str, str] = {}
        self.thread_entries: Set[str] = set()


class _FuncInfo:
    def __init__(self, qual: str, node: ast.AST, mod: ModuleAnalysis,
                 cls: Optional[_ClassInfo]) -> None:
        self.qual = qual
        self.node = node
        self.mod = mod
        self.cls = cls
        # direct facts (filled by _summarize)
        self.acquire_locks: Dict[str, ast.AST] = {}
        self.blocking: List[Tuple[str, ast.AST]] = []
        self.dispatching: List[Tuple[str, ast.AST]] = []
        self.calls: Set[str] = set()

    @property
    def display(self) -> str:
        return self.qual.rsplit("::", 1)[-1]


def _short(qual: str) -> str:
    return qual.rsplit("::", 1)[-1]


def _canon(path: str) -> str:
    return os.path.realpath(os.path.abspath(path))


class ConcurrencyAnalysis:
    """Whole-package (or single-fixture) concurrency facts + findings."""

    def __init__(self, mods: Sequence[ModuleAnalysis]) -> None:
        self.mods = list(mods)
        self.classes: Dict[str, _ClassInfo] = {}
        self.module_funcs: Dict[str, Dict[str, str]] = {}
        self.module_vars: Dict[str, Dict[str, str]] = {}
        self.funcs: Dict[str, _FuncInfo] = {}
        self.findings: List[Finding] = []
        # (held, acquired) -> (path, line, col, chain)
        self.edges: Dict[Tuple[str, str],
                         Tuple[str, int, int, Tuple[str, ...]]] = {}
        self._finding_keys: Set[Tuple] = set()
        self._collect()
        self._summarize()
        self._fixpoint()
        for fi in self.funcs.values():
            self._analyze_func(fi)
        self._check_lock_order()
        self._check_shared_mutation()
        self._check_cond_wait()
        self._check_signal_closure()

    # ------------------------------------------------------------------
    # collection
    # ------------------------------------------------------------------
    def _collect(self) -> None:
        # pass 1: classes, methods, module funcs, lock attributes
        for mod in self.mods:
            self.module_funcs[mod.path] = {}
            self.module_vars[mod.path] = {}
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{mod.path}::{node.name}"
                    self.module_funcs[mod.path][node.name] = qual
                    self.funcs[qual] = _FuncInfo(qual, node, mod, None)
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                ci = _ClassInfo(node.name, mod.path)
                for item in node.body:
                    if isinstance(item,
                                  (ast.FunctionDef, ast.AsyncFunctionDef)):
                        ci.methods[item.name] = item
                self.classes[node.name] = ci
                for item in ci.methods.values():
                    for n in ast.walk(item):
                        a = self._self_assign(n)
                        if a is None:
                            continue
                        attr, value = a
                        if isinstance(value, ast.Call):
                            dn = dotted_name(value.func)
                            if dn in _LOCK_CTORS:
                                ci.locks[attr] = f"{ci.name}.{attr}"
                for item in ci.methods.values():
                    self.funcs[f"{ci.name}.{item.name}"] = _FuncInfo(
                        f"{ci.name}.{item.name}", item, mod, ci)

        # pass 2 (needs the global class-name set and pass-1 locks):
        # Condition aliasing, attribute types, module-level instances,
        # thread entry points
        for mod in self.mods:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    tgt = node.targets[0]
                    if (isinstance(tgt, ast.Name)
                            and self._enclosing_class(mod, node) is None
                            and mod.enclosing_function(node) is None):
                        cls = self._ctor_class(node.value)
                        if cls is not None:
                            self.module_vars[mod.path][tgt.id] = cls
            for ci in self.classes.values():
                if ci.path != mod.path:
                    continue
                for item in ci.methods.values():
                    for n in ast.walk(item):
                        a = self._self_assign(n)
                        if a is None:
                            continue
                        attr, value = a
                        if not isinstance(value,
                                          (ast.Call, ast.BoolOp)):
                            continue
                        dn = (dotted_name(value.func)
                              if isinstance(value, ast.Call) else None)
                        if dn in _LOCK_CTORS:
                            continue  # pass 1
                        if dn in _COND_CTORS:
                            under = None
                            if isinstance(value, ast.Call) and value.args:
                                arg0 = value.args[0]
                                if (isinstance(arg0, ast.Attribute)
                                        and isinstance(arg0.value, ast.Name)
                                        and arg0.value.id == "self"):
                                    under = ci.locks.get(arg0.attr)
                            ci.conds[attr] = under or f"{ci.name}.{attr}"
                            continue
                        cls = self._ctor_class(value)
                        if cls is not None:
                            ci.attr_types[attr] = cls
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                if dotted_name(node.func) not in _THREAD_CTORS:
                    continue
                target = None
                for kw in node.keywords:
                    if kw.arg == "target":
                        target = kw.value
                if target is None and len(node.args) >= 2:
                    target = node.args[1]
                if (isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"):
                    ci = self._enclosing_class(mod, node)
                    if ci is not None and target.attr in ci.methods:
                        ci.thread_entries.add(target.attr)

    @staticmethod
    def _self_assign(n: ast.AST) -> Optional[Tuple[str, ast.AST]]:
        """(attr, value) for a direct ``self.attr = value``."""
        if not isinstance(n, ast.Assign) or len(n.targets) != 1:
            return None
        tgt = n.targets[0]
        if (isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"):
            return tgt.attr, n.value
        return None

    def _enclosing_class(self, mod: ModuleAnalysis,
                         node: ast.AST) -> Optional[_ClassInfo]:
        cur = mod.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return self.classes.get(cur.name)
            cur = mod.parents.get(cur)
        return None

    def _ctor_class(self, value: ast.AST) -> Optional[str]:
        """Class name a constructor-ish expression evaluates to:
        ``C(...)``, ``x or C(...)``, ``C(...).install()`` builder
        chains (assumed to return self)."""
        if isinstance(value, ast.BoolOp):
            for v in value.values:
                c = self._ctor_class(v)
                if c is not None:
                    return c
            return None
        if isinstance(value, ast.Call):
            dn = dotted_name(value.func)
            if dn is not None:
                last = dn.rsplit(".", 1)[-1]
                if last in self.classes:
                    return last
            if isinstance(value.func, ast.Attribute):
                return self._ctor_class(value.func.value)
        return None

    # ------------------------------------------------------------------
    # resolution
    # ------------------------------------------------------------------
    def _resolve_lock(self, fi: _FuncInfo,
                      expr: ast.AST) -> Optional[str]:
        """Canonical lock name of an acquisition expression
        (``self._lock``, ``self._cond``, ``_STATE.lock``)."""
        if not (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)):
            return None
        base, attr = expr.value.id, expr.attr
        if base == "self" and fi.cls is not None:
            if attr in fi.cls.locks:
                return fi.cls.locks[attr]
            if attr in fi.cls.conds:
                return fi.cls.conds[attr]
            return None
        cls = self.module_vars.get(fi.mod.path, {}).get(base)
        if cls is not None:
            ci = self.classes.get(cls)
            if ci is not None:
                return ci.locks.get(attr) or ci.conds.get(attr)
        return None

    def _resolve_call(self, fi: _FuncInfo,
                      call: ast.Call) -> Optional[str]:
        f = call.func
        if isinstance(f, ast.Name):
            q = self.module_funcs.get(fi.mod.path, {}).get(f.id)
            if q is not None:
                return q
            if f.id in self.classes:
                init = f"{f.id}.__init__"
                return init if init in self.funcs else None
            return None
        if not isinstance(f, ast.Attribute):
            return None
        v = f.value
        if isinstance(v, ast.Name):
            if v.id == "self" and fi.cls is not None:
                if f.attr in fi.cls.methods:
                    return f"{fi.cls.name}.{f.attr}"
                t = fi.cls.attr_types.get(f.attr)
                if t is not None and f.attr in self.classes.get(
                        t, _ClassInfo("", "")).methods:
                    return f"{t}.{f.attr}"
                return None
            cls = self.module_vars.get(fi.mod.path, {}).get(v.id)
            if cls is not None and f.attr in self.classes.get(
                    cls, _ClassInfo("", "")).methods:
                return f"{cls}.{f.attr}"
            return None
        if (isinstance(v, ast.Attribute)
                and isinstance(v.value, ast.Name)
                and v.value.id == "self" and fi.cls is not None):
            # self.attr.m() through the constructor-resolved attr type
            t = fi.cls.attr_types.get(v.attr)
            if t is not None and f.attr in self.classes.get(
                    t, _ClassInfo("", "")).methods:
                return f"{t}.{f.attr}"
            return None
        if isinstance(v, ast.Call):
            # Ctor().m() builder chain
            cls = self._ctor_class(v)
            if cls is not None and f.attr in self.classes.get(
                    cls, _ClassInfo("", "")).methods:
                return f"{cls}.{f.attr}"
        return None

    # ------------------------------------------------------------------
    # summaries + fixpoint
    # ------------------------------------------------------------------
    def _summarize(self) -> None:
        for fi in self.funcs.values():
            body = fi.node.body
            body = body if isinstance(body, list) else [body]
            for stmt in body:
                for n in _walk_no_nested(stmt):
                    if isinstance(n, (ast.With, ast.AsyncWith)):
                        for item in n.items:
                            ln = self._resolve_lock(fi, item.context_expr)
                            if ln is not None:
                                fi.acquire_locks.setdefault(
                                    ln, item.context_expr)
                    if not isinstance(n, ast.Call):
                        continue
                    if (isinstance(n.func, ast.Attribute)
                            and n.func.attr == "acquire"):
                        ln = self._resolve_lock(fi, n.func.value)
                        if ln is not None:
                            fi.acquire_locks.setdefault(ln, n)
                    dn = dotted_name(n.func)
                    if dn in _BLOCKING_CALLS:
                        fi.blocking.append((dn, n))
                    elif dn is not None and (
                            dn.startswith(_DEVICE_PREFIXES)
                            or dn in _DEVICE_NAMES):
                        fi.dispatching.append((dn, n))
                    q = self._resolve_call(fi, n)
                    if q is not None and q != fi.qual:
                        fi.calls.add(q)

    def _fixpoint(self) -> None:
        # qual -> lock -> witness chain (quals, ending at the acquirer)
        self.may_acquire: Dict[str, Dict[str, Tuple[str, ...]]] = {}
        # qual -> (description, witness chain)
        self.may_block: Dict[str, Tuple[str, Tuple[str, ...]]] = {}
        self.may_dispatch: Dict[str, Tuple[str, Tuple[str, ...]]] = {}
        for q, fi in self.funcs.items():
            self.may_acquire[q] = {
                ln: (q,) for ln in fi.acquire_locks}
            if fi.blocking:
                self.may_block[q] = (fi.blocking[0][0], (q,))
            if fi.dispatching:
                self.may_dispatch[q] = (fi.dispatching[0][0], (q,))
        for _ in range(len(self.funcs) + 1):
            changed = False
            for q, fi in self.funcs.items():
                for callee in fi.calls:
                    for ln, chain in self.may_acquire.get(
                            callee, {}).items():
                        if ln not in self.may_acquire[q]:
                            self.may_acquire[q][ln] = (q,) + chain
                            changed = True
                    if callee in self.may_block and q not in self.may_block:
                        desc, chain = self.may_block[callee]
                        self.may_block[q] = (desc, (q,) + chain)
                        changed = True
                    if callee in self.may_dispatch and q not in self.may_dispatch:
                        desc, chain = self.may_dispatch[callee]
                        self.may_dispatch[q] = (desc, (q,) + chain)
                        changed = True
            if not changed:
                break

    # ------------------------------------------------------------------
    # findings plumbing
    # ------------------------------------------------------------------
    def _emit(self, rid: str, fi: _FuncInfo, node: ast.AST,
              msg: str) -> None:
        key = (rid, fi.mod.path, getattr(node, "lineno", 1),
               getattr(node, "col_offset", 0))
        if key in self._finding_keys:
            return
        self._finding_keys.add(key)
        self.findings.append(Finding(
            rule_id=rid,
            rule_name=RULES[rid].name if rid in RULES else rid,
            path=fi.mod.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=msg,
        ))

    def findings_for(self, path: str, rid: str) -> Iterator[Finding]:
        # Package-mode modules are loaded from disk with absolute paths
        # while the CLI may lint with relative ones — match on realpath
        # and re-attribute to the requesting module's spelling so
        # run_rules' suppression filter and output stay consistent.
        want = _canon(path)
        for f in self.findings:
            if f.rule_id != rid or _canon(f.path) != want:
                continue
            if f.path != path:
                f = Finding(
                    rule_id=f.rule_id, rule_name=f.rule_name, path=path,
                    line=f.line, col=f.col, message=f.message)
            yield f

    def _edge(self, held: str, acquired: str, fi: _FuncInfo,
              node: ast.AST, chain: Tuple[str, ...] = ()) -> None:
        if held == acquired:
            return  # RLock reentrancy / condition re-entry
        self.edges.setdefault(
            (held, acquired),
            (fi.mod.path, getattr(node, "lineno", 1),
             getattr(node, "col_offset", 0), chain))

    # ------------------------------------------------------------------
    # lock-context dataflow (GL009, GL010 edges, GL013, GL011 writes)
    # ------------------------------------------------------------------
    def _analyze_func(self, fi: _FuncInfo) -> None:
        self._writes: Dict[Tuple[str, str], List] = getattr(
            self, "_writes", {})
        body = fi.node.body
        body = body if isinstance(body, list) else [body]
        self._visit_stmts(fi, body, ())

    def _visit_stmts(self, fi: _FuncInfo, stmts, held: Tuple[str, ...]
                     ) -> None:
        for s in stmts:
            if isinstance(s, FUNC_NODES + (ast.ClassDef,)):
                continue  # separate scope/execution time
            if isinstance(s, (ast.With, ast.AsyncWith)):
                cur = list(held)
                for item in s.items:
                    ln = self._resolve_lock(fi, item.context_expr)
                    if ln is not None:
                        for h in cur:
                            self._edge(h, ln, fi, item.context_expr)
                        cur.append(ln)
                    else:
                        self._visit_expr(fi, item.context_expr,
                                         tuple(cur))
                self._visit_stmts(fi, s.body, tuple(cur))
            elif isinstance(s, ast.Try):
                self._visit_stmts(fi, s.body, held)
                for h in s.handlers:
                    self._visit_stmts(fi, h.body, held)
                self._visit_stmts(fi, s.orelse, held)
                self._visit_stmts(fi, s.finalbody, held)
            elif isinstance(s, ast.If):
                self._visit_expr(fi, s.test, held)
                self._visit_stmts(fi, s.body, held)
                self._visit_stmts(fi, s.orelse, held)
            elif isinstance(s, (ast.For, ast.AsyncFor)):
                self._visit_expr(fi, s.iter, held)
                self._visit_stmts(fi, s.body, held)
                self._visit_stmts(fi, s.orelse, held)
            elif isinstance(s, ast.While):
                self._visit_expr(fi, s.test, held)
                self._visit_stmts(fi, s.body, held)
                self._visit_stmts(fi, s.orelse, held)
            else:
                self._record_writes(fi, s, held)
                for child in ast.iter_child_nodes(s):
                    if isinstance(child, ast.expr):
                        self._visit_expr(fi, child, held)

    def _record_writes(self, fi: _FuncInfo, s: ast.stmt,
                       held: Tuple[str, ...]) -> None:
        if fi.cls is None:
            return
        targets: List[ast.AST] = []
        if isinstance(s, ast.Assign):
            targets = list(s.targets)
        elif isinstance(s, (ast.AugAssign, ast.AnnAssign)):
            targets = [s.target]
        for t in targets:
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                mname = fi.qual.split(".", 1)[1]
                self._writes.setdefault(
                    (fi.cls.name, mname), []).append(
                        (t.attr, bool(held), t, fi))

    def _visit_expr(self, fi: _FuncInfo, e: Optional[ast.AST],
                    held: Tuple[str, ...]) -> None:
        if e is None:
            return
        for n in _walk_no_nested(e):
            if not isinstance(n, ast.Call):
                continue
            if (isinstance(n.func, ast.Attribute)
                    and n.func.attr == "acquire"):
                ln = self._resolve_lock(fi, n.func.value)
                if ln is not None:
                    for h in held:
                        self._edge(h, ln, fi, n)
                    continue
            dn = dotted_name(n.func)
            if held and dn in _BLOCKING_CALLS:
                self._emit(
                    "GL009", fi, n,
                    f"`{dn}(...)` while holding `{held[-1]}` — blocking "
                    f"I/O under a lock stalls every thread contending "
                    f"for it; move the I/O outside the lock",
                )
                continue
            if held and dn is not None and (
                    dn.startswith(_DEVICE_PREFIXES) or dn in _DEVICE_NAMES):
                self._emit(
                    "GL013", fi, n,
                    f"`{dn}(...)` while holding `{held[-1]}` — device "
                    f"dispatch or sync under a lock serializes every "
                    f"other thread on the device; dispatch outside the lock",
                )
                continue
            q = self._resolve_call(fi, n)
            if q is None:
                continue
            if held and q in self.may_block:
                desc, chain = self.may_block[q]
                self._emit(
                    "GL009", fi, n,
                    f"call to `{_short(q)}` performs blocking I/O "
                    f"(`{desc}` via "
                    f"{' -> '.join(_short(c) for c in chain)}) while "
                    f"holding `{held[-1]}`; move the call outside the "
                    f"lock",
                )
            if held and q in self.may_dispatch:
                desc, chain = self.may_dispatch[q]
                self._emit(
                    "GL013", fi, n,
                    f"call to `{_short(q)}` dispatches to the device "
                    f"(`{desc}` via "
                    f"{' -> '.join(_short(c) for c in chain)}) while "
                    f"holding `{held[-1]}`; dispatch outside the lock",
                )
            for ln, chain in self.may_acquire.get(q, {}).items():
                for h in held:
                    self._edge(h, ln, fi, n, chain)

    # ------------------------------------------------------------------
    # GL010 — derived acquisition graph: cycles + manifest inversions
    # ------------------------------------------------------------------
    def _check_lock_order(self) -> None:
        adj: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, set()).add(b)

        def reaches(src: str, dst: str) -> bool:
            seen: Set[str] = set()
            work = [src]
            while work:
                n = work.pop()
                if n == dst:
                    return True
                if n in seen:
                    continue
                seen.add(n)
                work.extend(adj.get(n, ()))
            return False

        for (a, b), (path, line, col, chain) in sorted(
                self.edges.items()):
            fi = _SyntheticSite(path, line, col)
            via = (f" (via {' -> '.join(_short(c) for c in chain)})"
                   if chain else "")
            if reaches(b, a):
                self._emit(
                    "GL010", fi, fi,
                    f"acquiring `{b}` while holding `{a}`{via} "
                    f"completes a cycle in the derived lock graph "
                    f"(`{b}` already reaches `{a}`): deadlock under "
                    f"the right interleaving",
                )
            elif violates(a, b):
                self._emit(
                    "GL010", fi, fi,
                    f"acquiring `{b}` while holding `{a}`{via} inverts "
                    f"the blessed lock order (lint/lock_order.py "
                    f"sanctions `{b}` before `{a}`)",
                )

    # ------------------------------------------------------------------
    # GL011 — unguarded shared mutation across thread boundary
    # ------------------------------------------------------------------
    def _thread_closure(self, ci: _ClassInfo) -> Set[str]:
        work = [f"{ci.name}.{m}" for m in ci.thread_entries]
        seen: Set[str] = set()
        while work:
            q = work.pop()
            if q in seen or q not in self.funcs:
                continue
            seen.add(q)
            work.extend(self.funcs[q].calls)
        return seen

    def _check_shared_mutation(self) -> None:
        writes = getattr(self, "_writes", {})
        for ci in self.classes.values():
            if not ci.thread_entries:
                continue
            closure = self._thread_closure(ci)
            thread_methods = {
                q.split(".", 1)[1] for q in closure
                if q.startswith(ci.name + ".")}
            by_attr: Dict[str, Dict[str, List]] = {}
            for (cname, mname), ws in writes.items():
                if cname != ci.name or mname == "__init__":
                    continue
                side = ("thread" if mname in thread_methods else "main")
                for (attr, locked, node, fi) in ws:
                    by_attr.setdefault(attr, {"thread": [], "main": []})[
                        side].append((locked, node, fi, mname))
            for attr, sides in by_attr.items():
                if not sides["thread"] or not sides["main"]:
                    continue
                for locked, node, fi, mname in (
                        sides["thread"] + sides["main"]):
                    if locked:
                        continue
                    entry = sorted(ci.thread_entries)[0]
                    self._emit(
                        "GL011", fi, node,
                        f"`self.{attr}` is written both from the "
                        f"`{ci.name}.{entry}` thread's call closure and "
                        f"from the class's other methods, and this "
                        f"write in `{mname}` holds no lock — guard "
                        f"every write with the owning lock",
                    )

    # ------------------------------------------------------------------
    # GL012 — Condition.wait outside a while-predicate loop
    # ------------------------------------------------------------------
    def _check_cond_wait(self) -> None:
        for fi in self.funcs.values():
            for n in ast.walk(fi.node):
                if not (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "wait"):
                    continue
                recv = n.func.value
                ln = None
                if (isinstance(recv, ast.Attribute)
                        and isinstance(recv.value, ast.Name)):
                    base, attr = recv.value.id, recv.attr
                    if (base == "self" and fi.cls is not None
                            and attr in fi.cls.conds):
                        ln = fi.cls.conds[attr]
                    else:
                        cls = self.module_vars.get(
                            fi.mod.path, {}).get(base)
                        if cls is not None:
                            ln = self.classes.get(
                                cls, _ClassInfo("", "")).conds.get(attr)
                if ln is None:
                    continue  # Event.wait / unknown receiver
                cur = fi.mod.parents.get(n)
                in_while = False
                while cur is not None and not isinstance(cur, FUNC_NODES):
                    if isinstance(cur, ast.While):
                        in_while = True
                        break
                    cur = fi.mod.parents.get(cur)
                if not in_while:
                    self._emit(
                        "GL012", fi, n,
                        f"`Condition.wait` on `{ln}` outside a "
                        f"while-predicate loop — spurious wakeups and "
                        f"notify-before-wait races require "
                        f"`while not <predicate>: cond.wait()`",
                    )

    # ------------------------------------------------------------------
    # GL014 — interprocedural signal-handler closure (GL007, but deep)
    # ------------------------------------------------------------------
    def _signal_handlers(self) -> Dict[str, str]:
        """qual -> registered display name, from signal.signal calls."""
        out: Dict[str, str] = {}
        for mod in self.mods:
            for n in ast.walk(mod.tree):
                if not (isinstance(n, ast.Call)
                        and dotted_name(n.func) == "signal.signal"
                        and len(n.args) >= 2):
                    continue
                h = n.args[1]
                name = None
                if isinstance(h, ast.Name):
                    name = h.id
                elif isinstance(h, ast.Attribute):
                    name = h.attr
                if name is None:
                    continue
                q = self.module_funcs.get(mod.path, {}).get(name)
                if q is None:
                    for cname, ci in self.classes.items():
                        if name in ci.methods:
                            q = f"{cname}.{name}"
                            break
                if q is not None:
                    out[q] = name
        return out

    def _check_signal_closure(self) -> None:
        handlers = self._signal_handlers()
        if not handlers:
            return
        parent: Dict[str, Optional[str]] = {}
        work = list(handlers)
        for q in work:
            parent[q] = None
        while work:
            q = work.pop()
            fi = self.funcs.get(q)
            if fi is None:
                continue
            for callee in fi.calls:
                if callee not in parent:
                    parent[callee] = q
                    work.append(callee)
        for q in parent:
            if q in handlers:
                continue  # direct hazards in the handler are GL007's
            fi = self.funcs.get(q)
            if fi is None:
                continue
            chain: List[str] = []
            cur: Optional[str] = q
            while cur is not None:
                chain.append(_short(cur))
                cur = parent[cur]
            chain.reverse()
            root = chain[0]
            for n in ast.walk(fi.node):
                if not isinstance(n, ast.Call):
                    continue
                dn = dotted_name(n.func)
                if dn is None:
                    continue
                last = dn.rsplit(".", 1)[-1]
                if dn.startswith(_SIGNAL_HAZARD_PREFIXES) or (
                        dn in _SIGNAL_HAZARD_NAMES
                        or last in _SIGNAL_HAZARD_NAMES):
                    self._emit(
                        "GL014", fi, n,
                        f"`{dn}` is reachable from signal handler "
                        f"`{handlers.get(root, root)}` "
                        f"(via {' -> '.join(chain)}) — everything a "
                        f"handler can reach must stay flag-only; do "
                        f"the work at the next iteration boundary",
                    )


class _SyntheticSite:
    """Finding site for graph-level (edge) findings: quacks like a
    node (lineno/col_offset) and like a _FuncInfo (mod.path)."""

    def __init__(self, path: str, line: int, col: int) -> None:
        self.lineno = line
        self.col_offset = col
        self.mod = type("_M", (), {"path": path})()


def _walk_no_nested(node: ast.AST):
    """ast.walk that does not descend into nested function/class
    scopes (node itself is yielded even if function-like)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, FUNC_NODES + (ast.ClassDef,)):
                continue
            stack.append(child)


# ---------------------------------------------------------------------------
# package assembly + caching
# ---------------------------------------------------------------------------

_PACKAGE_CACHE: Dict[str, ConcurrencyAnalysis] = {}
_SINGLE_CACHE: List = [None, None]  # [mod, analysis]


def _package_root(path: str) -> Optional[str]:
    parts = os.path.abspath(path).replace("\\", "/").split("/")
    for i in range(len(parts) - 1, 0, -1):
        if parts[i] in _SCOPE_DIRS or parts[i] == "utils":
            root = "/".join(parts[:i])
            if os.path.isdir(os.path.join(root, "serve")):
                return root
    return None


def analysis_for(mod: ModuleAnalysis) -> ConcurrencyAnalysis:
    """The (cached) package-wide analysis covering ``mod`` — or a
    single-module analysis when ``mod`` is a synthetic fixture whose
    package root does not exist on disk."""
    root = _package_root(mod.path)
    if root is None:
        if _SINGLE_CACHE[0] is mod:
            return _SINGLE_CACHE[1]
        ana = ConcurrencyAnalysis([mod])
        _SINGLE_CACHE[0], _SINGLE_CACHE[1] = mod, ana
        return ana
    cached = _PACKAGE_CACHE.get(root)
    if cached is not None:
        return cached
    paths: List[str] = []
    for d in _SCOPE_DIRS:
        full = os.path.join(root, d)
        if os.path.isdir(full):
            for fn in sorted(os.listdir(full)):
                if fn.endswith(".py"):
                    paths.append(os.path.join(full, fn))
    for fn in _SCOPE_FILES:
        p = os.path.join(root, "utils", fn)
        if os.path.isfile(p):
            paths.append(p)
    mods: List[ModuleAnalysis] = []
    mod_real = os.path.realpath(os.path.abspath(mod.path))
    for p in paths:
        if os.path.realpath(p) == mod_real:
            mods.append(mod)
            continue
        try:
            with open(p, "r", encoding="utf-8") as f:
                mods.append(ModuleAnalysis(f.read(), p))
        except (OSError, SyntaxError, ValueError):
            continue  # GL000 reports parse failures; skip here
    if mod.path not in {m.path for m in mods}:
        mods.append(mod)
    ana = ConcurrencyAnalysis(mods)
    _PACKAGE_CACHE[root] = ana
    return ana


# ---------------------------------------------------------------------------
# rule registrations
# ---------------------------------------------------------------------------


@rule(
    "GL009",
    "lock-blocking-io",
    "blocking I/O (open/fsync/sleep/...) while holding a lock, "
    "directly or through a callee",
    "An fsync'd journal append under the server-wide lock stalls "
    "submit/poll/cancel and every worker's queue transition for a "
    "disk round-trip: journal/audit writes belong outside "
    "`self._lock`. Locks that exist "
    "specifically to serialize one file's writes (the serve log, the "
    "journal) annotate the write with "
    "`# graftlint: disable=GL009`.",
    scope=_RULE_SCOPE,
)
def check_blocking_io_under_lock(mod: ModuleAnalysis) -> Iterator[Finding]:
    yield from analysis_for(mod).findings_for(mod.path, "GL009")


@rule(
    "GL010",
    "lock-order-inversion",
    "acquisition edge that cycles the derived lock graph or inverts "
    "the blessed order in lint/lock_order.py",
    "Two threads taking the same two locks in opposite orders is a "
    "deadlock waiting for the right interleaving. The warden derives "
    "the global acquisition graph (with-nesting plus call-graph "
    "propagation) and checks it against the committed partial order; "
    "new legitimate edges are added to lint/lock_order.py, where the "
    "racecheck runtime auditor asserts them too.",
    scope=_RULE_SCOPE,
)
def check_lock_order_inversion(mod: ModuleAnalysis) -> Iterator[Finding]:
    yield from analysis_for(mod).findings_for(mod.path, "GL010")


@rule(
    "GL011",
    "unguarded-shared-write",
    "attribute written from a Thread-target closure AND from other "
    "methods with at least one write lockless",
    "State shared between a worker thread and the public API needs "
    "one owning lock on every write; a lockless write on either side "
    "is a data race the GIL hides until a preemption lands between "
    "read-modify-write steps. Thread-confined attributes (written "
    "only by the worker) are fine and not flagged.",
    scope=_RULE_SCOPE,
)
def check_unguarded_shared_write(mod: ModuleAnalysis) -> Iterator[Finding]:
    yield from analysis_for(mod).findings_for(mod.path, "GL011")


@rule(
    "GL012",
    "naked-cond-wait",
    "Condition.wait outside a while-predicate loop",
    "Condition.wait can return spuriously and a notify can land "
    "before the wait starts; only `while not predicate: cond.wait()` "
    "is correct (a lost wake-up hangs wait_idle). Event.wait "
    "is level-triggered and exempt.",
    scope=_RULE_SCOPE,
)
def check_naked_cond_wait(mod: ModuleAnalysis) -> Iterator[Finding]:
    yield from analysis_for(mod).findings_for(mod.path, "GL012")


@rule(
    "GL013",
    "device-under-lock",
    "device dispatch / device-blocking call while holding a lock",
    "A kernel build or blocking device sync under the server-wide "
    "lock freezes submit/poll/cancel for every tenant until the device "
    "returns — up to minutes for a cold nvcc build. Dispatch outside "
    "the lock; publish results under it.",
    scope=_RULE_SCOPE,
)
def check_device_under_lock(mod: ModuleAnalysis) -> Iterator[Finding]:
    yield from analysis_for(mod).findings_for(mod.path, "GL013")


@rule(
    "GL014",
    "signal-closure-hazard",
    "device/IO/serialization work transitively reachable from a "
    "registered signal handler",
    "GL007 checks the handler body; this closes the loophole of a "
    "flag-only handler calling a helper that fsyncs or pickles. A "
    "signal handler runs at an arbitrary bytecode boundary, so its "
    "whole call closure must stay flag-only "
    "(shield/signals.py is the reference).",
    scope=_RULE_SCOPE,
)
def check_signal_closure_hazard(mod: ModuleAnalysis) -> Iterator[Finding]:
    yield from analysis_for(mod).findings_for(mod.path, "GL014")
