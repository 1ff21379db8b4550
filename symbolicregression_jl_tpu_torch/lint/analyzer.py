"""Shared AST analysis for graftlint (port of ``lint/analyzer.py``).

The rules in :mod:`.rules` are small functions over a
:class:`ModuleAnalysis`, which precomputes what they need from a
module's source:

- a parent map (``ast`` has no uplinks),
- per-line suppression directives (``# graftlint: disable=GL003``),
- the *hot-loop* set: every function whose body runs once per cycle of
  the search, where one host synchronization stalls the launch queue.
  That is every function of ``evolve/step.py`` and ``evolve/mutation.py``
  (the generation step and its mutations), of any module carrying the
  directive ``# graftlint: hot-loop``, and every module-local function
  they call by simple name or ``self.<method>``.

The JAX package's analyzer finds traced bodies (``jax.jit``, ``vmap``,
``scan``); the port runs eagerly, and its counterpart of "a sync inside
a traced body" is "a sync inside the per-cycle loop".
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Set

__all__ = [
    "Finding",
    "ModuleAnalysis",
    "dotted_name",
    "parse_suppressions",
    "root_name",
    "walk_pruned",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding, pointing at a source line."""

    rule_id: str
    rule_name: str
    path: str
    line: int
    col: int
    message: str

    def __str__(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.rule_id}[{self.rule_name}] {self.message}"
        )


# ``# graftlint: disable`` suppresses every rule on the line;
# ``# graftlint: disable=GL001,GL003`` suppresses the listed rules.
_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable(?:=(?P<rules>[A-Za-z0-9_,\s-]+))?"
)

# Sentinel for "all rules suppressed on this line".
ALL_RULES = None


def parse_suppressions(source: str) -> Dict[int, Optional[Set[str]]]:
    """Map line number -> suppressed rule-id set (None = all rules).

    Directives are matched textually, so a suppression string inside a
    string literal also counts — acceptable for a repo linter, and it
    keeps the scanner independent of tokenization errors.
    """
    out: Dict[int, Optional[Set[str]]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = m.group("rules")
        if rules is None:
            out[i] = ALL_RULES
        else:
            out[i] = {
                r.strip().upper()
                for r in rules.replace(";", ",").split(",")
                if r.strip()
            }
    return out


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def root_name(node: ast.AST) -> Optional[str]:
    """Leftmost Name of an Attribute/Subscript chain (``a`` in ``a.b[0].c``)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def walk_pruned(node: ast.AST, prune=None):
    """``ast.walk`` that does not descend into nested function scopes.

    ``node`` itself is always yielded (even if function-like); children
    matching ``prune`` (default: function-like nodes) are skipped whole.
    """
    if prune is None:
        prune = FUNC_NODES
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, prune):
                continue
            stack.append(child)


FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

# Modules whose every function is on the per-cycle hot path
# (``evolve/<name>``), and the directive that marks any other module so.
HOT_LOOP_FILES = ("step.py", "mutation.py")
_HOT_LOOP_RE = re.compile(r"#\s*graftlint:\s*hot-loop")


def _is_hot_module(path: str, source: str) -> bool:
    parts = path.replace("\\", "/").split("/")
    if len(parts) >= 2 and parts[-2] == "evolve" and parts[-1] in HOT_LOOP_FILES:
        return True
    return bool(_HOT_LOOP_RE.search(source))


class ModuleAnalysis:
    """Parsed module + the shared analyses rules consume."""

    def __init__(self, source: str, path: str = "<string>"):
        self.source = source
        self.path = path
        self.tree = ast.parse(source)
        self.suppressions = parse_suppressions(source)

        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent

        # name -> function-like def nodes (module defs, nested defs,
        # methods, and lambdas bound via simple assignment).
        self._defs_by_name: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._defs_by_name.setdefault(node.name, []).append(node)
            elif isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Lambda
            ):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self._defs_by_name.setdefault(tgt.id, []).append(
                            node.value
                        )

        self.hot: Set[ast.AST] = set()
        self._compute_hot()

    # ------------------------------------------------------------------
    def _resolve_func_ref(self, node: ast.AST) -> List[ast.AST]:
        """Function-def nodes a reference may denote (over-approximate)."""
        if isinstance(node, ast.Lambda):
            return [node]
        if isinstance(node, ast.Name):
            return self._defs_by_name.get(node.id, [])
        if isinstance(node, ast.Attribute):
            # self._foo / cls._foo: resolve by method name anywhere in the
            # module (class attribution is an over-approximation).
            base = root_name(node)
            if base in ("self", "cls"):
                return self._defs_by_name.get(node.attr, [])
        return []

    def _compute_hot(self) -> None:
        if not _is_hot_module(self.path, self.source):
            return
        # every function of a hot module, and what they call by name
        work = list(self.functions())
        while work:
            fn = work.pop()
            if fn in self.hot:
                continue
            self.hot.add(fn)
            body = fn.body if isinstance(fn.body, list) else [fn.body]
            for stmt in body:
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Call):
                        for target in self._resolve_func_ref(node.func):
                            if target not in self.hot:
                                work.append(target)

    # ------------------------------------------------------------------
    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None and not isinstance(cur, FUNC_NODES):
            cur = self.parents.get(cur)
        return cur

    def in_hot_loop(self, node: ast.AST) -> bool:
        """Whether ``node`` sits in a function on the per-cycle hot path."""
        fn = self.enclosing_function(node)
        while fn is not None:
            if fn in self.hot:
                return True
            fn = self.enclosing_function(fn)
        return False

    def functions(self) -> Iterator[ast.AST]:
        for node in ast.walk(self.tree):
            if isinstance(node, FUNC_NODES):
                yield node

    def is_suppressed(self, rule_id: str, line: int) -> bool:
        if line not in self.suppressions:
            return False
        rules = self.suppressions[line]
        return rules is ALL_RULES or rule_id.upper() in rules
