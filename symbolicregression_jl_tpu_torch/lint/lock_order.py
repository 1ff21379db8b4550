"""The blessed lock acquisition order — graftwarden's manifest (port of
``lint/lock_order.py``).

The serve/shield thread fabric holds the JAX package's seven locks
(``SearchServer._lock`` — its ``_cond`` is a Condition over the same
lock —, ``AdmissionController._lock``, ``RequestJournal._lock``,
``ServeLog._lock``, ``ExecutableCache._lock``,
``MetricsServer._state_lock``, and ``_SharedSignalState.lock``, the
process-global signal-guard RLock of shield/signals.py), and the port
adds the locks its serve tenants share inside one process:

- ``_ProgramKernel._lock``: each kernel wrapper's launch counter and its
  library binding (ops/fused_eval.py);
- ``cuda_build._LOCK``: the build-and-load of a kernel library
  (ops/cuda_build.py), taken inside the binding;
- ``fused_eval._BF16_LOCK`` and ``fused_eval._WEIGHTED_LOCK``: the bf16
  copy of X and the weighted-rows count, one per data tensor (leaf locks);
- ``PackedCohort._lock``: a cohort's slot table and iteration barrier
  (pack/cohort.py; its ``_barrier`` is a Condition over it).

:data:`BLESSED_EDGES` is the committed partial order: ``(A, B)`` means
"holding A while acquiring B is sanctioned". The static analyzer
(lint/concurrency.py, rule GL010) flags any *derived* acquisition edge
whose reverse is reachable in this order, and the runtime auditor
(lint/racecheck.py) asserts every *actual* acquisition against the same
closure when ``debug_checks=True`` — one manifest, checked twice.

Adding an edge: append it here, run ``python -m
symbolicregression_jl_tpu_torch.lint`` (GL010 re-derives the graph), and
keep :func:`check_manifest_acyclic` green — a cycle in the manifest is a
deadlock blessed on paper.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Set, Tuple

__all__ = [
    "BLESSED_EDGES",
    "MANIFEST_LOCKS",
    "blessed_closure",
    "check_manifest_acyclic",
    "violates",
]

# (held, then-acquired): the sanctioned nesting, one tuple per edge.
BLESSED_EDGES: Tuple[Tuple[str, str], ...] = (
    # cancel()/_finish()/submit-rollback release the admission slot
    # while holding the server lock (admission's own lock is leaf-ward)
    ("SearchServer._lock", "AdmissionController._lock"),
    # start() attaches/detaches the process-global preemption guard
    # under the server lock (shield/signals.py refcounting)
    ("SearchServer._lock", "_SharedSignalState.lock"),
    # the overload ladder audits sheds/rejects to serve telemetry from
    # inside the admission decision
    ("AdmissionController._lock", "ServeLog._lock"),
    # the serve fault injector's journal-corruption hook audits from
    # inside the journal append
    ("RequestJournal._lock", "ServeLog._lock"),
    # a kernel wrapper binds its library (built and loaded at first use)
    # under its own lock
    ("_ProgramKernel._lock", "cuda_build._LOCK"),
)

# Every lock name the manifest talks about. The analyzers only assert
# order between locks in this universe; locks outside it (per-request
# watchdogs, test fixtures) are unordered by fiat.
MANIFEST_LOCKS: Tuple[str, ...] = tuple(sorted(
    {a for a, _ in BLESSED_EDGES} | {b for _, b in BLESSED_EDGES}
    | {"ExecutableCache._lock", "MetricsServer._state_lock",
       "fused_eval._BF16_LOCK", "fused_eval._WEIGHTED_LOCK", "PackedCohort._lock"}
))


def blessed_closure(
    edges: Sequence[Tuple[str, str]] = BLESSED_EDGES,
) -> Dict[str, Set[str]]:
    """``before -> {every lock reachable after it}`` (transitive)."""
    adj: Dict[str, Set[str]] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    out: Dict[str, Set[str]] = {}
    for src in adj:
        seen: Set[str] = set()
        work: List[str] = list(adj[src])
        while work:
            n = work.pop()
            if n in seen:
                continue
            seen.add(n)
            work.extend(adj.get(n, ()))
        out[src] = seen
    return out


def violates(
    held: str,
    acquiring: str,
    edges: Sequence[Tuple[str, str]] = BLESSED_EDGES,
) -> bool:
    """True when acquiring ``acquiring`` while holding ``held`` inverts
    the blessed order (i.e. the manifest sanctions the REVERSE path).
    Unrelated lock pairs are not violations — the manifest is a partial
    order, not a total one."""
    if held == acquiring:
        return False  # RLock reentrancy
    return held in blessed_closure(edges).get(acquiring, ())


def check_manifest_acyclic(
    edges: Iterable[Tuple[str, str]] = BLESSED_EDGES,
) -> None:
    """Raise ``ValueError`` if the manifest contains a cycle — a blessed
    deadlock. Run by the lint test suite on every edit."""
    edges = list(edges)
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}

    def visit(node: str, trail: List[str]) -> None:
        color[node] = GRAY
        trail.append(node)
        for nxt in adj.get(node, ()):
            c = color.get(nxt, WHITE)
            if c == GRAY:
                cyc = trail[trail.index(nxt):] + [nxt]
                raise ValueError(
                    "lock-order manifest has a cycle: "
                    + " -> ".join(cyc)
                )
            if c == WHITE:
                visit(nxt, trail)
        trail.pop()
        color[node] = BLACK

    for node in list(adj):
        if color.get(node, WHITE) == WHITE:
            visit(node, [])


# the committed manifest must itself be a DAG at import time
check_manifest_acyclic(BLESSED_EDGES)
