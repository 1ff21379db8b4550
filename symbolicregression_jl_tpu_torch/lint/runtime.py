"""Runtime invariant auditing for the postfix program tables, and guards
for the hot loop (port of ``lint/runtime.py``).

Three tools, all debug-tier:

- :func:`validate_programs` / :func:`check_programs`: the structural
  invariants of the padded postfix encoding (ops/encoding.py), on numpy
  copies of a :class:`~..ops.encoding.TreeBatch`. A corrupt table
  evaluates without error and silently breeds garbage, so
  ``Options(debug_checks=True)`` runs this checker on the engine's
  population and hall of fame at ``init_state`` and after every
  ``run_iteration``. The checks and their messages are the JAX package's.
- :func:`compile_count_guard`: bounds how many kernel libraries are
  built or loaded in a region, from the build-and-load events of
  ``ops/cuda_build.py`` (the counter behind the telemetry hub's
  ``recompiles``); a warm iteration builds and loads nothing.
- :func:`no_transfer`: ``torch.cuda.set_sync_debug_mode("error")`` over a
  region.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..ops.encoding import LEAF_CONST, LEAF_PARAM, LEAF_VAR, MAX_ARITY

__all__ = [
    "ProgramInvariantError",
    "CompileBudgetExceeded",
    "CompileStats",
    "check_programs",
    "validate_programs",
    "compile_count_guard",
    "no_transfer",
]


class ProgramInvariantError(AssertionError):
    """A postfix program table violates a structural invariant."""


class CompileBudgetExceeded(AssertionError):
    """More kernel builds or loads happened in a guarded region than allowed."""


def _resolve_nops(operators) -> Tuple[int, ...]:
    """Per-arity operator counts (index d-1 = arity d) from an
    OperatorSet, a dict {arity: n}, or a plain sequence."""
    if operators is None:
        return ()
    if hasattr(operators, "nops_tuple"):
        return tuple(operators.nops_tuple())
    if isinstance(operators, dict):
        ma = max(operators) if operators else 0
        return tuple(int(operators.get(d, 0)) for d in range(1, ma + 1))
    return tuple(int(n) for n in operators)


def _host(x) -> np.ndarray:
    """A numpy copy of a tensor (any device) or array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _subtree_sizes(arity: np.ndarray, D: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Subtree sizes per slot via the postfix prefix-sum identity
    ``start(k) = max{ j <= k : D(j-1) == D(k) - 1 }``, size = k-start+1;
    O(N*L) memory and one Python loop over the L slots."""
    N, L = arity.shape
    Dm1 = D - (1 - arity)  # exclusive prefix sum
    rows = np.arange(N)
    last_at = np.full((N, L + 2), -1, np.int64)
    start = np.empty((N, L), np.int64)
    for k in range(L):
        last_at[rows, np.clip(Dm1[:, k], 0, L + 1)] = k
        start[:, k] = last_at[rows, np.clip(D[:, k] - 1, 0, L + 1)]
    start = np.clip(start, 0, np.arange(L)[None, :])
    return np.arange(L)[None, :] - start + 1, start


def check_programs(
    trees,
    operators=None,
    *,
    nfeatures: Optional[int] = None,
    n_params: Optional[int] = None,
    strict_padding: bool = False,
    max_report: int = 10,
) -> List[str]:
    """Check every tree of a (any batch shape) TreeBatch; return the
    violations as readable strings (empty: every invariant holds). Tensors
    are copied to the host.

    Invariants (ops/encoding.py):

    1. ``1 <= length <= L``.
    2. ``0 <= arity <= MAX_ARITY`` on used slots.
    3. op-code ranges: leaves in {LEAF_CONST, LEAF_VAR, LEAF_PARAM};
       arity-d operators index the d-ary table (``op < nops[d-1]``).
    4. postfix stack discipline: the stack height ``D(k) = sum_{j<=k}
       (1 - arity_j)`` stays >= 1 and ends at exactly 1.
    5. span recurrence: every operator's child spans tile its own span.
    6. padding: slots ``k >= length`` hold arity 0 (and, with
       ``strict_padding``, zero op/feat/const).
    7. optional leaf payloads: features in ``[0, nfeatures)``, parameter
       indices in ``[0, n_params)``.
    """
    arity = _host(trees.arity)
    op = _host(trees.op)
    feat = _host(trees.feat)
    const = _host(trees.const)
    length = _host(trees.length)

    L = arity.shape[-1]
    arity = arity.reshape(-1, L).astype(np.int64)
    op = op.reshape(-1, L).astype(np.int64)
    feat = feat.reshape(-1, L).astype(np.int64)
    const = const.reshape(-1, L)
    length = length.reshape(-1).astype(np.int64)
    N = arity.shape[0]
    nops = _resolve_nops(operators)

    msgs: List[str] = []

    def report(mask: np.ndarray, fmt) -> None:
        idx = np.flatnonzero(mask)
        room = max(0, max_report - len(msgs))
        for i in idx[:room]:
            msgs.append(fmt(int(i)))
        omitted = len(idx) - min(room, len(idx))
        if omitted > 0:
            msgs.append(f"... (+{omitted} more of this kind, report truncated)")

    # 1. length bounds
    bad_len = (length < 1) | (length > L)
    report(bad_len, lambda i: f"tree {i}: length {length[i]} outside [1, {L}]")
    if bad_len.any():
        length = np.clip(length, 1, L)

    used = np.arange(L)[None, :] < length[:, None]

    # 2. arity range
    bad_arity = used & ((arity < 0) | (arity > MAX_ARITY))
    report(bad_arity.any(axis=1), lambda i: (
        f"tree {i}: arity outside [0, {MAX_ARITY}] at slots "
        f"{np.flatnonzero(bad_arity[i]).tolist()}"))

    # 3. op-code ranges
    is_leaf = arity == 0
    bad_leaf = used & is_leaf & ((op < LEAF_CONST) | (op > LEAF_PARAM))
    report(bad_leaf.any(axis=1), lambda i: (
        f"tree {i}: leaf op code outside "
        f"{{{LEAF_CONST},{LEAF_VAR},{LEAF_PARAM}}} at slots "
        f"{np.flatnonzero(bad_leaf[i]).tolist()}"))
    if nops:
        for d in range(1, len(nops) + 1):
            sel = used & (arity == d)
            bad_op = sel & ((op < 0) | (op >= max(nops[d - 1], 1)))
            if nops[d - 1] == 0:
                bad_op = sel
            report(bad_op.any(axis=1), lambda i, d=d, bad=bad_op: (
                f"tree {i}: arity-{d} op index outside [0, {nops[d - 1]}) at slots "
                f"{np.flatnonzero(bad[i]).tolist()}"))

    # 4. stack discipline
    safe_arity = np.clip(arity, 0, MAX_ARITY)
    step = np.where(used, 1 - safe_arity, 0)
    D = np.cumsum(step, axis=1)
    under = used & (D < 1)
    report(under.any(axis=1), lambda i: (
        f"tree {i}: postfix stack underflow at slot "
        f"{int(np.flatnonzero(under[i])[0])} (operator consumes "
        f"operands that don't exist — subtree contiguity broken)"))
    final = D[np.arange(N), length - 1]
    bad_final = (~under.any(axis=1)) & (final != 1)
    report(bad_final, lambda i: (
        f"tree {i}: postfix stack ends at height {int(final[i])} "
        f"(expected 1) — {int(final[i]) - 1} unrooted subtree(s)"))

    # 5. span recurrence
    structurally_ok = ~(under.any(axis=1) | bad_final | bad_arity.any(axis=1))
    if structurally_ok.any():
        sizes, _ = _subtree_sizes(safe_arity, D)
        k = np.arange(L)[None, :]
        un = used & (safe_arity == 1)
        bin_ = used & (safe_arity == 2)
        prev = np.maximum(k - 1, 0)
        size_prev = np.take_along_axis(sizes, np.broadcast_to(prev, sizes.shape), axis=1)
        left_root = np.maximum(k - 1 - size_prev, 0)
        size_left = np.take_along_axis(sizes, left_root, axis=1)
        bad_un = un & (sizes != 1 + size_prev)
        bad_bin = bin_ & (sizes != 1 + size_prev + size_left)
        bad_span = (bad_un | bad_bin) & structurally_ok[:, None]
        report(bad_span.any(axis=1), lambda i: (
            f"tree {i}: child spans do not tile the subtree span at "
            f"slots {np.flatnonzero(bad_span[i]).tolist()}"))

    # 6. padding cleanliness
    pad = ~used
    dirty_arity = pad & (arity != 0)
    report(dirty_arity.any(axis=1), lambda i: (
        f"tree {i}: nonzero arity in padding slots "
        f"{np.flatnonzero(dirty_arity[i]).tolist()} (corrupts the "
        f"full-axis structural prefix sums)"))
    if strict_padding:
        dirty = pad & ((op != 0) | (feat != 0) | (const != 0))
        report(dirty.any(axis=1), lambda i: (
            f"tree {i}: padding slots "
            f"{np.flatnonzero(dirty[i]).tolist()} not zeroed "
            f"(non-canonical table: hashing/dedup equality breaks)"))

    # 7. leaf payload ranges
    if nfeatures is not None:
        var = used & is_leaf & (op == LEAF_VAR)
        bad_feat = var & ((feat < 0) | (feat >= nfeatures))
        report(bad_feat.any(axis=1), lambda i: (
            f"tree {i}: variable feature outside [0, {nfeatures}) at "
            f"slots {np.flatnonzero(bad_feat[i]).tolist()}"))
    if n_params is not None:
        par = used & is_leaf & (op == LEAF_PARAM)
        bad_par = par & ((feat < 0) | (feat >= max(n_params, 1)))
        if n_params == 0:
            bad_par = par
        report(bad_par.any(axis=1), lambda i: (
            f"tree {i}: parameter index outside [0, {n_params}) at "
            f"slots {np.flatnonzero(bad_par[i]).tolist()}"))

    return msgs


def validate_programs(
    trees,
    operators=None,
    *,
    nfeatures: Optional[int] = None,
    n_params: Optional[int] = None,
    where: str = "",
    strict_padding: bool = False,
    max_report: int = 10,
) -> int:
    """Raise :class:`ProgramInvariantError` on any violation; return the
    number of trees checked when clean."""
    msgs = check_programs(trees, operators, nfeatures=nfeatures, n_params=n_params,
                          strict_padding=strict_padding, max_report=max_report)
    if msgs:
        ctx = f" [{where}]" if where else ""
        raise ProgramInvariantError(
            f"postfix program table invariants violated{ctx}:\n  " + "\n  ".join(msgs))
    return int(np.prod(tuple(trees.length.shape))) or 1


# ---------------------------------------------------------------------------
# Hot-loop budget guards
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompileStats:
    """Counters filled in by :func:`compile_count_guard`: ``traces`` counts
    kernel libraries loaded into the process, ``backend_compiles`` the
    nvcc builds behind them (the names are the telemetry hub's). A warm
    region adds neither."""

    traces: int = 0
    backend_compiles: int = 0


@contextlib.contextmanager
def compile_count_guard(max_compiles: Optional[int] = None, *,
                        what: str = "guarded region") -> Iterator[CompileStats]:
    """Count kernel builds and library loads (``ops/cuda_build.py``'s
    events) in a region; raise :class:`CompileBudgetExceeded` when the
    loads exceed ``max_compiles``.

    Usage::

        engine.run_iteration(state, data, maxsize)       # warm-up
        with compile_count_guard(max_compiles=0):
            engine.run_iteration(state2, data, maxsize)  # builds nothing
    """
    from ..ops import cuda_build

    stats = CompileStats()

    def on_event(kind: str, name: str, secs: float) -> None:
        if kind == "load":
            stats.traces += 1
        elif kind == "build":
            stats.backend_compiles += 1

    cuda_build.add_listener(on_event)
    try:
        yield stats
    finally:
        cuda_build.remove_listener(on_event)
    if max_compiles is not None and stats.traces > max_compiles:
        raise CompileBudgetExceeded(
            f"{what}: {stats.traces} kernel library load(s) "
            f"({stats.backend_compiles} nvcc build(s)), budget is {max_compiles} "
            f"— a kernel source or its flags are being built in the hot loop")


@contextlib.contextmanager
def no_transfer(level: str = "error"):
    """Raise on a device-to-host synchronization in the region.

    ``torch.cuda.set_sync_debug_mode(level)`` for the region, restored
    after: ``"error"`` raises on the first synchronizing call, ``"warn"``
    only warns. Torch flags every host sync (``.item()``, ``.cpu()``,
    ``float()`` of a CUDA tensor, a ``nonzero``, a blocking copy), where
    the JAX package's ``jax.transfer_guard`` flags only implicit transfers
    and lets explicit ``device_get`` through; an explicit copy is a sync
    here too. Launches, device-side ops and host-to-device copies of
    pinned memory pass. On the CPU, or without CUDA, it is a no-op: there
    is no device to wait for.
    """
    import torch

    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(level)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
