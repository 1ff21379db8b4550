"""The lockstep launch group: N tenant searches advancing in step (a copy
of the JAX package's ``pack/cohort.py``).

A :class:`PackedCohort` holds the live slot table of one pack launch.
Each tenant thread runs its own full ``equation_search`` (keeping its
journal records, checkpoints, ledger spans, and telemetry stream
exactly as on the unpacked path) and calls :meth:`arrive` from its
per-iteration logger probe; the barrier releases a round once every
active tenant has arrived. The engine is shared through the serve
ExecutableCache and all tenants run the same launch geometry, so lockstep
rounds keep the tenants' kernels (#1-#3) at one shape, round by round,
instead of N unrelated schedules.

Correctness stance: the barrier is **scheduling-only**. A tenant's
search result is a pure function of its own (padded) inputs and seed —
peers can arrive late, time out, join mid-flight, or peel off without
touching anyone's numerics. That is why the timeout fallback and
"leave releases the round" below are safe by construction, and why a
packed tenant is bit-identical to its solo run (tests/test_torch_serve.py
and ``chip_smoke.py`` phase 32 pin this).

The cohort lock is held only for the slot table and the barrier; it is
never held across file I/O or a device call, and the only blocking call
under it is ``Condition.wait`` inside a while-predicate loop.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["PackedCohort"]


class PackedCohort:
    """Slot table + iteration barrier of one pack launch group."""

    def __init__(self, group_key: str, *, slot_cap: int,
                 barrier_timeout_s: float = 30.0) -> None:
        self.group_key = group_key
        self.slot_cap = max(int(slot_cap), 1)
        self.barrier_timeout_s = float(barrier_timeout_s)
        self._lock = threading.Lock()
        self._barrier = threading.Condition(self._lock)
        self._active: Dict[int, str] = {}  # slot -> request_id
        self._next_slot = 0
        self._arrived: set = set()
        self._generation = 0
        # active-tenant count at each completed round: the occupancy
        # record (tenant-islands / capacity, per round) pack_done and
        # `bench load --packed` report
        self._rounds: List[int] = []
        self._tenants_total = 0
        self._peak = 0

    # ------------------------------------------------------------------
    def size(self) -> int:
        with self._lock:
            return len(self._active)

    def join(self, request_id: str) -> Optional[int]:
        """Claim a slot; None when the group is at its bin capacity.
        Joining mid-round simply grows the arrival quorum — the new
        tenant's first ``arrive`` closes the round like any other."""
        with self._lock:
            if len(self._active) >= self.slot_cap:
                return None
            slot = self._next_slot
            self._next_slot += 1
            self._active[slot] = request_id
            self._tenants_total += 1
            self._peak = max(self._peak, len(self._active))
            return slot

    def leave(self, slot: int) -> None:
        """Peel a tenant off at an iteration boundary (finished,
        cancelled, preempted, or failed). If the departing tenant was
        the last hold-out of the current round, the round releases."""
        with self._barrier:
            self._active.pop(slot, None)
            self._arrived.discard(slot)
            if self._active and len(self._arrived) >= len(self._active):
                self._release_round_locked()
            else:
                # waiters re-check their predicate (a shrunken quorum
                # may already be satisfied on the next arrival)
                self._barrier.notify_all()

    def arrive(self, slot: int) -> None:
        """Iteration-boundary barrier: block until every active tenant
        reaches its boundary, the round times out, or this tenant is no
        longer active. Scheduling-only — see the module docstring for
        why the timeout fallback cannot affect results."""
        with self._barrier:
            if slot not in self._active:
                return
            self._arrived.add(slot)
            gen = self._generation
            if len(self._arrived) >= len(self._active):
                self._release_round_locked()
                return
            deadline = time.monotonic() + self.barrier_timeout_s
            while (self._generation == gen and slot in self._active
                   and len(self._arrived) < len(self._active)):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._release_round_locked()
                    return
                self._barrier.wait(timeout=min(remaining, 0.1))
            if (self._generation == gen
                    and len(self._arrived) >= len(self._active)):
                self._release_round_locked()

    def _release_round_locked(self) -> None:
        self._rounds.append(len(self._active))
        self._generation += 1
        self._arrived.clear()
        self._barrier.notify_all()

    # ------------------------------------------------------------------
    def occupancy(self) -> Dict[str, Any]:
        """Launch-group summary for the ``pack_done`` serve event."""
        with self._lock:
            rounds = list(self._rounds)
            return {
                "tenants_total": self._tenants_total,
                "peak_tenants": self._peak,
                "slot_cap": self.slot_cap,
                "rounds": len(rounds),
                # mean per-round occupancy: active tenant-islands over
                # the bin capacity, averaged across lockstep rounds
                "occupancy": (
                    round(sum(rounds) / (len(rounds) * self.slot_cap), 4)
                    if rounds else None),
            }
