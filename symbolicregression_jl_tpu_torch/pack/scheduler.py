"""Pack grouping + bin capacity: what may launch together, and how many
(a copy of the JAX package's ``pack/scheduler.py``).

A **pack group** is the set of requests that can share one engine and
launch geometry: same shape bucket (after padding every member to the
bucket's row count) and the same canonical Options kwargs (the
engine-cache key is the canonical options fingerprint — different
options would build different engines, defeating the point).

The **slot cap** is the bin capacity of one launch group. graftgauge's
:class:`~..gauge.HeadroomModel` per-bucket byte prediction is the
input: each extra tenant adds roughly one more program's working state,
so the cap is ``1 + headroom_bytes // predicted_bytes`` clamped to the
policy maximum. The advisory contract from admission carries over
unchanged — a missing prediction (cold ledger, no byte limit) never
hard-rejects; it just falls back to the policy cap, and the floor is
always one tenant (the lead launches regardless).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

__all__ = ["PackPolicy", "pack_group_key", "packable", "slot_cap"]


@dataclasses.dataclass
class PackPolicy:
    """Knobs of the packed scheduler (``SearchServer(pack=...)``).

    ``coalesce_window_s`` — how long a freshly-popped lead request waits
    for the rest of its burst before launching; late arrivals can still
    join a running cohort at iteration boundaries, so this only trades
    first-request latency against first-launch occupancy.
    ``join_poll_s`` — the cohort manager's poll interval for late joins
    while its tenants run. ``barrier_timeout_s`` — lockstep-barrier
    fallback: the barrier is scheduling-only (each tenant's numerics are
    a pure function of its own inputs), so releasing a round when a peer
    stalls is always safe.
    """

    max_tenants: int = 4
    coalesce_window_s: float = 0.05
    join_poll_s: float = 0.02
    barrier_timeout_s: float = 30.0


def packable(options_kwargs: Optional[Dict[str, Any]]) -> bool:
    """Whether a request's options are compatible with bucket padding.

    ``batching=True`` samples ``batch_size`` row indices uniformly over
    the materialized rows each cycle — pad rows would enter the sample
    and the search would no longer equal its unpadded meaning, so such
    requests run on the unpacked path (correctness over throughput).
    """
    return not bool((options_kwargs or {}).get("batching", False))


def pack_group_key(bucket: Tuple[int, int, int],
                   options_kwargs: Optional[Dict[str, Any]]) -> str:
    """Canonical co-launch key: shape bucket + exact options kwargs.

    The kwargs dict is JSON-able by the submit contract (the journal
    replays it), so a sorted dump is a stable canonical form.
    """
    return json.dumps(
        {"bucket": list(bucket), "options": options_kwargs or {}},
        sort_keys=True, separators=(",", ":"))


def slot_cap(policy: PackPolicy,
             memory_advice: Optional[Dict[str, Any]]) -> int:
    """Bin capacity of one launch group, from the headroom advisory.

    ``memory_advice`` is ``HeadroomModel.advise()``'s dict (or None):
    ``predicted_bytes`` for the bucket's program and ``headroom_bytes``
    left under the device budget. Absent either number the policy cap
    stands — the advisory becomes an input, never a hard reject.
    """
    cap = max(int(policy.max_tenants), 1)
    if not memory_advice:
        return cap
    try:
        predicted = memory_advice.get("predicted_bytes")
        headroom = memory_advice.get("headroom_bytes")
        if predicted and headroom is not None and int(predicted) > 0:
            fit = 1 + max(int(headroom), 0) // int(predicted)
            return max(1, min(cap, fit))
    except (TypeError, ValueError):
        pass
    return cap
