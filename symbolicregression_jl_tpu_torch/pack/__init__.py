"""graftpack — device-level multi-tenant packing (docs/SERVING.md,
"Packed tenancy"; port of the JAX package's ``pack/``, host-side and
unchanged).

The serve layer timeshares tenants per worker: one search runs while
queued requests wait. This package turns co-queued same-bucket requests
into **one device program's worth of concurrent work**:

- :mod:`.padding` pads a request's dataset to its pow2 admission bucket
  (serve/admission.py ``shape_bucket``) with the pad rows zero-weighted
  out of every loss/norm, so near-miss shapes share one launch geometry
  of kernels #1-#3 instead of requiring exact row equality;
- :mod:`.scheduler` decides what may pack together (``pack_group_key``,
  ``packable``) and how many tenants one launch group may hold
  (``slot_cap`` — graftgauge's per-bucket byte prediction is the bin
  capacity input, advisory-floored at one tenant);
- :mod:`.cohort` is the lockstep launch group: tenants join, run their
  (unchanged, individually-journaled) searches in step via a
  per-iteration barrier, and peel off at iteration boundaries when they
  finish, are cancelled, or are preempted.

The packed path never changes a tenant's numerics: each search is a
pure function of its own (padded) inputs, the barrier only shapes
scheduling, and the padding itself is journaled effective
configuration (``SearchRequest.bucket_rows``/``pad_rows``) — so every
tenant's result is bit-identical to the same request run alone, and the
graftserve kill-restart-replay contract holds unchanged under packing.
"""

from .cohort import PackedCohort
from .padding import pad_to_bucket
from .scheduler import PackPolicy, pack_group_key, packable, slot_cap

__all__ = [
    "PackPolicy",
    "PackedCohort",
    "pack_group_key",
    "packable",
    "pad_to_bucket",
    "slot_cap",
]
