"""graftgauge: device capacity observability (docs/OBSERVABILITY.md,
"Capacity & memory"; port of the JAX package's ``gauge/``).

Four parts, wired by api/search.py and the serve layer:

- footprint.py — one probe iteration's allocator peak per launch
  geometry, in a process-wide fingerprint+geometry-keyed ledger;
- sampler.py — per-iteration device-memory accounting
  (``torch.cuda.memory_allocated`` and ``memory_stats()``; none on the
  CPU) with
  watermarks, the pulse leak tripwire, and bundle snapshots;
- latency.py — log-bucketed host-side dispatch-latency histograms,
  rendered on ``/metrics`` and in ``telemetry report``;
- capacity.py — the headroom model behind the serve layer's advisory
  memory-aware admission and the proactive ``eval_tile_rows``
  step-down (degrade BEFORE the OOM, not after).

Everything is host-side and — at the default knobs — bit-neutral to
the search (on/off HoF A/B pinned in tests/test_gauge.py, the same
contract pulse and ledger carry; in the port
tests/test_torch_diagnostics.py).
"""

from .capacity import HeadroomModel, ProactiveDegrader
from .footprint import (
    FootprintLedger,
    geometry_key,
    global_ledger,
    probe_engine_iteration,
    summarize_compiled,
)
from .latency import DEFAULT_LE_BOUNDS, DispatchLatency, global_latency
from .sampler import MemorySampler, device_memory_stats, process_peak_bytes

__all__ = [
    "DEFAULT_LE_BOUNDS",
    "DispatchLatency",
    "FootprintLedger",
    "HeadroomModel",
    "MemorySampler",
    "ProactiveDegrader",
    "device_memory_stats",
    "geometry_key",
    "global_latency",
    "global_ledger",
    "probe_engine_iteration",
    "process_peak_bytes",
    "summarize_compiled",
]
