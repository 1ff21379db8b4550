"""Live memory sampling at iteration boundaries (graftgauge, part b).

Port of the JAX package's ``gauge/sampler.py``. A telemetry-hub sink
that, once per iteration boundary, accounts the process' device memory
through PyTorch's caching allocator, in place of ``jax.live_arrays()``
and the backend's ``memory_stats()``:

- ``live_bytes`` is ``torch.cuda.memory_allocated`` (the bytes of live
  tensors on the card, no device call) and ``live_arrays`` the
  allocator's count of active blocks (``memory_stats()["active.all.
  current"]``); this is the signal the leak tripwire and the bundle
  snapshot use;
- ``stats`` is the allocator's truth in the JAX package's three fields:
  ``bytes_in_use`` (``allocated_bytes.all.current``),
  ``peak_bytes_in_use`` (``allocated_bytes.all.peak``) and
  ``bytes_limit`` (the card's total memory).

On the CPU there is no allocator to ask: the sampler degrades as the JAX
one does on a backend without memory stats, with ``stats: None`` (and
zero live bytes) rather than failing.

Per-iteration results feed four consumers, all host-side:

1. a ``gauge`` event (kind ``memory``) into the graftscope stream;
2. the graftpulse :class:`~..pulse.anomaly.AnomalyDetector` leak
   tripwire (``observe_live_bytes`` — monotonic growth over K
   iterations fires a ``live_bytes_growth`` anomaly, which also
   triggers a flight-recorder bundle dump);
3. the flight recorder's deterministic per-iteration view, as a
   BASELINE-RELATIVE delta: absolute live bytes include whatever else
   the process holds (a previous run's returned state, test fixtures),
   so the bundle records growth since run start — the part that is
   reproducible across identical runs — keeping the bundle
   byte-stability contract intact;
4. the proactive headroom degrader (capacity.py), handed the
   watermark so it can step ``eval_tile_rows`` down BEFORE an OOM.

Per-phase watermarks ride the host-span observer chain (the same
``(name, seconds)`` callback the cost ledger uses): the peak sampled
live bytes attributed to each named host phase's completion (the
latest iteration sample — spans do not re-walk the registry),
summarized into the run-end ``gauge`` event.

Reads only; never touches state, keys, or options — bit-neutral, with
the on/off HoF A/B pinned like pulse/ledger.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

__all__ = ["MemorySampler", "device_memory_stats", "process_peak_bytes"]

# Process-wide peak of live-array bytes observed by ANY sampler, for
# the serve /metrics surface (concurrent tenants share one device; the
# per-process peak is the capacity-relevant number).
_peak_lock = threading.Lock()
_process_peak = 0


def process_peak_bytes() -> int:
    with _peak_lock:
        return _process_peak


def _note_process_peak(live_bytes: int) -> None:
    global _process_peak
    with _peak_lock:
        if live_bytes > _process_peak:
            _process_peak = live_bytes


def _cuda_device(device=None):
    """The CUDA device to account: ``device`` when it is one, else the
    current device once this process has initialized CUDA, else None (a
    CPU run never initializes CUDA just to be measured)."""
    try:
        import torch

        if device is not None:
            device = torch.device(device)
            return device if device.type == "cuda" else None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch.device("cuda", torch.cuda.current_device())
    except Exception:  # noqa: BLE001 - sampling must never break the loop
        pass
    return None


def live_array_bytes(device=None) -> Dict[str, int]:
    """Bytes of live tensors and the allocator's active blocks on the
    card (no device traffic); zeros on the CPU. Never raises."""
    dev = _cuda_device(device)
    if dev is None:
        return {"live_bytes": 0, "live_arrays": 0}
    try:
        import torch

        stats = torch.cuda.memory_stats(dev)
        return {"live_bytes": int(torch.cuda.memory_allocated(dev)),
                "live_arrays": int(stats.get("active.all.current", 0))}
    except Exception:  # noqa: BLE001 - sampling must never break the loop
        return {"live_bytes": 0, "live_arrays": 0}


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The caching allocator's stats, normalized to the three fields the
    capacity layer uses — or None on the CPU, where there is no
    allocator to introspect."""
    dev = _cuda_device(device)
    if dev is None:
        return None
    try:
        import torch

        stats = torch.cuda.memory_stats(dev)
        return {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory),
        }
    except Exception:  # noqa: BLE001 - backend-optional introspection
        return None


class MemorySampler:
    """Telemetry-hub sink; see module docstring."""

    def __init__(self, hub, *, detector=None, recorder=None,
                 degrader=None, emit_every: int = 1, device=None) -> None:
        self.hub = hub
        self.device = device
        self.detector = detector
        self.degrader = degrader
        self.emit_every = max(int(emit_every), 1)
        base = live_array_bytes(device)
        # run-start baseline: the deterministic bundle view records
        # growth relative to this (absolute totals include unrelated
        # allocations the process already held)
        self.baseline_bytes = int(base["live_bytes"])
        self.baseline_arrays = int(base["live_arrays"])
        self.peak_live_bytes = self.baseline_bytes
        self.last: Optional[Dict[str, Any]] = None
        self._det_snapshot: Optional[Dict[str, int]] = None
        self.phase_peaks: Dict[str, int] = {}
        if recorder is not None:
            # recorder pulls the deterministic snapshot per iteration;
            # attribute hookup (not an import) keeps pulse free of any
            # gauge dependency
            recorder.memory_provider = self.deterministic_snapshot

    # -- host-span observer chain --------------------------------------
    def note_phase(self, name: str, seconds: float) -> None:
        """Per-phase live-bytes watermark; rides the same (name,
        seconds) span-observer callback as the cost ledger. Reuses the
        latest iteration sample rather than asking the allocator again,
        as the JAX package does: spans fire several times per
        iteration."""
        b = (self.last or {}).get("live_bytes", self.baseline_bytes)
        if b > self.phase_peaks.get(name, -1):
            self.phase_peaks[name] = b

    # -- recorder hookup -----------------------------------------------
    def deterministic_snapshot(self) -> Optional[Dict[str, int]]:
        """The baseline-relative part of the latest sample (what the
        flight-recorder bundle keeps in its deterministic view)."""
        return self._det_snapshot

    # -- hub sink protocol ---------------------------------------------
    def on_iteration(self, ctx) -> None:
        it = int(ctx.iteration)
        live = live_array_bytes(self.device)
        live_bytes = int(live["live_bytes"])
        stats = device_memory_stats(self.device)
        self.peak_live_bytes = max(self.peak_live_bytes, live_bytes)
        _note_process_peak(live_bytes)
        self._det_snapshot = {
            "live_bytes_delta": live_bytes - self.baseline_bytes,
            "live_arrays_delta": (int(live["live_arrays"])
                                  - self.baseline_arrays),
        }
        sample: Dict[str, Any] = {
            "live_bytes": live_bytes,
            "live_arrays": int(live["live_arrays"]),
            "peak_live_bytes": self.peak_live_bytes,
            "stats": stats,
        }
        self.last = sample
        if self.detector is not None:
            observe = getattr(self.detector, "observe_live_bytes", None)
            if observe is not None:
                observe(it, live_bytes)
        if self.degrader is not None:
            # allocator watermark where the backend has one (that is
            # what actually OOMs); live-array bytes otherwise
            watermark = (stats or {}).get("bytes_in_use", live_bytes)
            limit = (stats or {}).get("bytes_limit")
            self.degrader.check(it, watermark_bytes=watermark,
                                limit_bytes=limit)
        if it % self.emit_every == 0:
            self.hub.gauge(
                "memory", iteration=it, live_bytes=live_bytes,
                live_arrays=int(live["live_arrays"]),
                peak_live_bytes=self.peak_live_bytes,
                bytes_in_use=(stats or {}).get("bytes_in_use"),
                peak_bytes_in_use=(stats or {}).get("peak_bytes_in_use"),
                bytes_limit=(stats or {}).get("bytes_limit"),
            )

    def emit_final(self, iteration: int = 0) -> None:
        # final watermark summary; the search loop calls this right
        # before hub.finish() so the event lands BEFORE run_end (the
        # timeline exporter and tail follower read streams in order)
        self.hub.gauge(
            "watermark", iteration=int(iteration),
            peak_live_bytes=self.peak_live_bytes,
            baseline_bytes=self.baseline_bytes,
            phase_peaks=(dict(self.phase_peaks)
                         if self.phase_peaks else None),
        )
