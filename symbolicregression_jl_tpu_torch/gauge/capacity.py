"""Headroom model + proactive degrade (graftgauge, part d; a copy of the
JAX package's ``gauge/capacity.py``; in the port the step-down caps
graftstage's screening sample, evolve/engine.py).

Two capacity consumers of the footprint ledger and the live sampler:

- :class:`HeadroomModel` answers the admission-time question "does a
  request of this shape fit?" from fingerprint/geometry-keyed ledger
  history. Its answer is ADVISORY: the serve
  :class:`~..serve.admission.AdmissionController` attaches it to the
  decision (and the journaled accept record) but never rejects on it —
  the model is a floor estimate from observed programs, and a wrong
  "no" would be a false outage. Operators alert on the advisory;
  the shield still catches a real OOM.

- :class:`ProactiveDegrader` steps ``eval_tile_rows`` down BEFORE an
  OOM: when the per-iteration memory watermark crosses
  ``headroom_fraction`` of the known byte limit, it invokes the same
  ``Engine.degrade_eval_tile_rows`` ladder the shield uses reactively
  (docs/ROBUSTNESS.md) and emits a ``fault`` event (kind
  ``proactive_degrade``) — which also triggers the flight-recorder
  bundle dump, so the evidence of WHY the shape shrank is on disk.
  Default-off (``RuntimeOptions(gauge_headroom_fraction=None)``):
  stepping the launch geometry down changes results by design, so the
  knob must be an explicit opt-in to keep the default-config A/B
  bit-identity contract.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .footprint import FootprintLedger, global_ledger
from .sampler import device_memory_stats

__all__ = ["HeadroomModel", "ProactiveDegrader"]


class HeadroomModel:
    """Predict prospective footprints from ledger history."""

    def __init__(self, ledger: Optional[FootprintLedger] = None) -> None:
        self.ledger = ledger if ledger is not None else global_ledger()

    def predict_bytes(self, *, rows: Optional[int] = None,
                      nfeatures: Optional[int] = None,
                      fingerprint: Optional[str] = None
                      ) -> Optional[int]:
        """Largest known ``total_bytes`` among matching ledger entries
        (a floor — see FootprintLedger.predict_bytes), or None when the
        ledger has no history for the shape yet."""
        return self.ledger.predict_bytes(
            rows=rows, nfeatures=nfeatures, fingerprint=fingerprint)

    def advise(self, *, bucket, limit_bytes: Optional[int] = None,
               in_use_bytes: Optional[int] = None
               ) -> Optional[Dict[str, Any]]:
        """Admission advisory for one shape bucket ``(rows, nfeatures,
        nout)``: predicted program bytes vs the device byte budget.

        ``limit_bytes`` defaults to the card's total memory
        (``bytes_limit``; None on CPU — the advisory then reports the
        prediction with ``fits: None``, unknowable rather than
        fabricated). Returns None when the ledger knows nothing about
        the shape (no advisory beats a made-up one)."""
        rows, nfeatures = int(bucket[0]), int(bucket[1])
        predicted = self.predict_bytes(rows=rows, nfeatures=nfeatures)
        if predicted is None:
            return None
        stats = device_memory_stats()
        if limit_bytes is None and stats is not None:
            limit_bytes = stats.get("bytes_limit")
        if in_use_bytes is None and stats is not None:
            in_use_bytes = stats.get("bytes_in_use")
        out: Dict[str, Any] = {
            "predicted_bytes": int(predicted),
            "limit_bytes": (int(limit_bytes)
                            if limit_bytes is not None else None),
            "in_use_bytes": (int(in_use_bytes)
                             if in_use_bytes is not None else None),
            "headroom_bytes": None,
            "fits": None,
        }
        if limit_bytes:
            headroom = int(limit_bytes) - int(in_use_bytes or 0)
            out["headroom_bytes"] = headroom
            out["fits"] = bool(predicted <= headroom)
        return out


class ProactiveDegrader:
    """Watermark-driven ``eval_tile_rows`` step-down; see module
    docstring. Driven per iteration by the MemorySampler."""

    def __init__(
        self,
        degrade: Callable[[], Optional[int]],
        *,
        headroom_fraction: float,
        limit_bytes: Optional[int] = None,
        hub=None,
        cooldown: int = 2,
    ) -> None:
        if not (0.0 < float(headroom_fraction) <= 1.0):
            raise ValueError("headroom_fraction must be in (0, 1]")
        self.degrade = degrade
        self.headroom_fraction = float(headroom_fraction)
        # explicit budget (RuntimeOptions(gauge_limit_bytes) — the only
        # path on CPU); the per-check allocator limit overrides it when
        # the backend reports one
        self.limit_bytes = limit_bytes
        self.hub = hub
        # iterations to wait after a step-down before re-evaluating:
        # the smaller launch geometry needs at least one iteration to
        # show up in the watermark, and without the cooldown a single
        # excursion would ladder straight to the floor
        self.cooldown = max(int(cooldown), 0)
        self._cooldown_until = -1
        self.exhausted = False
        self.degrades = 0

    def check(self, iteration: int, *, watermark_bytes: int,
              limit_bytes: Optional[int] = None) -> bool:
        """Evaluate one iteration's watermark; returns True when a
        step-down happened. Never raises into the loop."""
        limit = limit_bytes if limit_bytes is not None else self.limit_bytes
        if limit is None or self.exhausted:
            return False
        if iteration < self._cooldown_until:
            return False
        threshold = self.headroom_fraction * float(limit)
        if float(watermark_bytes) <= threshold:
            return False
        try:
            new_rows = self.degrade()
        except Exception:  # noqa: BLE001 - protection must not crash
            return False
        self._cooldown_until = iteration + 1 + self.cooldown
        if new_rows is None:
            # already at the floor: record the exhaustion once, then go
            # quiet — the reactive shield path owns whatever comes next
            self.exhausted = True
        else:
            self.degrades += 1
        if self.hub is not None:
            try:
                self.hub.fault(
                    "proactive_degrade", iteration=int(iteration),
                    watermark_bytes=int(watermark_bytes),
                    limit_bytes=int(limit),
                    headroom_fraction=self.headroom_fraction,
                    eval_tile_rows=new_rows,
                    exhausted=self.exhausted or None,
                )
            except Exception:  # noqa: BLE001 - audit is best-effort
                pass
        return new_rows is not None
