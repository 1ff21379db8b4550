"""Resource monitor: host-overhead fraction of the search loop.

A copy of the JAX package's ``utils/monitor.py``. The analogue of the
reference's ResourceMonitor (src/SearchUtils.jl:411-438): the reference estimates
head-node occupancy from the fraction of worker polls that found results
waiting; in the synchronous device loop the analogous quantity is the
fraction of wall time the host spends *outside* the device iteration
(HoF decode, CSV/checkpoint writes, logging). A high fraction means the
host bookkeeping — not the device — is pacing the search, mirroring the
reference's "head node occupied" warning (:485-489).
"""

from __future__ import annotations

import sys
import threading
import traceback
from collections import deque
from typing import Deque, Tuple

__all__ = ["ResourceMonitor", "thread_dump"]


def thread_dump() -> str:
    """Python stacks of every live thread, main thread first — the
    graftshield watchdog's diagnostic payload (shield/watchdog.py). A
    dispatch hung inside the device runtime shows up as the main thread
    blocked in a synchronize (or a specific kernel call), which
    is exactly the attribution an external ``timeout`` kill loses."""
    names = {t.ident: t.name for t in threading.enumerate()}
    main_id = threading.main_thread().ident
    frames = sys._current_frames()
    order = sorted(frames, key=lambda tid: (tid != main_id, tid))
    chunks = []
    for tid in order:
        name = names.get(tid, "?")
        tag = " (main)" if tid == main_id else ""
        stack = "".join(traceback.format_stack(frames[tid]))
        chunks.append(f"--- thread {name}{tag} [{tid}] ---\n{stack}")
    return "".join(chunks)


class ResourceMonitor:
    """Sliding-window tracker of device vs host time per iteration."""

    def __init__(self, window: int = 20, warn_fraction: float = 0.2):
        self.samples: Deque[Tuple[float, float]] = deque(maxlen=window)
        self.warn_fraction = warn_fraction
        self._warned = False

    def record(self, device_seconds: float, host_seconds: float) -> None:
        self.samples.append((float(device_seconds), float(host_seconds)))

    def estimate_work_fraction(self) -> float:
        """Fraction of loop time spent on host bookkeeping
        (estimate_work_fraction, src/SearchUtils.jl:432-438)."""
        dev = sum(d for d, _ in self.samples)
        host = sum(h for _, h in self.samples)
        total = dev + host
        return host / total if total > 0 else 0.0

    def check_and_warn(self, verbosity: int = 1) -> bool:
        """Warn when host overhead paces the search (the reference warns
        at 10s head occupancy estimates >= ~0.X).

        The warning is edge-triggered, not one-shot: it re-arms when the
        fraction drops back below the threshold (with a recovery note),
        so a host-overhead regression AFTER a recovery is not silent —
        the old latch never reset and swallowed every later excursion.
        """
        if len(self.samples) < self.samples.maxlen:
            return False
        frac = self.estimate_work_fraction()
        if frac > self.warn_fraction:
            if self._warned:
                return False
            self._warned = True
            if verbosity >= 1:
                print(
                    f"Warning: host bookkeeping is {frac:.0%} of loop time "
                    "— consider raising checkpoint_every_n / log_every_n or "
                    "reducing verbosity."
                )
            return True
        if self._warned:
            self._warned = False  # re-arm for the next excursion
            if verbosity >= 1:
                print(
                    f"Host bookkeeping recovered to {frac:.0%} of loop time."
                )
        return False
