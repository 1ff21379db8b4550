"""Graceful degradation: transient-failure retries and a step-down of the
screening sample.

Port of the search half of ``symbolicregression_jl_tpu/shield/degrade.py``
(``OverloadLadder``, the serving half, comes with the serving stack,
ROADMAP.md queue 1 item 7). Transient device failures (a CUDA
out-of-memory under memory pressure from a neighbour on a shared card, an
unavailable peer) should cost a bounded retry, not the whole search. The
:class:`ShieldRunner` wraps each ``Engine.run_iteration`` attempt:

1. transient failures retry with exponential backoff (base
   ``Options(retry_backoff)``, doubling, capped) up to
   ``Options(max_retries)`` times; after an out-of-memory the runner
   returns PyTorch's cached blocks to the driver
   (``torch.cuda.empty_cache()``) before it waits;
2. when the retries run out on an out-of-memory, the engine steps down
   (``Engine.degrade_eval_tile_rows`` halves ``cfg.eval_tile_rows``, which
   in the port caps graftstage's screening sample), the retry budget
   resets and the iteration runs again;
3. anything else, or an out-of-memory with no step left, re-raises.

Every retry and step emits a ``fault`` record. The classification reads
the exception's type (``torch.cuda.OutOfMemoryError``) and its text (the
markers below, as the fault-injection harness spells them too). Errors
that leave the CUDA context unusable (an illegal memory access, a
device-side assert, a launch failure) are never retried: every later call
on that context fails as well. Nor is a failed kernel build
(``ops/cuda_build.py``'s nvcc), which fails the same way again.

A failed attempt leaves its input state as it was: ``Engine.run_iteration``
writes only into tensors it allocated (tests/test_torch_shield.py pins
it), so a retry starts from the same state and key and ends bit-identical
to a run that never failed.
"""

from __future__ import annotations

import time
import traceback
from typing import Callable

import torch

__all__ = ["ShieldRunner", "is_transient_failure", "TRANSIENT_MARKERS", "STICKY_MARKERS"]

# Substrings (case-sensitive) that mark a failure as worth retrying. Every
# _OOM_MARKERS entry is here too: an out-of-memory must be transient, or
# the degradation ladder never gets its turn.
TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "Resource exhausted",
    "Out of memory",
    "out of memory",
    "Failed to allocate",
    "UNAVAILABLE",
    "ABORTED",
    "DEADLINE_EXCEEDED",
    "Failed to deserialize",   # the JAX package's compile-cache glitches, kept
    "compilation cache",       # so both classify every text alike
)

_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "Resource exhausted",
    "Out of memory",
    "out of memory",
    "Failed to allocate",
)

# Never transient, whatever else the text says: a sticky CUDA error leaves
# the context unusable, and a kernel build that failed fails again.
STICKY_MARKERS = (
    "illegal memory access",
    "device-side assert triggered",
    "unspecified launch failure",
    "cudaErrorLaunchFailure",
    "nvcc",
)


# What PyTorch raises when the caching allocator cannot serve a request.
_OOM_TYPES = tuple(t for t in (getattr(torch.cuda, "OutOfMemoryError", None),
                               getattr(torch, "OutOfMemoryError", None)) if t is not None)


def _is_sticky(exc: BaseException) -> bool:
    msg = str(exc)
    return any(m in msg for m in STICKY_MARKERS)


def _is_oom(exc: BaseException) -> bool:
    if _is_sticky(exc):
        return False
    if isinstance(exc, _OOM_TYPES):
        return True
    msg = str(exc)
    return any(m in msg for m in _OOM_MARKERS)


def is_transient_failure(exc: BaseException) -> bool:
    if _is_sticky(exc):
        return False
    if _is_oom(exc):
        return True
    msg = str(exc)
    return any(m in msg for m in TRANSIENT_MARKERS)


def _free_cached_memory(exc: BaseException) -> None:
    """Release the failed attempt's tensors (the locals of the frames in
    ``exc``'s traceback) and return the caching allocator's free blocks to
    the driver, so the retry (and a neighbour on the card) finds them."""
    traceback.clear_frames(exc.__traceback__)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


class ShieldRunner:
    """Retry, backoff and degradation supervisor for iteration attempts."""

    def __init__(self, *, max_retries: int = 3, backoff: float = 0.5,
                 backoff_cap: float = 30.0, telemetry=None,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self.max_retries = max(int(max_retries), 0)
        self.backoff = max(float(backoff), 0.0)
        self.backoff_cap = float(backoff_cap)
        self.telemetry = telemetry
        self._sleep = sleep
        self.retries_total = 0
        self.degrades_total = 0

    def _fault(self, kind: str, iteration: int, **detail) -> None:
        if self.telemetry is not None:
            self.telemetry.fault(kind, iteration=iteration, **detail)

    def run(self, fn: Callable[[], object], *, iteration: int = 0, engine=None,
            output: int = 1):
        """Run ``fn`` (one iteration attempt) under the retry and
        degradation policy."""
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 - classified below
                if not is_transient_failure(e):
                    raise
                oom = _is_oom(e)
                if oom:
                    _free_cached_memory(e)
                attempt += 1
                if attempt <= self.max_retries:
                    delay = min(self.backoff * (2.0 ** (attempt - 1)), self.backoff_cap)
                    self.retries_total += 1
                    self._fault("retry", iteration, output=output, attempt=attempt,
                                max_retries=self.max_retries, delay_s=delay,
                                error=str(e)[:500])
                    if delay > 0:
                        self._sleep(delay)
                    continue
                # Retries exhausted: step the screening sample down.
                new_rows = engine.degrade_eval_tile_rows() if (
                    engine is not None and oom) else None
                if new_rows is None:
                    raise
                attempt = 0
                self.degrades_total += 1
                self._fault("degrade", iteration, output=output, eval_tile_rows=new_rows,
                            error=str(e)[:500])
