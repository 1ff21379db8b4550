"""Span tracing: line a profiler capture up with search iterations.

Port of the JAX package's ``telemetry/spans.py`` on
``torch.profiler.record_function``, named so a ``torch.profiler`` capture
of a search shows one ``sr:iteration`` range per engine iteration with
the host phases (hall-of-fame decode, checkpoint CSV writes, telemetry
sinks/logging) as named ranges between device work. While the search
runs on a CUDA device each span also opens an NVTX range of the same
name (``torch.cuda.nvtx.range``), so an Nsight capture shows them too.
Outside a capture both cost microseconds, so they are ALWAYS on — no
option gates them.

Span names (schema-stable, see docs/OBSERVABILITY.md):

- ``sr:iteration`` — one per search iteration (device launches + the
  blocking sync), carrying ``step_num`` in its NVTX message.
- ``sr:host:hof_decode`` — device HoF pull + host tree decode.
- ``sr:host:checkpoint`` — hall-of-fame CSV + full-state pickle writes.
- ``sr:host:sinks`` — telemetry hub sink dispatch (SRLogger, Recorder,
  ProgressBar, JSONL emission).
- ``sr:host:report`` — regressor report building (pareto scoring,
  equation stringification).

The engine's ``sr:constant_optimizer`` range (evolve/engine.py) is a
plain ``record_function`` of its own.

Failure discipline: an unusable profiler must never break the search
(spans degrade to no-ops), but it must not be SILENT either —
an operator staring at an empty trace needs to know the annotations
never existed. The first failure per process reports through the hook
the telemetry hub registers (a one-time ``pulse`` event, kind
``profiler_unusable``); later failures stay quiet.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional

__all__ = ["step_span", "host_span", "set_profiler_warning_hook",
           "set_span_observer", "set_nvtx"]

# graftledger host-phase observer: a thread-local callback receiving
# (name, seconds) for every completed host span on THIS thread. When no
# observer is registered host_span returns the raw annotation unchanged:
# zero new work on the hot path.
_observer = threading.local()

# Whether spans also open NVTX ranges: equation_search turns it on for
# the length of a search on a CUDA device (thread-local, like the
# observer, so concurrent searches on other devices are unaffected).
_nvtx = threading.local()


def set_span_observer(
        fn: Optional[Callable[[str, float], None]]) -> None:
    """Register (or clear, with None) this thread's host-span observer."""
    _observer.fn = fn


def set_nvtx(on: bool) -> None:
    """Open an NVTX range beside every span on this thread (a search on a
    CUDA device), or stop doing so."""
    _nvtx.on = bool(on)


class _TimedSpan:
    """Wraps a profiler annotation with a wall-clock timing report."""

    __slots__ = ("name", "inner", "report", "_t0")

    def __init__(self, name: str, inner,
                 report: Callable[[str, float], None]) -> None:
        self.name = name
        self.inner = inner
        self.report = report

    def __enter__(self):
        self._t0 = time.perf_counter()
        self.inner.__enter__()
        return self

    def __exit__(self, *exc):
        result = self.inner.__exit__(*exc)
        try:
            self.report(self.name, time.perf_counter() - self._t0)
        except Exception:  # observation must never outcrash the span
            pass
        return result


# one-time-per-process profiler-unusable warning plumbing: the latest
# constructed Telemetry hub owns the hook
_warn_hook: Optional[Callable[[str], None]] = None
_warned = False


def set_profiler_warning_hook(hook: Optional[Callable[[str], None]]) -> None:
    """Register the callback invoked (once per process) when a span is
    requested but the profiler is unusable. The telemetry hub passes a
    closure emitting a ``pulse`` event, kind ``profiler_unusable``."""
    global _warn_hook
    _warn_hook = hook


def _note_profiler_unusable(err: BaseException) -> None:
    global _warned
    if _warned:
        return
    _warned = True
    hook = _warn_hook
    if hook is None:
        return
    try:
        hook(f"{type(err).__name__}: {err}")
    except Exception:  # the warning must never outcrash the no-op
        pass


class _Span:
    """``record_function(name)`` and, when NVTX is on for this thread, an
    NVTX range of the same name (message ``nvtx_message``)."""

    __slots__ = ("name", "nvtx_message", "_stack")

    def __init__(self, name: str, nvtx_message: Optional[str]) -> None:
        self.name = name
        self.nvtx_message = nvtx_message

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        try:
            import torch

            self._stack.enter_context(torch.profiler.record_function(self.name))
            if getattr(_nvtx, "on", False):
                self._stack.enter_context(
                    torch.cuda.nvtx.range(self.nvtx_message or self.name))
        except Exception as e:  # profiler or NVTX unavailable
            _note_profiler_unusable(e)
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)


def step_span(step_num: int, *, trace_id: Optional[str] = None,
              span_id: Optional[str] = None):
    """The ``sr:iteration`` range of one search iteration. Its NVTX
    message carries ``step_num`` and, when graftledger trace context is
    threaded in, ``trace_id``/``span_id``, so an Nsight capture correlates
    with the JSONL streams by id."""
    attrs = [f"step_num={step_num}"]
    if trace_id is not None:
        attrs.append(f"trace_id={trace_id}")
    if span_id is not None:
        attrs.append(f"span_id={span_id}")
    return _Span("sr:iteration", "sr:iteration " + " ".join(attrs))


def host_span(name: str):
    """Named host-phase span (``sr:host:<name>``); timed and reported
    to this thread's ledger observer when one is registered."""
    span = _Span(f"sr:host:{name}", None)
    fn = getattr(_observer, "fn", None)
    if fn is None:
        return span
    return _TimedSpan(name, span, fn)
