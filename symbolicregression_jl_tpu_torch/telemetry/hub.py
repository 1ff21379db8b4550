"""The host-side Telemetry hub.

Port of the JAX package's ``telemetry/hub.py``. One object owns every
per-iteration consumer of the search loop: the ``SRLogger`` callback,
the genealogy ``Recorder``, the ``ProgressBar``, and the graftscope
JSONL stream. Per iteration the hub:

1. fetches the device counters (``state.telem``) as one int32 vector per
   output, copied to the host without waiting (:meth:`Telemetry.prefetch`,
   right after the iteration's launches) and read after the loop's
   hall-of-fame pull has synchronized the stream: the only
   host<->device traffic telemetry adds, and no extra sync;
2. merges them with ``ResourceMonitor`` timings and the compile events
   observed since the last iteration — in the port, the kernel builds
   (nvcc runs) and library loads of ``ops/cuda_build.py``;
3. emits a schema-versioned JSONL ``iteration`` event every
   ``options.telemetry_interval`` iterations (counters summed across
   the interval);
4. dispatches the registered sinks under an ``sr:host:sinks`` span.

Sinks implement ``on_iteration(ctx)`` / ``on_end(summary)``; adapters
for the three consumers live here so api/search.py registers them in one
line each.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.options import MUTATION_KINDS
from ..ledger.context import TraceContext, mint_run_trace
from .counters import LOSS_HIST_BINS, N_KIND_SLOTS, N_REASONS
from .schema import SCHEMA_VERSION
from .spans import host_span, set_profiler_warning_hook

__all__ = [
    "IterationContext",
    "Telemetry",
    "LoggerSink",
    "RecorderSink",
    "ProgressSink",
]

_KIND_NAMES = tuple(MUTATION_KINDS) + ("crossover",)
_REASON_NAMES = ("none", "constraint", "invalid", "annealing")
_SCALARS = ("candidates", "invalid", "eval_rows", "eval_launches", "screen_rows",
            "screen_launches", "rescore_rows", "rescore_launches")


@dataclasses.dataclass
class IterationContext:
    """Everything one iteration hands to the sinks."""

    iteration: int
    states: Sequence[Any]          # per-output SearchDeviceState
    hofs: Sequence[Any]            # per-output HallOfFame
    options: Any
    num_evals: float
    elapsed: float
    best_loss: float
    evals_per_sec: float
    device_s: float
    host_s: float
    host_fraction: float
    events: Sequence[Any]          # per-output CycleEvents or None
    counters: Sequence[Optional[Dict[str, Any]]] = ()


class _CompileEventCounter:
    """Counts the port's compile events for the hub: ``traces`` counts
    kernel libraries loaded into the process and ``backend_compiles``
    the nvcc builds behind them (ops/cuda_build.py). An iteration with
    neither is a warm iteration."""

    def __init__(self) -> None:
        self.traces = 0
        self.backend_compiles = 0
        self.transfer_guard_hits = 0
        # graftledger: the seconds the same events took (the cost ledger
        # diffs them; wall-clock, so ledger accounts keep them out of the
        # deterministic view)
        self.trace_secs = 0.0
        self.backend_compile_secs = 0.0
        self._active = False

    def _on_event(self, kind: str, name: str, secs: float) -> None:
        if not self._active:
            return
        if kind == "load":
            self.traces += 1
            self.trace_secs += float(secs or 0.0)
        elif kind == "build":
            self.backend_compiles += 1
            self.backend_compile_secs += float(secs or 0.0)

    def start(self) -> None:
        from ..ops import cuda_build

        self._active = True
        cuda_build.add_listener(self._on_event)

    def stop(self) -> None:
        from ..ops import cuda_build

        self._active = False
        cuda_build.remove_listener(self._on_event)

    def snapshot(self) -> Dict[str, int]:
        return {
            "traces": self.traces,
            "backend_compiles": self.backend_compiles,
            "transfer_guard_hits": self.transfer_guard_hits,
        }

    def seconds_snapshot(self) -> Dict[str, float]:
        """Cumulative compile seconds (kept out of :meth:`snapshot` so
        count consumers — recompiles_total, the anomaly detector — never
        see float fields)."""
        return {
            "trace_s": self.trace_secs,
            "backend_compile_s": self.backend_compile_secs,
        }


class _StagedCounters:
    """One output's counters on their way to the host: the int32 vector
    (pinned host memory when it came from the card) and the event that
    marks its copy."""

    __slots__ = ("host", "event")

    def __init__(self, telem) -> None:
        import torch

        parts = [t.reshape(-1) for t in telem.cycle.fields()]
        parts += [telem.finalize_rows.reshape(1), telem.finalize_unique.reshape(1),
                  telem.loss_hist, telem.cx_hist]
        vec = torch.cat(parts)
        self.event = None
        if vec.is_cuda:
            self.host = vec.to("cpu", non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = vec

    def values(self) -> np.ndarray:
        # The loop's hall-of-fame pull synchronizes the stream before the
        # hub reads this, so the copy has landed and query() is True; the
        # wait below only guards a caller that skipped that pull.
        if self.event is not None and not self.event.query():
            self.event.synchronize()
        return self.host.numpy()


def _counters_to_dict(staged: Optional[_StagedCounters]) -> Optional[Dict[str, Any]]:
    """Staged IterationTelemetry vector -> plain JSON-ready dict."""
    if staged is None:
        return None
    v = staged.values().tolist()
    proposed, v = v[:N_KIND_SLOTS], v[N_KIND_SLOTS:]
    accepted, v = v[:N_KIND_SLOTS], v[N_KIND_SLOTS:]
    reasons, v = v[:N_REASONS], v[N_REASONS:]
    scalars, v = dict(zip(_SCALARS, v[:len(_SCALARS)])), v[len(_SCALARS):]
    rows, unique, v = v[0], v[1], v[2:]
    loss_hist, cx_hist = v[:LOSS_HIST_BINS], v[LOSS_HIST_BINS:]
    return {
        "proposed": dict(zip(_KIND_NAMES, proposed)),
        "accepted": dict(zip(_KIND_NAMES, accepted)),
        "reject_reasons": dict(zip(_REASON_NAMES[1:], reasons[1:])),
        **scalars,
        "dedup": {
            "rows": rows,
            "unique": unique,
            "hits": max(rows - unique, 0),
        },
        "loss_hist": loss_hist,
        "complexity_hist": cx_hist,
    }


def _merge_counts(acc: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    """Sum two counter dicts (interval accumulation)."""
    out = dict(acc)
    for key in ("proposed", "accepted", "reject_reasons", "dedup"):
        out[key] = {
            k: acc[key].get(k, 0) + new[key].get(k, 0)
            for k in set(acc[key]) | set(new[key])
        }
    for key in _SCALARS:
        out[key] = acc.get(key, 0) + new.get(key, 0)
    for key in ("loss_hist", "complexity_hist"):
        out[key] = [a + b for a, b in zip(acc[key], new[key])]
    return out


class Telemetry:
    """The search-loop telemetry hub (see module docstring).

    Always constructed by ``equation_search`` (sink dispatch); the JSONL
    stream only exists when ``options.telemetry`` is set.
    """

    def __init__(
        self,
        options,
        *,
        run_id: str,
        out_dir: Optional[str],
        niterations: int,
        nout: int,
        backend: str = "cuda",
        engine_info: Optional[List[Dict[str, Any]]] = None,
        trace: Optional[TraceContext] = None,
        stream: bool = True,
        n_devices: int = 1,
    ) -> None:
        self.options = options
        self.run_id = run_id
        # graftledger causal context: a deterministic run_id mint, so
        # EVERY event this hub emits carries a trace (graftscope.v2).
        self.trace = trace if trace is not None else mint_run_trace(run_id)
        self.interval = max(int(getattr(options, "telemetry_interval", 1)), 1)
        self._sinks: List[Any] = []
        self._compiles = _CompileEventCounter()
        self._last_compiles = self._compiles.snapshot()
        self._acc: List[Optional[Dict[str, Any]]] = [None] * nout
        self._staged: List[Optional[_StagedCounters]] = [None] * nout
        self._acc_device_s = 0.0
        self._acc_host_s = 0.0
        self._pending = False
        self._last_ctx: Optional[IterationContext] = None
        self._iterations_seen = 0
        # graftshield fault audit: per-kind counts, kept whether or not
        # the JSONL stream is on (run_end carries them).
        self.fault_counts: Dict[str, int] = {}
        # graftpulse: per-metric anomaly counts (the same always-tracked
        # contract as fault_counts) and event watchers — callbacks that
        # observe every out-of-band event (fault/mesh/anomaly/pulse/gauge)
        # even when the JSONL stream is off. The flight recorder
        # (pulse/recorder.py) registers here so a fault can trigger its
        # bundle dump before a watchdog abort ends the process.
        self.anomaly_counts: Dict[str, int] = {}
        self._watchers: List[Callable[[Dict[str, Any]], None]] = []

        self.path: Optional[str] = None
        # stream=False: a rank other than 0 of a multi-process run, whose
        # stream would race rank 0's on the same file.
        if stream and bool(getattr(options, "telemetry", False)):
            fname = getattr(options, "telemetry_file", "telemetry.jsonl")
            self.path = (
                fname if os.path.isabs(fname)
                else os.path.join(out_dir or ".", fname)
            )
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            # truncate any stale file from a previous run with this id
            open(self.path, "w").close()
        self._compiles.start()
        # spans.py contract: when a profiler range is requested but the
        # profiler is unusable, the first failure per process surfaces as
        # a pulse event instead of a silent no-op.
        set_profiler_warning_hook(
            lambda msg: self.pulse("profiler_unusable", error=msg))
        if self.path is not None:
            self._emit({
                "event": "run_start",
                "run_id": run_id,
                "backend": backend,
                "n_devices": int(n_devices),
                "nout": nout,
                "niterations": int(niterations),
                "telemetry_interval": self.interval,
                "options": {
                    "maxsize": options.maxsize,
                    "populations": options.populations,
                    "population_size": options.population_size,
                    "ncycles_per_iteration": options.ncycles_per_iteration,
                    "batching": options.batching,
                    "batch_size": options.batch_size,
                    "telemetry_file": getattr(
                        options, "telemetry_file", "telemetry.jsonl"),
                },
                "engines": list(engine_info or []),
            })

    # ------------------------------------------------------------------
    def add_sink(self, sink) -> "Telemetry":
        self._sinks.append(sink)
        return self

    def add_watcher(self, fn: Callable[[Dict[str, Any]], None]
                    ) -> "Telemetry":
        """Register an out-of-band event observer: called with every
        fault/mesh/anomaly/pulse/gauge event dict, stream on or off.
        Watcher exceptions are swallowed — observation must never break
        the path it observes (the same contract sinks have)."""
        self._watchers.append(fn)
        return self

    def _notify(self, event: Dict[str, Any]) -> None:
        for fn in self._watchers:
            try:
                fn(event)
            except Exception:  # observers must never break the search
                pass

    def _out_of_band(self, event: Dict[str, Any]) -> Dict[str, Any]:
        """Stream one out-of-band event (when the stream is on) and tell
        the watchers; never raises into the loop it observes."""
        if self.path is not None:
            try:
                self._emit(event)
            except (OSError, TypeError, ValueError):
                pass
        self._notify(event)
        return event

    def pulse(self, kind: str, *, iteration: int = 0,
              **detail) -> Dict[str, Any]:
        """Record a graftpulse diagnostics audit event (schema ``pulse``):
        capture windows armed/started/stopped, bundle dumps,
        profiler-unusable warnings."""
        return self._out_of_band({
            "event": "pulse",
            "kind": str(kind),
            "iteration": int(iteration),
            "detail": {k: v for k, v in detail.items() if v is not None},
        })

    def mesh(self, *, iteration: int, shards: int, **detail) -> Dict[str, Any]:
        """Record an island-mesh event (schema ``mesh``): the periodic
        cross-shard dedup-key exchange's results and shard balance
        (mesh/engine.MeshEngine.dedup_exchange). Observability only: never
        raises into the search loop, streamed only when the JSONL stream
        is on."""
        event = {
            "event": "mesh",
            "iteration": int(iteration),
            "shards": int(shards),
            "detail": {k: v for k, v in detail.items() if v is not None},
        }
        if self.path is not None:
            try:
                self._emit(event)
            except OSError:  # observability must not break the search
                pass
        self._notify(event)
        return event

    def anomaly(self, metric: str, *, iteration: int = 0,
                **detail) -> Dict[str, Any]:
        """Record a graftpulse anomaly-detector finding (schema
        ``anomaly``): a rolling-statistics excursion on one watched
        per-iteration metric. Counted in-process always, streamed when
        the JSONL stream is on."""
        self.anomaly_counts[metric] = self.anomaly_counts.get(metric, 0) + 1
        return self._out_of_band({
            "event": "anomaly",
            "metric": str(metric),
            "iteration": int(iteration),
            "detail": {k: v for k, v in detail.items() if v is not None},
        })

    def gauge(self, kind: str, *, iteration: int = 0,
              **detail) -> Dict[str, Any]:
        """Record a graftgauge capacity event (schema ``gauge``):
        per-iteration memory samples, footprints, end-of-run watermarks
        and dispatch-latency summaries."""
        return self._out_of_band({
            "event": "gauge",
            "kind": str(kind),
            "iteration": int(iteration),
            "detail": {k: v for k, v in detail.items() if v is not None},
        })

    def compile_snapshot(self) -> Dict[str, int]:
        """Cumulative kernel load and build counts seen so far (the
        anomaly detector diffs consecutive snapshots)."""
        return self._compiles.snapshot()

    def compile_seconds_snapshot(self) -> Dict[str, float]:
        """Cumulative kernel load and build seconds (the cost ledger
        diffs these)."""
        return self._compiles.seconds_snapshot()

    def fault(self, kind: str, *, iteration: int = 0,
              **detail) -> Dict[str, Any]:
        """Record a graftshield fault or recovery event (schema ``fault``):
        a retry, a degrade step, a quarantine, an injected fault, a
        preemption signal, an emergency checkpoint, a watchdog timeout or
        a corrupt checkpoint passed over on resume. Cheap, and never
        raises into the recovery path it audits: counted in-process with
        the stream off, emitted with it on."""
        event = {
            "event": "fault",
            "kind": str(kind),
            "iteration": int(iteration),
            "detail": {k: v for k, v in detail.items() if v is not None},
        }
        self.fault_counts[kind] = self.fault_counts.get(kind, 0) + 1
        return self._out_of_band(event)

    def _emit(self, obj: Dict[str, Any]) -> None:
        # run_id on EVERY event so concatenated streams stay attributable
        obj = {
            "schema": SCHEMA_VERSION, "t": time.time(),
            "run_id": self.run_id, "trace": self.trace.to_dict(), **obj,
        }
        with open(self.path, "a") as f:
            f.write(json.dumps(obj) + "\n")

    # ------------------------------------------------------------------
    def prefetch(self, states: Sequence[Any]) -> None:
        """Start copying each output's counters to the host, without
        waiting. Call right after the iteration's launches; only the JSONL
        stream reads them, so without one this does nothing."""
        if self.path is None:
            return
        self._staged = [
            None if getattr(s, "telem", None) is None else _StagedCounters(s.telem)
            for s in states
        ]

    def iteration(self, ctx: IterationContext) -> Optional[Dict[str, Any]]:
        """Record one iteration: accumulate counters, maybe emit the
        JSONL event, dispatch sinks. Returns the emitted event (None
        when this iteration fell inside an interval)."""
        self._iterations_seen = ctx.iteration
        event = None
        if self.path is not None:
            counters = [_counters_to_dict(st) for st in self._staged]
            self._staged = [None] * len(self._staged)
            ctx.counters = counters
            for j, c in enumerate(counters):
                if c is None:
                    continue
                self._acc[j] = c if self._acc[j] is None else _merge_counts(
                    self._acc[j], c)
            self._acc_device_s += ctx.device_s
            self._acc_host_s += ctx.host_s
            self._pending = True
            self._last_ctx = ctx
            if ctx.iteration % self.interval == 0:
                event = self._emit_iteration(ctx)

        with host_span("sinks"):
            for sink in self._sinks:
                sink.on_iteration(ctx)
        return event

    def _emit_iteration(self, ctx: IterationContext) -> Dict[str, Any]:
        from ..utils.logging import pareto_volume

        snap = self._compiles.snapshot()
        delta = {k: snap[k] - self._last_compiles[k] for k in snap}
        self._last_compiles = snap
        outputs = []
        for j, hof in enumerate(ctx.hofs):
            frontier = hof.pareto_frontier()
            losses = [e.loss for e in frontier]
            complexities = [e.complexity for e in frontier]
            acc = self._acc[j]
            out: Dict[str, Any] = {
                "output": j + 1,
                "min_loss": float(min(losses)) if losses else None,
                "pareto_volume": pareto_volume(
                    losses, complexities, ctx.options.maxsize,
                    use_linear_scaling=(ctx.options.loss_scale == "linear"),
                ),
                "counters": None,
                "loss_hist": None,
                "complexity_hist": None,
            }
            if acc is not None:
                acc = dict(acc)
                out["loss_hist"] = acc.pop("loss_hist")
                out["complexity_hist"] = acc.pop("complexity_hist")
                out["counters"] = acc
            outputs.append(out)
        event = {
            "event": "iteration",
            "iteration": ctx.iteration,
            "num_evals": float(ctx.num_evals),
            "evals_per_sec": float(ctx.evals_per_sec),
            "elapsed_s": float(ctx.elapsed),
            "device_s": float(self._acc_device_s),
            "host_s": float(self._acc_host_s),
            "host_fraction": float(ctx.host_fraction),
            "recompiles": {
                "traces": delta["traces"],
                "backend_compiles": delta["backend_compiles"],
            },
            "transfer_guard_hits": delta["transfer_guard_hits"],
            "outputs": outputs,
        }
        self._emit(event)
        self._acc = [None] * len(self._acc)
        self._acc_device_s = 0.0
        self._acc_host_s = 0.0
        self._pending = False
        return event

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Release process-global resources (the kernel-build listener).
        Idempotent; ``finish`` calls it, and the search loop calls it
        again in a ``finally`` so an interrupted or failing search cannot
        leak a listener per fit."""
        self._compiles.stop()

    def finish(self, *, stop_reason: str, num_evals: float,
               elapsed: float) -> None:
        """Flush any partial interval, emit run_end, close sinks."""
        if (self.path is not None and self._pending
                and self._last_ctx is not None):
            self._emit_iteration(self._last_ctx)
        self.close()
        if self.path is not None:
            self._emit({
                "event": "run_end",
                "stop_reason": stop_reason,
                "iterations": int(self._iterations_seen),
                "num_evals": float(num_evals),
                "elapsed_s": float(elapsed),
                "recompiles_total": {
                    k: v for k, v in self._compiles.snapshot().items()
                    if k != "transfer_guard_hits"
                },
                # schema-optional: the run's graftshield fault counts by
                # kind and graftpulse anomaly counts by metric
                "faults_total": dict(self.fault_counts),
                "anomalies_total": dict(self.anomaly_counts),
            })
        summary = {
            "stop_reason": stop_reason,
            "num_evals": float(num_evals),
            "elapsed_s": float(elapsed),
        }
        for sink in self._sinks:
            on_end = getattr(sink, "on_end", None)
            if on_end is not None:
                on_end(summary)


# ---------------------------------------------------------------------------
# Sink adapters for the consumers
# ---------------------------------------------------------------------------


class LoggerSink:
    """SRLogger-compatible sink (any object with ``log_iteration``)."""

    def __init__(self, logger, every: int = 1) -> None:
        import inspect

        self.logger = logger
        self.every = max(int(every), 1)
        # host_fraction is new in the hub contract; user loggers written
        # against the original signature keep working.
        try:
            params = inspect.signature(logger.log_iteration).parameters
            self._pass_host_fraction = "host_fraction" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values()
            )
        except (TypeError, ValueError):  # builtins / C callables
            self._pass_host_fraction = False

    def on_iteration(self, ctx: IterationContext) -> None:
        if ctx.iteration % self.every != 0:
            return
        kw = {}
        if self._pass_host_fraction:
            kw["host_fraction"] = ctx.host_fraction
        self.logger.log_iteration(
            iteration=ctx.iteration, hofs=ctx.hofs, states=ctx.states,
            options=ctx.options, num_evals=ctx.num_evals,
            elapsed=ctx.elapsed, **kw,
        )


class RecorderSink:
    """Genealogy Recorder sink; owns the end-of-run write."""

    def __init__(self, recorder, variable_names: Sequence[Sequence[str]],
                 path: str) -> None:
        self.recorder = recorder
        self.variable_names = list(variable_names)
        self.path = path

    def on_iteration(self, ctx: IterationContext) -> None:
        events = ctx.events or [None] * len(ctx.states)
        for j, state in enumerate(ctx.states):
            self.recorder.record_iteration(
                ctx.iteration, j, state, ctx.hofs[j],
                float(state.num_evals),
                variable_names=self.variable_names[j],
                events=events[j],
            )

    def on_end(self, summary: Dict[str, Any]) -> None:
        self.recorder.record_final("stop_reason", summary["stop_reason"])
        self.recorder.record_final("num_evals", summary["num_evals"])
        self.recorder.write(self.path)


class ProgressSink:
    """Terminal progress-bar sink."""

    def __init__(self, bar) -> None:
        self.bar = bar

    def on_iteration(self, ctx: IterationContext) -> None:
        self.bar.update(
            ctx.iteration, best_loss=ctx.best_loss,
            evals_per_sec=ctx.evals_per_sec,
            host_fraction=ctx.host_fraction,
        )

    def on_end(self, summary: Dict[str, Any]) -> None:
        self.bar.close()
