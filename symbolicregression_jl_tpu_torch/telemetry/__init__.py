"""graftscope — device-resident search telemetry, span tracing, run reports.

Port of the JAX package's observability layer (docs/OBSERVABILITY.md):

- :mod:`.counters` — device-side counters accumulated over an
  iteration's generation steps (mutation proposals/accepts per kind,
  invalid-eval fraction, dedup hit-rate, eval launches, population
  histograms). They ride the engine state, so the host fetches them with
  the per-iteration state pull it already makes.
- :mod:`.hub` — the host-side ``Telemetry`` hub: merges device counters
  with ``ResourceMonitor`` timings and the kernel builds and loads of
  ``ops/cuda_build.py``, emits schema-versioned JSONL (:mod:`.schema`),
  and dispatches registered sinks (``SRLogger``, ``Recorder``,
  ``ProgressBar``).
- :mod:`.spans` — ``torch.profiler`` (and, on a CUDA device, NVTX) ranges
  so a capture lines up with search iterations and host phases.
- :mod:`.report` — the run-report CLI::

      python -m symbolicregression_jl_tpu_torch.telemetry run.jsonl
      python -m symbolicregression_jl_tpu_torch.telemetry report run.jsonl --json
      python -m symbolicregression_jl_tpu_torch.telemetry validate run.jsonl

Enable with ``Options(telemetry=True)``.
"""

from .counters import (
    CycleTelemetry,
    IterationTelemetry,
    empty_cycle_telemetry,
    empty_iteration_telemetry,
)
from .hub import IterationContext, Telemetry
from .schema import (
    SCHEMA_VERSION,
    SCHEMA_VERSIONS,
    validate_event,
    validate_lines,
)

__all__ = [
    "CycleTelemetry",
    "IterationTelemetry",
    "IterationContext",
    "Telemetry",
    "SCHEMA_VERSION",
    "SCHEMA_VERSIONS",
    "empty_cycle_telemetry",
    "empty_iteration_telemetry",
    "validate_event",
    "validate_lines",
]
