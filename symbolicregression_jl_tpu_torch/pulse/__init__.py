"""graftpulse: active diagnostics on top of the graftscope stream (port
of the JAX package's ``pulse/``).

graftscope (telemetry/) made every run *emit* schema-versioned
telemetry; graftpulse makes the emitting process hold the evidence an
operator needs the moment something goes wrong, instead of an exit
code and a log tail:

- :class:`FlightRecorder` (recorder.py) — a bounded in-memory ring of
  the last K iterations' device counters + host timings + recent
  out-of-band events, registered as a telemetry-hub sink/watcher and
  dumped as a self-contained ``graftpulse.bundle.v1`` JSON bundle when
  a fault fires (watchdog timeout, quarantine, injection) or the run
  exits nonzero.
- :class:`AnomalyDetector` (anomaly.py) — rolling EWMA/z-score over
  per-iteration evals/s, host_fraction, recompile count and
  invalid-fraction; emits ``anomaly`` events and arms a rate-limited,
  budgeted profiler capture.
- :class:`TraceCapture` + :class:`SignalArm` (capture.py) —
  programmatic ``torch.profiler`` trace windows (the ``sr:iteration`` /
  ``sr:host:*`` spans' consumer), armed by SIGUSR2, a
  ``RuntimeOptions(pulse_trace_on=...)`` knob, a serve request flag,
  or the detector.
- :class:`PromText` (metrics.py) — the Prometheus text-exposition
  builder behind graftserve's ``/metrics`` endpoint.

Everything here is observability-only and bit-neutral to the search:
host-side reads of values the loop already materialized, zero extra
device dispatches or transfers (pinned by tests/test_pulse.py's on/off
A/B, the same contract graftscope carries; in the port
tests/test_torch_diagnostics.py). See docs/OBSERVABILITY.md.
"""

from .anomaly import AnomalyDetector, AnomalyThresholds
from .capture import SignalArm, TraceCapture
from .metrics import PromText
from .recorder import (
    BUNDLE_SCHEMA,
    FlightRecorder,
    bundle_fingerprint,
    deterministic_view,
    validate_bundle,
)

__all__ = [
    "AnomalyDetector",
    "AnomalyThresholds",
    "BUNDLE_SCHEMA",
    "FlightRecorder",
    "PromText",
    "SignalArm",
    "TraceCapture",
    "bundle_fingerprint",
    "deterministic_view",
    "validate_bundle",
]
