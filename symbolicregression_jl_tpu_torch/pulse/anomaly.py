"""Rolling anomaly detection over per-iteration search metrics (a copy of
the JAX package's ``pulse/anomaly.py``; its ``recompiles`` rule reads the
hub's compile counter, which in the port counts kernel library loads).

A telemetry-hub sink keeping exponentially-weighted mean/variance of
the per-iteration throughput and host-fraction signals, plus two
absolute rules (warm recompiles, invalid-candidate fraction). An
excursion emits an ``anomaly`` event through the hub and — via the
``on_anomaly`` callback — arms the rate-limited, budgeted profiler
capture (capture.py), so the evidence window opens AT the anomaly
instead of requiring a rerun under a hand-driven profiling script.

Watched metrics (docs/OBSERVABILITY.md has the threshold table):

- ``evals_per_sec`` — per-iteration rate (delta evals / delta wall
  time, not the cumulative average the progress bar shows): a retry
  storm, host stall, or degraded eval shape collapses it immediately.
  EWMA/z-score **in log space** (rate noise is multiplicative — a 10x
  collapse is the same sigma excursion at any absolute throughput),
  with a relative std floor; compile-bearing iterations are excluded
  from the rolling stats (they are legitimately 100-1000x slower, and
  the dedicated ``recompiles`` rule already covers unexpected ones).
- ``host_fraction`` — the monitor's host-work estimate; a sink or
  checkpoint path going quadratic drifts it up. EWMA/z-score.
- ``recompiles`` — any kernel library load (the hub's ``traces``
  counter, ops/cuda_build.py) observed after the warmup window is
  anomalous (warm iterations load nothing new; the first iterations
  load the kernels legitimately).
- ``invalid_fraction`` — invalid candidates / candidates from the
  device counters, when the JSONL stream already pulled them (the
  detector never adds a device transfer of its own); a NaN storm
  spikes it. Absolute threshold. Under staged eval the structural
  unrescored-candidate NaN floor (screen_rows - rescore_rows,
  docs/PRECISION.md) is subtracted first — the rule watches the
  rescored candidates, which a genuine storm still poisons.
- ``live_bytes_growth`` — the graftgauge leak tripwire: live-array
  bytes strictly increasing over ``leak_window`` consecutive
  iterations by at least ``leak_min_bytes`` total (fed by
  gauge/sampler.py via :meth:`AnomalyDetector.observe_live_bytes`);
  the anomaly also triggers the flight-recorder bundle dump, so the
  memory snapshot lands on disk at the moment of detection.

Bit-neutral by construction: reads only host-side values the loop
already materialized, never touches state, keys, or options.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

__all__ = ["AnomalyDetector", "AnomalyThresholds"]


@dataclasses.dataclass
class AnomalyThresholds:
    """Detector tuning; the defaults are the zero-configuration
    contract CI's pulse-smoke pins (docs/OBSERVABILITY.md)."""

    zscore: float = 4.0           # |z| beyond this fires
    warmup: int = 5               # samples before z-rules may fire
    alpha: float = 0.3            # EWMA weight of the newest sample
    min_std_frac: float = 0.05    # std floor, as a fraction of |mean|
    invalid_fraction_max: float = 0.5
    cooldown: int = 8             # iterations between events per metric
    max_events: int = 32          # per-run event budget
    # graftstage staged-eval drift rule: relative tolerance on the
    # observed rescore fraction (rescore_rows / screen_rows from the
    # device counters) vs the configured Options.rescore_fraction. The
    # counters are exact static counts, so any drift beyond rounding
    # means the compiled program and the host-side config disagree —
    # a stale AOT executable or a mis-threaded knob.
    rescore_drift_tol: float = 0.2
    # graftgauge leak tripwire: live-array bytes (gauge/sampler.py)
    # growing STRICTLY monotonically over leak_window consecutive
    # iteration samples, by at least leak_min_bytes in total, fires a
    # live_bytes_growth anomaly (which also triggers the flight-
    # recorder bundle dump — recorder.py). A healthy search plateaus
    # after warmup (populations are fixed-size, loop temporaries are
    # freed functionally); unbroken growth means something is
    # accumulating references. The byte floor keeps small-object churn
    # (HoF growth toward its cap, python-side caches) below the rule.
    leak_window: int = 8
    leak_min_bytes: int = 1 << 20


class _Rolling:
    """Exponentially-weighted mean + variance of one scalar signal."""

    def __init__(self, alpha: float) -> None:
        self.alpha = float(alpha)
        self.mean: Optional[float] = None
        self.var = 0.0
        self.n = 0

    def zscore(self, x: float, min_std: float) -> Optional[float]:
        if self.mean is None:
            return None
        std = max(math.sqrt(max(self.var, 0.0)), min_std, 1e-12)
        return (x - self.mean) / std

    def update(self, x: float) -> None:
        self.n += 1
        if self.mean is None:
            self.mean = x
            self.var = 0.0
            return
        a = self.alpha
        delta = x - self.mean
        self.mean += a * delta
        # EW variance (West 1979 form): decays old spread, adds the
        # new sample's contribution around the pre-update mean
        self.var = (1.0 - a) * (self.var + a * delta * delta)


class AnomalyDetector:
    """Telemetry-hub sink; see module docstring."""

    def __init__(
        self,
        hub,
        *,
        thresholds: Optional[AnomalyThresholds] = None,
        on_anomaly: Optional[Callable[[str, int], None]] = None,
        expected_rescore_fraction: Optional[float] = None,
    ) -> None:
        self.hub = hub
        self.t = thresholds or AnomalyThresholds()
        self.on_anomaly = on_anomaly
        # None = staged eval off (or unknown config): drift rule dormant
        self.expected_rescore_fraction = expected_rescore_fraction
        self.events = 0
        self._roll: Dict[str, _Rolling] = {
            "evals_per_sec": _Rolling(self.t.alpha),
            "host_fraction": _Rolling(self.t.alpha),
        }
        self._cooldown_until: Dict[str, int] = {}
        self._last_evals: Optional[float] = None
        self._last_elapsed: Optional[float] = None
        self._last_traces: Optional[int] = None
        self._samples = 0
        # graftgauge leak tripwire state: the live-bytes value at the
        # start of the current strictly-increasing streak, the previous
        # sample, and the streak length
        self._leak_base: Optional[int] = None
        self._leak_prev: Optional[int] = None
        self._leak_streak = 0

    # ------------------------------------------------------------------
    def _fire(self, metric: str, iteration: int, **detail) -> None:
        if self.events >= self.t.max_events:
            return
        if iteration < self._cooldown_until.get(metric, 0):
            return
        self._cooldown_until[metric] = iteration + self.t.cooldown
        self.events += 1
        armed = False
        if self.on_anomaly is not None:
            try:
                armed = bool(self.on_anomaly(metric, iteration))
            except Exception:  # arming must never break detection
                armed = False
        self.hub.anomaly(metric, iteration=iteration,
                         armed_capture=armed or None, **detail)

    def _observe_z(self, metric: str, value: Optional[float],
                   iteration: int, *, log_space: bool = False) -> None:
        if value is None or not math.isfinite(value):
            return
        if log_space and value <= 0.0:
            return
        obs = math.log(value) if log_space else value
        roll = self._roll[metric]
        if roll.n >= self.t.warmup:
            min_std = abs(roll.mean or 0.0) * self.t.min_std_frac
            z = roll.zscore(obs, min_std)
            if z is not None and abs(z) > self.t.zscore:
                mean = (math.exp(roll.mean) if log_space and
                        roll.mean is not None else roll.mean)
                self._fire(
                    metric, iteration, value=round(value, 6),
                    mean=(None if mean is None else round(mean, 6)),
                    zscore=round(z, 3), threshold=self.t.zscore,
                )
        roll.update(obs)

    # -- graftgauge leak tripwire --------------------------------------
    def observe_live_bytes(self, iteration: int, live_bytes: int) -> None:
        """One per-iteration live-array byte sample (fed by
        gauge/sampler.py, not the hub sink protocol — the sampler runs
        as its own sink and hands the value here so the leak rule
        shares the detector's cooldown/budget/capture-arming plumbing).

        Fires ``live_bytes_growth`` after ``leak_window`` consecutive
        strictly-increasing samples whose total growth is at least
        ``leak_min_bytes``; any non-increase resets the streak."""
        b = int(live_bytes)
        if self._leak_prev is not None and b > self._leak_prev:
            self._leak_streak += 1
        else:
            self._leak_streak = 0
            self._leak_base = b
        if self._leak_base is None:
            self._leak_base = b
        self._leak_prev = b
        growth = b - self._leak_base
        if (self._leak_streak >= self.t.leak_window
                and growth >= self.t.leak_min_bytes):
            self._fire(
                "live_bytes_growth", int(iteration), value=b,
                growth_bytes=growth, window=self._leak_streak,
                threshold=self.t.leak_window,
            )

    # -- hub sink protocol ---------------------------------------------
    def on_iteration(self, ctx) -> None:
        it = int(ctx.iteration)
        self._samples += 1

        # per-iteration rate from the cumulative counters the loop
        # already computed (first sample has no delta; skip it)
        rate = None
        if self._last_evals is not None and self._last_elapsed is not None:
            dt = float(ctx.elapsed) - self._last_elapsed
            if dt > 0:
                rate = (float(ctx.num_evals) - self._last_evals) / dt
        self._last_evals = float(ctx.num_evals)
        self._last_elapsed = float(ctx.elapsed)
        traces = int(self.hub.compile_snapshot().get("traces", 0))
        compiled_this_iter = (self._last_traces is not None
                              and traces > self._last_traces)
        if not compiled_this_iter:
            # compile-bearing iterations are legitimately 100-1000x
            # slower — feeding them into the rolling rate stats would
            # inflate the variance past any real stall
            self._observe_z("evals_per_sec", rate, it, log_space=True)
        self._observe_z("host_fraction", float(ctx.host_fraction), it)

        # warm recompiles: absolute rule on the hub's load counter
        # delta, past the warmup window (startup loads are legitimate)
        if (compiled_this_iter and self._samples > self.t.warmup):
            self._fire(
                "recompiles", it,
                value=traces - self._last_traces, threshold=0,
            )
        self._last_traces = traces

        # invalid fraction from the device counters, when the stream
        # already fetched them (ctx.counters stays empty otherwise).
        # Under graftstage staged eval (docs/PRECISION.md) every
        # UNRESCORED candidate carries NaN cost by contract and the
        # device counter counts it invalid — subtract that structural
        # floor and measure the storm among rescored candidates, where
        # a genuine NaN storm still lands (NaN screens rank last but
        # top-k must still fill rescore_rows slots).
        worst = None
        for c in ctx.counters or ():
            if c and c.get("candidates"):
                inv = c.get("invalid", 0)
                cand = c["candidates"]
                unrescored = max(
                    0, c.get("screen_rows", 0) - c.get("rescore_rows", 0))
                if unrescored:
                    inv = max(0, inv - unrescored)
                    cand = max(1, cand - unrescored)
                frac = inv / cand
                worst = frac if worst is None else max(worst, frac)
        if worst is not None and worst > self.t.invalid_fraction_max:
            self._fire(
                "invalid_fraction", it, value=round(worst, 6),
                threshold=self.t.invalid_fraction_max,
            )

        # graftstage rescore-fraction drift (docs/PRECISION.md): the
        # staged screen/rescore counts are static per compiled program,
        # so the observed ratio should match the configured fraction up
        # to per-launch ceil rounding; past rescore_drift_tol the
        # program serving this search was built from different knobs.
        expect = self.expected_rescore_fraction
        if expect:
            worst_drift = None
            observed = None
            for c in ctx.counters or ():
                if c and c.get("screen_rows"):
                    frac = c.get("rescore_rows", 0) / c["screen_rows"]
                    drift = abs(frac - expect) / expect
                    if worst_drift is None or drift > worst_drift:
                        worst_drift, observed = drift, frac
            if worst_drift is not None and worst_drift > self.t.rescore_drift_tol:
                self._fire(
                    "rescore_fraction_drift", it,
                    value=round(observed, 6), expected=round(expect, 6),
                    threshold=self.t.rescore_drift_tol,
                )
