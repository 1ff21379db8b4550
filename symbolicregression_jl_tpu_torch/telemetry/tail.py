"""``telemetry tail`` — follow a live graftscope stream (a copy of the JAX
package's ``telemetry/tail.py``).

A graftscope JSONL file is append-only and crash-torn at worst, which
makes it a perfectly good live surface: this follower re-reads only the
bytes appended since its last poll, holds any partial final line in a
buffer until the writer finishes it (a live stream ALWAYS has a torn
tail mid-write — that is not corruption), and folds each complete event
into a rolling single-screen summary::

    python -m symbolicregression_jl_tpu_torch.telemetry tail run.jsonl
    python -m symbolicregression_jl_tpu_torch.telemetry tail run.jsonl --once

``--interval`` sets the refresh period (default 1s); ``--once`` renders
the current state once and exits (scripts, tests). The screen shows the
run header, the latest iteration's throughput/loss/host-fraction, and
the fault / anomaly / pulse / serve counters — the "is it healthy right
now" view that ``telemetry report`` gives post-mortem.

Pure host-side text processing; no torch or jax import.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

__all__ = ["TailState", "TailFollower", "main"]


class TailState:
    """Rolling summary of the events seen so far."""

    def __init__(self) -> None:
        self.run: Optional[Dict[str, Any]] = None
        self.last_iter: Optional[Dict[str, Any]] = None
        self.iterations = 0
        self.faults: Dict[str, int] = {}
        self.anomalies: Dict[str, int] = {}
        self.pulse: Dict[str, int] = {}
        self.serve: Dict[str, int] = {}
        self.gauge: Dict[str, int] = {}
        # latest graftgauge memory sample (live/peak bytes), for the
        # "is it about to OOM" line
        self.last_memory: Optional[Dict[str, Any]] = None
        self.mesh_exchanges = 0
        self.end: Optional[Dict[str, Any]] = None
        self.events = 0
        self.skipped = 0

    def update(self, e: Dict[str, Any]) -> None:
        self.events += 1
        ev = e.get("event")
        if ev == "run_start":
            self.run = e
        elif ev == "iteration":
            self.last_iter = e
            self.iterations = max(self.iterations, int(e.get("iteration", 0)))
        elif ev == "fault":
            k = e.get("kind", "?")
            self.faults[k] = self.faults.get(k, 0) + 1
        elif ev == "anomaly":
            k = e.get("metric", "?")
            self.anomalies[k] = self.anomalies.get(k, 0) + 1
        elif ev == "pulse":
            k = e.get("kind", "?")
            self.pulse[k] = self.pulse.get(k, 0) + 1
        elif ev == "serve":
            k = e.get("kind", "?")
            self.serve[k] = self.serve.get(k, 0) + 1
        elif ev == "gauge":
            k = e.get("kind", "?")
            self.gauge[k] = self.gauge.get(k, 0) + 1
            if k in ("memory", "watermark"):
                self.last_memory = e.get("detail") or {}
        elif ev == "mesh":
            self.mesh_exchanges += 1
        elif ev == "run_end":
            self.end = e

    def render(self) -> str:
        """The single-screen summary (bounded line count)."""
        lines: List[str] = []
        r = self.run or {}
        niter = r.get("niterations")
        lines.append(
            f"run {r.get('run_id', '?')}  [{r.get('backend', '?')} x "
            f"{r.get('n_devices', '?')} device(s)]  "
            f"{self.events} events"
            + (f", {self.skipped} torn/skipped" if self.skipped else "")
        )
        it = self.last_iter
        if it is not None:
            frac = (f"{self.iterations}/{niter}" if niter
                    else str(self.iterations))
            lines.append(
                f"iteration {frac}  |  evals/s "
                f"{it.get('evals_per_sec', 0):,.3g}  |  best loss "
                f"{it.get('best_loss', float('nan')):.6g}  |  host "
                f"{100.0 * it.get('host_fraction', 0.0):.1f}%  |  evals "
                f"{it.get('num_evals', 0):,.3g}"
            )
            rc = it.get("recompiles") or {}
            if rc.get("traces"):
                lines.append(f"  recompiles this event: {rc['traces']}")
        else:
            lines.append("iteration -  (no iteration events yet)")
        mem = self.last_memory
        if mem:
            live = mem.get("live_bytes")
            peak = mem.get("peak_live_bytes")
            in_use = mem.get("bytes_in_use")
            bits = []
            if live is not None:
                bits.append(f"live {live:,} B")
            if peak is not None:
                bits.append(f"peak {peak:,} B")
            if in_use is not None:
                bits.append(f"allocator {in_use:,} B")
            if bits:
                lines.append("memory: " + "  |  ".join(bits))
        for label, counts in (("faults", self.faults),
                              ("anomalies", self.anomalies),
                              ("pulse", self.pulse),
                              ("gauge", self.gauge),
                              ("serve", self.serve)):
            if counts:
                body = ", ".join(
                    f"{k}={v}" for k, v in sorted(counts.items()))
                lines.append(f"{label}: {body}")
        if self.mesh_exchanges:
            lines.append(f"mesh: {self.mesh_exchanges} exchange(s)")
        if self.end is not None:
            lines.append(
                f"run END: {self.end.get('stop_reason')} after "
                f"{self.end.get('iterations')} iterations, "
                f"{self.end.get('num_evals', 0):,.3g} evals in "
                f"{self.end.get('elapsed_s', 0):,.1f}s"
            )
        else:
            lines.append("run live...")
        return "\n".join(lines)


class TailFollower:
    """Incremental reader: new bytes only, partial tail buffered."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.state = TailState()
        self._pos = 0
        self._buf = ""
        self._ino: Optional[tuple] = None  # (st_dev, st_ino) of last poll

    def poll(self) -> int:
        """Fold newly-appended complete lines into the state; returns
        how many events arrived. Missing file = 0 (writer not up yet).
        A file that SHRANK (truncation) or whose identity changed
        (rotation: rename-and-recreate swaps the inode, possibly with a
        LARGER new file) is a new run over the same path — restart the
        summary from byte 0 rather than silently mixing two runs or
        stalling on a stale offset."""
        try:
            st = os.stat(self.path)
        except OSError:
            return 0
        ident = (st.st_dev, st.st_ino)
        if st.st_size < self._pos or (
                self._ino is not None and ident != self._ino):
            self.state = TailState()
            self._pos = 0
            self._buf = ""
        self._ino = ident
        with open(self.path) as f:
            f.seek(self._pos)
            chunk = f.read()
            self._pos = f.tell()
        self._buf += chunk
        # everything before the last newline is complete; the remainder
        # stays buffered (the torn tail of a mid-write writer)
        complete, sep, rest = self._buf.rpartition("\n")
        if not sep:
            return 0
        self._buf = rest
        n = 0
        for line in complete.split("\n"):
            if not line.strip():
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                self.state.skipped += 1
                continue
            if isinstance(e, dict):
                self.state.update(e)
                n += 1
            else:
                self.state.skipped += 1
        return n


_CLEAR = "\x1b[2J\x1b[H"


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    once = "--once" in argv
    interval = 1.0
    if "--interval" in argv:
        i = argv.index("--interval")
        try:
            interval = float(argv[i + 1])
            del argv[i:i + 2]
        except (IndexError, ValueError):
            print("--interval needs a number of seconds", file=sys.stderr)
            return 2
    paths = [a for a in argv if not a.startswith("-")]
    if len(paths) != 1:
        print("usage: telemetry tail <run.jsonl> [--interval S] [--once]",
              file=sys.stderr)
        return 2
    follower = TailFollower(paths[0])
    try:
        while True:
            follower.poll()
            screen = follower.state.render()
            if once:
                print(screen)
                return 0
            sys.stdout.write(_CLEAR + screen + "\n")
            sys.stdout.flush()
            if follower.state.end is not None:
                return 0
            time.sleep(max(interval, 0.05))
    except KeyboardInterrupt:
        print()
        return 0
