"""The live metrics surface: a Prometheus-text HTTP endpoint (a copy of
the JAX package's ``serve/metrics.py``).

graftscope's JSONL stream answers "what happened"; this answers "what
is happening": a tiny stdlib HTTP server exposing ``GET /metrics``
(Prometheus text format v0.0.4, rendered fresh per scrape from
``SearchServer.metrics_text``) and ``GET /healthz``. No third-party
client library, no background sampling thread — the server's own
counters (admission, executable cache, request records) ARE the state,
and a scrape just reads them.

Binds 127.0.0.1 by default (the serve API itself is in-process;
exposing metrics beyond the host is a deployment decision, not a
default). ``port=0`` picks an ephemeral port — tests and multi-server
hosts read it back from ``MetricsServer.port``.

docs/OBSERVABILITY.md carries the full metric-name table.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

__all__ = ["MetricsServer", "CONTENT_TYPE", "render_ledger_metrics",
           "render_gauge_metrics"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def render_ledger_metrics(p, rollup: Optional[dict]) -> None:
    """Append the graftledger per-tenant cost section to a ``PromText``
    builder from a ``graftledger.rollup.v1`` document (ledger/rollup.py;
    None — no rollup written yet — appends nothing).

    One label set per request the root has ever completed: attribution
    is the point, and a serve root's request count is bounded by its
    lifetime, not its concurrency — operators with long-lived roots
    should scrape the rollup file instead of relying on these families
    staying small."""
    if not rollup:
        return
    for rid, acct in sorted(rollup.get("requests", {}).items()):
        labels = {"request": rid}
        p.counter("request_device_seconds_total", acct.get("device_s", 0.0),
                  "Ledger-attributed device seconds per request", labels)
        p.counter("request_host_seconds_total", acct.get("host_s", 0.0),
                  "Ledger-attributed host bookkeeping seconds", labels)
        p.counter("request_compile_seconds_total",
                  acct.get("compile_s", 0.0),
                  "Ledger-attributed kernel load and build seconds", labels)
        p.counter("request_ledger_evals_total", acct.get("num_evals", 0.0),
                  "Final cumulative expression evaluations", labels)
        p.counter("request_checkpoint_bytes_total",
                  acct.get("checkpoint_bytes", 0),
                  "Bytes of full-state checkpoints written", labels)
        hist = acct.get("iteration_latency") or {}
        le = hist.get("le") or []
        counts = hist.get("counts") or []
        if le and len(counts) == len(le) + 1:
            p.histogram(
                "request_iteration_latency_seconds", le, counts,
                acct.get("device_s", 0.0) + acct.get("host_s", 0.0),
                "Per-iteration device+host latency (log-bucketed)",
                labels)
    totals = rollup.get("totals", {})
    p.counter("ledger_device_seconds_total", totals.get("device_s", 0.0),
              "Ledger-attributed device seconds, all requests")
    p.counter("ledger_evals_total", totals.get("num_evals", 0.0),
              "Cumulative expression evaluations, all requests")


def render_gauge_metrics(p) -> None:
    """Append the graftgauge capacity section to a ``PromText`` builder:
    the process-wide dispatch-latency histogram, the peak device bytes
    (``torch.cuda.memory_allocated``) any search in this process
    reached, and one ``footprint_bytes``
    gauge per footprint-ledger entry (fingerprint truncated to 12 hex
    chars — a label, not a join key; the full value is in the gauge
    events and the ledger API). All reads of process-global state;
    never raises into a scrape."""
    try:
        from ..gauge import global_latency, global_ledger, process_peak_bytes

        global_latency().render(p)
        p.gauge(
            "process_peak_live_bytes", process_peak_bytes(),
            "Peak allocated device bytes observed by any search "
            "in this process",
        )
        for e in global_ledger().entries():
            total = (e.get("summary") or {}).get("total_bytes")
            if not total:
                continue
            fp = e.get("fingerprint") or ""
            p.gauge(
                "footprint_bytes", int(total),
                "Launch-geometry footprint (temp+args+output) from "
                "one probe iteration's allocator peak",
                {
                    "fingerprint": fp[:12] or "none",
                    "geometry": e.get("geometry", ""),
                    "source": e.get("source", ""),
                },
            )
    except Exception:  # noqa: BLE001 - a scrape must not 500 on gauge
        pass


class MetricsServer:
    """Serve ``render()`` at /metrics until ``stop()``."""

    def __init__(self, render: Callable[[], str], *, port: int = 0,
                 host: str = "127.0.0.1") -> None:
        self.render = render
        self._requested_port = int(port)
        self.host = host
        # guards the _httpd/_thread lifecycle handoff only — never held
        # across bind/shutdown/join (those block on the network stack)
        self._state_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        """The bound port (after ``start()``; resolves port=0)."""
        httpd = self._httpd
        return httpd.server_address[1] if httpd else None

    @property
    def running(self) -> bool:
        return self._httpd is not None

    def start(self) -> "MetricsServer":
        with self._state_lock:
            if self._httpd is not None:
                # a second bind would leak a ThreadingHTTPServer on a
                # second port behind the caller's back — refuse loudly;
                # callers that may race a live endpoint check .running
                raise RuntimeError(
                    f"MetricsServer already serving on port {self.port}")
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 - stdlib API
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    try:
                        body = outer.render().encode()
                    except Exception as e:  # render must not kill a scrape
                        self.send_error(500, explain=str(e)[:200])
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/healthz":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", "3")
                    self.end_headers()
                    self.wfile.write(b"ok\n")
                else:
                    self.send_error(404)

            def log_message(self, *args) -> None:
                pass  # scrapes every few seconds; stderr stays quiet

        # bind OUTSIDE the state lock (it can block in the network
        # stack); publish under it, losing a concurrent start() cleanly
        httpd = ThreadingHTTPServer(
            (self.host, self._requested_port), Handler)
        httpd.daemon_threads = True
        with self._state_lock:
            if self._httpd is not None:
                httpd.server_close()
                raise RuntimeError(
                    f"MetricsServer already serving on port {self.port}")
            self._httpd = httpd
            self._thread = threading.Thread(
                target=httpd.serve_forever,
                name="graftserve-metrics", daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        """Shut the endpoint down and join the serving thread (bounded).
        Idempotent — concurrent/repeat stops take the refs under the
        state lock, so exactly one caller does the shutdown."""
        with self._state_lock:
            httpd, thread = self._httpd, self._thread
            self._httpd = None
            self._thread = None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)
