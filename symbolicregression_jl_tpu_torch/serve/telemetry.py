"""Server-side graftscope emitter (a copy of the JAX package's
``serve/telemetry.py``).

Each request's *search* writes its own graftscope.v1 stream (the
Telemetry hub, telemetry/hub.py) under the request's run directory; the
server itself writes one long-lived stream of ``serve`` and ``fault``
events — the fleet-level audit trail: admissions, rejections, journal
replay, cache hits, overload shedding, shutdowns. Both streams are the
same schema (telemetry/schema.py), so ``telemetry report`` and
``telemetry validate`` work on either, and the report's per-request
view groups serve events by request_id (docs/SERVING.md).

Unlike the per-search hub, this file is opened in append mode and
persists across server restarts — a restarted server's ``replay``
events land in the same stream as the original acceptances, which is
what makes the recovery auditable end to end.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

from ..ledger.context import TraceContext, mint_run_trace
from ..telemetry.schema import SCHEMA_VERSION

__all__ = ["ServeLog"]

# server-scope events (shutdown, journal faults, cache events that
# matched no live request) still carry a trace — the constant
# server-lifecycle tree. Root-independent by construction: no path in
# the mint, so cross-root A/B comparisons see identical ids here too.
_SERVER_TRACE = mint_run_trace("graftserve")


class ServeLog:
    """Append-only graftscope.v2 emitter for serve/fault events."""

    def __init__(self, path: Optional[str]) -> None:
        self.path = path
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {}
        # request_id -> TraceContext, populated by the server on
        # accept/replay: emitters that know only the request id (cache
        # callbacks, fault harness hooks) still stamp the right trace.
        # Bounded by the server's own request records.
        self.trace_of: Dict[str, TraceContext] = {}
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def _emit(self, obj: Dict[str, Any],
              trace: Optional[TraceContext] = None) -> None:
        obj = {"schema": SCHEMA_VERSION, "t": time.time(), **obj}
        obj["trace"] = (trace or _SERVER_TRACE).to_dict()
        if self.path is None:
            return
        try:
            # _lock is this log's own line-serialization lock (held for
            # one buffered write, nothing else nests inside it); the
            # server-wide lock is never held around log calls
            with self._lock, open(self.path, "a") as f:  # graftlint: disable=GL009
                f.write(json.dumps(obj) + "\n")
        except OSError:  # auditing must never break serving
            pass

    # ------------------------------------------------------------------
    def serve(self, kind: str, request_id: str,
              trace: Optional[TraceContext] = None, **detail) -> None:
        """One request-lifecycle event (schema event type ``serve``).

        ``trace`` is the request's journaled graftledger root span —
        the same trace_id the request's search hub stamps on its own
        stream, which is what makes the serve lifecycle and the engine
        iterations one causal tree across files. Callers without the
        context in hand fall back to the ``trace_of`` registry, then to
        the server-lifecycle trace."""
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if trace is None:
            trace = self.trace_of.get(str(request_id))
        self._emit({
            "event": "serve",
            "kind": str(kind),
            "request_id": str(request_id),
            "detail": {k: v for k, v in detail.items() if v is not None},
        }, trace=trace)

    def fault(self, kind: str, *, iteration: int = 0,
              trace: Optional[TraceContext] = None, **detail) -> None:
        """A shield-style fault/recovery audit record — same shape the
        search hub emits, so OverloadLadder and the fault injectors can
        target either sink."""
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self._emit({
            "event": "fault",
            "kind": str(kind),
            "iteration": int(iteration),
            "detail": {k: v for k, v in detail.items() if v is not None},
        }, trace=trace)
