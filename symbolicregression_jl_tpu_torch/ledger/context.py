"""graftledger trace context: deterministic causal ids for one request.

A copy of the JAX package's ``ledger/context.py``: both packages mint the
same ids from the same request, so their journals and streams join.

A :class:`TraceContext` is the W3C-traceparent-shaped triple
``(trace_id, span_id, parent_id)`` that ties every graftscope event a
request causes — serve lifecycle, engine iterations, mesh exchanges,
faults, anomalies, pulse audits — into one causal tree reconstructable
from the JSONL streams alone (docs/OBSERVABILITY.md).

Determinism is the design constraint, not an accident: ids are minted
by hashing request *content* (request id, seed, iteration budget), so

- a kill-restart-replay reconstructs byte-identical trace ids from the
  journal (`serve/journal.py` stores the minted context in the submit
  detail, and :meth:`TraceContext.from_detail` reads it back verbatim —
  the hash is only the minting rule, never re-derived on replay), and
- two servers running the same request set over different roots agree
  on every id, which is what lets a test compare
  deterministic ledger fingerprints across an uninterrupted root and a
  killed-and-resumed one.

No RNG, no wall clock, no filesystem paths feed the hash.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional

__all__ = ["TraceContext", "mint_trace", "mint_run_trace"]

_MINT_DOMAIN = "graftledger"


def _hex(material: str, nchars: int) -> str:
    return hashlib.sha256(material.encode()).hexdigest()[:nchars]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One span in a request's causal tree.

    ``trace_id`` (32 hex chars) names the whole request tree; ``span_id``
    (16 hex chars) names this node; ``parent_id`` is the parent node's
    span_id (None at the root).
    """

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None

    def child(self, name: str) -> "TraceContext":
        """Deterministic child span (e.g. the search under a request)."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=_hex(f"{self.trace_id}:{self.span_id}:{name}", 16),
            parent_id=self.span_id,
        )

    def to_dict(self) -> Dict[str, Any]:
        """The ``trace`` field stamped onto graftscope.v2 events."""
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
        }

    @classmethod
    def from_dict(cls, obj: Optional[Dict[str, Any]]
                  ) -> Optional["TraceContext"]:
        """Inverse of :meth:`to_dict`; None/malformed input -> None (old
        journals and pre-v2 streams carry no trace)."""
        if not isinstance(obj, dict):
            return None
        trace_id = obj.get("trace_id")
        span_id = obj.get("span_id")
        if not isinstance(trace_id, str) or not isinstance(span_id, str):
            return None
        parent = obj.get("parent_id")
        return cls(trace_id=trace_id, span_id=span_id,
                   parent_id=parent if isinstance(parent, str) else None)


def mint_trace(request_id: str, *, seed: int, niterations: int
               ) -> TraceContext:
    """Root span for one served request, minted at ``submit()``.

    Hashes only request content — never the serve root path — so
    identical request sets over different roots mint identical ids.
    """
    trace_id = _hex(
        f"{_MINT_DOMAIN}:{request_id}:{seed}:{niterations}", 32)
    return TraceContext(
        trace_id=trace_id,
        span_id=_hex(f"{trace_id}:root", 16),
        parent_id=None,
    )


def mint_run_trace(run_id: str) -> TraceContext:
    """Root span for a plain (serverless) search, minted from its
    run_id by ``equation_search`` when no context was threaded in."""
    trace_id = _hex(f"{_MINT_DOMAIN}:run:{run_id}", 32)
    return TraceContext(
        trace_id=trace_id,
        span_id=_hex(f"{trace_id}:root", 16),
        parent_id=None,
    )
