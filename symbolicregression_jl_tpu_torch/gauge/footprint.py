"""Launch-geometry footprint ledger (graftgauge, part a).

Port of the JAX package's ``gauge/footprint.py``. The JAX package reads
XLA's static ``memory_analysis()`` of each compiled program; the port has
no compiled program to ask, so :func:`probe_engine_iteration` measures
one: it runs one throwaway ``Engine.run_iteration`` from the search's
state (the state is left as it was, so the search is unchanged) between
``torch.cuda.reset_peak_memory_stats`` and ``max_memory_allocated``, and
records the allocator's peak above what was live before, beside the
bytes of the state and data it reads and of the state it returns. One
probe per (options fingerprint, launch geometry): a geometry the ledger
knows is not probed again. On the CPU the probe records the argument and
output bytes only (there is no allocator peak to read).

Consumers (as in the JAX package):

- the serve :class:`~..serve.admission.AdmissionController` asks the
  :class:`~.capacity.HeadroomModel` "does a request of this shape
  fit?", which answers from this ledger's history;
- the serve ``ExecutableCache`` stamps known footprints onto its
  cache_hit/cache_miss telemetry details;
- ``/metrics`` renders one ``footprint_bytes`` gauge per ledger entry
  (serve/metrics.py ``render_gauge_metrics``);
- ``equation_search`` emits each new entry as a ``gauge`` event
  (kind ``footprint``) into the graftscope stream.

Everything here is host-side bookkeeping; the probe's iteration is
discarded, so the search stays bit-identical with it on or off.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "FootprintLedger",
    "geometry_key",
    "global_ledger",
    "probe_engine_iteration",
    "summarize_compiled",
]

# The summary's byte fields, in stable order (the JAX package's
# memory_analysis() names where one applies); total_bytes sums them.
_MEMORY_FIELDS = (
    "temp_size_in_bytes",
    "argument_size_in_bytes",
    "output_size_in_bytes",
)


def geometry_key(*, rows: int, nfeatures: int, nout: int = 1) -> str:
    """Canonical geometry label: the axes that change a program's
    footprint (dataset rows, features, outputs). Matches the admission
    shape-bucket axes so ledger history answers bucket queries."""
    return f"r{int(rows)}xf{int(nfeatures)}xo{int(nout)}"


def _tensor_bytes(obj) -> int:
    """Bytes of every tensor in a (nested) dataclass, tuple, list or dict."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        return int(obj.numel() * obj.element_size())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_tensor_bytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_bytes(v) for v in obj)
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v) for v in obj.values())
    return 0


def summarize_compiled(compiled: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """A probe's measurements of a built engine (the counterpart of a
    ``jax.stages.Compiled``'s memory analysis) as a ledger summary: the
    byte fields of ``_MEMORY_FIELDS`` it has, ``peak_bytes`` when the
    allocator gave one, and ``total_bytes`` over the byte fields; None
    when empty."""
    out: Dict[str, Any] = {}
    for field in _MEMORY_FIELDS + ("peak_bytes",):
        v = compiled.get(field)
        if v is not None:
            out[field] = int(v)
    if not any(f in out for f in _MEMORY_FIELDS):
        return None
    out["total_bytes"] = sum(int(out.get(f, 0)) for f in _MEMORY_FIELDS)
    return out


class FootprintLedger:
    """Thread-safe (fingerprint, geometry) -> footprint-summary table.

    One entry per distinct (options, launch geometry) the process has
    measured; re-recording an existing key refreshes the summary and
    bumps its ``compiles`` count (the JAX package's name for it).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], Dict[str, Any]] = {}

    def record(self, fingerprint: Optional[str], geometry: str,
               summary: Optional[Dict[str, Any]], *,
               source: str = "unknown",
               rows: Optional[int] = None,
               nfeatures: Optional[int] = None,
               nout: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Record one geometry's footprint; returns the stored
        entry (None when there was nothing to store)."""
        if not summary:
            return None
        key = (fingerprint or "", str(geometry))
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = {
                    "fingerprint": fingerprint,
                    "geometry": str(geometry),
                    "source": str(source),
                    "compiles": 0,
                    "rows": rows,
                    "nfeatures": nfeatures,
                    "nout": nout,
                }
                self._entries[key] = entry
            entry["compiles"] += 1
            entry["summary"] = dict(summary)
            return dict(entry)

    def known(self, fingerprint: Optional[str], geometry: str) -> bool:
        with self._lock:
            return (fingerprint or "", str(geometry)) in self._entries

    def lookup(self, fingerprint: Optional[str],
               geometry: Optional[str] = None
               ) -> Optional[Dict[str, Any]]:
        """The entry for an exact (fingerprint, geometry) key, or —
        with geometry None — the largest-footprint entry recorded for
        the fingerprint at any geometry (the conservative answer for
        "what does this config cost")."""
        with self._lock:
            if geometry is not None:
                e = self._entries.get((fingerprint or "", str(geometry)))
                return dict(e) if e is not None else None
            best = None
            for (fp, _), e in self._entries.items():
                if fp != (fingerprint or ""):
                    continue
                if best is None or (
                        e["summary"].get("total_bytes", 0)
                        > best["summary"].get("total_bytes", 0)):
                    best = e
            return dict(best) if best is not None else None

    def predict_bytes(self, *, rows: Optional[int] = None,
                      nfeatures: Optional[int] = None,
                      fingerprint: Optional[str] = None
                      ) -> Optional[int]:
        """Footprint estimate for a prospective program: the largest
        ``total_bytes`` among entries matching the given axes (None
        axes match everything; rows matches entries at or below the
        requested count — a bigger dataset can only cost more, so the
        estimate is a floor, reported as such by the headroom model)."""
        with self._lock:
            best: Optional[int] = None
            for e in self._entries.values():
                if fingerprint is not None and \
                        e.get("fingerprint") != fingerprint:
                    continue
                if nfeatures is not None and \
                        e.get("nfeatures") not in (None, int(nfeatures)):
                    continue
                if rows is not None and e.get("rows") is not None \
                        and int(e["rows"]) > int(rows):
                    continue
                total = e["summary"].get("total_bytes")
                if total and (best is None or int(total) > best):
                    best = int(total)
            return best

    def entries(self) -> List[Dict[str, Any]]:
        """Stable-ordered snapshot (the /metrics render and `telemetry
        report` iterate this)."""
        with self._lock:
            return [dict(e) for _, e in sorted(self._entries.items())]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


# Process-wide ledger: the search-loop probe records into it, and the
# serve layer's /metrics + admission advisor read it without threading a
# handle through every constructor. Append-only bookkeeping guarded by
# its own lock; never nested with any other lock.
_GLOBAL = FootprintLedger()


def global_ledger() -> FootprintLedger:
    return _GLOBAL


def probe_engine_iteration(engine, state, data, cur_maxsize=None,
                           *, ledger: Optional[FootprintLedger] = None,
                           source: str = "probe"
                           ) -> Optional[Dict[str, Any]]:
    """Run one throwaway iteration of ``engine`` from ``state`` and record
    its memory footprint (see the module docstring); the search loop
    gates it behind ``RuntimeOptions(gauge_footprint)``. Returns the
    ledger entry, or None when nothing could be measured (never raises —
    observability must not take down the search it measures)."""
    led = ledger if ledger is not None else _GLOBAL
    try:
        import torch

        from ..api.checkpoint import options_fingerprint

        fp = options_fingerprint(engine.options)
        rows = int(data.y.shape[0])
        geom = geometry_key(rows=rows, nfeatures=int(engine.nfeatures))
        if led.known(fp, geom):
            return led.lookup(fp, geom)
        maxsize = engine.options.maxsize if cur_maxsize is None else int(cur_maxsize)
        dev = torch.device(engine.device)
        measured: Dict[str, Any] = {
            "argument_size_in_bytes": _tensor_bytes(state) + _tensor_bytes(data)}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        out = engine.run_iteration(state, data, maxsize)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev)
            measured["peak_bytes"] = peak
            measured["temp_size_in_bytes"] = max(peak - before, 0)
        out_state = out[0] if isinstance(out, tuple) else out
        measured["output_size_in_bytes"] = _tensor_bytes(out_state)
        del out, out_state
        return led.record(
            fp, geom, summarize_compiled(measured), source=source,
            rows=rows, nfeatures=int(engine.nfeatures), nout=1,
        )
    except Exception:  # noqa: BLE001 - probe is best-effort by contract
        return None
