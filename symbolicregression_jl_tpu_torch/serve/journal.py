"""Durable request journal — the crash-recovery spine of graftserve.

A copy of the JAX package's ``serve/journal.py``: the ``graftserve.v1``
format is shared, so each package reads the other's journal, digest for
digest (tests/test_torch_serve.py).

Schema-versioned JSONL (``graftserve.v1``), one record per request
lifecycle transition, each record individually sha256-verified like the
checkpoint v2 envelope (api/checkpoint.py)::

    {"schema": "graftserve.v1", "seq": 7, "t": ..., "event": "submit",
     "request_id": "req00003", "detail": {...}, "sha256": "<hex>"}

The digest is computed over the canonical (sort_keys) JSON of the record
*without* the ``sha256`` field, so any bit flip or truncation inside a
record is detected on replay. Appends are flushed + fsync'd before
``append`` returns: once ``submit`` has returned to the client, the
acceptance survives a kill -9.

Replay (:meth:`RequestJournal.replay`) is corruption-tolerant in the
same spirit as the rolling-checkpoint fallback: a torn final record
(the expected artifact of a crash mid-append) is dropped silently-but-
audited, a corrupt record in the middle is skipped and reported, and
everything verifiable is returned in order. The server turns the
corruption notes into ``fault`` telemetry events so every recovery is
auditable (docs/SERVING.md).

Dataset arrays ride inside ``submit`` records as base64-encoded raw
bytes (:func:`encode_array`) — bit-exact round-trip, which the
killed-vs-unkilled bit-identity guarantee needs. The journal is the
replay source, so it holds the request's *effective* configuration:
post-admission shed sample size, demoted priority, seed, options
kwargs. This bounds journal use to small/medium requests; multi-GB datasets
want a content-addressed store, not a journal line.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "JOURNAL_SCHEMA",
    "JournalCorruptError",
    "RequestJournal",
    "encode_array",
    "decode_array",
]

JOURNAL_SCHEMA = "graftserve.v1"

# Lifecycle record kinds. `submit` carries the full effective request;
# the others reference it by request_id.
RECORD_EVENTS = ("submit", "start", "done", "cancel", "failed")


class JournalCorruptError(ValueError):
    """The journal file as a whole cannot be trusted (e.g. a schema
    marker from a future incompatible version). Per-record corruption
    does NOT raise — it is skipped and reported by ``replay``."""


def encode_array(a) -> Dict[str, Any]:
    """numpy array -> JSON-safe dict with bit-exact payload."""
    a = np.ascontiguousarray(a)
    return {
        "dtype": str(a.dtype),
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def decode_array(d: Dict[str, Any]) -> np.ndarray:
    return np.frombuffer(
        base64.b64decode(d["data"]), dtype=np.dtype(d["dtype"])
    ).reshape(d["shape"]).copy()


def _record_digest(rec: Dict[str, Any]) -> str:
    body = {k: v for k, v in rec.items() if k != "sha256"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()
    ).hexdigest()


class RequestJournal:
    """Append-only, digest-per-record JSONL journal for one server."""

    def __init__(self, path: str, injector=None) -> None:
        import threading

        self.path = path
        self.injector = injector  # ServeFaultInjector (corrupt-record hook)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # appends come from both the server (submit/cancel) and its
        # worker threads (start/done) — seq assignment and the write
        # must be atomic
        self._lock = threading.Lock()
        self._seq = 0
        self._records_written = 0
        # counter recovery from an existing file is deferred to the
        # first replay() or append(): the server replays once at
        # startup anyway, and submit records embed whole datasets — a
        # second parse+digest pass over the journal would double the
        # recovery cost for nothing
        self._recovered = not os.path.exists(path)

    # ------------------------------------------------------------------
    def append(self, event: str, request_id: str,
               detail: Optional[Dict[str, Any]] = None) -> int:
        """Durably append one record; returns its seq number."""
        if event not in RECORD_EVENTS:
            raise ValueError(
                f"journal event {event!r} not one of {RECORD_EVENTS}")
        if not self._recovered:
            self.replay()  # one-time counter recovery (reopened file)
        with self._lock:
            self._seq += 1
            seq = self._seq
            rec = {
                "schema": JOURNAL_SCHEMA,
                "seq": seq,
                "t": time.time(),
                "event": event,
                "request_id": str(request_id),
                "detail": detail or {},
            }
            rec["sha256"] = _record_digest(rec)
            line = (json.dumps(rec, sort_keys=True) + "\n").encode()
            # binary append: byte-exact offsets for the corruption-
            # injection hook, no text-mode tell() cookie ambiguity
            # a+b (not ab): append semantics with READ access, needed
            # for the torn-tail probe below
            #
            # _lock exists precisely to serialize seq assignment with
            # this file append+fsync (a record's durability is its
            # acknowledgement); callers never hold any other lock here
            with open(self.path, "a+b") as f:  # graftlint: disable=GL009
                f.seek(0, os.SEEK_END)
                if f.tell() > 0:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        # torn tail from a crash mid-append: seal the
                        # partial line so this record is not glued onto
                        # the corrupt bytes — otherwise the first
                        # post-restart append (already fsync'd and
                        # acknowledged to its client) would itself be
                        # unreadable after a second crash. replay still
                        # skips + audits the sealed torn line.
                        f.write(b"\n")
                offset = f.tell()
                f.write(line)
                f.flush()
                os.fsync(f.fileno())  # graftlint: disable=GL009
            self._records_written += 1
            if self.injector is not None:
                self.injector.on_journal_append(
                    self.path, self._records_written, offset,
                    len(line) - 1)
        return seq

    # ------------------------------------------------------------------
    def replay(self) -> Tuple[List[Dict[str, Any]],
                              List[Dict[str, Any]]]:
        """Read back every verifiable record, in order.

        Returns ``(records, corrupt)`` where ``corrupt`` is one note per
        unusable line: ``{"line": n, "reason": ..., "torn_tail": bool}``.
        A non-JSON or digest-failing FINAL line is classified as a torn
        tail (the normal crash artifact); anywhere else it is skipped
        corruption. Both are audited by the server as ``fault`` events.
        """
        records: List[Dict[str, Any]] = []
        corrupt: List[Dict[str, Any]] = []
        if not os.path.exists(self.path):
            return records, corrupt
        # binary read: a bit-flipped record may not even be valid UTF-8,
        # and one garbled line must not make the whole file unreadable
        with open(self.path, "rb") as f:
            lines = f.read().splitlines()
        last = len(lines)
        for lineno, raw in enumerate(lines, start=1):
            raw = raw.strip()
            if not raw:
                continue
            reason = None
            rec = None
            try:
                rec = json.loads(raw.decode())
            except UnicodeDecodeError as e:
                reason = f"invalid UTF-8: {e}"
            except json.JSONDecodeError as e:
                reason = f"invalid JSON: {e}"
            if rec is not None:
                if not isinstance(rec, dict):
                    reason = "record is not an object"
                elif rec.get("sha256") != _record_digest(rec):
                    # digest FIRST: a bit flip inside the schema string
                    # must be per-record corruption (skip + audit), not
                    # a file-level version error that bricks recovery
                    reason = "sha256 digest mismatch"
                elif rec.get("schema") != JOURNAL_SCHEMA:
                    # digest-valid but different schema: genuinely a
                    # file from an incompatible journal version
                    raise JournalCorruptError(
                        f"{self.path}:{lineno}: schema "
                        f"{rec.get('schema')!r}, expected "
                        f"{JOURNAL_SCHEMA!r}"
                    )
                elif rec.get("event") not in RECORD_EVENTS:
                    reason = f"unknown event {rec.get('event')!r}"
            if reason is not None:
                corrupt.append({
                    "line": lineno,
                    "reason": reason,
                    "torn_tail": lineno == last,
                })
                continue
            records.append(rec)
        with self._lock:
            if not self._recovered:
                self._recovered = True
                if records:
                    self._seq = max(self._seq,
                                    max(r["seq"] for r in records))
                # floor at the line count too: when the NEWEST record
                # is the corrupt one, its seq must not be reused by the
                # next append (every record's seq <= its line number,
                # so this over-approximation keeps seqs unique)
                self._seq = max(self._seq, last)
                self._records_written = max(self._records_written, last)
        return records, corrupt
