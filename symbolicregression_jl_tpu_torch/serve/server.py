"""graftserve — a crash-safe, multi-tenant persistent search service.

Port of the JAX package's ``serve/server.py`` on one CUDA device (or the
CPU with ``device="cpu"``). One long-lived :class:`SearchServer` owns a
device, an engine cache, a bounded admission queue, and a durable
request journal; clients interact through a thin **submit / poll /
cancel** API in front of ``api/search.py`` (docs/SERVING.md is the full
design note). Each request runs the port's ``equation_search`` on
kernels #1-#3 with weighted (and, when packed, padded) data.
Robustness-first contracts:

- **Durability**: once ``submit`` returns, the request is journaled
  (serve/journal.py, fsync'd, sha256 per record). A SIGTERM'd, killed,
  or crashed server process, restarted over the same root directory,
  replays the journal and finishes every accepted request — in-flight
  searches resume from their graftshield rolling checkpoints
  (``resume="auto"``), and each completed result is **bit-identical**
  to what an unkilled server would have produced (the per-request
  searches are deterministic given seed+options, and boundary-only
  stops keep checkpoints on the uninterrupted trajectory).
- **Admission control**: bounded, shape-bucketed queue with an overload
  ladder (shield/degrade.py) — shed row-sample size, then queue
  priority, then reject with a structured retry-after error
  (serve/admission.py). Saturation never hangs and never OOMs the
  device with unbounded queued work.
- **Cancellation + deadlines**: per-request cancel and deadline are
  wired through ``RuntimeOptions.stop_hook`` (honored at iteration
  boundaries, preserving resume bit-identity) with a
  shield/watchdog.py backstop for genuinely hung dispatches.
- **Audit**: every lifecycle transition, recovery, rejection, shed, and
  cache hit/miss is a graftscope.v1 ``serve``/``fault`` event
  (serve/telemetry.py); ``telemetry report`` renders the per-request
  view and the executable-cache hit rate.

Requests are specified as JSON-able payloads (numpy data + an Options
**kwargs dict**) precisely so the journal can replay them; Options
objects with live callables don't survive a process boundary.

Threads and the card. The workers, and under packing each tenant of a
cohort, run ``equation_search`` on threads of this process against one
card. They share process-wide state, each guarded for it: the kernel
wrappers' launch counters and the first build and load of a kernel
library (``ops/cuda_build.py``'s lock), the engine cache, the journal,
the serve log; each search's span observer is thread-local
(telemetry/spans.py); the preemption guard's handlers are installed by
``start()`` on the main thread and the tenant searches only attach to
it. Every tenant launches on the default CUDA stream, not a stream of its
own: the search ends each iteration with ``torch.cuda.synchronize``,
which waits for the whole device, so a stream per tenant would not free
a tenant's host from its peers' kernels; the shared engine's tables were
made on the default stream and would need cross-stream events; and each
tenant's kernels are deterministic, so results are bit-identical either
way. A tenant that waits its turn behind its peers is not hung: the
request watchdog's budget (``deadline_s`` + ``hang_grace_s``) spans the
whole request, and the iteration deadlines are server-owned and off.
``Engine.degrade_eval_tile_rows`` on a shared engine lowers the
screening sample for every tenant of that engine (docs/SERVING.md).
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..ledger.context import TraceContext, mint_trace
from ..ledger.rollup import load_rollup, write_rollup
from ..pack import (PackedCohort, PackPolicy, pack_group_key, packable,
                    pad_to_bucket, slot_cap)
from ..shield.faults import active_serve_injector
from ..shield.watchdog import Watchdog, WatchdogTimeout
from ..device import resolve_device
from .admission import AdmissionController, ServerSaturated, shape_bucket
from .cache import ExecutableCache
from .journal import RequestJournal, decode_array, encode_array
from .telemetry import ServeLog

__all__ = ["SearchServer", "SearchRequest", "ServerSaturated"]

# Options keys the server owns; client-supplied values are ignored so a
# request can neither disable its own durability, write outside its run
# directory, nor arm the shield watchdog's process-abort (os._exit 124)
# — one tenant's deadline must never kill the whole server (and, via
# journal replay of the poison request, crash-loop every restart).
# Per-request deadlines go through submit(deadline_s=...), which
# cancels at iteration boundaries instead of aborting the process.
# timeout_in_seconds is owned for a different reason: a wall-clock stop
# is machine-load dependent, so it would journal a NONDETERMINISTIC
# partial result as "done" and break the kill-restart bit-identity
# contract. (max_evals/early_stop_condition stay client-usable: they
# stop on deterministic search state.)
_SERVER_OWNED_OPTIONS = (
    "output_directory", "save_to_file", "telemetry", "telemetry_file",
    "interactive_quit", "seed", "shield", "use_recorder",
    "iteration_deadline", "compile_budget", "timeout_in_seconds",
)

_TERMINAL = ("done", "failed", "cancelled")


@dataclasses.dataclass
class SearchRequest:
    """The journaled (effective, post-admission) form of one request."""

    request_id: str
    X: np.ndarray
    y: np.ndarray
    niterations: int
    seed: int
    options_kwargs: Dict[str, Any]
    priority: int = 0
    deadline_s: Optional[float] = None
    sample_rows: Optional[int] = None
    bucket: Tuple[int, int, int] = (0, 0, 0)
    index: int = 0  # k-th accepted request of this root, 1-based
    # graftpack padded-bucket provenance (docs/SERVING.md "Packed
    # tenancy"): the pow2 row count this request's dataset is padded to
    # (0 = unpacked path) and how many zero-weight replica rows that
    # adds AFTER any overload-shed sampling. Journaled effective
    # configuration, like sample_rows: replay reads these back instead
    # of re-deriving from the server's current pack setting, so a
    # killed-and-restarted request pads identically even if the
    # restarted server's pack policy changed.
    bucket_rows: int = 0
    pad_rows: int = 0
    # graftpulse: arm a profiler-capture window for this request's
    # search (RuntimeOptions.pulse_trace_on); journaled so a replayed
    # request still honors it
    pulse_trace: bool = False
    # graftledger: the request's root TraceContext, minted at submit()
    # from request content (ledger/context.py) and journaled — a
    # replayed request reads the ORIGINAL ids back verbatim, so
    # kill-restart-replay reconstructs the identical causal tree.
    trace: Optional[TraceContext] = None

    def to_detail(self) -> Dict[str, Any]:
        return {
            "X": encode_array(self.X),
            "y": encode_array(self.y),
            "niterations": int(self.niterations),
            "seed": int(self.seed),
            "options_kwargs": self.options_kwargs,
            "priority": int(self.priority),
            "deadline_s": self.deadline_s,
            "sample_rows": self.sample_rows,
            "bucket": list(self.bucket),
            "index": int(self.index),
            "bucket_rows": int(self.bucket_rows),
            "pad_rows": int(self.pad_rows),
            "pulse_trace": bool(self.pulse_trace),
            "trace": self.trace.to_dict() if self.trace else None,
        }

    @staticmethod
    def from_detail(request_id: str, d: Dict[str, Any]) -> "SearchRequest":
        return SearchRequest(
            request_id=request_id,
            X=decode_array(d["X"]),
            y=decode_array(d["y"]),
            niterations=int(d["niterations"]),
            seed=int(d["seed"]),
            options_kwargs=dict(d.get("options_kwargs") or {}),
            priority=int(d.get("priority", 0)),
            deadline_s=d.get("deadline_s"),
            sample_rows=d.get("sample_rows"),
            bucket=tuple(d.get("bucket") or (0, 0, 0)),
            index=int(d.get("index", 0)),
            bucket_rows=int(d.get("bucket_rows", 0)),
            pad_rows=int(d.get("pad_rows", 0)),
            pulse_trace=bool(d.get("pulse_trace", False)),
            # pre-graftledger journals carry no trace: re-mint from the
            # same content the original submit would have hashed, so
            # old roots replay with stable (and still deterministic) ids
            trace=(TraceContext.from_dict(d.get("trace"))
                   or mint_trace(request_id,
                                 seed=int(d["seed"]),
                                 niterations=int(d["niterations"]))),
        )


class _RequestRecord:
    """In-memory runtime state of one accepted request."""

    def __init__(self, request: SearchRequest) -> None:
        self.request = request
        # queued|running|done|failed|cancelled — a preempted request
        # goes back to "queued" (the `interrupted` serve EVENT audits
        # the transition; it is not a state)
        self.state = "queued"
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None
        self.cancel_event = threading.Event()
        self.cancel_reason: Optional[str] = None
        self.submitted_t = time.time()
        self.started_t: Optional[float] = None
        self.finished_t: Optional[float] = None
        self.resumed = False
        # False while submit() is still journaling the record (outside
        # the server lock): a cancel in that window defers its journal
        # write to submit's publish step, so the journal can never hold
        # a `cancel` record ahead of its `submit` (replay would drop it)
        self.journaled = False
        # wall-clock of the FIRST start attempt, surviving preemptions
        # and restarts (recovered from the journal's start records):
        # the request's deadline_s budget is anchored here, not at each
        # resume, so a preempted request cannot restart its clock
        self.first_started_wall: Optional[float] = None
        # live per-iteration progress (graftpulse /metrics gauges):
        # written by the worker's logger probe, read by metrics_text
        self.progress: Optional[Dict[str, Any]] = None

    def cancel(self, reason: str = "cancelled") -> None:
        # a terminal cancel (client/deadline) OVERRIDES a pending
        # preemption — preempt means "pause and resume later", cancel
        # means "never finish"; the terminal reason must win or the
        # requeue path would resurrect a cancelled request. The first
        # terminal reason sticks.
        if self.cancel_reason in (None, "preempted"):
            self.cancel_reason = reason
        self.cancel_event.set()

    def snapshot(self) -> Dict[str, Any]:
        return {
            "request_id": self.request.request_id,
            "state": self.state,
            "priority": self.request.priority,
            "bucket": list(self.request.bucket),
            "sample_rows": self.request.sample_rows,
            "bucket_rows": self.request.bucket_rows,
            "pad_rows": self.request.pad_rows,
            "result": self.result,
            "error": self.error,
            "cancel_reason": self.cancel_reason,
            "resumed": self.resumed,
        }


class _InjectorProbe:
    """RuntimeOptions.logger shim: a per-iteration hook inside a
    running request's search without any api/search.py surface. Serves
    three consumers: the serve fault injector (cancel-mid-iteration
    scenario), the /metrics per-request progress gauges (iteration,
    evals, evals/s of every RUNNING request, live), and — when the
    request runs inside a graftpack cohort — the lockstep barrier
    (pack/cohort.py), which keys the tenants' iteration boundaries
    together. The barrier call comes LAST: a cancel decided this
    iteration must not wait a full round to be observed."""

    def __init__(self, server: "SearchServer", rec: _RequestRecord,
                 cohort: Optional[PackedCohort] = None,
                 slot: Optional[int] = None) -> None:
        self.server = server
        self.rec = rec
        self.cohort = cohort
        self.slot = slot

    def log_iteration(self, *, iteration, num_evals=0.0, elapsed=0.0,
                      **_kw) -> None:
        it = int(iteration)
        self.rec.progress = {
            "iteration": it,
            "num_evals": float(num_evals),
            "elapsed_s": float(elapsed),
            "evals_per_sec": float(num_evals) / max(float(elapsed), 1e-9),
        }
        inj = self.server._injector
        if inj is not None and inj.should_cancel(
                self.rec.request.index, it,
                self.rec.request.request_id):
            self.rec.cancel("cancelled")
        if self.cohort is not None and self.slot is not None:
            self.cohort.arrive(self.slot)


class _RequestCacheView:
    """RuntimeOptions.engine_cache adapter pinning the request's
    ADMISSION bucket onto the cache's hit/miss accounting. Without it
    the cache recomputes the bucket from the effective row count, so an
    overload-shed request (1000 rows sampled to 500) would be
    admission-counted in bucket 1024 but cache-counted in bucket 512 —
    and `telemetry report`'s per-bucket views would disagree. Pure
    accounting: the engine cache key itself is row-agnostic."""

    def __init__(self, cache: ExecutableCache, bucket) -> None:
        self._cache = cache
        self._bucket = tuple(bucket) if any(bucket) else None

    def get_engine(self, options, **kw):
        if self._bucket is not None:
            kw.setdefault("bucket", self._bucket)
        return self._cache.get_engine(options, **kw)


def _le_bytes(t) -> bytes:
    """A tensor's bytes from a CPU copy, little-endian, C order."""
    a = np.ascontiguousarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                             else np.asarray(t))
    return a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()


def result_fingerprint(state) -> str:
    """sha256 over the hall-of-fame tensors of a finished SearchState (the
    JAX package's fields: the trees' arity, op, feat, const and length,
    then cost and loss, per output), read from CPU copies in a fixed byte
    order — the bit-identity comparison surface for the killed-vs-unkilled
    and packed-vs-solo checks (tests/test_torch_serve.py, ``chip_smoke.py``
    phase 32)."""
    h = hashlib.sha256()
    for ds in state.device_states:
        for f in ("arity", "op", "feat", "const", "length"):
            h.update(_le_bytes(getattr(ds.hof.trees, f)))
        h.update(_le_bytes(ds.hof.cost))
        h.update(_le_bytes(ds.hof.loss))
    return h.hexdigest()


class SearchServer:
    """The persistent engine process (see module docstring).

    ``SearchServer(root)`` over an existing root replays the journal and
    re-queues every accepted-but-unfinished request; call ``start()`` to
    begin (or resume) draining. ``workers=0`` with ``start()`` never
    called is valid — submissions queue (or reject) without running,
    which the admission tests use. Requests run on ``device`` (CUDA
    unless ``device="cpu"``). ``debug_checks=True`` (or ``SR_RACECHECK=1``)
    instruments the server's locks with the runtime lock-order auditor
    (``lint/racecheck.py``).
    """

    def __init__(
        self,
        root: str,
        *,
        capacity: int = 8,
        bucket_capacity: Optional[int] = None,
        workers: int = 1,
        ladder=None,
        cache: Optional[ExecutableCache] = None,
        hang_grace_s: float = 60.0,
        telemetry: bool = True,
        metrics_port: Optional[int] = None,
        debug_checks: bool = False,
        pack=None,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.log = ServeLog(
            os.path.join(self.root, "serve_telemetry.jsonl")
            if telemetry else None
        )
        self._injector = active_serve_injector(telemetry=self.log)
        self.journal = RequestJournal(
            os.path.join(self.root, "requests.jsonl"),
            injector=self._injector,
        )
        from ..gauge import HeadroomModel
        from ..shield.degrade import OverloadLadder

        self.admission = AdmissionController(
            capacity, bucket_capacity=bucket_capacity,
            ladder=ladder or OverloadLadder(telemetry=self.log),
            # graftgauge memory advisory: predicted footprint vs device
            # budget, attached to every accept record (advisory only —
            # see AdmissionController; docs/SERVING.md)
            headroom=HeadroomModel(),
        )
        self.cache = cache or ExecutableCache(
            on_event=self._on_cache_event)
        # graftpack multi-tenant packing (docs/SERVING.md "Packed
        # tenancy"): OFF by default. ``pack=True`` enables the default
        # PackPolicy; a PackPolicy instance sets the knobs. When on,
        # packable requests are padded to their admission bucket at
        # submit (journaled provenance) and same-group queued requests
        # launch together as one lockstep cohort sharing one cached
        # engine, instead of timesharing the worker.
        if pack is True:
            self.pack: Optional[PackPolicy] = PackPolicy()
        elif pack:
            self.pack = pack
        else:
            self.pack = None
        # pack counters for /metrics; mutated under self._lock
        self._pack_stats = {
            "launches": 0, "multi_tenant_launches": 0, "tenants": 0,
            "peak_tenants": 0, "occupancy_sum": 0.0, "occupancy_n": 0,
        }
        # pack groups whose shared engine has run at least one iteration
        # (a tenant completed one): cold groups stage their first launch
        # so ONE tenant pays the kernel build and load instead of every
        # tenant waiting on it concurrently
        self._pack_warm: set = set()
        self.workers = int(workers)
        self.hang_grace_s = float(hang_grace_s)
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._records: Dict[str, _RequestRecord] = {}
        self._queue: List[Tuple[int, int, str]] = []  # (priority, seq, id)
        self._qseq = 0
        self._rid_seq = 0  # auto request-id counter (collision-skipping)
        self._accepted = 0  # k-th accepted counter (faults target it)
        self._threads: List[threading.Thread] = []
        self._stopping = False
        self._preempting = False
        self._guard = None
        # per-WORKER-thread request attribution for cache events: a
        # shared attribute would be clobbered across workers
        self._cache_tls = threading.local()
        # graftpulse live metrics endpoint (serve/metrics.py): None
        # disables; 0 binds an ephemeral port (read server.metrics.port
        # back after start()). Scrapes render metrics_text() fresh.
        self.metrics = None
        if metrics_port is not None:
            from .metrics import MetricsServer

            self.metrics = MetricsServer(self.metrics_text,
                                         port=metrics_port)
        # graftwarden's runtime auditor (lint/racecheck.py): wraps every
        # serve/shield lock and the kernel launch path's process-wide
        # locks, asserts the actual acquisition order against the blessed
        # lint/lock_order.py manifest, and honours SR_RACE_PLAN's
        # deterministic context-switch windows. Opt-in (the flag or
        # SR_RACECHECK=1), so production pays nothing.
        self.debug_checks = bool(debug_checks) or bool(os.environ.get("SR_RACECHECK"))
        if self.debug_checks:
            from ..lint.racecheck import instrument_server

            self._race_recorder = instrument_server(self)
        self._recover()

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------
    def _recover(self) -> None:
        records, corrupt = self.journal.replay()
        for note in corrupt:
            # A torn tail is the expected crash artifact; mid-file
            # corruption means a journaled acceptance may be LOST — both
            # are audited, the latter loudly.
            self.log.fault(
                "journal_corrupt", line=note["line"],
                reason=note["reason"], torn_tail=note["torn_tail"],
            )
        started: Dict[str, bool] = {}
        pending: List[Tuple[int, int, str]] = []
        for rec in records:
            rid = rec["request_id"]
            ev = rec["event"]
            if ev == "submit":
                try:
                    req = SearchRequest.from_detail(rid, rec["detail"])
                    self.log.trace_of[rid] = req.trace
                except Exception as e:  # noqa: BLE001 - poison record
                    # a digest-valid record whose payload cannot be
                    # reconstructed must not brick recovery of every
                    # OTHER request in the root: skip it, loudly
                    self.log.fault(
                        "journal_replay_failed", request_id=rid,
                        error=f"{type(e).__name__}: {e}"[:200],
                    )
                    continue
                r = _RequestRecord(req)
                r.journaled = True
                self._records[rid] = r
                self._accepted = max(self._accepted, req.index)
                pending.append((req.priority, req.index, rid))
            elif rid not in self._records:
                continue  # lifecycle record whose submit was corrupted
            elif ev == "start":
                started[rid] = True
                r = self._records[rid]
                t = rec.get("t")
                if isinstance(t, (int, float)) and (
                        r.first_started_wall is None
                        or t < r.first_started_wall):
                    r.first_started_wall = t
            elif ev == "done":
                r = self._records[rid]
                r.state = "done"
                r.result = rec["detail"].get("result")
            elif ev == "cancel":
                r = self._records[rid]
                r.state = "cancelled"
                r.cancel_reason = rec["detail"].get("reason", "cancelled")
            elif ev == "failed":
                r = self._records[rid]
                r.state = "failed"
                r.error = rec["detail"].get("error")
        for priority, index, rid in sorted(pending, key=lambda t: t[:2]):
            r = self._records[rid]
            if r.state in _TERMINAL:
                continue
            r.resumed = started.get(rid, False)
            self.admission.readmit(r.request.bucket)
            # construction-time: _recover runs from __init__ before any
            # worker thread exists, so the queue counter is unshared
            self._qseq += 1  # graftlint: disable=GL011
            heapq.heappush(self._queue, (priority, self._qseq, rid))
            self.log.serve(
                "replay", rid, trace=r.request.trace, resumed=r.resumed,
                bucket=list(r.request.bucket),
            )

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    def submit(
        self,
        X,
        y,
        *,
        options: Optional[Dict[str, Any]] = None,
        niterations: int = 4,
        seed: int = 0,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        request_id: Optional[str] = None,
        pulse_trace: bool = False,
    ) -> str:
        """Admit one search request; returns its request_id.

        Raises :class:`ServerSaturated` (with a retry-after hint) when
        the queue or the request's shape class is full, and ValueError
        for malformed payloads. On return the request is durably
        journaled and will complete even across server crashes.
        """
        # copy, not asarray: the accepted request must be a SNAPSHOT of
        # the submit-time bytes. A caller reusing its buffer after
        # submit would otherwise mutate the queued in-memory request
        # while the journal holds the original — and the in-process
        # result would differ from a crash-replay's (bit-identity).
        X = np.array(X, copy=True)
        y = np.array(y, copy=True)
        if X.ndim != 2 or y.ndim != 1 or X.shape[0] != y.shape[0]:
            raise ValueError(
                f"expected X [n, f] and y [n]; got {X.shape} / {y.shape}")
        if X.dtype.kind not in "biuf" or y.dtype.kind not in "biuf":
            # an object-dtype array would journal cleanly (tobytes()
            # succeeds) but decode_array cannot reconstruct it — the
            # poison record would brick every future replay of the root
            raise ValueError(
                f"X/y must be numeric arrays; got {X.dtype} / {y.dtype}")
        opts = dict(options or {})
        for k in _SERVER_OWNED_OPTIONS:
            opts.pop(k, None)
        try:
            json.dumps(opts)
        except TypeError as e:
            raise ValueError(
                "serve options must be a JSON-able kwargs dict (the "
                f"journal replays it across restarts): {e}"
            ) from e
        if self._stopping:
            raise ServerSaturated(
                "server is shutting down",
                retry_after_s=self.admission.default_retry_after_s,
                queue_depth=self.admission.depth,
                capacity=self.admission.capacity,
                bucket=shape_bucket(X.shape[0], X.shape[1]),
                level="shutdown",
            )
        # admission (internally locked) runs OUTSIDE the server lock:
        # under overload its ladder writes shed/reject audit records to
        # the serve telemetry file, and file I/O must not stall
        # poll/cancel or the workers' queue transitions
        try:
            decision = self.admission.admit(
                n_rows=X.shape[0], nfeatures=X.shape[1],
                priority=priority, request_id=request_id or "",
            )
        except ServerSaturated as e:
            self.log.serve("reject", request_id or "", **e.to_dict())
            raise
        try:
            with self._lock:
                if self._stopping:
                    raise ServerSaturated(
                        "server is shutting down",
                        retry_after_s=(
                            self.admission.default_retry_after_s),
                        queue_depth=self.admission.depth,
                        capacity=self.admission.capacity,
                        bucket=decision.bucket, level="shutdown",
                    )
                if request_id is not None:
                    rid = request_id
                    if rid in self._records:
                        raise ValueError(
                            f"request_id {rid!r} already exists")
                else:
                    # server-owned counter, skipping past any id a
                    # client chose explicitly — an auto id must never
                    # collide
                    while True:
                        self._rid_seq += 1
                        rid = f"req{self._rid_seq:05d}"
                        if rid not in self._records:
                            break
                self._accepted += 1
                # graftpack padding provenance, decided AT ADMISSION and
                # journaled: effective rows (post-shed) padded up to the
                # bucket's pow2 row count. Computed here, not at run
                # time, so replay pads identically regardless of the
                # replaying server's pack setting.
                bucket_rows = pad_rows = 0
                if self.pack is not None and packable(opts):
                    eff_rows = (
                        decision.sample_rows
                        if decision.sample_rows is not None
                        and decision.sample_rows < X.shape[0]
                        else X.shape[0])
                    bucket_rows = int(decision.bucket[0])
                    pad_rows = max(bucket_rows - int(eff_rows), 0)
                req = SearchRequest(
                    request_id=rid, X=X, y=y,
                    niterations=int(niterations), seed=int(seed),
                    options_kwargs=opts, priority=decision.priority,
                    deadline_s=deadline_s,
                    sample_rows=decision.sample_rows,
                    bucket=decision.bucket, index=self._accepted,
                    bucket_rows=bucket_rows, pad_rows=pad_rows,
                    pulse_trace=bool(pulse_trace),
                    # graftledger root span: minted from request content
                    # (never the root path), journaled with the submit
                    # record — replay and cross-root A/B runs agree on
                    # every id
                    trace=mint_trace(rid, seed=int(seed),
                                     niterations=int(niterations)),
                )
                # reserve the id (collision checks see it) but do NOT
                # enqueue yet: no worker may journal a dependent
                # "start" before the submit record is durable
                rec = _RequestRecord(req)
                self._records[rid] = rec
        except BaseException:
            self.admission.release(decision.bucket)
            raise
        # the heavy part — base64-encoding the dataset + an fsync'd
        # append — runs OUTSIDE the server lock (the journal has its
        # own), so one client's submit I/O cannot stall poll/cancel or
        # the workers' queue transitions
        try:
            self.journal.append("submit", rid, req.to_detail())
        except OSError:
            with self._lock:
                self._records.pop(rid, None)
                self.admission.release(decision.bucket)
                # _accepted is NOT rolled back: a concurrent submit may
                # already hold the next index — a gap in the accepted
                # numbering is harmless, a duplicate is not
            raise
        # audit "accept" BEFORE the publish step: once the request is
        # on the heap a worker may log "start" immediately, and the
        # per-request view's lifecycle ordering (accept -> start) must
        # hold in the stream. Still outside the server lock.
        self.log.trace_of[rid] = req.trace
        self.log.serve(
            "accept", rid, trace=req.trace, bucket=list(decision.bucket),
            priority=decision.priority,
            sample_rows=decision.sample_rows,
            level=decision.level, queue_depth=self.admission.depth,
            memory=decision.memory,
            # graftpack padding provenance: bucket_rows=0 means the
            # unpacked path; `report summarize_requests` audits these
            bucket_rows=req.bucket_rows, pad_rows=req.pad_rows,
        )
        with self._lock:
            rec.journaled = True
            cancelled = rec.cancel_event.is_set()
            if cancelled:
                # a cancel arrived while the record was being journaled
                # (deferred by cancel() so the journal stays in order):
                # finalize it here instead of enqueueing
                rec.state = "cancelled"
                rec.finished_t = time.time()
                self.admission.release(decision.bucket)
            else:
                self._qseq += 1
                heapq.heappush(self._queue,
                               (req.priority, self._qseq, rid))
                self._cond.notify_all()
        if cancelled:
            self._journal_cancel(rec, where="queued")
        return rid

    def poll(self, request_id: str) -> Dict[str, Any]:
        """Status snapshot of one request (state, result when done)."""
        with self._lock:
            rec = self._records.get(request_id)
            if rec is None:
                raise KeyError(f"unknown request_id {request_id!r}")
            return rec.snapshot()

    def cancel(self, request_id: str, reason: str = "cancelled") -> bool:
        """Cancel a queued or running request. Returns False when the
        request already reached a terminal state."""
        with self._lock:
            rec = self._records.get(request_id)
            if rec is None:
                raise KeyError(f"unknown request_id {request_id!r}")
            if rec.state in _TERMINAL:
                return False
            rec.cancel(reason)
            # finalize a queued cancel only once its submit record is
            # durable — a cancel racing submit's unlocked journal write
            # would otherwise land its record FIRST, and replay drops
            # lifecycle records that precede their submit (the request
            # would resurrect). Pre-journal cancels are completed by
            # submit's publish step.
            finalize = rec.state == "queued" and rec.journaled
            if finalize:
                # remove from the heap lazily (worker skips cancelled)
                rec.state = "cancelled"
                rec.finished_t = time.time()
                self.admission.release(rec.request.bucket)
        if finalize:
            self._journal_cancel(rec, where="queued")
        return True

    def requests(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r.snapshot() for r in self._records.values()]

    def metrics_text(self) -> str:
        """The /metrics exposition body (Prometheus text format);
        docs/OBSERVABILITY.md has the metric-name table. Renders fresh
        from the server's own counters — no sampling thread."""
        from ..pulse import PromText

        p = PromText("graftserve")
        p.gauge("queue_depth", self.admission.depth,
                "Requests queued or running")
        p.gauge("queue_capacity", self.admission.capacity,
                "Admission queue capacity")
        p.gauge("queue_utilization", self.admission.utilization(),
                "queue_depth / queue_capacity")
        for bucket, n in sorted(self.admission.in_flight_by_bucket().items()):
            p.gauge("bucket_in_flight", n,
                    "Queued+running requests per admission shape bucket",
                    labels={"bucket": "x".join(str(b) for b in bucket)})
        stats = self.cache.stats()
        p.gauge("cache_entries", stats["entries"], "Cached engines")
        p.counter("cache_hits_total", stats["hits"],
                  "Executable-cache hits")
        p.counter("cache_misses_total", stats["misses"],
                  "Executable-cache misses")
        p.gauge("cache_hit_rate", stats["hit_rate"] or 0.0,
                "hits / (hits + misses); 0 before any lookup")
        if self.pack is not None:
            with self._lock:
                ps = dict(self._pack_stats)
            p.counter("pack_launches_total", ps["launches"],
                      "Packed cohort launches")
            p.counter("pack_multi_tenant_launches_total",
                      ps["multi_tenant_launches"],
                      "Cohort launches holding more than one tenant")
            p.counter("pack_tenants_total", ps["tenants"],
                      "Tenant searches run inside packed cohorts")
            p.gauge("pack_peak_tenants", ps["peak_tenants"],
                    "Largest tenant count of any single launch")
            p.gauge("pack_mean_occupancy",
                    (ps["occupancy_sum"] / ps["occupancy_n"]
                     if ps["occupancy_n"] else 0.0),
                    "Mean per-round tenant occupancy across launches")
        with self._lock:
            by_state: Dict[str, int] = {}
            running = []
            for r in self._records.values():
                by_state[r.state] = by_state.get(r.state, 0) + 1
                if r.state == "running" and r.progress is not None:
                    running.append((r.request, dict(r.progress)))
        for state in ("queued", "running", "done", "failed", "cancelled"):
            p.gauge("requests", by_state.get(state, 0),
                    "Requests by lifecycle state",
                    labels={"state": state})
        # per-RUNNING-request progress only: terminal requests would
        # grow the label cardinality without bound over a server's life
        for req, prog in running:
            labels = {"request": req.request_id}
            p.gauge("request_iteration", prog["iteration"],
                    "Completed iterations of a running request", labels)
            p.gauge("request_iterations_total", req.niterations,
                    "Iteration target of a running request", labels)
            p.gauge("request_evals", prog["num_evals"],
                    "Cumulative expression evaluations", labels)
            p.gauge("request_evals_per_sec", prog["evals_per_sec"],
                    "Cumulative evaluation rate", labels)
        # graftledger per-tenant cost attribution: device/host/compile
        # seconds, evals, checkpoint bytes, and the log-bucketed
        # iteration-latency histogram per request, from the rollup the
        # completion path maintains (ledger/rollup.py)
        from .metrics import render_gauge_metrics, render_ledger_metrics

        render_ledger_metrics(p, load_rollup(self.root))
        # graftgauge capacity section: dispatch-latency histogram, peak
        # live bytes, per-entry compiled-program footprints
        render_gauge_metrics(p)
        return p.render()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "SearchServer":
        """Start the worker pool (and the process-global preemption
        guard when called from the main thread — a SIGTERM then drains
        gracefully: in-flight searches stop at the next iteration
        boundary with their emergency checkpoints, and the journal
        carries everything else)."""
        from ..shield.signals import PreemptionGuard

        with self._lock:
            # a prior stop() that timed out may have left finished (or
            # still-draining) workers tracked; only fully-dead threads
            # are pruned — live stragglers block a restart rather than
            # letting worker count exceed the configured pool
            self._threads = [t for t in self._threads if t.is_alive()]
            if self._threads:
                return self
            self._stopping = False
            self._preempting = False
            if self._guard is not None:
                # a SIGTERM-drained pool dies without stop() running:
                # detach the stale guard so the attach below opens a
                # fresh cycle (refcount back to 0 clears the shared
                # preempt flag — otherwise new workers would observe
                # the old signal and exit immediately)
                self._guard.uninstall()
                self._guard = None
            self._guard = PreemptionGuard().install()
            for i in range(max(self.workers, 1)):
                t = threading.Thread(
                    target=self._worker_loop,
                    name=f"graftserve-worker-{i}", daemon=True,
                )
                t.start()
                self._threads.append(t)
        if self.metrics is not None and not self.metrics.running:
            # .running guard: a stop() that timed out keeps the endpoint
            # up, and MetricsServer.start() now refuses a double bind
            self.metrics.start()
        return self

    def stop(self, drain: bool = False, timeout: Optional[float] = None
             ) -> None:
        """Stop the server. ``drain=True`` finishes everything queued
        first; ``drain=False`` preempts in-flight searches at their next
        iteration boundary (their checkpoints + the journal let a later
        server finish them)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        if drain:
            self.wait_idle(timeout=timeout)
        with self._lock:
            self._stopping = True
            if not drain:
                self._preempting = True
                for rec in self._records.values():
                    if rec.state == "running":
                        rec.cancel("preempted")
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=(
                None if deadline is None
                else max(deadline - time.monotonic(), 0.1)))
        alive = [t for t in self._threads if t.is_alive()]
        if alive:
            # the stop timeout elapsed mid-dispatch: the workers WILL
            # exit at their next iteration boundary (stop flags are
            # set). Keep them tracked (start() must not over-spawn),
            # keep _preempting and the guard live (their searches still
            # need the stop signal), and audit the leak.
            self._threads = alive
            self.log.fault("stop_timeout", workers=len(alive))
            return
        self._threads = []
        self._preempting = False
        if self._guard is not None:
            self._guard.uninstall()
            self._guard = None
        if self.metrics is not None:
            # only on a FULL stop: a stop_timeout return above keeps the
            # endpoint up — the server is still effectively running
            self.metrics.stop()
        self.log.serve("shutdown", "", drained=drain)

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until no request is queued or running."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                # record states, NOT the heap: a queued cancel is
                # removed lazily (the tuple stays on the heap until a
                # worker pops and skips it), and a stale entry must not
                # make an idle server look busy — stop(drain=True)
                # would hang forever with workers=0
                busy = any(
                    r.state in ("queued", "running")
                    for r in self._records.values())
                if not busy:
                    return True
                remaining = (
                    None if deadline is None
                    else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=(
                    0.5 if remaining is None else min(remaining, 0.5)))

    def wait(self, request_id: str, timeout: Optional[float] = None
             ) -> Dict[str, Any]:
        """Block until one request reaches a terminal state."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            snap = self.poll(request_id)
            if snap["state"] in _TERMINAL:
                return snap
            if deadline is not None and time.monotonic() > deadline:
                return snap
            time.sleep(0.05)

    def __enter__(self) -> "SearchServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))

    # ------------------------------------------------------------------
    # worker
    # ------------------------------------------------------------------
    def _preempt_requested(self) -> bool:
        return self._preempting or (
            self._guard is not None and self._guard.requested)

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopping and (
                        not self._preempt_requested()):
                    self._cond.wait(timeout=0.2)
                if self._stopping or self._preempt_requested():
                    self._cond.notify_all()
                    return
                _, _, rid = heapq.heappop(self._queue)
                rec = self._records.get(rid)
                if rec is None or rec.state != "queued":
                    continue  # lazily-removed cancellation
                rec.state = "running"
                rec.started_t = time.time()
            try:
                if self.pack is not None and rec.request.bucket_rows > 0:
                    # packed path: this worker becomes the cohort
                    # manager — it claims co-queued same-group requests
                    # and launches them together (one shared engine,
                    # lockstep iterations)
                    self._run_packed_cohort(rec)
                else:
                    self._run_request(rec)
            except Exception as e:  # noqa: BLE001 - fail the request
                self._finish(rec, "failed",
                             error=f"{type(e).__name__}: {e}")
            with self._cond:
                self._cond.notify_all()

    # ------------------------------------------------------------------
    # graftpack: packed-cohort manager (docs/SERVING.md "Packed tenancy")
    # ------------------------------------------------------------------
    def _claim_pack_peers(self, gkey: str,
                          budget: int) -> List[_RequestRecord]:
        """Claim up to ``budget`` queued requests of the same pack group
        (same bucket + same options kwargs). Claimed records flip to
        "running" under the lock; their heap tuples are removed lazily,
        exactly like a queued cancel (the worker pop skips non-queued
        states)."""
        claimed: List[_RequestRecord] = []
        with self._lock:
            for _, _, rid in sorted(self._queue):
                if len(claimed) >= budget:
                    break
                r = self._records.get(rid)
                if r is None or r.state != "queued":
                    continue
                rq = r.request
                if rq.bucket_rows <= 0:
                    continue
                if pack_group_key(rq.bucket, rq.options_kwargs) != gkey:
                    continue
                r.state = "running"
                r.started_t = time.time()
                claimed.append(r)
        return claimed

    def _run_pack_tenant(self, rec: _RequestRecord,
                         cohort: PackedCohort, slot: int) -> None:
        """One tenant of a packed launch: the unchanged per-request run
        (journal start/done, checkpoints, ledger, telemetry all intact),
        plus cohort membership for the iteration barrier. Always peels
        the slot off, whatever the outcome — a leaked slot would stall
        the peers' barrier until its timeout."""
        try:
            try:
                self._run_request(rec, cohort=cohort, slot=slot)
            except Exception as e:  # noqa: BLE001 - fail the request
                self._finish(rec, "failed",
                             error=f"{type(e).__name__}: {e}")
        finally:
            cohort.leave(slot)
            self.log.serve(
                "pack_peel", rec.request.request_id,
                trace=rec.request.trace, state=rec.state,
                iterations=(rec.progress or {}).get("iteration"),
            )
            with self._cond:
                self._cond.notify_all()

    def _run_packed_cohort(self, lead: _RequestRecord) -> None:
        """Cohort manager, run on the worker thread that popped the
        lead request: coalesce the burst, launch every tenant on its
        own thread, then admit late joiners at iteration boundaries
        until the group drains. Tenant threads are owned by this
        manager (the worker does not return until they exit), so
        stop()/preemption semantics are unchanged — each tenant's
        stop_hook fires exactly as on the unpacked path."""
        req = lead.request
        gkey = pack_group_key(req.bucket, req.options_kwargs)
        # graftgauge bin capacity: the per-bucket byte prediction from
        # the headroom model bounds how many tenants one launch holds.
        # Advisory contract carries over: no data -> policy cap, and
        # the floor is always the lead tenant.
        advice = None
        if self.admission.headroom is not None:
            try:
                advice = self.admission.headroom.advise(
                    bucket=req.bucket,
                    limit_bytes=self.admission.memory_limit_bytes)
            except Exception:  # noqa: BLE001 - advisory is best-effort
                advice = None
        cap = slot_cap(self.pack, advice)
        cohort = PackedCohort(
            gkey, slot_cap=cap,
            barrier_timeout_s=self.pack.barrier_timeout_s)
        # coalesce window (no locks held): let the rest of a burst land
        # before the first launch so it starts at high occupancy
        if self.pack.coalesce_window_s > 0 and not self._stopping:
            time.sleep(self.pack.coalesce_window_s)
        members = [(lead, cohort.join(req.request_id))]
        for r in self._claim_pack_peers(gkey, cap - 1):
            slot = cohort.join(r.request.request_id)
            if slot is None:  # cannot happen while only we add; belt
                self._requeue_claimed(r)
                continue
            members.append((r, slot))
        launch_t = time.time()
        self.log.serve(
            "pack_launch", req.request_id, trace=req.trace,
            bucket=list(req.bucket), slot_cap=cap,
            tenants=[r.request.request_id for r, _ in members],
            coalesce_wait_s={
                r.request.request_id: round(launch_t - r.submitted_t, 6)
                for r, _ in members},
            memory=advice,
        )
        with self._lock:
            st = self._pack_stats
            st["launches"] += 1
            st["tenants"] += len(members)
            if len(members) > 1:
                st["multi_tenant_launches"] += 1
            st["peak_tenants"] = max(st["peak_tenants"], len(members))
        threads: List[threading.Thread] = []

        def spawn(r: _RequestRecord, slot: int) -> None:
            t = threading.Thread(
                target=self._run_pack_tenant, args=(r, cohort, slot),
                name=f"graftpack-{r.request.request_id}", daemon=True)
            t.start()
            threads.append(t)

        with self._lock:
            warm = gkey in self._pack_warm
        spawn(*members[0])
        if not warm and len(members) > 1:
            # cold group: the lead's FIRST iteration builds and loads
            # the kernels (ops/cuda_build.py) and warms the allocator;
            # peers spawned now would wait on the same build lock and
            # contend for the first allocations. Hold the peers
            # until the lead's first iteration boundary — the probe
            # sets rec.progress BEFORE arriving at the barrier, and
            # the lead then simply waits at that barrier until the
            # warmed peers catch up (scheduling-only, always safe).
            lead_t = threads[0]
            while (lead_t.is_alive() and lead.progress is None
                   and not self._stopping
                   and not self._preempt_requested()):
                lead_t.join(timeout=self.pack.join_poll_s)
            if lead.progress is not None:
                with self._lock:
                    self._pack_warm.add(gkey)
        else:
            with self._lock:
                self._pack_warm.add(gkey)
        for r, slot in members[1:]:
            spawn(r, slot)
        # late-join loop: free slots (initial headroom or peeled
        # tenants) admit queued same-group requests at iteration
        # boundaries while the cohort is still running
        while any(t.is_alive() for t in threads):
            if not self._stopping and not self._preempt_requested():
                budget = cap - cohort.size()
                if budget > 0:
                    for r in self._claim_pack_peers(gkey, budget):
                        slot = cohort.join(r.request.request_id)
                        if slot is None:
                            self._requeue_claimed(r)
                            continue
                        self.log.serve(
                            "pack_join", r.request.request_id,
                            trace=r.request.trace,
                            bucket=list(r.request.bucket),
                            coalesce_wait_s=round(
                                time.time() - r.submitted_t, 6),
                        )
                        with self._lock:
                            self._pack_stats["tenants"] += 1
                        spawn(r, slot)
            for t in threads:
                if t.is_alive():
                    t.join(timeout=self.pack.join_poll_s)
                    break
        occ = cohort.occupancy()
        self.log.serve("pack_done", req.request_id, trace=req.trace,
                       bucket=list(req.bucket), **occ)
        with self._lock:
            if occ["occupancy"] is not None:
                self._pack_stats["occupancy_sum"] += occ["occupancy"]
                self._pack_stats["occupancy_n"] += 1

    def _requeue_claimed(self, rec: _RequestRecord) -> None:
        """Put a claimed-but-not-launched record back on the queue."""
        with self._cond:
            if rec.state == "running":
                rec.state = "queued"
                self._qseq += 1
                heapq.heappush(
                    self._queue,
                    (rec.request.priority, self._qseq,
                     rec.request.request_id))
                self._cond.notify_all()

    # ------------------------------------------------------------------
    def _on_cache_event(self, kind: str, detail: Dict[str, Any]) -> None:
        rid = getattr(self._cache_tls, "request_id", "") or ""
        rec = self._records.get(rid)
        self.log.serve(kind, rid,
                       trace=rec.request.trace if rec else None, **detail)

    def _request_dir(self, rid: str) -> str:
        return os.path.join(self.root, "requests", rid)

    def _journal_cancel(self, rec: _RequestRecord, *, where: str) -> None:
        """Durably record + audit a queued-cancel. Caller must NOT hold
        the server lock — the append fsyncs."""
        rid = rec.request.request_id
        try:
            self.journal.append(
                "cancel", rid, {"reason": rec.cancel_reason or "cancelled"})
        except OSError as e:
            self.log.fault("journal_write_failed", request_id=rid,
                           event="cancel", error=str(e)[:200])
        self.log.serve("cancel", rid, trace=rec.request.trace,
                       reason=rec.cancel_reason, where=where)

    def _finish(self, rec: _RequestRecord, state: str, *, result=None,
                error=None, journal_event: Optional[str] = None) -> None:
        with self._lock:
            rec.state = state
            rec.result = result
            rec.error = error
            rec.finished_t = time.time()
            self.admission.release(rec.request.bucket)
            if rec.started_t is not None:
                self.admission.observe_service_time(
                    rec.finished_t - rec.started_t)
        # journal + audit OUTSIDE the server lock (the journal has its
        # own): the fsync'd terminal record on a contended disk must
        # not stall poll/submit/cancel or the other workers
        try:
            if journal_event:
                detail: Dict[str, Any] = {}
                if result is not None:
                    detail["result"] = result
                if error is not None:
                    detail["error"] = str(error)[:500]
                if state == "cancelled":
                    detail["reason"] = rec.cancel_reason or "cancelled"
                self.journal.append(
                    journal_event, rec.request.request_id, detail)
            elif state == "failed":
                self.journal.append(
                    "failed", rec.request.request_id,
                    {"error": str(error)[:500]})
        except OSError as e:
            # a full/failing disk must not leak the admission slot or
            # kill the worker thread: the in-memory state is final
            # either way, and a restart simply re-runs the request
            # (its terminal record is missing) — the deterministic
            # search makes that safe, just wasteful
            self.log.fault(
                "journal_write_failed",
                request_id=rec.request.request_id,
                event=journal_event or state, error=str(e)[:200],
            )
        self.log.serve(
            {"cancelled": "cancel"}.get(state, state),
            rec.request.request_id, trace=rec.request.trace,
            error=error, reason=rec.cancel_reason,
        )
        # graftledger rollup: rebuild the per-tenant view from the
        # per-request ledger files on every completion. A full rewrite,
        # so a crash between completions loses nothing — the files are
        # the source of truth. /metrics and `bench load` read it.
        write_rollup(self.root)

    def _run_request(self, rec: _RequestRecord,
                     cohort: Optional[PackedCohort] = None,
                     slot: Optional[int] = None) -> None:
        from ..api.search import RuntimeOptions, equation_search
        from ..core.options import Options

        req = rec.request
        rid = req.request_id
        try:
            self.journal.append("start", rid, {"resumed": rec.resumed})
        except OSError as e:
            # same policy as _finish: a transient disk failure must not
            # terminally fail a durably-accepted request. Cost of a
            # missing start record: a restart loses the deadline anchor
            # and the resumed flag — the search itself still resumes
            # from its checkpoints.
            self.log.fault("journal_write_failed", request_id=rid,
                           event="start", error=str(e)[:200])
        self.log.serve("start", rid, trace=req.trace, resumed=rec.resumed)
        if self._injector is not None:
            self._injector.on_request_start(req.index, rid)

        options = Options(
            output_directory=self._request_dir(rid),
            save_to_file=True, telemetry=True, interactive_quit=False,
            shield=True, seed=req.seed, **req.options_kwargs,
        )
        X, y = req.X, req.y
        if req.sample_rows is not None and req.sample_rows < X.shape[0]:
            # overload shed, journaled at admission. Deterministic
            # STRIDED sample, not a head slice: row-ordered datasets
            # (time series, swept parameters) keep full domain
            # coverage, and the selection depends only on
            # (n, sample_rows) so a crash-replay re-runs the identical
            # degraded search
            sel = (np.arange(req.sample_rows) * X.shape[0]
                   ) // req.sample_rows
            X, y = X[sel], y[sel]
        # graftpack shape-bucket padding, driven by the JOURNALED
        # provenance alone (never by cohort membership or the server's
        # current pack setting): zero-weight cyclic-replica rows up to
        # the bucket's pow2 row count, provably inert (pack/padding.py)
        # — so near-miss shapes share one engine and launch geometry, and
        # a replayed request pads bit-identically
        weights = None
        if req.pad_rows > 0 and req.bucket_rows > X.shape[0]:
            X, y, weights = pad_to_bucket(X, y, rows=req.bucket_rows)

        # deadline budget anchored at the FIRST start attempt — wall
        # clock, because it must survive preemption and process
        # restarts (recovered from the journal's start records): a
        # resumed request spends its REMAINING budget, not a fresh one
        if rec.first_started_wall is None:
            rec.first_started_wall = time.time()
        elapsed0 = time.time() - rec.first_started_wall
        started_m = time.monotonic()

        def stop_hook() -> Optional[str]:
            if rec.cancel_event.is_set():
                return rec.cancel_reason or "cancelled"
            if self._preempt_requested():
                rec.cancel("preempted")
                return "preempted"
            if req.deadline_s is not None and (
                    elapsed0 + (time.monotonic() - started_m)
                    > req.deadline_s):
                rec.cancel("deadline")
                return "deadline"
            return None

        # run_id = request id: deterministic across restarts (the same
        # run directory resumes) AND attributable — every event in the
        # request's graftscope stream carries it, so concatenated
        # multi-tenant streams group correctly in `telemetry report`.
        ropt = RuntimeOptions(
            niterations=req.niterations, run_id=rid, seed=req.seed,
            verbosity=0, checkpoint_every_n=1, return_state=True,
            engine_cache=_RequestCacheView(self.cache, req.bucket),
            stop_hook=stop_hook,
            logger=_InjectorProbe(self, rec, cohort, slot), log_every_n=1,
            pulse_trace_on=bool(req.pulse_trace),
            # graftledger: the search runs under a child span of the
            # journaled request root — its hub stamps the same trace_id
            # on every event of the request's own graftscope stream
            trace=req.trace,
        )
        # Hang backstop: the soft deadline above stops at an iteration
        # boundary; a dispatch that never reaches one trips the
        # watchdog, which cancels the request and audits the hang (it
        # cannot interrupt a blocked CUDA call — docs/ROBUSTNESS.md).
        watchdog = None
        if req.deadline_s is not None:
            def on_hang(dump: str) -> None:
                rec.cancel("deadline")
                self.log.fault("request_hang", request_id=rid,
                               dump_head=dump[:500])
            watchdog = Watchdog(on_timeout=on_hang)
        try:
            self._cache_tls.request_id = rid
            import contextlib

            phase = (
                watchdog.phase(
                    "serve_request",
                    max(req.deadline_s - elapsed0, 0.0)
                    + self.hang_grace_s)
                if watchdog is not None else contextlib.nullcontext()
            )
            with phase:
                # resume="auto": first run finds nothing and starts
                # fresh; a journal-replayed run finds the request's
                # rolling checkpoints and continues bit-identically.
                state, hof = equation_search(
                    X, y, weights=weights, options=options,
                    resume="auto", runtime_options=ropt,
                    device=self.device,
                )
        except WatchdogTimeout:
            self._finish(rec, "cancelled", journal_event="cancel")
            return
        finally:
            self._cache_tls.request_id = None
            if watchdog is not None:
                watchdog.stop()

        iters = int(state.iterations_done)
        # a client cancel (or deadline) landing in the same window as a
        # preemption is STILL a terminal cancellation: the non-preempt
        # reason wins, else the requeue path below would resurrect the
        # request and a cancelled search would later complete as "done"
        user_stop = (rec.cancel_event.is_set()
                     and rec.cancel_reason not in (None, "preempted"))
        preempted = not user_stop and (
            rec.cancel_reason == "preempted" or self._preempt_requested())
        if (rec.cancel_event.is_set() and not preempted
                and iters < req.niterations):
            # any non-preempt cancel reason (including custom reasons
            # passed to cancel()) is a terminal cancellation — a
            # partial result must never be journaled as "done"
            self._finish(rec, "cancelled", journal_event="cancel")
            return
        if iters < req.niterations and preempted:
            # interrupted mid-flight: journal deliberately left at
            # "start". Re-queue IN PROCESS (keeping the admission slot
            # — the request never left the system) so a start() on this
            # same instance resumes it; a fresh server over the root
            # replays the journal instead.
            with self._cond:
                if rec.cancel_reason not in (None, "preempted"):
                    # a terminal cancel raced the requeue decision
                    # (e.g. client cancel during the preemption window)
                    # — it must not be wiped by the state reset below
                    terminal = True
                else:
                    terminal = False
                    rec.cancel_event.clear()
                    rec.cancel_reason = None
                    rec.resumed = True
                    rec.state = "queued"
                    self._qseq += 1
                    heapq.heappush(
                        self._queue, (req.priority, self._qseq, rid))
            if terminal:
                self._finish(rec, "cancelled", journal_event="cancel")
            else:
                self.log.serve("interrupted", rid, trace=req.trace,
                               iterations=iters)
            return
        hofs = hof if isinstance(hof, list) else [hof]
        result = {
            "fingerprint": result_fingerprint(state),
            "iterations": iters,
            "num_evals": float(state.num_evals),
            "equations": [
                {
                    "equation": e.equation_string(),
                    "loss": float(e.loss),
                    "complexity": int(e.complexity),
                }
                for h in hofs for e in h.pareto_frontier()
            ],
        }
        self._finish(rec, "done", result=result, journal_event="done")
