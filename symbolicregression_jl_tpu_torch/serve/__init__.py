"""graftserve — crash-safe, multi-tenant persistent search service (port
of the JAX package's ``serve/`` on one CUDA device).

Public surface::

    from symbolicregression_jl_tpu_torch.serve import SearchServer, ServerSaturated

    server = SearchServer("/var/sr/root", capacity=8).start()   # device="cuda"
    rid = server.submit(X, y, options={"maxsize": 12}, niterations=8,
                        seed=7)
    status = server.poll(rid)        # queued/running/done/... + result
    server.cancel(rid)               # honored at iteration boundary
    server.stop(drain=True)

Kill the process at any point; a new ``SearchServer`` over the same
root replays the journal and finishes every accepted request with
results bit-identical to an unkilled run. Full design note:
docs/SERVING.md.
"""

from .admission import (
    AdmissionController,
    AdmissionDecision,
    ServerSaturated,
    shape_bucket,
)
from .cache import ExecutableCache
from .journal import JournalCorruptError, RequestJournal
from .server import SearchRequest, SearchServer, result_fingerprint
from .telemetry import ServeLog

__all__ = [
    "SearchServer",
    "SearchRequest",
    "ServerSaturated",
    "AdmissionController",
    "AdmissionDecision",
    "shape_bucket",
    "ExecutableCache",
    "RequestJournal",
    "JournalCorruptError",
    "ServeLog",
    "result_fingerprint",
]
