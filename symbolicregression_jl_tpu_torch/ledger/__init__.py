"""graftledger — per-tenant cost attribution and causal tracing (port of
the JAX package's ``ledger/``).

Three pieces (docs/OBSERVABILITY.md, "Cost attribution & tracing"):

- :mod:`.context` — deterministic ``TraceContext`` ids minted at
  ``SearchServer.submit()`` (journaled) or from a plain search's
  run_id, stamped by the telemetry hub onto every graftscope.v2 event;
- :mod:`.ledger` — the ``CostLedger`` hub sink folding device/host/
  compile seconds, host-phase spans, evals, and checkpoint bytes into
  per-request ``graftledger.v1`` accounts with a deterministic/wall
  split, plus :mod:`.rollup`'s server-level per-tenant view;
- :mod:`.timeline` — the unified Chrome-trace (Perfetto) exporter
  behind ``python -m symbolicregression_jl_tpu_torch.telemetry timeline``.
"""

from .context import TraceContext, mint_run_trace, mint_trace
from .ledger import (
    LATENCY_BUCKETS_S,
    LEDGER_SCHEMA,
    CostLedger,
    fold_accounts,
    ledger_fingerprint,
    load_accounts,
    validate_account,
)
from .rollup import (
    ROLLUP_NAME,
    ROLLUP_SCHEMA,
    build_rollup,
    load_rollup,
    request_ledger_paths,
    write_rollup,
)
from .timeline import build_timeline, validate_chrome_trace, write_timeline

__all__ = [
    "TraceContext",
    "mint_trace",
    "mint_run_trace",
    "LEDGER_SCHEMA",
    "LATENCY_BUCKETS_S",
    "CostLedger",
    "validate_account",
    "load_accounts",
    "fold_accounts",
    "ledger_fingerprint",
    "ROLLUP_SCHEMA",
    "ROLLUP_NAME",
    "build_rollup",
    "write_rollup",
    "load_rollup",
    "request_ledger_paths",
    "build_timeline",
    "write_timeline",
    "validate_chrome_trace",
]
