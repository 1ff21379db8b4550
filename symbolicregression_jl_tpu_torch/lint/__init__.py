"""graftlint for the PyTorch/CUDA port: static analysis of the port's own
hazards, and runtime invariant auditing (port of the JAX package's
``lint/``).

Static side (pure-Python AST, no torch import needed):

- :data:`~.rules.RULES`: GL001-GL008, the port's single-module hazards
  (threefry key reuse, host RNG, host syncs in the per-cycle hot loop,
  kernel builds in loops, in-place writes to saved tensors, debug hooks,
  signal handlers, and GL008 ``collective-hazard``: a ``torch.distributed``
  collective under a rank-dependent branch, or a host sync between one
  iteration's collectives, in ``mesh/`` and ``parallel/``), and the
  graftwarden concurrency rules GL009-GL014
  (:mod:`.concurrency`, checked against the lock-order manifest of
  :mod:`.lock_order`);
- :func:`~.cli.lint_source` / :func:`~.cli.lint_paths`;
- ``python -m symbolicregression_jl_tpu_torch.lint [paths]``: the CLI,
  the port's tree by default; exits non-zero on findings.

Runtime side:

- :func:`~.runtime.validate_programs`: postfix program-table invariants
  (``Options(debug_checks=True)`` runs it on the engine's state);
- :func:`~.runtime.compile_count_guard`: no kernel builds or loads in a
  region;
- :func:`~.runtime.no_transfer`: no host syncs in a region;
- :mod:`.racecheck`: instrumented locks that assert the manifest at run
  time, and deterministic race replays (``SR_RACE_PLAN``).
"""

from .analyzer import Finding, ModuleAnalysis
from .cli import lint_paths, lint_source, main
from .lock_order import BLESSED_EDGES, check_manifest_acyclic
from .rules import RULES, Rule, rule

__all__ = [
    "BLESSED_EDGES",
    "Finding",
    "ModuleAnalysis",
    "RULES",
    "Rule",
    "rule",
    "check_manifest_acyclic",
    "lint_paths",
    "lint_source",
    "main",
]
