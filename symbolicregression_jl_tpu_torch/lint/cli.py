"""graftlint CLI: ``python -m symbolicregression_jl_tpu_torch.lint <paths>``
(port of ``lint/cli.py``).

Walks the given files/directories, runs every registered rule (see
:mod:`.rules`), prints findings as ``path:line:col: ID[name] message``,
and exits nonzero when anything is found. ``--list-rules`` prints the
rule catalog; ``--select GL001,GL003`` restricts the run.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Iterable, List, Optional, Sequence, Set

from .analyzer import Finding, ModuleAnalysis
from .rules import RULES, run_rules

# registers GL009-GL014 (the graftwarden concurrency rules) in RULES
from . import concurrency  # noqa: E402,F401  isort:skip

__all__ = ["lint_source", "lint_paths", "iter_py_files", "main"]

# The port's own tree, wherever the command runs from.
_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", "build"}


def iter_py_files(target: str) -> Iterable[str]:
    if os.path.isfile(target):
        if target.endswith(".py"):
            yield target
        return
    for dirpath, dirnames, filenames in os.walk(target):
        dirnames[:] = sorted(
            d for d in dirnames
            if d not in _SKIP_DIRS and not d.startswith(".")
        )
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def lint_source(
    source: str,
    path: str = "<string>",
    select: Optional[Set[str]] = None,
) -> List[Finding]:
    """Lint one source string. ``path`` drives directory-scoped rules
    (e.g. GL002 only fires for paths containing an ``evolve``/``ops``
    component) — tests pass synthetic paths like ``pkg/evolve/x.py``."""
    return run_rules(ModuleAnalysis(source, path), select=select)


def lint_paths(
    targets: Sequence[str],
    select: Optional[Set[str]] = None,
    on_error=None,
) -> List[Finding]:
    findings: List[Finding] = []
    for target in targets:
        for path in iter_py_files(target):
            try:
                with open(path, "r", encoding="utf-8") as f:
                    source = f.read()
                findings.extend(lint_source(source, path, select=select))
            except SyntaxError as e:
                findings.append(
                    Finding(
                        rule_id="GL000",
                        rule_name="parse-error",
                        path=path,
                        line=e.lineno or 1,
                        col=e.offset or 0,
                        message=f"could not parse: {e.msg}",
                    )
                )
            except (UnicodeDecodeError, ValueError) as e:
                # non-UTF-8 bytes, or ast.parse on source with null
                # bytes (ValueError, not SyntaxError) — report, continue
                findings.append(
                    Finding(
                        rule_id="GL000",
                        rule_name="parse-error",
                        path=path,
                        line=1,
                        col=0,
                        message=f"could not read/parse: {e}",
                    )
                )
            except OSError as e:
                if on_error is not None:
                    on_error(path, e)
    return findings


def _print_catalog(out) -> None:
    for r in RULES.values():
        scope = (
            f" [only: {', '.join(r.scope)}/]" if r.scope else ""
        )
        print(f"{r.id}  {r.name}{scope}", file=out)
        print(f"    {r.summary}", file=out)
        if r.rationale:
            print(f"    why: {r.rationale}", file=out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m symbolicregression_jl_tpu_torch.lint",
        description=(
            "graftlint — static analysis of the PyTorch/CUDA port's hazards "
            "(threefry key reuse, host RNG, host syncs in the hot loop, "
            "kernel builds in loops, in-place writes to saved tensors, "
            "debug hooks, signal handlers, lock discipline)."
        ),
    )
    parser.add_argument(
        "targets", nargs="*", default=[_PACKAGE_DIR],
        help="files or directories to lint (default: the package)",
    )
    parser.add_argument(
        "--select", default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        _print_catalog(sys.stdout)
        return 0

    select = None
    if args.select:
        select = {s.strip().upper() for s in args.select.split(",") if s.strip()}
        unknown = select - set(RULES)
        if unknown:
            print(
                f"unknown rule id(s): {', '.join(sorted(unknown))}",
                file=sys.stderr,
            )
            return 2

    findings = lint_paths(
        args.targets,
        select=select,
        on_error=lambda p, e: print(f"{p}: {e}", file=sys.stderr),
    )
    for f in findings:
        print(f)
    if findings:
        print(
            f"\ngraftlint: {len(findings)} finding(s). Suppress a "
            f"legitimate line with `# graftlint: disable=<RULE>`.",
            file=sys.stderr,
        )
        return 1
    return 0
