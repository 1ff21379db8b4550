"""graftbench CLI: ``python -m symbolicregression_jl_tpu_torch.bench <cmd>``
(port of ``bench/__main__.py``).

Commands:

- ``run``   — run the benchmark matrix (``--full`` for the chip-sized
  shapes) and write the ``graftbench.result.v1`` JSON (``--out``).
- ``gate``  — run a fresh matrix (or read ``--result``) and diff it
  against the committed baseline (``benchmarks/baseline.json``); exits
  nonzero on a regression beyond band.
- ``trend`` — fold result files and headline lines, the ones named and
  the ``*.json`` of the directories named, into one trajectory report.
- ``load``  — the serve-level submit/poll storm (bench/load.py's CLI).
- ``_cell`` — internal: one matrix cell in a clean subprocess.

Cells run on CUDA unless ``--device cpu``; the island-sharded cells on
their own gloo ranks. ``run --baseline-out PATH`` pins the run(s) as a
baseline with bands calibrated from ``--repeats`` (at least 2 for real
bands); it writes only the path named, never over the committed
``benchmarks/baseline.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


# The JAX package's committed baseline: the port gates against it and never
# writes it.
COMMITTED_BASELINE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "benchmarks", "baseline.json")


def _write_json(path: Optional[str], payload: dict, log=print) -> None:
    if not path:
        return
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    log(f"wrote {path}")


def _add_matrix_args(p: argparse.ArgumentParser) -> None:
    from .cell import VARIANTS
    from .matrix import DEFAULT_SEEDS, PORT_VARIANTS

    p.add_argument("--full", action="store_true",
                   help="chip-sized shapes (default: the mini matrix)")
    p.add_argument("--variants", nargs="+", default=list(PORT_VARIANTS),
                   choices=list(VARIANTS), metavar="VARIANT")
    p.add_argument("--seeds", nargs="+", type=int, default=list(DEFAULT_SEEDS))
    p.add_argument("--workdir", default=None,
                   help="scratch dir for cell runs/telemetry (default $TMPDIR/graftbench)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")


def _matrix(args) -> dict:
    from .matrix import run_matrix

    return run_matrix(matrix="full" if args.full else "mini", variants=args.variants,
                      seeds=args.seeds, workdir=args.workdir, device=args.device)


def cmd_run(args) -> int:
    if args.baseline_out and (os.path.realpath(args.baseline_out)
                              == os.path.realpath(COMMITTED_BASELINE)):
        print(f"refusing to write over the committed {COMMITTED_BASELINE}; name another path",
              file=sys.stderr)
        return 2
    results = []
    for rep in range(max(args.repeats, 1)):
        print(f"matrix run {rep + 1}/{args.repeats} ({'full' if args.full else 'mini'}):")
        results.append(_matrix(args))
    _write_json(args.out, results[-1])
    # failures of ANY repeat fail the run
    failed_cells = sorted({cid for r in results for cid in r["failures"]})
    if args.baseline_out:
        if failed_cells:
            print(f"refusing to pin a baseline: cell(s) failed in at least one repeat: "
                  f"{', '.join(failed_cells)}", file=sys.stderr)
        else:
            from .gate import calibrate_bands, make_baseline

            try:
                baseline = make_baseline(results, calibrate_bands(results))
            except ValueError as e:
                print(str(e), file=sys.stderr)
                return 1
            _write_json(args.baseline_out, baseline)
    if failed_cells:
        print(f"{len(failed_cells)} cell(s) failed across {len(results)} repeat(s)",
              file=sys.stderr)
        return 1
    return 0


def cmd_gate(args) -> int:
    from .gate import diff_result, format_findings, gate_failed, load_baseline
    from .matrix import DEFAULT_SEEDS, PORT_VARIANTS, matrix_cells

    try:
        baseline = load_baseline(args.baseline)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"gate: cannot load baseline: {e}", file=sys.stderr)
        return 2
    # A sliced gate diffs only what was asked.
    requested = [cid for cid, _, _ in matrix_cells(args.variants, args.seeds)]
    cells_filter = [cid for cid in requested if cid in baseline.get("cells", {})]
    if not cells_filter:
        print(f"gate: requested slice {requested} matches no baseline cell — nothing to gate",
              file=sys.stderr)
        return 2
    if (tuple(args.variants) != PORT_VARIANTS or tuple(args.seeds) != DEFAULT_SEEDS):
        print(f"gate: PARTIAL — diffing {len(cells_filter)} of "
              f"{len(baseline.get('cells', {}))} baseline cells")
    if args.result:
        with open(args.result) as f:
            result = json.load(f)
    else:
        matrix = "full" if args.full else "mini"
        if matrix != baseline.get("matrix"):
            print(f"gate: baseline is a {baseline.get('matrix')!r} matrix; pass the "
                  f"matching flags", file=sys.stderr)
            return 2
        print(f"gate: running a fresh {matrix} matrix against {args.baseline}")
        result = _matrix(args)
    findings = diff_result(result, baseline, cells_filter=cells_filter)
    payload = dict(result)
    payload["gate"] = {
        "baseline": args.baseline,
        "findings": [f.to_dict() for f in findings],
        "failed": gate_failed(findings),
    }
    _write_json(args.out, payload)
    print(format_findings(findings))
    return 1 if gate_failed(findings) else 0


def cmd_trend(args) -> int:
    from .trend import build_trend, format_trend

    trend = build_trend(args.paths)
    if args.json:
        print(json.dumps(trend))
    else:
        print(format_trend(trend))
    return 1 if (args.strict and trend["red_count"]) else 0


def cmd_load(args) -> int:
    """The ``load`` subcommand: ``args`` is its argument list, which
    bench/load.py parses (``--packed``, ``--compare``, ...; its --help)."""
    from .load import main as load_main

    return load_main(list(args))


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["load"]:
        return cmd_load(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m symbolicregression_jl_tpu_torch.bench",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run the benchmark matrix")
    _add_matrix_args(p)
    p.add_argument("--repeats", type=int, default=1, help="repeat the matrix N times")
    p.add_argument("--out", default=None, help="result JSON path")
    p.add_argument("--baseline-out", default=None,
                   help="pin the run(s) as a new baseline at this path (never over "
                        "benchmarks/baseline.json)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("gate", help="diff a fresh matrix (or --result) against the baseline")
    _add_matrix_args(p)
    p.add_argument("--baseline", default="benchmarks/baseline.json")
    p.add_argument("--result", default=None,
                   help="gate a result file instead of running the matrix")
    p.add_argument("--out", default=None, help="write result + findings JSON here")
    p.set_defaults(fn=cmd_gate)

    sub.add_parser("load", help="serve submit/poll storm (bench/load.py; see its --help)")

    p = sub.add_parser("trend", help="benchmark trajectory report")
    p.add_argument("paths", nargs="+",
                   help="result/headline JSON files, or directories of them")
    p.add_argument("--json", action="store_true")
    p.add_argument("--strict", action="store_true",
                   help="exit nonzero when any red artifact exists")
    p.set_defaults(fn=cmd_trend)

    p = sub.add_parser("_cell")  # internal subprocess entry
    p.add_argument("spec")
    p.set_defaults(fn=None)

    args = ap.parse_args(argv)
    if args.cmd == "_cell":
        from .cell import cell_main

        return cell_main(args.spec)
    try:
        return args.fn(args)
    except NotImplementedError as e:
        print(f"{args.cmd}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
