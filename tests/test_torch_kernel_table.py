"""Every TPU kernel of the repo has its CUDA counterpart in the port.

Reads every ``.py`` file outside ``symbolicregression_jl_tpu_torch/`` and
``tests/`` (and outside the directories ``.gitignore`` lists) with ``ast``
and finds each *call* of ``pallas_call`` (``pl.pallas_call(...)``,
``pallas_call(...)``; a name in a string or a docstring is no call). Each
site is keyed by (file, enclosing top-level function) and must have a row
in ``KERNELS``, which names its CUDA source under the port's ``csrc/`` and
one ``extern "C"`` function that the source's text defines. A row whose
site is gone is stale and fails too.
"""

import ast
import functools
import os
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "symbolicregression_jl_tpu_torch" / "csrc"
SKIP = {"symbolicregression_jl_tpu_torch", "tests"}

# (file, top-level function of the pallas_call) -> (CUDA source, extern "C" entry)
KERNELS = {
    ("symbolicregression_jl_tpu/ops/fused_eval.py", "_program_launch"):
        ("program_eval.cu", "sr_program_eval"),
    ("symbolicregression_jl_tpu/ops/fused_eval.py", "fused_loss_multi"):
        ("program_multi.cu", "sr_program_multi"),
    ("symbolicregression_jl_tpu/ops/fused_eval.py", "fused_grad_multi"):
        ("program_grad.cu", "sr_program_grad"),
    ("symbolicregression_jl_tpu/ops/fused_eval.py", "fused_predict_program"):
        ("program_predict.cu", "sr_program_predict"),
    ("symbolicregression_jl_tpu/ops/fused_eval.py", "_fused_predict_vjp_program"):
        ("program_predict_vjp.cu", "sr_program_predict_vjp"),
    ("profiling/kernel_variants.py", "loss_variant"):
        ("program_variants.cu", "sr_program_variants"),
}


def _ignored_dirs():
    """Directory names .gitignore lists (``name/`` lines)."""
    path = ROOT / ".gitignore"
    lines = path.read_text().splitlines() if path.exists() else []
    return {ln.strip().strip("/") for ln in lines
            if ln.strip().endswith("/") and not ln.startswith("#")}


def _is_pallas_call(node) -> bool:
    fn = node.func
    return ((isinstance(fn, ast.Attribute) and fn.attr == "pallas_call")
            or (isinstance(fn, ast.Name) and fn.id == "pallas_call"))


@functools.lru_cache(maxsize=None)
def pallas_sites():
    """{(file, top-level function or "<module>"): [line, ...]} of every
    pallas_call in the repo outside the port and the tests."""
    skip = SKIP | _ignored_dirs()
    sites = {}
    for dirpath, dirs, files in os.walk(ROOT):
        rel = Path(dirpath).relative_to(ROOT)
        dirs[:] = sorted(d for d in dirs if not d.startswith(".") and d not in skip)
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = Path(dirpath) / name
            tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
            for top in tree.body:
                owner = getattr(top, "name", "<module>")
                for node in ast.walk(top):
                    if isinstance(node, ast.Call) and _is_pallas_call(node):
                        key = ((rel / name).as_posix(), owner)
                        sites.setdefault(key, []).append(node.lineno)
    return sites


def test_every_pallas_call_site_has_a_cuda_counterpart():
    sites = pallas_sites()
    missing = sorted(set(sites) - set(KERNELS))
    assert not missing, f"TPU kernels without a CUDA counterpart: {missing}"


def test_no_row_is_stale():
    stale = sorted(set(KERNELS) - set(pallas_sites()))
    assert not stale, f"rows whose pallas_call site is gone: {stale}"


def test_the_scan_finds_the_six_sites():
    sites = pallas_sites()
    assert len(sites) == 6 and sum(len(v) for v in sites.values()) == 6, sites
    assert ("profiling/kernel_variants.py", "loss_variant") in sites


def test_each_counterpart_defines_its_entry():
    for site, (source, entry) in KERNELS.items():
        text = (CSRC / source).read_text()
        assert re.search(r'extern "C"[^;{]*\b' + re.escape(entry) + r"\s*\(", text), (site, entry)


def test_a_string_or_docstring_is_no_site():
    """The scan counts calls only: the JAX package names pallas_call in
    comments, docstrings and tables that are no kernel."""
    code = ('"""pl.pallas_call in a docstring."""\n'
            'NAMES = ("pl.pallas_call", "pallas_call")\n'
            'def f():\n    return pl.pallas_call(k)(x)\n')
    tree = ast.parse(code)
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and _is_pallas_call(n)]
    assert [c.lineno for c in calls] == [4]
