"""Kernels #2 and #3's vector-blocked interpreter built for the host CPU.

csrc/interp.cuh's run_vec carries several constant vectors of a tree
through each step (#2: 8, #3: 3). Built with g++ through the shim of
tests/test_torch_tile_host.py, each vector's outputs must be the bits of
a launch with that vector alone, in float32 and in the float64 forms: with
V not a multiple of the vectors a thread carries, trees that read no
constant among the others (one pass, every vector the same loss and
validity, a zero gradient) and a step-count class with no tree; #3's loss
bit-equal to #2's.
A file of its own, so that the test run's workers take it beside the other
host kernels' file. Skips where g++ is missing.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import pytest
import torch

from symbolicregression_jl_tpu_torch.core import losses as SL

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_tile_host import (CONST_FREE, CSRC, _same, grad_case,  # noqa: E402
                                  load_host_libraries, run_grad, run_multi)

VECTOR_CASES = ("V5_step_classes_W64", "V7_W32", "const_free_W64_V24", "empty_class_W64_V3",
                "W64_V24", "step_classes_W64_V3")


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA sources for the host")
    return load_host_libraries(CSRC, tmp_path_factory.mktemp("tile_host_vector"))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", VECTOR_CASES)
def test_vector_blocking_on_host(host_libs, case, dtype):
    ops, loss_fn, args, W = grad_case(case, SL.l2_dist_loss)
    instr, nsteps, nconst, cv, X, y, w = args
    if dtype == "float64":
        cv, X, y, w = (t.double().contiguous() for t in (cv, X, y, w))
    lib2, lib3 = host_libs["program_multi.cu"], host_libs["program_grad.cu"]
    ml, mv = run_multi(lib2, ops, loss_fn, instr, nsteps, cv, X, y, w, W)
    gl, gv, gg = run_grad(lib3, ops, loss_fn, instr, nsteps, nconst, cv, X, y, w, W)
    assert _same(gl, ml) and _same(gv, mv), "#3's loss differs from #2's"
    V = cv.shape[1]
    for v in range(V):
        one = cv[:, v:v + 1].contiguous()
        l1, v1 = run_multi(lib2, ops, loss_fn, instr, nsteps, one, X, y, w, W)
        g1 = run_grad(lib3, ops, loss_fn, instr, nsteps, nconst, one, X, y, w, W)
        assert _same(ml[:, v:v + 1], l1) and _same(mv[:, v:v + 1], v1), f"#2 vector {v}"
        assert all(_same(a, b) for a, b in zip((gl[:, v:v + 1], gv[:, v:v + 1],
                                               gg[:, v:v + 1]), g1)), f"#3 vector {v}"
    free = nconst == 0
    if case == "const_free_W64_V24":
        assert int(free.sum()) >= len(CONST_FREE)
    if bool(free.any()):
        assert _same(ml[free], ml[free][:, :1].expand(-1, V))
        assert _same(gv[free], gv[free][:, :1].expand(-1, V))
        assert bool((gg[free] == 0).all())
    m = nsteps.clamp(max=instr.shape[1])
    if case == "empty_class_W64_V3":
        assert not bool(((m > 4) & (m <= 12)).any()) and bool((m > 12).any())
