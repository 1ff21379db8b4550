"""The port's kernel-structure variants against the repo's JAX harness.

``profiling/kernel_variants.py`` (the TPU kernel's A/B harness, imported
from ``profiling/`` through ``sys.path``) runs ``loss_variant`` in interpret
mode once, at T = 16 trees of 4 steps over 256 rows of its bench problem;
``symbolicregression_jl_tpu_torch/profiling/kernel_variants.py`` is held to
it:

- the bench problem's data and ``synth_program``'s arrays bit-equal;
- every variant with a defined output (all but nostore, whose TPU kernel
  reads a scratch row it never wrote) in its plain version: validity
  bit-equal, the loss sums NaN and +-inf in the same places and otherwise
  within rtol 1e-5 (1e-2 for bf16, whose steps round to bf16 after
  float32 operations that may differ by an ULP between the two libraries);
- the exact variants' plain outputs bit-equal to base's;
- ``main`` printing every row with its check tag.

``csrc/program_variants.cu`` built for the host with the shim of
tests/test_torch_tile_host.py (skipped where g++ is missing) is held to the
plain versions, nostore too, by the same rules, and its exact variants and
tree blocks to base's bits, on ragged row counts and on fewer rows than a
block's lanes, with trees of 1 to 5 steps (an odd count runs the pair
unroll's padding step).
"""

import ctypes
import shutil
import sys
from pathlib import Path

import jax  # noqa: F401  (the JAX harness runs on the CPU here)
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parity import cap_torch_threads  # noqa: E402

import symbolicregression_jl_tpu_torch.profiling.kernel_variants as KV  # noqa: E402
from symbolicregression_jl_tpu_torch.profiling._common import make_bench_problem  # noqa: E402

cap_torch_threads()

ROOT = Path(__file__).resolve().parent.parent
T, STEPS, N_ROWS = 16, 4, 256
DEFINED = tuple(v for v in KV.VARIANTS if v != "nostore")
TOL = {"bf16": 1e-2}


def _bits(t):
    t = torch.as_tensor(np.array(t))
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _close(got, want, rtol):
    """(validity-independent) NaN and +-inf in the same places, the rest
    within ``rtol``; returns the worst relative error or None on a
    non-finite mismatch."""
    got, want = torch.as_tensor(np.array(got)), torch.as_tensor(np.array(want))
    if not (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isposinf(got), torch.isposinf(want))
            and torch.equal(torch.isneginf(got), torch.isneginf(want))):
        return None
    f = torch.isfinite(want)
    if not f.any():
        return 0.0
    return float(((got[f] - want[f]).abs() / want[f].abs().clamp(min=1e-30)).max())


def _same(a, b) -> bool:
    """Bit-equal, NaN in the same places (a NaN's sign is the host's)."""
    a, b = torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b))
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(_bits(a[~nan]), _bits(b[~nan]))


@pytest.fixture(scope="module")
def jax_run():
    sys.path.insert(0, str(ROOT / "profiling"))
    import kernel_variants as J

    options, ds, engine = J.make_bench_problem(n_rows=N_ROWS)
    X, y = ds.data.Xt, ds.data.y
    ops = engine.cfg.operators
    F = X.shape[0]
    n_codes = 1 + len(ops.binary) + len(ops.unary)
    prog = J.synth_program(T, STEPS, 30, F, 15, n_codes)
    outs = {}
    for v in DEFINED:
        loss, valid = J.loss_variant(prog, X, y, F, ops, options.elementwise_loss,
                                     tree_block=16 if v == "combo" else 8, variant=v,
                                     interpret=True)
        outs[v] = (np.asarray(loss), np.asarray(valid))
    return dict(J=J, X=np.asarray(X), y=np.asarray(y), n_codes=n_codes, outs=outs)


@pytest.fixture(scope="module")
def port():
    options, ds, engine = make_bench_problem(n_rows=N_ROWS, device="cpu")
    ops = engine.cfg.operators
    F = ds.data.Xt.shape[0]
    n_codes = 1 + len(ops.binary) + len(ops.unary)
    prog = KV.synth_program(T, STEPS, 30, F, 15, n_codes, device="cpu")
    outs = {v: KV.loss_variant(prog, ds.data.Xt, ds.data.y, F, ops, options.elementwise_loss,
                               variant=v, device="cpu") for v in KV.VARIANTS}
    return dict(options=options, ds=ds, ops=ops, outs=outs)


def test_bench_problem_and_operators_match_jax(jax_run, port):
    assert _same(port["ds"].data.Xt, jax_run["X"])
    assert _same(port["ds"].data.y, jax_run["y"])
    assert [o.name for o in port["ops"].binary] == list(KV.BENCH_BINARY)
    assert [o.name for o in port["ops"].unary] == list(KV.BENCH_UNARY)


@pytest.mark.parametrize("seed", [0, 7])
def test_synth_program_bit_equal(jax_run, seed):
    J = jax_run["J"]
    want = J.synth_program(64, 8, 30, 5, 15, jax_run["n_codes"], seed=seed)
    got = KV.synth_program(64, 8, 30, 5, 15, jax_run["n_codes"], seed=seed, device="cpu")
    for name in ("code", "src1", "src2", "nsteps", "cvals", "cslot", "nconst", "const_ok"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, name
        assert np.array_equal(w.view(np.int32) if w.dtype == np.float32 else w,
                              g.view(np.int32) if g.dtype == np.float32 else g), name


@pytest.mark.parametrize("variant", DEFINED)
def test_plain_matches_jax(jax_run, port, variant):
    loss_j, valid_j = jax_run["outs"][variant]
    loss_p, valid_p = port["outs"][variant]
    assert valid_p.dtype == torch.int32
    assert np.array_equal(valid_p.numpy(), valid_j)
    rel = _close(loss_p, loss_j, TOL.get(variant, 1e-5))
    assert rel is not None and rel <= TOL.get(variant, 1e-5), (variant, rel)


@pytest.mark.parametrize("variant", KV.EXACT)
def test_exact_plain_bit_equal_to_base(port, variant):
    for got, want in zip(port["outs"][variant], port["outs"]["base"]):
        assert _same(got, want)


def test_nostore_plain_reads_zero_rows(port):
    """nostore's root row of a tree of more than one step is never written:
    the kernel zero-fills it, so the loss is sum(y^2)."""
    y = port["ds"].data.y
    loss, _ = port["outs"]["nostore"]
    assert torch.allclose(loss, torch.full_like(loss, float(torch.sum(y * y))), rtol=1e-5)


def test_variants_refuse_other_operator_sets(port):
    from symbolicregression_jl_tpu_torch import Options

    ds = port["ds"]
    ops = Options(binary_operators=["*", "+"], unary_operators=["cos"]).operators
    prog = KV.synth_program(2, 2, 30, 5, 15, 4, device="cpu")
    for variant in ("signmerge", "muldiv", "opgroup", "combo", "noswitch", "static", "nostore"):
        with pytest.raises(ValueError, match="operator"):
            KV.loss_variant(prog, ds.data.Xt, ds.data.y, 5, ops, port["options"].elementwise_loss,
                            variant=variant, device="cpu")
    with pytest.raises(ValueError, match="unknown variant"):
        KV.loss_variant(prog, ds.data.Xt, ds.data.y, 5, ops, port["options"].elementwise_loss,
                        variant="fast", device="cpu")


def test_main_prints_every_row(monkeypatch, capsys):
    monkeypatch.setenv("STEPS", str(STEPS))
    assert KV.main([str(T), *KV.ROWS, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"T={T} steps: mean 4.00 max 4")
    rows = {line.split()[0]: line for line in lines[1:]}
    assert set(rows) == set(KV.ROWS)
    for row, line in rows.items():
        assert "ms/launch" in line and "trees/s" in line and "ns/step" in line
        assert "bound" in line and line.endswith("[cpu: the plain versions on the host, no card]")
        if row in KV.EXACT or row.startswith("tb"):
            assert "  loss==base  " in line, line
        elif row in KV.APPROX:
            assert "  loss~=base@1e-3  " in line, line


# ---------------------------------------------------------------------------
# The kernel, built for the host
# ---------------------------------------------------------------------------

HOST_T = 40
HOST_STEPS = 5
HOST_ROWS = (301, 37)           # ragged; fewer rows than the block's 256 lanes
HOST_RUNS = tuple((v, 8) for v in KV.VARIANTS) + (("base", 16), ("base", 32), ("combo", 16))


@pytest.fixture(scope="module")
def host_runs(tmp_path_factory):
    """{(variant, tree block, rows): (loss, valid)} of the host-built kernel,
    and the plain versions' by (variant, rows)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    from test_torch_tile_host import CSRC, build_host_library

    lib = KV.bind(ctypes.CDLL(str(build_host_library(
        CSRC / "program_variants.cu", tmp_path_factory.mktemp("variants")))))
    assert lib.sr_program_variants_lanes(30, 15, 5) == 256
    kernel, plain, data = {}, {}, {}
    for n in HOST_ROWS:
        options, ds, engine = make_bench_problem(n_rows=n, device="cpu")
        ops = engine.cfg.operators
        prog = KV.synth_program(HOST_T, HOST_STEPS, 30, 5, 15, 8, seed=3, device="cpu")
        prog.nsteps = 1 + torch.arange(HOST_T, dtype=torch.int32) % HOST_STEPS
        X, y = ds.data.Xt, ds.data.y
        for variant, tb in HOST_RUNS:
            optab = torch.tensor(KV.op_table(ops, variant), dtype=torch.int32)
            args, loss, valid, held = KV.launch_args(prog, X, y, 5, ops, tb, variant, optab)
            assert lib.sr_program_variants(*args, None) == 0
            kernel[variant, tb, n] = (loss, valid)
            del held
        for variant in KV.VARIANTS:
            plain[variant, n] = KV.loss_variant_plain(prog, X, y, 5, ops,
                                                      options.elementwise_loss, variant=variant)
        data[n] = y
    return kernel, plain, data


@pytest.mark.parametrize("n", HOST_ROWS)
@pytest.mark.parametrize("variant", KV.VARIANTS)
def test_host_kernel_matches_plain(host_runs, variant, n):
    kernel, plain, _ = host_runs
    loss_k, valid_k = kernel[variant, 8, n]
    loss_p, valid_p = plain[variant, n]
    assert torch.equal(valid_k, valid_p), (valid_k, valid_p)
    assert 0 < int(valid_k.sum()), "no valid tree: the comparison would be empty"
    rel = _close(loss_k, loss_p, TOL.get(variant, 1e-5))
    assert rel is not None and rel <= TOL.get(variant, 1e-5), (variant, rel)


@pytest.mark.parametrize("n", HOST_ROWS)
@pytest.mark.parametrize("run", [(v, 8) for v in KV.EXACT] + [("base", 16), ("base", 32)],
                         ids=lambda r: f"{r[0]}-tb{r[1]}")
def test_host_exact_variants_bit_equal_to_base(host_runs, run, n):
    kernel, _, _ = host_runs
    for got, want in zip(kernel[(*run, n)], kernel["base", 8, n]):
        assert _same(got, want), run


@pytest.mark.parametrize("n", HOST_ROWS)
def test_host_approx_variants_within_1e3_of_base(host_runs, n):
    kernel, _, _ = host_runs
    for variant in KV.APPROX:
        loss, valid = kernel[variant, 8, n]
        base_loss, base_valid = kernel["base", 8, n]
        assert torch.equal(valid, base_valid)
        rel = _close(loss, base_loss, 1e-3)
        assert rel is not None and rel <= 1e-3, (variant, rel)
