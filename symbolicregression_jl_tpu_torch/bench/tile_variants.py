"""Kernels #2 and #3 built with other blockings, timed on one GPU.

    python -m symbolicregression_jl_tpu_torch.bench.tile_variants [NAME=MACROS ...]

Each argument names a variant and its ``-D`` macros, comma-separated
(``m_v4=SR_MULTI_VR=4``, ``g_r1=SR_GRAD_ROWS=1,SR_GRAD_MIN_BLOCKS=4``): a
variant of SR_MULTI_* macros builds ``csrc/program_multi.cu``, one of
SR_GRAD_* ``csrc/program_grad.cu`` (the macros of their blocking). Without
arguments it runs VARIANTS. Every build (nvcc with the port's flags, the
default build of each source too, all started together, into
``build/variants/``) prints its seconds and ptxas's registers and spills
of the float kernels. Then each variant runs ``chip_smoke.py`` phase 4's
inputs (#2: V = 24 over 18,432 trees of 3 steps; #3: V = 3 over them and
over the mixed-step trees; each also over their first 50 rows, a
minibatch; #3 also in its float64 form) and the calls of one real
iteration (the optimizer cell at 10 cycles after a warm-up one, its 8 calls
of #2 and 9 of #3 recorded, each call's inputs kept; timed as their sum) in
turns with its source's default
build (default, variant, variant, default; CUDA events, mean of 5), and
its outputs must be the default's bit for bit. Prints the card's name and power limit first;
exits 1 when a variant's bits differ. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import subprocess
import sys
import time

VARIANTS = {
    "m_r4v4": "SR_MULTI_ROWS=4,SR_MULTI_VR=4,SR_MULTI_MIN_BLOCKS=8",
    "m_v4": "SR_MULTI_VR=4",
    "m_b3": "SR_MULTI_MIN_BLOCKS=3",
    "g_r1": "SR_GRAD_ROWS=1",
    "g_r1b2": "SR_GRAD_ROWS=1,SR_GRAD_MIN_BLOCKS=2",
    "g_b3": "SR_GRAD_MIN_BLOCKS=3",
    "g_b5": "SR_GRAD_MIN_BLOCKS=5",
}

_ROOT = pathlib.Path(__file__).resolve().parents[2]


def _source(macros: str) -> str:
    return "program_multi.cu" if macros.startswith("SR_MULTI") else "program_grad.cu"


def build(variants: dict) -> dict:
    """{name: (library path, seconds, ptxas lines)} of each variant and of
    each source's default build ("default program_multi.cu", ...)."""
    from symbolicregression_jl_tpu_torch.ops import cuda_build

    out_dir = _ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {f"default {s}": (s, []) for s in sorted({_source(m) for m in variants.values()})}
    for name, macros in variants.items():
        jobs[name] = (_source(macros), [f"-D{m}" for m in macros.split(",") if m])
    running = {}
    for name, (src, flags) in jobs.items():
        tag = hashlib.sha256(f"{name} {src} {flags}".encode()).hexdigest()[:12]
        so = out_dir / f"{pathlib.Path(src).stem}-{tag}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", str(so),
               str(cuda_build.source_path(src))]
        running[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                              text=True), time.perf_counter())
    built = {}
    for name, (so, proc, t0) in running.items():
        _, err = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err[-8000:]}")
        built[name] = (so, secs, err)
    return built


def bind(kernel_type, so: pathlib.Path):
    """A fresh wrapper of ``kernel_type`` whose library is ``so``."""
    k = kernel_type()
    lib = ctypes.CDLL(str(so))
    k._smem_fn(lib).argtypes = [ctypes.c_int] * k._smem_nargs
    k._smem_fn(lib).restype = ctypes.c_size_t
    getattr(lib, k._entry).restype = ctypes.c_int
    k._bind(lib)
    k._libs[None] = lib
    return k


def real_calls(torch, sr, C, dev):
    """{"#2": [args], "#3": [args]}: the arguments of every call of kernels
    #2 and #3 in one 10-cycle iteration of the optimizer cell, after a
    warm-up iteration."""
    from symbolicregression_jl_tpu_torch.evolve import rng
    from symbolicregression_jl_tpu_torch.evolve.engine import Engine
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    options = C.bench_options(sr, 10)
    X, y = C.bench_data()
    ds = sr.make_dataset(X, y, device=dev)
    ds.update_baseline_loss(options.elementwise_loss)
    engine = Engine(options, X.shape[1], device=dev)
    state = engine.init_state(rng.key(0, device=dev), ds.data, options.populations)
    state = engine.run_iteration(state, ds.data, options.maxsize)
    calls = {"#2": [], "#3": []}
    originals = {k: k.__call__ for k in (FE.ProgramMultiKernel, FE.ProgramGradKernel)}

    def recording(label, orig):
        def call(self, *a, **kw):
            calls[label].append((a, kw))
            return orig(self, *a, **kw)
        return call

    FE.ProgramMultiKernel.__call__ = recording("#2", originals[FE.ProgramMultiKernel])
    FE.ProgramGradKernel.__call__ = recording("#3", originals[FE.ProgramGradKernel])
    try:
        engine.run_iteration(state, ds.data, options.maxsize)
        torch.cuda.synchronize()
    finally:
        for k, orig in originals.items():
            k.__call__ = orig
    return calls


def main(argv=None) -> int:
    import torch

    sys.path.insert(0, str(_ROOT))
    import chip_smoke as C
    import symbolicregression_jl_tpu_torch as sr
    from symbolicregression_jl_tpu_torch.ops import fused_eval as FE

    args = sys.argv[1:] if argv is None else argv
    variants = dict(a.split("=", 1) for a in args) if args else VARIANTS
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    built = build(variants)
    for name, (so, secs, log) in built.items():
        kname = "program_multi_kernel" if "multi" in so.name else "program_grad_kernel"
        rows = [r for r in C.ptxas_report(log, kname) if "double" not in r[0]]
        print(f"{name}: nvcc {secs:.1f} s; " + "; ".join(
            f"{r[0]} {r[1]} registers, stack {r[2]} B, spills {r[3]}/{r[4]} B" for r in rows))

    dev = torch.device("cuda")
    (options, _, _, (instr, nsteps, cvals, _, Xt, yt, w), nconst, R, V_ls, cv_ls,
     cv_g) = C.opt_kernel_inputs(torch, sr, dev)
    ops, el = options.operators, options.elementwise_loss
    margs, mops, mel = C.mixed_grad_inputs(torch, sr, dev)
    rows50 = (Xt[:, :50].contiguous(), yt[:50].contiguous(), w[:50].contiguous())
    real = real_calls(torch, sr, C, dev)

    def all_calls(label):
        """Every recorded call of one kernel, its outputs concatenated."""
        return lambda k: [t.flatten() for a, kw in real[label] for t in k(*a, **kw)]

    f64 = lambda args: tuple(t.double().contiguous() if t.is_floating_point() else t
                             for t in args)
    gargs64, margs64 = f64((instr, nsteps, nconst, cv_g, Xt, yt, w)), f64(margs)
    M, G, G64 = FE.ProgramMultiKernel, FE.ProgramGradKernel, FE.ProgramGradF64Kernel
    cases = {
        "program_multi.cu": [
            ("#2", M, lambda k: k(instr, nsteps, cv_ls, Xt, yt, w, ops, el)),
            ("#2 50 rows", M, lambda k: k(instr, nsteps, cv_ls, *rows50, ops, el)),
            (f"#2 real iteration ({len(real['#2'])} calls)", M, all_calls("#2"))],
        "program_grad.cu": [
            ("#3", G, lambda k: k(instr, nsteps, nconst, cv_g, Xt, yt, w, ops, el)),
            ("#3 mixed steps", G, lambda k: k(*margs, mops, mel)),
            ("#3 50 rows", G, lambda k: k(instr, nsteps, nconst, cv_g, *rows50, ops, el)),
            (f"#3 real iteration ({len(real['#3'])} calls)", G, all_calls("#3")),
            ("#3 f64", G64, lambda k: k(*gargs64, ops, el)),
            ("#3 f64 mixed steps", G64, lambda k: k(*margs64, mops, mel))],
    }
    bad = 0
    for name, macros in variants.items():
        src = _source(macros)
        for label, ktype, run in cases[src]:
            base = bind(ktype, built[f"default {src}"][0])
            var = bind(ktype, built[name][0])
            same = C.digest(*run(base)) == C.digest(*run(var))
            bad += not same
            times = [C.cuda_ms(torch, lambda k=k: run(k), reps=5) for k in (base, var, var, base)]
            print(f"{name} ({macros}) {label}: default {times[0]:.4f} / {times[3]:.4f} ms, "
                  f"variant {times[1]:.4f} / {times[2]:.4f} ms, default / variant "
                  f"{(times[0] + times[3]) / (times[1] + times[2]):.3f}; bits "
                  f"{'equal' if same else 'DIFFERENT'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
