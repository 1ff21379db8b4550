"""The port's CUDA kernels #1-#5 compiled for the host CPU.

The CUDA sources under ``symbolicregression_jl_tpu_torch/csrc/`` build
only with nvcc for the card. This file builds all five with g++
through a small shim instead: each CUDA thread of a block runs as a fiber
of the launching thread on x86-64 (a ``std::thread`` elsewhere), in
thread order up to the next barrier; ``__syncthreads`` and
``__syncthreads_and`` are that barrier, a launch runs its blocks one after
another, and ``extern __shared__`` is a buffer of the block (refilled with
a 0xA5 pattern before every block, so nothing may rely on its contents).
``-ffp-contract=off`` keeps every multiply and add apart, as the kernels'
``__fmul_rn``/``__fadd_rn`` do. The host's libm stands in for the card's
transcendental functions, so a kernel and its plain PyTorch version differ
there by an ULP, while two kernels built here differ only where their
arithmetic or summation order does. The tests hold:

- kernel #3's loss and validity bit-equal to kernel #2's on the same
  constant vectors and lane count (the lane order of csrc/interp.cuh);
- #3's validity equal to ``program_grad_plain``'s, its loss sums within
  rtol 1e-5 and its gradients non-finite in the same places and otherwise
  within 1e-4 of the sum of the absolute per-row terms (chip_smoke.py
  phase 4's tolerance);
- #4's validity equal to ``program_predict_plain``'s, its predictions NaN
  and +-inf in the same places and otherwise within rtol 1e-5, or within
  1e-5 of the tree's largest finite |prediction| where the rows cancel
  (chip_smoke.py phase 8's tolerance);
- #5's gcomp NaN and +-inf in the same places as
  ``program_predict_vjp_plain``'s and otherwise within 1e-4 of the sum of
  the absolute per-row terms, and its gx by #4's rule (chip_smoke.py
  phase 8's tolerances);
- two launches of each bit-identical;
- #1 (cost form), #2 and #3 with every library loss kind, in float32 and
  in their float64 forms, against their plain versions (#3's loss
  bit-equal to #2's);

on ragged row counts, a minibatch's 50 rows and a single row (fewer rows
than lanes), lane counts W of 32, 64 and 256, V of 1, 3 and 24,
shared and per-member X, repeated arguments, constant-only trees, one-step
programs and trees of every step-count class. They skip where g++ is
missing. ``build_host_library`` also builds another checkout's sources, so
two versions of a kernel can be held against each other bit for bit:
``python tests/test_torch_tile_host.py OLD_CSRC NEW_CSRC`` (#2 in float32,
bf16 and float64, #3 in float32 and float64, #4 and #5).
tests/test_torch_tile_host_vector.py holds #2's and #3's vectors against
launches of each alone.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu_torch as S
from symbolicregression_jl_tpu_torch.core import losses as SL
from symbolicregression_jl_tpu_torch.evolve.step import evolve_config_from_options
from symbolicregression_jl_tpu_torch.ops import fused_eval as SF
from symbolicregression_jl_tpu_torch.ops.encoding import encode_population
from symbolicregression_jl_tpu_torch.ops.program import compile_program
from symbolicregression_jl_tpu_torch.ops.tree import parse_expression

sys.path.insert(0, str(Path(__file__).resolve().parent))
from kernel_trees import cat_trees, random_trees, with_written  # noqa: E402
from torch_parity import cap_torch_threads  # noqa: E402

cap_torch_threads()

CSRC = Path(SF.__file__).resolve().parent.parent / "csrc"
SOURCES = ("program_multi.cu", "program_grad.cu", "program_predict.cu",
           "program_predict_vjp.cu", "program_eval.cu")

SHIM = r"""
#pragma once
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <math.h>
#include <mutex>
#include <stdint.h>
#include <thread>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

struct shim_dim3 { unsigned x, y, z; };
inline thread_local shim_dim3 threadIdx{0, 0, 0};
inline thread_local shim_dim3 blockIdx{0, 0, 0};
inline thread_local shim_dim3 blockDim{1, 1, 1};
inline thread_local shim_dim3 gridDim{1, 1, 1};

struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }

struct __nv_bfloat16 { unsigned short bits; };
inline float __bfloat162float(__nv_bfloat16 v) {
  uint32_t u = (uint32_t)v.bits << 16; float f; memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __nv_bfloat16{0x7fff};
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{(unsigned short)(u >> 16)};
}

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline double __longlong_as_double(long long i) { double d; memcpy(&d, &i, 8); return d; }
inline int atomicMax(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(p, &old, v, false, __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {}
  return old;
}
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline void __trap() { fprintf(stderr, "__trap\n"); abort(); }
template <class T> inline T min(T a, T b) { return b < a ? b : a; }
template <class T> inline T max(T a, T b) { return a < b ? b : a; }

typedef int cudaError_t;
enum : int { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// Two SMs of two blocks each: a persistent launch runs four blocks, the
// first of which takes every item of a work counter (blocks run in turn).
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 2; return cudaSuccess; }
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int threads, size_t smem) {
  *n = (threads <= 1024 && smem <= 232448) ? 2 : 0;
  return cudaSuccess;
}

namespace shim {
inline int last_error = 0;
#if defined(__x86_64__)
// Each CUDA thread of a block is a fiber of the calling thread with a
// stack of its own: it runs until it reaches a barrier (or returns), then
// the next one runs, in thread order; when every fiber left waits at the
// barrier, they go on, each given the AND of their predicates. No OS
// thread per CUDA thread: a launch takes one core however busy the host
// is (a block of 256 threads on a barrier of std::threads waited on the
// scheduler at every __syncthreads when other processes held the cores).
extern "C" void shim_switch(void** save_sp, void* next_sp);
asm(".text\n.globl shim_switch\n.hidden shim_switch\n.type shim_switch,@function\n"
    "shim_switch:\n  pushq %rbp\n  pushq %rbx\n  pushq %r12\n  pushq %r13\n  pushq %r14\n"
    "  pushq %r15\n  movq %rsp, (%rdi)\n  movq %rsi, %rsp\n  popq %r15\n  popq %r14\n"
    "  popq %r13\n  popq %r12\n  popq %rbx\n  popq %rbp\n  ret\n"
    ".size shim_switch, .-shim_switch\n");

struct Fiber { void* sp = nullptr; int pred = 1; bool done = false; };
inline thread_local void* sched_sp = nullptr;
inline thread_local Fiber* fibers = nullptr;
inline thread_local int current = 0, barrier_result = 1;
inline thread_local void (*run_body)(void*) = nullptr;
inline thread_local void* body_arg = nullptr;
inline thread_local unsigned char* dyn = nullptr;

[[noreturn]] inline void fiber_main() {
  run_body(body_arg);
  fibers[current].done = true;
  shim_switch(&fibers[current].sp, sched_sp);
  __builtin_unreachable();
}

// A fresh fiber's stack: the first switch into it "returns" to fiber_main.
inline void* fiber_stack(unsigned char* top) {
  void** sp = reinterpret_cast<void**>(reinterpret_cast<uintptr_t>(top) & ~uintptr_t(15));
  *--sp = nullptr;                                   // fiber_main's return slot
  *--sp = reinterpret_cast<void*>(&fiber_main);
  for (int i = 0; i < 6; ++i) *--sp = nullptr;       // rbp rbx r12-r15
  return sp;
}

inline int sync(int p) {
  fibers[current].pred = p;
  shim_switch(&fibers[current].sp, sched_sp);
  return barrier_result;
}

// grid blocks of `threads` threads in turn, `smem` bytes of dynamic
// shared memory each; refuses what the card would refuse.
template <class Body>
void launch(Body body, long grid, long threads, size_t smem, cudaStream_t = nullptr) {
  if (threads < 1 || threads > 1024 || smem > 232448) { last_error = 1; return; }
  last_error = 0;
  constexpr size_t kStack = size_t(1) << 18;
  std::vector<unsigned char> buf(smem + 16);
  unsigned char* base = buf.data() + (16 - (uintptr_t)buf.data() % 16) % 16;
  unsigned char* stacks = static_cast<unsigned char*>(malloc(kStack * threads));
  std::vector<Fiber> fs(threads);
  fibers = fs.data();
  dyn = base;
  run_body = [](void* b) { (*static_cast<Body*>(b))(); };
  body_arg = &body;
  blockDim = {(unsigned)threads, 1, 1};
  gridDim = {(unsigned)grid, 1, 1};
  for (long g = 0; g < grid; ++g) {
    memset(base, 0xA5, smem);
    blockIdx = {(unsigned)g, 0, 0};
    for (long t = 0; t < threads; ++t) fs[t] = Fiber{fiber_stack(stacks + (t + 1) * kStack)};
    for (;;) {
      int waiting = 0, acc = 1;
      for (long t = 0; t < threads; ++t) {
        if (fs[t].done) continue;
        current = (int)t;
        threadIdx = {(unsigned)t, 0, 0};
        shim_switch(&sched_sp, fs[t].sp);
        if (!fs[t].done) { ++waiting; acc &= fs[t].pred != 0; }
      }
      if (!waiting) break;
      barrier_result = acc;
    }
  }
  free(stacks);
}
}  // namespace shim

inline void __syncthreads() { shim::sync(1); }
inline int __syncthreads_and(int p) { return shim::sync(p); }
#else

// One block's barrier; sync(p) returns the AND of every thread's p.
// (A waiter yields a few times, then sleeps on the generation word, a futex
// with no mutex: a condition variable woke a block of 256 threads into one
// mutex in turn, and waiters that only yield starve the other test
// processes of their cores.)
struct Block {
  int nthreads = 0, result = 1;
  std::atomic<int> count{0}, acc{1}, gen{0};
  int sync(int p) {
    const int g = gen.load(std::memory_order_acquire);
    if (!p) acc.store(0, std::memory_order_relaxed);
    if (count.fetch_add(1, std::memory_order_acq_rel) + 1 == nthreads) {
      result = acc.load(std::memory_order_relaxed);
      acc.store(1, std::memory_order_relaxed);
      count.store(0, std::memory_order_relaxed);
      gen.fetch_add(1, std::memory_order_release);
      gen.notify_all();
      return result;
    }
    for (int i = 0; i < 16 && gen.load(std::memory_order_acquire) == g; ++i) {
      std::this_thread::yield();
    }
    while (gen.load(std::memory_order_acquire) == g) gen.wait(g, std::memory_order_acquire);
    return result;
  }
};
inline thread_local Block* block = nullptr;
inline thread_local unsigned char* dyn = nullptr;

// grid blocks of `threads` threads in turn, `smem` bytes of dynamic
// shared memory each; refuses what the card would refuse.
template <class Body>
void launch(Body body, long grid, long threads, size_t smem, cudaStream_t = nullptr) {
  if (threads < 1 || threads > 1024 || smem > 232448) { last_error = 1; return; }
  last_error = 0;
  std::vector<unsigned char> buf(smem + 16);
  unsigned char* base = buf.data() + (16 - (uintptr_t)buf.data() % 16) % 16;
  Block b;
  b.nthreads = (int)threads;
  auto work = [&](int tid) {
    threadIdx = {(unsigned)tid, 0, 0};
    blockDim = {(unsigned)threads, 1, 1};
    gridDim = {(unsigned)grid, 1, 1};
    block = &b;
    dyn = base;
    for (long g = 0; g < grid; ++g) {
      if (tid == 0) memset(base, 0xA5, smem);
      b.sync(1);
      blockIdx = {(unsigned)g, 0, 0};
      body();
      b.sync(1);
    }
  };
  std::vector<std::thread> pool;
  for (int tid = 0; tid < threads; ++tid) pool.emplace_back(work, tid);
  for (auto& th : pool) th.join();
}
}  // namespace shim

inline void __syncthreads() { shim::block->sync(1); }
inline int __syncthreads_and(int p) { return shim::block->sync(p); }
#endif
inline cudaError_t cudaGetLastError() { return shim::last_error; }
"""


def _host_source(text: str) -> str:
    """A kernel source with its launches and dynamic shared memory
    rewritten for the shim."""
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(shim::dyn);", text)
    return re.sub(r"(\w+)\s*<<<(.*?)>>>\s*\((.*?)\);",
                  r"shim::launch([&]() { \1(\3); }, \2);", text, flags=re.S)


def build_host_library(src: Path, out_dir: Path, user_header: str = None) -> Path:
    """Compile the CUDA source ``src`` (and the headers beside it) for the
    host with the shim into ``out_dir``; returns the shared library.
    ``user_header``: an operator set's generated user operators
    (ops/user_ops.py), compiled in as ops/cuda_build.py does."""
    out_dir.mkdir(parents=True, exist_ok=True)
    inc = out_dir / "include"
    inc.mkdir(exist_ok=True)
    (inc / "cuda_host_shim.h").write_text(SHIM)
    for header in ("cuda_runtime.h", "cuda_bf16.h"):
        (inc / header).write_text('#pragma once\n#include "cuda_host_shim.h"\n')
    # The headers beside the source, rewritten as the source is (found
    # first: the include directory precedes the source's own).
    for header in src.parent.glob("*.cuh"):
        (inc / header.name).write_text(_host_source(header.read_text()))
    cpp = out_dir / (src.stem + ".cpp")
    cpp.write_text(_host_source(src.read_text()))
    lib = out_dir / f"lib{src.stem}.so"
    user = []
    if user_header is not None:
        (inc / "sr_user_ops.cuh").write_text(user_header)
        user = ["-DSR_USER_OPS"]
    cmd = ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fno-strict-aliasing", "-fPIC",
           "-shared", "-pthread", "-w", *user, f"-I{inc}", f"-I{src.parent}", "-include",
           "cuda_host_shim.h", "-o", str(lib), str(cpp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {src.name}:\n{proc.stderr[-4000:]}")
    return lib


def load_host_libraries(csrc: Path, out_dir: Path):
    """{source name: ctypes library} of SOURCES in ``csrc``, built in
    parallel, with the kernel wrappers' argument types."""
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        paths = list(ex.map(lambda s: build_host_library(csrc / s, out_dir / Path(s).stem),
                            SOURCES))
    libs = {s: ctypes.CDLL(str(p)) for s, p in zip(SOURCES, paths)}
    for kernel, name in ((SF.ProgramMultiKernel(), "program_multi.cu"),
                         (SF.ProgramGradKernel(), "program_grad.cu"),
                         (SF.ProgramPredictKernel(), "program_predict.cu"),
                         (SF.ProgramPredictVjpKernel(), "program_predict_vjp.cu"),
                         (SF.ProgramEvalKernel(), "program_eval.cu"),
                         (SF.ProgramEvalF64Kernel(), "program_eval.cu"),
                         (SF.ProgramMultiF64Kernel(), "program_multi.cu"),
                         (SF.ProgramMultiBf16Kernel(), "program_multi.cu"),
                         (SF.ProgramGradF64Kernel(), "program_grad.cu")):
        _bind_host(kernel, libs[name])
    return libs


def _planned(lib, entry: str) -> bool:
    """Whether the library's #2 or #3 (``entry`` sr_program_multi or
    sr_program_grad) takes a plan buffer: a source tree before the
    vector-blocked kernels has neither it nor its size function."""
    return hasattr(lib, entry + "_plan_ints")


def _bind_host(kernel, lib):
    """The wrapper's argument types, without the plan buffer for an older
    source tree's #2 and #3."""
    older = any(kernel._entry.startswith(e) and not _planned(lib, e)
                for e in ("sr_program_multi", "sr_program_grad"))
    try:
        kernel._bind(lib)
    except AttributeError:   # the plan's functions, missing from an older tree
        if not older:
            raise
    fn = getattr(lib, kernel._entry)
    fn.restype = ctypes.c_int
    if older:
        fn.argtypes = fn.argtypes[:-2] + fn.argtypes[-1:]


def _plan_buf(lib, entry: str, T: int):
    """The plan buffer of #2 or #3, filled with garbage (None for an older
    tree)."""
    if not _planned(lib, entry):
        return None
    return torch.full((getattr(lib, entry + "_plan_ints")(T),), -7, dtype=torch.int32)


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def run_multi(lib, ops, loss_fn, instr, nsteps, cv, X, y, w, W):
    """Kernel #2 (float32, float64, or 2b for a bfloat16 X)."""
    T, V = cv.shape[:2]
    loss = torch.full((T, V), -7.0, dtype=cv.dtype)
    valid = torch.full((T, V), -7, dtype=torch.int32)
    optab = torch.tensor(SF._optab_list(ops), dtype=torch.int32)
    entry = (lib.sr_program_multi_f64 if cv.dtype == torch.float64 else
             lib.sr_program_multi_bf16 if X.dtype == torch.bfloat16 else lib.sr_program_multi)
    plan = _plan_buf(lib, "sr_program_multi", T)
    rc = entry(_p(instr), _p(nsteps), _p(cv), _p(X), _p(y), _p(w), _p(optab),
               T, V, instr.shape[1], cv.shape[2], X.shape[0], X.shape[1], W,
               loss_fn.kind, loss_fn.param, _code_mask(ops), 30, _p(loss),
               _p(valid), *([] if plan is None else [_p(plan)]), None)
    assert rc == 0
    return loss, valid


def run_grad(lib, ops, loss_fn, instr, nsteps, nconst, cv, X, y, w, W):
    T, V, CMAX = cv.shape
    loss = torch.full((T, V), -7.0, dtype=cv.dtype)
    valid = torch.full((T, V), -7, dtype=torch.int32)
    gcomp = torch.full((T, V, CMAX), -7.0, dtype=cv.dtype)
    optab = torch.tensor(SF._optab_list(ops), dtype=torch.int32)
    entry = lib.sr_program_grad_f64 if cv.dtype == torch.float64 else lib.sr_program_grad
    plan = _plan_buf(lib, "sr_program_grad", T)
    rc = entry(_p(instr), _p(nsteps), _p(nconst), _p(cv), _p(X), _p(y), _p(w),
               _p(optab), T, V, instr.shape[1], CMAX, X.shape[0], X.shape[1],
               SF._weighted_rows(w), W, loss_fn.kind, loss_fn.param,
               _code_mask(ops), 30, _p(loss), _p(valid), _p(gcomp),
               *([] if plan is None else [_p(plan)]), None)
    assert rc == 0
    return loss, valid, gcomp


def run_predict(lib, ops, instr, nsteps, cvals, ok, X, W):
    T = instr.shape[0]
    F, n = X.shape[-2:]
    pred = torch.full((T, n), -7.0)
    valid = torch.full((T,), -7, dtype=torch.int32)
    optab = torch.tensor(SF._optab_list(ops), dtype=torch.int32)
    rc = lib.sr_program_predict(_p(instr), _p(nsteps), _p(cvals), _p(ok), _p(X), _p(optab), T,
                                instr.shape[1], cvals.shape[1], F, n, W, int(X.dim() == 3),
                                _code_mask(ops), 30, _p(pred), _p(valid), None)
    assert rc == 0
    return pred, valid


def run_predict_vjp(lib, ops, instr, nsteps, nconst, cvals, X, ct, W):
    T = instr.shape[0]
    F, n = X.shape[-2:]
    per_member = X.dim() == 3
    gcomp = torch.full((T, cvals.shape[1]), -7.0)
    gx = torch.full((T, F, n), -7.0) if per_member else None
    optab = torch.tensor(SF._optab_list(ops), dtype=torch.int32)
    rc = lib.sr_program_predict_vjp(_p(instr), _p(nsteps), _p(nconst), _p(cvals), _p(X), _p(ct),
                                    _p(optab), T, instr.shape[1], cvals.shape[1], F, n, W,
                                    int(per_member), _code_mask(ops), 30, _p(gcomp),
                                    _p(gx) if per_member else None, None)
    assert rc == 0
    return gcomp, gx


def run_eval_cost(lib, ops, loss_fn, instr, nsteps, cvals, const_ok, X, y, w, cx, scal, W):
    """Kernel #1's cost form (float32, or float64 for float64 inputs)."""
    T = instr.shape[0]
    loss = torch.full((T,), -7.0, dtype=X.dtype)
    cost = torch.full((T,), -7.0, dtype=X.dtype)
    valid = torch.full((T,), -7, dtype=torch.int32)
    optab = torch.tensor(SF._optab_list(ops), dtype=torch.int32)
    entry = lib.sr_program_eval_f64 if X.dtype == torch.float64 else lib.sr_program_eval
    rc = entry(_p(instr), _p(nsteps), _p(cvals), _p(const_ok), _p(X), _p(y), _p(w), _p(cx),
               _p(scal), _p(optab), T, instr.shape[1], cvals.shape[1], X.shape[0], X.shape[1], W,
               loss_fn.kind, loss_fn.param, _code_mask(ops), 30, _p(loss), _p(valid), _p(cost),
               None)
    assert rc == 0
    return loss, valid, cost


def _code_mask(ops) -> int:
    return 0x3F if SF._dispatch_plan(ops).merged else 0x7F


def _bits(t):
    """Integer view of a tensor, every float NaN as one quiet NaN."""
    if t.dtype not in (torch.float32, torch.float64):
        return t
    nan = torch.tensor(float("nan"), dtype=t.dtype)
    return torch.where(torch.isnan(t), nan, t).view(
        torch.int64 if t.dtype == torch.float64 else torch.int32)


def _same(a, b) -> bool:
    """Bit for bit, NaN in the same places: on the host the payload and sign
    of a NaN + NaN follow the operand order the compiler picked for each
    addss, where the card returns one canonical NaN."""
    return bool(torch.equal(_bits(a), _bits(b)))


def _nonfinite_match(a, b):
    ia, ib = torch.isinf(a), torch.isinf(b)
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(ia, ib) and torch.equal(a[ia], b[ib])


# Trees that read no constant: kernels #2 and #3 run them once, for every
# vector.
CONST_FREE = ("x1 * x2", "cos(x1) - x3", "exp(x2) * (x1 + x3)", "(x1 * x1) / (x2 - x3)",
              "abs(x1 - x2) + (x3 * x1)")


def _grad_args(n: int, nlength, T: int, binary=("+", "-", "*", "/"), zero_weights=False,
               nonfinite_const=False, written=True, const_free=False):
    """T random trees over 3 features (maxsize 30) of each length of
    ``nlength`` (kernel_trees.random_trees) followed by the written ones the
    operators can write (unless ``written`` is False) and CONST_FREE (with
    ``const_free``), bench-like data with every 97th row's X at +-1e20
    (x * x overflows, inf - inf gives NaN) and a tenth of the weights 0."""
    opts = S.Options(binary_operators=list(binary), unary_operators=["cos", "abs", "exp"],
                     maxsize=30, populations=4, population_size=32, tournament_selection_n=8,
                     should_optimize_constants=False, save_to_file=False)
    ops = opts.operators
    cfg = evolve_config_from_options(opts, 3, torch.device("cpu"))
    trees = random_trees(11, 1, T, cfg.mctx, nlength, "cpu")
    if written:
        trees = with_written(trees, ops, 3)
    if const_free:
        names = ["x1", "x2", "x3"]
        trees = cat_trees([trees, encode_population([parse_expression(e, ops, names)
                                                     for e in CONST_FREE], trees.max_nodes, ops,
                                                    device="cpu")])
    g = np.random.default_rng(n)
    Xn = g.uniform(-3, 3, (3, n)).astype(np.float32)
    Xn[:, ::97] = 1e20 * np.sign(g.normal(size=Xn[:, ::97].shape))
    wn = np.where(g.random(n) < 0.1, 0.0, g.uniform(0.2, 2, n)).astype(np.float32)
    if zero_weights:
        wn[:] = 0.0
    prog = compile_program(trees, 3, len(ops.binary))
    instr, nsteps, cvals, _, X, y, w = SF._launch_inputs(
        prog, torch.from_numpy(Xn), torch.from_numpy(g.normal(size=n).astype(np.float32)),
        torch.from_numpy(wn), 3, ops)
    if nonfinite_const:
        cvals = cvals.clone()
        cvals[::7, 0] = torch.inf
        cvals[::13, 0] = torch.nan
    return ops, instr, nsteps, prog.nconst.to(torch.int32).contiguous(), cvals, X, y, w


def _inexact(instr, nsteps, ops):
    """[T] bool: a live step applies a unary operator other than abs, whose
    float32 value the host's libm and PyTorch may round an ULP apart (an
    ill-conditioned random tree amplifies that past any fixed rtol)."""
    tab = torch.tensor(SF._optab_list(ops))
    entry = tab[((instr >> 24) & _code_mask(ops)).long()]
    live = torch.arange(instr.shape[1])[None, :] < nsteps[:, None]
    unary = ((entry >> 8) == SF._K_UNARY) & ((entry & 0xFF) != SF._KERNEL_OP_IDS["abs"])
    return (live & unary).any(dim=1)


def _variants(cvals, V: int, seed: int):
    """The trees' constants perturbed V ways (V = 1: as they are), a few
    non-finite."""
    if V == 1:
        return cvals[:, None, :].contiguous()
    g = torch.Generator().manual_seed(seed)
    cv = cvals[:, None, :] * (1.0 + 0.5 * torch.randn((cvals.shape[0], V, cvals.shape[1]),
                                                      generator=g))
    cv[::5, V // 2, 0] = torch.nan
    return cv.contiguous()


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA sources for the host")
    return load_host_libraries(CSRC, tmp_path_factory.mktemp("tile_host"))


GRAD_CASES = {
    # n not a multiple of the lanes or of the rows per thread
    "ragged_W256_V3": dict(n=1001, W=256, V=3, nlength=6),
    "W32_V1": dict(n=203, W=32, V=1, nlength=6),
    "W64_V24": dict(n=258, W=64, V=24, nlength=6),
    "one_step_W64_V3": dict(n=130, W=64, V=3, nlength=1),
    "zero_weights_W32_V3": dict(n=99, W=32, V=3, nlength=6, zero_weights=True),
    "nonfinite_const_W64_V3": dict(n=300, W=64, V=3, nlength=8, nonfinite_const=True),
    "unmerged_plan_W32_V3": dict(n=97, W=32, V=3, nlength=6, binary=("*", "/", "-")),
    # every step-count class of csrc/program_grad.cu in one call (m <= 4,
    # 5-12 and 13 or more steps), and long trees alone in passes of one or
    # two vectors
    "step_classes_W64_V3": dict(n=203, W=64, V=3, nlength=(2, 8, 16)),
    "long_W256_V24": dict(n=301, W=256, V=24, nlength=24),
    # a minibatch's rows (batch_size 50) and a single row: fewer rows than
    # lanes, at the lane count of the bench shapes
    "batch50_W256_V24": dict(n=50, W=256, V=24, nlength=6),
    "batch50_step_classes_W256_V3": dict(n=50, W=256, V=3, nlength=(2, 8, 16)),
    "one_row_W256_V3": dict(n=1, W=256, V=3, nlength=6),
    # V not a multiple of the vectors a thread carries (8 in #2, 3 in #3)
    "V5_step_classes_W64": dict(n=203, W=64, V=5, nlength=(2, 8, 16)),
    "V7_W32": dict(n=130, W=32, V=7, nlength=6),
    # trees that read no constant among the others
    "const_free_W64_V24": dict(n=150, W=64, V=24, nlength=(2, 8), const_free=True),
    # trees of 1 and of 16 or more steps only: the middle class has none
    "empty_class_W64_V3": dict(n=97, W=64, V=3, nlength=(1, 16), written=False),
}


def grad_case(case: str, loss_fn):
    """(operators, loss_fn, launch arguments after the library, W) of a
    GRAD_CASES case."""
    spec = dict(GRAD_CASES[case])
    W, V = spec.pop("W"), spec.pop("V")
    ops, instr, nsteps, nconst, cvals, X, y, w = _grad_args(T=24, **spec)
    return ops, loss_fn, (instr, nsteps, nconst, _variants(cvals, V, seed=V), X, y, w), W


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
@pytest.mark.parametrize("loss_fn", [SL.l2_dist_loss, SL.LOSS_REGISTRY["huber"]],
                         ids=["l2", "huber"])
def test_grad_kernel_on_host(host_libs, case, loss_fn):
    ops, loss_fn, args, W = grad_case(case, loss_fn)
    instr, nsteps, nconst, cv, X, y, w = args
    lib2, lib3 = host_libs["program_multi.cu"], host_libs["program_grad.cu"]
    gl, gv, gg = run_grad(lib3, ops, loss_fn, *args, W)
    gl2, gv2, gg2 = run_grad(lib3, ops, loss_fn, *args, W)
    assert _same(gl, gl2) and _same(gv, gv2) and _same(gg, gg2)
    ml, mv = run_multi(lib2, ops, loss_fn, instr, nsteps, cv, X, y, w, W)
    assert _same(gl, ml) and _same(gv, mv), "#3's loss differs from #2's"

    pl, pv, pg, pabs = SF.program_grad_plain(*args, ops, loss_fn, return_abs=True)
    assert torch.equal(gv.bool(), pv) and 0 < int(pv.sum()) < pv.numel()
    live = pv[..., None].expand_as(pg)
    fin_k, fin_p = torch.isfinite(gg), torch.isfinite(pg)
    assert torch.equal(fin_k[live], fin_p[live]), "gradients non-finite in other places"
    # Magnitudes on trees of exact operators; the others are held by their
    # bits against #2 above.
    exact = pv & ~_inexact(instr, nsteps, ops)[:, None]
    assert int(exact.sum()) > 0
    np.testing.assert_allclose(gl[exact].numpy(), pl[exact].numpy(), rtol=1e-5, atol=0)
    both = exact[..., None].expand_as(pg) & fin_k & fin_p
    assert bool(((gg - pg).abs()[both] <= 1e-4 * pabs[both]).all())
    used = torch.arange(cv.shape[2])[None, None, :] < nconst[:, None, None]
    assert bool((gg[~used.expand_as(gg)] == 0).all())


@pytest.mark.parametrize("fill", ["cyclic", "edge"])
def test_zero_weight_padding_bit_inert_on_host(host_libs, fill):
    """pack/padding.py's contract on the CUDA sources: the ragged case's
    trees on its 1,001 rows (a tenth of the weights 0, every 97th row's X
    at +-1e20, so some rows' derivatives overflow) and on the same rows
    padded to their 2,048-row bucket with ``fill`` replicas at weight 0:
    #1's cost form, #2 and #3 (loss sums, validity, gradients) bit-equal.
    #3 sums the constants' cotangents up to the last row of positive
    weight, so a replica's 0 x inf never reaches a gradient."""
    from symbolicregression_jl_tpu_torch.pack import pad_to_bucket

    ops, loss_fn, args, W = grad_case("ragged_W256_V3", SL.l2_dist_loss)
    instr, nsteps, nconst, cv, X, y, w = args
    n = X.shape[1]
    Xp, yp, _ = pad_to_bucket(X.T.numpy(), y.numpy(), rows=2048, fill=fill)
    wp = np.concatenate([w.numpy(), np.zeros(2048 - n, np.float32)])
    padded = (torch.from_numpy(np.ascontiguousarray(Xp.T)), torch.from_numpy(yp),
              torch.from_numpy(wp))
    cvals = cv[:, 0, :].contiguous()
    ok = torch.ones(instr.shape[0], dtype=torch.int32)
    cx = torch.full((instr.shape[0],), 3.0)
    scal = torch.tensor([float(w.sum()), 1.5, 0.01])
    outs = []
    for Xs, ys, ws in ((X, y, w), padded):
        outs.append((*run_eval_cost(host_libs["program_eval.cu"], ops, loss_fn, instr, nsteps,
                                    cvals, ok, Xs, ys, ws, cx, scal, W),
                     *run_multi(host_libs["program_multi.cu"], ops, loss_fn, instr, nsteps, cv,
                                Xs, ys, ws, W),
                     *run_grad(host_libs["program_grad.cu"], ops, loss_fn, instr, nsteps, nconst,
                               cv, Xs, ys, ws, W)))
    for a, b in zip(*outs):
        assert _same(a, b)
    gv, gg = outs[0][-2].bool(), outs[0][-1]
    assert 0 < int(gv.sum()) < gv.numel() and bool(torch.isfinite(gg).all()) is False


# Every library loss besides L2 and Huber(1) (the kinds of csrc/interp.cuh
# that run in LOSS_ANY's run-time switch), and each with float64 inputs.
KIND_LOSSES = {"l1": SL.l1_dist_loss, "huber(0.5)": SL.huber_loss(0.5),
               "huber(2)": SL.huber_loss(2.0), "logcosh": SL.LOSS_REGISTRY["logcosh"],
               "logit": SL.LOSS_REGISTRY["LogitDistLoss"],
               "sigmoid_ce": SL.sigmoid_cross_entropy_loss,
               "periodic(2pi)": SL.periodic_l2_loss(), "periodic(1)": SL.periodic_l2_loss(1.0)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("loss_name", sorted(KIND_LOSSES) + ["l2"])
def test_loss_kinds_and_float64_on_host(host_libs, loss_name, dtype):
    """Kernels #1 (cost form), #2 and #3 with every loss kind, in float32
    and in their float64 forms, on GRAD_CASES' ragged W = 256 case: #3's
    loss bit-equal to #2's, validity equal to the plain versions', losses
    on trees of exact operators within rtol 1e-5 (float32) or 1e-9
    (float64) with inf in the same places, gradients non-finite in the same
    places and otherwise within 1e-4 (1e-9) of the absolute row sums, #1's
    cost form against its plain version the same way."""
    loss_fn = KIND_LOSSES.get(loss_name, SL.l2_dist_loss)
    rtol = 1e-9 if dtype == "float64" else 1e-5
    gtol = 1e-9 if dtype == "float64" else 1e-4
    ops, _, args, W = grad_case("ragged_W256_V3", loss_fn)
    instr, nsteps, nconst, cv, X, y, w = args
    if dtype == "float64":
        cv, X, y, w = (t.double().contiguous() for t in (cv, X, y, w))
        args = (instr, nsteps, nconst, cv, X, y, w)
    gl, gv, gg = run_grad(host_libs["program_grad.cu"], ops, loss_fn, *args, W)
    ml, mv = run_multi(host_libs["program_multi.cu"], ops, loss_fn, instr, nsteps, cv, X, y, w,
                       W)
    assert gl.dtype == cv.dtype
    assert _same(gl, ml) and _same(gv, mv), "#3's loss differs from #2's"
    pl, pv, pg, pabs = SF.program_grad_plain(*args, ops, loss_fn, return_abs=True)
    assert torch.equal(gv.bool(), pv) and 0 < int(pv.sum()) < pv.numel()
    exact = pv & ~_inexact(instr, nsteps, ops)[:, None]
    np.testing.assert_allclose(gl[exact].numpy(), pl[exact].numpy(), rtol=rtol, atol=0)
    live = pv[..., None].expand_as(pg)
    fin_k, fin_p = torch.isfinite(gg), torch.isfinite(pg)
    assert torch.equal(fin_k[live], fin_p[live])
    both = exact[..., None].expand_as(pg) & fin_k & fin_p
    assert bool(((gg - pg).abs()[both] <= gtol * pabs[both]).all())

    cvals = cv[:, 0].contiguous()
    ok = torch.ones(instr.shape[0], dtype=torch.int32)
    cx = torch.arange(instr.shape[0], dtype=X.dtype) % 7 + 1
    scal = torch.tensor([float(w.sum()), 1.3, 0.01], dtype=X.dtype)
    lk, vk, ck = run_eval_cost(host_libs["program_eval.cu"], ops, loss_fn, instr, nsteps, cvals,
                               ok, X, y, w, cx, scal, W)
    lp, vp, cp = SF.program_eval_plain(instr, nsteps, cvals, ok, X, y, w, ops, loss_fn, cx=cx,
                                       scal=scal)
    assert torch.equal(vk.bool(), vp)
    ex1 = vp & ~_inexact(instr, nsteps, ops)
    assert torch.equal(torch.isinf(lk), torch.isinf(lp))
    np.testing.assert_allclose(ck[ex1].numpy(), cp[ex1].numpy(), rtol=rtol, atol=0)


PREDICT_CASES = {
    "shared_F1_W256": dict(n=1001, F=1, per_member=False, W=256),
    "shared_F3_W32": dict(n=250, F=3, per_member=False, W=32),
    "per_member_F2_W64": dict(n=203, F=2, per_member=True, W=64),
    "per_member_F2_aligned_W256": dict(n=512, F=2, per_member=True, W=256),
    # a minibatch's rows and a single row: fewer rows than lanes
    "shared_batch50_W256": dict(n=50, F=1, per_member=False, W=256),
    "per_member_one_row_W256": dict(n=1, F=2, per_member=True, W=256),
}


def predict_case(case: str):
    """(operators, launch arguments after the library, W) of a
    PREDICT_CASES case: random trees of + - * cos (maxsize 30) and a few
    written out, every fifth tree's const_ok cleared, every 97th row's X
    at +-1e20 (in every seventh tree's X when per-member)."""
    spec = PREDICT_CASES[case]
    n, F, per_member, W = spec["n"], spec["F"], spec["per_member"], spec["W"]
    opts = S.Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=30,
                     populations=4, population_size=32, tournament_selection_n=8,
                     should_optimize_constants=False, save_to_file=False)
    ops = opts.operators
    cfg = evolve_config_from_options(opts, F, torch.device("cpu"))
    trees = with_written(random_trees(5 + F, 1, 40, cfg.mctx, 5, "cpu"), ops, F)
    T = trees.arity.shape[0]
    prog = compile_program(trees, F, len(ops.binary))
    g = np.random.default_rng(n + F)
    Xn = g.uniform(-2, 2, (T, F, n) if per_member else (F, n)).astype(np.float32)
    big = Xn[::7, :, ::97] if per_member else Xn[:, ::97]
    big[...] = np.where(big < 0, -1e20, 1e20)
    instr, nsteps, cvals, X = SF._predict_inputs(prog, torch.from_numpy(Xn), F, ops)
    ok = prog.const_ok.to(torch.int32).clone()
    ok[::5] = 0
    return ops, (instr, nsteps, cvals, ok, X), W


@pytest.mark.parametrize("case", sorted(PREDICT_CASES))
def test_predict_kernel_on_host(host_libs, case):
    ops, args, W = predict_case(case)
    lib = host_libs["program_predict.cu"]
    pk, vk = run_predict(lib, ops, *args, W)
    pk2, vk2 = run_predict(lib, ops, *args, W)
    assert _same(pk, pk2) and _same(vk, vk2)
    pp, vp = SF.program_predict_plain(*args, ops)
    T = pp.shape[0]
    assert torch.equal(vk.bool(), vp) and 0 < int(vp.sum()) < T
    _nonfinite_match(pk, pp)
    fb = torch.isfinite(pp)
    scale = torch.where(fb, pp.abs(), 0.0).amax(dim=-1, keepdim=True).expand_as(pp)
    err = (pk - pp).abs()[fb]
    assert bool(((err <= 1e-5 * pp.abs()[fb]) | (err <= 1e-5 * scale[fb])).all())


# Trees whose arguments repeat, so one feature's cotangent adds up from
# several leaves (operand 1 before operand 2), beside the random ones.
REPEATED = ("x1 * x1", "x1 + x1", "x1 - x1", "(x1 * x1) * x1", "cos(x1) * x1",
            "(x1 + 0.5) * (x1 - 0.5)")

VJP_CASES = {
    # n not a multiple of the lanes or of the rows per thread
    "shared_ragged_W256": dict(n=1001, F=1, per_member=False, W=256, nlength=5),
    "shared_F3_W32": dict(n=250, F=3, per_member=False, W=32, nlength=5),
    "per_member_F2_W64": dict(n=203, F=2, per_member=True, W=64, nlength=5),
    "per_member_aligned_W256": dict(n=512, F=2, per_member=True, W=256, nlength=5),
    "one_step_per_member_W32": dict(n=130, F=1, per_member=True, W=32, nlength=1),
    # every step-count class (m <= 4, 5-12 and 13 or more steps) in one call
    "step_classes_shared_W64": dict(n=203, F=2, per_member=False, W=64, nlength=(2, 8, 16)),
    "step_classes_per_member_W256": dict(n=301, F=2, per_member=True, W=256,
                                         nlength=(2, 8, 16)),
    # a minibatch's rows and a single row: fewer rows than lanes
    "shared_batch50_W256": dict(n=50, F=1, per_member=False, W=256, nlength=5),
    "per_member_one_row_W256": dict(n=1, F=2, per_member=True, W=256, nlength=(2, 8, 16)),
}


def vjp_case(case: str):
    """(operators, launch arguments after the library, W) of a VJP_CASES
    case: random trees of + - * cos (maxsize 30) of the case's step counts,
    the written ones (constant-only and one-step trees among them) and
    REPEATED, X on [-2, 2] with every 97th row at +-1e20 (in every seventh
    tree's X when per-member), random row cotangents."""
    spec = VJP_CASES[case]
    n, F, per_member, W = spec["n"], spec["F"], spec["per_member"], spec["W"]
    opts = S.Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=30,
                     populations=4, population_size=32, tournament_selection_n=8,
                     should_optimize_constants=False, save_to_file=False)
    ops = opts.operators
    cfg = evolve_config_from_options(opts, F, torch.device("cpu"))
    trees = with_written(random_trees(19 + F, 1, 24, cfg.mctx, spec["nlength"], "cpu"), ops, F)
    names = [f"x{i + 1}" for i in range(F)]
    trees = cat_trees([trees, encode_population([parse_expression(e, ops, names)
                                                 for e in REPEATED], trees.max_nodes, ops,
                                                device="cpu")])
    T = trees.arity.shape[0]
    prog = compile_program(trees, F, len(ops.binary))
    g = np.random.default_rng(n + 7 * F)
    Xn = g.uniform(-2, 2, (T, F, n) if per_member else (F, n)).astype(np.float32)
    big = Xn[::7, :, ::97] if per_member else Xn[:, ::97]
    big[...] = np.where(big < 0, -1e20, 1e20)
    instr, nsteps, cvals, X = SF._predict_inputs(prog, torch.from_numpy(Xn), F, ops)
    ct = torch.from_numpy(g.normal(size=(T, n)).astype(np.float32))
    nconst = prog.nconst.to(torch.int32).contiguous()
    return ops, (instr, nsteps, nconst, cvals, X, ct), W


@pytest.mark.parametrize("case", sorted(VJP_CASES))
def test_predict_vjp_kernel_on_host(host_libs, case):
    ops, args, W = vjp_case(case)
    lib = host_libs["program_predict_vjp.cu"]
    gk, xk = run_predict_vjp(lib, ops, *args, W)
    gk2, xk2 = run_predict_vjp(lib, ops, *args, W)
    assert _same(gk, gk2) and (xk is None or _same(xk, xk2))
    gp, xp, gabs = SF.program_predict_vjp_plain(*args, ops, return_abs=True)
    nsteps, nconst = args[1], args[2]
    assert int(nsteps.min()) == 1
    if isinstance(VJP_CASES[case]["nlength"], tuple):
        assert int(nsteps.max()) > 12 and bool(((nsteps > 4) & (nsteps <= 12)).any())
    # Where the absolute per-row terms overflow (gabs inf), the order of the
    # sum decides between finite, +-inf and NaN; everywhere else the
    # non-finite places agree.
    order = torch.isinf(gabs)
    assert torch.equal(torch.isfinite(gk)[~order], torch.isfinite(gp)[~order])
    assert torch.equal(torch.isnan(gk)[~order], torch.isnan(gp)[~order])
    assert bool(torch.isfinite(gk).any())
    both = torch.isfinite(gabs) & torch.isfinite(gk)
    assert bool(((gk - gp).abs()[both] <= 1e-4 * gabs[both]).all())
    used = torch.arange(gk.shape[1])[None, :] < nconst[:, None]
    assert bool((gk[~used] == 0).all())
    assert (xk is None) == (xp is None)
    if xk is not None:
        T = xk.shape[0]
        xk, xp = xk.reshape(T, -1), xp.reshape(T, -1)
        _nonfinite_match(xk, xp)
        fb = torch.isfinite(xp)
        scale = torch.where(fb, xp.abs(), 0.0).amax(dim=-1, keepdim=True).expand_as(xp)
        assert bool(((xk - xp).abs()[fb] <= 1e-5 * scale[fb]).all())


# ---------------------------------------------------------------------------
# User operators: the generated header (ops/user_ops.py) compiled in
# ---------------------------------------------------------------------------

USER_OPS = {}


def user_opset():
    """+ - * pdiv / exp gauss softplus, the user operators written in torch
    (tests/test_torch_user_ops.py holds them against the JAX package)."""
    if not USER_OPS:
        USER_OPS["set"] = S.OperatorSet(
            ["+", "-", "*", S.Op("pdiv", 2, lambda a, b: torch.where(b == 0, 0, a / b))],
            ["exp", S.Op("gauss", 1, lambda x: torch.exp(-x * x)),
             S.Op("softplus", 1, lambda x: torch.log1p(torch.exp(x)))])
    return USER_OPS["set"]


@pytest.fixture(scope="module")
def user_host_libs(tmp_path_factory):
    """Kernels #3, #4 and #5 built for the host with the user operators'
    generated header."""
    from symbolicregression_jl_tpu_torch.ops.user_ops import user_op_set

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA sources for the host")
    header = user_op_set(user_opset()).header
    out = tmp_path_factory.mktemp("tile_host_user")
    names = ("program_grad.cu", "program_predict.cu", "program_predict_vjp.cu")
    with ThreadPoolExecutor(len(names)) as ex:
        paths = list(ex.map(lambda s: build_host_library(CSRC / s, out / Path(s).stem, header),
                            names))
    libs = {s: ctypes.CDLL(str(p)) for s, p in zip(names, paths)}
    for kernel, name in ((SF.ProgramGradKernel(), "program_grad.cu"),
                         (SF.ProgramPredictKernel(), "program_predict.cu"),
                         (SF.ProgramPredictVjpKernel(), "program_predict_vjp.cu")):
        _bind_host(kernel, libs[name])
    return libs


def _user_case(F: int, n: int, per_member: bool = False):
    """Random trees of the user operator set in every step-count class,
    X on [-3, 3] with the last feature 0 on every fifth row (pdiv's b = 0)
    and a few rows large enough for exp to overflow."""
    ops = user_opset()
    opts = S.Options(binary_operators=list(ops.binary), unary_operators=list(ops.unary),
                     maxsize=30, populations=4, population_size=32, tournament_selection_n=8,
                     should_optimize_constants=False, save_to_file=False)
    cfg = evolve_config_from_options(opts, F, torch.device("cpu"))
    trees = random_trees(23 + F, 1, 24, cfg.mctx, (2, 8, 16), "cpu")
    T = trees.arity.shape[0]
    g = np.random.default_rng(n + F)
    Xn = g.uniform(-3, 3, (T, F, n) if per_member else (F, n)).astype(np.float32)
    Xn[..., -1, ::5] = 0.0
    Xn[..., 0, 3::17] = 95.0
    return ops, compile_program(trees, F, len(ops.binary)), torch.from_numpy(Xn), g


@pytest.mark.parametrize("kernel", ["grad", "predict", "vjp_shared", "vjp_per_member"])
def test_user_ops_on_host(user_host_libs, kernel):
    """Kernels #3, #4 and #5 with the generated user operators against their
    plain versions (which call the operators' own functions and
    torch.autograd) under this file's rules, on trees of every step-count
    class: validity bit-equal, losses within rtol 1e-5 on the trees whose
    values libm and PyTorch compute alike, gradients non-finite in the same
    places where the absolute row sums are finite and otherwise within 1e-4
    of them, predictions and gx by #4's rule, two launches bit-identical."""
    if kernel == "grad":
        ops, prog, X, g = _user_case(3, 203)
        n = X.shape[1]
        y = torch.from_numpy(g.normal(size=n).astype(np.float32))
        w = torch.from_numpy(np.where(g.random(n) < 0.1, 0.0, 1.0).astype(np.float32))
        instr, nsteps, cvals, _, Xc, yc, wc = SF._launch_inputs(prog, X, y, w, 3, ops)
        args = (instr, nsteps, prog.nconst.to(torch.int32).contiguous(),
                _variants(cvals, 3, seed=3), Xc, yc, wc)
        lib = user_host_libs["program_grad.cu"]
        gl, gv, gg = run_grad(lib, ops, SL.l2_dist_loss, *args, 64)
        gl2, gv2, gg2 = run_grad(lib, ops, SL.l2_dist_loss, *args, 64)
        assert _same(gl, gl2) and _same(gg, gg2)
        pl, pv, pg, pabs = SF.program_grad_plain(*args, ops, SL.l2_dist_loss, return_abs=True)
        assert torch.equal(gv.bool(), pv) and 0 < int(pv.sum()) < pv.numel()
        nsteps_ok = torch.isfinite(pabs)
        live = pv[..., None].expand_as(pg) & nsteps_ok
        assert torch.equal(torch.isfinite(gg)[live], torch.isfinite(pg)[live])
        assert torch.equal(torch.isnan(gg)[live], torch.isnan(pg)[live])
        both = live & torch.isfinite(gg) & torch.isfinite(pg)
        assert bool(((gg - pg).abs()[both] <= 1e-4 * pabs[both]).all())
        fin = pv & torch.isfinite(pl)
        rel = ((gl - pl).abs() / pl.abs().clamp(min=1e-30))[fin]
        assert float(rel.median()) < 1e-5 and float(rel.max()) < 1e-2
        return
    per_member = kernel == "vjp_per_member"
    ops, prog, X, g = _user_case(2, 161, per_member)
    F = X.shape[-2]
    instr, nsteps, cvals, Xc = SF._predict_inputs(prog, X, F, ops)
    T, n = instr.shape[0], Xc.shape[-1]
    if kernel == "predict":
        ok = prog.const_ok.to(torch.int32).contiguous()
        lib = user_host_libs["program_predict.cu"]
        pk, vk = run_predict(lib, ops, instr, nsteps, cvals, ok, Xc, 64)
        pk2, vk2 = run_predict(lib, ops, instr, nsteps, cvals, ok, Xc, 64)
        assert _same(pk, pk2) and _same(vk, vk2)
        pp, vp = SF.program_predict_plain(instr, nsteps, cvals, ok, Xc, ops)
        assert torch.equal(vk.bool(), vp) and 0 < int(vp.sum()) < T
        _nonfinite_match(pk, pp)
        fb = torch.isfinite(pp)
        scale = torch.where(fb, pp.abs(), 0.0).amax(dim=-1, keepdim=True).expand_as(pp)
        err = (pk - pp).abs()[fb]
        assert bool(((err <= 1e-5 * pp.abs()[fb]) | (err <= 1e-5 * scale[fb])).all())
        return
    nconst = prog.nconst.to(torch.int32).contiguous()
    ct = torch.from_numpy(g.normal(size=(T, n)).astype(np.float32))
    lib = user_host_libs["program_predict_vjp.cu"]
    gk, xk = run_predict_vjp(lib, ops, instr, nsteps, nconst, cvals, Xc, ct, 64)
    gk2, xk2 = run_predict_vjp(lib, ops, instr, nsteps, nconst, cvals, Xc, ct, 64)
    assert _same(gk, gk2) and (xk is None or _same(xk, xk2))
    gp, xp, gabs = SF.program_predict_vjp_plain(instr, nsteps, nconst, cvals, Xc, ct, ops,
                                                return_abs=True)
    order = torch.isinf(gabs)
    assert torch.equal(torch.isfinite(gk)[~order], torch.isfinite(gp)[~order])
    assert torch.equal(torch.isnan(gk)[~order], torch.isnan(gp)[~order])
    both = torch.isfinite(gabs) & torch.isfinite(gk)
    assert bool(((gk - gp).abs()[both] <= 1e-4 * gabs[both]).all())
    assert (xk is None) == (xp is None) == (not per_member)
    if per_member:
        xk, xp = xk.reshape(T, -1), xp.reshape(T, -1)
        _nonfinite_match(xk, xp)
        fb = torch.isfinite(xp)
        scale = torch.where(fb, xp.abs(), 0.0).amax(dim=-1, keepdim=True).expand_as(xp)
        err = (xk - xp).abs()[fb]
        assert bool(((err <= 1e-5 * xp.abs()[fb]) | (err <= 1e-5 * scale[fb])).all())


def main(argv) -> int:
    """Hold two csrc directories' kernels #2 (loss, valid; float32, 2b and
    float64), #3 (loss, valid, gcomp; float32 and float64), #4 (pred,
    valid) and #5 (gcomp, gx) against each other bit for bit on every case
    above."""
    import tempfile

    dirs = [Path(a) for a in argv[1:3]]
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        libs = [load_host_libraries(c, Path(tmp) / str(i)) for i, c in enumerate(dirs)]
        for case in sorted(GRAD_CASES):
            for loss_name in ("l2", "huber"):
                ops, loss_fn, args, W = grad_case(case, SL.LOSS_REGISTRY[loss_name])
                instr, nsteps, nconst, cv, X, y, w = args
                f64 = tuple(t.double().contiguous() for t in (cv, X, y, w))
                runs = {
                    "#2": lambda lib: run_multi(lib["program_multi.cu"], ops, loss_fn, instr,
                                                nsteps, cv, X, y, w, W),
                    "2b": lambda lib: run_multi(lib["program_multi.cu"], ops, loss_fn, instr,
                                                nsteps, cv, X.bfloat16(), y, w, W),
                    "#2 f64": lambda lib: run_multi(lib["program_multi.cu"], ops, loss_fn, instr,
                                                    nsteps, *f64, W),
                    "#3": lambda lib: run_grad(lib["program_grad.cu"], ops, loss_fn, *args, W),
                    "#3 f64": lambda lib: run_grad(lib["program_grad.cu"], ops, loss_fn, instr,
                                                   nsteps, nconst, *f64, W),
                }
                for kernel, run in runs.items():
                    a, b = (run(lib) for lib in libs)
                    same = all(_same(p, q) for p, q in zip(a, b))
                    bad += not same
                    print(f"{kernel} {case} {loss_name}: {'bit-equal' if same else 'DIFFERENT'}")
        for case in sorted(PREDICT_CASES):
            ops, args, W = predict_case(case)
            a, b = (run_predict(lib["program_predict.cu"], ops, *args, W) for lib in libs)
            same = all(_same(p, q) for p, q in zip(a, b))
            bad += not same
            print(f"#4 {case}: {'bit-equal' if same else 'DIFFERENT'}")
        for case in sorted(VJP_CASES):
            ops, args, W = vjp_case(case)
            a, b = (run_predict_vjp(lib["program_predict_vjp.cu"], ops, *args, W) for lib in libs)
            same = all(p is q or _same(p, q) for p, q in zip(a, b))
            bad += not same
            print(f"#5 {case}: {'bit-equal' if same else 'DIFFERENT'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
