// Forward + adjoint program kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_multi_grad_kernel` / `fused_grad_multi`
// in symbolicregression_jl_tpu/ops/fused_eval.py (Pallas). For every pair
// of a tree t and one of its V constant vectors v it computes kernel #2's
// loss_sum[t, v] and valid[t, v] and the gradient of loss_sum with respect
// to the tree's constants, gcomp[t, v, c] for c < nconst[t] (0 past it).
//
// Per row: the forward sweep (kernel #2's arithmetic, so the loss is
// bit-equal to kernel #2's), the loss cotangent seeded with the row's
// weight and zeroed where w <= 0, then a reverse sweep over the steps that
// mirrors the JAX package's `_bwd_dispatch` (interp.cuh's reverse sweep,
// shared with kernel #5): each constant's cotangent adds straight into its
// row's per-lane gradient sum; X's and the zero row's cotangents are never
// read, so they are not kept. Weight-0 rows are not masked (their cotangent is
// exactly 0 and 0 * inf is NaN inside an operator's derivative, as in the
// JAX package); the wrapper zeroes non-finite gradients.
//
// Design (vector-blocked, for this card). What bounded the tile
// interpreter's form (one CTA per tree, each vector of a pass in turn on
// each tile, forward then reverse): every vector paid each step's table
// read, decode and dispatch twice (both sweeps) for two rows, and reloaded
// its X operands; the loss and every constant's lane sums went through
// shared memory on every tile; each call launched every tree once per
// step-count class, two of the three blocks returning at once. Now each
// thread carries grad_rows row of grad_vr vectors (all three of the
// optimizer's) through both sweeps (interp.cuh run_vec, run_vec_reverse):
// one dispatch serves the three evaluations, each X operand loads once for
// them, and the loss sums and the constants' cotangent sums stay in
// registers for the whole row walk (up to GRAD_REG_CONSTS constants),
// written to shared memory once for lane_tree_sum. One row a thread, not
// two: W threads a block at 80 registers hide the sweeps' shared-memory
// latency better than W / 2 at 128 (bench/tile_variants.py). Each vector keeps its
// own stored values and adjoint rows, so a block's shared memory grows
// with its tree times grad_vr: the plan kernel (interp.cuh
// vec_plan_kernel) sorts the trees by step count on the device, stably,
// and one launch per class, sized to it, takes exactly that class's trees
// (a wave of persistent blocks on a work counter). The last class (13 or
// more steps, or more than GRAD_REG_CONSTS constants) runs one vector at a
// time with its constants' sums in shared memory, as the tile interpreter
// did. A program that reads none of the vector's constants (nconst == 0,
// or an early-exit tree cut to one step) runs the forward sweep once: its
// loss is every vector's and its gradient is 0. A launch over fewer rows
// than half of W (a minibatch) runs a smaller block (interp.cuh vec_lanes).
// Each sum keeps the fixed lane order at the wrapper's W (interp.cuh), so
// loss, valid and gcomp are the tile interpreter's bits, and the loss
// equals kernel #2's.
//
// Loss kinds and the float64 form (sr_program_grad_f64) as kernel #2's:
// L2 and its derivative inlined, every other kind (and its JAX-order
// derivative, interp.cuh loss_vjp_of_kind) behind LOSS_ANY's run-time
// switch; the float64 form keeps values, adjoints and sums in double.
//
// What bounds it on the H100: FP32 ALU and SFU work, the forward's and the
// derivatives' instructions per (step, row) and per pair, plus the
// shared-memory traffic of the stored values and the adjoints, which stays
// per vector. X (200 KB at the bench shapes) stays in L2; device-memory
// traffic is the words, the constant vectors and the gradients.

#include "interp.cuh"

using namespace sr;

namespace {

// The blocking, chosen on the H100 (bench/tile_variants.py builds and times
// other values through these macros): rows each thread carries, vectors it
// carries in classes 0 and 1, and the blocks per SM its register cap must
// allow: one block fewer in the double form, whose registers are twice as
// wide.
#ifndef SR_GRAD_ROWS
#define SR_GRAD_ROWS 1
#endif
#ifndef SR_GRAD_VR
#define SR_GRAD_VR 3
#endif
#ifndef SR_GRAD_MIN_BLOCKS
#define SR_GRAD_MIN_BLOCKS 3
#endif

template <typename C>
__host__ __device__ constexpr int grad_rows() { return SR_GRAD_ROWS; }

template <typename C>
__host__ __device__ constexpr int grad_vr() { return SR_GRAD_VR; }

template <typename C>
__host__ __device__ constexpr int grad_min_blocks() {
  return sizeof(C) == 8 && SR_GRAD_MIN_BLOCKS > 1 ? SR_GRAD_MIN_BLOCKS - 1 : SR_GRAD_MIN_BLOCKS;
}

// A launch's arguments.
template <typename C>
struct GradParams {
  const int* instr;     // [T, L]
  const int* nsteps;    // [T]
  const int* nconst;    // [T]
  const C* cvals_v;     // [T, V, CMAX]
  const C* X;           // [F, n]
  const C* y;           // [n]
  const C* w;           // [n]
  const int* optab;     // [n_codes]
  int T, V, L, CMAX, F, n, n_grad, W, code_mask, sign_shift;
  LossSpec<C> ls;
  int* plan;            // [vec_plan_ints(T)]
  C* loss_out;          // [T, V]
  int* valid_out;       // [T, V]
  C* gcomp_out;         // [T, V, CMAX]
};

// The shared memory of class `cls`: its tables, X's rows, the stored step
// values and the adjoint rows of `vr` vectors, the G rows of sums per
// vector (the loss, then each constant; in classes 0 and 1 written after
// the row walk, over the values), the pass's constants and flags, the
// decode's scratch.
struct GradLayout {
  int mhi, nslot, vr, G;
  bool reg;
  size_t stab, rtab, sx, sval, sadj, sred, sc, sok, snext, sflag, slast, sneed, sfree, total;
};

template <typename C>
__host__ __device__ inline GradLayout grad_layout(int W, int cls, int L, int CMAX, int F) {
  const size_t csize = sizeof(C);
  GradLayout o;
  o.mhi = vec_class_cap(cls, L);
  o.reg = cls < VEC_CLASSES - 1;
  o.vr = o.reg ? grad_vr<C>() : 1;
  o.nslot = vec_slots(o.mhi, L);
  // A tree of m steps has at most m + 1 constants.
  o.G = 1 + min(CMAX, o.reg ? GRAD_REG_CONSTS : o.mhi + 1);
  const size_t vals = csize * (size_t)(o.mhi > 1 ? o.mhi - 1 : 0) * o.vr * W;
  const size_t adjs = csize * (size_t)o.nslot * o.vr * W;
  const size_t red = csize * (size_t)o.G * o.vr * W;
  o.stab = 0;                                                      // int4 [mhi] forward
  o.rtab = o.stab + 16 * (size_t)o.mhi;                            // int4 [mhi] reverse
  o.sx = align_up(o.rtab + 16 * (size_t)o.mhi, 16);                // C [F * W]
  o.sval = o.sx + csize * (size_t)F * W;                           // C [(mhi - 1) * vr * W]
  o.sadj = o.sval + vals;                                          // C [nslot * vr * W]
  o.sred = o.reg ? o.sval : o.sadj + adjs;                         // C [G * vr * W]
  o.sc = o.reg ? o.sval + (vals + adjs > red ? vals + adjs : red) : o.sred + red;
  o.sok = align_up(o.sc + csize * (size_t)(CMAX + 1) * o.vr, 4);   // int [vr]
  o.snext = o.sok + 4 * (size_t)o.vr;                              // int
  o.sflag = o.snext + 4;                                           // int [mhi]
  o.slast = o.sflag + 4 * (size_t)o.mhi;                           // int [mhi]
  o.sneed = o.slast + 4 * (size_t)o.mhi;                           // int [mhi]
  o.sfree = o.sneed + 4 * (size_t)o.mhi;                           // int [max(nslot, 1)]
  o.total = o.sfree + 4 * (size_t)(o.nslot > 0 ? o.nslot : 1);
  return o;
}

// One pass of tree t (m steps, nc constants) over every row for vectors
// v0 .. v0 + nv - 1, VRP at once (slots past nv repeat vector v0 and are
// dropped): the loss sums and, unless FWD, the constants' cotangent sums
// (REG: in registers; else in the thread's columns of the sum rows),
// reduced in the fixed lane order. FWD runs the forward sweep alone for a
// program that reads no constant (all_vectors: its loss goes to every
// vector, its gradient is 0). `last`: the tree's last pass.
template <typename C, int LOSS, int K, int VRP, bool REG, bool FWD>
__device__ __forceinline__ void grad_pass(const GradParams<C>& p, const GradLayout& lay,
                                          unsigned char* smem, int t, int m, int nc, int v0,
                                          int nv, bool all_vectors, bool last) {
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const int W = p.W, n = p.n, CMAX = p.CMAX, CS = CMAX + 1;
  const int G = 1 + nc;             // sum rows per vector: the loss, then each constant
  const int GF = FWD ? 1 : G;       // the rows this pass reduces
  const int4* stab = reinterpret_cast<const int4*>(smem + lay.stab);
  const int4* rtab = reinterpret_cast<const int4*>(smem + lay.rtab);
  C* sc = reinterpret_cast<C*>(smem + lay.sc);
  int* sok = reinterpret_cast<int*>(smem + lay.sok);
  C* sred = reinterpret_cast<C*>(smem + lay.sred);
  const C* cv_t = p.cvals_v + (size_t)t * p.V * CMAX;
  for (int i = tid; i < CS * VRP; i += P) {
    const int c = i / VRP, j = i - c * VRP;
    const int v = v0 + (j < nv ? j : 0);
    sc[i] = c < CMAX ? cv_t[(size_t)v * CMAX + c] : C(0);
  }
  for (int j = tid; j < VRP; j += P) sok[j] = 1;
  if (!REG && !FWD) {
    for (int i = tid; i < VRP * G * W; i += P) sred[i] = C(0);
  }
  __syncthreads();

  C* colx = reinterpret_cast<C*>(smem + lay.sx) + K * tid;
  C* colv = reinterpret_cast<C*>(smem + lay.sval) + K * tid;
  C* colad = reinterpret_cast<C*>(smem + lay.sadj) + K * tid;
  C* gsm = sred + K * tid;
  const int adj_stride = lay.vr * W;
  const bool vec_x = n % K == 0 && reinterpret_cast<uintptr_t>(p.X) % sizeof(RowPack<C, K>) == 0;
  const bool vec_yw = n % K == 0 && reinterpret_cast<uintptr_t>(p.y) % sizeof(RowPack<C, K>) == 0
                      && reinterpret_cast<uintptr_t>(p.w) % sizeof(RowPack<C, K>) == 0;
  C lsum[VRP][K];
  C g[GRAD_REG_CONSTS][VRP][K];
  bool ok[VRP];
#pragma unroll
  for (int j = 0; j < VRP; ++j) {
    ok[j] = true;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lsum[j][k] = C(0);
#pragma unroll
      for (int q = 0; q < GRAD_REG_CONSTS; ++q) g[q][j][k] = C(0);
    }
  }
  for (int r0 = 0; r0 < n; r0 += W) {
    const int r = r0 + K * tid;
    if (r >= n) break;   // no rows left for this thread; no barrier in the row walk
    const int live = min(K, n - r);
    // the rows whose constants' cotangents count: those before n_grad
    const int glive = max(0, min(live, p.n_grad - r));
    const RowPack<C, K> yk = load_rows<C, K>(p.y, r, n, vec_yw, C(0));
    const RowPack<C, K> wk = load_rows<C, K>(p.w, r, n, vec_yw, C(0));
    for (int f0 = 0; f0 < p.F; f0 += TILE_LOADS) {
      RowPack<C, K> xs[TILE_LOADS];
#pragma unroll
      for (int q = 0; q < TILE_LOADS; ++q) {
        if (f0 + q < p.F) xs[q] = load_rows<C, K>(p.X + (size_t)(f0 + q) * n, r, n, vec_x, C(0));
      }
#pragma unroll
      for (int q = 0; q < TILE_LOADS; ++q) {
        if (f0 + q < p.F) *reinterpret_cast<RowPack<C, K>*>(colx + (f0 + q) * W) = xs[q];
      }
    }
    C root[VRP][K], chk[VRP][K], ct[VRP][K];
    run_vec<C, K, VRP>(stab, m, colx, colv, W, sc, root, chk);
#pragma unroll
    for (int j = 0; j < VRP; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < live) {
          lsum[j][k] = rn_add(lsum[j][k], loss_term<LOSS>(p.ls, root[j][k], yk.v[k], wk.v[k]));
          ok[j] = ok[j] && chk[j][k] == C(0);
        }
        if (!FWD) {
          const C dpred = loss_vjp<LOSS>(p.ls, root[j][k], yk.v[k], wk.v[k]);
          ct[j][k] = wk.v[k] > C(0) ? dpred : C(0);
        }
      }
    }
    if (!FWD) {
      run_vec_reverse<K, VRP, REG>(rtab, m, colx, colv, colad, adj_stride, sc, gsm, G, g, W,
                                   glive, ct);
    }
  }
#pragma unroll
  for (int j = 0; j < VRP; ++j) {
    if (!ok[j]) sok[j] = 0;
  }
  __syncthreads();   // the walk is done: the register sums take their rows
#pragma unroll
  for (int j = 0; j < VRP; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      gsm[(j * GF) * W + k] = lsum[j][k];
      if (REG && !FWD) {
#pragma unroll
        for (int q = 0; q < GRAD_REG_CONSTS; ++q) {
          if (q < nc) gsm[(j * G + 1 + q) * W + k] = g[q][j][k];
        }
      }
    }
  }
  __syncthreads();
  lane_tree_sum(sred, W, nv * GF, n);
  const int nout = all_vectors ? p.V : nv;
  for (int i = tid; i < nout; i += P) {
    const int j = all_vectors ? 0 : i;
    const C total = sred[(size_t)j * GF * W];
    const size_t pair = (size_t)t * p.V + v0 + i;
    p.loss_out[pair] = total;
    p.valid_out[pair] = (sok[j] != 0 && isfinite(total)) ? 1 : 0;
  }
  for (int i = tid; i < nout * CMAX; i += P) {
    const int c = i / CMAX, q = i - c * CMAX;
    const int j = all_vectors ? 0 : c;
    p.gcomp_out[((size_t)t * p.V + v0 + c) * CMAX + q] =
        (!FWD && q < nc) ? sred[((size_t)j * G + 1 + q) * W] : C(0);
  }
  // Another pass refills the constants and flags the lines above read; the
  // next tree's decode barriers come before anything they read is written.
  if (!last) __syncthreads();
}

// One class's launch: each block takes the class's trees in plan order.
template <typename C, int LOSS>
__global__ void __launch_bounds__(TILE_MAX_W / grad_rows<C>(), grad_min_blocks<C>())
program_grad_kernel(const GradParams<C> p, int cls) {
  extern __shared__ __align__(16) unsigned char smem[];
  const GradLayout lay = grad_layout<C>(p.W, cls, p.L, p.CMAX, p.F);
  if (vec_class_empty(p.plan, p.T, cls)) return;
  int reserved = vec_reserve(p.plan, p.T, cls);
  for (;;) {
    const int t = vec_next_tree(p.plan, p.T, cls, reinterpret_cast<int*>(smem + lay.snext),
                                reserved);
    if (t < 0) return;
    const int m = min(p.nsteps[t], p.L);
    const int nc = min(max(p.nconst[t], 0), p.CMAX);
    // the plan put the tree in another class, or more constants than m steps have
    if (m > lay.mhi || 1 + nc > lay.G) __trap();
    const bool reads = decode_grad_vec(
        p.instr + (size_t)t * p.L, m, p.optab, p.code_mask, p.sign_shift, p.F, p.CMAX, p.L, p.W,
        lay.vr, nc, lay.nslot, reinterpret_cast<int*>(smem + lay.sflag),
        reinterpret_cast<int*>(smem + lay.slast), reinterpret_cast<int*>(smem + lay.sneed),
        reinterpret_cast<int*>(smem + lay.sfree), reinterpret_cast<int4*>(smem + lay.stab),
        reinterpret_cast<int4*>(smem + lay.rtab));
    if (!reads) {
      grad_pass<C, LOSS, grad_rows<C>(), 1, false, true>(p, lay, smem, t, m, nc, 0, 1, true,
                                                        true);
    } else if (lay.reg) {
      constexpr int VR = grad_vr<C>();
      for (int v0 = 0; v0 < p.V; v0 += VR) {
        grad_pass<C, LOSS, grad_rows<C>(), VR, true, false>(p, lay, smem, t, m, nc, v0,
                                                           min(VR, p.V - v0), false,
                                                           v0 + VR >= p.V);
      }
    } else {
      for (int v0 = 0; v0 < p.V; ++v0) {
        grad_pass<C, LOSS, grad_rows<C>(), 1, false, false>(p, lay, smem, t, m, nc, v0, 1, false,
                                                           v0 + 1 >= p.V);
      }
    }
  }
}

// Each class launch's (largest step count, threads, shared memory bytes,
// active blocks per SM, blocks, vectors a thread carries, most constants
// of its trees), out [VEC_CLASSES][7]; or the error of the first class
// that cannot run.
template <typename C, int LOSS>
cudaError_t grad_classes(int T, int n, int W, int L, int CMAX, int F, int* out) {
  constexpr int K = grad_rows<C>();
  if (W % K != 0 || W > TILE_MAX_W || (W & (W - 1)) != 0) return cudaErrorInvalidValue;
  auto kern = program_grad_kernel<C, LOSS>;
  const int threads = vec_lanes(W, n, K) / K;
  for (int cls = 0; cls < VEC_CLASSES; ++cls) {
    const GradLayout lay = grad_layout<C>(W, cls, L, CMAX, F);
    if (lay.total > kSmemLimit) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)lay.total);
    int grid = 0, per_sm = 0;
    if (err == cudaSuccess) err = vec_grid(kern, threads, lay.total, T, &grid, &per_sm);
    if (err != cudaSuccess) return err;
    int* o = out + 7 * cls;
    o[0] = lay.mhi;
    o[1] = threads;
    o[2] = (int)lay.total;
    o[3] = per_sm;
    o[4] = grid;
    o[5] = lay.vr;
    o[6] = lay.G - 1;
  }
  return cudaSuccess;
}

template <typename C, int LOSS>
cudaError_t launch_grad(const GradParams<C>& p, cudaStream_t stream) {
  int cfg[7 * VEC_CLASSES];
  cudaError_t err = grad_classes<C, LOSS>(p.T, p.n, p.W, p.L, p.CMAX, p.F, cfg);
  if (err == cudaSuccess) {
    err = launch_vec_plan(p.nsteps, p.nconst, p.T, p.L, GRAD_REG_CONSTS, p.plan, stream);
  }
  if (err != cudaSuccess) return err;
  auto kern = program_grad_kernel<C, LOSS>;
  for (int cls = 0; cls < VEC_CLASSES; ++cls) {
    const int* o = cfg + 7 * cls;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, o[2]);
    if (err != cudaSuccess) return err;
    kern<<<o[4], o[1], o[2], stream>>>(p, cls);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename C>
int grad_entry(const int* instr, const int* nsteps, const int* nconst, const C* cvals_v,
               const C* X, const C* y, const C* w, const int* optab, int T, int V, int L,
               int CMAX, int F, int n, int n_grad, int block, int loss_kind, double loss_param,
               int code_mask, int sign_shift, C* loss, int* valid, C* gcomp, int* plan,
               void* stream) {
  if ((long long)T * V == 0) return 0;
  if (loss_kind < LOSS_L2 || loss_kind > LOSS_PERIODIC_L2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const GradParams<C> p{instr, nsteps, nconst, cvals_v, X, y, w, optab, T, V, L, CMAX, F, n,
                        n_grad, block, code_mask, sign_shift,
                        LossSpec<C>{loss_kind, (C)loss_param}, plan, loss, valid, gcomp};
  if (loss_kind == LOSS_L2) return (int)launch_grad<C, LOSS_L2>(p, s);
  return (int)launch_grad<C, LOSS_ANY>(p, s);
}

template <typename C>
size_t grad_row_smem(int block, int L, int CMAX, int F) {
  const size_t rows = (size_t)(F + L) + (F + CMAX + L + 1) + CMAX;
  return sizeof(C) * (rows * block + CMAX + block) + sizeof(int) * L;
}

}  // namespace

// Shared memory of the per-row layout with `block` threads ((F + L) value
// rows, (F + CMAX + L + 1) adjoint rows and CMAX gradient rows of one value
// per thread, the constants, one reduction value per thread, the words):
// the wrapper's `_block` picks the lane count W as the largest block whose
// per-row layout fits, as it did when the kernel ran that layout, so W, and
// with it every sum's order, stays as it was (and equal to kernel #2's at
// the same shapes).
extern "C" size_t sr_program_grad_smem(int block, int L, int CMAX, int F) {
  return grad_row_smem<float>(block, L, CMAX, F);
}

// The same for the float64 form (values of 8 bytes).
extern "C" size_t sr_program_grad_f64_smem(int block, int L, int CMAX, int F) {
  return grad_row_smem<double>(block, L, CMAX, F);
}

// Ints of a call's `plan` buffer for T trees (the class lists; interp.cuh
// vec_plan_kernel), which the wrapper allocates.
extern "C" int sr_program_grad_plan_ints(int T) { return vec_plan_ints(T); }

// Each class launch's (largest step count, threads, shared memory bytes,
// active blocks per SM, blocks, vectors a thread carries, most constants
// of its trees) into out [3][7] for T trees over n rows at W = `block`
// lanes, in float (f64 = 0) or double, the L2 (loss_any = 0) or LOSS_ANY
// instantiation. Returns 0 or the CUDA error.
extern "C" int sr_program_grad_classes(int f64, int loss_any, int T, int n, int block, int L,
                                       int CMAX, int F, int* out) {
  if (f64) {
    return (int)(loss_any ? grad_classes<double, LOSS_ANY>(T, n, block, L, CMAX, F, out)
                          : grad_classes<double, LOSS_L2>(T, n, block, L, CMAX, F, out));
  }
  return (int)(loss_any ? grad_classes<float, LOSS_ANY>(T, n, block, L, CMAX, F, out)
                        : grad_classes<float, LOSS_L2>(T, n, block, L, CMAX, F, out));
}

// Launch on `stream` with W = `block` lanes (W / grad_rows threads a
// block): the plan kernel, then one launch per step-count class; returns
// cudaGetLastError() (0 on success). `plan` is scratch of
// sr_program_grad_plan_ints(T) ints, `loss_kind` one of the LOSS_* kinds,
// `loss_param` its parameter (interp.cuh LossSpec). The gradient sums the
// constants' cotangents of rows 0 .. n_grad - 1 only (n_grad <= n: the wrapper passes
// the rows up to the last one of positive weight), so zero-weight rows
// appended to a request (pack/padding.py) leave every bit of it as it was,
// even where a row's derivative is not finite (0 x inf); the loss and the
// validity read all n rows.
extern "C" int sr_program_grad(const int* instr, const int* nsteps, const int* nconst,
                               const float* cvals_v, const float* X, const float* y,
                               const float* w, const int* optab, int T, int V, int L,
                               int CMAX, int F, int n, int n_grad, int block, int loss_kind,
                               double loss_param, int code_mask, int sign_shift, float* loss,
                               int* valid, float* gcomp, int* plan, void* stream) {
  return grad_entry<float>(instr, nsteps, nconst, cvals_v, X, y, w, optab, T, V, L, CMAX, F, n,
                           n_grad, block, loss_kind, loss_param, code_mask, sign_shift, loss,
                           valid, gcomp, plan, stream);
}

// The float64 form: every input, output, value, adjoint and sum in double.
extern "C" int sr_program_grad_f64(const int* instr, const int* nsteps, const int* nconst,
                                   const double* cvals_v, const double* X, const double* y,
                                   const double* w, const int* optab, int T, int V, int L,
                                   int CMAX, int F, int n, int n_grad, int block, int loss_kind,
                                   double loss_param, int code_mask, int sign_shift,
                                   double* loss, int* valid, double* gcomp, int* plan,
                                   void* stream) {
  return grad_entry<double>(instr, nsteps, nconst, cvals_v, X, y, w, optab, T, V, L, CMAX, F,
                            n, n_grad, block, loss_kind, loss_param, code_mask, sign_shift, loss,
                            valid, gcomp, plan, stream);
}
