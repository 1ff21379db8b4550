// Multi-variant program kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_multi_kernel` / `fused_loss_multi` in
// symbolicregression_jl_tpu/ops/fused_eval.py (Pallas). For every pair of
// a tree t and one of its V constant vectors v it runs the tree's packed
// program over every row and reduces the elementwise loss:
//
//   loss_sum[t, v] = sum_r where(w_r > 0, elt_r, 0) * w_r,
//   valid[t, v]    = every step finite on every row AND isfinite(loss_sum).
//
// The constant optimizer's line search calls it once per L-BFGS
// iteration with all R*C candidate steps of every selected member as the
// variants (constant validity, the mean and the inf mapping are applied
// by the wrapper, ops/fused_eval.py `fused_loss_multi`).
//
// Design (vector-blocked, for this card). What bounded the tile
// interpreter's form (one CTA per tree running each vector of a pass in
// turn on each tile, K = 4 rows a thread): every vector paid the step's
// table read, operand decode and operator dispatch, and reloaded each X
// operand from shared memory, for 4 rows, several times the work of + - *;
// each vector's lane sums went through shared memory on every tile; every
// block was sized for the longest program's held rows (about 23 KB at the
// bench shapes, 18 warps per SM). Now each thread carries MULTI_ROWS rows of
// multi_vr vectors through each step (interp.cuh run_vec): one dispatch
// and one X load serve 16 evaluations (8 for the double forms, whose
// registers are twice as wide). The (lane, vector) sums stay in registers
// for the whole row walk and go to shared memory once, for lane_tree_sum.
// A program that reads none of the vector's constants (nconst == 0, or an
// early-exit tree cut to one step) runs one pass and its loss goes to all
// V. Each call runs a plan kernel that partitions the trees by step count
// on the device (interp.cuh vec_plan_kernel), then one launch per class,
// each sized to its class's held rows and run as a wave of persistent
// blocks that take the class's trees from a counter; over fewer rows than
// half of W (a minibatch), with smaller blocks (interp.cuh vec_lanes).
// Every output keeps the fixed lane order at the wrapper's W (interp.cuh),
// so the bits are the tile interpreter's: #2 with V = 1 equals #1's plain
// form, #3's loss equals #2's, and two launches agree.
//
// bf16 form (2b: sr_program_multi_bf16; the TPU kernel's `bf16=True`
// variant, graftstage's optimizer_bf16_linesearch): the same over a
// bfloat16 value buffer, as kernel 1b runs it. X arrives as bf16, each
// vector's constants round to bf16 as the block loads them, steps compute
// in float and store rounded; the loss and its row sum stay float.
//
// Loss kinds, the float64 form (sr_program_multi_f64) and 2b's float64 and
// bf16 loss spines (sr_program_multi_bf16_f64, sr_program_multi_bf16_data)
// as kernel #1's (program_eval.cu): L2 inlined, every other kind behind
// LOSS_ANY's run-time switch; double storage computes in double.
//
// What bounds it on the H100. Like kernel #1 it is FP32 ALU and SFU work,
// (steps x rows) operator evaluations per pair, plus a few instructions per
// (step, row) around each operator: the chk FMA, the rounding to the
// storage type, the operand moves. X (200 KB at the bench shapes) stays in
// L2 and each tree reads it ceil(V / multi_vr) times; device-memory traffic
// is the words and the constant vectors.

#include "interp.cuh"

using namespace sr;

namespace {

// The blocking, chosen on the H100 (bench/tile_variants.py builds and times
// other values through these macros): rows and vectors a thread carries,
// and the blocks per SM its register cap must allow (65536 registers /
// (threads x blocks)). Where the steps or the loss spine are double, half
// the vectors and half the blocks: a double takes two registers.
#ifndef SR_MULTI_ROWS
#define SR_MULTI_ROWS 2
#endif
#ifndef SR_MULTI_VR
#define SR_MULTI_VR 8
#endif
#ifndef SR_MULTI_MIN_BLOCKS
#define SR_MULTI_MIN_BLOCKS 4
#endif
constexpr int MULTI_ROWS = SR_MULTI_ROWS;

template <typename S, typename A>
__host__ __device__ constexpr bool multi_wide() {
  return sizeof(CT<S>) == 8 || sizeof(CT<A>) == 8;
}

template <typename S, typename A>
__host__ __device__ constexpr int multi_vr() {
  return multi_wide<S, A>() && SR_MULTI_VR > 1 ? SR_MULTI_VR / 2 : SR_MULTI_VR;
}

template <typename S, typename A>
__host__ __device__ constexpr int multi_min_blocks() {
  return multi_wide<S, A>() && SR_MULTI_MIN_BLOCKS > 1 ? SR_MULTI_MIN_BLOCKS / 2
                                                       : SR_MULTI_MIN_BLOCKS;
}

// A launch's arguments (D = CT<A>, the loss spine's compute type).
template <typename S, typename A>
struct MultiParams {
  const int* instr;       // [T, L]
  const int* nsteps;      // [T]
  const CT<A>* cvals_v;   // [T, V, CMAX]
  const S* X;             // [F, n]
  const CT<A>* y;         // [n]
  const CT<A>* w;         // [n]
  const int* optab;       // [n_codes]
  int T, V, L, CMAX, F, n, W, code_mask, sign_shift;
  LossSpec<CT<A>> ls;
  int* plan;              // [vec_plan_ints(T)]
  CT<A>* loss_out;        // [T, V]
  int* valid_out;         // [T, V]
};

// Byte offsets of a class's dynamic shared memory: the table, X's rows, the
// held rows of VR vectors (after the row walk: the VR rows of lane sums),
// the pass's constants and flags, the decode's scratch.
struct MultiLayout {
  int nslot;
  size_t stab, sx, sh, sc, sok, snext, sflag, slast, sfree, total;
};

template <typename S, typename A>
__host__ __device__ inline MultiLayout multi_layout(int W, int mhi, int L, int CMAX, int F) {
  constexpr int VR = multi_vr<S, A>();
  MultiLayout o;
  o.nslot = vec_slots(mhi, L);
  const size_t held = sizeof(S) * (size_t)o.nslot * VR * W;
  const size_t sums = sizeof(CT<A>) * (size_t)VR * W;
  o.stab = 0;                                                        // int4 [mhi]
  o.sx = align_up(16 * (size_t)mhi, 16);                             // S [F * W]
  o.sh = align_up(o.sx + sizeof(S) * (size_t)F * W, 16);             // S [nslot * VR * W]
  o.sc = o.sh + (held > sums ? held : sums);                         // S [(CMAX + 1) * VR]
  o.sok = align_up(o.sc + sizeof(S) * (size_t)(CMAX + 1) * VR, 4);   // int [VR]
  o.snext = o.sok + 4 * (size_t)VR;                                  // int
  o.sflag = o.snext + 4;                                             // int [mhi]
  o.slast = o.sflag + 4 * (size_t)mhi;                               // int [mhi]
  o.sfree = o.slast + 4 * (size_t)mhi;                               // int [max(nslot, 1)]
  o.total = o.sfree + 4 * (size_t)(o.nslot > 0 ? o.nslot : 1);
  return o;
}

// One pass of tree t over every row for vectors v0 .. v0 + nv - 1 (VRP at
// once; slots past nv repeat vector v0 and are dropped): the lane sums of
// each, reduced in the fixed lane order. With `all_vectors` (a program that
// reads no constant, run for vector 0) the result goes to every vector;
// `last`: the tree's last pass.
template <typename S, typename A, int LOSS, int K, int VRP>
__device__ __forceinline__ void multi_pass(const MultiParams<S, A>& p, const MultiLayout& lay,
                                           unsigned char* smem, int t, int m, int v0, int nv,
                                           bool all_vectors, bool last) {
  typedef CT<S> C;
  typedef CT<A> D;
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const int W = p.W, n = p.n, CS = p.CMAX + 1;
  const int4* stab = reinterpret_cast<const int4*>(smem + lay.stab);
  S* sc = reinterpret_cast<S*>(smem + lay.sc);
  int* sok = reinterpret_cast<int*>(smem + lay.sok);
  const D* cv_t = p.cvals_v + (size_t)t * p.V * p.CMAX;
  for (int i = tid; i < CS * VRP; i += P) {
    const int c = i / VRP, j = i - c * VRP;
    const int v = v0 + (j < nv ? j : 0);
    sc[i] = from_c<S>(c < p.CMAX ? (C)cv_t[(size_t)v * p.CMAX + c] : C(0));
  }
  for (int j = tid; j < VRP; j += P) sok[j] = 1;
  __syncthreads();

  S* colx = reinterpret_cast<S*>(smem + lay.sx) + K * tid;
  S* colh = reinterpret_cast<S*>(smem + lay.sh) + K * tid;
  const bool vec_x = n % K == 0 && reinterpret_cast<uintptr_t>(p.X) % sizeof(RowPack<S, K>) == 0;
  const bool vec_yw = n % K == 0 && reinterpret_cast<uintptr_t>(p.y) % sizeof(RowPack<D, K>) == 0
                      && reinterpret_cast<uintptr_t>(p.w) % sizeof(RowPack<D, K>) == 0;
  D acc[VRP][K];
  bool ok[VRP];
#pragma unroll
  for (int j = 0; j < VRP; ++j) {
    ok[j] = true;
#pragma unroll
    for (int k = 0; k < K; ++k) acc[j][k] = D(0);
  }
  for (int r0 = 0; r0 < n; r0 += W) {
    const int r = r0 + K * tid;
    if (r >= n) break;   // no rows left for this thread; no barrier in the row walk
    const RowPack<D, K> yk = load_rows<D, K>(p.y, r, n, vec_yw, D(0));
    const RowPack<D, K> wk = load_rows<D, K>(p.w, r, n, vec_yw, D(0));
    for (int f0 = 0; f0 < p.F; f0 += TILE_LOADS) {
      RowPack<S, K> xs[TILE_LOADS];
#pragma unroll
      for (int q = 0; q < TILE_LOADS; ++q) {
        if (f0 + q < p.F) xs[q] = load_rows<S, K>(p.X + (size_t)(f0 + q) * n, r, n, vec_x,
                                                  from_c<S>(C(0)));
      }
#pragma unroll
      for (int q = 0; q < TILE_LOADS; ++q) {
        if (f0 + q < p.F) *reinterpret_cast<RowPack<S, K>*>(colx + (f0 + q) * W) = xs[q];
      }
    }
    C root[VRP][K], chk[VRP][K];
    run_vec<S, K, VRP>(stab, m, colx, colh, W, sc, root, chk);
#pragma unroll
    for (int j = 0; j < VRP; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (r + k < n) {
          const D term = round_to<A>(loss_term<LOSS>(p.ls, (D)root[j][k], yk.v[k], wk.v[k]));
          acc[j][k] = rn_add(acc[j][k], term);
          ok[j] = ok[j] && chk[j][k] == C(0);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VRP; ++j) {
    if (!ok[j]) sok[j] = 0;
  }
  __syncthreads();   // the held rows are free: the lane sums take their place
  D* ssum = reinterpret_cast<D*>(smem + lay.sh);
#pragma unroll
  for (int j = 0; j < VRP; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) ssum[j * W + K * tid + k] = acc[j][k];
  }
  __syncthreads();
  lane_tree_sum(ssum, W, nv, n);
  const int nout = all_vectors ? p.V : nv;
  for (int i = tid; i < nout; i += P) {
    const int j = all_vectors ? 0 : i;
    const D total = round_to<A>(ssum[j * W]);
    const size_t pair = (size_t)t * p.V + v0 + i;
    p.loss_out[pair] = total;
    p.valid_out[pair] = (sok[j] != 0 && isfinite(total)) ? 1 : 0;
  }
  // Another pass refills the constants and flags the lines above read; the
  // next tree's decode barriers come before anything they read is written.
  if (!last) __syncthreads();
}

// One class's launch: each block takes the class's trees in plan order and
// runs each in passes of multi_vr vectors (one pass for a program that
// reads no constant).
template <typename S, typename A, int LOSS>
__global__ void __launch_bounds__(TILE_MAX_W / MULTI_ROWS, (multi_min_blocks<S, A>()))
program_multi_kernel(const MultiParams<S, A> p, int cls, int mhi) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VR = multi_vr<S, A>();
  const MultiLayout lay = multi_layout<S, A>(p.W, mhi, p.L, p.CMAX, p.F);
  if (vec_class_empty(p.plan, p.T, cls)) return;
  int reserved = vec_reserve(p.plan, p.T, cls);
  for (;;) {
    const int t = vec_next_tree(p.plan, p.T, cls, reinterpret_cast<int*>(smem + lay.snext),
                                reserved);
    if (t < 0) return;
    const int m = min(p.nsteps[t], p.L);
    if (m > mhi) __trap();   // the plan put the tree in another class
    const bool reads = decode_vec_program(
        p.instr + (size_t)t * p.L, m, p.optab, p.code_mask, p.sign_shift, p.F, p.CMAX, p.L, p.W,
        VR, lay.nslot, reinterpret_cast<int*>(smem + lay.sflag),
        reinterpret_cast<int*>(smem + lay.slast), reinterpret_cast<int*>(smem + lay.sfree),
        reinterpret_cast<int4*>(smem + lay.stab));
    // A program that reads no constant: one pass, its result every vector's.
    const int nvec = reads ? p.V : 1;
    for (int v0 = 0; v0 < nvec; v0 += VR) {
      multi_pass<S, A, LOSS, MULTI_ROWS, VR>(p, lay, smem, t, m, v0, min(VR, nvec - v0), !reads,
                                             v0 + VR >= nvec);
    }
  }
}

// Each class launch's (largest step count, threads, shared memory bytes,
// active blocks per SM, blocks), out [VEC_CLASSES][5]; or the error of the
// first class that cannot run.
template <typename S, typename A, int LOSS>
cudaError_t multi_classes(int T, int n, int W, int L, int CMAX, int F, int* out) {
  if (W % MULTI_ROWS != 0 || W > TILE_MAX_W || (W & (W - 1)) != 0) return cudaErrorInvalidValue;
  auto kern = program_multi_kernel<S, A, LOSS>;
  const int threads = vec_lanes(W, n, MULTI_ROWS) / MULTI_ROWS;
  for (int cls = 0; cls < VEC_CLASSES; ++cls) {
    const int mhi = vec_class_cap(cls, L);
    const size_t smem = multi_layout<S, A>(W, mhi, L, CMAX, F).total;
    if (smem > kSmemLimit) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    int grid = 0, per_sm = 0;
    if (err == cudaSuccess) err = vec_grid(kern, threads, smem, T, &grid, &per_sm);
    if (err != cudaSuccess) return err;
    int* o = out + 5 * cls;
    o[0] = mhi;
    o[1] = threads;
    o[2] = (int)smem;
    o[3] = per_sm;
    o[4] = grid;
  }
  return cudaSuccess;
}

template <typename S, typename A, int LOSS>
cudaError_t launch_multi(const MultiParams<S, A>& p, cudaStream_t stream) {
  int cfg[5 * VEC_CLASSES];
  cudaError_t err = multi_classes<S, A, LOSS>(p.T, p.n, p.W, p.L, p.CMAX, p.F, cfg);
  if (err == cudaSuccess) err = launch_vec_plan(p.nsteps, nullptr, p.T, p.L, -1, p.plan, stream);
  if (err != cudaSuccess) return err;
  auto kern = program_multi_kernel<S, A, LOSS>;
  for (int cls = 0; cls < VEC_CLASSES; ++cls) {
    const int* o = cfg + 5 * cls;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, o[2]);
    if (err != cudaSuccess) return err;
    kern<<<o[4], o[1], o[2], stream>>>(p, cls, o[0]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The per-row layout's shared memory with `block` threads (see
// sr_program_multi_smem).
template <typename S>
size_t row_layout_smem(int block, int L, int CMAX, int F) {
  return sizeof(S) * padded<S>((size_t)(F + L) * block + CMAX) +
         sizeof(typename Compute<S>::type) * block + sizeof(int) * L;
}

// S is the value buffer's storage, A the loss spine's type (interp.cuh
// round_to).
template <typename S, typename A = CT<S>, typename C = CT<A>>
int multi_entry(const int* instr, const int* nsteps, const C* cvals_v, const S* X,
                const C* y, const C* w, const int* optab, int T, int V, int L,
                int CMAX, int F, int n, int W, int loss_kind, double loss_param, int code_mask,
                int sign_shift, C* loss, int* valid, int* plan, void* stream) {
  if ((long long)T * V == 0) return 0;
  if (loss_kind < LOSS_L2 || loss_kind > LOSS_PERIODIC_L2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const MultiParams<S, A> p{instr, nsteps, cvals_v, X, y, w, optab, T, V, L, CMAX, F, n, W,
                            code_mask, sign_shift, LossSpec<C>{loss_kind, (C)loss_param}, plan,
                            loss, valid};
  if (loss_kind == LOSS_L2) return (int)launch_multi<S, A, LOSS_L2>(p, s);
  return (int)launch_multi<S, A, LOSS_ANY>(p, s);
}

template <typename S, typename A>
int classes_of(int loss_any, int T, int n, int W, int L, int CMAX, int F, int* out) {
  return (int)(loss_any ? multi_classes<S, A, LOSS_ANY>(T, n, W, L, CMAX, F, out)
                        : multi_classes<S, A, LOSS_L2>(T, n, W, L, CMAX, F, out));
}

}  // namespace

// Shared memory of the per-row layout with `block` threads ((F + L) values
// per thread, the constants, one reduction value per thread, the words):
// the wrapper's `_block` picks the lane count W as the largest block whose
// per-row layout fits, as it did when the kernel ran that layout, so W,
// and with it every sum's order, stays as it was (and equal to kernel #1's
// and #3's at the same shapes). `esize` is the buffer's element size (4:
// float, 2: bf16, 8: double).
extern "C" size_t sr_program_multi_smem(int block, int L, int CMAX, int F, int esize) {
  return esize == 2   ? row_layout_smem<__nv_bfloat16>(block, L, CMAX, F)
         : esize == 8 ? row_layout_smem<double>(block, L, CMAX, F)
                      : row_layout_smem<float>(block, L, CMAX, F);
}

// Ints of a call's `plan` buffer for T trees (the class lists; interp.cuh
// vec_plan_kernel), which the wrapper allocates.
extern "C" int sr_program_multi_plan_ints(int T) { return vec_plan_ints(T); }

// Each class launch's (largest step count, threads, shared memory bytes,
// active blocks per SM, blocks) into out [3][5] for T trees over n rows at
// W = `block` lanes: `form` 0 float, 1 bf16 (2b), 2 double, 3 2b's float64
// spine, 4 2b's bf16 spine; `loss_any` the LOSS_ANY instantiation. Returns
// 0 or the CUDA error.
extern "C" int sr_program_multi_classes(int form, int loss_any, int T, int n, int block, int L,
                                        int CMAX, int F, int* out) {
  switch (form) {
    case 0: return classes_of<float, float>(loss_any, T, n, block, L, CMAX, F, out);
    case 1: return classes_of<__nv_bfloat16, float>(loss_any, T, n, block, L, CMAX, F, out);
    case 2: return classes_of<double, double>(loss_any, T, n, block, L, CMAX, F, out);
    case 3: return classes_of<__nv_bfloat16, double>(loss_any, T, n, block, L, CMAX, F, out);
    case 4:
      return classes_of<__nv_bfloat16, __nv_bfloat16>(loss_any, T, n, block, L, CMAX, F, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch on `stream` with W = `block` lanes (W / MULTI_ROWS threads a
// block): the plan kernel, then one launch per step-count class; returns
// cudaGetLastError() (0 on success). `loss_kind` is one of the LOSS_*
// kinds, `loss_param` its parameter (interp.cuh LossSpec); `plan` is
// scratch of sr_program_multi_plan_ints(T) ints.
extern "C" int sr_program_multi(const int* instr, const int* nsteps,
                                const float* cvals_v, const float* X,
                                const float* y, const float* w, const int* optab,
                                int T, int V, int L, int CMAX, int F, int n,
                                int block, int loss_kind, double loss_param, int code_mask,
                                int sign_shift, float* loss, int* valid, int* plan,
                                void* stream) {
  return multi_entry<float>(instr, nsteps, cvals_v, X, y, w, optab, T, V, L, CMAX, F, n,
                            block, loss_kind, loss_param, code_mask, sign_shift, loss, valid,
                            plan, stream);
}

// Kernel 2b: the same over a bf16 value buffer; X is [F, n] bf16.
extern "C" int sr_program_multi_bf16(const int* instr, const int* nsteps,
                                     const float* cvals_v, const __nv_bfloat16* X,
                                     const float* y, const float* w, const int* optab,
                                     int T, int V, int L, int CMAX, int F, int n,
                                     int block, int loss_kind, double loss_param,
                                     int code_mask, int sign_shift, float* loss, int* valid,
                                     int* plan, void* stream) {
  return multi_entry<__nv_bfloat16>(instr, nsteps, cvals_v, X, y, w, optab, T, V, L, CMAX, F,
                                    n, block, loss_kind, loss_param, code_mask, sign_shift,
                                    loss, valid, plan, stream);
}

// The float64 form: every input, output and step in double.
extern "C" int sr_program_multi_f64(const int* instr, const int* nsteps,
                                    const double* cvals_v, const double* X,
                                    const double* y, const double* w, const int* optab,
                                    int T, int V, int L, int CMAX, int F, int n,
                                    int block, int loss_kind, double loss_param,
                                    int code_mask, int sign_shift, double* loss, int* valid,
                                    int* plan, void* stream) {
  return multi_entry<double>(instr, nsteps, cvals_v, X, y, w, optab, T, V, L, CMAX, F, n,
                             block, loss_kind, loss_param, code_mask, sign_shift, loss, valid,
                             plan, stream);
}

// Kernel 2b for float64 data (optimizer_bf16_linesearch under
// jax_enable_x64): a bf16 value buffer with float steps, each vector's
// constants rounded to bf16 through float, and y, w, the loss and its sums
// in double (program_eval.cu sr_program_eval_bf16_f64).
extern "C" int sr_program_multi_bf16_f64(const int* instr, const int* nsteps,
                                         const double* cvals_v, const __nv_bfloat16* X,
                                         const double* y, const double* w, const int* optab,
                                         int T, int V, int L, int CMAX, int F, int n, int block,
                                         int loss_kind, double loss_param, int code_mask,
                                         int sign_shift, double* loss, int* valid, int* plan,
                                         void* stream) {
  return multi_entry<__nv_bfloat16, double>(instr, nsteps, cvals_v, X, y, w, optab, T, V, L,
                                            CMAX, F, n, block, loss_kind, loss_param, code_mask,
                                            sign_shift, loss, valid, plan, stream);
}

// Kernel 2b for bf16 data (eval_dtype="bfloat16"): the loss terms and the
// sums rounded to bf16 (program_eval.cu sr_program_eval_bf16_data).
extern "C" int sr_program_multi_bf16_data(const int* instr, const int* nsteps,
                                          const float* cvals_v, const __nv_bfloat16* X,
                                          const float* y, const float* w, const int* optab,
                                          int T, int V, int L, int CMAX, int F, int n, int block,
                                          int loss_kind, double loss_param, int code_mask,
                                          int sign_shift, float* loss, int* valid, int* plan,
                                          void* stream) {
  return multi_entry<__nv_bfloat16, __nv_bfloat16>(instr, nsteps, cvals_v, X, y, w, optab, T, V,
                                                   L, CMAX, F, n, block, loss_kind, loss_param,
                                                   code_mask, sign_shift, loss, valid, plan, stream);
}
