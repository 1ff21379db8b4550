// Program-interpreter kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_program_kernel` / `_program_launch` in
// symbolicregression_jl_tpu/ops/fused_eval.py (Pallas). It runs one packed,
// leaf-free program per tree (ops/program.py, ops/fused_eval.py
// `_pack_instr`) over every row of the dataset and reduces an elementwise
// loss per tree:
//
//   plain form: loss_sum[t] = sum_r where(w_r > 0, elt_r, 0) * w_r,
//               valid[t]    = every step finite on every row
//                             AND isfinite(loss_sum) AND const_ok[t];
//   cost form:  the same, then mean = loss_sum / denom,
//               loss = (valid && isfinite(mean)) ? mean : inf,
//               cost = loss / norm + parsimony * complexity
//               (core/losses.loss_to_cost's operation order, no FMA).
//
// Instruction word: sign << 30 | code << 24 | src1 << 12 | src2, decoded
// exactly as `_fwd_dispatch` decodes it. `optab[code]` maps each merged
// opcode of the operator set (`_dispatch_plan`) to its operator:
// kind << 8 | op id, kind 0 = identity (unmerged plans), 1 = binary,
// 2 = unary, 3 = the merged add/sub branch a + (1 - 2 sign) * b, whose
// identity steps read the zero row at address BASE + L.
//
// Parametric form (sr_program_eval_param; the TPU kernel's `nparam > 0`
// variant): the plain form over a buffer whose per-row region holds the
// row's X features and then its NP parameter values,
//
//   buf[F + p] = bank[t, p, class_idx[r]],   base = F + NP + CMAX,
//
// so a LEAF_PARAM operand reads its tree's bank entry for the row's class.
// The TPU kernel built that row as a sum over class one-hots,
// sum_c onehot[c, r] * bank[t, p, c], a workaround for a gather on the
// TPU; this kernel gathers, as the JAX package's interpreter path and the
// reference do, so a non-finite bank entry reaches only its own class's
// rows (0 * inf does not spread NaN to the others). The tree's bank
// (NP x NC floats) sits in shared memory; each row reads its class once.
//
// bf16 forms (1b: sr_program_eval_bf16 and sr_program_eval_param_bf16;
// the TPU kernel's `bf16=True` variant, graftstage's eval_precision="bf16"):
// the same kernel over a bfloat16 value buffer. X arrives as bf16 (the
// wrapper rounds it once per dataset), the constants and the bank are
// rounded to bf16 as the block loads them, every step reads bf16
// operands, computes in float, checks finiteness on the float value and
// stores the value rounded to bf16 (round to nearest even); the root is
// the stored value. y, w, the loss terms, the row sums and the cost
// epilogue stay float. The buffer halves, so a block of 256 threads fits
// where the float buffer needed a smaller one.
//
// Loss kinds (interp.cuh LossSpec): L2 runs its own instantiation with the
// formula inlined; L1, Huber with any delta, log-cosh, the logit distance,
// sigmoid cross-entropy and the periodic L2 run one LOSS_ANY instantiation
// that switches on the launch's kind (warp-uniform), each the JAX
// package's formula operation for operation.
//
// float64 forms (sr_program_eval_f64, sr_program_eval_param_f64; the TPU
// kernel under jax_enable_x64): X, y, w, the constants, the bank, every
// step, the loss terms, the row sums and the cost epilogue in double
// (__dadd_rn, __dmul_rn, ...: no contraction), in the same lane order.
//
// The loss spine (interp.cuh round_to): 1b over float64 data
// (sr_program_eval_bf16_f64, ..._param_bf16_f64; the TPU kernel with
// bf16=True under jax_enable_x64) keeps the bf16 buffer and its float steps
// and takes y, w, the constants, the bank, the loss terms, the sums and the
// cost epilogue in double; 1b over bf16 data (..._bf16_data, eval_dtype=
// "bfloat16") rounds each loss term, each sum and the epilogue's results to
// bf16.
//
// The operator code and the tile interpreter live in interp.cuh, shared
// with kernels #2 (program_multi.cu) and #3-#5.
//
// Design. One CTA per tree, so every step is warp-uniform. The block
// decodes the tree's words once into a shared-memory table of resolved
// steps (operator, each operand as a buffer offset or a constant index,
// the row a result is held in), loads the tree's constants (and bank)
// once, then walks the rows in tiles of W (the wrappers' lane count, 256
// at the bench shapes) with W / TILE_ROWS threads: each thread issues the
// loads of its TILE_ROWS consecutive rows' X, y and w together (vector
// loads where aligned), stores X in its own columns of a [row][lane]
// shared buffer, then runs every step for its TILE_ROWS rows at once: one
// table read, one operator dispatch and one operand address per step
// serve TILE_ROWS evaluations, whose latencies overlap. A step's result
// stays in registers for the next step and is stored only when a later
// step reads it, in a row reused by liveness, so the buffer holds
// R + (L - 2) / 3 rows (14 at the bench shapes, where every step had one
// before). Each lane's loss terms add in row order into its own float;
// the lanes reduce in lane_tree_sum's fixed pairwise order (the fixed lane
// order of interp.cuh): no float atomics, and the sums keep the per-row
// kernel's bits.
//
// What bounds it on the H100. The work is FP32 ALU and SFU work: per
// (step, row) the operator's own instructions (one for + - *, about ten
// for / and exp, tens for cos with its range reduction) and a few for the
// operand and the finiteness check, plus about ten per row for the loss.
// X, y and w (28 bytes per row in float at F = 5) are read by every block
// from the 50 MB L2; device-memory traffic is only the per-tree words and
// constants. The per-row work (the tile's loads and the loss) weighs as
// much as the steps at the bench's three steps per tree, so the kernel
// needs many blocks in flight: its registers are capped at 64 a thread
// (TILE_MIN_BLOCKS), which with the smaller buffer lets 13 blocks share an
// SM. The parametric form adds per row NP shared-memory stores and one
// read of `class_idx` (n ints, L2-resident like X); its device-memory
// traffic grows by the banks, T x NP x NC floats.

#include "interp.cuh"

using namespace sr;

namespace {

// The per-row layout's shared memory with `block` threads (see
// sr_program_eval_smem).
template <typename S>
size_t row_layout_smem(int block, int L, int CMAX, int F, int NP, int NC) {
  return sizeof(S) * padded<S>((size_t)(F + NP + L) * block + CMAX + (size_t)NP * NC) +
         sizeof(typename Compute<S>::type) * block + sizeof(int) * L;
}

template <typename S, typename A, int LOSS, bool COST, bool PARAM, typename C = CT<A>>
__global__ void __launch_bounds__(TILE_MAX_W / TILE_ROWS, tile_min_blocks<C>()) program_eval_kernel(
    const int* __restrict__ instr,      // [T, L]
    const int* __restrict__ nsteps,     // [T]
    const C* __restrict__ cvals,        // [T, CMAX]
    const int* __restrict__ const_ok,   // [T]
    const C* __restrict__ bank,         // [T, NP, NC]  (parametric form)
    const int* __restrict__ class_idx,  // [n]          (parametric form)
    const S* __restrict__ X,            // [F, n]
    const C* __restrict__ y,            // [n]
    const C* __restrict__ w,            // [n]
    const C* __restrict__ cx,           // [T]   (cost form)
    const C* __restrict__ scal,         // [3]   denom, norm, parsimony (cost form)
    const int* __restrict__ optab,      // [n_codes]
    int L, int CMAX, int F, int NP, int NC, int n, int W, int code_mask, int sign_shift,
    LossSpec<C> ls, C* __restrict__ loss_out, int* __restrict__ valid_out,
    C* __restrict__ cost_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  tree_loss_sums<S, LOSS, PARAM, TILE_ROWS, A>(
      instr + (size_t)t * L, min(nsteps[t], L), cvals + (size_t)t * CMAX,
      PARAM ? bank + (size_t)t * NP * NC : nullptr, class_idx, X, y, w, optab, 1, 1, L, CMAX,
      F, NP, NC, n, W, code_mask, sign_shift, ls, smem, [&](int, C total, bool all_ok) {
        const int valid = (all_ok && isfinite(total) && const_ok[t] != 0) ? 1 : 0;
        valid_out[t] = valid;
        if (COST) {
          const C mean = round_to<A>(rn_div(total, scal[0]));
          const C lossf = (valid && isfinite(mean)) ? mean : C(INFINITY);
          loss_out[t] = lossf;
          cost_out[t] = round_to<A>(rn_add(round_to<A>(rn_div(lossf, scal[1])),
                                           round_to<A>(rn_mul(scal[2], cx[t]))));
        } else {
          loss_out[t] = total;
        }
      });
}

// C = CT<A> (not deduced: the forms pass nullptr for what they lack).
template <typename S, typename A, int LOSS, bool COST, bool PARAM>
cudaError_t launch_one(int T, int W, cudaStream_t stream, const int* instr, const int* nsteps,
                       const CT<A>* cvals, const int* const_ok, const CT<A>* bank,
                       const int* class_idx, const S* X, const CT<A>* y, const CT<A>* w,
                       const CT<A>* cx, const CT<A>* scal, const int* optab, int L, int CMAX,
                       int F, int NP, int NC, int n, int code_mask, int sign_shift,
                       LossSpec<CT<A>> ls, CT<A>* loss, int* valid, CT<A>* cost) {
  if (W % TILE_ROWS != 0 || W > TILE_MAX_W || (W & (W - 1)) != 0) return cudaErrorInvalidValue;
  const size_t smem = tile_layout<S, A>(W, L, CMAX, F + NP, NP, NC, 1).total;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kern = program_eval_kernel<S, A, LOSS, COST, PARAM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<T, W / TILE_ROWS, smem, stream>>>(instr, nsteps, cvals, const_ok, bank, class_idx, X, y,
                                           w, cx, scal, optab, L, CMAX, F, NP, NC, n, W,
                                           code_mask, sign_shift, ls, loss, valid, cost);
  return cudaGetLastError();
}

// The cost and plain forms: `cost` == nullptr selects the plain form. L2
// runs its own instantiation; every other kind runs LOSS_ANY's. S is the
// value buffer's storage, A the loss spine's type (interp.cuh round_to).
template <typename S, typename A = CT<S>, typename C = CT<A>>
int eval_entry(const int* instr, const int* nsteps, const C* cvals, const int* const_ok,
               const S* X, const C* y, const C* w, const C* cx, const C* scal,
               const int* optab, int T, int L, int CMAX, int F, int n, int W, int loss_kind,
               double loss_param, int code_mask, int sign_shift, C* loss, int* valid, C* cost,
               void* stream) {
  if (T == 0) return 0;
  if (loss_kind < LOSS_L2 || loss_kind > LOSS_PERIODIC_L2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const LossSpec<C> ls{loss_kind, (C)loss_param};
  cudaError_t err;
#define SR_LAUNCH(LK)                                                                     \
  err = (cost != nullptr)                                                                 \
            ? launch_one<S, A, LK, true, false>(T, W, s, instr, nsteps, cvals, const_ok,  \
                                                nullptr, nullptr, X, y, w, cx, scal,      \
                                                optab, L, CMAX, F, 0, 0, n, code_mask,    \
                                                sign_shift, ls, loss, valid, cost)        \
            : launch_one<S, A, LK, false, false>(T, W, s, instr, nsteps, cvals, const_ok, \
                                                 nullptr, nullptr, X, y, w, cx, scal,     \
                                                 optab, L, CMAX, F, 0, 0, n, code_mask,   \
                                                 sign_shift, ls, loss, valid, cost);
  if (loss_kind == LOSS_L2) {
    SR_LAUNCH(LOSS_L2)
  } else {
    SR_LAUNCH(LOSS_ANY)
  }
#undef SR_LAUNCH
  return (int)err;
}

// The parametric form (plain form only).
template <typename S, typename A = CT<S>, typename C = CT<A>>
int param_entry(const int* instr, const int* nsteps, const C* cvals, const int* const_ok,
                const C* bank, const int* class_idx, const S* X, const C* y, const C* w,
                const int* optab, int T, int L, int CMAX, int F, int NP, int NC, int n, int W,
                int loss_kind, double loss_param, int code_mask, int sign_shift, C* loss,
                int* valid, void* stream) {
  if (T == 0) return 0;
  if (NP < 1 || NC < 1) return (int)cudaErrorInvalidValue;
  if (loss_kind < LOSS_L2 || loss_kind > LOSS_PERIODIC_L2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const LossSpec<C> ls{loss_kind, (C)loss_param};
  cudaError_t err;
#define SR_LAUNCH(LK)                                                                      \
  err = launch_one<S, A, LK, false, true>(T, W, s, instr, nsteps, cvals, const_ok, bank,   \
                                          class_idx, X, y, w, nullptr, nullptr, optab, L,  \
                                          CMAX, F, NP, NC, n, code_mask, sign_shift, ls,   \
                                          loss, valid, nullptr);
  if (loss_kind == LOSS_L2) {
    SR_LAUNCH(LOSS_L2)
  } else {
    SR_LAUNCH(LOSS_ANY)
  }
#undef SR_LAUNCH
  return (int)err;
}

}  // namespace

// Shared memory of the per-row layout with `block` threads ((F + NP + L)
// values per thread, the constants, the bank, one reduction value per
// thread, the words): the wrappers' `_block` picks the lane count W as the
// largest block whose per-row layout fits, as it did when the kernel ran
// that layout, so W, and with it every sum's order, stays as it was.
// `esize` is the buffer's element size (4: float, 2: bf16, 8: double),
// NP = NC = 0 for the non-parametric forms.
extern "C" size_t sr_program_eval_smem(int block, int L, int CMAX, int F, int NP, int NC,
                                       int esize) {
  return esize == 2   ? row_layout_smem<__nv_bfloat16>(block, L, CMAX, F, NP, NC)
         : esize == 8 ? row_layout_smem<double>(block, L, CMAX, F, NP, NC)
                      : row_layout_smem<float>(block, L, CMAX, F, NP, NC);
}

// Launch on `stream` with W = `block` lanes (W / TILE_ROWS threads);
// returns cudaGetLastError() (0 on success). `cost` == nullptr selects the
// plain form. `loss_kind` is one of the LOSS_* kinds, `loss_param` its
// parameter (interp.cuh LossSpec).
extern "C" int sr_program_eval(const int* instr, const int* nsteps,
                               const float* cvals, const int* const_ok,
                               const float* X, const float* y, const float* w,
                               const float* cx, const float* scal,
                               const int* optab, int T, int L, int CMAX, int F,
                               int n, int block, int loss_kind, double loss_param,
                               int code_mask, int sign_shift, float* loss, int* valid,
                               float* cost, void* stream) {
  return eval_entry<float>(instr, nsteps, cvals, const_ok, X, y, w, cx, scal, optab, T, L,
                           CMAX, F, n, block, loss_kind, loss_param, code_mask, sign_shift, loss,
                           valid, cost, stream);
}

// Kernel 1b: the same over a bf16 value buffer; X is [F, n] bf16.
extern "C" int sr_program_eval_bf16(const int* instr, const int* nsteps,
                                    const float* cvals, const int* const_ok,
                                    const __nv_bfloat16* X, const float* y, const float* w,
                                    const float* cx, const float* scal,
                                    const int* optab, int T, int L, int CMAX, int F,
                                    int n, int block, int loss_kind, double loss_param,
                                    int code_mask, int sign_shift, float* loss, int* valid,
                                    float* cost, void* stream) {
  return eval_entry<__nv_bfloat16>(instr, nsteps, cvals, const_ok, X, y, w, cx, scal, optab,
                                   T, L, CMAX, F, n, block, loss_kind, loss_param, code_mask,
                                   sign_shift, loss, valid, cost, stream);
}

// The float64 form: every input, output and step in double.
extern "C" int sr_program_eval_f64(const int* instr, const int* nsteps,
                                   const double* cvals, const int* const_ok,
                                   const double* X, const double* y, const double* w,
                                   const double* cx, const double* scal,
                                   const int* optab, int T, int L, int CMAX, int F,
                                   int n, int block, int loss_kind, double loss_param,
                                   int code_mask, int sign_shift, double* loss, int* valid,
                                   double* cost, void* stream) {
  return eval_entry<double>(instr, nsteps, cvals, const_ok, X, y, w, cx, scal, optab, T, L,
                            CMAX, F, n, block, loss_kind, loss_param, code_mask, sign_shift,
                            loss, valid, cost, stream);
}

// The parametric form (plain form only): `bank` [T, NP, NC], `class_idx`
// [n] with values in [0, NC). Returns cudaGetLastError() (0 on success).
extern "C" int sr_program_eval_param(const int* instr, const int* nsteps,
                                     const float* cvals, const int* const_ok,
                                     const float* bank, const int* class_idx,
                                     const float* X, const float* y, const float* w,
                                     const int* optab, int T, int L, int CMAX, int F,
                                     int NP, int NC, int n, int block, int loss_kind,
                                     double loss_param, int code_mask, int sign_shift,
                                     float* loss, int* valid, void* stream) {
  return param_entry<float>(instr, nsteps, cvals, const_ok, bank, class_idx, X, y, w, optab,
                            T, L, CMAX, F, NP, NC, n, block, loss_kind, loss_param, code_mask,
                            sign_shift, loss, valid, stream);
}

// Kernel 1b's parametric form: X is [F, n] bf16, the bank rounds to bf16
// as the block loads it.
extern "C" int sr_program_eval_param_bf16(const int* instr, const int* nsteps,
                                          const float* cvals, const int* const_ok,
                                          const float* bank, const int* class_idx,
                                          const __nv_bfloat16* X, const float* y,
                                          const float* w, const int* optab, int T, int L,
                                          int CMAX, int F, int NP, int NC, int n, int block,
                                          int loss_kind, double loss_param, int code_mask,
                                          int sign_shift, float* loss, int* valid,
                                          void* stream) {
  return param_entry<__nv_bfloat16>(instr, nsteps, cvals, const_ok, bank, class_idx, X, y, w,
                                    optab, T, L, CMAX, F, NP, NC, n, block, loss_kind,
                                    loss_param, code_mask, sign_shift, loss, valid, stream);
}

// The parametric form in float64.
extern "C" int sr_program_eval_param_f64(const int* instr, const int* nsteps,
                                         const double* cvals, const int* const_ok,
                                         const double* bank, const int* class_idx,
                                         const double* X, const double* y, const double* w,
                                         const int* optab, int T, int L, int CMAX, int F,
                                         int NP, int NC, int n, int block, int loss_kind,
                                         double loss_param, int code_mask, int sign_shift,
                                         double* loss, int* valid, void* stream) {
  return param_entry<double>(instr, nsteps, cvals, const_ok, bank, class_idx, X, y, w, optab,
                             T, L, CMAX, F, NP, NC, n, block, loss_kind, loss_param, code_mask,
                             sign_shift, loss, valid, stream);
}

// float64 data on a bf16 value buffer (the TPU kernel under
// jax_enable_x64 with bf16=True): X is [F, n] bf16 (the wrapper rounds the
// float64 data once), the constants round to bf16 as the block loads them
// (through float, as the plain version's conversion), every step computes
// in float, and the prediction enters a float64 loss: y, w, the loss terms,
// the row sums and the cost epilogue in double.
extern "C" int sr_program_eval_bf16_f64(const int* instr, const int* nsteps,
                                        const double* cvals, const int* const_ok,
                                        const __nv_bfloat16* X, const double* y,
                                        const double* w, const double* cx, const double* scal,
                                        const int* optab, int T, int L, int CMAX, int F, int n,
                                        int block, int loss_kind, double loss_param,
                                        int code_mask, int sign_shift, double* loss, int* valid,
                                        double* cost, void* stream) {
  return eval_entry<__nv_bfloat16, double>(instr, nsteps, cvals, const_ok, X, y, w, cx, scal,
                                           optab, T, L, CMAX, F, n, block, loss_kind,
                                           loss_param, code_mask, sign_shift, loss, valid, cost,
                                           stream);
}

// The parametric form of float64 data on a bf16 buffer.
extern "C" int sr_program_eval_param_bf16_f64(const int* instr, const int* nsteps,
                                              const double* cvals, const int* const_ok,
                                              const double* bank, const int* class_idx,
                                              const __nv_bfloat16* X, const double* y,
                                              const double* w, const int* optab, int T, int L,
                                              int CMAX, int F, int NP, int NC, int n, int block,
                                              int loss_kind, double loss_param, int code_mask,
                                              int sign_shift, double* loss, int* valid,
                                              void* stream) {
  return param_entry<__nv_bfloat16, double>(instr, nsteps, cvals, const_ok, bank, class_idx, X,
                                            y, w, optab, T, L, CMAX, F, NP, NC, n, block,
                                            loss_kind, loss_param, code_mask, sign_shift, loss,
                                            valid, stream);
}

// bf16 data (eval_dtype="bfloat16"): kernel 1b with a bf16 loss spine. y
// and w hold bf16 values in float, each row's loss term, each sum and the
// cost epilogue's results round to bf16 (interp.cuh round_to).
extern "C" int sr_program_eval_bf16_data(const int* instr, const int* nsteps,
                                         const float* cvals, const int* const_ok,
                                         const __nv_bfloat16* X, const float* y, const float* w,
                                         const float* cx, const float* scal, const int* optab,
                                         int T, int L, int CMAX, int F, int n, int block,
                                         int loss_kind, double loss_param, int code_mask,
                                         int sign_shift, float* loss, int* valid, float* cost,
                                         void* stream) {
  return eval_entry<__nv_bfloat16, __nv_bfloat16>(instr, nsteps, cvals, const_ok, X, y, w, cx,
                                                  scal, optab, T, L, CMAX, F, n, block,
                                                  loss_kind, loss_param, code_mask, sign_shift,
                                                  loss, valid, cost, stream);
}

// The parametric form of bf16 data.
extern "C" int sr_program_eval_param_bf16_data(const int* instr, const int* nsteps,
                                               const float* cvals, const int* const_ok,
                                               const float* bank, const int* class_idx,
                                               const __nv_bfloat16* X, const float* y,
                                               const float* w, const int* optab, int T, int L,
                                               int CMAX, int F, int NP, int NC, int n, int block,
                                               int loss_kind, double loss_param, int code_mask,
                                               int sign_shift, float* loss, int* valid,
                                               void* stream) {
  return param_entry<__nv_bfloat16, __nv_bfloat16>(instr, nsteps, cvals, const_ok, bank,
                                                   class_idx, X, y, w, optab, T, L, CMAX, F, NP,
                                                   NC, n, block, loss_kind, loss_param,
                                                   code_mask, sign_shift, loss, valid, stream);
}
