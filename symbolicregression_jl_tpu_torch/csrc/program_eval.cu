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
         sizeof(float) * block + sizeof(int) * L;
}

template <typename S, int LOSS, bool COST, bool PARAM>
__global__ void __launch_bounds__(TILE_MAX_W / TILE_ROWS, TILE_MIN_BLOCKS) program_eval_kernel(
    const int* __restrict__ instr,      // [T, L]
    const int* __restrict__ nsteps,     // [T]
    const float* __restrict__ cvals,    // [T, CMAX]
    const int* __restrict__ const_ok,   // [T]
    const float* __restrict__ bank,     // [T, NP, NC]  (parametric form)
    const int* __restrict__ class_idx,  // [n]          (parametric form)
    const S* __restrict__ X,            // [F, n]
    const float* __restrict__ y,        // [n]
    const float* __restrict__ w,        // [n]
    const float* __restrict__ cx,       // [T]   (cost form)
    const float* __restrict__ scal,     // [3]   denom, norm, parsimony (cost form)
    const int* __restrict__ optab,      // [n_codes]
    int L, int CMAX, int F, int NP, int NC, int n, int W, int code_mask, int sign_shift,
    float* __restrict__ loss_out, int* __restrict__ valid_out,
    float* __restrict__ cost_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  tree_loss_sums<S, LOSS, PARAM, TILE_ROWS>(
      instr + (size_t)t * L, min(nsteps[t], L), cvals + (size_t)t * CMAX,
      PARAM ? bank + (size_t)t * NP * NC : nullptr, class_idx, X, y, w, optab, 1, 1, L, CMAX,
      F, NP, NC, n, W, code_mask, sign_shift, smem, [&](int, float total, bool all_ok) {
        const int valid = (all_ok && isfinite(total) && const_ok[t] != 0) ? 1 : 0;
        valid_out[t] = valid;
        if (COST) {
          const float mean = __fdiv_rn(total, scal[0]);
          const float lossf = (valid && isfinite(mean)) ? mean : INFINITY;
          loss_out[t] = lossf;
          cost_out[t] = __fadd_rn(__fdiv_rn(lossf, scal[1]), __fmul_rn(scal[2], cx[t]));
        } else {
          loss_out[t] = total;
        }
      });
}

template <typename S, int LOSS, bool COST, bool PARAM>
cudaError_t launch_one(int T, int W, cudaStream_t stream, const int* instr, const int* nsteps,
                       const float* cvals, const int* const_ok, const float* bank,
                       const int* class_idx, const S* X, const float* y, const float* w,
                       const float* cx, const float* scal, const int* optab, int L, int CMAX,
                       int F, int NP, int NC, int n, int code_mask, int sign_shift, float* loss,
                       int* valid, float* cost) {
  if (W % TILE_ROWS != 0 || W > TILE_MAX_W || (W & (W - 1)) != 0) return cudaErrorInvalidValue;
  const size_t smem = tile_layout<S>(W, L, CMAX, F + NP, NP, NC, 1).total;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kern = program_eval_kernel<S, LOSS, COST, PARAM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<T, W / TILE_ROWS, smem, stream>>>(instr, nsteps, cvals, const_ok, bank, class_idx, X, y,
                                           w, cx, scal, optab, L, CMAX, F, NP, NC, n, W,
                                           code_mask, sign_shift, loss, valid, cost);
  return cudaGetLastError();
}

// The cost and plain forms: `cost` == nullptr selects the plain form.
template <typename S>
int eval_entry(const int* instr, const int* nsteps, const float* cvals, const int* const_ok,
               const S* X, const float* y, const float* w, const float* cx,
               const float* scal, const int* optab, int T, int L, int CMAX, int F, int n,
               int W, int loss_kind, int code_mask, int sign_shift, float* loss,
               int* valid, float* cost, void* stream) {
  if (T == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SR_LAUNCH(LK)                                                                     \
  err = (cost != nullptr)                                                                 \
            ? launch_one<S, LK, true, false>(T, W, s, instr, nsteps, cvals, const_ok,     \
                                             nullptr, nullptr, X, y, w, cx, scal, optab,  \
                                             L, CMAX, F, 0, 0, n, code_mask, sign_shift,  \
                                             loss, valid, cost)                           \
            : launch_one<S, LK, false, false>(T, W, s, instr, nsteps, cvals, const_ok,    \
                                              nullptr, nullptr, X, y, w, cx, scal, optab, \
                                              L, CMAX, F, 0, 0, n, code_mask, sign_shift, \
                                              loss, valid, cost);
  switch (loss_kind) {
    case LOSS_L2: SR_LAUNCH(LOSS_L2) break;
    case LOSS_L1: SR_LAUNCH(LOSS_L1) break;
    case LOSS_HUBER: SR_LAUNCH(LOSS_HUBER) break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SR_LAUNCH
  return (int)err;
}

// The parametric form (plain form only).
template <typename S>
int param_entry(const int* instr, const int* nsteps, const float* cvals, const int* const_ok,
                const float* bank, const int* class_idx, const S* X, const float* y,
                const float* w, const int* optab, int T, int L, int CMAX, int F, int NP,
                int NC, int n, int W, int loss_kind, int code_mask, int sign_shift,
                float* loss, int* valid, void* stream) {
  if (T == 0) return 0;
  if (NP < 1 || NC < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SR_LAUNCH(LK)                                                                   \
  err = launch_one<S, LK, false, true>(T, W, s, instr, nsteps, cvals, const_ok, bank,   \
                                       class_idx, X, y, w, nullptr, nullptr, optab, L,  \
                                       CMAX, F, NP, NC, n, code_mask, sign_shift, loss, \
                                       valid, nullptr);
  switch (loss_kind) {
    case LOSS_L2: SR_LAUNCH(LOSS_L2) break;
    case LOSS_L1: SR_LAUNCH(LOSS_L1) break;
    case LOSS_HUBER: SR_LAUNCH(LOSS_HUBER) break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SR_LAUNCH
  return (int)err;
}

}  // namespace

// Shared memory of the per-row layout with `block` threads ((F + NP + L)
// values per thread, the constants, the bank, one reduction float per
// thread, the words): the wrappers' `_block` picks the lane count W as the
// largest block whose per-row layout fits, as it did when the kernel ran
// that layout, so W, and with it every sum's order, stays as it was.
// `esize` is the buffer's element size (4: float, 2: bf16), NP = NC = 0
// for the non-parametric forms.
extern "C" size_t sr_program_eval_smem(int block, int L, int CMAX, int F, int NP, int NC,
                                       int esize) {
  return esize == 2 ? row_layout_smem<__nv_bfloat16>(block, L, CMAX, F, NP, NC)
                    : row_layout_smem<float>(block, L, CMAX, F, NP, NC);
}

// Launch on `stream` with W = `block` lanes (W / TILE_ROWS threads);
// returns cudaGetLastError() (0 on success). `cost` == nullptr selects the
// plain form.
extern "C" int sr_program_eval(const int* instr, const int* nsteps,
                               const float* cvals, const int* const_ok,
                               const float* X, const float* y, const float* w,
                               const float* cx, const float* scal,
                               const int* optab, int T, int L, int CMAX, int F,
                               int n, int block, int loss_kind, int code_mask,
                               int sign_shift, float* loss, int* valid,
                               float* cost, void* stream) {
  return eval_entry<float>(instr, nsteps, cvals, const_ok, X, y, w, cx, scal, optab, T, L,
                           CMAX, F, n, block, loss_kind, code_mask, sign_shift, loss, valid,
                           cost, stream);
}

// Kernel 1b: the same over a bf16 value buffer; X is [F, n] bf16.
extern "C" int sr_program_eval_bf16(const int* instr, const int* nsteps,
                                    const float* cvals, const int* const_ok,
                                    const __nv_bfloat16* X, const float* y, const float* w,
                                    const float* cx, const float* scal,
                                    const int* optab, int T, int L, int CMAX, int F,
                                    int n, int block, int loss_kind, int code_mask,
                                    int sign_shift, float* loss, int* valid,
                                    float* cost, void* stream) {
  return eval_entry<__nv_bfloat16>(instr, nsteps, cvals, const_ok, X, y, w, cx, scal, optab,
                                   T, L, CMAX, F, n, block, loss_kind, code_mask, sign_shift,
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
                                     int code_mask, int sign_shift, float* loss,
                                     int* valid, void* stream) {
  return param_entry<float>(instr, nsteps, cvals, const_ok, bank, class_idx, X, y, w, optab,
                            T, L, CMAX, F, NP, NC, n, block, loss_kind, code_mask, sign_shift,
                            loss, valid, stream);
}

// Kernel 1b's parametric form: X is [F, n] bf16, the bank rounds to bf16
// as the block loads it.
extern "C" int sr_program_eval_param_bf16(const int* instr, const int* nsteps,
                                          const float* cvals, const int* const_ok,
                                          const float* bank, const int* class_idx,
                                          const __nv_bfloat16* X, const float* y,
                                          const float* w, const int* optab, int T, int L,
                                          int CMAX, int F, int NP, int NC, int n, int block,
                                          int loss_kind, int code_mask, int sign_shift,
                                          float* loss, int* valid, void* stream) {
  return param_entry<__nv_bfloat16>(instr, nsteps, cvals, const_ok, bank, class_idx, X, y, w,
                                    optab, T, L, CMAX, F, NP, NC, n, block, loss_kind,
                                    code_mask, sign_shift, loss, valid, stream);
}
