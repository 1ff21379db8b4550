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
// Design. One CTA per tree, which owns all V of the tree's constant
// vectors: the tile interpreter of interp.cuh (tree_loss_sums), the same
// code as kernel #1's. The block decodes the tree's words once, then walks
// the rows in tiles of W (W / TILE_ROWS threads, TILE_ROWS rows each) and
// runs every vector of a pass of TILE_VCH vectors on each tile: the
// tile's X sits in shared memory once for all of them, and each vector's
// constants (rounded to the storage type) sit side by side, with a
// per-lane float sum per vector in shared memory. A pair's sum keeps the
// per-row kernel's lane order (interp.cuh), so a pair gives kernel #1's
// plain-form bits for the same constants, kernel #3's loss bits, and two
// launches give the same bits. The TPU kernel's V-chunking and tree
// blocks worked around its VMEM size and its per-step scalar dispatch;
// here each call is one launch.
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
// (steps x rows) operator evaluations per pair; X (200 KB at the bench
// shapes) stays in L2, and each tree reads it ceil(V / TILE_VCH) times,
// not once per pair; device-memory traffic is the words and the constant
// vectors. The decode, the operator dispatch and the operand
// addresses are paid once per step for TILE_ROWS rows, as in kernel #1;
// what is left is the operators' own work, a few instructions per (step,
// row) around it, and the per-vector lane sums' shared-memory traffic.

#include "interp.cuh"

using namespace sr;

namespace {

// The per-row layout's shared memory with `block` threads (see
// sr_program_multi_smem).
template <typename S>
size_t row_layout_smem(int block, int L, int CMAX, int F) {
  return sizeof(S) * padded<S>((size_t)(F + L) * block + CMAX) +
         sizeof(typename Compute<S>::type) * block + sizeof(int) * L;
}

template <typename S, typename A, int LOSS, typename C = CT<A>>
__global__ void __launch_bounds__(TILE_MAX_W / TILE_ROWS) program_multi_kernel(
    const int* __restrict__ instr,      // [T, L]
    const int* __restrict__ nsteps,     // [T]
    const C* __restrict__ cvals_v,      // [T, V, CMAX]
    const S* __restrict__ X,            // [F, n]
    const C* __restrict__ y,            // [n]
    const C* __restrict__ w,            // [n]
    const int* __restrict__ optab,      // [n_codes]
    int V, int vch, int L, int CMAX, int F, int n, int W, int code_mask, int sign_shift,
    LossSpec<C> ls, C* __restrict__ loss_out, int* __restrict__ valid_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  tree_loss_sums<S, LOSS, false, TILE_ROWS, A>(
      instr + (size_t)t * L, min(nsteps[t], L), cvals_v + (size_t)t * V * CMAX, nullptr, nullptr,
      X, y, w, optab, V, vch, L, CMAX, F, 0, 0, n, W, code_mask, sign_shift, ls, smem,
      [&](int v, C total, bool all_ok) {
        loss_out[(size_t)t * V + v] = total;
        valid_out[(size_t)t * V + v] = (all_ok && isfinite(total)) ? 1 : 0;
      });
}

template <typename S, typename A, int LOSS, typename C = CT<A>>
cudaError_t launch_multi(int T, int W, cudaStream_t stream, const int* instr, const int* nsteps,
                         const C* cvals_v, const S* X, const C* y, const C* w,
                         const int* optab, int V, int L, int CMAX, int F, int n,
                         int code_mask, int sign_shift, LossSpec<C> ls, C* loss, int* valid) {
  if (W % TILE_ROWS != 0 || W > TILE_MAX_W || (W & (W - 1)) != 0) return cudaErrorInvalidValue;
  // The most vectors per pass (up to TILE_VCH) whose layout fits.
  int vch = min(V, TILE_VCH);
  while (vch > 1 && tile_layout<S, A>(W, L, CMAX, F, 0, 0, vch).total > kSmemLimit) vch >>= 1;
  const size_t smem = tile_layout<S, A>(W, L, CMAX, F, 0, 0, vch).total;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kern = program_multi_kernel<S, A, LOSS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<T, W / TILE_ROWS, smem, stream>>>(instr, nsteps, cvals_v, X, y, w, optab, V, vch, L,
                                           CMAX, F, n, W, code_mask, sign_shift, ls, loss,
                                           valid);
  return cudaGetLastError();
}

// S is the value buffer's storage, A the loss spine's type (interp.cuh
// round_to).
template <typename S, typename A = CT<S>, typename C = CT<A>>
int multi_entry(const int* instr, const int* nsteps, const C* cvals_v, const S* X,
                const C* y, const C* w, const int* optab, int T, int V, int L,
                int CMAX, int F, int n, int W, int loss_kind, double loss_param, int code_mask,
                int sign_shift, C* loss, int* valid, void* stream) {
  if ((long long)T * V == 0) return 0;
  if (loss_kind < LOSS_L2 || loss_kind > LOSS_PERIODIC_L2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const LossSpec<C> ls{loss_kind, (C)loss_param};
  if (loss_kind == LOSS_L2) {
    return (int)launch_multi<S, A, LOSS_L2>(T, W, s, instr, nsteps, cvals_v, X, y, w, optab, V,
                                            L, CMAX, F, n, code_mask, sign_shift, ls, loss,
                                            valid);
  }
  return (int)launch_multi<S, A, LOSS_ANY>(T, W, s, instr, nsteps, cvals_v, X, y, w, optab, V, L,
                                           CMAX, F, n, code_mask, sign_shift, ls, loss, valid);
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

// Launch on `stream` with W = `block` lanes (W / TILE_ROWS threads per
// tree); returns cudaGetLastError() (0 on success). `loss_kind` is one of
// the LOSS_* kinds, `loss_param` its parameter (interp.cuh LossSpec).
extern "C" int sr_program_multi(const int* instr, const int* nsteps,
                                const float* cvals_v, const float* X,
                                const float* y, const float* w, const int* optab,
                                int T, int V, int L, int CMAX, int F, int n,
                                int block, int loss_kind, double loss_param, int code_mask,
                                int sign_shift, float* loss, int* valid,
                                void* stream) {
  return multi_entry<float>(instr, nsteps, cvals_v, X, y, w, optab, T, V, L, CMAX, F, n,
                            block, loss_kind, loss_param, code_mask, sign_shift, loss, valid,
                            stream);
}

// Kernel 2b: the same over a bf16 value buffer; X is [F, n] bf16.
extern "C" int sr_program_multi_bf16(const int* instr, const int* nsteps,
                                     const float* cvals_v, const __nv_bfloat16* X,
                                     const float* y, const float* w, const int* optab,
                                     int T, int V, int L, int CMAX, int F, int n,
                                     int block, int loss_kind, double loss_param,
                                     int code_mask, int sign_shift, float* loss, int* valid,
                                     void* stream) {
  return multi_entry<__nv_bfloat16>(instr, nsteps, cvals_v, X, y, w, optab, T, V, L, CMAX, F,
                                    n, block, loss_kind, loss_param, code_mask, sign_shift,
                                    loss, valid, stream);
}

// The float64 form: every input, output and step in double.
extern "C" int sr_program_multi_f64(const int* instr, const int* nsteps,
                                    const double* cvals_v, const double* X,
                                    const double* y, const double* w, const int* optab,
                                    int T, int V, int L, int CMAX, int F, int n,
                                    int block, int loss_kind, double loss_param,
                                    int code_mask, int sign_shift, double* loss, int* valid,
                                    void* stream) {
  return multi_entry<double>(instr, nsteps, cvals_v, X, y, w, optab, T, V, L, CMAX, F, n,
                             block, loss_kind, loss_param, code_mask, sign_shift, loss, valid,
                             stream);
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
                                         int sign_shift, double* loss, int* valid,
                                         void* stream) {
  return multi_entry<__nv_bfloat16, double>(instr, nsteps, cvals_v, X, y, w, optab, T, V, L,
                                            CMAX, F, n, block, loss_kind, loss_param, code_mask,
                                            sign_shift, loss, valid, stream);
}

// Kernel 2b for bf16 data (eval_dtype="bfloat16"): the loss terms and the
// sums rounded to bf16 (program_eval.cu sr_program_eval_bf16_data).
extern "C" int sr_program_multi_bf16_data(const int* instr, const int* nsteps,
                                          const float* cvals_v, const __nv_bfloat16* X,
                                          const float* y, const float* w, const int* optab,
                                          int T, int V, int L, int CMAX, int F, int n, int block,
                                          int loss_kind, double loss_param, int code_mask,
                                          int sign_shift, float* loss, int* valid,
                                          void* stream) {
  return multi_entry<__nv_bfloat16, __nv_bfloat16>(instr, nsteps, cvals_v, X, y, w, optab, T, V,
                                                   L, CMAX, F, n, block, loss_kind, loss_param,
                                                   code_mask, sign_shift, loss, valid, stream);
}
