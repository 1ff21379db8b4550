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
// Design. One CTA per (tree, variant) pair, running the interpreter of
// interp.cuh exactly as kernel #1 runs it: the per-thread row loop, the
// shared-memory [slot][thread] value buffer and the fixed-order tree
// reduction are the same code. So a pair gives kernel #1's plain-form
// bits for the same constants, and two launches give the same bits. The
// TPU kernel's V-chunking and tree blocks worked around its VMEM size and
// its per-step scalar dispatch; here every pair is its own block and each
// call is one launch.
//
// bf16 form (2b: sr_program_multi_bf16; the TPU kernel's `bf16=True`
// variant, graftstage's optimizer_bf16_linesearch): the same over a
// bfloat16 value buffer, as kernel 1b runs it. X arrives as bf16, each
// pair's constants round to bf16 as the block loads them, steps compute
// in float and store rounded; the loss and its row sum stay float. The
// TPU kernel's 16-variant chunks worked around VMEM and are not copied:
// one launch per call.
//
// What bounds it on the H100. Like kernel #1 it is FP32 ALU and SFU work,
// (steps x rows) operator evaluations per pair, with X (200 KB at the
// bench shapes) resident in L2; device-memory traffic is the words and
// constant vectors. Reading the words once per tree instead of once per
// pair, and keeping the values in registers, is later work.

#include "interp.cuh"

using namespace sr;

namespace {

// Dynamic shared memory a launch with `block` threads needs (kernel #1's).
template <typename S>
size_t multi_smem(int block, int L, int CMAX, int F) {
  return sizeof(S) * padded<S>((size_t)(F + L) * block + CMAX) + sizeof(float) * block +
         sizeof(int) * L;
}

template <typename S, int LOSS>
__global__ void program_multi_kernel(
    const int* __restrict__ instr,      // [T, L]
    const int* __restrict__ nsteps,     // [T]
    const float* __restrict__ cvals_v,  // [T, V, CMAX]
    const S* __restrict__ X,            // [F, n]
    const float* __restrict__ y,        // [n]
    const float* __restrict__ w,        // [n]
    const int* __restrict__ optab,      // [n_codes]
    int V, int L, int CMAX, int F, int n, int code_mask, int sign_shift,
    float* __restrict__ loss_out, int* __restrict__ valid_out) {
  extern __shared__ float smem[];
  const int pair = blockIdx.x;
  const int t = pair / V;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  S* sv = reinterpret_cast<S*>(smem);        // [(F + L) * bd] per-row values
  S* sc = sv + (size_t)(F + L) * bd;         // [CMAX] constants of this variant
  float* sred = reinterpret_cast<float*>(    // [bd] reduction scratch
      sv + padded<S>((size_t)(F + L) * bd + CMAX));
  int* sins = reinterpret_cast<int*>(sred + bd);  // [L] instruction words

  const int base = F + CMAX;
  for (int i = tid; i < L; i += bd) sins[i] = instr[(size_t)t * L + i];
  for (int i = tid; i < CMAX; i += bd) sc[i] = from_f32<S>(cvals_v[(size_t)pair * CMAX + i]);
  __syncthreads();

  const int m = nsteps[t];
  const RowBufT<S> b{sv, sc, F, base, base + L, bd, tid};
  float acc = 0.0f;
  bool ok = true;
  for (int r = tid; r < n; r += bd) {
    const float v = forward_row(b, sins, X, n, r, m, optab, code_mask, sign_shift, ok);
    acc = __fadd_rn(acc, loss_term<LOSS>(v, y[r], w[r]));
  }

  const int all_ok = __syncthreads_and(ok ? 1 : 0);
  block_sum(sred, acc);
  if (tid == 0) {
    const float total = sred[0];
    loss_out[pair] = total;
    valid_out[pair] = (all_ok && isfinite(total)) ? 1 : 0;
  }
}

template <typename S, int LOSS>
cudaError_t launch_multi(int pairs, int block, size_t smem, cudaStream_t stream,
                         const int* instr, const int* nsteps, const float* cvals_v,
                         const S* X, const float* y, const float* w,
                         const int* optab, int V, int L, int CMAX, int F, int n,
                         int code_mask, int sign_shift, float* loss, int* valid) {
  auto kern = program_multi_kernel<S, LOSS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<pairs, block, smem, stream>>>(instr, nsteps, cvals_v, X, y, w, optab, V, L,
                                       CMAX, F, n, code_mask, sign_shift, loss, valid);
  return cudaGetLastError();
}

template <typename S>
int multi_entry(const int* instr, const int* nsteps, const float* cvals_v, const S* X,
                const float* y, const float* w, const int* optab, int T, int V, int L,
                int CMAX, int F, int n, int block, int loss_kind, int code_mask,
                int sign_shift, float* loss, int* valid, void* stream) {
  const long long pairs = (long long)T * V;
  if (pairs == 0) return 0;
  if (pairs > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const size_t smem = multi_smem<S>(block, L, CMAX, F);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (loss_kind) {
#define SR_LAUNCH(LK)                                                             \
  case LK:                                                                        \
    return (int)launch_multi<S, LK>((int)pairs, block, smem, s, instr, nsteps,    \
                                    cvals_v, X, y, w, optab, V, L, CMAX, F, n,    \
                                    code_mask, sign_shift, loss, valid);
    SR_LAUNCH(LOSS_L2)
    SR_LAUNCH(LOSS_L1)
    SR_LAUNCH(LOSS_HUBER)
#undef SR_LAUNCH
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory a launch with `block` threads needs; `esize` is
// the buffer's element size (4: float, 2: bf16).
extern "C" size_t sr_program_multi_smem(int block, int L, int CMAX, int F, int esize) {
  return esize == 2 ? multi_smem<__nv_bfloat16>(block, L, CMAX, F)
                    : multi_smem<float>(block, L, CMAX, F);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int sr_program_multi(const int* instr, const int* nsteps,
                                const float* cvals_v, const float* X,
                                const float* y, const float* w, const int* optab,
                                int T, int V, int L, int CMAX, int F, int n,
                                int block, int loss_kind, int code_mask,
                                int sign_shift, float* loss, int* valid,
                                void* stream) {
  return multi_entry<float>(instr, nsteps, cvals_v, X, y, w, optab, T, V, L, CMAX, F, n,
                            block, loss_kind, code_mask, sign_shift, loss, valid, stream);
}

// Kernel 2b: the same over a bf16 value buffer; X is [F, n] bf16.
extern "C" int sr_program_multi_bf16(const int* instr, const int* nsteps,
                                     const float* cvals_v, const __nv_bfloat16* X,
                                     const float* y, const float* w, const int* optab,
                                     int T, int V, int L, int CMAX, int F, int n,
                                     int block, int loss_kind, int code_mask,
                                     int sign_shift, float* loss, int* valid,
                                     void* stream) {
  return multi_entry<__nv_bfloat16>(instr, nsteps, cvals_v, X, y, w, optab, T, V, L, CMAX, F,
                                    n, block, loss_kind, code_mask, sign_shift, loss, valid,
                                    stream);
}
