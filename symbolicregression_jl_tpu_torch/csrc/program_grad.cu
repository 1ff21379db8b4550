// Forward + adjoint program kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_multi_grad_kernel` / `fused_grad_multi`
// in symbolicregression_jl_tpu/ops/fused_eval.py (Pallas). For every pair
// of a tree t and one of its V constant vectors v it computes kernel #2's
// loss_sum[t, v] and valid[t, v] and the gradient of loss_sum with respect
// to the tree's constants, gcomp[t, v, c] for c < nconst[t] (0 past it).
//
// Per row: the forward sweep of interp.cuh (kernel #2's code, so the loss
// is bit-equal to kernel #2's), the loss cotangent seeded with the row's
// weight and zeroed where w <= 0, then a reverse sweep over the steps that
// mirrors the JAX package's `_bwd_dispatch`: step k's cotangent sits in
// adj[BASE + k]; its operands' cotangents are stored at their addresses
// with plain stores. Every node has one parent, so each adjoint slot is
// written once per row; two operands of one step collide only in the X
// region, which is never read, and the identity steps' zero-row adjoint
// is written and never read. The constants' adjoints (adj[F + c]) are
// added into a per-thread sum in a fixed order, and the block reduces each
// with a fixed-order tree: no float atomics. Weight-0 rows are not masked
// (their cotangent is exactly 0 and 0 * inf is NaN inside an operator's
// derivative, as in the JAX package); the wrapper zeroes non-finite
// gradients.
//
// Design. One CTA per (tree, variant) pair. Shared memory per block:
// (F + L) value rows, (F + CMAX + L + 1) adjoint rows and CMAX gradient
// rows, each one float per thread, plus the words and constants: 104 KB
// at the bench shapes (F 5, CMAX 15, L 30) with 256 threads, so two
// blocks fit on an SM. What bounds it on the H100 is again FP32 ALU and
// SFU work, about three times kernel #2's per pair (forward, derivative,
// adjoint stores); making it fast is later work.

#include "interp.cuh"

using namespace sr;

namespace {

template <int LOSS>
__global__ void program_grad_kernel(
    const int* __restrict__ instr,      // [T, L]
    const int* __restrict__ nsteps,     // [T]
    const int* __restrict__ nconst,     // [T]
    const float* __restrict__ cvals_v,  // [T, V, CMAX]
    const float* __restrict__ X,        // [F, n]
    const float* __restrict__ y,        // [n]
    const float* __restrict__ w,        // [n]
    const int* __restrict__ optab,      // [n_codes]
    int V, int L, int CMAX, int F, int n, int code_mask, int sign_shift,
    float* __restrict__ loss_out, int* __restrict__ valid_out,
    float* __restrict__ gcomp_out) {    // [T, V, CMAX]
  extern __shared__ float smem[];
  const int pair = blockIdx.x;
  const int t = pair / V;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int base = F + CMAX;
  float* sv = smem;                                // [(F + L) * bd] values
  float* adj = sv + (size_t)(F + L) * bd;          // [(base + L + 1) * bd] adjoints
  float* gacc = adj + (size_t)(base + L + 1) * bd; // [CMAX * bd] per-thread gradients
  float* sc = gacc + (size_t)CMAX * bd;            // [CMAX] constants of this variant
  float* sred = sc + CMAX;                         // [bd] reduction scratch
  int* sins = reinterpret_cast<int*>(sred + bd);   // [L] instruction words

  for (int i = tid; i < L; i += bd) sins[i] = instr[(size_t)t * L + i];
  for (int i = tid; i < CMAX; i += bd) sc[i] = cvals_v[(size_t)pair * CMAX + i];
  const int nc = nconst[t];
  for (int c = 0; c < nc; ++c) gacc[c * bd + tid] = 0.0f;
  __syncthreads();

  const int m = nsteps[t];
  const RowBuf b{sv, sc, F, base, base + L, bd, tid};
  float acc = 0.0f;
  bool ok = true;
  for (int r = tid; r < n; r += bd) {
    const float v = forward_row(b, sins, X, n, r, m, optab, code_mask, sign_shift, ok);
    const float yr = y[r];
    const float wr = w[r];
    acc = __fadd_rn(acc, loss_term<LOSS>(v, yr, wr));

    const float dpred = loss_vjp<LOSS>(v, yr, wr);
    adj[(base + m - 1) * bd + tid] = wr > 0.0f ? dpred : 0.0f;
    for (int k = m - 1; k >= 0; --k) {
      const float ct = adj[(base + k) * bd + tid];
      const Step s = decode(sins[k], optab, code_mask, sign_shift);
      if (s.kind == K_ADDSUB) {
        adj[s.i1 * bd + tid] = ct;
        adj[s.i2 * bd + tid] = __fmul_rn(s.sg, ct);
      } else if (s.kind == K_BINARY) {
        float d1, d2;
        vjp_binary(s.id, b.rd(s.i1), b.rd(s.i2), ct, d1, d2);
        adj[s.i1 * bd + tid] = d1;
        adj[s.i2 * bd + tid] = d2;
      } else if (s.kind == K_UNARY) {
        adj[s.i1 * bd + tid] = vjp_unary(s.id, b.rd(s.i1), ct);
      } else {
        adj[s.i1 * bd + tid] = ct;
      }
    }
    for (int c = 0; c < nc; ++c)
      gacc[c * bd + tid] = __fadd_rn(gacc[c * bd + tid], adj[(F + c) * bd + tid]);
  }

  const int all_ok = __syncthreads_and(ok ? 1 : 0);
  block_sum(sred, acc);
  if (tid == 0) {
    const float total = sred[0];
    loss_out[pair] = total;
    valid_out[pair] = (all_ok && isfinite(total)) ? 1 : 0;
  }
  float* g = gcomp_out + (size_t)pair * CMAX;
  for (int c = 0; c < nc; ++c) {
    __syncthreads();  // sred is read by thread 0 above / by the last round
    block_sum(sred, gacc[c * bd + tid]);
    if (tid == 0) g[c] = sred[0];
  }
  for (int c = nc + tid; c < CMAX; c += bd) g[c] = 0.0f;
}

template <int LOSS>
cudaError_t launch_grad(int pairs, int block, size_t smem, cudaStream_t stream,
                        const int* instr, const int* nsteps, const int* nconst,
                        const float* cvals_v, const float* X, const float* y,
                        const float* w, const int* optab, int V, int L, int CMAX,
                        int F, int n, int code_mask, int sign_shift, float* loss,
                        int* valid, float* gcomp) {
  auto kern = program_grad_kernel<LOSS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<pairs, block, smem, stream>>>(instr, nsteps, nconst, cvals_v, X, y, w, optab,
                                       V, L, CMAX, F, n, code_mask, sign_shift, loss,
                                       valid, gcomp);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory a launch with `block` threads needs.
extern "C" size_t sr_program_grad_smem(int block, int L, int CMAX, int F) {
  const size_t rows = (size_t)(F + L) + (F + CMAX + L + 1) + CMAX;
  return sizeof(float) * (rows * block + CMAX + block) + sizeof(int) * L;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int sr_program_grad(const int* instr, const int* nsteps, const int* nconst,
                               const float* cvals_v, const float* X, const float* y,
                               const float* w, const int* optab, int T, int V, int L,
                               int CMAX, int F, int n, int block, int loss_kind,
                               int code_mask, int sign_shift, float* loss, int* valid,
                               float* gcomp, void* stream) {
  const long long pairs = (long long)T * V;
  if (pairs == 0) return 0;
  if (pairs > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sr_program_grad_smem(block, L, CMAX, F);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (loss_kind) {
#define SR_LAUNCH(LK)                                                               \
  case LK:                                                                          \
    return (int)launch_grad<LK>((int)pairs, block, smem, s, instr, nsteps, nconst,  \
                                cvals_v, X, y, w, optab, V, L, CMAX, F, n,          \
                                code_mask, sign_shift, loss, valid, gcomp);
    SR_LAUNCH(LOSS_L2)
    SR_LAUNCH(LOSS_L1)
    SR_LAUNCH(LOSS_HUBER)
#undef SR_LAUNCH
    default: return (int)cudaErrorInvalidValue;
  }
}
