// Predict-VJP kernel for NVIDIA Hopper (sm_90a): the backward of kernel #4.
//
// Replaces the TPU kernel `_make_program_predict_vjp_kernel` /
// `_fused_predict_vjp_program` in symbolicregression_jl_tpu/ops/fused_eval.py
// (Pallas). Given row cotangents ct[t, r] of kernel #4's predictions it
// computes, per tree t,
//
//   gcomp[t, c]  = d sum_r ct[t, r] * pred[t, r] / d cvals[t, c]
//                  (c < nconst[t]; 0 past it; raw, non-finite kept),
//   gx[t, f, r]  = d sum_r ct[t, r] * pred[t, r] / d X[t, f, r]
//                  (per-member X only; raw, since the template `D`
//                  operator reads a NaN there as invalid).
//
// Per row: kernel #4's forward sweep (interp.cuh, so the values are kernel
// #4's), the cotangent seeded at the root's slot, then a reverse sweep
// that mirrors the JAX package's `_bwd_dispatch` with the derivative table
// of interp.cuh (`vjp_binary`, `vjp_unary`). There is no loss and no
// weight: autograd differentiates the loss outside the kernel.
//
// Operand adjoints. Step regions and constants have one parent each and
// take plain stores, as in kernel #3. The X region differs: an argument
// may appear at several leaves (x1 * x1 has both operands at address 0),
// and its adjoint is gx, which is read. So the X region is zeroed per row
// and accumulated with `+=` in operand order (operand 1, then operand 2),
// as `store_adj` does in the JAX kernel.
//
// Determinism. Each constant's adjoint is added into a per-thread sum in
// row order, then the block reduces it with a fixed-order tree: no float
// atomics, so two launches give the same bits.
//
// Design. One CTA per tree, threads over rows (gx stores coalesce like
// pred's in kernel #4). Shared memory per block: (F + L) value rows,
// (F + CMAX + L + 1) adjoint rows and CMAX gradient rows, one float per
// thread each, plus the words and constants. What bounds it on the H100:
// the FP32 work of the forward and adjoint sweeps (about three times
// kernel #4's per row) or, in per-member mode, the bytes of X, ct and gx;
// making it fast is later work.

#include "interp.cuh"

using namespace sr;

namespace {

__global__ void program_predict_vjp_kernel(
    const int* __restrict__ instr,      // [T, L]
    const int* __restrict__ nsteps,     // [T]
    const int* __restrict__ nconst,     // [T]
    const float* __restrict__ cvals,    // [T, CMAX]
    const float* __restrict__ X,        // [F, n] shared or [T, F, n] per member
    const float* __restrict__ ct,       // [T, n]
    const int* __restrict__ optab,      // [n_codes]
    int L, int CMAX, int F, int n, int per_member, int code_mask, int sign_shift,
    float* __restrict__ gcomp_out,      // [T, CMAX]
    float* __restrict__ gx_out) {       // [T, F, n] (per member only)
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int base = F + CMAX;
  float* sv = smem;                                // [(F + L) * bd] values
  float* adj = sv + (size_t)(F + L) * bd;          // [(base + L + 1) * bd] adjoints
  float* gacc = adj + (size_t)(base + L + 1) * bd; // [CMAX * bd] per-thread gradients
  float* sc = gacc + (size_t)CMAX * bd;            // [CMAX] constants
  float* sred = sc + CMAX;                         // [bd] reduction scratch
  int* sins = reinterpret_cast<int*>(sred + bd);   // [L] instruction words

  for (int i = tid; i < L; i += bd) sins[i] = instr[(size_t)t * L + i];
  for (int i = tid; i < CMAX; i += bd) sc[i] = cvals[(size_t)t * CMAX + i];
  const int nc = nconst[t];
  for (int c = 0; c < nc; ++c) gacc[c * bd + tid] = 0.0f;
  __syncthreads();

  const float* Xt = per_member ? X + (size_t)t * F * n : X;
  const float* ctt = ct + (size_t)t * n;
  const int m = nsteps[t];
  const RowBuf b{sv, sc, F, base, base + L, bd, tid};
  // X-region adjoints accumulate, the others are written once.
  auto store = [&](int a, float v) {
    float& slot = adj[a * bd + tid];
    slot = a < F ? __fadd_rn(slot, v) : v;
  };
  bool ok = true;  // validity is kernel #4's business; unused here
  for (int r = tid; r < n; r += bd) {
    forward_row(b, sins, Xt, n, r, m, optab, code_mask, sign_shift, ok);
    for (int f = 0; f < F; ++f) adj[f * bd + tid] = 0.0f;
    adj[(base + m - 1) * bd + tid] = ctt[r];
    for (int k = m - 1; k >= 0; --k) {
      const float c = adj[(base + k) * bd + tid];
      const Step s = decode(sins[k], optab, code_mask, sign_shift);
      if (s.kind == K_ADDSUB) {
        store(s.i1, c);
        store(s.i2, __fmul_rn(s.sg, c));
      } else if (s.kind == K_BINARY) {
        float d1, d2;
        vjp_binary(s.id, b.rd(s.i1), b.rd(s.i2), c, d1, d2);
        store(s.i1, d1);
        store(s.i2, d2);
      } else if (s.kind == K_UNARY) {
        store(s.i1, vjp_unary(s.id, b.rd(s.i1), c));
      } else {
        store(s.i1, c);
      }
    }
    for (int cc = 0; cc < nc; ++cc)
      gacc[cc * bd + tid] = __fadd_rn(gacc[cc * bd + tid], adj[(F + cc) * bd + tid]);
    if (per_member)
      for (int f = 0; f < F; ++f) gx_out[((size_t)t * F + f) * n + r] = adj[f * bd + tid];
  }

  float* g = gcomp_out + (size_t)t * CMAX;
  for (int c = 0; c < nc; ++c) {
    __syncthreads();  // sred is read by thread 0 in the previous round
    block_sum(sred, gacc[c * bd + tid]);
    if (tid == 0) g[c] = sred[0];
  }
  for (int c = nc + tid; c < CMAX; c += bd) g[c] = 0.0f;
}

}  // namespace

// Dynamic shared memory a launch with `block` threads needs.
extern "C" size_t sr_program_predict_vjp_smem(int block, int L, int CMAX, int F) {
  const size_t rows = (size_t)(F + L) + (F + CMAX + L + 1) + CMAX;
  return sizeof(float) * (rows * block + CMAX + block) + sizeof(int) * L;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). `gx` may
// be null when per_member == 0.
extern "C" int sr_program_predict_vjp(const int* instr, const int* nsteps, const int* nconst,
                                      const float* cvals, const float* X, const float* ct,
                                      const int* optab, int T, int L, int CMAX, int F, int n,
                                      int block, int per_member, int code_mask, int sign_shift,
                                      float* gcomp, float* gx, void* stream) {
  if (T == 0) return 0;
  if (per_member && gx == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = sr_program_predict_vjp_smem(block, L, CMAX, F);
  cudaError_t err = cudaFuncSetAttribute(
      program_predict_vjp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  program_predict_vjp_kernel<<<T, block, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      instr, nsteps, nconst, cvals, X, ct, optab, L, CMAX, F, n, per_member, code_mask,
      sign_shift, gcomp, gx);
  return (int)cudaGetLastError();
}
