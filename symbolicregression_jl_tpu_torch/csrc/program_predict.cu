// Program-predict kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_program_predict_kernel` /
// `fused_predict_program` in symbolicregression_jl_tpu/ops/fused_eval.py
// (Pallas). It runs one packed, leaf-free program per tree over every row
// and returns the raw row predictions instead of a loss:
//
//   pred[t, r] = the value of step nsteps[t] - 1 on row r,
//   valid[t]   = every step finite on every row AND const_ok[t].
//
// Template expressions call it once per subexpression call site
// (models/template.py). X is either shared dataset columns [F, n] or one
// argument block per tree [T, F, n] (per_member != 0: the arguments are
// other subexpressions' outputs, as in g(f(x1), x2)). F is the call
// site's argument count, so the buffer base F + CMAX is a runtime value.
//
// The operator code, the decode and the forward row sweep live in
// interp.cuh, shared with kernels #1-#3 and #5, so a tree's predictions
// are the very values kernel #1 feeds into its loss.
//
// Design. One CTA per tree (a warp-uniform opcode switch), threads over
// rows, each thread's X features and step results in shared memory laid
// out [slot][thread], the tree's words and constants in shared memory
// once per block. Thread `tid` handles rows tid, tid + bd, ..., so a
// warp's stores of pred fall on 32 consecutive floats and coalesce.
//
// What bounds it on the H100: the store of pred, T x n floats (655 MB at
// the template cell's 16,384 candidates x 10,000 rows), against 3.35 TB/s;
// the FP32 work is (steps x rows) operator evaluations per tree. Making it
// reach that bound (register-resident step buffers, several trees per
// block) is later work.

#include "interp.cuh"

using namespace sr;

namespace {

__global__ void program_predict_kernel(
    const int* __restrict__ instr,      // [T, L]
    const int* __restrict__ nsteps,     // [T]
    const float* __restrict__ cvals,    // [T, CMAX]
    const int* __restrict__ const_ok,   // [T]
    const float* __restrict__ X,        // [F, n] shared or [T, F, n] per member
    const int* __restrict__ optab,      // [n_codes]
    int L, int CMAX, int F, int n, int per_member, int code_mask, int sign_shift,
    float* __restrict__ pred_out,       // [T, n]
    int* __restrict__ valid_out) {      // [T]
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  float* sv = smem;                               // [(F + L) * bd] per-row values
  float* sc = sv + (size_t)(F + L) * bd;          // [CMAX] constants
  int* sins = reinterpret_cast<int*>(sc + CMAX);  // [L] instruction words

  const int base = F + CMAX;
  for (int i = tid; i < L; i += bd) sins[i] = instr[(size_t)t * L + i];
  for (int i = tid; i < CMAX; i += bd) sc[i] = cvals[(size_t)t * CMAX + i];
  __syncthreads();

  const float* Xt = per_member ? X + (size_t)t * F * n : X;
  float* out = pred_out + (size_t)t * n;
  const int m = nsteps[t];
  const RowBuf b{sv, sc, F, base, base + L, bd, tid};
  bool ok = true;
  for (int r = tid; r < n; r += bd)
    out[r] = forward_row(b, sins, Xt, n, r, m, optab, code_mask, sign_shift, ok);

  const int all_ok = __syncthreads_and(ok ? 1 : 0);
  if (tid == 0) valid_out[t] = (all_ok && const_ok[t] != 0) ? 1 : 0;
}

}  // namespace

// Dynamic shared memory a launch with `block` threads needs.
extern "C" size_t sr_program_predict_smem(int block, int L, int CMAX, int F) {
  return sizeof(float) * ((size_t)(F + L) * block + CMAX) + sizeof(int) * L;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int sr_program_predict(const int* instr, const int* nsteps, const float* cvals,
                                  const int* const_ok, const float* X, const int* optab,
                                  int T, int L, int CMAX, int F, int n, int block,
                                  int per_member, int code_mask, int sign_shift,
                                  float* pred, int* valid, void* stream) {
  if (T == 0) return 0;
  const size_t smem = sr_program_predict_smem(block, L, CMAX, F);
  cudaError_t err = cudaFuncSetAttribute(
      program_predict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  program_predict_kernel<<<T, block, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      instr, nsteps, cvals, const_ok, X, optab, L, CMAX, F, n, per_member, code_mask,
      sign_shift, pred, valid);
  return (int)cudaGetLastError();
}
