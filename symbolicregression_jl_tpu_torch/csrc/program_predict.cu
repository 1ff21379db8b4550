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
// The operator code and the tile interpreter live in interp.cuh, shared
// with kernels #1-#3: each step computes as in every other kernel, so a
// tree's predictions are the very values kernel #1 feeds into its loss.
//
// Design. One CTA per tree on the tile interpreter: the block decodes the
// tree's words once into a table of resolved steps (decode_tile_program,
// R = F per-row rows and the held-results rows by liveness), loads the
// constants once, then walks the rows in tiles of W with W / TILE_ROWS
// threads. Each thread issues the loads of its TILE_ROWS consecutive rows'
// arguments together (vector loads where aligned), stores them in its own
// columns of the [row][lane] buffer, runs every step for its rows at once
// (run_tile) and writes the roots to pred[t, r..r+3] as one 16-byte store,
// so a warp stores 512 contiguous bytes (guarded stores at a ragged n or
// a misaligned row). Validity is every step's finiteness on the rows below
// n, and'ed over the block, and const_ok. There is no sum, so no lane
// order: W is the largest lane count whose layout fits (256 at every shape
// the port launches).
//
// What bounds it on the H100: the store of pred, T x n floats (655 MB at
// the template cell's 16,384 candidates x 10,000 rows) against 3.35 TB/s,
// next to the operators' own FP32 and SFU instructions, (steps x rows)
// evaluations per tree. Shared X (F x n floats) stays in L2; per-member X
// is read once from device memory.

#include "interp.cuh"

using namespace sr;

namespace {

__global__ void __launch_bounds__(TILE_MAX_W / TILE_ROWS) program_predict_kernel(
    const int* __restrict__ instr,      // [T, L]
    const int* __restrict__ nsteps,     // [T]
    const float* __restrict__ cvals,    // [T, CMAX]
    const int* __restrict__ const_ok,   // [T]
    const float* __restrict__ X,        // [F, n] shared or [T, F, n] per member
    const int* __restrict__ optab,      // [n_codes]
    int L, int CMAX, int F, int n, int W, int per_member, int code_mask, int sign_shift,
    float* __restrict__ pred_out,       // [T, n]
    int* __restrict__ valid_out) {      // [T]
  constexpr int K = TILE_ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const TileLayout lay = tile_layout<float>(W, L, CMAX, F, 0, 0, 1);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  const int4* stab = reinterpret_cast<const int4*>(smem + lay.stab);

  for (int i = tid; i <= CMAX; i += P) sc[i] = i < CMAX ? cvals[(size_t)t * CMAX + i] : 0.0f;
  const int m = min(nsteps[t], L);
  decode_tile_program(instr + (size_t)t * L, m, optab, code_mask, sign_shift, F, CMAX, L, W,
                      reinterpret_cast<int*>(smem + lay.sflag),
                      reinterpret_cast<int*>(smem + lay.slast),
                      reinterpret_cast<int*>(smem + lay.sfree),
                      reinterpret_cast<int4*>(smem + lay.stab));

  const float* Xt = per_member ? X + (size_t)t * F * n : X;
  float* out = pred_out + (size_t)t * n;
  float* col = reinterpret_cast<float*>(smem + lay.sv) + K * tid;
  const bool vec_x = n % K == 0 && reinterpret_cast<uintptr_t>(Xt) % sizeof(RowPack<float, K>) == 0;
  const bool vec_out = n % K == 0
                       && reinterpret_cast<uintptr_t>(out) % sizeof(RowPack<float, K>) == 0;
  bool ok = true;
  for (int r0 = 0; r0 < n; r0 += W) {
    const int r = r0 + K * tid;
    if (r >= n) break;   // no barrier in the row loop
    for (int f0 = 0; f0 < F; f0 += TILE_LOADS) {
      RowPack<float, K> xs[TILE_LOADS];
#pragma unroll
      for (int j = 0; j < TILE_LOADS; ++j) {
        if (f0 + j < F) xs[j] = load_rows<float, K>(Xt + (size_t)(f0 + j) * n, r, n, vec_x, 0.0f);
      }
#pragma unroll
      for (int j = 0; j < TILE_LOADS; ++j) {
        if (f0 + j < F) *reinterpret_cast<RowPack<float, K>*>(col + (f0 + j) * W) = xs[j];
      }
    }
    float root[K], chk[K];
    run_tile<float, K>(stab, m, col, sc, root, chk);
    if (vec_out && r + K <= n) {
      RowPack<float, K> p;
#pragma unroll
      for (int k = 0; k < K; ++k) p.v[k] = root[k];
      *reinterpret_cast<RowPack<float, K>*>(out + r) = p;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (r + k < n) out[r + k] = root[k];
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) ok = ok && (r + k >= n || chk[k] == 0.0f);
  }

  const int all_ok = __syncthreads_and(ok ? 1 : 0);
  if (tid == 0) valid_out[t] = (all_ok && const_ok[t] != 0) ? 1 : 0;
}

}  // namespace

// Dynamic shared memory of a launch with W = `block` lanes: the wrapper's
// `_block` picks the largest lane count whose layout fits.
extern "C" size_t sr_program_predict_smem(int block, int L, int CMAX, int F) {
  return tile_layout<float>(block, L, CMAX, F, 0, 0, 1).total;
}

// Launch on `stream` with W = `block` lanes (W / TILE_ROWS threads per
// tree); returns cudaGetLastError() (0 on success).
extern "C" int sr_program_predict(const int* instr, const int* nsteps, const float* cvals,
                                  const int* const_ok, const float* X, const int* optab,
                                  int T, int L, int CMAX, int F, int n, int block,
                                  int per_member, int code_mask, int sign_shift,
                                  float* pred, int* valid, void* stream) {
  if (T == 0) return 0;
  const int W = block;
  if (W % TILE_ROWS != 0 || W > TILE_MAX_W) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_layout<float>(W, L, CMAX, F, 0, 0, 1).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      program_predict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  program_predict_kernel<<<T, W / TILE_ROWS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      instr, nsteps, cvals, const_ok, X, optab, L, CMAX, F, n, W, per_member, code_mask,
      sign_shift, pred, valid);
  return (int)cudaGetLastError();
}
