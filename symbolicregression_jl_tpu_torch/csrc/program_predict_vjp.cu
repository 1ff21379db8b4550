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
// Per row: kernel #4's forward sweep (the tile interpreter of interp.cuh,
// so the values are kernel #4's), the root's cotangent seeded with ct, then
// the reverse sweep kernel #3 runs (interp.cuh's run_tile_reverse, which
// mirrors the JAX package's `_bwd_dispatch`). There is no loss, weight or
// validity output: autograd differentiates the loss outside the kernel,
// and validity is kernel #4's.
//
// Operand cotangents. Step results and constants have one reader each: a
// step's cotangent goes to registers or an adjoint row, a constant's adds
// into its lane sum. An argument may appear at several leaves (x1 * x1
// reads address 0 twice), so with per-member X each feature's cotangent
// adds into the tile's gx row for it from 0.0f, steps last to first and
// operand 1 before operand 2, as `store_adj` does in the JAX kernel; after
// the tile's sweep the thread stores its rows of gx. Shared X keeps no X
// cotangent (gx is not an output there).
//
// Design. One CTA per tree on the tile interpreter: the block decodes the
// tree's words once into a forward table and a reverse table
// (decode_grad_program), loads the constants once, then walks the rows in
// tiles of W with W / GRAD_ROWS threads of GRAD_ROWS consecutive rows
// each. A thread loads its rows' ct and arguments (vector loads where n and
// the pointer allow; per-member X from the tree's own X + t F n), runs
// run_tile, which stores every value the reverse sweep reads, then
// run_tile_reverse, and stores its gx rows as one vector store each
// (guarded at a ragged n or a misaligned row). One call launches the kernel
// once per step-count class (launch_step_classes), each launch with its
// class's shared memory. The template optimizer's trees are short (about
// 3.1 steps), so nearly all run in the m <= 4 class.
//
// Determinism and bits. W is the lane count the per-row layout gave
// (sr_program_predict_vjp_smem, the wrapper's `_block`): lane j adds each
// constant's cotangent over rows j, j + W, ... from 0.0f on live rows, and
// lane_tree_sum reduces the lanes in the fixed pairing (interp.cuh), so
// gcomp equals the per-row kernel's this replaced bit for bit, and so does
// gx (no sum across rows). No float atomics: two launches give the same
// bits.
//
// What bounds it on the H100: the forward's and the derivatives' FP32 ALU
// and SFU instructions per (step, row) and the shared-memory traffic of the
// stored values and adjoints; in per-member mode also the bytes of X, ct and
// gx (3.3 GB at 16,384 trees x 2 arguments x 10,000 rows). Shared X stays
// in L2.

#include "interp.cuh"

using namespace sr;

namespace {

// The shared memory of a class whose trees have at most `mhi` steps: its
// tables, value and adjoint rows, `nx` gx rows (F per-member, else 0) and
// `acc` rows of W float sums (one per constant).
struct VjpLayout {
  int nslot, acc;
  size_t stab, rtab, sv, sadj, sgx, sacc, sc, sflag, slast, sneed, sfree, total;
};

__host__ __device__ inline VjpLayout vjp_layout(int W, int mhi, int L, int CMAX, int F, int nx) {
  VjpLayout o;
  // A tree of m steps has at most 2m + 1 nodes, so it holds at most
  // tile_slots(2m + 1) results at once and has at most m + 1 constants.
  o.nslot = tile_slots(min(L, 2 * mhi + 1));
  o.acc = min(CMAX, mhi + 1);
  o.stab = 0;                                                      // int4 [mhi] forward
  o.rtab = o.stab + 16 * (size_t)mhi;                              // int4 [mhi] reverse
  o.sv = align_up(o.rtab + 16 * (size_t)mhi, 16);                  // float [(F + mhi - 1) * W]
  o.sadj = o.sv + 4 * (size_t)(F + mhi - 1) * W;                   // float [nslot * W]
  o.sgx = o.sadj + 4 * (size_t)o.nslot * W;                        // float [nx * W]
  o.sacc = o.sgx + 4 * (size_t)nx * W;                             // float [acc * W]
  o.sc = o.sacc + 4 * (size_t)o.acc * W;                           // float [CMAX + 1]
  o.sflag = o.sc + 4 * (size_t)(CMAX + 1);                         // int [mhi]
  o.slast = o.sflag + 4 * (size_t)mhi;                             // int [mhi]
  o.sneed = o.slast + 4 * (size_t)mhi;                             // int [mhi]
  o.sfree = o.sneed + 4 * (size_t)mhi;                             // int [nslot]
  o.total = o.sfree + 4 * (size_t)o.nslot;
  return o;
}

// GX: per-member X, whose cotangents are kept and stored to gx_out.
template <int K, bool GX>
__global__ void __launch_bounds__(TILE_MAX_W / GRAD_ROWS, GRAD_MIN_BLOCKS)
program_predict_vjp_kernel(
    const int* __restrict__ instr,      // [T, L]
    const int* __restrict__ nsteps,     // [T]
    const int* __restrict__ nconst,     // [T]
    const float* __restrict__ cvals,    // [T, CMAX]
    const float* __restrict__ X,        // [F, n] shared or [T, F, n] per member (GX)
    const float* __restrict__ ct,       // [T, n]
    const int* __restrict__ optab,      // [n_codes]
    int L, int CMAX, int F, int n, int W, int mlo, int mhi, int code_mask, int sign_shift,
    float* __restrict__ gcomp_out,      // [T, CMAX]
    float* __restrict__ gx_out) {       // [T, F, n] (GX only)
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  const int m = min(nsteps[t], L);
  if (m <= mlo || m > mhi) return;   // another class's tree
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const VjpLayout lay = vjp_layout(W, mhi, L, CMAX, F, GX ? F : 0);
  float* sacc = reinterpret_cast<float*>(smem + lay.sacc);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  const int4* stab = reinterpret_cast<const int4*>(smem + lay.stab);
  const int4* rtab = reinterpret_cast<const int4*>(smem + lay.rtab);

  const int nc = min(max(nconst[t], 0), CMAX);
  if (nc > lay.acc) __trap();   // more constants than a tree of m steps has
  for (int i = tid; i <= CMAX; i += P) sc[i] = i < CMAX ? cvals[(size_t)t * CMAX + i] : 0.0f;
  for (int i = tid; i < nc * W; i += P) sacc[i] = 0.0f;
  decode_grad_program<GX>(instr + (size_t)t * L, m, optab, code_mask, sign_shift, F, CMAX, L, W,
                          nc, lay.nslot, reinterpret_cast<int*>(smem + lay.sflag),
                          reinterpret_cast<int*>(smem + lay.slast),
                          reinterpret_cast<int*>(smem + lay.sneed),
                          reinterpret_cast<int*>(smem + lay.sfree),
                          reinterpret_cast<int4*>(smem + lay.stab),
                          reinterpret_cast<int4*>(smem + lay.rtab));

  const float* Xt = GX ? X + (size_t)t * F * n : X;
  const float* ctt = ct + (size_t)t * n;
  float* gxt = GX ? gx_out + (size_t)t * F * n : nullptr;
  float* col = reinterpret_cast<float*>(smem + lay.sv) + K * tid;
  float* adj = reinterpret_cast<float*>(smem + lay.sadj) + K * tid;
  float* gcol = reinterpret_cast<float*>(smem + lay.sgx) + K * tid;
  float* acol = sacc + K * tid;
  // n % K == 0 keeps every row of X, ct and gx (n apart) as aligned as its base.
  const bool vec_x = n % K == 0 && reinterpret_cast<uintptr_t>(Xt) % sizeof(RowPack<float, K>) == 0;
  const bool vec_ct = n % K == 0
                      && reinterpret_cast<uintptr_t>(ctt) % sizeof(RowPack<float, K>) == 0;
  const bool vec_gx = GX && n % K == 0
                      && reinterpret_cast<uintptr_t>(gxt) % sizeof(RowPack<float, K>) == 0;
  for (int r0 = 0; r0 < n; r0 += W) {
    const int r = r0 + K * tid;
    if (r >= n) break;   // no barrier in the row loop
    const int live = min(K, n - r);
    const RowPack<float, K> ck = load_rows<float, K>(ctt, r, n, vec_ct, 0.0f);
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
    if (GX) {
      const RowPack<float, K> zero = {};
      for (int f = 0; f < F; ++f) *reinterpret_cast<RowPack<float, K>*>(gcol + f * W) = zero;
    }
    float root[K], chk[K], cts[K];
    run_tile<float, K>(stab, m, col, sc, root, chk);
#pragma unroll
    for (int k = 0; k < K; ++k) cts[k] = ck.v[k];
    run_tile_reverse<float, K, GX>(rtab, m, col, sc, adj, acol, gcol, W, live, cts);
    if (GX) {
      for (int f = 0; f < F; ++f) {
        const RowPack<float, K> g = *reinterpret_cast<const RowPack<float, K>*>(gcol + f * W);
        float* out = gxt + (size_t)f * n;
        if (vec_gx && live == K) {
          *reinterpret_cast<RowPack<float, K>*>(out + r) = g;
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (k < live) out[r + k] = g.v[k];
          }
        }
      }
    }
  }

  __syncthreads();
  lane_tree_sum(sacc, W, nc);
  for (int j = tid; j < CMAX; j += P) gcomp_out[(size_t)t * CMAX + j] = j < nc ? sacc[j * W] : 0.0f;
}

template <bool GX>
cudaError_t launch_vjp(int T, int W, cudaStream_t stream, const int* instr, const int* nsteps,
                       const int* nconst, const float* cvals, const float* X, const float* ct,
                       const int* optab, int L, int CMAX, int F, int n, int code_mask,
                       int sign_shift, float* gcomp, float* gx) {
  const int nx = GX ? F : 0;
  if (vjp_layout(W, L, L, CMAX, F, nx).total > kSmemLimit) return cudaErrorInvalidValue;
  auto kern = program_predict_vjp_kernel<GRAD_ROWS, GX>;
  return launch_step_classes(L, [&](int mlo, int mhi) {
    const size_t smem = vjp_layout(W, mhi, L, CMAX, F, nx).total;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<T, W / GRAD_ROWS, smem, stream>>>(instr, nsteps, nconst, cvals, X, ct, optab, L, CMAX,
                                             F, n, W, mlo, mhi, code_mask, sign_shift, gcomp,
                                             gx);
    return cudaGetLastError();
  });
}

}  // namespace

// Shared memory of the per-row layout with `block` threads ((F + L) value
// rows, (F + CMAX + L + 1) adjoint rows and CMAX gradient rows of one float
// per thread, the constants, one reduction float per thread, the words):
// the wrapper's `_block` picks the lane count W as the largest block whose
// per-row layout fits, as it did when the kernel ran that layout, so W, and
// with it every sum's order, stays as it was.
extern "C" size_t sr_program_predict_vjp_smem(int block, int L, int CMAX, int F) {
  const size_t rows = (size_t)(F + L) + (F + CMAX + L + 1) + CMAX;
  return sizeof(float) * (rows * block + CMAX + block) + sizeof(int) * L;
}

// Launch on `stream` with W = `block` lanes (W / GRAD_ROWS threads per
// tree), one launch per step-count class; returns cudaGetLastError() (0 on
// success). `gx` may be null when per_member == 0.
extern "C" int sr_program_predict_vjp(const int* instr, const int* nsteps, const int* nconst,
                                      const float* cvals, const float* X, const float* ct,
                                      const int* optab, int T, int L, int CMAX, int F, int n,
                                      int block, int per_member, int code_mask, int sign_shift,
                                      float* gcomp, float* gx, void* stream) {
  if (T == 0) return 0;
  const int W = block;
  if (W % GRAD_ROWS != 0 || W > TILE_MAX_W || (W & (W - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (per_member && gx == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return per_member
      ? (int)launch_vjp<true>(T, W, s, instr, nsteps, nconst, cvals, X, ct, optab, L, CMAX, F, n,
                              code_mask, sign_shift, gcomp, gx)
      : (int)launch_vjp<false>(T, W, s, instr, nsteps, nconst, cvals, X, ct, optab, L, CMAX, F,
                               n, code_mask, sign_shift, gcomp, gx);
}
