// Forward + adjoint program kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_multi_grad_kernel` / `fused_grad_multi`
// in symbolicregression_jl_tpu/ops/fused_eval.py (Pallas). For every pair
// of a tree t and one of its V constant vectors v it computes kernel #2's
// loss_sum[t, v] and valid[t, v] and the gradient of loss_sum with respect
// to the tree's constants, gcomp[t, v, c] for c < nconst[t] (0 past it).
//
// Per row: the forward sweep (kernel #2's arithmetic, so the loss is
// bit-equal to kernel #2's), the loss cotangent seeded with the row's
// weight and zeroed where w <= 0, then a reverse sweep over the steps that
// mirrors the JAX package's `_bwd_dispatch` (interp.cuh's reverse sweep,
// shared with kernel #5): each constant's cotangent adds straight into its
// row's per-lane gradient sum; X's and the zero row's cotangents are never
// read, so they are not kept. Weight-0 rows are not masked (their cotangent is
// exactly 0 and 0 * inf is NaN inside an operator's derivative, as in the
// JAX package); the wrapper zeroes non-finite gradients.
//
// Design. One CTA per tree, which owns all V of the tree's constant
// vectors, on the tile interpreter of interp.cuh: the block decodes the
// tree's words once into a forward table and a reverse table
// (decode_grad_program), then walks the rows in tiles of W (W / GRAD_ROWS
// threads, GRAD_ROWS rows each); on each tile it runs the vectors of a
// pass in turn, so the tile's X, y and w are read from L2 once per pass,
// not once per pair. For each vector run_tile stores every
// step value the reverse sweep reads in the step's own row, the root stays
// in registers for the loss and its cotangent, and run_tile_reverse walks
// the steps back with the cotangent of step k - 1 in registers and the
// others in adjoint rows reused by liveness. Each lane's loss terms and
// constant cotangents add in row order into per-lane float sums in shared
// memory (one row for the loss and one per constant, for each vector of
// the pass); the block sums each with lane_tree_sum (the fixed lane order
// of interp.cuh). W is the lane count the per-row layout gave
// (sr_program_grad_smem, the wrapper's `_block`), so every sum keeps the
// order of the per-row kernel this replaced: lane j sums rows j, j + W, ...
// from 0.0f. Hence the loss equals kernel #2's at the same W bit for bit,
// and loss, valid and gcomp equal the per-row kernel's.
//
// Shared memory against occupancy. A block's rows grow with its tree:
// F + m - 1 value rows, up to tile_slots adjoint rows and 1 + nc rows of
// sums per vector of a pass, W floats each. Sized for the longest program
// (L 30 at the bench shapes: 61 KB at W 256) every block would fit three
// to an SM, though most trees are short. So one call launches the kernel once per class of
// step counts (GRAD_STEP_CAPS: m <= 4, 5-12, longer), each launch with its
// class's shared memory and its blocks for the other classes' trees
// returning at once: 17 KB for the short class (eight blocks of 128
// threads per SM, as many as the registers allow), 39 KB and 61 KB for the
// others. A tree with few constants runs several vectors per pass.
//
// What bounds it on the H100: FP32 ALU and SFU work, the forward's and the
// derivatives' instructions per (step, row) and per pair, plus the
// shared-memory traffic of the stored values, adjoints and sums. X (200 KB
// at the bench shapes) stays in L2; device-memory traffic is the words,
// the constant vectors and the gradients.

#include "interp.cuh"

using namespace sr;

namespace {

// The shared memory of a class whose trees have at most `mhi` steps: its
// tables, value and adjoint rows, and `acc` rows of W float sums.
struct GradLayout {
  int nslot, acc;
  size_t stab, rtab, sv, sadj, sacc, sc, sok, sflag, slast, sneed, sfree, total;
};

__host__ __device__ inline GradLayout grad_layout(int W, int mhi, int L, int CMAX, int F) {
  GradLayout o;
  // A tree of m steps has at most 2m + 1 nodes, so it holds at most
  // tile_slots(2m + 1) results at once and has at most m + 1 constants.
  o.nslot = tile_slots(min(L, 2 * mhi + 1));
  o.acc = 1 + min(CMAX, mhi + 1);   // the loss and every constant of one vector
  o.stab = 0;                                                      // int4 [mhi] forward
  o.rtab = o.stab + 16 * (size_t)mhi;                              // int4 [mhi] reverse
  o.sv = align_up(o.rtab + 16 * (size_t)mhi, 16);                  // float [(F + mhi - 1) * W]
  o.sadj = o.sv + 4 * (size_t)(F + mhi - 1) * W;                   // float [nslot * W]
  o.sacc = o.sadj + 4 * (size_t)o.nslot * W;                       // float [acc * W]
  o.sc = o.sacc + 4 * (size_t)o.acc * W;                           // float [acc * (CMAX + 1)]
  o.sok = o.sc + 4 * (size_t)o.acc * (CMAX + 1);                   // int [acc]
  o.sflag = o.sok + 4 * (size_t)o.acc;                             // int [mhi]
  o.slast = o.sflag + 4 * (size_t)mhi;                             // int [mhi]
  o.sneed = o.slast + 4 * (size_t)mhi;                             // int [mhi]
  o.sfree = o.sneed + 4 * (size_t)mhi;                             // int [nslot]
  o.total = o.sfree + 4 * (size_t)o.nslot;
  return o;
}

template <int LOSS, int K>
__global__ void __launch_bounds__(TILE_MAX_W / GRAD_ROWS, GRAD_MIN_BLOCKS) program_grad_kernel(
    const int* __restrict__ instr,      // [T, L]
    const int* __restrict__ nsteps,     // [T]
    const int* __restrict__ nconst,     // [T]
    const float* __restrict__ cvals_v,  // [T, V, CMAX]
    const float* __restrict__ X,        // [F, n]
    const float* __restrict__ y,        // [n]
    const float* __restrict__ w,        // [n]
    const int* __restrict__ optab,      // [n_codes]
    int V, int L, int CMAX, int F, int n, int W, int mlo, int mhi, int code_mask,
    int sign_shift, float* __restrict__ loss_out, int* __restrict__ valid_out,
    float* __restrict__ gcomp_out) {    // [T, V, CMAX]
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  const int m = min(nsteps[t], L);
  if (m <= mlo || m > mhi) return;   // another class's tree
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const GradLayout lay = grad_layout(W, mhi, L, CMAX, F);
  float* sv = reinterpret_cast<float*>(smem + lay.sv);
  float* sacc = reinterpret_cast<float*>(smem + lay.sacc);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  int* sok = reinterpret_cast<int*>(smem + lay.sok);
  const int4* stab = reinterpret_cast<const int4*>(smem + lay.stab);
  const int4* rtab = reinterpret_cast<const int4*>(smem + lay.rtab);

  const int nc = min(max(nconst[t], 0), CMAX);
  const int G = 1 + nc;                    // sum rows per vector: the loss, then each constant
  if (G > lay.acc) __trap();               // more constants than a tree of m steps has
  const int vch = min(V, lay.acc / G);     // vectors per pass
  decode_grad_program<false>(instr + (size_t)t * L, m, optab, code_mask, sign_shift, F, CMAX, L, W, nc,
                      lay.nslot, reinterpret_cast<int*>(smem + lay.sflag),
                      reinterpret_cast<int*>(smem + lay.slast),
                      reinterpret_cast<int*>(smem + lay.sneed),
                      reinterpret_cast<int*>(smem + lay.sfree),
                      reinterpret_cast<int4*>(smem + lay.stab),
                      reinterpret_cast<int4*>(smem + lay.rtab));

  float* col = sv + K * tid;
  float* adj = reinterpret_cast<float*>(smem + lay.sadj) + K * tid;
  float* acol = sacc + K * tid;
  const bool vec_x = n % K == 0 && reinterpret_cast<uintptr_t>(X) % sizeof(RowPack<float, K>) == 0;
  const bool vec_yw = n % K == 0 && reinterpret_cast<uintptr_t>(y) % sizeof(RowPack<float, K>) == 0
                      && reinterpret_cast<uintptr_t>(w) % sizeof(RowPack<float, K>) == 0;
  const int CS = CMAX + 1;
  for (int v0 = 0; v0 < V; v0 += vch) {
    const int nv = min(vch, V - v0);
    const float* cv_t = cvals_v + ((size_t)t * V + v0) * CMAX;
    for (int i = tid; i < nv * CS; i += P) {
      const int c = i / CS, j = i - c * CS;
      sc[i] = j < CMAX ? cv_t[(size_t)c * CMAX + j] : 0.0f;
    }
    for (int c = tid; c < nv; c += P) sok[c] = 1;
    for (int i = tid; i < nv * G * W; i += P) sacc[i] = 0.0f;
    __syncthreads();

    for (int r0 = 0; r0 < n; r0 += W) {
      const int r = r0 + K * tid;
      if (r >= n) break;   // no barrier in the row loop
      const int live = min(K, n - r);
      const RowPack<float, K> yk = load_rows<float, K>(y, r, n, vec_yw, 0.0f);
      const RowPack<float, K> wk = load_rows<float, K>(w, r, n, vec_yw, 0.0f);
      for (int f0 = 0; f0 < F; f0 += TILE_LOADS) {
        RowPack<float, K> xs[TILE_LOADS];
#pragma unroll
        for (int j = 0; j < TILE_LOADS; ++j) {
          if (f0 + j < F) xs[j] = load_rows<float, K>(X + (size_t)(f0 + j) * n, r, n, vec_x, 0.0f);
        }
#pragma unroll
        for (int j = 0; j < TILE_LOADS; ++j) {
          if (f0 + j < F) *reinterpret_cast<RowPack<float, K>*>(col + (f0 + j) * W) = xs[j];
        }
      }
      for (int c = 0; c < nv; ++c) {
        const float* cv = sc + c * CS;
        float* av = acol + (size_t)c * G * W;
        float root[K], chk[K], ct[K];
        run_tile<float, K>(stab, m, col, cv, root, chk);
        RowPack<float, K> lsum = *reinterpret_cast<RowPack<float, K>*>(av);
        bool ok = true;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k < live) {
            lsum.v[k] = __fadd_rn(lsum.v[k], loss_term<LOSS>(root[k], yk.v[k], wk.v[k]));
            ok = ok && chk[k] == 0.0f;
          }
          const float dpred = loss_vjp<LOSS>(root[k], yk.v[k], wk.v[k]);
          ct[k] = wk.v[k] > 0.0f ? dpred : 0.0f;
        }
        *reinterpret_cast<RowPack<float, K>*>(av) = lsum;
        if (!ok) sok[c] = 0;
        run_tile_reverse<float, K, false>(rtab, m, col, cv, adj, av + W, nullptr, W, live, ct);
      }
    }

    __syncthreads();
    lane_tree_sum(sacc, W, nv * G);
    for (int c = tid; c < nv; c += P) {
      const float total = sacc[(size_t)c * G * W];
      const size_t pair = (size_t)t * V + v0 + c;
      loss_out[pair] = total;
      valid_out[pair] = (sok[c] != 0 && isfinite(total)) ? 1 : 0;
    }
    for (int i = tid; i < nv * CMAX; i += P) {
      const int c = i / CMAX, j = i - c * CMAX;
      gcomp_out[((size_t)t * V + v0 + c) * CMAX + j] =
          j < nc ? sacc[((size_t)c * G + 1 + j) * W] : 0.0f;
    }
    __syncthreads();
  }
}

template <int LOSS>
cudaError_t launch_grad(int T, int W, cudaStream_t stream, const int* instr, const int* nsteps,
                        const int* nconst, const float* cvals_v, const float* X, const float* y,
                        const float* w, const int* optab, int V, int L, int CMAX, int F, int n,
                        int code_mask, int sign_shift, float* loss, int* valid, float* gcomp) {
  if (W % GRAD_ROWS != 0 || W > TILE_MAX_W || (W & (W - 1)) != 0) return cudaErrorInvalidValue;
  if (grad_layout(W, L, L, CMAX, F).total > kSmemLimit) return cudaErrorInvalidValue;
  auto kern = program_grad_kernel<LOSS, GRAD_ROWS>;
  return launch_step_classes(L, [&](int mlo, int mhi) {
    const size_t smem = grad_layout(W, mhi, L, CMAX, F).total;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<T, W / GRAD_ROWS, smem, stream>>>(instr, nsteps, nconst, cvals_v, X, y, w, optab, V,
                                             L, CMAX, F, n, W, mlo, mhi, code_mask, sign_shift,
                                             loss, valid, gcomp);
    return cudaGetLastError();
  });
}

}  // namespace

// Shared memory of the per-row layout with `block` threads ((F + L) value
// rows, (F + CMAX + L + 1) adjoint rows and CMAX gradient rows of one float
// per thread, the constants, one reduction float per thread, the words):
// the wrapper's `_block` picks the lane count W as the largest block whose
// per-row layout fits, as it did when the kernel ran that layout, so W, and
// with it every sum's order, stays as it was (and equal to kernel #2's at
// the same shapes).
extern "C" size_t sr_program_grad_smem(int block, int L, int CMAX, int F) {
  const size_t rows = (size_t)(F + L) + (F + CMAX + L + 1) + CMAX;
  return sizeof(float) * (rows * block + CMAX + block) + sizeof(int) * L;
}

// Launch on `stream` with W = `block` lanes (W / GRAD_ROWS threads per
// tree), one launch per step-count class; returns cudaGetLastError() (0 on
// success).
extern "C" int sr_program_grad(const int* instr, const int* nsteps, const int* nconst,
                               const float* cvals_v, const float* X, const float* y,
                               const float* w, const int* optab, int T, int V, int L,
                               int CMAX, int F, int n, int block, int loss_kind,
                               int code_mask, int sign_shift, float* loss, int* valid,
                               float* gcomp, void* stream) {
  if ((long long)T * V == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (loss_kind) {
#define SR_LAUNCH(LK)                                                                        \
  case LK:                                                                                   \
    return (int)launch_grad<LK>(T, block, s, instr, nsteps, nconst, cvals_v, X, y, w, optab,   \
                                V, L, CMAX, F, n, code_mask, sign_shift, loss, valid, gcomp);
    SR_LAUNCH(LOSS_L2)
    SR_LAUNCH(LOSS_L1)
    SR_LAUNCH(LOSS_HUBER)
#undef SR_LAUNCH
    default: return (int)cudaErrorInvalidValue;
  }
}
