// Kernel-structure variants of the program interpreter for NVIDIA Hopper
// (sm_90a): the instrument that splits one interpreter step into its costs.
//
// Replaces the TPU kernel of profiling/kernel_variants.py: `loss_variant`
// (its pallas_call) and the kernel body `_make_kernel`, an A/B harness of
// kernel #1's dispatch structure. Its Python side, with the plain PyTorch
// version of every variant, is
// symbolicregression_jl_tpu_torch/profiling/kernel_variants.py.
//
// What it computes. The legacy interpreter of kernel #1 before its dispatch
// plan: per tree a value buffer of F + CMAX + L rows,
//
//   rows 0..F-1           the X features of the row,
//   rows F..F+CMAX-1      the tree's constants, broadcast over the rows,
//   row F + CMAX + k      the result of step k, stored by every step,
//
// steps that read their operands from the buffer (word code << 24 | src1 <<
// 12 | src2) and a finiteness track; then the L2 loss of the root (the row
// of step m - 1) against y, summed over rows: loss_sum [T], and valid [T]
// = every executed step finite on every row, the sum finite, const_ok. The
// variants change one mechanism each (VARIANT in the Python module):
//
//   base      the switch over the legacy codes (0 identity, 1..B binary,
//             then unary, through the opcode table `optab`: the resolved
//             operator ids of interp.cuh), steps run in pairs, the second
//             at min(2 k + 1, L - 1) as the TPU kernel's unroll (an odd
//             step count runs one padding step more);
//   noswitch  every step a + b on its operands: loop, loads, store, track;
//   static    a + b of rows 0 and 1: no operand addressing either;
//   nostore   noswitch storing every step to the first step row: a timing
//             floor (the root of a tree of m > 1 steps reads a step row
//             never written, which this kernel zero-fills, so that the
//             output is defined: sum(y^2));
//   novmask   base without the finiteness track;
//   cond2     class (identity, binary, unary), then a switch inside it;
//   signmerge + and - in one case, a + (1 - 2 sign) b (exact), by the sign
//             bit 30 of the remapped word;
//   muldiv    signmerge plus * and / in one case, a * (div ? 1 / b : b):
//             two roundings for /, so not bit-equal to base;
//   opgroup   muldiv plus every unary of the bench set (exp, abs, cos)
//             computed and one selected by the index in bits 26-28;
//   nounroll  base with one step per loop turn;
//   cvec      the constants staged in shared memory once per block and
//             stored from there (base: a loop to nconst of global loads,
//             per tile and tree);
//   custatic  CMAX constant stores unrolled, no nconst;
//   bf16      base's switch over a bf16 value buffer, computed in float,
//             one step per turn, finiteness on the stored bf16 value by the
//             TPU kernel's test |v| <= bf16(3.38e38);
//   combo     signmerge + nounroll, run with 16 trees a block.
//
// Design. A block owns TB trees (8, 16 or 32: the TPU kernel's tree block)
// and walks the rows in tiles of W lanes with W / TILE_ROWS threads, each
// carrying TILE_ROWS consecutive rows through every step (kernel #1's tile
// shape): a step is one shared-memory word read, one table read, one
// dispatch and one operand address for four evaluations. A tile's X rows
// are loaded once and shared by the block's TB trees (tb16/tb32 amortize
// them further). Each thread reads and writes only its own columns of the
// buffer, so the row loop needs no barrier. W is the largest of 256, 128,
// 64, 32 whose layout fits with 32 trees and a float buffer, the same for
// every variant, so each lane sums the same rows in the same order and
// lane_tree_sum (interp.cuh) reduces them in the same fixed order: the
// exact variants (cond2, signmerge, nounroll, tb16, tb32, cvec, custatic,
// combo) give base's bits. Every operation is interp.cuh's (apply_binary,
// apply_unary, rn_*, the L2 loss), so each rounds as kernel #1's does.
//
// What bounds it on the H100: FP32 ALU and SFU work, T x S x n step
// evaluations (0.0098 ms at 8,192 trees of 8 steps over 10,000 rows at
// 67 TFLOP/s); the bytes (X, y and the words) are a few MB from L2. The
// buffer of F + CMAX + L rows for every lane (51 KB at the bench shapes, a
// block of 8 trees 61 KB) holds the card to three blocks, six warps, an
// SM, so a step's chain of dependent shared-memory reads is hardly hidden:
// the legacy layout's cost, which kernel #1's held-results layout removed.
// It is an instrument, not a path: no search launches it.

#include "interp.cuh"

using namespace sr;

namespace {

// Variant ids: symbolicregression_jl_tpu_torch/profiling/kernel_variants.py
// VARIANT_IDS holds the same numbers by name.
enum : int {
  V_BASE = 0, V_NOSWITCH = 1, V_STATIC = 2, V_NOSTORE = 3, V_NOVMASK = 4, V_COND2 = 5,
  V_SIGNMERGE = 6, V_MULDIV = 7, V_OPGROUP = 8, V_NOUNROLL = 9, V_CVEC = 10, V_CUSTATIC = 11,
  V_BF16 = 12, V_COMBO = 13
};

// Resolved operators past interp.cuh's ids: the reciprocal-select multiply
// and the grouped unary.
enum : int { OPX_MULDIV = 19, OPX_UGROUP = 20 };

constexpr int VK = TILE_ROWS;      // rows a thread carries through a step
constexpr int VMAX_TB = 32;        // the largest tree block
constexpr int VOPS = 128;          // entries of the opcode -> operator table
constexpr int CUSTATIC_MAX = 32;   // custatic's unrolled constant stores

__host__ __device__ constexpr bool runs_pairs(int v) {
  return v != V_NOUNROLL && v != V_COMBO && v != V_BF16;
}
__host__ __device__ constexpr int word_code_mask(int v) {
  return v == V_OPGROUP                      ? 0x3
         : v == V_MULDIV                     ? 0x1F
         : v == V_SIGNMERGE || v == V_COMBO  ? 0x3F
                                             : 0x7F;
}

// Byte offsets of a block's dynamic shared memory.
struct VarLayout {
  size_t sv, sacc, sw, sop, scv, sm, snc, sok, total;
};

template <typename S>
__host__ __device__ inline VarLayout var_layout(int W, int L, int CMAX, int F, int TB) {
  VarLayout o;
  o.sv = 0;                                                              // S [(F+CMAX+L) * W]
  o.sacc = align_up(o.sv + sizeof(S) * (size_t)(F + CMAX + L) * W, 16);  // float [TB * W]
  o.sw = o.sacc + 4 * (size_t)TB * W;                                    // int [TB * L]
  o.sop = o.sw + 4 * (size_t)TB * L;                                     // int [VOPS]
  o.scv = o.sop + 4 * (size_t)VOPS;                                      // float [TB * CMAX]
  o.sm = o.scv + 4 * (size_t)TB * CMAX;                                  // int [TB]
  o.snc = o.sm + 4 * (size_t)TB;                                         // int [TB]
  o.sok = o.snc + 4 * (size_t)TB;                                        // int [TB]
  o.total = o.sok + 4 * (size_t)TB;
  return o;
}

// The lane count W of every variant (0: none fits).
int variant_lanes(int L, int CMAX, int F) {
  for (int W = TILE_MAX_W; W >= 32; W >>= 1) {
    if (var_layout<float>(W, L, CMAX, F, VMAX_TB).total <= kSmemLimit) return W;
  }
  return 0;
}

template <typename S>
__device__ __forceinline__ void read_row(const S* at, float (&out)[VK]) {
  const RowPack<S, VK> p = *reinterpret_cast<const RowPack<S, VK>*>(at);
#pragma unroll
  for (int k = 0; k < VK; ++k) out[k] = to_c(p.v[k]);
}

template <typename S>
__device__ __forceinline__ void fill_row(S* at, float v) {
  RowPack<S, VK> p;
  const S s = from_c<S>(v);
#pragma unroll
  for (int k = 0; k < VK; ++k) p.v[k] = s;
  *reinterpret_cast<RowPack<S, VK>*>(at) = p;
}

__device__ __forceinline__ bool stored_finite(float v) { return isfinite(v); }
// The TPU kernel's bf16 test: |v| <= bf16(3.38e38) = 0x7F7E, so the largest
// finite bf16 value counts as not finite; NaN compares false.
__device__ __forceinline__ bool stored_finite(__nv_bfloat16 v) {
  return fabsf(__bfloat162float(v)) <= __int_as_float(0x7F7E0000);
}

#define SR_VAR_BIN(ID)                                                         \
  case ID:                                                                     \
    read_row<S>(col + i2 * W, b);                                              \
    _Pragma("unroll") for (int k = 0; k < VK; ++k) r[k] = apply_binary<float>(ID, a[k], b[k]); \
    break;
#define SR_VAR_UN(ID) \
  case ID:            \
    _Pragma("unroll") for (int k = 0; k < VK; ++k) r[k] = apply_unary<float>(ID, a[k]); \
    break;
#define SR_VAR_BINARY_CASES                                                      \
  SR_VAR_BIN(B_ADD) SR_VAR_BIN(B_SUB) SR_VAR_BIN(B_MUL) SR_VAR_BIN(B_DIV)        \
  SR_VAR_BIN(B_POW) SR_VAR_BIN(B_MOD) SR_VAR_BIN(B_MAX) SR_VAR_BIN(B_MIN)        \
  SR_VAR_BIN(B_ATAN2) SR_VAR_BIN(B_GT) SR_VAR_BIN(B_LT) SR_VAR_BIN(B_GE)         \
  SR_VAR_BIN(B_LE) SR_VAR_BIN(B_COND) SR_VAR_BIN(B_OR) SR_VAR_BIN(B_AND)
#define SR_VAR_UNARY_CASES                                                       \
  SR_VAR_UN(U_EXP) SR_VAR_UN(U_ABS) SR_VAR_UN(U_LOG) SR_VAR_UN(U_LOG2)           \
  SR_VAR_UN(U_LOG10) SR_VAR_UN(U_LOG1P) SR_VAR_UN(U_SQRT) SR_VAR_UN(U_CBRT)      \
  SR_VAR_UN(U_SIN) SR_VAR_UN(U_COS) SR_VAR_UN(U_TAN) SR_VAR_UN(U_SINH)           \
  SR_VAR_UN(U_COSH) SR_VAR_UN(U_TANH) SR_VAR_UN(U_ASIN) SR_VAR_UN(U_ACOS)        \
  SR_VAR_UN(U_ATAN) SR_VAR_UN(U_ASINH) SR_VAR_UN(U_ACOSH) SR_VAR_UN(U_ATANH)     \
  SR_VAR_UN(U_ATANH_CLIP) SR_VAR_UN(U_ERF) SR_VAR_UN(U_ERFC) SR_VAR_UN(U_GAMMA)  \
  SR_VAR_UN(U_SQUARE) SR_VAR_UN(U_CUBE) SR_VAR_UN(U_NEG) SR_VAR_UN(U_INV)        \
  SR_VAR_UN(U_RELU) SR_VAR_UN(U_ROUND) SR_VAR_UN(U_FLOOR) SR_VAR_UN(U_CEIL)      \
  SR_VAR_UN(U_SIGN)

// One step s of word `word` on the thread's VK rows: operands read from its
// column `col` of the buffer, the result stored to row BASE + s (nostore:
// BASE) and tracked in `fin`. `sop` maps the word's code to the operator;
// B is the number of binary operators (cond2's class bound).
template <typename S, int VAR>
__device__ __forceinline__ void var_step(int word, int s, S* col, int W, int BASE, int B,
                                         const int* sop, bool (&fin)[VK]) {
  const int i1 = (word >> 12) & 0xFFF;
  const int i2 = word & 0xFFF;
  float a[VK], b[VK], r[VK];
  if constexpr (VAR == V_STATIC) {
    read_row<S>(col, a);
    read_row<S>(col + W, b);
#pragma unroll
    for (int k = 0; k < VK; ++k) r[k] = rn_add(a[k], b[k]);
  } else if constexpr (VAR == V_NOSWITCH || VAR == V_NOSTORE) {
    read_row<S>(col + i1 * W, a);
    read_row<S>(col + i2 * W, b);
#pragma unroll
    for (int k = 0; k < VK; ++k) r[k] = rn_add(a[k], b[k]);
  } else if constexpr (VAR == V_COND2) {
    read_row<S>(col + i1 * W, a);
    const int code = (word >> 24) & word_code_mask(VAR);
    if (code == 0) {
#pragma unroll
      for (int k = 0; k < VK; ++k) r[k] = a[k];
    } else if (code <= B) {
      switch (sop[code]) {
        SR_VAR_BINARY_CASES
        default:
#pragma unroll
          for (int k = 0; k < VK; ++k) r[k] = qnan<float>();
      }
    } else {
      switch (sop[code]) {
        SR_VAR_UNARY_CASES
        default:
#pragma unroll
          for (int k = 0; k < VK; ++k) r[k] = qnan<float>();
      }
    }
  } else {
    // One switch for base and the merged variants: they differ only in the
    // word's decode and in the case a step takes.
    read_row<S>(col + i1 * W, a);
    switch (sop[(word >> 24) & word_code_mask(VAR)]) {
      case OPX_IDENT:
#pragma unroll
        for (int k = 0; k < VK; ++k) r[k] = a[k];
        break;
      case OPX_ADDSUB: {
        read_row<S>(col + i2 * W, b);
        const float sg = ((word >> 30) & 1) ? -1.0f : 1.0f;
#pragma unroll
        for (int k = 0; k < VK; ++k) r[k] = rn_add(a[k], rn_mul(sg, b[k]));
        break;
      }
      case OPX_MULDIV: {
        read_row<S>(col + i2 * W, b);
        const bool div = (word >> 29) & 1;
#pragma unroll
        for (int k = 0; k < VK; ++k) r[k] = rn_mul(a[k], div ? rn_div(1.0f, b[k]) : b[k]);
        break;
      }
      case OPX_UGROUP: {
        const int u = (word >> 26) & 0x7;
#pragma unroll
        for (int k = 0; k < VK; ++k) {
          const float e = apply_unary<float>(U_EXP, a[k]);
          const float m = apply_unary<float>(U_ABS, a[k]);
          const float c = apply_unary<float>(U_COS, a[k]);
          r[k] = u == 2 ? c : (u == 1 ? m : e);
        }
        break;
      }
      SR_VAR_BINARY_CASES
      SR_VAR_UNARY_CASES
      default:
#pragma unroll
        for (int k = 0; k < VK; ++k) r[k] = qnan<float>();
    }
  }
  RowPack<S, VK> st;
#pragma unroll
  for (int k = 0; k < VK; ++k) st.v[k] = from_c<S>(r[k]);
  *reinterpret_cast<RowPack<S, VK>*>(col + (VAR == V_NOSTORE ? BASE : BASE + s) * W) = st;
  if constexpr (VAR != V_NOVMASK) {
#pragma unroll
    for (int k = 0; k < VK; ++k) fin[k] = fin[k] && stored_finite(st.v[k]);
  }
}

#undef SR_VAR_BIN
#undef SR_VAR_UN

// The tree's constants into rows F..F+CMAX-1 of the thread's column: from
// the block's staged copy `scv` (cvec), CMAX unrolled stores (custatic) or
// a loop to the tree's `nc` constants (the rest), from the global `cv`.
template <typename S, int VAR>
__device__ __forceinline__ void preload(S* crow, int W, int CMAX, int nc,
                                        const float* __restrict__ cv, const float* scv) {
  if constexpr (VAR == V_CVEC) {
    for (int c = 0; c < CMAX; ++c) fill_row<S>(crow + c * W, scv[c]);
  } else if constexpr (VAR == V_CUSTATIC) {
#pragma unroll
    for (int c = 0; c < CUSTATIC_MAX; ++c) {
      if (c < CMAX) fill_row<S>(crow + c * W, cv[c]);
    }
  } else {
    for (int c = 0; c < nc; ++c) fill_row<S>(crow + c * W, cv[c]);
  }
}

template <typename S, int VAR>
__global__ void __launch_bounds__(TILE_MAX_W / VK) program_variants_kernel(
    const int* __restrict__ instr,      // [T, L]
    const int* __restrict__ nsteps,     // [T]
    const int* __restrict__ nconst,     // [T]
    const float* __restrict__ cvals,    // [T, CMAX]
    const int* __restrict__ const_ok,   // [T]
    const S* __restrict__ X,            // [F, n]
    const float* __restrict__ y,        // [n]
    const int* __restrict__ optab,      // [VOPS]
    int T, int TB, int L, int CMAX, int F, int n, int W, int B,
    float* __restrict__ loss_out, int* __restrict__ valid_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const VarLayout lay = var_layout<S>(W, L, CMAX, F, TB);
  S* sv = reinterpret_cast<S*>(smem + lay.sv);
  float* sacc = reinterpret_cast<float*>(smem + lay.sacc);
  int* sw = reinterpret_cast<int*>(smem + lay.sw);
  int* sop = reinterpret_cast<int*>(smem + lay.sop);
  float* scv = reinterpret_cast<float*>(smem + lay.scv);
  int* sm = reinterpret_cast<int*>(smem + lay.sm);
  int* snc = reinterpret_cast<int*>(smem + lay.snc);
  int* sok = reinterpret_cast<int*>(smem + lay.sok);
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const int t0 = blockIdx.x * TB;
  const int nt = min(TB, T - t0);
  const int BASE = F + CMAX;
  const LossSpec<float> ls{LOSS_L2, 0.0f};

  // The block's words, step and constant counts (and, for cvec, its
  // constants) once: they are the same for every tile.
  for (int i = tid; i < nt * L; i += P) sw[i] = instr[(size_t)t0 * L + i];
  for (int i = tid; i < VOPS; i += P) sop[i] = optab[i];
  for (int i = tid; i < nt; i += P) {
    sm[i] = min(nsteps[t0 + i], L);
    snc[i] = min(nconst[t0 + i], CMAX);
    sok[i] = 1;
  }
  if (VAR == V_CVEC) {
    for (int i = tid; i < nt * CMAX; i += P) scv[i] = cvals[(size_t)t0 * CMAX + i];
  }
  S* col = sv + VK * tid;
  float* acol = sacc + VK * tid;
  for (int t = 0; t < nt; ++t) {
#pragma unroll
    for (int k = 0; k < VK; ++k) acol[t * W + k] = 0.0f;
  }
  if (VAR == V_NOSTORE) {
    for (int s = 0; s < L; ++s) fill_row<S>(col + (BASE + s) * W, 0.0f);
  }
  __syncthreads();

  const bool vec_x = n % VK == 0 && reinterpret_cast<uintptr_t>(X) % sizeof(RowPack<S, VK>) == 0;
  const bool vec_y =
      n % VK == 0 && reinterpret_cast<uintptr_t>(y) % sizeof(RowPack<float, VK>) == 0;
  for (int r0 = 0; r0 < n; r0 += W) {
    const int r = r0 + VK * tid;
    const RowPack<float, VK> yk = load_rows<float, VK>(y, r, n, vec_y, 0.0f);
    for (int f = 0; f < F; ++f) {
      *reinterpret_cast<RowPack<S, VK>*>(col + f * W) =
          load_rows<S, VK>(X + (size_t)f * n, r, n, vec_x, from_c<S>(0.0f));
    }
    for (int t = 0; t < nt; ++t) {
      const int m = sm[t];
      const int* words = sw + t * L;
      preload<S, VAR>(col + F * W, W, CMAX, snc[t], cvals + (size_t)(t0 + t) * CMAX,
                      scv + t * CMAX);
      bool fin[VK];
#pragma unroll
      for (int k = 0; k < VK; ++k) fin[k] = true;
      if constexpr (runs_pairs(VAR)) {
#pragma unroll 1
        for (int s2 = 0; s2 < (m + 1) >> 1; ++s2) {
          var_step<S, VAR>(words[2 * s2], 2 * s2, col, W, BASE, B, sop, fin);
          const int s1 = min(2 * s2 + 1, L - 1);
          var_step<S, VAR>(words[s1], s1, col, W, BASE, B, sop, fin);
        }
      } else {
#pragma unroll 1
        for (int s = 0; s < m; ++s) var_step<S, VAR>(words[s], s, col, W, BASE, B, sop, fin);
      }
      float root[VK];
      read_row<S>(col + (BASE + m - 1) * W, root);
      RowPack<float, VK> acc = *reinterpret_cast<RowPack<float, VK>*>(acol + t * W);
      bool ok = true;
#pragma unroll
      for (int k = 0; k < VK; ++k) {
        if (r + k < n) {
          acc.v[k] = rn_add(acc.v[k], elementwise_loss<LOSS_L2>(ls, root[k], yk.v[k]));
          ok = ok && fin[k];
        }
      }
      *reinterpret_cast<RowPack<float, VK>*>(acol + t * W) = acc;
      if (!ok) sok[t] = 0;
    }
  }

  __syncthreads();
  lane_tree_sum(sacc, W, nt);
  for (int t = tid; t < nt; t += P) {
    const float total = sacc[t * W];
    loss_out[t0 + t] = total;
    valid_out[t0 + t] = (sok[t] != 0 && isfinite(total) && const_ok[t0 + t] != 0) ? 1 : 0;
  }
}

template <typename S, int VAR>
cudaError_t launch_variant(const int* instr, const int* nsteps, const int* nconst,
                           const float* cvals, const int* const_ok, const void* Xv,
                           const float* y, const int* optab, int T, int TB, int L, int CMAX,
                           int F, int n, int B, float* loss, int* valid, cudaStream_t stream) {
  const int W = variant_lanes(L, CMAX, F);
  if (W == 0) return cudaErrorInvalidValue;
  const size_t smem = var_layout<S>(W, L, CMAX, F, TB).total;
  const S* X = static_cast<const S*>(Xv);
  auto kern = program_variants_kernel<S, VAR>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (T + TB - 1) / TB;
  kern<<<grid, W / VK, smem, stream>>>(instr, nsteps, nconst, cvals, const_ok, X, y, optab, T,
                                       TB, L, CMAX, F, n, W, B, loss, valid);
  return cudaGetLastError();
}

}  // namespace

// Lanes W of every variant's launch for programs of L steps, CMAX constants
// and F features (0: no layout fits one block).
extern "C" int sr_program_variants_lanes(int L, int CMAX, int F) {
  return variant_lanes(L, CMAX, F);
}

// Launch variant `variant` (V_* above) with `tb` trees a block on `stream`:
// `optab` [128] maps each code of the variant's words to its operator, `X`
// is [F, n] float (bf16 for V_BF16), `y` [n]. Every src of a word must
// address a row of the buffer below F + CMAX + L (the programs of
// ops/program.py and synth_program do). Returns cudaGetLastError() (0 on
// success).
extern "C" int sr_program_variants(int variant, const int* instr, const int* nsteps,
                                   const int* nconst, const float* cvals, const int* const_ok,
                                   const void* X, const float* y, const int* optab, int T,
                                   int tb, int L, int CMAX, int F, int n, int B, float* loss,
                                   int* valid, void* stream) {
  if (T == 0) return 0;
  if (tb < 1 || tb > VMAX_TB || L < 1 || CMAX < 0 || F < 1 || n < 1 ||
      F + CMAX + L > 4096 || (variant == V_CUSTATIC && CMAX > CUSTATIC_MAX)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define SR_VARIANT(V, S)                                                                   \
  case V:                                                                                  \
    return (int)launch_variant<S, V>(instr, nsteps, nconst, cvals, const_ok, X, y, optab, T, \
                                     tb, L, CMAX, F, n, B, loss, valid, s);
  switch (variant) {
    SR_VARIANT(V_BASE, float)
    SR_VARIANT(V_NOSWITCH, float)
    SR_VARIANT(V_STATIC, float)
    SR_VARIANT(V_NOSTORE, float)
    SR_VARIANT(V_NOVMASK, float)
    SR_VARIANT(V_COND2, float)
    SR_VARIANT(V_SIGNMERGE, float)
    SR_VARIANT(V_MULDIV, float)
    SR_VARIANT(V_OPGROUP, float)
    SR_VARIANT(V_NOUNROLL, float)
    SR_VARIANT(V_CVEC, float)
    SR_VARIANT(V_CUSTATIC, float)
    SR_VARIANT(V_BF16, __nv_bfloat16)
    SR_VARIANT(V_COMBO, float)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SR_VARIANT
}
