// Device-side interpreter shared by the program kernels (sm_90a).
//
// program_eval.cu (kernel #1), program_multi.cu (#2), program_grad.cu
// (#3), program_predict.cu (#4) and program_predict_vjp.cu (#5) include
// this header, so all five compute every forward step, every elementwise
// loss and every row reduction with the same code: a (tree, constant
// vector) pair gives the same bits in each of them. The value buffer's
// storage is a template parameter: float for #1-#5, bf16 for the bf16
// forms of #1 and #2 (1b and 2b), which compute in float too.
//
// Instruction word: sign << 30 | code << 24 | src1 << 12 | src2, decoded
// as the JAX package's `_fwd_dispatch` decodes it. `optab[code]` maps
// each merged opcode of the operator set (`_dispatch_plan`) to its
// operator: kind << 8 | op id, kind 0 = identity (unmerged plans),
// 1 = binary, 2 = unary, 3 = the merged add/sub branch
// a + (1 - 2 sign) * b, whose identity steps read the zero row at
// address BASE + L.
//
// The reverse-mode table (vjp_binary, vjp_unary, loss_vjp) follows the
// JVP rules JAX applies to the operators' own definitions; its plain
// PyTorch version is symbolicregression_jl_tpu_torch/ops/vjp.py, which
// says where the non-finite values land and why.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sr {

// Operator ids; symbolicregression_jl_tpu_torch/ops/fused_eval.py
// `_KERNEL_OP_IDS` holds the same table by name.
enum : int {
  B_ADD = 0, B_SUB, B_MUL, B_DIV, B_POW, B_MOD, B_MAX, B_MIN, B_ATAN2,
  B_GT, B_LT, B_GE, B_LE, B_COND, B_OR, B_AND,
  U_EXP = 32, U_ABS, U_LOG, U_LOG2, U_LOG10, U_LOG1P, U_SQRT, U_CBRT,
  U_SIN, U_COS, U_TAN, U_SINH, U_COSH, U_TANH, U_ASIN, U_ACOS, U_ATAN,
  U_ASINH, U_ACOSH, U_ATANH, U_ATANH_CLIP, U_ERF, U_ERFC, U_GAMMA,
  U_SQUARE, U_CUBE, U_NEG, U_INV, U_RELU, U_ROUND, U_FLOOR, U_CEIL, U_SIGN
};

enum : int { K_IDENTITY = 0, K_BINARY = 1, K_UNARY = 2, K_ADDSUB = 3 };
enum : int { LOSS_L2 = 0, LOSS_L1 = 1, LOSS_HUBER = 2 };

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// Python-style remainder (sign of the divisor), as jnp.mod / torch.remainder.
__device__ __forceinline__ float py_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((m < 0.0f) != (b < 0.0f))) m = __fadd_rn(m, b);
  return m;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a || b != b) return qnan();
  return fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a || b != b) return qnan();
  return fminf(a, b);
}

__device__ __forceinline__ float safe_pow(float x, float y) {
  const bool is_int = (y == rintf(y));
  const bool is_odd = fabsf(py_mod(y, 2.0f)) == 1.0f;
  const float mag = powf(fabsf(x), y);
  if (is_int) {
    if (y < 0.0f && x == 0.0f) return qnan();
    return (is_odd && x < 0.0f) ? -mag : mag;
  }
  const bool bad = (y > 0.0f && x < 0.0f) || (y < 0.0f && x <= 0.0f);
  return bad ? qnan() : mag;
}

__device__ __forceinline__ float sign_of(float x) {
  if (x != x) return x;
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float gamma_fn(float x) {
  const float s = x > 0.0f ? 1.0f : sign_of(sinf(__fmul_rn(3.14159265358979323846f, x)));
  const float out = __fmul_rn(s, expf(lgammaf(x)));
  return isinf(out) ? qnan() : out;
}

__device__ float apply_binary(int id, float a, float b) {
  switch (id) {
    case B_ADD: return __fadd_rn(a, b);
    case B_SUB: return __fsub_rn(a, b);
    case B_MUL: return __fmul_rn(a, b);
    case B_DIV: return __fdiv_rn(a, b);
    case B_POW: return safe_pow(a, b);
    case B_MOD: return py_mod(a, b);
    case B_MAX: return nan_max(a, b);
    case B_MIN: return nan_min(a, b);
    case B_ATAN2: return atan2f(a, b);
    case B_GT: return a > b ? 1.0f : 0.0f;
    case B_LT: return a < b ? 1.0f : 0.0f;
    case B_GE: return a >= b ? 1.0f : 0.0f;
    case B_LE: return a <= b ? 1.0f : 0.0f;
    case B_COND: return a > 0.0f ? b : 0.0f;
    case B_OR: return (a > 0.0f || b > 0.0f) ? 1.0f : 0.0f;
    case B_AND: return (a > 0.0f && b > 0.0f) ? 1.0f : 0.0f;
    default: return qnan();
  }
}

__device__ float apply_unary(int id, float x) {
  switch (id) {
    case U_EXP: return expf(x);
    case U_ABS: return fabsf(x);
    case U_LOG: return x > 0.0f ? logf(x) : qnan();
    case U_LOG2: return x > 0.0f ? log2f(x) : qnan();
    case U_LOG10: return x > 0.0f ? log10f(x) : qnan();
    case U_LOG1P: return x > -1.0f ? log1pf(x) : qnan();
    case U_SQRT: return x >= 0.0f ? sqrtf(x) : qnan();
    case U_CBRT: return cbrtf(x);
    case U_SIN: return sinf(x);
    case U_COS: return cosf(x);
    case U_TAN: return tanf(x);
    case U_SINH: return sinhf(x);
    case U_COSH: return coshf(x);
    case U_TANH: return tanhf(x);
    case U_ASIN: return (x >= -1.0f && x <= 1.0f) ? asinf(x) : qnan();
    case U_ACOS: return (x >= -1.0f && x <= 1.0f) ? acosf(x) : qnan();
    case U_ATAN: return atanf(x);
    case U_ASINH: return asinhf(x);
    case U_ACOSH: return x >= 1.0f ? acoshf(x) : qnan();
    case U_ATANH: return (x >= -1.0f && x <= 1.0f) ? atanhf(x) : qnan();
    case U_ATANH_CLIP: return atanhf(__fsub_rn(py_mod(__fadd_rn(x, 1.0f), 2.0f), 1.0f));
    case U_ERF: return erff(x);
    case U_ERFC: return erfcf(x);
    case U_GAMMA: return gamma_fn(x);
    case U_SQUARE: return __fmul_rn(x, x);
    case U_CUBE: return __fmul_rn(__fmul_rn(x, x), x);
    case U_NEG: return -x;
    case U_INV: return __fdiv_rn(1.0f, x);
    case U_RELU: return x > 0.0f ? x : 0.0f;
    case U_ROUND: return rintf(x);
    case U_FLOOR: return floorf(x);
    case U_CEIL: return ceilf(x);
    case U_SIGN: return sign_of(x);
    default: return qnan();
  }
}

template <int LOSS>
__device__ __forceinline__ float elementwise_loss(float p, float y) {
  const float d = __fsub_rn(p, y);
  if (LOSS == LOSS_L2) return __fmul_rn(d, d);
  const float a = fabsf(d);
  if (LOSS == LOSS_L1) return a;
  // Huber with delta = 1: where(a <= 1, 0.5 * a * a, 1 * (a - 0.5)).
  return a <= 1.0f ? __fmul_rn(__fmul_rn(0.5f, a), a) : __fsub_rn(a, 0.5f);
}

// Storage of the value buffer: float (kernels #1-#5), or __nv_bfloat16
// (the bf16 forms 1b and 2b, graftstage's eval_precision="bf16" and
// optimizer_bf16_linesearch). A bf16 buffer is only storage: every step
// reads its operands as float, computes in float and rounds the result to
// bf16 (round to nearest even) as it stores it. For float both
// conversions are the identity, so the f32 kernels compile as before.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S>
__device__ __forceinline__ S from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Elements of storage type S in front of a block's float scratch, rounded
// up to keep the scratch 4-byte aligned (a no-op for float).
template <typename S>
__host__ __device__ constexpr size_t padded(size_t count) {
  return sizeof(S) >= 4 ? count : (count + 1) & ~(size_t)1;
}

// The loss term of one row: where(w > 0, elt, 0) * w.
template <int LOSS>
__device__ __forceinline__ float loss_term(float v, float yr, float wr) {
  const float elt = elementwise_loss<LOSS>(v, yr);
  return __fmul_rn(wr > 0.0f ? elt : 0.0f, wr);
}

// ---------------------------------------------------------------------------
// Tile interpreter of kernels #1-#5 (program_eval.cu, program_multi.cu,
// program_grad.cu, program_predict.cu, program_predict_vjp.cu)
// ---------------------------------------------------------------------------
//
// A block owns one tree and, for kernels #2 and #3, all of the tree's
// constant vectors. It decodes the tree's m instruction words once into a
// table of resolved steps in shared memory (decode_tile_program); each
// thread then carries K rows through every step (run_tile), so one table
// read, one operator dispatch and one operand address serve K independent
// evaluations; every step is warp-uniform. Kernels #2 and #3 run their
// vectors in turn on each tile of rows, so the tile's X, y and w are read
// from L2 once for all of them. Kernels #3 and #5 add a reverse sweep over
// a second decoded table (decode_grad_program, run_tile_reverse, below).
//
// The fixed lane order. Every (tree, constant vector) sum keeps the order
// of the per-row kernels these replaced, which ran one row per thread: W
// reduction lanes; lane j sums its terms over rows j, j + W, j + 2W, ... in
// that order from 0.0f; then lane_tree_sum's pairwise tree, strides W/2
// down to 1, pair (i, i + s), the per-row kernels' block reduction. W is
// the block size the wrappers' `_block` (ops/fused_eval.py) picks from the
// per-row layout's shared memory, not the tile kernels' thread count: a
// tile kernel runs W / K threads (K = TILE_ROWS for #1, #2 and #4,
// GRAD_ROWS for #3 and #5), thread i owns lanes K * i ... K * i + K - 1, a
// tile is W consecutive rows (one row of each lane) and the tiles run in
// row order. Three bit checks rest on this order: kernel #2 with one
// constant vector equals #1's plain form (both run tree_loss_sums); kernel
// #3's loss, whose lanes sum the same terms in the same order at the same W
// (its gradient lanes sum each constant's cotangents so too), equals #2's
// on the same constant vectors; and #5's gcomp, whose lanes sum each
// constant's cotangents so, equals the per-row #5's. Kernel #4 sums
// nothing, so it has no lane order.
//
// The value buffer of a tile is [R + tile_slots(L)][W] in the storage
// type: R per-row rows (the X features, then the parametric form's
// parameter values), then the rows that hold step results still to be
// read. A thread reads and writes only its own columns, so the row loop
// needs no barrier. A step's result stays in registers for the next step
// and is stored only when a later step reads it, in a row that is free
// again once its last reader has run. In a program compiled from a tree
// (ops/program.py: post-order, every step read once, by its parent) the
// results held at once are left operands waiting for their right operand's
// subtree; each needs its own subtree (two nodes at least), its parent and,
// under the last of them, a step of two nodes, so a tree of L nodes holds at
// most (L - 2) / 3 of them. A program outside that contract traps.

constexpr int TILE_ROWS = 4;              // rows each thread carries through a step
constexpr int TILE_MAX_W = 256;           // the largest lane count `_block` picks
constexpr int TILE_VCH = 8;               // constant vectors per pass over the rows (#2)
constexpr int TILE_LOADS = 4;             // per-row rows loaded before any is stored
constexpr int TILE_MIN_BLOCKS = 16;       // #1: blocks per SM its registers must allow (64 a thread)
constexpr size_t kSmemLimit = 232448;     // bytes of shared memory one H100 block may use

// Rows for held step results in a program of L steps (see above).
__host__ __device__ constexpr int tile_slots(int L) { return L > 2 ? (L - 2) / 3 : 0; }

// Resolved step: x = op | sign << 8, y and z the operands, w the buffer
// offset its result is stored at (-1: not stored).
// op is the operator id of apply_binary / apply_unary, or one of these:
enum : int { OPX_ADDSUB = 16, OPX_IDENT = 17, OPX_NAN = 18 };
// Operand: offset << 2 | kind; a row operand's offset is its buffer row
// times W, a constant's its index in the vector (CMAX: the zero row).
enum : int { OPD_ROW = 0, OPD_CONST = 1, OPD_PREV = 2 };

// One thread's TILE_ROWS consecutive values of a buffer row, moved as one
// vector load or store.
template <typename S, int K>
struct alignas(sizeof(S) * K) RowPack {
  S v[K];
};

__host__ __device__ constexpr size_t align_up(size_t at, size_t a) { return (at + a - 1) / a * a; }

// Byte offsets of a tile block's dynamic shared memory, for passes of
// `vch` constant vectors (kernel #4: one vector, its row of lane sums
// unused).
struct TileLayout {
  size_t stab, sv, sacc, sc, sbank, sok, sflag, slast, sfree, total;
};

template <typename S>
__host__ __device__ inline TileLayout tile_layout(int W, int L, int CMAX, int R, int NP, int NC,
                                                  int vch) {
  const int rows = R + tile_slots(L);
  TileLayout o;
  o.stab = 0;                                                             // int4 [L]
  o.sv = align_up(o.stab + 16 * (size_t)L, 16);                           // S [rows * W]
  o.sacc = align_up(o.sv + sizeof(S) * (size_t)rows * W, 16);             // float [vch * W]
  o.sc = o.sacc + 4 * (size_t)vch * W;                                    // S [vch * (CMAX+1)]
  o.sbank = o.sc + sizeof(S) * (size_t)vch * (CMAX + 1);                  // S [NP * NC]
  o.sok = align_up(o.sbank + sizeof(S) * (size_t)NP * NC, 4);             // int [vch]
  o.sflag = o.sok + 4 * (size_t)vch;                                      // int [L]
  o.slast = o.sflag + 4 * (size_t)L;                                      // int [L]
  o.sfree = o.slast + 4 * (size_t)L;                                      // int [tile_slots(L)]
  o.total = o.sfree + 4 * (size_t)tile_slots(L);
  return o;
}

// Step u reads buffer address a: when a is step j's result and u reads it
// later than at once (j < u - 1), j is held until its last reader.
__device__ __forceinline__ void mark_held(int a, int u, int base, int zero_addr, int* slast) {
  if (a >= base && a < zero_addr && a - base < u - 1) atomicMax(&slast[a - base], u);
}

// The operand at buffer address `a` of step u: per-row value (a < R),
// constant, an earlier step, or the zero row.
__device__ __forceinline__ int operand_desc(int a, int u, int R, int base, int zero_addr,
                                            int CMAX, int W, const int* sflag) {
  if (a < R) return (a * W) << 2 | OPD_ROW;
  if (a < base) return (a - R) << 2 | OPD_CONST;
  if (a >= zero_addr) return CMAX << 2 | OPD_CONST;
  const int j = a - base;
  if (j == u - 1) return OPD_PREV;
  if (j > u - 1 || sflag[j] < 0) __trap();   // not a tree's post-order program
  return ((R + sflag[j]) * W) << 2 | OPD_ROW;
}

// The resolved op of an optab entry (see OPX_ADDSUB).
__device__ __forceinline__ int tile_op(int entry) {
  const int kind = entry >> 8;
  const int id = entry & 0xFF;
  if (kind == K_ADDSUB) return OPX_ADDSUB;
  if (kind == K_BINARY) return id < 16 ? id : OPX_NAN;
  if (kind == K_UNARY) return (id >= U_EXP && id <= U_SIGN) ? id : OPX_NAN;
  return OPX_IDENT;
}

// Rows by liveness for the tree's m words (buffer addresses base.. of its
// steps, zero_addr of the zero row): `slast` [m] gets each step's last
// reader later than the next step (-1: none), `sflag` [m] the row of
// `nslot` its result is held in (-1: not held); `sfree` [nslot] is
// scratch (the step after which a row is free). Every thread of the block
// calls it; it ends with a barrier.
__device__ void tile_liveness(const int* __restrict__ words, int m,
                              const int* __restrict__ optab, int code_mask, int base,
                              int zero_addr, int nslot, int* sflag, int* slast, int* sfree) {
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  for (int u = tid; u < m; u += P) slast[u] = -1;
  for (int i = tid; i < nslot; i += P) sfree[i] = -1;
  __syncthreads();
  for (int u = tid; u < m; u += P) {
    const int word = words[u];
    const int kind = optab[(word >> 24) & code_mask] >> 8;
    mark_held((word >> 12) & 0xFFF, u, base, zero_addr, slast);
    if (kind == K_BINARY || kind == K_ADDSUB) mark_held(word & 0xFFF, u, base, zero_addr, slast);
  }
  __syncthreads();
  if (tid == 0) {
    // Step u's result takes a row whose holder's last reader is u or
    // earlier (operands are read before the result is stored).
    for (int u = 0; u < m; ++u) {
      sflag[u] = -1;
      if (slast[u] < 0) continue;
      int row = 0;
      while (row < nslot && sfree[row] > u) ++row;
      if (row == nslot) __trap();   // more held results than a tree's program has
      sflag[u] = row;
      sfree[row] = slast[u];
    }
  }
  __syncthreads();
}

// Decodes the tree's m words into `stab` [m], held results in the rows
// tile_liveness gives them. Scratch: `slast` and `sflag` [m], `sfree`
// [tile_slots(L)]. Every thread of the block calls it; it ends with a
// barrier.
__device__ void decode_tile_program(const int* __restrict__ words, int m,
                                    const int* __restrict__ optab, int code_mask, int sign_shift,
                                    int R, int CMAX, int L, int W, int* sflag, int* slast,
                                    int* sfree, int4* stab) {
  const int base = R + CMAX;
  const int zero_addr = base + L;
  tile_liveness(words, m, optab, code_mask, base, zero_addr, tile_slots(L), sflag, slast, sfree);
  for (int u = threadIdx.x; u < m; u += blockDim.x) {
    const int word = words[u];
    const int entry = optab[(word >> 24) & code_mask];
    const int kind = entry >> 8;
    const bool two = kind == K_BINARY || kind == K_ADDSUB;
    const int d1 = operand_desc((word >> 12) & 0xFFF, u, R, base, zero_addr, CMAX, W, sflag);
    const int d2 = two ? operand_desc(word & 0xFFF, u, R, base, zero_addr, CMAX, W, sflag) : 0;
    const int sign = (word >> sign_shift) & 1;
    stab[u] = make_int4(tile_op(entry) | sign << 8, d1, d2,
                        sflag[u] >= 0 ? (R + sflag[u]) * W : -1);
  }
  __syncthreads();
}

// One operand for the thread's K rows: its column of a buffer row, a
// constant of the vector `cv`, or the previous step's values.
template <typename S, int K>
__device__ __forceinline__ void tile_operand(int desc, const S* col, const S* cv,
                                             const float (&prev)[K], float (&out)[K]) {
  const int kind = desc & 3;
  if (kind == OPD_ROW) {
    const RowPack<S, K> p = *reinterpret_cast<const RowPack<S, K>*>(col + (desc >> 2));
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = to_f32(p.v[k]);
  } else if (kind == OPD_CONST) {
    const float c = to_f32(cv[desc >> 2]);
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = c;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = prev[k];
  }
}

// Runs the decoded program on the thread's K rows of the tile, whose
// per-row values are loaded in its column `col`, with the constants `cv`
// (CMAX + 1 of them, the last 0): each step applies its operator
// (apply_binary, apply_unary, or the merged add/sub branch), rounds to S and
// keeps the stored value for the next step; root[k] is the last step's
// stored value. chk[k] stays 0 while every step's float value on row k is
// finite and is NaN after (r * 0 is NaN exactly for an infinite or NaN r,
// and NaN stays). With a bf16 buffer a finite value past bf16's range
// stores as inf with chk still 0: the inf surfaces in the next step or in
// the loss, as in the TPU kernel.
template <typename S, int K>
__device__ __forceinline__ void run_tile(const int4* __restrict__ stab, int m, S* col,
                                         const S* cv, float (&root)[K], float (&chk)[K]) {
  float prev[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    prev[k] = 0.0f;
    chk[k] = 0.0f;
  }
  int4 d = m > 0 ? stab[0] : make_int4(0, 0, 0, -1);
  for (int s = 0; s < m; ++s) {
    const int4 dn = s + 1 < m ? stab[s + 1] : d;   // the next step's entry, ahead of its use
    float a[K], b[K], r[K];
    tile_operand<S, K>(d.y, col, cv, prev, a);
    // The second operand loads inside the binary cases: fewer values live
    // across the dispatch (64 registers hold the unrolled operators).
#define SR_TILE_BIN(ID)                        \
  case ID:                                     \
    tile_operand<S, K>(d.z, col, cv, prev, b); \
    _Pragma("unroll") for (int k = 0; k < K; ++k) r[k] = apply_binary(ID, a[k], b[k]); \
    break;
#define SR_TILE_UN(ID) \
  case ID:             \
    _Pragma("unroll") for (int k = 0; k < K; ++k) r[k] = apply_unary(ID, a[k]); \
    break;
    switch (d.x & 0xFF) {
      case OPX_ADDSUB: {
        tile_operand<S, K>(d.z, col, cv, prev, b);
        const float sg = (d.x & 0x100) ? -1.0f : 1.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) r[k] = __fadd_rn(a[k], __fmul_rn(sg, b[k]));
        break;
      }
      case OPX_IDENT:
#pragma unroll
        for (int k = 0; k < K; ++k) r[k] = a[k];
        break;
      SR_TILE_BIN(B_ADD) SR_TILE_BIN(B_SUB) SR_TILE_BIN(B_MUL) SR_TILE_BIN(B_DIV)
      SR_TILE_BIN(B_POW) SR_TILE_BIN(B_MOD) SR_TILE_BIN(B_MAX) SR_TILE_BIN(B_MIN)
      SR_TILE_BIN(B_ATAN2) SR_TILE_BIN(B_GT) SR_TILE_BIN(B_LT) SR_TILE_BIN(B_GE)
      SR_TILE_BIN(B_LE) SR_TILE_BIN(B_COND) SR_TILE_BIN(B_OR) SR_TILE_BIN(B_AND)
      SR_TILE_UN(U_EXP) SR_TILE_UN(U_ABS) SR_TILE_UN(U_LOG) SR_TILE_UN(U_LOG2)
      SR_TILE_UN(U_LOG10) SR_TILE_UN(U_LOG1P) SR_TILE_UN(U_SQRT) SR_TILE_UN(U_CBRT)
      SR_TILE_UN(U_SIN) SR_TILE_UN(U_COS) SR_TILE_UN(U_TAN) SR_TILE_UN(U_SINH)
      SR_TILE_UN(U_COSH) SR_TILE_UN(U_TANH) SR_TILE_UN(U_ASIN) SR_TILE_UN(U_ACOS)
      SR_TILE_UN(U_ATAN) SR_TILE_UN(U_ASINH) SR_TILE_UN(U_ACOSH) SR_TILE_UN(U_ATANH)
      SR_TILE_UN(U_ATANH_CLIP) SR_TILE_UN(U_ERF) SR_TILE_UN(U_ERFC) SR_TILE_UN(U_GAMMA)
      SR_TILE_UN(U_SQUARE) SR_TILE_UN(U_CUBE) SR_TILE_UN(U_NEG) SR_TILE_UN(U_INV)
      SR_TILE_UN(U_RELU) SR_TILE_UN(U_ROUND) SR_TILE_UN(U_FLOOR) SR_TILE_UN(U_CEIL)
      SR_TILE_UN(U_SIGN)
      default:
#pragma unroll
        for (int k = 0; k < K; ++k) r[k] = qnan();
    }
#undef SR_TILE_BIN
#undef SR_TILE_UN
    RowPack<S, K> st;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      chk[k] = __fmaf_rn(r[k], 0.0f, chk[k]);
      st.v[k] = from_f32<S>(r[k]);
      prev[k] = to_f32(st.v[k]);
    }
    if (d.w >= 0) *reinterpret_cast<RowPack<S, K>*>(col + d.w) = st;
    d = dn;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) root[k] = prev[k];
}

// K consecutive values at `src[r]`, r = the thread's first row of the tile:
// one vector load where the whole pack is in range and aligned, else one
// guarded load each (rows past n read `fill`).
template <typename T, int K>
__device__ __forceinline__ RowPack<T, K> load_rows(const T* __restrict__ src, int r, int n,
                                                   bool vec, T fill) {
  RowPack<T, K> p;
  if (vec && r + K <= n) {
    p = *reinterpret_cast<const RowPack<T, K>*>(src + r);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) p.v[k] = r + k < n ? src[r + k] : fill;
  }
  return p;
}

// Sums `count` arrays of W floats (x[c * W + i], W a power of two) in the
// fixed lane order's pairing: strides W/2 down to 1, x[i] = x[i] + x[i + s].
// The sums land in x[c * W]. No float atomics, so one input always gives
// one result. Every thread of the block calls it.
__device__ __forceinline__ void lane_tree_sum(float* x, int W, int count) {
  int sh = 0;
  while ((1 << sh) < W) ++sh;
  for (int s = W >> 1; s > 0; s >>= 1) {
    --sh;
    for (int idx = threadIdx.x; idx < count * s; idx += blockDim.x) {
      float* row = x + (idx >> sh) * W;
      const int i = idx & (s - 1);
      row[i] = __fadd_rn(row[i], row[i + s]);
    }
    __syncthreads();
  }
}

// The body of a tile block (blockDim.x = W / K): the loss sums of one tree
// over all n rows for each of its V constant vectors `cvals` [V, CMAX], in
// passes of `vch` vectors that share each tile's X, y and w. The
// parametric form (PARAM) fills per-row rows F..F+NP-1 with bank[p,
// class[r]] (the tree's bank [NP, NC], class clipped to [0, NC)). Calls
// emit(v, sum, ok) once per vector from one thread; ok: every step finite
// on every row below n.
template <typename S, int LOSS, bool PARAM, int K, typename Emit>
__device__ __forceinline__ void tree_loss_sums(
    const int* __restrict__ words, int m, const float* __restrict__ cvals,
    const float* __restrict__ bank, const int* __restrict__ class_idx,
    const S* __restrict__ X, const float* __restrict__ y, const float* __restrict__ w,
    const int* __restrict__ optab, int V, int vch, int L, int CMAX, int F, int NP, int NC, int n,
    int W, int code_mask, int sign_shift, unsigned char* smem, Emit emit) {
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const int R = F + NP;
  const TileLayout lay = tile_layout<S>(W, L, CMAX, R, NP, NC, vch);
  int4* stab = reinterpret_cast<int4*>(smem + lay.stab);
  S* sv = reinterpret_cast<S*>(smem + lay.sv);
  float* sacc = reinterpret_cast<float*>(smem + lay.sacc);
  S* sc = reinterpret_cast<S*>(smem + lay.sc);
  S* sbank = reinterpret_cast<S*>(smem + lay.sbank);
  int* sok = reinterpret_cast<int*>(smem + lay.sok);

  if (PARAM) {
    for (int i = tid; i < NP * NC; i += P) sbank[i] = from_f32<S>(bank[i]);
  }
  decode_tile_program(words, m, optab, code_mask, sign_shift, R, CMAX, L, W,
                      reinterpret_cast<int*>(smem + lay.sflag),
                      reinterpret_cast<int*>(smem + lay.slast),
                      reinterpret_cast<int*>(smem + lay.sfree), stab);

  S* col = sv + K * tid;
  float* acol = sacc + K * tid;
  const bool vec_x = n % K == 0 && reinterpret_cast<uintptr_t>(X) % sizeof(RowPack<S, K>) == 0;
  const bool vec_yw = n % K == 0 && reinterpret_cast<uintptr_t>(y) % sizeof(RowPack<float, K>) == 0
                      && reinterpret_cast<uintptr_t>(w) % sizeof(RowPack<float, K>) == 0;
  const int CS = CMAX + 1;
  for (int v0 = 0; v0 < V; v0 += vch) {
    const int nv = min(vch, V - v0);
    for (int i = tid; i < nv * CS; i += P) {
      const int c = i / CS, j = i - c * CS;
      sc[i] = from_f32<S>(j < CMAX ? cvals[(size_t)(v0 + c) * CMAX + j] : 0.0f);
    }
    for (int c = tid; c < nv; c += P) sok[c] = 1;
    for (int c = 0; c < nv; ++c) {
#pragma unroll
      for (int k = 0; k < K; ++k) acol[c * W + k] = 0.0f;
    }
    __syncthreads();

    for (int r0 = 0; r0 < n; r0 += W) {
      const int r = r0 + K * tid;
      // The tile's loads are issued before their values are stored, so
      // they travel together (TILE_LOADS features at a time).
      const RowPack<float, K> yk = load_rows<float, K>(y, r, n, vec_yw, 0.0f);
      const RowPack<float, K> wk = load_rows<float, K>(w, r, n, vec_yw, 0.0f);
      int cls[K];
      if (PARAM) {
#pragma unroll
        for (int k = 0; k < K; ++k) cls[k] = r + k < n ? min(max(class_idx[r + k], 0), NC - 1) : 0;
      }
      for (int f0 = 0; f0 < F; f0 += TILE_LOADS) {
        RowPack<S, K> xs[TILE_LOADS];
#pragma unroll
        for (int j = 0; j < TILE_LOADS; ++j) {
          if (f0 + j < F) xs[j] = load_rows<S, K>(X + (size_t)(f0 + j) * n, r, n, vec_x,
                                                   from_f32<S>(0.0f));
        }
#pragma unroll
        for (int j = 0; j < TILE_LOADS; ++j) {
          if (f0 + j < F) *reinterpret_cast<RowPack<S, K>*>(col + (f0 + j) * W) = xs[j];
        }
      }
      if (PARAM) {
        for (int q = 0; q < NP; ++q) {
          RowPack<S, K> pk;
#pragma unroll
          for (int k = 0; k < K; ++k) pk.v[k] = sbank[q * NC + cls[k]];
          *reinterpret_cast<RowPack<S, K>*>(col + (F + q) * W) = pk;
        }
      }
      for (int c = 0; c < nv; ++c) {
        float root[K], chk[K];
        run_tile<S, K>(stab, m, col, sc + c * CS, root, chk);
        RowPack<float, K> acc = *reinterpret_cast<RowPack<float, K>*>(acol + c * W);
        bool ok = true;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (r + k < n) {
            acc.v[k] = __fadd_rn(acc.v[k], loss_term<LOSS>(root[k], yk.v[k], wk.v[k]));
            ok = ok && chk[k] == 0.0f;
          }
        }
        *reinterpret_cast<RowPack<float, K>*>(acol + c * W) = acc;
        if (!ok) sok[c] = 0;
      }
    }

    __syncthreads();
    lane_tree_sum(sacc, W, nv);
    for (int c = tid; c < nv; c += P) emit(v0 + c, sacc[c * W], sok[c] != 0);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Reverse-mode table (plain version: ops/vjp.py)
// ---------------------------------------------------------------------------

// JAX's _balanced_eq: 1 where x is the max/min, halved on a tie.
__device__ __forceinline__ float balanced(float x, float ans, float other) {
  return __fdiv_rn(x == ans ? 1.0f : 0.0f, other == ans ? 2.0f : 1.0f);
}

__device__ __forceinline__ float recip2(float v) { return __fdiv_rn(1.0f, __fmul_rn(v, v)); }

__device__ __forceinline__ float rsqrt_ieee(float v) { return __fdiv_rn(1.0f, sqrtf(v)); }

// Cotangent through clip(x, -1, 1) = min(1, max(-1, x)).
__device__ __forceinline__ float clip_vjp(float x, float ct_c) {
  const float m = nan_max(-1.0f, x);
  const float c = nan_min(1.0f, m);
  const float ct_m = __fmul_rn(ct_c, balanced(m, c, 1.0f));
  return __fmul_rn(ct_m, balanced(x, m, -1.0f));
}

__device__ __forceinline__ float clip1(float x) { return nan_min(1.0f, nan_max(-1.0f, x)); }

// Digamma in double: reflection below 0, recurrence to x >= 6, then the
// asymptotic series. Poles as torch.digamma: -inf at +0, +inf at -0, NaN at
// negative integers.
__device__ double digamma_d(double x) {
  if (x == 0.0) return copysign(INFINITY, -x);
  if (x < 0.0 && floor(x) == x) return NAN;
  double r = 0.0;
  if (x < 0.0) {
    r = -3.14159265358979323846 / tan(3.14159265358979323846 * x);
    x = 1.0 - x;
  }
  while (x < 6.0) {
    r -= 1.0 / x;
    x += 1.0;
  }
  const double f = 1.0 / (x * x);
  const double t = f * (-1.0 / 12 + f * (1.0 / 120 + f * (-1.0 / 252 + f * (1.0 / 240
                   + f * (-1.0 / 132)))));
  return r + log(x) - 0.5 / x + t;
}

__device__ void vjp_binary(int id, float a, float b, float ct, float& da, float& db) {
  switch (id) {
    case B_ADD: da = ct; db = ct; return;
    case B_SUB: da = ct; db = -ct; return;
    case B_MUL: da = __fmul_rn(ct, b); db = __fmul_rn(a, ct); return;
    case B_DIV:
      da = __fdiv_rn(ct, b);
      db = -__fmul_rn(__fmul_rn(ct, recip2(b)), a);
      return;
    case B_POW: {
      const bool is_int = (b == rintf(b));
      const bool is_odd = fabsf(py_mod(b, 2.0f)) == 1.0f;
      const float ax = fabsf(a);
      const float mag = powf(ax, b);
      const float ct_int = is_int ? ct : 0.0f;
      const float ct_non = is_int ? 0.0f : ct;
      const float ct_s = (b < 0.0f && a == 0.0f) ? 0.0f : ct_int;
      const float ct_m1 = (is_odd && a < 0.0f) ? -ct_s : ct_s;
      const bool bad = (b > 0.0f && a < 0.0f) || (b < 0.0f && a <= 0.0f);
      const float ct_m2 = bad ? 0.0f : ct_non;
      const float jac_x = __fmul_rn(b, powf(ax, __fsub_rn(b, 1.0f)));
      const float jac_y = __fmul_rn(logf(ax == 0.0f ? 1.0f : ax), mag);
      const float d_ax = __fadd_rn(__fmul_rn(ct_m1, jac_x), __fmul_rn(ct_m2, jac_x));
      da = a >= 0.0f ? d_ax : -d_ax;
      db = __fadd_rn(__fmul_rn(ct_m1, jac_y), __fmul_rn(ct_m2, jac_y));
      return;
    }
    case B_MOD: {
      const float tm = fmodf(a, b);
      const bool do_plus = ((tm < 0.0f) != (b < 0.0f)) && tm != 0.0f;
      const float q = __fdiv_rn(a, b);
      const float jac = __fmul_rn(sign_of(q), floorf(fabsf(q)));
      da = ct;
      db = __fadd_rn(-__fmul_rn(ct, jac), do_plus ? ct : 0.0f);
      return;
    }
    case B_MAX: {
      const float ans = nan_max(a, b);
      da = __fmul_rn(ct, balanced(a, ans, b));
      db = __fmul_rn(ct, balanced(b, ans, a));
      return;
    }
    case B_MIN: {
      const float ans = nan_min(a, b);
      da = __fmul_rn(ct, balanced(a, ans, b));
      db = __fmul_rn(ct, balanced(b, ans, a));
      return;
    }
    case B_ATAN2: {
      const float den = __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
      da = __fmul_rn(ct, __fdiv_rn(b, den));
      db = __fmul_rn(ct, __fdiv_rn(-a, den));
      return;
    }
    case B_COND: da = 0.0f; db = a > 0.0f ? ct : 0.0f; return;
    default: da = 0.0f; db = 0.0f; return;  // comparisons and logical ops
  }
}

__device__ float vjp_unary(int id, float x, float ct) {
  switch (id) {
    case U_EXP: return __fmul_rn(ct, expf(x));
    case U_ABS: return x >= 0.0f ? ct : -ct;
    case U_LOG: return x > 0.0f ? __fdiv_rn(ct, x) : 0.0f;
    case U_LOG2: return x > 0.0f ? __fdiv_rn(__fdiv_rn(ct, 0.693147182464599609375f), x) : 0.0f;
    case U_LOG10: return x > 0.0f ? __fdiv_rn(__fmul_rn(ct, 0.4342944920063018798828125f), x)
                                  : 0.0f;
    case U_LOG1P: return x > -1.0f ? __fdiv_rn(ct, __fadd_rn(x, 1.0f)) : 0.0f;
    case U_SQRT: return x >= 0.0f ? __fmul_rn(ct, __fdiv_rn(0.5f, sqrtf(x))) : 0.0f;
    case U_CBRT: {
      const float ans = (float)cbrt((double)x);
      return __fmul_rn(ct, __fmul_rn(0.3333333432674407958984375f, recip2(ans)));
    }
    case U_SIN: return __fmul_rn(ct, cosf(x));
    case U_COS: return __fmul_rn(-ct, sinf(x));
    case U_TAN: {
      const float t = tanf(x);
      return __fmul_rn(ct, __fadd_rn(1.0f, __fmul_rn(t, t)));
    }
    case U_SINH: return __fmul_rn(ct, (float)cosh((double)x));
    case U_COSH: return __fmul_rn(ct, (float)sinh((double)x));
    case U_TANH: {
      const float ans = tanhf(x);
      const float t = __fmul_rn(ct, __fsub_rn(1.0f, ans));
      return __fadd_rn(t, __fmul_rn(t, ans));
    }
    case U_ASIN:
    case U_ACOS: {
      const bool ok = x >= -1.0f && x <= 1.0f;
      const float c = clip1(x);
      float r = rsqrt_ieee(__fsub_rn(1.0f, __fmul_rn(c, c)));
      if (id == U_ACOS) r = -r;
      return clip_vjp(x, __fmul_rn(ok ? ct : 0.0f, r));
    }
    case U_ATAN: return __fdiv_rn(ct, __fadd_rn(1.0f, __fmul_rn(x, x)));
    case U_ASINH: return __fmul_rn(ct, rsqrt_ieee(__fadd_rn(__fmul_rn(x, x), 1.0f)));
    case U_ACOSH: return x >= 1.0f ? __fmul_rn(ct, rsqrt_ieee(__fsub_rn(__fmul_rn(x, x), 1.0f)))
                                   : 0.0f;
    case U_ATANH: {
      const bool ok = x >= -1.0f && x <= 1.0f;
      const float c = clip1(x);
      const float r = __fdiv_rn(1.0f, __fadd_rn(1.0f, c));
      return clip_vjp(x, __fdiv_rn(__fmul_rn(r, ok ? ct : 0.0f), __fsub_rn(1.0f, c)));
    }
    case U_ATANH_CLIP: {
      const float u = __fsub_rn(py_mod(__fadd_rn(x, 1.0f), 2.0f), 1.0f);
      const float r = __fdiv_rn(1.0f, __fadd_rn(1.0f, u));
      return __fdiv_rn(__fmul_rn(r, ct), __fsub_rn(1.0f, u));
    }
    case U_ERF:
      return __fmul_rn(1.12837922573089599609375f, __fmul_rn(ct, expf(-__fmul_rn(x, x))));
    case U_ERFC:
      return __fmul_rn(-1.12837922573089599609375f, __fmul_rn(ct, expf(-__fmul_rn(x, x))));
    case U_GAMMA: {
      const double xd = (double)x;
      const double sign = xd > 0.0 ? 1.0 : (double)sign_of((float)sin(3.14159265358979323846 * xd));
      const double e = exp(lgamma(xd));
      const float out = (float)(sign * e);
      const float ct_o = isinf(out) ? 0.0f : ct;
      const float ct_lg = __fmul_rn(__fmul_rn((float)sign, ct_o), (float)e);
      return __fmul_rn(ct_lg, (float)digamma_d(xd));
    }
    case U_SQUARE: return __fadd_rn(__fmul_rn(ct, x), __fmul_rn(x, ct));
    case U_CUBE: {
      const float p = __fmul_rn(x, x);
      const float ct_p = __fmul_rn(ct, x);
      return __fadd_rn(__fmul_rn(p, ct), __fadd_rn(__fmul_rn(ct_p, x), __fmul_rn(x, ct_p)));
    }
    case U_NEG: return -ct;
    case U_INV: return -__fmul_rn(__fmul_rn(ct, recip2(x)), 1.0f);
    case U_RELU: return x > 0.0f ? ct : 0.0f;
    default: return 0.0f;  // round, floor, ceil, sign
  }
}

// d elementwise_loss / d pred, cotangent `ct`.
template <int LOSS>
__device__ __forceinline__ float loss_vjp(float p, float y, float ct) {
  const float d = __fsub_rn(p, y);
  if (LOSS == LOSS_L2) return __fadd_rn(__fmul_rn(ct, d), __fmul_rn(d, ct));
  if (LOSS == LOSS_L1) return d >= 0.0f ? ct : -ct;
  const float a = fabsf(d);
  const bool near = a <= 1.0f;
  const float ct1 = near ? ct : 0.0f;
  const float ct2 = near ? 0.0f : ct;
  const float ct_a = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(0.5f, a), ct1),
                                         __fmul_rn(0.5f, __fmul_rn(ct1, a))), ct2);
  return d >= 0.0f ? ct_a : -ct_a;
}

// ---------------------------------------------------------------------------
// Reverse sweep of kernels #3 and #5 (program_grad.cu, program_predict_vjp.cu)
// ---------------------------------------------------------------------------
//
// Every node of a tree has one parent, so each step's cotangent is written
// once per row and each constant slot has one reader: a constant's cotangent
// adds straight into its lane sums. The zero row's cotangent is never read,
// nor, in kernel #3, X's. Kernel #5 with per-member X keeps X's (GX): an
// argument may appear at several leaves (x1 * x1 reads address 0 twice), so
// each feature's cotangent adds into its gx row from 0.0f, steps last to
// first and within a step operand 1 before operand 2, as the JAX package's
// `store_adj` does.

// The reverse table (decode_grad_program): for step u, x = op | sign << 8
// | (slot + 1) << 9, slot the adjoint row its cotangent waits in (-1: it
// arrives in registers from step u + 1, or is the root's seed); y and z
// the operands' values as value_desc gives them; w = dest1 | dest2 << 16,
// where each operand's cotangent goes: CTD_NEXT the registers of step
// u - 1 (the operand is step u - 1, the last of u's operands in
// post-order), CTD_ADJ | slot << 2 an adjoint row (an earlier step, in its
// liveness row: its cotangent is written at u and read at the step itself,
// the interval it was held over in the forward sweep), CTD_CONST | c << 2
// constant c's gradient accumulator (c < nc; each constant slot has one
// reader), CTD_NONE nowhere (the zero row, constants past nc, X without
// GX). With GX, X feature f's cotangent goes to gx row f, as CTD_NONE |
// (f + 1) << 2 (the 2-bit kind is full; CTD_NONE alone stays 0).
enum : int { CTD_NONE = 0, CTD_NEXT = 1, CTD_ADJ = 2, CTD_CONST = 3 };

// The operand at buffer address `a` as the reverse sweep reads it: as
// operand_desc gives it, but a step's result in its own row R + j.
__device__ __forceinline__ int value_desc(int a, int R, int base, int zero_addr, int CMAX, int W) {
  if (a < R) return (a * W) << 2 | OPD_ROW;
  if (a < base) return (a - R) << 2 | OPD_CONST;
  if (a >= zero_addr) return CMAX << 2 | OPD_CONST;
  return ((R + a - base) * W) << 2 | OPD_ROW;
}

// Where step u sends the cotangent of its operand at address `a` (see
// CTD_NONE).
template <bool GX>
__device__ __forceinline__ int ct_dest(int a, int u, int R, int base, int zero_addr, int nc,
                                       const int* sflag) {
  if (a < R || a >= zero_addr) return (GX && a < R) ? (a + 1) << 2 | CTD_NONE : CTD_NONE;
  if (a < base) return a - R < nc ? (a - R) << 2 | CTD_CONST : CTD_NONE;
  const int j = a - base;
  if (j == u - 1) return CTD_NEXT;
  if (j > u - 1 || sflag[j] < 0) __trap();   // not a tree's post-order program
  return sflag[j] << 2 | CTD_ADJ;
}

// Decodes the tree's m words into the forward table `stab` [m] (as
// decode_tile_program does, but every step result that the reverse sweep
// reads, as an operand of a binary or unary step, or that a later step
// reads is stored in its own row R + u) and the reverse table `rtab` [m]
// (see CTD_NONE), whose adjoint rows are the liveness rows tile_liveness
// gives (`nslot` of them). `nc` is the tree's constant count. Scratch:
// `sflag`, `slast` and `sneed` [m], `sfree` [nslot]. Every thread of the
// block calls it; it ends with a barrier. Kept out of line: inlined, it
// shifts the kernel's register allocation and made #3 9-13% slower on the
// H100 (PERF.md section 6).
template <bool GX>
__device__ __noinline__ void decode_grad_program(const int* __restrict__ words, int m,
                                    const int* __restrict__ optab, int code_mask, int sign_shift,
                                    int R, int CMAX, int L, int W, int nc, int nslot, int* sflag,
                                    int* slast, int* sneed, int* sfree, int4* stab, int4* rtab) {
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const int base = R + CMAX;
  const int zero_addr = base + L;
  for (int u = tid; u < m; u += P) sneed[u] = 0;
  tile_liveness(words, m, optab, code_mask, base, zero_addr, nslot, sflag, slast, sfree);
  for (int u = tid; u < m; u += P) {
    const int word = words[u];
    const int kind = optab[(word >> 24) & code_mask] >> 8;
    const int a1 = (word >> 12) & 0xFFF, a2 = word & 0xFFF;
    if (kind == K_BINARY || kind == K_UNARY) {
      if (a1 >= base && a1 < zero_addr) sneed[a1 - base] = 1;
      if (kind == K_BINARY && a2 >= base && a2 < zero_addr) sneed[a2 - base] = 1;
    }
  }
  __syncthreads();
  for (int u = tid; u < m; u += P) {
    const int word = words[u];
    const int entry = optab[(word >> 24) & code_mask];
    const int kind = entry >> 8;
    const bool two = kind == K_BINARY || kind == K_ADDSUB;
    const int a1 = (word >> 12) & 0xFFF, a2 = word & 0xFFF;
    const int c1 = ct_dest<GX>(a1, u, R, base, zero_addr, nc, sflag);
    const int c2 = two ? ct_dest<GX>(a2, u, R, base, zero_addr, nc, sflag) : CTD_NONE;
    const int v1 = value_desc(a1, R, base, zero_addr, CMAX, W);
    const int v2 = two ? value_desc(a2, R, base, zero_addr, CMAX, W) : 0;
    const int op = tile_op(entry) | ((word >> sign_shift) & 1) << 8;
    // Forward operands: the previous step's result from registers.
    stab[u] = make_int4(op, (c1 & 3) == CTD_NEXT ? OPD_PREV : v1,
                        (c2 & 3) == CTD_NEXT ? OPD_PREV : v2,
                        (sneed[u] || slast[u] >= 0) ? (R + u) * W : -1);
    rtab[u] = make_int4(op | (sflag[u] + 1) << 9, v1, v2, c1 | c2 << 16);
  }
  __syncthreads();
}

// Sends one operand's cotangents on (see CTD_NONE): into `next` (step
// u - 1's), the thread's column of an adjoint row of `adj`, constant c's
// gradient accumulator row of `gacc` on the first `live` rows only (the
// thread's rows below n), or, with GX, feature f's row of `gx` (every row;
// the caller stores only those below n).
template <int K, bool GX>
__device__ __forceinline__ void route_ct(int dest, const float (&d)[K], float (&next)[K],
                                         float* adj, float* gacc, float* gx, int W, int live) {
  const int kind = dest & 3;
  if (kind == CTD_NEXT) {
#pragma unroll
    for (int k = 0; k < K; ++k) next[k] = d[k];
  } else if (kind == CTD_ADJ) {
    RowPack<float, K> p;
#pragma unroll
    for (int k = 0; k < K; ++k) p.v[k] = d[k];
    *reinterpret_cast<RowPack<float, K>*>(adj + (dest >> 2) * W) = p;
  } else if (kind == CTD_CONST) {
    RowPack<float, K>* at = reinterpret_cast<RowPack<float, K>*>(gacc + (dest >> 2) * W);
    RowPack<float, K> g = *at;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < live) g.v[k] = __fadd_rn(g.v[k], d[k]);
    }
    *at = g;
  } else if (GX && dest != CTD_NONE) {
    RowPack<float, K>* at = reinterpret_cast<RowPack<float, K>*>(gx + ((dest >> 2) - 1) * W);
    RowPack<float, K> g = *at;
#pragma unroll
    for (int k = 0; k < K; ++k) g.v[k] = __fadd_rn(g.v[k], d[k]);
    *at = g;
  }
}

// The reverse sweep over the table `rtab` (decode_grad_program), after
// run_tile stored the values it reads in `col`: the thread's K rows enter
// with the root's cotangents in `ct`; each step, last to first, takes its
// cotangents (from the registers, or from its adjoint row of `adj`, the
// thread's column), computes its operands' cotangents with vjp_binary /
// vjp_unary, as the JAX package's `_bwd_dispatch` does row by row, and
// routes them (route_ct), operand 1 before operand 2. Each constant's
// cotangent adds into its row of `gacc` (the thread's column of one
// constant vector's gradient accumulators) on the `live` rows; with GX each
// feature's adds into its row of `gx` (the thread's column, zeroed by the
// caller). The zero row's cotangents are not kept.
template <typename S, int K, bool GX>
__device__ __forceinline__ void run_tile_reverse(const int4* __restrict__ rtab, int m, const S* col,
                                                 const S* cv, float* adj, float* gacc, float* gx,
                                                 int W, int live, float (&ct)[K]) {
  const float none[K] = {};
  for (int s = m - 1; s >= 0; --s) {
    const int4 e = rtab[s];
    const int slot = (e.x >> 9) - 1;
    if (slot >= 0) {
      const RowPack<float, K> p = *reinterpret_cast<const RowPack<float, K>*>(adj + slot * W);
#pragma unroll
      for (int k = 0; k < K; ++k) ct[k] = p.v[k];
    }
    float a[K], b[K], d1[K], d2[K];
#define SR_REV_BIN(ID)                                                          \
  case ID:                                                                      \
    tile_operand<S, K>(e.y, col, cv, none, a);                                  \
    tile_operand<S, K>(e.z, col, cv, none, b);                                  \
    _Pragma("unroll") for (int k = 0; k < K; ++k) vjp_binary(ID, a[k], b[k], ct[k], d1[k], d2[k]); \
    break;
#define SR_REV_UN(ID)                                                          \
  case ID:                                                                     \
    tile_operand<S, K>(e.y, col, cv, none, a);                                 \
    _Pragma("unroll") for (int k = 0; k < K; ++k) d1[k] = vjp_unary(ID, a[k], ct[k]); \
    break;
    switch (e.x & 0xFF) {
      case OPX_ADDSUB: {
        const float sg = (e.x & 0x100) ? -1.0f : 1.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          d1[k] = ct[k];
          d2[k] = __fmul_rn(sg, ct[k]);
        }
        break;
      }
      case OPX_IDENT:
#pragma unroll
        for (int k = 0; k < K; ++k) d1[k] = ct[k];
        break;
      SR_REV_BIN(B_ADD) SR_REV_BIN(B_SUB) SR_REV_BIN(B_MUL) SR_REV_BIN(B_DIV)
      SR_REV_BIN(B_POW) SR_REV_BIN(B_MOD) SR_REV_BIN(B_MAX) SR_REV_BIN(B_MIN)
      SR_REV_BIN(B_ATAN2) SR_REV_BIN(B_GT) SR_REV_BIN(B_LT) SR_REV_BIN(B_GE)
      SR_REV_BIN(B_LE) SR_REV_BIN(B_COND) SR_REV_BIN(B_OR) SR_REV_BIN(B_AND)
      SR_REV_UN(U_EXP) SR_REV_UN(U_ABS) SR_REV_UN(U_LOG) SR_REV_UN(U_LOG2)
      SR_REV_UN(U_LOG10) SR_REV_UN(U_LOG1P) SR_REV_UN(U_SQRT) SR_REV_UN(U_CBRT)
      SR_REV_UN(U_SIN) SR_REV_UN(U_COS) SR_REV_UN(U_TAN) SR_REV_UN(U_SINH)
      SR_REV_UN(U_COSH) SR_REV_UN(U_TANH) SR_REV_UN(U_ASIN) SR_REV_UN(U_ACOS)
      SR_REV_UN(U_ATAN) SR_REV_UN(U_ASINH) SR_REV_UN(U_ACOSH) SR_REV_UN(U_ATANH)
      SR_REV_UN(U_ATANH_CLIP) SR_REV_UN(U_ERF) SR_REV_UN(U_ERFC) SR_REV_UN(U_GAMMA)
      SR_REV_UN(U_SQUARE) SR_REV_UN(U_CUBE) SR_REV_UN(U_NEG) SR_REV_UN(U_INV)
      SR_REV_UN(U_RELU) SR_REV_UN(U_ROUND) SR_REV_UN(U_FLOOR) SR_REV_UN(U_CEIL)
      SR_REV_UN(U_SIGN)
      default:   // OPX_NAN: vjp_binary's and vjp_unary's zero for an unknown id
#pragma unroll
        for (int k = 0; k < K; ++k) d1[k] = d2[k] = 0.0f;
    }
#undef SR_REV_BIN
#undef SR_REV_UN
    float next[K];
#pragma unroll
    for (int k = 0; k < K; ++k) next[k] = ct[k];
    route_ct<K, GX>(e.w & 0xFFFF, d1, next, adj, gacc, gx, W, live);
    route_ct<K, GX>(e.w >> 16, d2, next, adj, gacc, gx, W, live);
#pragma unroll
    for (int k = 0; k < K; ++k) ct[k] = next[k];
  }
}

// Rows each thread of a reverse-sweep kernel carries (W / GRAD_ROWS threads
// a block): two, not the forward kernels' TILE_ROWS, because the reverse
// sweep's values and dispatch need more registers per row, and more threads
// on fewer rows each hide the shared-memory latency better. The register cap
// gives GRAD_MIN_BLOCKS blocks per SM.
constexpr int GRAD_ROWS = 2;
constexpr int GRAD_MIN_BLOCKS = 8;

// The step-count classes of a reverse-sweep call: every value the sweep
// reads lives until the sweep reaches its reader, so a block's shared
// memory grows with its tree. Class i takes the trees with
// GRAD_STEP_CAPS[i - 1] < m <= GRAD_STEP_CAPS[i] (the last class every m up
// to L), each launched with the shared memory its largest tree needs, so the
// many small trees run more blocks per SM than the few large ones.
constexpr int GRAD_STEP_CAPS[] = {4, 12};

// Calls launch(mlo, mhi) for each class in turn: it launches one grid whose
// blocks return at once for a tree outside mlo < m <= mhi, and returns
// cudaGetLastError(). Stops at the first error and returns it.
template <typename Launch>
inline cudaError_t launch_step_classes(int L, Launch launch) {
  int mlo = -1;   // the first class takes every m up to its cap
  for (int i = 0; mlo < L; ++i) {
    const int ncap = (int)(sizeof(GRAD_STEP_CAPS) / sizeof(int));
    const int mhi = i < ncap ? min(GRAD_STEP_CAPS[i], L) : L;
    if (mhi <= mlo) continue;
    const cudaError_t err = launch(mlo, mhi);
    if (err != cudaSuccess) return err;
    mlo = mhi;
  }
  return cudaSuccess;
}

}  // namespace sr
