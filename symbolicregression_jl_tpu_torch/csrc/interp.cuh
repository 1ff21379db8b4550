// Device-side interpreter shared by the program kernels (sm_90a).
//
// program_eval.cu (kernel #1), program_multi.cu (#2), program_grad.cu
// (#3), program_predict.cu (#4) and program_predict_vjp.cu (#5) include
// this header, so all five compute every forward step, every elementwise
// loss and every row reduction with the same code: a (tree, constant
// vector) pair gives the same bits in each of them. The value buffer's
// storage is a template parameter S, and the compute type C follows it
// (Compute<S>): float storage computes in float (#1-#5), bf16 storage in
// float too (the bf16 forms of #1 and #2, 1b and 2b), and double storage in
// double (the float64 forms of #1, #1p, #2 and #3). Every operation is
// written once against C: rn_add, rn_mul, ... are __fadd_rn, __fmul_rn, ...
// for float and __dadd_rn, __dmul_rn, ... for double (no contraction), and
// the m_* math functions are expf, ... for float and exp, ... for double,
// so the float instantiations compile to what they were.
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
//
// User operators (ids USER_B0.. and USER_U0..) are generated device
// functions: ops/user_ops.py traces each into an IR and writes its forward
// and its adjoint into a header of the operator set, which this file
// includes where SR_USER_OPS is defined (ops/cuda_build.py builds each
// operator set's libraries with it). Without it the user cases expand to
// nothing and every built-in instantiation is what it was.

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

// User operators: binary USER_B0..USER_U0 - 1, unary USER_U0..USER_END - 1
// (ops/user_ops.py numbers them in the operator set's order).
enum : int { USER_B0 = 96, USER_U0 = 112, USER_END = 128 };

enum : int { K_IDENTITY = 0, K_BINARY = 1, K_UNARY = 2, K_ADDSUB = 3 };

// Elementwise loss kinds (core/losses.py `KernelLoss.kind` holds the same
// numbers). A kernel is instantiated twice over the loss: LOSS_L2, the hot
// default, with its formula inlined, and LOSS_ANY, which switches at run
// time on the launch's LossSpec (every kind, L2 included), so each new kind
// costs no instantiation.
enum : int {
  LOSS_L2 = 0, LOSS_L1 = 1, LOSS_HUBER = 2, LOSS_LOGCOSH = 3, LOSS_LOGIT_DIST = 4,
  LOSS_SIGMOID_CE = 5, LOSS_PERIODIC_L2 = 6, LOSS_ANY = 100
};

// A launch's loss: its kind and its one parameter (Huber's delta, the
// periodic L2's period; unused by the others), rounded to the compute type.
template <typename C>
struct LossSpec {
  int kind;
  C param;
};

// ---------------------------------------------------------------------------
// The compute type: rounded arithmetic and math functions for float and
// double
// ---------------------------------------------------------------------------

template <typename S> struct Compute { typedef float type; };
template <> struct Compute<double> { typedef double type; };
template <typename S> using CT = typename Compute<S>::type;

__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double rn_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rn_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rn_div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float rn_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double rn_fma(double a, double b, double c) { return __fma_rn(a, b, c); }

#define SR_MATH1(NAME, F, D)                                            \
  __device__ __forceinline__ float NAME(float x) { return F(x); }      \
  __device__ __forceinline__ double NAME(double x) { return D(x); }
#define SR_MATH2(NAME, F, D)                                                   \
  __device__ __forceinline__ float NAME(float x, float y) { return F(x, y); }  \
  __device__ __forceinline__ double NAME(double x, double y) { return D(x, y); }
SR_MATH1(m_exp, expf, exp) SR_MATH1(m_abs, fabsf, fabs) SR_MATH1(m_log, logf, log)
SR_MATH1(m_log2, log2f, log2) SR_MATH1(m_log10, log10f, log10) SR_MATH1(m_log1p, log1pf, log1p)
SR_MATH1(m_sqrt, sqrtf, sqrt) SR_MATH1(m_cbrt, cbrtf, cbrt) SR_MATH1(m_sin, sinf, sin)
SR_MATH1(m_cos, cosf, cos) SR_MATH1(m_tan, tanf, tan) SR_MATH1(m_sinh, sinhf, sinh)
SR_MATH1(m_cosh, coshf, cosh) SR_MATH1(m_tanh, tanhf, tanh) SR_MATH1(m_asin, asinf, asin)
SR_MATH1(m_acos, acosf, acos) SR_MATH1(m_atan, atanf, atan) SR_MATH1(m_asinh, asinhf, asinh)
SR_MATH1(m_acosh, acoshf, acosh) SR_MATH1(m_atanh, atanhf, atanh) SR_MATH1(m_erf, erff, erf)
SR_MATH1(m_erfc, erfcf, erfc) SR_MATH1(m_lgamma, lgammaf, lgamma) SR_MATH1(m_rint, rintf, rint)
SR_MATH1(m_floor, floorf, floor) SR_MATH1(m_ceil, ceilf, ceil)
SR_MATH2(m_pow, powf, pow) SR_MATH2(m_fmod, fmodf, fmod) SR_MATH2(m_fmax, fmaxf, fmax)
SR_MATH2(m_fmin, fminf, fmin) SR_MATH2(m_atan2, atan2f, atan2)
#undef SR_MATH1
#undef SR_MATH2

// Constants at each type's rounding (the float ones as the JAX package's
// float32 derivatives take them).
template <typename C> struct Num;
template <> struct Num<float> {
  __host__ __device__ static constexpr float pi() { return 3.14159265358979323846f; }
  __host__ __device__ static constexpr float ln2() { return 0.693147182464599609375f; }
  __host__ __device__ static constexpr float inv_ln10() { return 0.4342944920063018798828125f; }
  __host__ __device__ static constexpr float third() { return 0.3333333432674407958984375f; }
  __host__ __device__ static constexpr float two_over_sqrt_pi() {
    return 1.12837922573089599609375f;
  }
};
template <> struct Num<double> {
  __host__ __device__ static constexpr double pi() { return 3.14159265358979323846; }
  __host__ __device__ static constexpr double ln2() { return 0.69314718055994530942; }
  __host__ __device__ static constexpr double inv_ln10() { return 0.43429448190325182765; }
  __host__ __device__ static constexpr double third() { return 1.0 / 3.0; }
  __host__ __device__ static constexpr double two_over_sqrt_pi() {
    return 1.12837916709551257390;
  }
};

template <typename C> __device__ __forceinline__ C qnan();
template <> __device__ __forceinline__ float qnan<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double qnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// Python-style remainder (sign of the divisor), as jnp.mod / torch.remainder.
template <typename C>
__device__ __forceinline__ C py_mod(C a, C b) {
  C m = m_fmod(a, b);
  if (m != C(0) && ((m < C(0)) != (b < C(0)))) m = rn_add(m, b);
  return m;
}

template <typename C>
__device__ __forceinline__ C nan_max(C a, C b) {
  if (a != a || b != b) return qnan<C>();
  return m_fmax(a, b);
}

template <typename C>
__device__ __forceinline__ C nan_min(C a, C b) {
  if (a != a || b != b) return qnan<C>();
  return m_fmin(a, b);
}

template <typename C>
__device__ __forceinline__ C safe_pow(C x, C y) {
  const bool is_int = (y == m_rint(y));
  const bool is_odd = m_abs(py_mod(y, C(2))) == C(1);
  const C mag = m_pow(m_abs(x), y);
  if (is_int) {
    if (y < C(0) && x == C(0)) return qnan<C>();
    return (is_odd && x < C(0)) ? -mag : mag;
  }
  const bool bad = (y > C(0) && x < C(0)) || (y < C(0) && x <= C(0));
  return bad ? qnan<C>() : mag;
}

template <typename C>
__device__ __forceinline__ C sign_of(C x) {
  if (x != x) return x;
  return x > C(0) ? C(1) : (x < C(0) ? C(-1) : C(0));
}

template <typename C>
__device__ __forceinline__ C gamma_fn(C x) {
  const C s = x > C(0) ? C(1) : sign_of(m_sin(rn_mul(Num<C>::pi(), x)));
  const C out = rn_mul(s, m_exp(m_lgamma(x)));
  return isinf(out) ? qnan<C>() : out;
}

template <typename C>
__device__ C apply_binary(int id, C a, C b) {
  switch (id) {
    case B_ADD: return rn_add(a, b);
    case B_SUB: return rn_sub(a, b);
    case B_MUL: return rn_mul(a, b);
    case B_DIV: return rn_div(a, b);
    case B_POW: return safe_pow(a, b);
    case B_MOD: return py_mod(a, b);
    case B_MAX: return nan_max(a, b);
    case B_MIN: return nan_min(a, b);
    case B_ATAN2: return m_atan2(a, b);
    case B_GT: return a > b ? C(1) : C(0);
    case B_LT: return a < b ? C(1) : C(0);
    case B_GE: return a >= b ? C(1) : C(0);
    case B_LE: return a <= b ? C(1) : C(0);
    case B_COND: return a > C(0) ? b : C(0);
    case B_OR: return (a > C(0) || b > C(0)) ? C(1) : C(0);
    case B_AND: return (a > C(0) && b > C(0)) ? C(1) : C(0);
    default: return qnan<C>();
  }
}

template <typename C>
__device__ C apply_unary(int id, C x) {
  switch (id) {
    case U_EXP: return m_exp(x);
    case U_ABS: return m_abs(x);
    case U_LOG: return x > C(0) ? m_log(x) : qnan<C>();
    case U_LOG2: return x > C(0) ? m_log2(x) : qnan<C>();
    case U_LOG10: return x > C(0) ? m_log10(x) : qnan<C>();
    case U_LOG1P: return x > C(-1) ? m_log1p(x) : qnan<C>();
    case U_SQRT: return x >= C(0) ? m_sqrt(x) : qnan<C>();
    case U_CBRT: return m_cbrt(x);
    case U_SIN: return m_sin(x);
    case U_COS: return m_cos(x);
    case U_TAN: return m_tan(x);
    case U_SINH: return m_sinh(x);
    case U_COSH: return m_cosh(x);
    case U_TANH: return m_tanh(x);
    case U_ASIN: return (x >= C(-1) && x <= C(1)) ? m_asin(x) : qnan<C>();
    case U_ACOS: return (x >= C(-1) && x <= C(1)) ? m_acos(x) : qnan<C>();
    case U_ATAN: return m_atan(x);
    case U_ASINH: return m_asinh(x);
    case U_ACOSH: return x >= C(1) ? m_acosh(x) : qnan<C>();
    case U_ATANH: return (x >= C(-1) && x <= C(1)) ? m_atanh(x) : qnan<C>();
    case U_ATANH_CLIP: return m_atanh(rn_sub(py_mod(rn_add(x, C(1)), C(2)), C(1)));
    case U_ERF: return m_erf(x);
    case U_ERFC: return m_erfc(x);
    case U_GAMMA: return gamma_fn(x);
    case U_SQUARE: return rn_mul(x, x);
    case U_CUBE: return rn_mul(rn_mul(x, x), x);
    case U_NEG: return -x;
    case U_INV: return rn_div(C(1), x);
    case U_RELU: return x > C(0) ? x : C(0);
    case U_ROUND: return m_rint(x);
    case U_FLOOR: return m_floor(x);
    case U_CEIL: return m_ceil(x);
    case U_SIGN: return sign_of(x);
    default: return qnan<C>();
  }
}

// The reverse-mode table (below), declared for the user operators' adjoints,
// which take a built-in operator's derivative from it.
template <typename C>
__device__ void vjp_binary(int id, C a, C b, C ct, C& da, C& db);
template <typename C>
__device__ C vjp_unary(int id, C x, C ct);

// Operand j's cotangent of built-in binary operator `id`.
template <typename C>
__device__ __forceinline__ C user_vjp_part(int id, C a, C b, C ct, int j) {
  C da, db;
  vjp_binary<C>(id, a, b, ct, da, db);
  return j == 0 ? da : db;
}

// SR_USER_OPS_CASES(BIN, UN) lists the user operators as BIN(id, forward,
// adjoint) and UN(id, forward, adjoint); run_tile and run_tile_reverse
// expand it into their switches.
#ifdef SR_USER_OPS
#include "sr_user_ops.cuh"
#else
#define SR_USER_OPS_CASES(BIN, UN)
#endif

// ---------------------------------------------------------------------------
// Elementwise losses (plain versions: core/losses.py), each the JAX
// package's formula (symbolicregression_jl_tpu/core/losses.py) operation for
// operation
// ---------------------------------------------------------------------------

// jnp.logaddexp(a, b): max(a, b) + log1p(exp(-|a - b|)), or a + b where
// a - b is NaN (NaNs, or infinities of one sign).
template <typename C>
__device__ __forceinline__ C logaddexp(C a, C b) {
  const C delta = rn_sub(a, b);
  if (delta != delta) return rn_add(a, b);
  return rn_add(nan_max(a, b), m_log1p(m_exp(-m_abs(delta))));
}

// JAX's _replace_inf: +inf becomes 0 (logaddexp's JVP).
template <typename C>
__device__ __forceinline__ C replace_inf(C x) { return x == C(INFINITY) ? C(0) : x; }

// The loss of one row of any kind (LOSS_ANY's run-time switch).
template <typename C>
__device__ __forceinline__ C loss_of_kind(const LossSpec<C>& ls, C p, C y) {
  const C d = rn_sub(p, y);
  switch (ls.kind) {
    case LOSS_L2: return rn_mul(d, d);
    case LOSS_L1: return m_abs(d);
    case LOSS_HUBER: {
      // where(a <= delta, 0.5 * a * a, delta * (a - 0.5 * delta))
      const C a = m_abs(d);
      return a <= ls.param ? rn_mul(rn_mul(C(0.5), a), a)
                           : rn_mul(ls.param, rn_sub(a, rn_mul(C(0.5), ls.param)));
    }
    case LOSS_LOGCOSH:
      // logaddexp(p - y, y - p) - log(2)
      return rn_sub(logaddexp(d, rn_sub(y, p)), Num<C>::ln2());
    case LOSS_LOGIT_DIST: {
      // 2 * (logaddexp(d / 2, -d / 2) - log(2))
      const C h = rn_div(d, C(2));
      return rn_mul(C(2), rn_sub(logaddexp(h, rn_div(-d, C(2))), Num<C>::ln2()));
    }
    case LOSS_SIGMOID_CE:
      // maximum(p, 0) - p * y + log1p(exp(-|p|))
      return rn_add(rn_sub(nan_max(p, C(0)), rn_mul(p, y)), m_log1p(m_exp(-m_abs(p))));
    case LOSS_PERIODIC_L2: {
      // e = mod(p - y + c / 2, c) - c / 2; e * e
      const C half = rn_mul(ls.param, C(0.5));
      const C e = rn_sub(py_mod(rn_add(d, half), ls.param), half);
      return rn_mul(e, e);
    }
    default: return qnan<C>();
  }
}

template <int LOSS, typename C>
__device__ __forceinline__ C elementwise_loss(const LossSpec<C>& ls, C p, C y) {
  if (LOSS == LOSS_L2) {
    const C d = rn_sub(p, y);
    return rn_mul(d, d);
  }
  return loss_of_kind(ls, p, y);
}

// Storage of the value buffer: float (kernels #1-#5), __nv_bfloat16
// (the bf16 forms 1b and 2b, graftstage's eval_precision="bf16" and
// optimizer_bf16_linesearch) or double (the float64 forms). A bf16 buffer
// is only storage: every step reads its operands as float, computes in
// float and rounds the result to bf16 (round to nearest even) as it stores
// it. For float and double both conversions are the identity.
__device__ __forceinline__ float to_c(float v) { return v; }
__device__ __forceinline__ double to_c(double v) { return v; }
__device__ __forceinline__ float to_c(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S>
__device__ __forceinline__ S from_c(typename Compute<S>::type v);
template <>
__device__ __forceinline__ float from_c<float>(float v) { return v; }
template <>
__device__ __forceinline__ double from_c<double>(double v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_c<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The loss spine's type A: y, w, the constants, the loss terms and the sums
// are CT<A> values; a bf16 spine (kernels 1b and 2b's bf16-data forms,
// eval_dtype="bfloat16") rounds each loss term and each sum to bf16, as the
// JAX kernel computes its loss in the data's dtype. For float and double
// the rounding is the identity.
template <typename A>
__device__ __forceinline__ typename Compute<A>::type round_to(typename Compute<A>::type v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Elements of storage type S in front of a block's compute-type scratch,
// rounded up to keep the scratch 4-byte aligned (a no-op for float and
// double).
template <typename S>
__host__ __device__ constexpr size_t padded(size_t count) {
  return sizeof(S) >= 4 ? count : (count + 1) & ~(size_t)1;
}

// The loss term of one row: where(w > 0, elt, 0) * w.
template <int LOSS, typename C>
__device__ __forceinline__ C loss_term(const LossSpec<C>& ls, C v, C yr, C wr) {
  const C elt = elementwise_loss<LOSS>(ls, v, yr);
  return rn_mul(wr > C(0) ? elt : C(0), wr);
}

// ---------------------------------------------------------------------------
// Tile interpreter of kernels #1-#5 (program_eval.cu, program_multi.cu,
// program_grad.cu, program_predict.cu, program_predict_vjp.cu)
// ---------------------------------------------------------------------------
//
// A block owns one tree (kernels #2 and #3: one tree at a time, with all
// of its constant vectors). It decodes the tree's m instruction words once
// into a table of resolved steps in shared memory (decode_tile_program);
// each thread then carries K rows through every step (run_tile), so one
// table read, one operator dispatch and one operand address serve K
// independent evaluations; every step is warp-uniform. Kernels #2 and #3
// carry K rows of several constant vectors at once (run_vec, below).
// Kernels #3 and #5 add a reverse sweep over a second decoded table
// (decode_grad_program, run_tile_reverse, below; #3's run_vec_reverse).
//
// The fixed lane order. Every (tree, constant vector) sum keeps the order
// of the per-row kernels these replaced, which ran one row per thread: W
// reduction lanes; lane j sums its terms over rows j, j + W, j + 2W, ... in
// that order from 0.0f; then lane_tree_sum's pairwise tree, strides W/2
// down to 1, pair (i, i + s), the per-row kernels' block reduction. W is
// the block size the wrappers' `_block` (ops/fused_eval.py) picks from the
// per-row layout's shared memory, not the tile kernels' thread count: a
// tile kernel runs W / K threads (K = TILE_ROWS for #1 and #4, GRAD_ROWS
// for #5, MULTI_ROWS and grad_rows for #2 and #3), thread i owns lanes
// K * i ... K * i + K - 1, a tile is W consecutive rows (one row of each
// lane) and the tiles run in row order. Three bit checks rest on this
// order: kernel #2 with one constant vector equals #1's plain form (the
// same terms, summed so); kernel #3's loss, whose lanes sum the same terms
// in the same order at the same W (its gradient lanes sum each constant's
// cotangents so too), equals #2's on the same constant vectors; and #5's
// gcomp, whose lanes sum each constant's cotangents so, equals the per-row
// #5's. Kernel #4 sums nothing, so it has no lane order.
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
constexpr int TILE_LOADS = 4;             // per-row rows loaded before any is stored
constexpr int TILE_MIN_BLOCKS = 16;       // #1: blocks per SM its registers must allow (64 a thread)

// #1's blocks per SM for the compute type C: a double takes two registers,
// so the float64 forms allow half as many blocks (128 registers a thread).
template <typename C>
__host__ __device__ constexpr int tile_min_blocks() {
  return sizeof(C) == 8 ? TILE_MIN_BLOCKS / 2 : TILE_MIN_BLOCKS;
}
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
// vector load or store (two for a pack of 32 bytes, aligned to 16).
template <typename S, int K>
struct alignas(sizeof(S) * K > 16 ? 16 : sizeof(S) * K) RowPack {
  S v[K];
};

__host__ __device__ constexpr size_t align_up(size_t at, size_t a) { return (at + a - 1) / a * a; }

// Byte offsets of a tile block's dynamic shared memory, for passes of
// `vch` constant vectors (kernel #4: one vector, its row of lane sums
// unused).
struct TileLayout {
  size_t stab, sv, sacc, sc, sbank, sok, sflag, slast, sfree, total;
};

template <typename S, typename A = typename Compute<S>::type>
__host__ __device__ inline TileLayout tile_layout(int W, int L, int CMAX, int R, int NP, int NC,
                                                  int vch) {
  const int rows = R + tile_slots(L);
  const size_t csize = sizeof(typename Compute<A>::type);
  TileLayout o;
  o.stab = 0;                                                             // int4 [L]
  o.sv = align_up(o.stab + 16 * (size_t)L, 16);                           // S [rows * W]
  o.sacc = align_up(o.sv + sizeof(S) * (size_t)rows * W, 16);             // C [vch * W]
  o.sc = o.sacc + csize * (size_t)vch * W;                                // S [vch * (CMAX+1)]
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
  if (kind == K_BINARY) return (id < 16 || (id >= USER_B0 && id < USER_U0)) ? id : OPX_NAN;
  if (kind == K_UNARY) {
    return ((id >= U_EXP && id <= U_SIGN) || (id >= USER_U0 && id < USER_END)) ? id : OPX_NAN;
  }
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
template <typename S, int K, typename C = typename Compute<S>::type>
__device__ __forceinline__ void tile_operand(int desc, const S* col, const S* cv,
                                             const C (&prev)[K], C (&out)[K]) {
  const int kind = desc & 3;
  if (kind == OPD_ROW) {
    const RowPack<S, K> p = *reinterpret_cast<const RowPack<S, K>*>(col + (desc >> 2));
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = to_c(p.v[k]);
  } else if (kind == OPD_CONST) {
    const C c = to_c(cv[desc >> 2]);
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
template <typename S, int K, typename C = typename Compute<S>::type>
__device__ __forceinline__ void run_tile(const int4* __restrict__ stab, int m, S* col,
                                         const S* cv, C (&root)[K], C (&chk)[K]) {
  C prev[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    prev[k] = C(0);
    chk[k] = C(0);
  }
  int4 d = m > 0 ? stab[0] : make_int4(0, 0, 0, -1);
  for (int s = 0; s < m; ++s) {
    const int4 dn = s + 1 < m ? stab[s + 1] : d;   // the next step's entry, ahead of its use
    C a[K], b[K], r[K];
    tile_operand<S, K>(d.y, col, cv, prev, a);
    // The second operand loads inside the binary cases: fewer values live
    // across the dispatch (64 registers hold the unrolled operators).
#define SR_TILE_BIN(ID)                        \
  case ID:                                     \
    tile_operand<S, K>(d.z, col, cv, prev, b); \
    _Pragma("unroll") for (int k = 0; k < K; ++k) r[k] = apply_binary<C>(ID, a[k], b[k]); \
    break;
#define SR_TILE_UN(ID) \
  case ID:             \
    _Pragma("unroll") for (int k = 0; k < K; ++k) r[k] = apply_unary<C>(ID, a[k]); \
    break;
#define SR_TILE_UBIN(ID, F, VF)                \
  case ID:                                     \
    tile_operand<S, K>(d.z, col, cv, prev, b); \
    _Pragma("unroll") for (int k = 0; k < K; ++k) r[k] = F<C>(a[k], b[k]); \
    break;
#define SR_TILE_UUN(ID, F, VF) \
  case ID:                     \
    _Pragma("unroll") for (int k = 0; k < K; ++k) r[k] = F<C>(a[k]); \
    break;
    switch (d.x & 0xFF) {
      case OPX_ADDSUB: {
        tile_operand<S, K>(d.z, col, cv, prev, b);
        const C sg = (d.x & 0x100) ? C(-1) : C(1);
#pragma unroll
        for (int k = 0; k < K; ++k) r[k] = rn_add(a[k], rn_mul(sg, b[k]));
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
      SR_USER_OPS_CASES(SR_TILE_UBIN, SR_TILE_UUN)
      default:
#pragma unroll
        for (int k = 0; k < K; ++k) r[k] = qnan<C>();
    }
#undef SR_TILE_BIN
#undef SR_TILE_UN
#undef SR_TILE_UBIN
#undef SR_TILE_UUN
    RowPack<S, K> st;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      chk[k] = rn_fma(r[k], C(0), chk[k]);
      st.v[k] = from_c<S>(r[k]);
      prev[k] = to_c(st.v[k]);
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

// Sums `count` arrays of W values (x[c * W + i], W a power of two) in the
// fixed lane order's pairing: strides W/2 down to 1, x[i] = x[i] + x[i + s].
// The sums land in x[c * W]. No float atomics, so one input always gives
// one result. Every thread of the block calls it. Where only the lanes
// below `live` may be nonzero, a level whose pairs all read a zero lane
// (s >= live) changes no sum and is skipped: no lane sum is -0.0 (each
// starts at +0.0, and x + -x is +0.0).
template <typename C>
__device__ __forceinline__ void lane_tree_sum(C* x, int W, int count, int live = 1 << 30) {
  int sh = 0;
  while ((1 << sh) < W) ++sh;
  for (int s = W >> 1; s > 0; s >>= 1) {
    --sh;
    if (s >= live) continue;
    for (int idx = threadIdx.x; idx < count * s; idx += blockDim.x) {
      C* row = x + (idx >> sh) * W;
      const int i = idx & (s - 1);
      row[i] = rn_add(row[i], row[i + s]);
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
// on every row below n. `ls` is the launch's loss (LOSS_ANY reads it). A is
// the loss spine's type (round_to): the constants, the bank, y, w, the loss
// and the sums are CT<A> (D below), the steps C = CT<S>; the root enters the
// loss as a D, the constants and the bank the buffer as a C first.
template <typename S, int LOSS, bool PARAM, int K, typename A = CT<S>, typename Emit>
__device__ __forceinline__ void tree_loss_sums(
    const int* __restrict__ words, int m, const CT<A>* __restrict__ cvals,
    const CT<A>* __restrict__ bank, const int* __restrict__ class_idx,
    const S* __restrict__ X, const CT<A>* __restrict__ y, const CT<A>* __restrict__ w,
    const int* __restrict__ optab, int V, int vch, int L, int CMAX, int F, int NP, int NC, int n,
    int W, int code_mask, int sign_shift, LossSpec<CT<A>> ls, unsigned char* smem, Emit emit) {
  typedef CT<S> C;
  typedef CT<A> D;
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const int R = F + NP;
  const TileLayout lay = tile_layout<S, A>(W, L, CMAX, R, NP, NC, vch);
  int4* stab = reinterpret_cast<int4*>(smem + lay.stab);
  S* sv = reinterpret_cast<S*>(smem + lay.sv);
  D* sacc = reinterpret_cast<D*>(smem + lay.sacc);
  S* sc = reinterpret_cast<S*>(smem + lay.sc);
  S* sbank = reinterpret_cast<S*>(smem + lay.sbank);
  int* sok = reinterpret_cast<int*>(smem + lay.sok);

  if (PARAM) {
    for (int i = tid; i < NP * NC; i += P) sbank[i] = from_c<S>((C)bank[i]);
  }
  decode_tile_program(words, m, optab, code_mask, sign_shift, R, CMAX, L, W,
                      reinterpret_cast<int*>(smem + lay.sflag),
                      reinterpret_cast<int*>(smem + lay.slast),
                      reinterpret_cast<int*>(smem + lay.sfree), stab);

  S* col = sv + K * tid;
  D* acol = sacc + K * tid;
  const bool vec_x = n % K == 0 && reinterpret_cast<uintptr_t>(X) % sizeof(RowPack<S, K>) == 0;
  const bool vec_yw = n % K == 0 && reinterpret_cast<uintptr_t>(y) % sizeof(RowPack<D, K>) == 0
                      && reinterpret_cast<uintptr_t>(w) % sizeof(RowPack<D, K>) == 0;
  const int CS = CMAX + 1;
  for (int v0 = 0; v0 < V; v0 += vch) {
    const int nv = min(vch, V - v0);
    for (int i = tid; i < nv * CS; i += P) {
      const int c = i / CS, j = i - c * CS;
      sc[i] = from_c<S>(j < CMAX ? (C)cvals[(size_t)(v0 + c) * CMAX + j] : C(0));
    }
    for (int c = tid; c < nv; c += P) sok[c] = 1;
    for (int c = 0; c < nv; ++c) {
#pragma unroll
      for (int k = 0; k < K; ++k) acol[c * W + k] = D(0);
    }
    __syncthreads();

    for (int r0 = 0; r0 < n; r0 += W) {
      const int r = r0 + K * tid;
      // The tile's loads are issued before their values are stored, so
      // they travel together (TILE_LOADS features at a time).
      const RowPack<D, K> yk = load_rows<D, K>(y, r, n, vec_yw, D(0));
      const RowPack<D, K> wk = load_rows<D, K>(w, r, n, vec_yw, D(0));
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
                                                   from_c<S>(C(0)));
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
        C root[K], chk[K];
        run_tile<S, K>(stab, m, col, sc + c * CS, root, chk);
        RowPack<D, K> acc = *reinterpret_cast<RowPack<D, K>*>(acol + c * W);
        bool ok = true;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (r + k < n) {
            const D term = round_to<A>(loss_term<LOSS>(ls, (D)root[k], yk.v[k], wk.v[k]));
            acc.v[k] = rn_add(acc.v[k], term);
            ok = ok && chk[k] == C(0);
          }
        }
        *reinterpret_cast<RowPack<D, K>*>(acol + c * W) = acc;
        if (!ok) sok[c] = 0;
      }
    }

    __syncthreads();
    lane_tree_sum(sacc, W, nv);
    for (int c = tid; c < nv; c += P) emit(v0 + c, round_to<A>(sacc[c * W]), sok[c] != 0);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Reverse-mode table (plain version: ops/vjp.py)
// ---------------------------------------------------------------------------

// JAX's _balanced_eq: 1 where x is the max/min, halved on a tie.
template <typename C>
__device__ __forceinline__ C balanced(C x, C ans, C other) {
  return rn_div(x == ans ? C(1) : C(0), other == ans ? C(2) : C(1));
}

template <typename C>
__device__ __forceinline__ C recip2(C v) { return rn_div(C(1), rn_mul(v, v)); }

template <typename C>
__device__ __forceinline__ C rsqrt_ieee(C v) { return rn_div(C(1), m_sqrt(v)); }

// Cotangent through clip(x, -1, 1) = min(1, max(-1, x)).
template <typename C>
__device__ __forceinline__ C clip_vjp(C x, C ct_c) {
  const C m = nan_max(C(-1), x);
  const C c = nan_min(C(1), m);
  const C ct_m = rn_mul(ct_c, balanced(m, c, C(1)));
  return rn_mul(ct_m, balanced(x, m, C(-1)));
}

template <typename C>
__device__ __forceinline__ C clip1(C x) { return nan_min(C(1), nan_max(C(-1), x)); }

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

template <typename C>
__device__ void vjp_binary(int id, C a, C b, C ct, C& da, C& db) {
  switch (id) {
    case B_ADD: da = ct; db = ct; return;
    case B_SUB: da = ct; db = -ct; return;
    case B_MUL: da = rn_mul(ct, b); db = rn_mul(a, ct); return;
    case B_DIV:
      da = rn_div(ct, b);
      db = -rn_mul(rn_mul(ct, recip2(b)), a);
      return;
    case B_POW: {
      const bool is_int = (b == m_rint(b));
      const bool is_odd = m_abs(py_mod(b, C(2))) == C(1);
      const C ax = m_abs(a);
      const C mag = m_pow(ax, b);
      const C ct_int = is_int ? ct : C(0);
      const C ct_non = is_int ? C(0) : ct;
      const C ct_s = (b < C(0) && a == C(0)) ? C(0) : ct_int;
      const C ct_m1 = (is_odd && a < C(0)) ? -ct_s : ct_s;
      const bool bad = (b > C(0) && a < C(0)) || (b < C(0) && a <= C(0));
      const C ct_m2 = bad ? C(0) : ct_non;
      const C jac_x = rn_mul(b, m_pow(ax, rn_sub(b, C(1))));
      const C jac_y = rn_mul(m_log(ax == C(0) ? C(1) : ax), mag);
      const C d_ax = rn_add(rn_mul(ct_m1, jac_x), rn_mul(ct_m2, jac_x));
      da = a >= C(0) ? d_ax : -d_ax;
      db = rn_add(rn_mul(ct_m1, jac_y), rn_mul(ct_m2, jac_y));
      return;
    }
    case B_MOD: {
      const C tm = m_fmod(a, b);
      const bool do_plus = ((tm < C(0)) != (b < C(0))) && tm != C(0);
      const C q = rn_div(a, b);
      const C jac = rn_mul(sign_of(q), m_floor(m_abs(q)));
      da = ct;
      db = rn_add(-rn_mul(ct, jac), do_plus ? ct : C(0));
      return;
    }
    case B_MAX: {
      const C ans = nan_max(a, b);
      da = rn_mul(ct, balanced(a, ans, b));
      db = rn_mul(ct, balanced(b, ans, a));
      return;
    }
    case B_MIN: {
      const C ans = nan_min(a, b);
      da = rn_mul(ct, balanced(a, ans, b));
      db = rn_mul(ct, balanced(b, ans, a));
      return;
    }
    case B_ATAN2: {
      const C den = rn_add(rn_mul(a, a), rn_mul(b, b));
      da = rn_mul(ct, rn_div(b, den));
      db = rn_mul(ct, rn_div(-a, den));
      return;
    }
    case B_COND: da = C(0); db = a > C(0) ? ct : C(0); return;
    default: da = C(0); db = C(0); return;  // comparisons and logical ops
  }
}

template <typename C>
__device__ C vjp_unary(int id, C x, C ct) {
  switch (id) {
    case U_EXP: return rn_mul(ct, m_exp(x));
    case U_ABS: return x >= C(0) ? ct : -ct;
    case U_LOG: return x > C(0) ? rn_div(ct, x) : C(0);
    case U_LOG2: return x > C(0) ? rn_div(rn_div(ct, Num<C>::ln2()), x) : C(0);
    case U_LOG10: return x > C(0) ? rn_div(rn_mul(ct, Num<C>::inv_ln10()), x) : C(0);
    case U_LOG1P: return x > C(-1) ? rn_div(ct, rn_add(x, C(1))) : C(0);
    case U_SQRT: return x >= C(0) ? rn_mul(ct, rn_div(C(0.5), m_sqrt(x))) : C(0);
    case U_CBRT: {
      const C ans = (C)cbrt((double)x);
      return rn_mul(ct, rn_mul(Num<C>::third(), recip2(ans)));
    }
    case U_SIN: return rn_mul(ct, m_cos(x));
    case U_COS: return rn_mul(-ct, m_sin(x));
    case U_TAN: {
      const C t = m_tan(x);
      return rn_mul(ct, rn_add(C(1), rn_mul(t, t)));
    }
    case U_SINH: return rn_mul(ct, (C)cosh((double)x));
    case U_COSH: return rn_mul(ct, (C)sinh((double)x));
    case U_TANH: {
      const C ans = m_tanh(x);
      const C t = rn_mul(ct, rn_sub(C(1), ans));
      return rn_add(t, rn_mul(t, ans));
    }
    case U_ASIN:
    case U_ACOS: {
      const bool ok = x >= C(-1) && x <= C(1);
      const C c = clip1(x);
      C r = rsqrt_ieee(rn_sub(C(1), rn_mul(c, c)));
      if (id == U_ACOS) r = -r;
      return clip_vjp(x, rn_mul(ok ? ct : C(0), r));
    }
    case U_ATAN: return rn_div(ct, rn_add(C(1), rn_mul(x, x)));
    case U_ASINH: return rn_mul(ct, rsqrt_ieee(rn_add(rn_mul(x, x), C(1))));
    case U_ACOSH: return x >= C(1) ? rn_mul(ct, rsqrt_ieee(rn_sub(rn_mul(x, x), C(1)))) : C(0);
    case U_ATANH: {
      const bool ok = x >= C(-1) && x <= C(1);
      const C c = clip1(x);
      const C r = rn_div(C(1), rn_add(C(1), c));
      return clip_vjp(x, rn_div(rn_mul(r, ok ? ct : C(0)), rn_sub(C(1), c)));
    }
    case U_ATANH_CLIP: {
      const C u = rn_sub(py_mod(rn_add(x, C(1)), C(2)), C(1));
      const C r = rn_div(C(1), rn_add(C(1), u));
      return rn_div(rn_mul(r, ct), rn_sub(C(1), u));
    }
    case U_ERF:
      return rn_mul(Num<C>::two_over_sqrt_pi(), rn_mul(ct, m_exp(-rn_mul(x, x))));
    case U_ERFC:
      return rn_mul(-Num<C>::two_over_sqrt_pi(), rn_mul(ct, m_exp(-rn_mul(x, x))));
    case U_GAMMA: {
      const double xd = (double)x;
      const double sign = xd > 0.0 ? 1.0 : (double)sign_of((C)sin(3.14159265358979323846 * xd));
      const double e = exp(lgamma(xd));
      const C out = (C)(sign * e);
      const C ct_o = isinf(out) ? C(0) : ct;
      const C ct_lg = rn_mul(rn_mul((C)sign, ct_o), (C)e);
      return rn_mul(ct_lg, (C)digamma_d(xd));
    }
    case U_SQUARE: return rn_add(rn_mul(ct, x), rn_mul(x, ct));
    case U_CUBE: {
      const C p = rn_mul(x, x);
      const C ct_p = rn_mul(ct, x);
      return rn_add(rn_mul(p, ct), rn_add(rn_mul(ct_p, x), rn_mul(x, ct_p)));
    }
    case U_NEG: return -ct;
    case U_INV: return -rn_mul(rn_mul(ct, recip2(x)), C(1));
    case U_RELU: return x > C(0) ? ct : C(0);
    default: return C(0);  // round, floor, ceil, sign
  }
}

// d logaddexp(a, b) = ta * exp(ri(a) - ri(out)) + tb * exp(ri(b) - ri(out))
// (JAX's custom JVP, ri = replace_inf): the two factors.
template <typename C>
__device__ __forceinline__ void logaddexp_jac(C a, C b, C& ea, C& eb) {
  const C out = replace_inf(logaddexp(a, b));
  ea = m_exp(rn_sub(replace_inf(a), out));
  eb = m_exp(rn_sub(replace_inf(b), out));
}

// d elementwise_loss / d pred of any kind, cotangent `ct`: the transpose of
// the JVP JAX takes of each loss's formula (core/losses.py `_loss_vjp` is
// its plain version).
template <typename C>
__device__ __forceinline__ C loss_vjp_of_kind(const LossSpec<C>& ls, C p, C y, C ct) {
  const C d = rn_sub(p, y);
  switch (ls.kind) {
    case LOSS_L2: return rn_add(rn_mul(ct, d), rn_mul(d, ct));
    case LOSS_L1: return d >= C(0) ? ct : -ct;
    case LOSS_HUBER: {
      const C a = m_abs(d);
      const bool near = a <= ls.param;
      const C ct1 = near ? ct : C(0);
      const C ct2 = near ? C(0) : ct;
      const C ct_a = rn_add(rn_add(rn_mul(rn_mul(C(0.5), a), ct1), rn_mul(C(0.5), rn_mul(ct1, a))),
                            rn_mul(ct2, ls.param));
      return d >= C(0) ? ct_a : -ct_a;
    }
    case LOSS_LOGCOSH: {
      C ea, eb;
      logaddexp_jac(d, rn_sub(y, p), ea, eb);
      return rn_add(rn_mul(ct, ea), -rn_mul(ct, eb));
    }
    case LOSS_LOGIT_DIST: {
      C ea, eb;
      logaddexp_jac(rn_div(d, C(2)), rn_div(-d, C(2)), ea, eb);
      const C c2 = rn_mul(ct, C(2));
      return rn_add(rn_div(rn_mul(c2, ea), C(2)), -rn_div(rn_mul(c2, eb), C(2)));
    }
    case LOSS_SIGMOID_CE: {
      // maximum(p, 0) - p * y + log1p(exp(-|p|)): the log1p term's
      // cotangent, then the product's, then the maximum's (JAX's order).
      const C e = m_exp(-m_abs(p));
      const C c3 = -rn_mul(rn_div(ct, rn_add(e, C(1))), e);
      const C c_log = p >= C(0) ? c3 : -c3;
      const C c_mul = rn_mul(-ct, y);
      const C c_max = rn_mul(ct, balanced(p, nan_max(p, C(0)), C(0)));
      return rn_add(rn_add(c_log, c_mul), c_max);
    }
    case LOSS_PERIODIC_L2: {
      const C half = rn_mul(ls.param, C(0.5));
      const C e = rn_sub(py_mod(rn_add(d, half), ls.param), half);
      return rn_add(rn_mul(ct, e), rn_mul(e, ct));
    }
    default: return qnan<C>();
  }
}

template <int LOSS, typename C>
__device__ __forceinline__ C loss_vjp(const LossSpec<C>& ls, C p, C y, C ct) {
  if (LOSS == LOSS_L2) {
    const C d = rn_sub(p, y);
    return rn_add(rn_mul(ct, d), rn_mul(d, ct));
  }
  return loss_vjp_of_kind(ls, p, y, ct);
}

// ---------------------------------------------------------------------------
// Reverse sweep of kernels #3 and #5 (program_grad.cu, program_predict_vjp.cu;
// #3's vector-blocked form, run_vec_reverse, is below and reads the same
// tables)
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
// shifts the kernel's register allocation (it made #3's tile form 9-13%
// slower on the H100, PERF.md section 6).
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
template <int K, bool GX, typename C>
__device__ __forceinline__ void route_ct(int dest, const C (&d)[K], C (&next)[K],
                                         C* adj, C* gacc, C* gx, int W, int live) {
  const int kind = dest & 3;
  if (kind == CTD_NEXT) {
#pragma unroll
    for (int k = 0; k < K; ++k) next[k] = d[k];
  } else if (kind == CTD_ADJ) {
    RowPack<C, K> p;
#pragma unroll
    for (int k = 0; k < K; ++k) p.v[k] = d[k];
    *reinterpret_cast<RowPack<C, K>*>(adj + (dest >> 2) * W) = p;
  } else if (kind == CTD_CONST) {
    RowPack<C, K>* at = reinterpret_cast<RowPack<C, K>*>(gacc + (dest >> 2) * W);
    RowPack<C, K> g = *at;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < live) g.v[k] = rn_add(g.v[k], d[k]);
    }
    *at = g;
  } else if (GX && dest != CTD_NONE) {
    RowPack<C, K>* at = reinterpret_cast<RowPack<C, K>*>(gx + ((dest >> 2) - 1) * W);
    RowPack<C, K> g = *at;
#pragma unroll
    for (int k = 0; k < K; ++k) g.v[k] = rn_add(g.v[k], d[k]);
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
                                                 const S* cv, CT<S>* adj, CT<S>* gacc, CT<S>* gx,
                                                 int W, int live, CT<S> (&ct)[K]) {
  typedef CT<S> C;
  const C none[K] = {};
  for (int s = m - 1; s >= 0; --s) {
    const int4 e = rtab[s];
    const int slot = (e.x >> 9) - 1;
    if (slot >= 0) {
      const RowPack<C, K> p = *reinterpret_cast<const RowPack<C, K>*>(adj + slot * W);
#pragma unroll
      for (int k = 0; k < K; ++k) ct[k] = p.v[k];
    }
    C a[K], b[K], d1[K], d2[K];
#define SR_REV_BIN(ID)                                                          \
  case ID:                                                                      \
    tile_operand<S, K>(e.y, col, cv, none, a);                                  \
    tile_operand<S, K>(e.z, col, cv, none, b);                                  \
    _Pragma("unroll") for (int k = 0; k < K; ++k) vjp_binary<C>(ID, a[k], b[k], ct[k], d1[k], d2[k]); \
    break;
#define SR_REV_UN(ID)                                                          \
  case ID:                                                                     \
    tile_operand<S, K>(e.y, col, cv, none, a);                                 \
    _Pragma("unroll") for (int k = 0; k < K; ++k) d1[k] = vjp_unary<C>(ID, a[k], ct[k]); \
    break;
#define SR_REV_UBIN(ID, F, VF)                                                  \
  case ID:                                                                      \
    tile_operand<S, K>(e.y, col, cv, none, a);                                  \
    tile_operand<S, K>(e.z, col, cv, none, b);                                  \
    _Pragma("unroll") for (int k = 0; k < K; ++k) VF<C>(a[k], b[k], ct[k], d1[k], d2[k]); \
    break;
#define SR_REV_UUN(ID, F, VF)                                                  \
  case ID:                                                                     \
    tile_operand<S, K>(e.y, col, cv, none, a);                                 \
    _Pragma("unroll") for (int k = 0; k < K; ++k) d1[k] = VF<C>(a[k], ct[k]); \
    break;
    switch (e.x & 0xFF) {
      case OPX_ADDSUB: {
        const C sg = (e.x & 0x100) ? C(-1) : C(1);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          d1[k] = ct[k];
          d2[k] = rn_mul(sg, ct[k]);
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
      SR_USER_OPS_CASES(SR_REV_UBIN, SR_REV_UUN)
      default:   // OPX_NAN: vjp_binary's and vjp_unary's zero for an unknown id
#pragma unroll
        for (int k = 0; k < K; ++k) d1[k] = d2[k] = C(0);
    }
#undef SR_REV_BIN
#undef SR_REV_UN
#undef SR_REV_UBIN
#undef SR_REV_UUN
    C next[K];
#pragma unroll
    for (int k = 0; k < K; ++k) next[k] = ct[k];
    route_ct<K, GX>(e.w & 0xFFFF, d1, next, adj, gacc, gx, W, live);
    route_ct<K, GX>(e.w >> 16, d2, next, adj, gacc, gx, W, live);
#pragma unroll
    for (int k = 0; k < K; ++k) ct[k] = next[k];
  }
}

// Rows each thread of kernel #5 carries (W / GRAD_ROWS threads a block):
// two, not the forward kernels' TILE_ROWS, because the reverse
// sweep's values and dispatch need more registers per row, and more threads
// on fewer rows each hide the shared-memory latency better. The register cap
// gives GRAD_MIN_BLOCKS blocks per SM.
constexpr int GRAD_ROWS = 2;
constexpr int GRAD_MIN_BLOCKS = 8;

// The step-count classes of a call of kernel #5: every value the sweep
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

// ---------------------------------------------------------------------------
// Vector-blocked interpreter of kernels #2 and #3 (program_multi.cu,
// program_grad.cu)
// ---------------------------------------------------------------------------
//
// Kernels #2 and #3 run one program for each of a tree's V constant vectors
// over the same rows. Run vector by vector (run_tile), each step's table
// read, operand decode and operator dispatch, and the load of a per-row
// operand, are paid once per vector for K rows; for + - * they cost several
// times the operator. Here each thread carries K rows of VR vectors through
// each step (run_vec): one table read, one dispatch and one per-row operand
// load serve K * VR evaluations, the operator unrolled over them. An
// operator of many instructions (a libm function beyond exp, log and sqrt,
// a user operator) runs in a loop over the K * VR values instead
// (each_value), so its code is compiled four times per case, as run_tile's
// is, not K * VR times.
//
// The value buffer: X's rows [F][W] in the storage type, shared by the
// vectors, and the rows that hold step results, one per vector: row q of
// vector j at (q * VR + j) * W (OPD_HELD, offset q * VR * W). A pass's
// constants are [CMAX + 1][VR]. A thread reads and writes only its own
// columns (K * i ... K * i + K - 1 of every row), so the row walk needs no
// barrier.
//
// Every evaluation is run_tile's, operation for operation, and the fixed
// lane order holds: thread i owns lanes K * i ... K * i + K - 1 and walks
// the tiles in row order, each (lane, vector) sum in a register for the
// whole walk, written to shared memory once for lane_tree_sum. So every
// output is bit-identical to the tile interpreter's at the same W.

// A held result's row, one per vector (see above).
enum : int { OPD_HELD = 3 };

// Held results a tree of at most `mhi` steps keeps at once: tile_slots of
// its node count (at most 2 mhi + 1), and (mhi - 1) / 2 by steps: a held
// result is a left operand whose parent waits for a right subtree with a
// step, so h of them take 2 h + 1 steps.
__host__ __device__ inline int vec_slots(int mhi, int L) {
  const int by_nodes = tile_slots(L < 2 * mhi + 1 ? L : 2 * mhi + 1);
  const int by_steps = mhi > 1 ? (mhi - 1) / 2 : 0;
  return by_nodes < by_steps ? by_nodes : by_steps;
}

// The operand at buffer address `a` of step u: as operand_desc gives it,
// but a held result in its row of `vr` vectors.
__device__ __forceinline__ int vec_operand_desc(int a, int u, int R, int base, int zero_addr,
                                                int CMAX, int W, int vr, const int* sflag) {
  if (a < R) return (a * W) << 2 | OPD_ROW;
  if (a < base) return (a - R) << 2 | OPD_CONST;
  if (a >= zero_addr) return CMAX << 2 | OPD_CONST;
  const int j = a - base;
  if (j == u - 1) return OPD_PREV;
  if (j > u - 1 || sflag[j] < 0) __trap();   // not a tree's post-order program
  return (sflag[j] * vr * W) << 2 | OPD_HELD;
}

// Whether an operand reads one of the vector's constants (the zero row's
// slot CMAX is 0 for every vector).
__device__ __forceinline__ bool reads_const(int desc, int CMAX) {
  return (desc & 3) == OPD_CONST && (desc >> 2) < CMAX;
}

// decode_tile_program for run_vec: held results in rows of `vr` vectors,
// `nslot` of them. Returns to every thread whether the program reads any of
// the vector's constants: one that reads none gives every vector the same
// bits. Scratch: `slast` and `sflag` [m], `sfree` [nslot]. Every thread of
// the block calls it; it ends with a barrier.
__device__ bool decode_vec_program(const int* __restrict__ words, int m,
                                   const int* __restrict__ optab, int code_mask, int sign_shift,
                                   int R, int CMAX, int L, int W, int vr, int nslot, int* sflag,
                                   int* slast, int* sfree, int4* stab) {
  const int base = R + CMAX;
  const int zero_addr = base + L;
  tile_liveness(words, m, optab, code_mask, base, zero_addr, nslot, sflag, slast, sfree);
  bool reads = false;
  for (int u = threadIdx.x; u < m; u += blockDim.x) {
    const int word = words[u];
    const int entry = optab[(word >> 24) & code_mask];
    const int kind = entry >> 8;
    const bool two = kind == K_BINARY || kind == K_ADDSUB;
    const int d1 = vec_operand_desc((word >> 12) & 0xFFF, u, R, base, zero_addr, CMAX, W, vr,
                                    sflag);
    const int d2 = two ? vec_operand_desc(word & 0xFFF, u, R, base, zero_addr, CMAX, W, vr, sflag)
                       : 0;
    reads = reads || reads_const(d1, CMAX) || reads_const(d2, CMAX);
    const int sign = (word >> sign_shift) & 1;
    stab[u] = make_int4(tile_op(entry) | sign << 8, d1, d2, sflag[u] >= 0 ? sflag[u] * vr * W : -1);
  }
  return !__syncthreads_and(!reads);
}

// One operand for the thread's K rows of VR vectors: its column of an X row
// (one load for every vector), of a held row (one per vector), the pass's
// constants `sc` [CMAX + 1][VR], or the previous step's values.
template <typename S, int K, int VR, typename C = CT<S>>
__device__ __forceinline__ void vec_operand(int desc, const S* colx, const S* colh, int W,
                                            const S* sc, const C (&prev)[VR][K],
                                            C (&out)[VR][K]) {
  const int kind = desc & 3;
  const int off = desc >> 2;
  if (kind == OPD_ROW) {
    const RowPack<S, K> p = *reinterpret_cast<const RowPack<S, K>*>(colx + off);
#pragma unroll
    for (int j = 0; j < VR; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) out[j][k] = to_c(p.v[k]);
    }
  } else if (kind == OPD_HELD) {
#pragma unroll
    for (int j = 0; j < VR; ++j) {
      const RowPack<S, K> p = *reinterpret_cast<const RowPack<S, K>*>(colh + off + j * W);
#pragma unroll
      for (int k = 0; k < K; ++k) out[j][k] = to_c(p.v[k]);
    }
  } else if (kind == OPD_CONST) {
#pragma unroll
    for (int j = 0; j < VR; ++j) {
      const C c = to_c(sc[off * VR + j]);
#pragma unroll
      for (int k = 0; k < K; ++k) out[j][k] = c;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VR; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) out[j][k] = prev[j][k];
    }
  }
}

// The values of a [VR][K] block one after another (see above): copied into
// a local array, f applied in a loop unrolled four times (four independent
// evaluations in flight, as run_tile's four rows), copied back.

template <int VR, int K, typename C, typename F>
__device__ __forceinline__ void each_value(const C (&a)[VR][K], const C (&b)[VR][K],
                                           C (&r)[VR][K], F f) {
  C ta[VR * K], tb[VR * K];
#pragma unroll
  for (int j = 0; j < VR; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ta[j * K + k] = a[j][k];
      tb[j * K + k] = b[j][k];
    }
  }
#pragma unroll 4
  for (int i = 0; i < VR * K; ++i) ta[i] = f(ta[i], tb[i]);
#pragma unroll
  for (int j = 0; j < VR; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) r[j][k] = ta[j * K + k];
  }
}

template <int VR, int K, typename C, typename F>
__device__ __forceinline__ void each_value1(const C (&a)[VR][K], C (&r)[VR][K], F f) {
  C ta[VR * K];
#pragma unroll
  for (int j = 0; j < VR; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) ta[j * K + k] = a[j][k];
  }
#pragma unroll 4
  for (int i = 0; i < VR * K; ++i) ta[i] = f(ta[i]);
#pragma unroll
  for (int j = 0; j < VR; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) r[j][k] = ta[j * K + k];
  }
}

// vjp_binary's two cotangents value by value, as each_value.
template <int VR, int K, typename C, typename F>
__device__ __forceinline__ void each_vjp(const C (&a)[VR][K], const C (&b)[VR][K],
                                         const C (&c)[VR][K], C (&d1)[VR][K], C (&d2)[VR][K],
                                         F f) {
  C ta[VR * K], tb[VR * K], tc[VR * K];
#pragma unroll
  for (int j = 0; j < VR; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ta[j * K + k] = a[j][k];
      tb[j * K + k] = b[j][k];
      tc[j * K + k] = c[j][k];
    }
  }
#pragma unroll 4
  for (int i = 0; i < VR * K; ++i) {
    C o1, o2;
    f(ta[i], tb[i], tc[i], o1, o2);
    ta[i] = o1;
    tb[i] = o2;
  }
#pragma unroll
  for (int j = 0; j < VR; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      d1[j][k] = ta[j * K + k];
      d2[j][k] = tb[j * K + k];
    }
  }
}

// run_tile for K rows of VR vectors: the decoded program `stab` (held
// results at offsets of `colh`, X in `colx`), the pass's constants `sc`;
// root and chk as run_tile's, per vector.
template <typename S, int K, int VR, typename C = CT<S>>
__device__ __forceinline__ void run_vec(const int4* __restrict__ stab, int m, const S* colx,
                                        S* colh, int W, const S* sc, C (&root)[VR][K],
                                        C (&chk)[VR][K]) {
  C prev[VR][K];
#pragma unroll
  for (int j = 0; j < VR; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      prev[j][k] = C(0);
      chk[j][k] = C(0);
    }
  }
  int4 d = m > 0 ? stab[0] : make_int4(0, 0, 0, -1);
  for (int s = 0; s < m; ++s) {
    const int4 dn = s + 1 < m ? stab[s + 1] : d;   // the next step's entry, ahead of its use
    C a[VR][K], b[VR][K], r[VR][K];
    vec_operand<S, K, VR>(d.y, colx, colh, W, sc, prev, a);
#define SR_VEC_ALL(EXPR)                                                                 \
  _Pragma("unroll") for (int j = 0; j < VR; ++j) {                                       \
    _Pragma("unroll") for (int k = 0; k < K; ++k) r[j][k] = EXPR;                        \
  }
#define SR_VEC_B(ID)                                              \
  case ID:                                                        \
    vec_operand<S, K, VR>(d.z, colx, colh, W, sc, prev, b);       \
    SR_VEC_ALL(apply_binary<C>(ID, a[j][k], b[j][k]))             \
    break;
#define SR_VEC_SB(ID)                                                                   \
  case ID:                                                                              \
    vec_operand<S, K, VR>(d.z, colx, colh, W, sc, prev, b);                             \
    each_value<VR, K>(a, b, r, [](C x, C y) { return apply_binary<C>(ID, x, y); });     \
    break;
#define SR_VEC_U(ID) \
  case ID:           \
    SR_VEC_ALL(apply_unary<C>(ID, a[j][k])) \
    break;
#define SR_VEC_SU(ID)                                                        \
  case ID:                                                                   \
    each_value1<VR, K>(a, r, [](C x) { return apply_unary<C>(ID, x); });     \
    break;
#define SR_VEC_UB(ID, F, VF)                                                \
  case ID:                                                                  \
    vec_operand<S, K, VR>(d.z, colx, colh, W, sc, prev, b);                 \
    each_value<VR, K>(a, b, r, [](C x, C y) { return F<C>(x, y); });        \
    break;
#define SR_VEC_UU(ID, F, VF)                                     \
  case ID:                                                       \
    each_value1<VR, K>(a, r, [](C x) { return F<C>(x); });       \
    break;
    switch (d.x & 0xFF) {
      case OPX_ADDSUB: {
        vec_operand<S, K, VR>(d.z, colx, colh, W, sc, prev, b);
        const C sg = (d.x & 0x100) ? C(-1) : C(1);
        SR_VEC_ALL(rn_add(a[j][k], rn_mul(sg, b[j][k])))
        break;
      }
      case OPX_IDENT:
        SR_VEC_ALL(a[j][k])
        break;
      SR_VEC_B(B_ADD) SR_VEC_B(B_SUB) SR_VEC_B(B_MUL) SR_VEC_B(B_DIV)
      SR_VEC_SB(B_POW) SR_VEC_SB(B_MOD) SR_VEC_B(B_MAX) SR_VEC_B(B_MIN)
      SR_VEC_SB(B_ATAN2) SR_VEC_B(B_GT) SR_VEC_B(B_LT) SR_VEC_B(B_GE)
      SR_VEC_B(B_LE) SR_VEC_B(B_COND) SR_VEC_B(B_OR) SR_VEC_B(B_AND)
      SR_VEC_U(U_EXP) SR_VEC_U(U_ABS) SR_VEC_U(U_LOG) SR_VEC_SU(U_LOG2)
      SR_VEC_SU(U_LOG10) SR_VEC_SU(U_LOG1P) SR_VEC_U(U_SQRT) SR_VEC_SU(U_CBRT)
      SR_VEC_SU(U_SIN) SR_VEC_SU(U_COS) SR_VEC_SU(U_TAN) SR_VEC_SU(U_SINH)
      SR_VEC_SU(U_COSH) SR_VEC_SU(U_TANH) SR_VEC_SU(U_ASIN) SR_VEC_SU(U_ACOS)
      SR_VEC_SU(U_ATAN) SR_VEC_SU(U_ASINH) SR_VEC_SU(U_ACOSH) SR_VEC_SU(U_ATANH)
      SR_VEC_SU(U_ATANH_CLIP) SR_VEC_SU(U_ERF) SR_VEC_SU(U_ERFC) SR_VEC_SU(U_GAMMA)
      SR_VEC_U(U_SQUARE) SR_VEC_U(U_CUBE) SR_VEC_U(U_NEG) SR_VEC_U(U_INV)
      SR_VEC_U(U_RELU) SR_VEC_U(U_ROUND) SR_VEC_U(U_FLOOR) SR_VEC_U(U_CEIL)
      SR_VEC_U(U_SIGN)
      SR_USER_OPS_CASES(SR_VEC_UB, SR_VEC_UU)
      default:
        SR_VEC_ALL(qnan<C>())
    }
#undef SR_VEC_B
#undef SR_VEC_SB
#undef SR_VEC_U
#undef SR_VEC_SU
#undef SR_VEC_UB
#undef SR_VEC_UU
    RowPack<S, K> st[VR];
#pragma unroll
    for (int j = 0; j < VR; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        chk[j][k] = rn_fma(r[j][k], C(0), chk[j][k]);
        st[j].v[k] = from_c<S>(r[j][k]);
        prev[j][k] = to_c(st[j].v[k]);
      }
    }
    if (d.w >= 0) {
#pragma unroll
      for (int j = 0; j < VR; ++j) *reinterpret_cast<RowPack<S, K>*>(colh + d.w + j * W) = st[j];
    }
    d = dn;
  }
#pragma unroll
  for (int j = 0; j < VR; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) root[j][k] = prev[j][k];
  }
}

// The reverse sweep's counterparts: decode_grad_program for run_vec and
// run_vec_reverse, with X's rows shared (OPD_ROW) and step u's value in its
// row of `vr` vectors at u * vr * W (OPD_HELD); the adjoint slots are rows
// of `vr` vectors (slot numbers in the tables, as there). Returns whether
// the program reads any of the vector's constants. Kept out of line, as
// decode_grad_program is.
__device__ __noinline__ bool decode_grad_vec(const int* __restrict__ words, int m,
                                             const int* __restrict__ optab, int code_mask,
                                             int sign_shift, int R, int CMAX, int L, int W,
                                             int vr, int nc, int nslot, int* sflag, int* slast,
                                             int* sneed, int* sfree, int4* stab, int4* rtab) {
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
  bool reads = false;
  for (int u = tid; u < m; u += P) {
    const int word = words[u];
    const int entry = optab[(word >> 24) & code_mask];
    const int kind = entry >> 8;
    const bool two = kind == K_BINARY || kind == K_ADDSUB;
    const int a1 = (word >> 12) & 0xFFF, a2 = word & 0xFFF;
    const int c1 = ct_dest<false>(a1, u, R, base, zero_addr, nc, sflag);
    const int c2 = two ? ct_dest<false>(a2, u, R, base, zero_addr, nc, sflag) : CTD_NONE;
    const int v1 = value_desc(a1, R, base, zero_addr, CMAX, W);
    const int v2 = two ? value_desc(a2, R, base, zero_addr, CMAX, W) : 0;
    // value_desc's row R + j becomes step j's row of vr vectors
    const int h1 = (v1 & 3) == OPD_ROW && a1 >= R ? ((a1 - base) * vr * W) << 2 | OPD_HELD : v1;
    const int h2 = two && (v2 & 3) == OPD_ROW && a2 >= R ? ((a2 - base) * vr * W) << 2 | OPD_HELD
                                                         : v2;
    reads = reads || reads_const(h1, CMAX) || reads_const(h2, CMAX);
    const int op = tile_op(entry) | ((word >> sign_shift) & 1) << 8;
    stab[u] = make_int4(op, (c1 & 3) == CTD_NEXT ? OPD_PREV : h1,
                        (c2 & 3) == CTD_NEXT ? OPD_PREV : h2,
                        (sneed[u] || slast[u] >= 0) ? u * vr * W : -1);
    rtab[u] = make_int4(op | (sflag[u] + 1) << 9, h1, h2, c1 | c2 << 16);
  }
  return !__syncthreads_and(!reads);
}

// Constant cotangent sums a register class of the gradient sweep keeps in
// registers, per vector (trees with more constants run in the last class,
// whose sums live in shared memory). Chosen on the H100 with
// bench/tile_variants.py, which builds other values through the macro.
#ifndef SR_GRAD_REG_CONSTS
#define SR_GRAD_REG_CONSTS 6
#endif
constexpr int GRAD_REG_CONSTS = SR_GRAD_REG_CONSTS;

// route_ct for K rows of VR vectors: adjoint rows at `adj` + slot *
// adj_stride + j * W; a constant's cotangent into its register sum g[c]
// (REG) or into the thread's column of row j * G + 1 + c of `gsm`, on the
// first `live` rows only.
template <int K, int VR, bool REG, typename C>
__device__ __forceinline__ void route_vec(int dest, const C (&d)[VR][K], C (&next)[VR][K],
                                          C* adj, int adj_stride, C* gsm, int G,
                                          C (&g)[GRAD_REG_CONSTS][VR][K], int W, int live) {
  const int kind = dest & 3;
  if (kind == CTD_NEXT) {
#pragma unroll
    for (int j = 0; j < VR; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) next[j][k] = d[j][k];
    }
  } else if (kind == CTD_ADJ) {
    C* at = adj + (dest >> 2) * adj_stride;
#pragma unroll
    for (int j = 0; j < VR; ++j) {
      RowPack<C, K> p;
#pragma unroll
      for (int k = 0; k < K; ++k) p.v[k] = d[j][k];
      *reinterpret_cast<RowPack<C, K>*>(at + j * W) = p;
    }
  } else if (kind == CTD_CONST) {
    const int c = dest >> 2;
    if (REG) {
#pragma unroll
      for (int q = 0; q < GRAD_REG_CONSTS; ++q) {
        if (q == c) {
#pragma unroll
          for (int j = 0; j < VR; ++j) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              if (k < live) g[q][j][k] = rn_add(g[q][j][k], d[j][k]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < VR; ++j) {
        RowPack<C, K>* at = reinterpret_cast<RowPack<C, K>*>(gsm + (j * G + 1 + c) * W);
        RowPack<C, K> p = *at;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k < live) p.v[k] = rn_add(p.v[k], d[j][k]);
        }
        *at = p;
      }
    }
  }
}

// run_tile_reverse for K rows of VR vectors (tables of decode_grad_vec),
// after run_vec stored the values it reads at `colv`: the cotangents enter
// in `ct`; each step takes its cotangents, computes its operands' with
// vjp_binary / vjp_unary (unrolled, or value by value for the operators
// of many instructions, as run_vec) and routes them (route_vec), operand 1
// before operand 2.
template <int K, int VR, bool REG, typename C>
__device__ __forceinline__ void run_vec_reverse(const int4* __restrict__ rtab, int m,
                                                const C* colx, const C* colv, C* adj,
                                                int adj_stride, const C* sc, C* gsm, int G,
                                                C (&g)[GRAD_REG_CONSTS][VR][K], int W, int live,
                                                C (&ct)[VR][K]) {
  C none[VR][K];
#pragma unroll
  for (int j = 0; j < VR; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) none[j][k] = C(0);
  }
  for (int s = m - 1; s >= 0; --s) {
    const int4 e = rtab[s];
    const int slot = (e.x >> 9) - 1;
    if (slot >= 0) {
#pragma unroll
      for (int j = 0; j < VR; ++j) {
        const RowPack<C, K> p =
            *reinterpret_cast<const RowPack<C, K>*>(adj + slot * adj_stride + j * W);
#pragma unroll
        for (int k = 0; k < K; ++k) ct[j][k] = p.v[k];
      }
    }
    C a[VR][K], b[VR][K], d1[VR][K], d2[VR][K];
#define SR_RV_ALL(STMT)                                   \
  _Pragma("unroll") for (int j = 0; j < VR; ++j) {        \
    _Pragma("unroll") for (int k = 0; k < K; ++k) STMT;   \
  }
#define SR_RV_B(ID)                                                              \
  case ID:                                                                       \
    vec_operand<C, K, VR>(e.y, colx, colv, W, sc, none, a);                      \
    vec_operand<C, K, VR>(e.z, colx, colv, W, sc, none, b);                      \
    SR_RV_ALL(vjp_binary<C>(ID, a[j][k], b[j][k], ct[j][k], d1[j][k], d2[j][k])) \
    break;
#define SR_RV_SB(ID)                                                                       \
  case ID:                                                                                 \
    vec_operand<C, K, VR>(e.y, colx, colv, W, sc, none, a);                                \
    vec_operand<C, K, VR>(e.z, colx, colv, W, sc, none, b);                                \
    each_vjp<VR, K>(a, b, ct, d1, d2,                                                      \
                    [](C x, C y, C c, C& o1, C& o2) { vjp_binary<C>(ID, x, y, c, o1, o2); }); \
    break;
#define SR_RV_U(ID)                                                 \
  case ID:                                                          \
    vec_operand<C, K, VR>(e.y, colx, colv, W, sc, none, a);         \
    SR_RV_ALL(d1[j][k] = vjp_unary<C>(ID, a[j][k], ct[j][k]))       \
    break;
#define SR_RV_SU(ID)                                                                 \
  case ID:                                                                           \
    vec_operand<C, K, VR>(e.y, colx, colv, W, sc, none, a);                          \
    each_value<VR, K>(a, ct, d1, [](C x, C c) { return vjp_unary<C>(ID, x, c); });   \
    break;
#define SR_RV_UB(ID, F, VF)                                                              \
  case ID:                                                                               \
    vec_operand<C, K, VR>(e.y, colx, colv, W, sc, none, a);                              \
    vec_operand<C, K, VR>(e.z, colx, colv, W, sc, none, b);                              \
    each_vjp<VR, K>(a, b, ct, d1, d2, [](C x, C y, C c, C& o1, C& o2) { VF<C>(x, y, c, o1, o2); }); \
    break;
#define SR_RV_UU(ID, F, VF)                                                          \
  case ID:                                                                           \
    vec_operand<C, K, VR>(e.y, colx, colv, W, sc, none, a);                          \
    each_value<VR, K>(a, ct, d1, [](C x, C c) { return VF<C>(x, c); });              \
    break;
    switch (e.x & 0xFF) {
      case OPX_ADDSUB: {
        const C sg = (e.x & 0x100) ? C(-1) : C(1);
        SR_RV_ALL((d1[j][k] = ct[j][k], d2[j][k] = rn_mul(sg, ct[j][k])))
        break;
      }
      case OPX_IDENT:
        SR_RV_ALL(d1[j][k] = ct[j][k])
        break;
      SR_RV_B(B_ADD) SR_RV_B(B_SUB) SR_RV_B(B_MUL) SR_RV_B(B_DIV)
      SR_RV_SB(B_POW) SR_RV_SB(B_MOD) SR_RV_B(B_MAX) SR_RV_B(B_MIN)
      SR_RV_SB(B_ATAN2) SR_RV_B(B_GT) SR_RV_B(B_LT) SR_RV_B(B_GE)
      SR_RV_B(B_LE) SR_RV_B(B_COND) SR_RV_B(B_OR) SR_RV_B(B_AND)
      SR_RV_U(U_EXP) SR_RV_U(U_ABS) SR_RV_U(U_LOG) SR_RV_SU(U_LOG2)
      SR_RV_SU(U_LOG10) SR_RV_SU(U_LOG1P) SR_RV_U(U_SQRT) SR_RV_SU(U_CBRT)
      SR_RV_SU(U_SIN) SR_RV_SU(U_COS) SR_RV_SU(U_TAN) SR_RV_SU(U_SINH)
      SR_RV_SU(U_COSH) SR_RV_SU(U_TANH) SR_RV_SU(U_ASIN) SR_RV_SU(U_ACOS)
      SR_RV_SU(U_ATAN) SR_RV_SU(U_ASINH) SR_RV_SU(U_ACOSH) SR_RV_SU(U_ATANH)
      SR_RV_SU(U_ATANH_CLIP) SR_RV_SU(U_ERF) SR_RV_SU(U_ERFC) SR_RV_SU(U_GAMMA)
      SR_RV_U(U_SQUARE) SR_RV_U(U_CUBE) SR_RV_U(U_NEG) SR_RV_U(U_INV)
      SR_RV_U(U_RELU) SR_RV_U(U_ROUND) SR_RV_U(U_FLOOR) SR_RV_U(U_CEIL)
      SR_RV_U(U_SIGN)
      SR_USER_OPS_CASES(SR_RV_UB, SR_RV_UU)
      default:   // OPX_NAN: vjp_binary's and vjp_unary's zero for an unknown id
        SR_RV_ALL((d1[j][k] = C(0), d2[j][k] = C(0)))
    }
#undef SR_RV_ALL
#undef SR_RV_B
#undef SR_RV_SB
#undef SR_RV_U
#undef SR_RV_SU
#undef SR_RV_UB
#undef SR_RV_UU
    C next[VR][K];
#pragma unroll
    for (int j = 0; j < VR; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) next[j][k] = ct[j][k];
    }
    route_vec<K, VR, REG>(e.w & 0xFFFF, d1, next, adj, adj_stride, gsm, G, g, W, live);
    route_vec<K, VR, REG>(e.w >> 16, d2, next, adj, adj_stride, gsm, G, g, W, live);
#pragma unroll
    for (int j = 0; j < VR; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) ct[j][k] = next[j][k];
    }
  }
}

// ---------------------------------------------------------------------------
// Step-count classes of kernels #2 and #3, with compacted tree lists
// ---------------------------------------------------------------------------
//
// A block's shared memory grows with its tree (held results, and for #3
// every stored value and adjoint), so each call launches once per class of
// step counts, each launch with its class's shared memory. A one-block plan
// kernel (vec_plan_kernel) first partitions the trees by class on the
// device, stably; each class launch is one wave of persistent blocks
// (active blocks per SM x SMs) that take the class's trees in list order
// from a work counter, so no block is spent on another class's tree and no
// host sync is needed. Which block runs a tree changes no bit of its
// outputs.

constexpr int VEC_CAP0 = 4;        // class 0: m <= 4 steps
constexpr int VEC_CAP1 = 12;       // class 1: 5 <= m <= 12; class 2: the rest
constexpr int VEC_CLASSES = 3;
constexpr int PLAN_THREADS = 256;
constexpr int PLAN_LOADS = 8;      // a plan thread's loads issued together

// Ints of a call's plan: [T] trees by class, [VEC_CLASSES + 1] class
// starts, [VEC_CLASSES] work counters.
__host__ __device__ inline int vec_plan_ints(int T) { return T + 2 * VEC_CLASSES + 1; }

// The largest step count of class `cls` of a program of L steps.
__host__ __device__ inline int vec_class_cap(int cls, int L) {
  const int cap = cls == 0 ? VEC_CAP0 : (cls == 1 ? VEC_CAP1 : L);
  return cap < L ? cap : L;
}

// A tree's class: by its step count m, or the last class when it has more
// than `ncr` constants (ncr >= 0).
__host__ __device__ inline int vec_class_of(int m, int nc, int ncr) {
  if (ncr >= 0 && nc > ncr) return VEC_CLASSES - 1;
  return m <= VEC_CAP0 ? 0 : (m <= VEC_CAP1 ? 1 : 2);
}

// The plan of one call (one block, PLAN_THREADS threads, VEC_CLASSES *
// PLAN_THREADS ints of shared memory): `plan` [0, T) the trees of class 0,
// then 1, then 2, each in tree order; plan[T + c] class c's first position
// (plan[T + VEC_CLASSES] = T); plan[T + VEC_CLASSES + 1 + c] class c's work
// counter, zeroed. `nconst` (with ncr >= 0) sends trees of many constants
// to the last class.
__global__ void vec_plan_kernel(const int* __restrict__ nsteps, const int* __restrict__ nconst,
                                int T, int L, int ncr, int* __restrict__ plan) {
  extern __shared__ int plan_scan[];   // [VEC_CLASSES][blockDim.x]
  const int tid = threadIdx.x;
  const int P = blockDim.x;
  const int per = (T + P - 1) / P;
  const int lo = min(T, tid * per);
  const int hi = min(T, lo + per);
  int cnt[VEC_CLASSES];
#pragma unroll
  for (int q = 0; q < VEC_CLASSES; ++q) cnt[q] = 0;
  for (int t0 = lo; t0 < hi; t0 += PLAN_LOADS) {   // PLAN_LOADS loads in flight
    int m[PLAN_LOADS], nc[PLAN_LOADS];
#pragma unroll
    for (int u = 0; u < PLAN_LOADS; ++u) {
      m[u] = t0 + u < hi ? nsteps[t0 + u] : 0;
      nc[u] = t0 + u < hi && nconst != nullptr ? nconst[t0 + u] : 0;
    }
#pragma unroll
    for (int u = 0; u < PLAN_LOADS; ++u) {
      const int c = vec_class_of(min(m[u], L), nc[u], ncr);
#pragma unroll
      for (int q = 0; q < VEC_CLASSES; ++q) cnt[q] += (t0 + u < hi && q == c) ? 1 : 0;
    }
  }
#pragma unroll
  for (int q = 0; q < VEC_CLASSES; ++q) plan_scan[q * P + tid] = cnt[q];
  __syncthreads();
  for (int s = 1; s < P; s <<= 1) {   // inclusive scans of each class's counts
    int add[VEC_CLASSES];
#pragma unroll
    for (int q = 0; q < VEC_CLASSES; ++q) add[q] = tid >= s ? plan_scan[q * P + tid - s] : 0;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < VEC_CLASSES; ++q) plan_scan[q * P + tid] += add[q];
    __syncthreads();
  }
  int pos[VEC_CLASSES];
  int start = 0;
#pragma unroll
  for (int q = 0; q < VEC_CLASSES; ++q) {
    pos[q] = start + plan_scan[q * P + tid] - cnt[q];
    if (tid == 0) {
      plan[T + q] = start;
      plan[T + VEC_CLASSES + 1 + q] = 0;
    }
    start += plan_scan[q * P + P - 1];
  }
  if (tid == 0) plan[T + VEC_CLASSES] = T;
  for (int t0 = lo; t0 < hi; t0 += PLAN_LOADS) {
    int m[PLAN_LOADS], nc[PLAN_LOADS];
#pragma unroll
    for (int u = 0; u < PLAN_LOADS; ++u) {
      m[u] = t0 + u < hi ? nsteps[t0 + u] : 0;
      nc[u] = t0 + u < hi && nconst != nullptr ? nconst[t0 + u] : 0;
    }
#pragma unroll
    for (int u = 0; u < PLAN_LOADS; ++u) {
      const int c = vec_class_of(min(m[u], L), nc[u], ncr);
#pragma unroll
      for (int q = 0; q < VEC_CLASSES; ++q) {
        if (t0 + u < hi && q == c) plan[pos[q]++] = t0 + u;
      }
    }
  }
}

// Launches the plan kernel on `stream`; returns cudaGetLastError().
inline cudaError_t launch_vec_plan(const int* nsteps, const int* nconst, int T, int L, int ncr,
                                   int* plan, cudaStream_t stream) {
  vec_plan_kernel<<<1, PLAN_THREADS, VEC_CLASSES * PLAN_THREADS * sizeof(int), stream>>>(
      nsteps, nconst, T, L, ncr, plan);
  return cudaGetLastError();
}

// Thread 0's first position in class `cls`'s list, from the class's work
// counter (vec_next_tree takes each next one a tree ahead, so the atomic's
// latency hides behind the tree before).
__device__ __forceinline__ int vec_reserve(int* plan, int T, int cls) {
  return threadIdx.x == 0 ? atomicAdd(plan + T + VEC_CLASSES + 1 + cls, 1) : 0;
}

// The calling block's next tree of class `cls`, or -1 when the class is
// done: thread 0 broadcasts its reserved position through `snext` and
// reserves the next. Every thread of the block calls it, and the tree's
// decode barriers fall between one call's read of `snext` and the next
// call's write.
__device__ __forceinline__ int vec_next_tree(int* plan, int T, int cls, int* snext,
                                             int& reserved) {
  if (threadIdx.x == 0) {
    *snext = reserved;
    reserved = atomicAdd(plan + T + VEC_CLASSES + 1 + cls, 1);
  }
  __syncthreads();
  const int i = plan[T + cls] + *snext;
  return i < plan[T + cls + 1] ? plan[i] : -1;
}

// Whether class `cls` of the plan has no tree (its launch returns at once).
__device__ __forceinline__ bool vec_class_empty(const int* plan, int T, int cls) {
  return plan[T + cls] == plan[T + cls + 1];
}

// Lanes a launch of K rows a thread runs: W, or for fewer rows than half
// of W the power of two at or above n (one warp of threads at least). The
// lanes past it would hold zero sums only, which lane_tree_sum's `live`
// skips, so every bit stays; a smaller block keeps more trees in flight,
// which a short minibatch's launch needs (its time is each tree's fixed
// cost: the decode, the barriers, the reduction).
__host__ __device__ inline int vec_lanes(int W, int n, int K) {
  int lanes = 32 * K;
  while (lanes < n && lanes < W) lanes <<= 1;
  return lanes < W ? lanes : W;
}

// Blocks of one class launch: one wave of `kern` with `threads` threads and
// `smem` bytes each over every SM (at most T); its active blocks per SM in
// *per_sm. cudaErrorInvalidValue when no block fits.
template <typename Kern>
inline cudaError_t vec_grid(Kern kern, int threads, size_t smem, int T, int* grid, int* per_sm) {
  int dev = 0, nsm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads, smem);
  }
  if (err != cudaSuccess) return err;
  if (*per_sm < 1 || nsm < 1) return cudaErrorInvalidValue;
  *grid = min(T, *per_sm * nsm);
  return cudaSuccess;
}

}  // namespace sr
