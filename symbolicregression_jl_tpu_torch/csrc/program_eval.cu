// Program-interpreter kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_program_kernel` / `_program_launch` in
// symbolicregression_jl_tpu/ops/fused_eval.py (Pallas). It runs one packed,
// leaf-free program per tree (ops/program.py, ops/fused_eval.py
// `_pack_instr`) over every row of the dataset and reduces an elementwise
// loss per tree:
//
//   plain form: loss_sum[t] = sum_r where(w_r > 0, elt_r, 0) * w_r,
//               valid[t]    = every step finite on every row
//                             AND isfinite(loss_sum) AND const_ok[t];
//   cost form:  the same, then mean = loss_sum / denom,
//               loss = (valid && isfinite(mean)) ? mean : inf,
//               cost = loss / norm + parsimony * complexity
//               (core/losses.loss_to_cost's operation order, no FMA).
//
// Instruction word: sign << 30 | code << 24 | src1 << 12 | src2, decoded
// exactly as `_fwd_dispatch` decodes it. `optab[code]` maps each merged
// opcode of the operator set (`_dispatch_plan`) to its operator:
// kind << 8 | op id, kind 0 = identity (unmerged plans), 1 = binary,
// 2 = unary, 3 = the merged add/sub branch a + (1 - 2 sign) * b, whose
// identity steps read the zero row at address BASE + L.
//
// Design. One CTA per tree, so the opcode switch is warp-uniform: every
// thread of the block runs the same instruction stream. Threads stride
// over rows. Each thread keeps its row's X features and step results in
// shared memory laid out [slot][thread] (consecutive threads hit
// consecutive banks); the tree's instruction words and constants sit in
// shared memory once per block. The reduction over rows is a per-thread
// sequential sum followed by a fixed-order tree reduction in shared
// memory: no float atomics, so one input always gives one result.
//
// What bounds it on the H100. The work is FP32 ALU and SFU work: about
// (steps x rows) operator evaluations per tree plus three FLOPs of loss
// per row, with shared-memory traffic for every operand. X (F x n floats,
// 200 KB at the bench shapes) is read by every block and stays resident
// in the 50 MB L2, so device-memory traffic is only the per-tree words.
// The design keeps everything a step touches on chip (shared memory) and
// launches one block per tree so that tens of thousands of blocks fill
// the 132 SMs; making it fast (register-resident buffers, several trees
// per block, row tiles per warp) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

template <int LOSS, bool COST>
__global__ void program_eval_kernel(
    const int* __restrict__ instr,      // [T, L]
    const int* __restrict__ nsteps,     // [T]
    const float* __restrict__ cvals,    // [T, CMAX]
    const int* __restrict__ const_ok,   // [T]
    const float* __restrict__ X,        // [F, n]
    const float* __restrict__ y,        // [n]
    const float* __restrict__ w,        // [n]
    const float* __restrict__ cx,       // [T]   (cost form)
    const float* __restrict__ scal,     // [3]   denom, norm, parsimony (cost form)
    const int* __restrict__ optab,      // [n_codes]
    int L, int CMAX, int F, int n, int code_mask, int sign_shift,
    float* __restrict__ loss_out, int* __restrict__ valid_out,
    float* __restrict__ cost_out) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  float* sv = smem;                          // [(F + L) * bd] per-row values
  float* sc = sv + (size_t)(F + L) * bd;     // [CMAX] constants
  float* sred = sc + CMAX;                   // [bd] reduction scratch
  int* sins = reinterpret_cast<int*>(sred + bd);  // [L] instruction words

  const int base = F + CMAX;
  const int zero_addr = base + L;
  for (int i = tid; i < L; i += bd) sins[i] = instr[(size_t)t * L + i];
  for (int i = tid; i < CMAX; i += bd) sc[i] = cvals[(size_t)t * CMAX + i];
  __syncthreads();

  const int m = nsteps[t];
  float acc = 0.0f;
  bool ok = true;
  for (int r = tid; r < n; r += bd) {
    for (int f = 0; f < F; ++f) sv[f * bd + tid] = X[(size_t)f * n + r];
    float v = 0.0f;
    for (int k = 0; k < m; ++k) {
      const int word = sins[k];
      const int code = (word >> 24) & code_mask;
      const int i1 = (word >> 12) & 0xFFF;
      const int i2 = word & 0xFFF;
      // Operand reads: X row, constant, earlier step, or the zero row.
      auto rd = [&](int a) -> float {
        if (a < F) return sv[a * bd + tid];
        if (a < base) return sc[a - F];
        if (a < zero_addr) return sv[(F + a - base) * bd + tid];
        return 0.0f;
      };
      const int entry = optab[code];
      const int kind = entry >> 8;
      const int id = entry & 0xFF;
      if (kind == K_ADDSUB) {
        const float sg = (float)(1 - 2 * ((word >> sign_shift) & 1));
        v = __fadd_rn(rd(i1), __fmul_rn(sg, rd(i2)));
      } else if (kind == K_BINARY) {
        v = apply_binary(id, rd(i1), rd(i2));
      } else if (kind == K_UNARY) {
        v = apply_unary(id, rd(i1));
      } else {
        v = rd(i1);
      }
      sv[(F + k) * bd + tid] = v;
      ok = ok && isfinite(v);
    }
    const float wr = w[r];
    const float elt = elementwise_loss<LOSS>(v, y[r]);
    acc = __fadd_rn(acc, __fmul_rn(wr > 0.0f ? elt : 0.0f, wr));
  }

  const int all_ok = __syncthreads_and(ok ? 1 : 0);
  sred[tid] = acc;
  __syncthreads();
  for (int s = bd >> 1; s > 0; s >>= 1) {
    if (tid < s) sred[tid] = __fadd_rn(sred[tid], sred[tid + s]);
    __syncthreads();
  }
  if (tid == 0) {
    const float total = sred[0];
    const int valid = (all_ok && isfinite(total) && const_ok[t] != 0) ? 1 : 0;
    valid_out[t] = valid;
    if (COST) {
      const float mean = __fdiv_rn(total, scal[0]);
      const float lossf = (valid && isfinite(mean)) ? mean : INFINITY;
      loss_out[t] = lossf;
      cost_out[t] = __fadd_rn(__fdiv_rn(lossf, scal[1]), __fmul_rn(scal[2], cx[t]));
    } else {
      loss_out[t] = total;
    }
  }
}

template <int LOSS, bool COST>
cudaError_t launch_one(int T, int block, size_t smem, cudaStream_t stream,
                       const int* instr, const int* nsteps, const float* cvals,
                       const int* const_ok, const float* X, const float* y,
                       const float* w, const float* cx, const float* scal,
                       const int* optab, int L, int CMAX, int F, int n,
                       int code_mask, int sign_shift, float* loss, int* valid,
                       float* cost) {
  auto kern = program_eval_kernel<LOSS, COST>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<T, block, smem, stream>>>(instr, nsteps, cvals, const_ok, X, y, w, cx,
                                   scal, optab, L, CMAX, F, n, code_mask,
                                   sign_shift, loss, valid, cost);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory a launch with `block` threads needs.
extern "C" size_t sr_program_eval_smem(int block, int L, int CMAX, int F) {
  return sizeof(float) * ((size_t)(F + L) * block + CMAX + block) + sizeof(int) * L;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// `cost` == nullptr selects the plain form.
extern "C" int sr_program_eval(const int* instr, const int* nsteps,
                               const float* cvals, const int* const_ok,
                               const float* X, const float* y, const float* w,
                               const float* cx, const float* scal,
                               const int* optab, int T, int L, int CMAX, int F,
                               int n, int block, int loss_kind, int code_mask,
                               int sign_shift, float* loss, int* valid,
                               float* cost, void* stream) {
  if (T == 0) return 0;
  const size_t smem = sr_program_eval_smem(block, L, CMAX, F);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SR_LAUNCH(LK)                                                              \
  err = (cost != nullptr)                                                          \
            ? launch_one<LK, true>(T, block, smem, s, instr, nsteps, cvals,        \
                                   const_ok, X, y, w, cx, scal, optab, L, CMAX, F, \
                                   n, code_mask, sign_shift, loss, valid, cost)   \
            : launch_one<LK, false>(T, block, smem, s, instr, nsteps, cvals,       \
                                    const_ok, X, y, w, cx, scal, optab, L, CMAX,  \
                                    F, n, code_mask, sign_shift, loss, valid,     \
                                    cost);
  switch (loss_kind) {
    case LOSS_L2: SR_LAUNCH(LOSS_L2) break;
    case LOSS_L1: SR_LAUNCH(LOSS_L1) break;
    case LOSS_HUBER: SR_LAUNCH(LOSS_HUBER) break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SR_LAUNCH
  return (int)err;
}
