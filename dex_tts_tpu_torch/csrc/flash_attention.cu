// Flash attention for the DiT's multi-head self-attention, Hopper: the
// forward (with its log-sum-exp for training) and the backward's dK/dV and
// dQ kernels.
//
// Replaces the TPU kernels reached from dex_tts_tpu/models/dit.py
// MHSA._flash (the library Pallas kernel
// jax.experimental.pallas.ops.tpu.flash_attention: its forward and, when a
// train step differentiates it, _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq) and MHSA._splash, which compute the same
// function: exact non-causal softmax(q·kᵀ·scale)·v per (batch, head),
// softmax statistics in f32.
//
// Forward bound at the main-path shape (B=16, H=2, T=3840, hd=128, bf16
// on an H100 SXM): 4·B·H·T²·hd = 2.42e11 FLOP → 0.244 ms at 989 TFLOP/s,
// against 4 × 31.5 MB of q, k, v, o → 0.038 ms at 3.35 TB/s. The kernel is
// bound by operations, so the work goes to the tensor cores and the T×T
// scores never leave registers.
//
// Forward design (first version: simple and correct; a wgmma + TMA
// redesign with a producer warp and a ring of K/V tiles is later work):
//   * grid (B·H, ⌈T/64⌉); 4 warps per CTA, each owns 16 query rows whose
//     bf16 fragments stay in registers for the whole key loop;
//   * a loop inside the CTA walks 64-key K/V tiles staged in shared memory
//     (rows padded by 16 bytes so fragment loads are free of bank
//     conflicts); keys ≥ T are zero-filled and scored −inf, queries ≥ T are
//     not stored, so any T works with no padding copy;
//   * S = Q·Kᵀ and O += P·V by mma.sync m16n8k16 (bf16 in, f32 accumulate);
//     V fragments come from ldmatrix.trans; P is rounded to bf16 before
//     P·V, as the JAX einsum branch rounds its weights to the compute type;
//   * online softmax with f32 running max and sum; the scale hd^-½ is
//     applied to the f32 scores (folded with log2 e for exp2);
//   * with a non-null `lse` (training) each query's natural-log
//     log-sum-exp of the scaled scores is written to lse[b, h, t] (f32);
//     that is a second instantiation, so inference runs the kernel with no
//     log-sum-exp code in it.
// The f32 variant does the same with f32 FMA on the CUDA cores (no TF32):
// 4 threads per query, each holding 32 of the 128 dims.
//
// Backward (per (b, h), with D = rowsum(dO∘O) computed outside, as the
// library computes it in XLA): P = exp(S·scale − lse) recomputed from the
// saved log-sum-exp, dP = dO·Vᵀ, dS = P∘(dP − D); dV = Pᵀ·dO with P
// rounded to the input type (the library's p.T.astype(do.dtype)), dK =
// scale·dSᵀ·Q and dQ = scale·dS·K with dS rounded to the input type for
// the tensor cores and the scale applied to the f32 sums. Bound at the
// train step's shape (B=32, T=880, H=2, hd=128, bf16): 10·B·H·T²·hd
// operations (S and dP recomputed, dV, dK, dQ: five T×T×hd products) =
// 6.3e10 → 0.064 ms at 989 TFLOP/s; bytes (q, k, v, o, dO read, dq, dk, dv
// written, lse and D) ≈ 58 MB → 0.017 ms. Bound by operations.
//   * dK/dV: grid (B·H, ⌈T/64⌉ key blocks); 4 warps × 16 keys; the key
//     block's K and V tiles and 32-query Q and dO tiles live in shared
//     memory (dynamic, 52 KB), the dK and dV sums (2 × 64 f32 per thread)
//     in registers; Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ come from the same mma
//     pattern as the forward's S, dV += Pᵀ·dO and dK += dSᵀ·Q from its P·V
//     pattern (ldmatrix.trans on the Q and dO tiles).
//   * dQ: grid (B·H, ⌈T/64⌉ query blocks); 4 warps × 16 queries with their
//     Q and dO fragments in registers (as the forward's Q), 64-key K/V
//     tiles in shared memory walked in 32-key halves, dQ += dS·K.
//   * queries ≥ T are zero rows with lse = +inf (P = 0), keys ≥ T zero rows
//     whose P is forced to 0 in dQ and whose dK/dV are not stored; any T.
//   * the f32 variants: 4 threads per key (dK/dV) or per query (dQ), each
//     holding 32 dims, 32-row tiles, FMA on the CUDA cores.
// Inputs are read through strides (views of the DiT's (B, T, 3, H, hd)
// projection); gradients are written through strides into one
// (B, T, 3, H, hd) buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------- bf16 ---

constexpr int kBlockQ = 64;             // 4 warps × 16 query rows
constexpr int kBlockK = 64;             // keys per shared-memory tile
constexpr int kRow = kHeadDim + 8;      // padded smem row, bf16 elements

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              const __nv_bfloat16* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

template <bool kLse>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
               int T, int H,
               long long q_sb, long long q_st, long long q_sh,
               long long k_sb, long long k_st, long long k_sh,
               long long v_sb, long long v_st, long long v_sh,
               float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * kRow];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK * kRow];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // row within the 8-row half of a fragment
  const int tq = lane & 3;   // column pair within a fragment
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  // this thread's two query rows (g and g + 8 of the warp's 16)
  const int r0 = blockIdx.y * kBlockQ + warp * 16 + g;
  const int r1 = r0 + 8;
  const bool ok0 = r0 < T;
  const bool ok1 = r1 < T;

  uint32_t qf[kHeadDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const int c = kk * 16 + tq * 2;
    qf[kk][0] = ok0 ? load_u32(qb + r0 * q_st + c) : 0u;
    qf[kk][1] = ok1 ? load_u32(qb + r1 * q_st + c) : 0u;
    qf[kk][2] = ok0 ? load_u32(qb + r0 * q_st + c + 8) : 0u;
    qf[kk][3] = ok1 ? load_u32(qb + r1 * q_st + c + 8) : 0u;
  }

  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int d = 0; d < kHeadDim / 8; ++d) {
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = (T + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    // stage the K and V tiles: 64 rows × 16 chunks of 16 bytes each
    for (int i = threadIdx.x; i < kBlockK * (kHeadDim / 8); i += blockDim.x) {
      const int row = i / (kHeadDim / 8);
      const int ch = (i % (kHeadDim / 8)) * 8;
      const int key = k0 + row;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u);
      uint4 vx = make_uint4(0u, 0u, 0u, 0u);
      if (key < T) {
        kx = *reinterpret_cast<const uint4*>(kb + key * k_st + ch);
        vx = *reinterpret_cast<const uint4*>(vb + key * v_st + ch);
      }
      *reinterpret_cast<uint4*>(ks + row * kRow + ch) = kx;
      *reinterpret_cast<uint4*>(vs + row * kRow + ch) = vx;
    }
    __syncthreads();

    // S = Q·Kᵀ for the warp's 16 rows × 64 keys (8 tiles of 8 keys)
    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        const __nv_bfloat16* kp = ks + (n * 8 + g) * kRow + kk * 16 + tq * 2;
        mma_bf16(s[n], qf[kk], load_u32(kp), load_u32(kp + 8));
      }
    }

    // scale, mask keys ≥ T, row max over the tile
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + tq * 2 + (e & 1);
        const float val = key < T ? s[n][e] * scale_log2 : -INFINITY;
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float base[2];
    float alpha[2];
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      base[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(m_run[i] - base[i]);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - base[e >> 1]);
        s[n][e] = p;
        rsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rsum[i];
#pragma unroll
    for (int d = 0; d < kHeadDim / 8; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // O += P·V, 16 keys per step; the S accumulator layout of two 8-key
    // tiles is the A-operand layout of one 16-key step
    const int mi = lane >> 3;   // which 8×8 matrix this lane addresses
    const int mr = lane & 7;    // which row of it
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int dn = 0; dn < kHeadDim / 16; ++dn) {
        const __nv_bfloat16* vp =
            vs + (j * 16 + mr + (mi & 1) * 8) * kRow + dn * 16 + (mi >> 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(b0, b1, b2, b3, vp);
        mma_bf16(acc[2 * dn], a, b0, b1);
        mma_bf16(acc[2 * dn + 1], a, b2, b3);
      }
    }
    __syncthreads();
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    inv[i] = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
  }
  if (kLse && tq == 0) {  // natural-log log-sum-exp of the scaled scores
    float* lb = lse + static_cast<long long>(blockIdx.x) * T;
    if (ok0) lb[r0] = (m_run[0] + log2f(l_run[0])) * kLn2;
    if (ok1) lb[r1] = (m_run[1] + log2f(l_run[1])) * kLn2;
  }
  const long long o_st = static_cast<long long>(H) * kHeadDim;
  __nv_bfloat16* ob = o + static_cast<long long>(b) * T * o_st + h * kHeadDim;
#pragma unroll
  for (int d = 0; d < kHeadDim / 8; ++d) {
    const int c = d * 8 + tq * 2;
    if (ok0) {
      *reinterpret_cast<uint32_t*>(ob + r0 * o_st + c) =
          pack_bf16(acc[d][0] * inv[0], acc[d][1] * inv[0]);
    }
    if (ok1) {
      *reinterpret_cast<uint32_t*>(ob + r1 * o_st + c) =
          pack_bf16(acc[d][2] * inv[1], acc[d][3] * inv[1]);
    }
  }
}

// ----------------------------------------------------------------- f32 ---

constexpr int kF32BlockQ = 32;   // 128 threads, 4 per query
constexpr int kF32BlockK = 32;
constexpr int kPer = kHeadDim / 4;  // dims held by each thread

template <bool kLse>
__global__ void __launch_bounds__(128)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int T, int H, long long q_sb, long long q_st, long long q_sh,
              long long k_sb, long long k_st, long long k_sh,
              long long v_sb, long long v_st, long long v_sh,
              float scale_log2) {
  __shared__ __align__(16) float ks[kF32BlockK * kHeadDim];
  __shared__ __align__(16) float vs[kF32BlockK * kHeadDim];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int sub = threadIdx.x & 3;
  const int row = blockIdx.y * kF32BlockQ + (threadIdx.x >> 2);
  const bool ok = row < T;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  // thread `sub` holds dims 16·i + 4·sub + {0..3}, i = 0..7: the four
  // threads of a query read 64 contiguous bytes of a K/V row at a time
  float qr[kPer];
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer / 4; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) x = *reinterpret_cast<const float4*>(qb + row * q_st + 16 * i + 4 * sub);
    qr[4 * i] = x.x;
    qr[4 * i + 1] = x.y;
    qr[4 * i + 2] = x.z;
    qr[4 * i + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  const int n_tiles = (T + kF32BlockK - 1) / kF32BlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32BlockK;
    for (int i = threadIdx.x; i < kF32BlockK * (kHeadDim / 4); i += blockDim.x) {
      const int r = i / (kHeadDim / 4);
      const int c = (i % (kHeadDim / 4)) * 4;
      const int key = k0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = make_float4(0.f, 0.f, 0.f, 0.f);
      if (key < T) {
        kx = *reinterpret_cast<const float4*>(kb + key * k_st + c);
        vx = *reinterpret_cast<const float4*>(vb + key * v_st + c);
      }
      *reinterpret_cast<float4*>(ks + r * kHeadDim + c) = kx;
      *reinterpret_cast<float4*>(vs + r * kHeadDim + c) = vx;
    }
    __syncthreads();

    float sc[kF32BlockK];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kF32BlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kPer / 4; ++i) {
        const float4 kx =
            *reinterpret_cast<const float4*>(ks + j * kHeadDim + 16 * i + 4 * sub);
        dot = fmaf(qr[4 * i], kx.x, dot);
        dot = fmaf(qr[4 * i + 1], kx.y, dot);
        dot = fmaf(qr[4 * i + 2], kx.z, dot);
        dot = fmaf(qr[4 * i + 3], kx.w, dot);
      }
      // butterfly: all four lanes end with the same (commutative) sum
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const float val = k0 + j < T ? dot * scale_log2 : -INFINITY;
      sc[j] = val;
      mx = fmaxf(mx, val);
    }
    const float m_new = fmaxf(m_run, mx);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m_run - base);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32BlockK; ++j) {
      const float p = exp2f(sc[j] - base);
      l_run += p;
#pragma unroll
      for (int i = 0; i < kPer / 4; ++i) {
        const float4 vx =
            *reinterpret_cast<const float4*>(vs + j * kHeadDim + 16 * i + 4 * sub);
        acc[4 * i] = fmaf(p, vx.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(p, vx.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(p, vx.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(p, vx.w, acc[4 * i + 3]);
      }
    }
    __syncthreads();
  }

  if (!ok) return;
  if (kLse && sub == 0) {
    lse[static_cast<long long>(blockIdx.x) * T + row] = (m_run + log2f(l_run)) * kLn2;
  }
  const float inv = l_run > 0.f ? 1.f / l_run : 0.f;
  const long long o_st = static_cast<long long>(H) * kHeadDim;
  float* orow = o + (static_cast<long long>(b) * T + row) * o_st + h * kHeadDim;
#pragma unroll
  for (int i = 0; i < kPer / 4; ++i) {
    *reinterpret_cast<float4*>(orow + 16 * i + 4 * sub) =
        make_float4(acc[4 * i] * inv, acc[4 * i + 1] * inv,
                    acc[4 * i + 2] * inv, acc[4 * i + 3] * inv);
  }
}


// --------------------------------------------------------- backward ---

struct Strides {
  long long b, t, h;
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, T), natural log
  const float* delta;  // (B, H, T), rowsum(dO∘O)
  void* dq;
  void* dk;
  void* dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int T, H;
  float scale_log2, scale;
};

template <typename T_>
__device__ __forceinline__ const T_* at(const void* base, const Strides& s, int b, int h) {
  return static_cast<const T_*>(base) + b * s.b + h * s.h;
}

template <typename T_>
__device__ __forceinline__ T_* at_mut(void* base, const Strides& s, int b, int h) {
  return static_cast<T_*>(base) + b * s.b + h * s.h;
}

constexpr int kBwdBlockQ = 32;  // queries per staged tile in dK/dV
constexpr int kBwdSmem =
    (2 * kBlockK + 2 * kBwdBlockQ) * kRow * 2 + 2 * kBwdBlockQ * 4;

// one 64-row × 128 bf16 tile (rows ≥ T zero-filled) into padded smem
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long st, int r0, int rows, int T) {
  for (int i = threadIdx.x; i < rows * (kHeadDim / 8); i += blockDim.x) {
    const int row = i / (kHeadDim / 8);
    const int ch = (i % (kHeadDim / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < T) x = *reinterpret_cast<const uint4*>(src + (r0 + row) * st + ch);
    *reinterpret_cast<uint4*>(dst + row * kRow + ch) = x;
  }
}

__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBlockK * kRow;
  __nv_bfloat16* qs = vs + kBlockK * kRow;
  __nv_bfloat16* dos = qs + kBwdBlockQ * kRow;
  float* lse_s = reinterpret_cast<float*>(dos + kBwdBlockQ * kRow);  // log2 units
  float* dl_s = lse_s + kBwdBlockQ;

  const int T = a.T;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int mi = lane >> 3;
  const int mr = lane & 7;
  const __nv_bfloat16* qb = at<__nv_bfloat16>(a.q, a.sq, b, h);
  const __nv_bfloat16* dob = at<__nv_bfloat16>(a.dout, a.sdo, b, h);
  const float* lb = a.lse + static_cast<long long>(blockIdx.x) * T;
  const float* db = a.delta + static_cast<long long>(blockIdx.x) * T;
  const int k0 = blockIdx.y * kBlockK;
  stage_rows(ks, at<__nv_bfloat16>(a.k, a.sk, b, h), a.sk.t, k0, kBlockK, T);
  stage_rows(vs, at<__nv_bfloat16>(a.v, a.sv, b, h), a.sv.t, k0, kBlockK, T);

  float dk[kHeadDim / 8][4];
  float dv[kHeadDim / 8][4];
#pragma unroll
  for (int d = 0; d < kHeadDim / 8; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  }
  const int kr = warp * 16;  // the warp's first key row in ks / vs

  for (int q0 = 0; q0 < T; q0 += kBwdBlockQ) {
    __syncthreads();  // K/V staged; the previous Q/dO tile consumed
    stage_rows(qs, qb, a.sq.t, q0, kBwdBlockQ, T);
    stage_rows(dos, dob, a.sdo.t, q0, kBwdBlockQ, T);
    if (threadIdx.x < kBwdBlockQ) {
      const int q = q0 + threadIdx.x;
      lse_s[threadIdx.x] = q < T ? lb[q] * kLog2e : INFINITY;
      dl_s[threadIdx.x] = q < T ? db[q] : 0.f;
    }
    __syncthreads();

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for the warp's 16 keys × 32 queries
    float st[kBwdBlockQ / 8][4];
    float dpt[kBwdBlockQ / 8][4];
#pragma unroll
    for (int n = 0; n < kBwdBlockQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      const int c = kk * 16 + tq * 2;
      uint32_t ka[4], va[4];
      ka[0] = load_u32(ks + (kr + g) * kRow + c);
      ka[1] = load_u32(ks + (kr + g + 8) * kRow + c);
      ka[2] = load_u32(ks + (kr + g) * kRow + c + 8);
      ka[3] = load_u32(ks + (kr + g + 8) * kRow + c + 8);
      va[0] = load_u32(vs + (kr + g) * kRow + c);
      va[1] = load_u32(vs + (kr + g + 8) * kRow + c);
      va[2] = load_u32(vs + (kr + g) * kRow + c + 8);
      va[3] = load_u32(vs + (kr + g + 8) * kRow + c + 8);
#pragma unroll
      for (int n = 0; n < kBwdBlockQ / 8; ++n) {
        const __nv_bfloat16* qp = qs + (n * 8 + g) * kRow + c;
        mma_bf16(st[n], ka, load_u32(qp), load_u32(qp + 8));
        const __nv_bfloat16* dp = dos + (n * 8 + g) * kRow + c;
        mma_bf16(dpt[n], va, load_u32(dp), load_u32(dp + 8));
      }
    }
    // Pᵀ = exp(S·scale − lse) and dSᵀ = Pᵀ∘(dPᵀ − D), per query column
#pragma unroll
    for (int n = 0; n < kBwdBlockQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + tq * 2 + (e & 1);
        const float p = exp2f(st[n][e] * a.scale_log2 - lse_s[qi]);
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - dl_s[qi]);
      }
    }
    // dV += Pᵀ·dO and dK += dSᵀ·Q, 16 queries per step
#pragma unroll
    for (int j = 0; j < kBwdBlockQ / 16; ++j) {
      uint32_t pa[4], sa[4];
      pa[0] = pack_bf16(st[2 * j][0], st[2 * j][1]);
      pa[1] = pack_bf16(st[2 * j][2], st[2 * j][3]);
      pa[2] = pack_bf16(st[2 * j + 1][0], st[2 * j + 1][1]);
      pa[3] = pack_bf16(st[2 * j + 1][2], st[2 * j + 1][3]);
      sa[0] = pack_bf16(dpt[2 * j][0], dpt[2 * j][1]);
      sa[1] = pack_bf16(dpt[2 * j][2], dpt[2 * j][3]);
      sa[2] = pack_bf16(dpt[2 * j + 1][0], dpt[2 * j + 1][1]);
      sa[3] = pack_bf16(dpt[2 * j + 1][2], dpt[2 * j + 1][3]);
      const int row = (j * 16 + mr + (mi & 1) * 8) * kRow + (mi >> 1) * 8;
#pragma unroll
      for (int dn = 0; dn < kHeadDim / 16; ++dn) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(b0, b1, b2, b3, dos + row + dn * 16);
        mma_bf16(dv[2 * dn], pa, b0, b1);
        mma_bf16(dv[2 * dn + 1], pa, b2, b3);
        ldsm_x4_trans(b0, b1, b2, b3, qs + row + dn * 16);
        mma_bf16(dk[2 * dn], sa, b0, b1);
        mma_bf16(dk[2 * dn + 1], sa, b2, b3);
      }
    }
  }

  const int r0 = k0 + kr + g;
  const int r1 = r0 + 8;
  __nv_bfloat16* dkb = at_mut<__nv_bfloat16>(a.dk, a.sdk, b, h);
  __nv_bfloat16* dvb = at_mut<__nv_bfloat16>(a.dv, a.sdv, b, h);
#pragma unroll
  for (int d = 0; d < kHeadDim / 8; ++d) {
    const int c = d * 8 + tq * 2;
    if (r0 < T) {
      *reinterpret_cast<uint32_t*>(dkb + r0 * a.sdk.t + c) =
          pack_bf16(dk[d][0] * a.scale, dk[d][1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + r0 * a.sdv.t + c) = pack_bf16(dv[d][0], dv[d][1]);
    }
    if (r1 < T) {
      *reinterpret_cast<uint32_t*>(dkb + r1 * a.sdk.t + c) =
          pack_bf16(dk[d][2] * a.scale, dk[d][3] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + r1 * a.sdv.t + c) = pack_bf16(dv[d][2], dv[d][3]);
    }
  }
}

__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(BwdArgs a) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * kRow];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK * kRow];

  const int T = a.T;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int mi = lane >> 3;
  const int mr = lane & 7;
  const __nv_bfloat16* qb = at<__nv_bfloat16>(a.q, a.sq, b, h);
  const __nv_bfloat16* kb = at<__nv_bfloat16>(a.k, a.sk, b, h);
  const __nv_bfloat16* vb = at<__nv_bfloat16>(a.v, a.sv, b, h);
  const __nv_bfloat16* dob = at<__nv_bfloat16>(a.dout, a.sdo, b, h);
  const float* lb = a.lse + static_cast<long long>(blockIdx.x) * T;
  const float* db = a.delta + static_cast<long long>(blockIdx.x) * T;

  const int r0 = blockIdx.y * kBlockQ + warp * 16 + g;
  const int r1 = r0 + 8;
  const bool ok0 = r0 < T;
  const bool ok1 = r1 < T;
  uint32_t qf[kHeadDim / 16][4];
  uint32_t df[kHeadDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const int c = kk * 16 + tq * 2;
    qf[kk][0] = ok0 ? load_u32(qb + r0 * a.sq.t + c) : 0u;
    qf[kk][1] = ok1 ? load_u32(qb + r1 * a.sq.t + c) : 0u;
    qf[kk][2] = ok0 ? load_u32(qb + r0 * a.sq.t + c + 8) : 0u;
    qf[kk][3] = ok1 ? load_u32(qb + r1 * a.sq.t + c + 8) : 0u;
    df[kk][0] = ok0 ? load_u32(dob + r0 * a.sdo.t + c) : 0u;
    df[kk][1] = ok1 ? load_u32(dob + r1 * a.sdo.t + c) : 0u;
    df[kk][2] = ok0 ? load_u32(dob + r0 * a.sdo.t + c + 8) : 0u;
    df[kk][3] = ok1 ? load_u32(dob + r1 * a.sdo.t + c + 8) : 0u;
  }
  const float lse2[2] = {ok0 ? lb[r0] * kLog2e : 0.f, ok1 ? lb[r1] * kLog2e : 0.f};
  const float dl[2] = {ok0 ? db[r0] : 0.f, ok1 ? db[r1] : 0.f};

  float dq[kHeadDim / 8][4];
#pragma unroll
  for (int d = 0; d < kHeadDim / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  for (int k0 = 0; k0 < T; k0 += kBlockK) {
    stage_rows(ks, kb, a.sk.t, k0, kBlockK, T);
    stage_rows(vs, vb, a.sv.t, k0, kBlockK, T);
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kbase = half * 32;
      float s[4][4];
      float dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kHeadDim / 16; ++kk) {
          const int off = (kbase + n * 8 + g) * kRow + kk * 16 + tq * 2;
          mma_bf16(s[n], qf[kk], load_u32(ks + off), load_u32(ks + off + 8));
          mma_bf16(dp[n], df[kk], load_u32(vs + off), load_u32(vs + off + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kbase + n * 8 + tq * 2 + (e & 1);
          const float p = key < T ? exp2f(s[n][e] * a.scale_log2 - lse2[e >> 1]) : 0.f;
          dp[n][e] = p * (dp[n][e] - dl[e >> 1]);
        }
      }
      // dQ += dS·K, 16 keys per step
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t sa[4];
        sa[0] = pack_bf16(dp[2 * j][0], dp[2 * j][1]);
        sa[1] = pack_bf16(dp[2 * j][2], dp[2 * j][3]);
        sa[2] = pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]);
        sa[3] = pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3]);
        const int row = (kbase + j * 16 + mr + (mi & 1) * 8) * kRow + (mi >> 1) * 8;
#pragma unroll
        for (int dn = 0; dn < kHeadDim / 16; ++dn) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(b0, b1, b2, b3, ks + row + dn * 16);
          mma_bf16(dq[2 * dn], sa, b0, b1);
          mma_bf16(dq[2 * dn + 1], sa, b2, b3);
        }
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* dqb = at_mut<__nv_bfloat16>(a.dq, a.sdq, b, h);
#pragma unroll
  for (int d = 0; d < kHeadDim / 8; ++d) {
    const int c = d * 8 + tq * 2;
    if (ok0) {
      *reinterpret_cast<uint32_t*>(dqb + r0 * a.sdq.t + c) =
          pack_bf16(dq[d][0] * a.scale, dq[d][1] * a.scale);
    }
    if (ok1) {
      *reinterpret_cast<uint32_t*>(dqb + r1 * a.sdq.t + c) =
          pack_bf16(dq[d][2] * a.scale, dq[d][3] * a.scale);
    }
  }
}

// f32: 4 threads per row, thread `sub` holding dims 16·i + 4·sub + {0..3}
__device__ __forceinline__ void load_row_f32(float r[kPer], const float* p, bool ok, int sub) {
#pragma unroll
  for (int i = 0; i < kPer / 4; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) x = *reinterpret_cast<const float4*>(p + 16 * i + 4 * sub);
    r[4 * i] = x.x;
    r[4 * i + 1] = x.y;
    r[4 * i + 2] = x.z;
    r[4 * i + 3] = x.w;
  }
}

__device__ __forceinline__ void store_row_f32(float* p, const float r[kPer], float scale, int sub) {
#pragma unroll
  for (int i = 0; i < kPer / 4; ++i) {
    *reinterpret_cast<float4*>(p + 16 * i + 4 * sub) =
        make_float4(r[4 * i] * scale, r[4 * i + 1] * scale, r[4 * i + 2] * scale,
                    r[4 * i + 3] * scale);
  }
}

// dot product of a register row with a shared-memory row, summed over the
// four threads of the row (all four end with the same sum)
__device__ __forceinline__ float dot_row_f32(const float r[kPer], const float* s, int sub) {
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < kPer / 4; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(s + 16 * i + 4 * sub);
    dot = fmaf(r[4 * i], x.x, dot);
    dot = fmaf(r[4 * i + 1], x.y, dot);
    dot = fmaf(r[4 * i + 2], x.z, dot);
    dot = fmaf(r[4 * i + 3], x.w, dot);
  }
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  dot += __shfl_xor_sync(0xffffffffu, dot, 2);
  return dot;
}

__device__ __forceinline__ void axpy_row_f32(float r[kPer], float a, const float* s, int sub) {
#pragma unroll
  for (int i = 0; i < kPer / 4; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(s + 16 * i + 4 * sub);
    r[4 * i] = fmaf(a, x.x, r[4 * i]);
    r[4 * i + 1] = fmaf(a, x.y, r[4 * i + 1]);
    r[4 * i + 2] = fmaf(a, x.z, r[4 * i + 2]);
    r[4 * i + 3] = fmaf(a, x.w, r[4 * i + 3]);
  }
}

__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, long long st,
                                               int r0, int T) {
  for (int i = threadIdx.x; i < kF32BlockK * (kHeadDim / 4); i += blockDim.x) {
    const int r = i / (kHeadDim / 4);
    const int c = (i % (kHeadDim / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) x = *reinterpret_cast<const float4*>(src + (r0 + r) * st + c);
    *reinterpret_cast<float4*>(dst + r * kHeadDim + c) = x;
  }
}

__global__ void __launch_bounds__(128) flash_bwd_dkv_f32(BwdArgs a) {
  __shared__ __align__(16) float qs[kF32BlockK * kHeadDim];
  __shared__ __align__(16) float dos[kF32BlockK * kHeadDim];
  __shared__ float lse_s[kF32BlockK];
  __shared__ float dl_s[kF32BlockK];

  const int T = a.T;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int sub = threadIdx.x & 3;
  const int key = blockIdx.y * kF32BlockK + (threadIdx.x >> 2);
  const bool ok = key < T;
  const float* qb = at<float>(a.q, a.sq, b, h);
  const float* dob = at<float>(a.dout, a.sdo, b, h);
  const float* lb = a.lse + static_cast<long long>(blockIdx.x) * T;
  const float* db = a.delta + static_cast<long long>(blockIdx.x) * T;

  float kr[kPer], vr[kPer], dk[kPer], dv[kPer];
  load_row_f32(kr, at<float>(a.k, a.sk, b, h) + key * a.sk.t, ok, sub);
  load_row_f32(vr, at<float>(a.v, a.sv, b, h) + key * a.sv.t, ok, sub);
#pragma unroll
  for (int i = 0; i < kPer; ++i) dk[i] = dv[i] = 0.f;

  for (int q0 = 0; q0 < T; q0 += kF32BlockK) {
    __syncthreads();
    stage_rows_f32(qs, qb, a.sq.t, q0, T);
    stage_rows_f32(dos, dob, a.sdo.t, q0, T);
    if (threadIdx.x < kF32BlockK) {
      const int q = q0 + threadIdx.x;
      lse_s[threadIdx.x] = q < T ? lb[q] * kLog2e : INFINITY;
      dl_s[threadIdx.x] = q < T ? db[q] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kF32BlockK; ++j) {
      const float s = dot_row_f32(kr, qs + j * kHeadDim, sub);
      const float dp = dot_row_f32(vr, dos + j * kHeadDim, sub);
      const float p = exp2f(s * a.scale_log2 - lse_s[j]);
      axpy_row_f32(dv, p, dos + j * kHeadDim, sub);
      axpy_row_f32(dk, p * (dp - dl_s[j]), qs + j * kHeadDim, sub);
    }
  }
  if (!ok) return;
  store_row_f32(at_mut<float>(a.dk, a.sdk, b, h) + key * a.sdk.t, dk, a.scale, sub);
  store_row_f32(at_mut<float>(a.dv, a.sdv, b, h) + key * a.sdv.t, dv, 1.f, sub);
}

__global__ void __launch_bounds__(128) flash_bwd_dq_f32(BwdArgs a) {
  __shared__ __align__(16) float ks[kF32BlockK * kHeadDim];
  __shared__ __align__(16) float vs[kF32BlockK * kHeadDim];

  const int T = a.T;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int sub = threadIdx.x & 3;
  const int row = blockIdx.y * kF32BlockQ + (threadIdx.x >> 2);
  const bool ok = row < T;
  const float* kb = at<float>(a.k, a.sk, b, h);
  const float* vb = at<float>(a.v, a.sv, b, h);
  const float* lb = a.lse + static_cast<long long>(blockIdx.x) * T;
  const float* db = a.delta + static_cast<long long>(blockIdx.x) * T;

  float qr[kPer], dr[kPer], dq[kPer];
  load_row_f32(qr, at<float>(a.q, a.sq, b, h) + row * a.sq.t, ok, sub);
  load_row_f32(dr, at<float>(a.dout, a.sdo, b, h) + row * a.sdo.t, ok, sub);
#pragma unroll
  for (int i = 0; i < kPer; ++i) dq[i] = 0.f;
  const float lse2 = ok ? lb[row] * kLog2e : 0.f;
  const float dl = ok ? db[row] : 0.f;

  for (int k0 = 0; k0 < T; k0 += kF32BlockK) {
    stage_rows_f32(ks, kb, a.sk.t, k0, T);
    stage_rows_f32(vs, vb, a.sv.t, k0, T);
    __syncthreads();
    const int n = min(kF32BlockK, T - k0);
    for (int j = 0; j < n; ++j) {
      const float s = dot_row_f32(qr, ks + j * kHeadDim, sub);
      const float dp = dot_row_f32(dr, vs + j * kHeadDim, sub);
      const float p = exp2f(s * a.scale_log2 - lse2);
      axpy_row_f32(dq, p * (dp - dl), ks + j * kHeadDim, sub);
    }
    __syncthreads();
  }
  if (!ok) return;
  store_row_f32(at_mut<float>(a.dq, a.sdq, b, h) + row * a.sdq.t, dq, a.scale, sub);
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, void* dk, void* dv,
                  int T, int H, const long long* s, float scale) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  Strides* all[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *all[i] = Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
  a.T = T;
  a.H = H;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. `lse` is
// null for inference, else an f32 (B, H, T) output. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
    int B, int T, int H, int head_dim, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, float scale,
    void* stream) {
  if (head_dim != kHeadDim || B <= 0 || T <= 0 || H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid(B * H, (T + kBlockQ - 1) / kBlockQ);
    auto kernel = lse != nullptr ? flash_fwd_bf16<true> : flash_fwd_bf16<false>;
    kernel<<<grid, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), T, H, q_sb,
        q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale_log2);
  } else if (dtype == 0) {
    const dim3 grid(B * H, (T + kF32BlockQ - 1) / kF32BlockQ);
    auto kernel = lse != nullptr ? flash_fwd_f32<true> : flash_fwd_f32<false>;
    kernel<<<grid, 128, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), T, H, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
        v_sb, v_st, v_sh, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's dK/dV kernel. `strides` (host memory): 21 element strides,
// (batch, time, head) of q, k, v, dout, dq, dk, dv in that order (dq unused
// here). lse and delta: f32 (B, H, T).
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int T, int H, int head_dim, const long long* strides, float scale,
    void* stream) {
  if (head_dim != kHeadDim || B <= 0 || T <= 0 || H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, T, H, strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkv_bf16<<<dim3(B * H, (T + kBlockK - 1) / kBlockK), 128, kBwdSmem, s>>>(a);
  } else if (dtype == 0) {
    flash_bwd_dkv_f32<<<dim3(B * H, (T + kF32BlockK - 1) / kF32BlockK), 128, 0, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's dQ kernel; arguments as flash_attention_bwd_dkv (the dk
// and dv strides unused here).
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int dtype, int B, int T,
    int H, int head_dim, const long long* strides, float scale, void* stream) {
  if (head_dim != kHeadDim || B <= 0 || T <= 0 || H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, T, H, strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    flash_bwd_dq_bf16<<<dim3(B * H, (T + kBlockQ - 1) / kBlockQ), 128, 0, s>>>(a);
  } else if (dtype == 0) {
    flash_bwd_dq_f32<<<dim3(B * H, (T + kF32BlockQ - 1) / kF32BlockQ), 128, 0, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
