// Flash-attention forward for the DiT's multi-head self-attention, Hopper.
//
// Replaces the TPU kernel reached from dex_tts_tpu/models/dit.py
// MHSA._flash (the library Pallas kernel
// jax.experimental.pallas.ops.tpu.flash_attention) and MHSA._splash, which
// compute the same function: exact non-causal
// softmax(q·kᵀ·scale)·v per (batch, head), softmax statistics in f32.
//
// Bound at the main-path shape (B=16, H=2, T=3840, hd=128, bf16 on an
// H100 SXM): 4·B·H·T²·hd = 2.42e11 FLOP → 0.244 ms at 989 TFLOP/s, against
// 4 × 31.5 MB of q, k, v, o → 0.038 ms at 3.35 TB/s. The kernel is bound by
// operations, so the work goes to the tensor cores and the T×T scores never
// leave registers.
//
// Design (first version: simple and correct; a wgmma + TMA redesign with a
// producer warp and a ring of K/V tiles is later work):
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
//     applied to the f32 scores (folded with log2 e for exp2).
// The f32 variant does the same with f32 FMA on the CUDA cores (no TF32):
// 4 threads per query, each holding 32 of the 128 dims.
//
// q, k, v are read in place through strides (the DiT passes views of its
// (B, T, 3, H, hd) projection); O is written contiguous (B, T, H, hd).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr float kLog2e = 1.4426950408889634f;

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

__global__ void __launch_bounds__(128)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int T, int H,
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

__global__ void __launch_bounds__(128)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int T,
              int H, long long q_sb, long long q_st, long long q_sh,
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// launch's cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int T, int H, int head_dim, long long q_sb, long long q_st,
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
    flash_fwd_bf16<<<grid, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), T, H, q_sb, q_st, q_sh, k_sb, k_st,
        k_sh, v_sb, v_st, v_sh, scale_log2);
  } else if (dtype == 0) {
    const dim3 grid(B * H, (T + kF32BlockQ - 1) / kF32BlockQ);
    flash_fwd_f32<<<grid, 128, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), T, H, q_sb,
        q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
