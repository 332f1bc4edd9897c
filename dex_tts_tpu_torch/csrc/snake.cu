// BigVGAN's anti-aliased snake activation, one pass, Hopper.
//
// Replaces the TPU kernels of dex_tts_tpu/ops/snake.py:
//   * `_snake_fold_kernel` (:309, via `snake_antialias_fold` :384), the
//     bf16 generator's route, with the polynomial sin² `_sin2_fast` (:297);
//   * `_snake_kernel` (:152, via `snake_antialias_pallas` :208), the f32
//     route, with the exact sine.
// Both compute, per channel c of x (B, T, C):
//   p0[s] = Σ_a f0[a]·x[clip(s+a-q)],  p1[s] = Σ_a f1[a]·x[clip(s+a-q+1)]
//   s0 = p0 + inv_beta[c]·sin²(alpha[c]·p0),  s1 likewise from p1
//   y[t] = Σ_a ge[a]·s̃1[t+a-q] + go[a]·s̃0[t+a-q+1]
// with q = k/4, a ∈ [0, k/2), and the reference's clipping on the
// interleaved upsampled signal: s̃0 = s̃1 = s0[0] left of 0 and s1[T-1]
// right of T-1. That is the 2× Kaiser-sinc upsample, the snake on both
// phases, and the 2k-tap low-pass plus 2× decimate, in polyphase form.
//
// Bound. One read of x and one write of y: at the main path's bf16 stage
// shapes (16, 3072, 768) … (16, 196608, 24) that is 151 MB at stage 0 and
// 302 MB at stages 1-5, 45 µs and 90 µs at 3.35 TB/s. Per output sample
// the kernel does 4k FLOP of filter FMAs (two upsample branches and the
// two-branch downsample) and two snake evaluations of about 23 FLOP each
// with the polynomial sine: about 94 f32 FLOP for k = 12, which at the
// 67 TFLOP/s f32 CUDA-core peak is as long as the bytes take, or a little
// longer. chip_smoke.py computes both bounds per shape and reports the
// larger. The exact sinf (f32) costs more operations than the polynomial.
//
// Design (first version: simple and correct):
//   * one block of 128 threads per (T-tile of 1024 outputs, channel,
//     batch): grid (⌈T/1024⌉, C, B). The generator hands each snake a
//     (B, T, C) transposed view of its (B, C, T) activations, so T is
//     the contiguous axis and a block's row of x is one contiguous run;
//   * the tile plus an 8-sample halo on each side (≥ k/2) is staged in
//     shared memory as f32, with 16-byte vector loads where the row is
//     16-byte aligned and T is contiguous; clipped scalar loads at the
//     global edges and for any other strides;
//   * each thread computes 8 consecutive positions of both snaked phases
//     from a register window of x, then 8 consecutive outputs from
//     register windows of s̃0 and s̃1; shared-memory rows carry one spare
//     word per 8 (index i + i/8), so the threads' stride-8 windows fall
//     in distinct banks;
//   * the edge rule is computed in the kernel (s0[0] and s1[T-1] from the
//     tile that holds them), so no pass fixes the edges afterwards, and
//     every output sample is written once, in the output dtype.
// Built without --use_fast_math: __sinf is wrong for large arguments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 8;                  // consecutive outputs per thread
constexpr int kTile = kThreads * kPer;   // outputs per block
constexpr int kMaxHalf = 8;              // taps per polyphase branch, k ≤ 16
constexpr int kHalo = 8;                 // x samples staged beyond the tile, each side
constexpr int kNx = kTile + 2 * kHalo;   // staged x samples
constexpr int kNs = kTile + kMaxHalf;    // snaked positions (≥ kTile + 2q)

__host__ __device__ constexpr int padded(int i) { return i + (i >> 3); }

struct Filters {
  float f0[kMaxHalf];
  float f1[kMaxHalf];
  float ge[kMaxHalf];
  float go[kMaxHalf];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of x → f32.
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 f = __bfloat1622float2(h);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// kPer outputs → 32 (f32) or 16 (bf16) bytes.
__device__ __forceinline__ void store_out(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// sin²(t) = 0.5 − 0.5·cos(2t), cos(2πv) as a degree-7 polynomial in v²
// after v = t/π − rint(t/π): the coefficients and the order of
// evaluation of `_sin2_fast` (dex_tts_tpu/ops/snake.py:275-306).
__device__ __forceinline__ float sin2_poly(float t) {
  float v = t * 0.3183098861837907f;
  v = v - rintf(v);
  const float z = v * v;
  float c = -1.4609479689305238f;
  c = c * z + 7.806608463960106f;
  c = c * z + -26.406761080377983f;
  c = c * z + 60.24246470872289f;
  c = c * z + -85.45668538180254f;
  c = c * z + 64.93939011340913f;
  c = c * z + -19.739208758208584f;
  c = c * z + 0.9999999999193508f;
  return 0.5f - 0.5f * c;
}

template <bool kFast>
__device__ __forceinline__ float snake(float p, float al, float ib) {
  if (kFast) return p + ib * sin2_poly(p * al);
  const float s = sinf(p * al);
  return p + ib * (s * s);
}

template <typename T, int K, bool kFast>
__global__ void __launch_bounds__(kThreads)
snake_fwd(const T* __restrict__ x, const T* __restrict__ alpha,
          const T* __restrict__ inv_beta, T* __restrict__ y, int n_t,
          long long x_sb, long long x_st, long long x_sc, long long y_sb,
          long long y_st, long long y_sc, int vec, Filters f) {
  constexpr int kQ = K / 4;
  constexpr int kHalf = K / 2;  // taps per branch, = 2q
  constexpr int kVec = 16 / sizeof(T);
  static_assert(kHalf <= kMaxHalf && kHalf <= kHalo, "k must be ≤ 16");
  static_assert(kNx % kVec == 0, "the staged row is whole vectors");

  __shared__ float xs[padded(kNx)];
  __shared__ float s0s[padded(kNs)];
  __shared__ float s1s[padded(kNs)];

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTile;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const T* xr = x + b * x_sb + c * x_sc;
  T* yr = y + b * y_sb + c * y_sc;
  const int g0 = t0 - kHalo;  // x index of xs[0]

  // 1. xs[i] = x[clip(g0 + i)] as f32
  if (vec) {
    for (int ch = tid; ch < kNx / kVec; ch += kThreads) {
      const int g = g0 + ch * kVec;
      float v[kVec];
      if (g >= 0 && g + kVec <= n_t) {
        load_vec(xr + g, v);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          v[e] = to_f32(xr[min(max(g + e, 0), n_t - 1)]);
        }
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) xs[padded(ch * kVec + e)] = v[e];
    }
  } else {
    for (int i = tid; i < kNx; i += kThreads) {
      const long long g = min(max(g0 + i, 0), n_t - 1);
      xs[padded(i)] = to_f32(xr[g * x_st]);
    }
  }
  const float al = to_f32(alpha[c]);
  const float ib = to_f32(inv_beta[c]);
  __syncthreads();

  // 2. snaked phases at s = t0 - q + j, j ∈ [0, kTile + 2q). x[s-q+a]
  // sits at xs[j + kHalo - kHalf + a]. Outside [0, T) the reference's
  // interleaved clip gives s0[0] on the left and s1[T-1] on the right.
  float s_lo = 0.f, s_hi = 0.f;
  if (t0 == 0) {  // p0 at s = 0
    float p = 0.f;
#pragma unroll
    for (int a = 0; a < kHalf; ++a) {
      p = fmaf(f.f0[a], xs[padded(kHalo - kQ + a)], p);
    }
    s_lo = snake<kFast>(p, al, ib);
  }
  if (t0 + kTile + kQ > n_t) {  // p1 at s = T-1
    float p = 0.f;
#pragma unroll
    for (int a = 0; a < kHalf; ++a) {
      p = fmaf(f.f1[a], xs[padded(n_t - kQ + a - g0)], p);
    }
    s_hi = snake<kFast>(p, al, ib);
  }
  {
    const int j0 = kPer * tid;
    float xw[kPer + kHalf];
#pragma unroll
    for (int m = 0; m < kPer + kHalf; ++m) {
      xw[m] = xs[padded(j0 + kHalo - kHalf + m)];
    }
#pragma unroll
    for (int o = 0; o < kPer; ++o) {
      const int s = t0 - kQ + j0 + o;
      float v0 = s < 0 ? s_lo : s_hi;
      float v1 = v0;
      if (s >= 0 && s < n_t) {
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int a = 0; a < kHalf; ++a) {
          p0 = fmaf(f.f0[a], xw[o + a], p0);
          p1 = fmaf(f.f1[a], xw[o + a + 1], p1);
        }
        v0 = snake<kFast>(p0, al, ib);
        v1 = snake<kFast>(p1, al, ib);
      }
      s0s[padded(j0 + o)] = v0;
      s1s[padded(j0 + o)] = v1;
    }
  }
  if (tid < kHalf) {  // the last 2q positions
    const int j = kTile + tid;
    const int s = t0 - kQ + j;
    float v0 = s < 0 ? s_lo : s_hi;
    float v1 = v0;
    if (s >= 0 && s < n_t) {
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int a = 0; a < kHalf; ++a) {
        p0 = fmaf(f.f0[a], xs[padded(j + kHalo - kHalf + a)], p0);
        p1 = fmaf(f.f1[a], xs[padded(j + kHalo - kHalf + a + 1)], p1);
      }
      v0 = snake<kFast>(p0, al, ib);
      v1 = snake<kFast>(p1, al, ib);
    }
    s0s[padded(j)] = v0;
    s1s[padded(j)] = v1;
  }
  __syncthreads();

  // 3. y[t] for t = t0 + j0 + o: s̃1[t-q+a] and s̃0[t-q+1+a] sit at
  // j = j0 + o + a and j0 + o + a + 1.
  const int j0 = kPer * tid;
  float w0[kPer + kHalf], w1[kPer + kHalf];
#pragma unroll
  for (int m = 0; m < kPer + kHalf; ++m) {
    w0[m] = s0s[padded(j0 + m)];
    w1[m] = s1s[padded(j0 + m)];
  }
  float out[kPer];
#pragma unroll
  for (int o = 0; o < kPer; ++o) {
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < kHalf; ++a) {
      acc = fmaf(f.ge[a], w1[o + a], acc);
      acc = fmaf(f.go[a], w0[o + a + 1], acc);
    }
    out[o] = acc;
  }
  const int t = t0 + j0;
  if (vec && t + kPer <= n_t) {
    store_out(yr + t, out);
  } else {
#pragma unroll
    for (int o = 0; o < kPer; ++o) {
      if (t + o < n_t) yr[static_cast<long long>(t + o) * y_st] = from_f32<T>(out[o]);
    }
  }
}

template <typename T, int K, bool kFast>
int launch(const void* x, const void* alpha, const void* inv_beta, void* y,
           int B, int n_t, int C, const long long* xs, const long long* ys,
           int vec, const Filters& f, cudaStream_t s) {
  const dim3 grid((n_t + kTile - 1) / kTile, C, B);
  snake_fwd<T, K, kFast><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(alpha),
      static_cast<const T*>(inv_beta), static_cast<T*>(y), n_t, xs[0], xs[1],
      xs[2], ys[0], ys[1], ys[2], vec, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kFast>
int launch_k(int k, const void* x, const void* alpha, const void* inv_beta,
             void* y, int B, int n_t, int C, const long long* xs,
             const long long* ys, int vec, const Filters& f, cudaStream_t s) {
  switch (k) {
    case 8:
      return launch<T, 8, kFast>(x, alpha, inv_beta, y, B, n_t, C, xs, ys, vec, f, s);
    case 12:
      return launch<T, 12, kFast>(x, alpha, inv_beta, y, B, n_t, C, xs, ys, vec, f, s);
    case 16:
      return launch<T, 16, kFast>(x, alpha, inv_beta, y, B, n_t, C, xs, ys, vec, f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p, long long sb, long long sc, size_t elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (sb * static_cast<long long>(elem)) % 16 == 0 &&
         (sc * static_cast<long long>(elem)) % 16 == 0;
}

}  // namespace

// x, y: (B, T, C) with strides in elements; alpha, inv_beta: (C,) in x's
// dtype. dtype: 0 = float32, 1 = bfloat16. k ∈ {8, 12, 16}. filters: 32
// floats, f0, f1, ge, go, each zero-padded to 8 taps. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int snake_antialias_fwd(
    const void* x, const void* alpha, const void* inv_beta, void* y,
    int dtype, int k, int fast_sin, int B, int T, int C, long long x_sb,
    long long x_st, long long x_sc, long long y_sb, long long y_st,
    long long y_sc, const float* filters, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || B > 65535 || C > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Filters f;
  for (int i = 0; i < kMaxHalf; ++i) {
    f.f0[i] = filters[i];
    f.f1[i] = filters[kMaxHalf + i];
    f.ge[i] = filters[2 * kMaxHalf + i];
    f.go[i] = filters[3 * kMaxHalf + i];
  }
  const long long xs[3] = {x_sb, x_st, x_sc};
  const long long ys[3] = {y_sb, y_st, y_sc};
  const size_t elem = dtype == 1 ? 2 : 4;
  const int vec = x_st == 1 && y_st == 1 && aligned16(x, x_sb, x_sc, elem) &&
                  aligned16(y, y_sb, y_sc, elem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return fast_sin
               ? launch_k<__nv_bfloat16, true>(k, x, alpha, inv_beta, y, B, T, C, xs, ys, vec, f, s)
               : launch_k<__nv_bfloat16, false>(k, x, alpha, inv_beta, y, B, T, C, xs, ys, vec, f, s);
  }
  if (dtype == 0) {
    return fast_sin
               ? launch_k<float, true>(k, x, alpha, inv_beta, y, B, T, C, xs, ys, vec, f, s)
               : launch_k<float, false>(k, x, alpha, inv_beta, y, B, T, C, xs, ys, vec, f, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
