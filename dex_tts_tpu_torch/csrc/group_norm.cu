// K5: the U-Net Block's epilogue in two kernels, Hopper.
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm and Mish to
// XLA, which fuses them on the TPU. In the port's plain version
// (ops/group_norm.py `group_norm_mish_reference`) the same epilogue is
// about 11 full-size elementwise passes and 9 small ones, ~56 bytes of
// device memory traffic per output element; K5 reads h twice and writes
// y once.
//
// Computes, for h (B, C, H, W), NCHW contiguous, cut into G groups of
// cpg = C/G channels, per slab (b, g) of n = cpg·H·W contiguous elements:
//   mean = Σx / n,  var = Σx² / n − mean²,  inv = rsqrt(var + eps)   (f32)
//   y = mish((x − mean)·inv·weight[c] + bias[c]) · mask[b, w] (+ shift[b, c])
// with mish(v) = v·tanh(softplus(v)), softplus at PyTorch's defaults
// (β = 1, threshold 20). f32 arithmetic from the storage dtype (bf16 or
// f32), weight, bias and shift read in f32, one rounding to the output.
// tanh(log1p(e^v)) = p / (p + 2) with p = e^v·(e^v + 2): one exp and one
// division per element; above the threshold mish(v) = v, as tanh(v)
// rounds to 1 there.
//
// Bound. One read of h and one write of y: 4 B per element in bf16. The
// U-Net's 13 Blocks move 503.3 M elements per denoiser call at the
// benchmark's batch 16 and 768-frame bucket, 2.0 GB, 0.60 ms at 3.35 TB/s.
// Two transcendental instructions per element (exp, reciprocal) on the
// special-function units, 16 per SM per clock, take about 0.24 ms of
// that: far below the ridge point, so bytes are the bound.
//
// Design. The statistics of a slab are needed before any of it can be
// written, and a slab of the largest Block (8 × 80 × 768 = 491,520
// elements, 983 KB in bf16) does not fit one block's shared memory. So
// two passes over a grid (chunks, B·G): `gn_stats` writes each chunk's
// f32 partial sums, `gn_apply` adds its slab's partials in a fixed order
// (every CTA of a slab gets the same sums) and applies the epilogue to
// its chunk, reading h again, two 16-byte loads in flight per thread:
// 6 B per element. The number of chunks per slab follows B·G
// (ops/group_norm.py `two_pass_chunks`). One pass, an 8-CTA cluster per
// slab holding it in shared memory with its sums added through
// distributed shared memory, ran no faster at the benchmark's shapes
// (H100, bf16: slower at the largest Block). `gn_apply`
// keeps the per-channel coefficients and the slab's mask row (as f32) in
// shared memory, and splits element indices into channel and frame with
// multiply-high division by the invariant H·W and W.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread in gn_stats
// dynamic shared memory a CTA of gn_apply may ask for without opting in
constexpr int kMaxDynamic = 49152;
constexpr float kSoftplusThreshold = 20.f;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// n / d for 0 ≤ n < 2^31 by a multiply-high (CUTLASS's FastDivmod).
struct FastDiv {
  unsigned d, mul, shift;
};

FastDiv fast_div(unsigned d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    unsigned log2 = 0;
    while ((1u << log2) < d) ++log2;  // ⌈log2 d⌉
    const unsigned p = 31 + log2;
    f.mul = static_cast<unsigned>(((1ull << p) + d - 1) / d);
    f.shift = p - 32;
  }
  return f;
}

__device__ __forceinline__ int div(const FastDiv& f, int n) {
  return f.d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), f.mul) >> f.shift);
}

struct Args {
  const void* x;
  const float* weight;
  const float* bias;
  const void* mask;    // (B, 1, 1, W) in x's dtype, element strides below
  long long mask_sb, mask_sw;
  const float* shift;  // (B, C) f32, or null
  long long shift_sb, shift_sc;
  void* y;
  // n = cpg·hw elements per slab. C is not read, but without it ptxas
  // spilled gn_apply at 64 registers (CUDA 12.8, sm_90a).
  int C, W, G, cpg, hw, n;
  float eps;
  FastDiv by_hw, by_w;
};

__device__ __forceinline__ float mish(float v) {
  if (v > kSoftplusThreshold) return v;
  const float e = __expf(v);
  const float p = e * (e + 2.f);
  return v * __fdividef(p, p + 2.f);
}

template <typename T, int V>
__device__ __forceinline__ void accumulate(const Pack<T, V>& p, float& s, float& ss) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float v = to_f(p.v[j]);
    s += v;
    ss = fmaf(v, v, ss);
  }
}

// The block's (Σ, Σ²) of every thread's (s, ss), valid in thread 0.
__device__ __forceinline__ float2 block_sum(float s, float ss, float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = make_float2(s, ss);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  if (warp == 0) {
    t = lane < kWarps ? red[lane] : t;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      t.x += __shfl_xor_sync(0xffffffffu, t.x, o);
      t.y += __shfl_xor_sync(0xffffffffu, t.y, o);
    }
  }
  return t;
}

// Σx, Σx² of packs [p0, p1) of src, kUnroll loads in flight per thread.
template <typename T, int V>
__device__ __forceinline__ float2 load_sum(const Pack<T, V>* __restrict__ src, int p0, int p1) {
  float s = 0.f, ss = 0.f;
  int p = p0 + threadIdx.x;
  for (; p + (kUnroll - 1) * kThreads < p1; p += kUnroll * kThreads) {
    Pack<T, V> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[p + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate(v[u], s, ss);
  }
  for (; p < p1; p += kThreads) accumulate(src[p], s, ss);
  return make_float2(s, ss);
}

// From the slab's (Σx, Σx²): its per-channel (inv·weight, mean, shift,
// bias) into coef and its mask row, as f32, into mrow. Ends on a block
// barrier.
template <typename T>
__device__ __forceinline__ void prepare(const Args& a, int b, int g, float2 sums,
                                        float4* coef, float* mrow) {
  const float mean = sums.x / static_cast<float>(a.n);
  const float var = sums.y / static_cast<float>(a.n) - mean * mean;
  const float inv = rsqrtf(var + a.eps);
  for (int cl = threadIdx.x; cl < a.cpg; cl += kThreads) {
    const int c = g * a.cpg + cl;
    const float shift = a.shift ? a.shift[b * a.shift_sb + c * a.shift_sc] : 0.f;
    coef[cl] = make_float4(inv * a.weight[c], mean, shift, a.bias[c]);
  }
  const T* m = static_cast<const T*>(a.mask) + b * a.mask_sb;
  for (int w = threadIdx.x; w < a.W; w += kThreads) mrow[w] = to_f(m[w * a.mask_sw]);
  __syncthreads();
}

// The pack v, the slab's pack p: y = mish((x − mean)·inv·weight + bias)·
// mask + shift, rounded to T (bf16 in pairs).
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> epilogue(const Args& a, const Pack<T, V>& v, int p,
                                               const float4* coef, const float* mrow) {
  const int i = p * V;  // a pack lies in one channel: V divides H·W
  const int cl = div(a.by_hw, i);
  const int hw = i - cl * a.hw;
  int w = hw - div(a.by_w, hw) * a.W;
  const float4 k = coef[cl];
  float m[V];
  bool whole = false;  // the pack's frames are w … w + V - 1, 16-byte aligned
  if constexpr (V % 4 == 0) {
    whole = a.W % V == 0;
    if (whole) {
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 m4 = *reinterpret_cast<const float4*>(mrow + w + j);
        m[j] = m4.x, m[j + 1] = m4.y, m[j + 2] = m4.z, m[j + 3] = m4.w;
      }
    }
  }
  if (!whole) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = mrow[w];
      if (++w == a.W) w = 0;
    }
  }
  float y[V];
#pragma unroll
  for (int j = 0; j < V; ++j) y[j] = fmaf(mish(fmaf(to_f(v.v[j]) - k.y, k.x, k.w)), m[j], k.z);
  Pack<T, V> r;
  if constexpr (std::is_same_v<T, __nv_bfloat16> && V % 2 == 0) {
    auto* r2 = reinterpret_cast<__nv_bfloat162*>(r.v);
#pragma unroll
    for (int j = 0; j < V / 2; ++j) r2[j] = __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) r.v[j] = from_f<T>(y[j]);
  }
  return r;
}

// The epilogue on the packs p0 … p0 + count - 1 of a slab; in[q] and
// out[q] hold pack p0 + q. 16-byte packs go two at a time, both loads
// issued before either result.
template <typename T, int V>
__device__ __forceinline__ void apply(const Args& a, const Pack<T, V>* __restrict__ in,
                                      Pack<T, V>* __restrict__ out, int p0, int count,
                                      const float4* coef, const float* mrow) {
  int q = threadIdx.x;
  if constexpr (V > 1) {
    for (; q + kThreads < count; q += 2 * kThreads) {
      const Pack<T, V> v0 = in[q], v1 = in[q + kThreads];
      out[q] = epilogue(a, v0, p0 + q, coef, mrow);
      out[q + kThreads] = epilogue(a, v1, p0 + q + kThreads, coef, mrow);
    }
  }
#pragma unroll 1
  for (; q < count; q += kThreads) out[q] = epilogue(a, in[q], p0 + q, coef, mrow);
}

// gn_apply's dynamic shared memory: coef (cpg float4) and mrow (W floats,
// padded to a multiple of 4).
__host__ __device__ __forceinline__ size_t head_bytes(int cpg, int W) {
  return static_cast<size_t>(cpg) * sizeof(float4) +
         static_cast<size_t>((W + 3) / 4 * 4) * sizeof(float);
}

// The first and last-plus-one pack of part `k` of `parts` of a slab of np.
__device__ __forceinline__ int2 part_range(int np, int k, int parts) {
  const long long per = (static_cast<long long>(np) + parts - 1) / parts;
  const long long p0 = min(static_cast<long long>(np), k * per);
  return make_int2(static_cast<int>(p0), static_cast<int>(min(static_cast<long long>(np), p0 + per)));
}

// Two passes, first: grid (chunks, B·G), each chunk's (Σx, Σx²).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2) gn_stats(const Args a, float2* __restrict__ partial) {
  __shared__ float2 red[kWarps];
  const int slab = blockIdx.y, np = a.n / V;
  const int2 r = part_range(np, blockIdx.x, gridDim.x);
  const auto* src = static_cast<const Pack<T, V>*>(a.x) + static_cast<long long>(slab) * np;
  const float2 mine = load_sum<T, V>(src, r.x, r.y);
  const float2 t = block_sum(mine.x, mine.y, red);
  if (threadIdx.x == 0) partial[static_cast<long long>(slab) * gridDim.x + blockIdx.x] = t;
}

// Two passes, second: the slab's partials added by one warp in a fixed
// order (every CTA of the slab gets the same sums), then the epilogue on
// the chunk, read from device memory again. Single-element packs may take
// more than 64 registers: they spilled at 64.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, V == 1 ? 1 : 2)
    gn_apply(const Args a, const float2* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 total;
  float4* coef = reinterpret_cast<float4*>(smem);
  float* mrow = reinterpret_cast<float*>(coef + a.cpg);
  const int slab = blockIdx.y, b = slab / a.G, g = slab - b * a.G, np = a.n / V;
  const int chunks = gridDim.x;
  if (threadIdx.x < 32) {
    float2 s = make_float2(0.f, 0.f);
    const float2* mine = partial + static_cast<long long>(slab) * chunks;
    for (int k = threadIdx.x; k < chunks; k += 32) {
      s.x += mine[k].x;
      s.y += mine[k].y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
    }
    if (threadIdx.x == 0) total = s;
  }
  __syncthreads();
  prepare<T>(a, b, g, total, coef, mrow);
  const int2 r = part_range(np, blockIdx.x, chunks);
  const auto* src = static_cast<const Pack<T, V>*>(a.x) + static_cast<long long>(slab) * np;
  auto* dst = static_cast<Pack<T, V>*>(a.y) + static_cast<long long>(slab) * np;
  apply<T, V>(a, src + r.x, dst + r.x, r.x, r.y - r.x, coef, mrow);
}

template <typename T, int V>
int launch(const Args& a, int B, int chunks, float2* partial, cudaStream_t s) {
  const size_t head = head_bytes(a.cpg, a.W);
  if (chunks < 1 || partial == nullptr || head > static_cast<size_t>(kMaxDynamic)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(chunks, B * a.G);
  gn_stats<T, V><<<grid, kThreads, 0, s>>>(a, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_apply<T, V><<<grid, kThreads, head, s>>>(a, partial);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = mish(GroupNorm(x)·weight + bias)·mask (+ shift), x and y (B, C, H, W)
// contiguous, dtype 0 f32 / 1 bf16, vec elements per 16-byte load (1, or
// 16 / element size where H·W is a multiple of it and x, y are 16-byte
// aligned), `chunks` chunks per slab with `partial` (2·B·G·chunks
// floats). Returns a CUDA error code, 0 on success.
extern "C" int group_norm_mish_fwd(const void* x, const float* weight, const float* bias,
                                   const void* mask, long long mask_sb, long long mask_sw,
                                   const float* shift, long long shift_sb, long long shift_sc,
                                   void* y, void* partial, int dtype, int vec, int B, int C,
                                   int H, int W, int G, float eps, int chunks,
                                   void* stream) {
  const auto invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || G <= 0 || C % G != 0 ||
      static_cast<long long>(B) * G > 65535) {
    return invalid;
  }
  const long long hw = static_cast<long long>(H) * W;
  const long long n = static_cast<long long>(C / G) * hw;
  if (n > 0x7fffffffLL - 16) return invalid;  // indices inside a slab are ints
  const int elem = dtype == 1 ? 2 : 4;
  if (vec != 1 && (vec * elem != 16 || hw % vec != 0 ||
                   reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                   reinterpret_cast<uintptr_t>(y) % 16 != 0)) {
    return invalid;
  }
  Args a{x, weight, bias, mask, mask_sb, mask_sw, shift, shift_sb, shift_sc, y,
         C, W, G, C / G, static_cast<int>(hw), static_cast<int>(n), eps,
         fast_div(static_cast<unsigned>(hw)), fast_div(static_cast<unsigned>(W))};
  auto* part = static_cast<float2*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return vec == 1 ? launch<__nv_bfloat16, 1>(a, B, chunks, part, s)
                    : launch<__nv_bfloat16, 8>(a, B, chunks, part, s);
  }
  if (dtype == 0) {
    return vec == 1 ? launch<float, 1>(a, B, chunks, part, s)
                    : launch<float, 4>(a, B, chunks, part, s);
  }
  return invalid;
}
