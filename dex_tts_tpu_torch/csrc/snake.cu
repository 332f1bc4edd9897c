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
// 67 TFLOP/s f32 CUDA-core peak takes a little longer than the bytes.
// chip_smoke.py computes both bounds per shape and reports the larger.
// So the kernel is bound by issued instructions on the CUDA cores: the
// design spends as few as it can on anything but the f32 arithmetic.
//
// Design: a warp walks a segment of one (b, c) row, with no block barrier.
//   * A row of T outputs is cut into chunks of 32 runs of kRun = 8
//     consecutive outputs, one run per lane (256 outputs per chunk). A
//     row's chunks are split evenly into segments of at most kSegChunks
//     chunks; one warp walks one segment, chunk after chunk. The
//     generator hands each snake a (B, T, C) transposed view of its
//     (B, C, T) activations, so a row is contiguous.
//   * The lane whose outputs are [t, t+8) computes both snaked phases at
//     [t+q, t+8+q), shifted right by q: their x is [t, t+8+2q), its own 8
//     samples and the next lane's first 2q. The downsample of [t, t+8) reads
//     s̃1 on [t-q, t+8+q-1) and s̃0 on [t-q+1, t+8+q): its own values and
//     the last 2q and 2q-1 of the lane before, by `__shfl_sync`. Lane 0
//     takes those of lane 31 of the chunk before, carried in registers
//     from the step before. So nothing to the right of a chunk is needed,
//     no state but that carry crosses a step, and only a segment's first
//     chunk computes 2q snaked positions of its left neighbour again.
//   * x reaches the lanes through a ring of kStages = 4 chunk slots per
//     warp in shared memory, filled by `cp.async` (16-byte copies that
//     hold no registers while in flight): step j starts the copy of chunk
//     j+2, waits for chunk j's, and reads the run and the next 2q samples
//     with 16-byte shared loads. Two chunks' loads are in flight while the
//     warp computes, one `__syncwarp` per step orders the lanes (the slot
//     a step refills was read two steps before), and x goes through
//     shared memory once, the snaked signal never.
//   * The chunks whose copies lie inside the row, on a row that is 16-byte
//     aligned with unit stride, come first in a row and run in a loop with
//     no edge logic at all. The others (a row's last one or two, or every
//     chunk for other strides or alignment) run after them in a loop of
//     their own: clipped, strided loads, and the edge value s1[T-1] at
//     positions ≥ T. Left of 0 only the first segment's carry reaches,
//     and it applies the edge rule.
// The sin² polynomial keeps `_sin2_fast`'s coefficients and order of
// evaluation, `rintf` included. Built without --use_fast_math: __sinf is
// wrong for large arguments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // warps per block, each on its own segment
constexpr int kRun = 8;                   // consecutive outputs per lane
constexpr int kChunk = 32 * kRun;         // outputs per warp per step
constexpr int kSegChunks = 16;            // chunks per segment, at most
constexpr int kMaxHalf = 8;               // taps per polyphase branch, k ≤ 16
constexpr int kMargin = 8;                // x samples read after a run (≥ 2q)
constexpr int kStages = 4;                // chunk slots of x per warp in shared memory
constexpr int kAhead = kStages - 2;       // chunks whose copies are in flight
constexpr int kSlot = kChunk + kMargin;   // a chunk's x in shared memory
constexpr unsigned kAll = 0xffffffffu;

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

// A run's x as loaded: its kRun samples and the kMargin after them.
template <typename T>
struct Raw;
template <>
struct Raw<__nv_bfloat16> {
  uint4 own, next;
};
template <>
struct Raw<float> {
  float4 own0, own1, next0, next1;
};

// 16 bytes, global → shared, asynchronously (cp.async; L2 only).
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's copies, but for the newest N groups, have landed
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// p points at the run's first sample in shared memory; 16-byte aligned.
__device__ __forceinline__ void load_raw(const __nv_bfloat16* p, Raw<__nv_bfloat16>& r) {
  r.own = *reinterpret_cast<const uint4*>(p);
  r.next = *reinterpret_cast<const uint4*>(p + kRun);
}
__device__ __forceinline__ void load_raw(const float* p, Raw<float>& r) {
  r.own0 = *reinterpret_cast<const float4*>(p);
  r.own1 = *reinterpret_cast<const float4*>(p + 4);
  r.next0 = *reinterpret_cast<const float4*>(p + kRun);
  r.next1 = *reinterpret_cast<const float4*>(p + kRun + 4);
}

// two bf16 in one word → f32: the lower address is the low half
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// xw[m] = x[t + m], m ∈ [0, N), for the run starting at t (N ≤ 2·kRun).
template <int N>
__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16>& r, float* xw) {
  const uint32_t w[8] = {r.own.x, r.own.y, r.own.z, r.own.w,
                         r.next.x, r.next.y, r.next.z, r.next.w};
#pragma unroll
  for (int m = 0; m < N; ++m) xw[m] = m % 2 ? bf_hi(w[m / 2]) : bf_lo(w[m / 2]);
}
template <int N>
__device__ __forceinline__ void unpack(const Raw<float>& r, float* xw) {
  const float v[16] = {r.own0.x, r.own0.y, r.own0.z, r.own0.w, r.own1.x, r.own1.y,
                       r.own1.z, r.own1.w, r.next0.x, r.next0.y, r.next0.z, r.next0.w,
                       r.next1.x, r.next1.y, r.next1.z, r.next1.w};
#pragma unroll
  for (int m = 0; m < N; ++m) xw[m] = v[m];
}

// kRun outputs → 32 (f32) or 16 (bf16) bytes.
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

// The last 2q snaked values of phase 1 and 2q-1 of phase 0 of a run: what
// the next lane's downsample reads left of its own values.
template <int Q>
struct Tail {
  float s1[2 * Q], s0[2 * Q - 1];
};

template <typename T, int K, bool kFast>
struct Walker {
  static constexpr int kQ = K / 4;
  static constexpr int kHalf = K / 2;   // taps per branch, = 2q
  static constexpr int kNx = kRun + kHalf;  // x samples a run's snake reads
  static_assert(kHalf <= kMaxHalf && kHalf <= kRun && kHalf <= kMargin, "k must be ≤ 16");

  const T* xr;  // the row of x and of y
  T* yr;
  T* ring;      // this warp's kStages slots of x in shared memory
  int n_t;
  long long x_st, y_st;
  bool vec;  // unit stride, row and y 16-byte aligned
  float al, ib;
  int lane;
  Filters f;

  __device__ __forceinline__ float x_at(int i) const {
    return to_f32(xr[static_cast<long long>(min(max(i, 0), n_t - 1)) * x_st]);
  }

  // both phases at u + o from a window xw[m] = x[clip(u - q + m)]
  __device__ __forceinline__ void phases(const float* xw, int o, float& v0, float& v1) const {
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int a = 0; a < kHalf; ++a) {
      p0 = fmaf(f.f0[a], xw[o + a], p0);
      p1 = fmaf(f.f1[a], xw[o + a + 1], p1);
    }
    v0 = snake<kFast>(p0, al, ib);
    v1 = snake<kFast>(p1, al, ib);
  }

  // (s̃0[u], s̃1[u]) at any u, with the reference's edge rule.
  __device__ __forceinline__ void pair_at(int u, float& v0, float& v1) const {
    float xw[kHalf + 1];
#pragma unroll
    for (int m = 0; m <= kHalf; ++m) xw[m] = x_at(min(max(u, 0), n_t - 1) - kQ + m);
    phases(xw, 0, v0, v1);
    if (u < 0) v1 = v0;
    if (u > n_t - 1) v0 = v1;
  }

  // chunks [0, n_inner()) take the branch-free path: their copies, the
  // kMargin after them included, lie inside the row
  __device__ __forceinline__ int n_inner() const {
    return vec && n_t >= kChunk + kMargin ? (n_t - kMargin) / kChunk : 0;
  }

  __device__ __forceinline__ T* slot(int j) const {
    return ring + (static_cast<unsigned>(j) % kStages) * kSlot + lane * kRun;
  }

  // start the copy of chunk j's x for this lane's run (lane 31 also the
  // kMargin after the chunk) into its slot; one commit group per chunk,
  // empty past the branch-free chunks
  __device__ __forceinline__ void issue(int j, int jf) const {
    if (j < jf) {
      constexpr int kPer = 16 / sizeof(T);  // samples per copy
      const T* g = xr + j * kChunk + lane * kRun;
      T* d = slot(j);
#pragma unroll
      for (int e = 0; e < kRun; e += kPer) copy16(d + e, g + e);
      if (lane == 31) {
#pragma unroll
        for (int e = 0; e < kMargin; e += kPer) copy16(d + kRun + e, g + kRun + e);
      }
    }
    copy_commit();
  }

  // the downsample of chunk j from the snaked values at [t+q, t+8+q) of
  // each lane's run [t, t+8), and its store. carry: lane 31's last values
  // of chunk j-1 (lane 0 reads them) in, those of chunk j out.
  __device__ __forceinline__ void downsample(int j, bool inner, const float* s0, const float* s1,
                                             Tail<kQ>& carry) const {
    // the last values of the lane before (lane 0: lane 31's, the next carry)
    const int up = (lane + 31) & 31;
    Tail<kQ> tr;
#pragma unroll
    for (int m = 0; m < 2 * kQ; ++m) tr.s1[m] = __shfl_sync(kAll, s1[kRun - 2 * kQ + m], up);
#pragma unroll
    for (int m = 0; m < 2 * kQ - 1; ++m) {
      tr.s0[m] = __shfl_sync(kAll, s0[kRun - 2 * kQ + 1 + m], up);
    }
    // w1[m] = s̃1[t-q+m], w0[m] = s̃0[t-q+1+m]
    float w1[kRun + 2 * kQ - 1], w0[kRun + 2 * kQ - 1];
#pragma unroll
    for (int m = 0; m < 2 * kQ; ++m) w1[m] = lane == 0 ? carry.s1[m] : tr.s1[m];
#pragma unroll
    for (int m = 0; m < 2 * kQ - 1; ++m) w0[m] = lane == 0 ? carry.s0[m] : tr.s0[m];
    carry = tr;
#pragma unroll
    for (int o = 0; o < kRun; ++o) {
      w0[2 * kQ - 1 + o] = s0[o];
      if (o < kRun - 1) w1[2 * kQ + o] = s1[o];
    }
    float y[kRun];
#pragma unroll
    for (int o = 0; o < kRun; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < kHalf; ++a) {
        acc = fmaf(f.ge[a], w1[o + a], acc);
        acc = fmaf(f.go[a], w0[o + a], acc);
      }
      y[o] = acc;
    }
    const int t = j * kChunk + lane * kRun;
    if (inner) {
      store_out(yr + t, y);
    } else {
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        if (t + o < n_t) yr[static_cast<long long>(t + o) * y_st] = from_f32<T>(y[o]);
      }
    }
  }

  // a branch-free chunk j: start chunk j+kAhead's copy, wait for chunk j's,
  // snake and downsample it
  __device__ __forceinline__ void step_inner(int j, int jf, Tail<kQ>& carry) const {
    issue(j + kAhead, jf);
    copy_wait<kAhead>();  // chunk j's copies have landed, this lane's
    __syncwarp();         // and every lane's; the slot refilled next step was
                          // read two steps ago, before this barrier
    Raw<T> raw;
    load_raw(slot(j), raw);
    float xw[kNx], s0[kRun], s1[kRun];
    unpack<kNx>(raw, xw);
#pragma unroll
    for (int o = 0; o < kRun; ++o) phases(xw, o, s0[o], s1[o]);
    downsample(j, true, s0, s1, carry);
  }

  // any other chunk j (a row's end, other strides): clipped loads, and the
  // edge value s1[T-1] at positions ≥ T (a warp-uniform condition)
  __device__ __forceinline__ void step_clipped(int j, Tail<kQ>& carry) const {
    const int t = j * kChunk + lane * kRun;
    float s_hi = 0.f;
    if ((j + 1) * kChunk + kQ > n_t) {
      float unused;
      pair_at(n_t - 1, unused, s_hi);
    }
    float xw[kNx], s0[kRun], s1[kRun];
#pragma unroll
    for (int m = 0; m < kNx; ++m) xw[m] = x_at(t + m);
#pragma unroll
    for (int o = 0; o < kRun; ++o) {
      phases(xw, o, s0[o], s1[o]);
      if (t + kQ + o >= n_t) s0[o] = s1[o] = s_hi;
    }
    downsample(j, false, s0, s1, carry);
  }

  // chunks [j0, j1) of the row: the branch-free ones, then the rest
  __device__ __forceinline__ void walk(int j0, int j1) const {
    const int jf = min(j1, n_inner());
#pragma unroll
    for (int i = 0; i < kAhead; ++i) issue(j0 + i, jf);
    // the carry into chunk j0: s̃ at [t0-q, t0+q), as lane 31 of chunk
    // j0-1 would leave it
    Tail<kQ> carry;
    {
      float v0, v1;
      pair_at(j0 * kChunk - kQ + lane, v0, v1);
#pragma unroll
      for (int m = 0; m < 2 * kQ; ++m) carry.s1[m] = __shfl_sync(kAll, v1, m);
#pragma unroll
      for (int m = 0; m < 2 * kQ - 1; ++m) carry.s0[m] = __shfl_sync(kAll, v0, m + 1);
    }
    int j = j0;
    for (; j < jf; ++j) step_inner(j, jf, carry);
    for (; j < j1; ++j) step_clipped(j, carry);
  }
};

template <typename T, int K, bool kFast>
__global__ void __launch_bounds__(32 * kWarps)
snake_fwd(const T* __restrict__ x, const T* __restrict__ alpha,
          const T* __restrict__ inv_beta, T* __restrict__ y, int n_t, int n_c,
          int n_chunks, int n_segs, long long n_warps, long long x_sb,
          long long x_st, long long x_sc, long long y_sb, long long y_st,
          long long y_sc, int vec, Filters f) {
  __shared__ __align__(16) unsigned char ring[kWarps * kStages * kSlot * sizeof(T)];
  const int warp = threadIdx.x >> 5;
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (w >= n_warps) return;  // the whole warp
  const long long row = w / n_segs;
  const int seg = static_cast<int>(w - row * n_segs);
  const long long b = row / n_c;
  const int c = static_cast<int>(row - b * n_c);
  const int j0 = static_cast<int>(static_cast<long long>(seg) * n_chunks / n_segs);
  const int j1 = static_cast<int>(static_cast<long long>(seg + 1) * n_chunks / n_segs);
  const Walker<T, K, kFast> walker{
      x + b * x_sb + c * x_sc, y + b * y_sb + c * y_sc,
      reinterpret_cast<T*>(ring) + warp * kStages * kSlot, n_t, x_st, y_st,
      vec != 0, to_f32(alpha[c]), to_f32(inv_beta[c]), static_cast<int>(threadIdx.x & 31), f};
  walker.walk(j0, j1);
}

template <typename T, int K, bool kFast>
int launch(const void* x, const void* alpha, const void* inv_beta, void* y,
           int B, int n_t, int C, const long long* xs, const long long* ys,
           int vec, const Filters& f, cudaStream_t s) {
  const int n_chunks = (n_t + kChunk - 1) / kChunk;
  const int n_segs = (n_chunks + kSegChunks - 1) / kSegChunks;
  const long long n_warps = static_cast<long long>(B) * C * n_segs;
  const long long blocks = (n_warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  snake_fwd<T, K, kFast><<<static_cast<unsigned>(blocks), 32 * kWarps, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(alpha),
      static_cast<const T*>(inv_beta), static_cast<T*>(y), n_t, C, n_chunks, n_segs,
      n_warps, xs[0], xs[1], xs[2], ys[0], ys[1], ys[2], vec, f);
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
  if (B <= 0 || T <= 0 || C <= 0 || T > 0x7fffffff - kChunk - kMargin) {
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
