// Monotonic alignment search (MAS, kernel K4) for DeX-TTS training, Hopper.
//
// Replaces the TPU kernel dex_tts_tpu/ops/mas.py `_mas_kernel`, launched
// by `maximum_path_pallas`: the Viterbi DP of the reference's Cython
// kernel (DEX-TTS/model/monotonic_align/core.pyx), the path equal to
// `maximum_path_scan` on every cell. Per item b of value, mask (B, Tx, Ty):
//   t_x = Σ mask[b, :, 0], t_y = Σ mask[b, 0, :];
//   col_y[x] = value·mask + max(x == y ? -1e9 : col_{y-1}[x],
//                               x == 0 ? (y == 0 ? 0 : -1e9) : col_{y-1}[x-1])
//   inside the band x ≤ y, x ≥ t_x + y - t_y, x < t_x, y < t_y, else -1e9;
//   bit[y][x] = col_{y-1}[x-1] > col_{y-1}[x] ("diagonal beats stay");
//   backtrace from index = t_x - 1, frame t_y - 1 down to 0: emit index,
//   then step to index - 1 if index ≠ 0 and (index == y or bit[y][index]).
// The path is written in full, zeros included, times the mask.
//
// What bounds it: latency. At the train step's shape (B=32, Tx=96,
// Ty=256, f32) value and mask are read once and the path written once,
// 9.4 MB, 2.8 µs at 3.35 TB/s, and the DP is ~10 operations per cell. But
// frame y needs column y-1 and the backtrace's frame y needs the index of
// frame y+1: one item is a chain of 2·Ty dependent steps, run by one warp
// (B = 32 items fill 32 of the 132 SMs). A lone warp issues far below one
// instruction per cycle (about one per 2.2 cycles in this DP's loop on an
// NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6), and anything else that uses
// the SM's shared-memory pipe slows its shuffles, ballots and shared
// loads, so the design keeps each step's instructions few and that pipe
// quiet.
//
// Two routes, chosen by shape alone (`maximum_path_mas_plan`; the Python
// wrapper mirrors it and counts launches per route):
//
// Warp route, `mas_warp<K>`: Tx ≤ 512, when its ring, bits and idx fit the
// 227 KB a block may use (`kSmemBudget`); K = ⌈Tx/32⌉ rounded up to an
// instantiated value (`kWarpKs`). One block of 3 warps per item; warp 0
// alone runs the DP and then the backtrace, with no block barrier from the
// first frame of the forward to the last of the backtrace.
//   * Lane l owns the K tokens x = 32k + l (k < K); their column values
//     stay in registers. A cell's x - 1 is lane l - 1's cell k, or for lane
//     0 lane 31's cell k - 1: one rotating __shfl_sync per cell and frame.
//     The band test is two integer compares per cell against per-frame
//     bounds.
//   * Warp 1 copies value and mask into a ring of kStages tiles of F
//     frames × 32K rows in shared memory (cp.async; mbarriers "full" and
//     "empty" per stage, so the DP warp waits on a tile only if it is not
//     there yet). A row's F frames are contiguous in device memory: 16-byte
//     copies where Ty % 4 == 0 and the bases are aligned, 4-byte copies
//     otherwise. A tile is laid out [F/4][32K rows] of float4 (4 frames of
//     a row); each copy instruction writes neighbouring rows from
//     neighbouring lanes, so neither its writes nor the DP warp's 16-byte
//     reads meet a bank conflict (conflicting copies slowed the DP warp,
//     PERF.md §6). value·mask is taken on read, 4 frames at a time.
//   * The "diagonal beats stay" bits are K ballots per frame: ballot k is
//     word k of the frame's Tx-bit string, bit x % 32. Lane 0 stores them to
//     a (Ty, K) uint32 array in shared memory (3 KB at (96, 256), 32 KB at
//     (256, 1024)); nothing goes to device memory.
//   * The backtrace runs in blocks of 32 frames. Lane l takes frame y0 - l
//     and the window of tokens [i - 31, i] the index can reach in the block
//     (one funnel shift of two words of the bit string), the diagonal set
//     and tokens ≤ 0 cleared; then the warp walks the block from the 32
//     windows in registers, a shift, an and and a subtraction per frame.
//     idx[y] lands in shared memory.
//   * Warp 2 writes the path's zeros while the DP runs, paced so as not
//     to crowd it; after the one barrier, the t_y cells on the path are
//     written, times the mask.
//
// Wide route, `mas_wide`: every other shape (Tx > 512, or bits too large
// for shared memory). One 256-thread block per item; a thread owns tokens
// x, x + 256, …; the previous and current columns live in shared memory
// (double buffer), one barrier per frame; tiles of up to 32 frames of
// value·mask are staged in shared memory. The bits are one byte per cell,
// (Ty, Tx), kept in the path's own buffer (its first quarter), which the
// path write overwrites after the backtrace; thread 0 replays them from
// device memory.
//
// Both routes use __fmul_rn/__fadd_rn: no fused multiply-add, so the
// arithmetic rounds as the plain version's does (ties at log-prior values
// are decided by the last bit).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kSmemBudget = 227 * 1024;  // bytes of shared memory a block may use
// warp route
constexpr int kMaxWarpTx = 512;          // 32 lanes × K ≤ 16 tokens
constexpr int kWarps = 3;                // the DP warp, the copying warp, the zeroing warp
constexpr int kStages = 3;               // ring tiles; kStages - 1 in flight
constexpr int kMaxTileF = 32;            // frames per tile, a multiple of 4
// wide route
constexpr int kWideThreads = 256;
constexpr int kMaxTileY = 32;

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
// mbarriers in shared memory (the warp route's ring)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(smem_addr(bar))
               : "memory");
}
// arrives once this thread's cp.async copies so far have landed
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// The wide route's path from idx[y] (the token of frame y, -1 for none):
// path[x, y] = idx[y] == x ? mask[x, y] : 0. A warp writes whole rows, its
// lanes side by side along y; only on-path cells read the mask. vec:
// Ty % 4 == 0, path 16-byte aligned (idx is).
__device__ void write_path(float* __restrict__ pb, const float* __restrict__ mb,
                           const int* idx, int Tx, int Ty, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int x = warp; x < Tx; x += warps) {
    float* row = pb + static_cast<long long>(x) * Ty;
    const float* mrow = mb + static_cast<long long>(x) * Ty;
    if (vec) {
#pragma unroll 4
      for (int j = lane; j < Ty >> 2; j += 32) {
        const int4 id = reinterpret_cast<const int4*>(idx)[j];
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        if (id.x == x || id.y == x || id.z == x || id.w == x) {
          if (id.x == x) o.x = mrow[4 * j];
          if (id.y == x) o.y = mrow[4 * j + 1];
          if (id.z == x) o.z = mrow[4 * j + 2];
          if (id.w == x) o.w = mrow[4 * j + 3];
        }
        reinterpret_cast<float4*>(row)[j] = o;
      }
    } else {
#pragma unroll 4
      for (int y = lane; y < Ty; y += 32) row[y] = idx[y] == x ? mrow[y] : 0.f;
    }
  }
}

// t_x and t_y of one item, summed by the whole block behind one barrier;
// red: 2 floats per warp of shared memory.
__device__ void item_lengths(const float* __restrict__ mb, int Tx, int Ty, float* red,
                             int& tx, int& ty) {
  float sx = 0.f, sy = 0.f;
#pragma unroll 4
  for (int x = threadIdx.x; x < Tx; x += blockDim.x) sx += mb[static_cast<long long>(x) * Ty];
#pragma unroll 4
  for (int y = threadIdx.x; y < Ty; y += blockDim.x) sy += mb[y];
  for (int o = 16; o > 0; o >>= 1) {
    sx += __shfl_xor_sync(kAll, sx, o);
    sy += __shfl_xor_sync(kAll, sy, o);
  }
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[2 * warp] = sx;
    red[2 * warp + 1] = sy;
  }
  __syncthreads();
  sx = sy = 0.f;
  for (int i = 0; i < warps; ++i) {
    sx += red[2 * i];
    sy += red[2 * i + 1];
  }
  tx = static_cast<int>(sx);
  ty = static_cast<int>(sy);
}

// the K ballot words of one frame, from lane 0 (K % 4 == 0: 16-byte stores)
template <int K>
__device__ __forceinline__ void store_words(uint32_t* dst, const uint32_t (&w)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4)
      *reinterpret_cast<uint4*>(dst + k) = make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 2) *reinterpret_cast<uint2*>(dst + k) = make_uint2(w[k], w[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k] = w[k];
  }
}

// ---------------------------------------------------------------- warp route

template <int K>
__global__ void __launch_bounds__(32 * kWarps)
mas_warp(const float* __restrict__ value, const float* __restrict__ mask,
         float* __restrict__ path, int Tx, int Ty, int F, int vec_in, int vec_out) {
  constexpr int kRows = 32 * K;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ty4 = (Ty + 3) & ~3;
  const int tile = (F >> 2) * kRows;                         // float4 per array and stage
  float4* ring = reinterpret_cast<float4*>(smem);             // kStages × {value, mask}
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * kStages * tile);  // kStages
  uint64_t* empty = full + kStages;                                         // kStages
  uint32_t* bits = reinterpret_cast<uint32_t*>(empty + kStages);           // ty4 × K
  int* idx = reinterpret_cast<int*>(bits + ty4 * K);                        // ty4
  float* red = reinterpret_cast<float*>(idx + ty4);                         // 2 × kWarps
  volatile int* dp_busy = reinterpret_cast<int*>(red + 2 * kWarps);         // 1

  const long long item = static_cast<long long>(blockIdx.x) * Tx * Ty;
  const float* vb = value + item;
  const float* mb = mask + item;
  float* pb = path + item;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + s, 32);   // the copying warp's lanes, once their copies land
      bar_init(empty + s, 32);  // the DP warp's lanes, once they have read the stage
    }
    *dp_busy = 1;
  }
  int tx, ty;
  item_lengths(mb, Tx, Ty, red, tx, ty);  // its barrier also publishes the mbarriers
  const int fy = min(max(ty, 0), Ty);     // frames the DP runs
  const int rx = min(max(tx, 0), Tx);     // rows copied
  const int tiles = (fy + F - 1) / F;

  if (warp == 0) {
    // The DP warp. Lane l owns tokens x = 32k + l (k < K), so ballot k is
    // word k of the frame's bit string (bit x % 32), and x - 1 is lane
    // l - 1's cell k, or for lane 0 lane 31's cell k - 1: one rotating
    // shuffle per cell.
    const int e = tx - 1 - lane;  // x < t_x ⟺ 32k ≤ e
    const int d = ty - tx;        // x ≤ y ⟺ 32k ≤ c2 + d
    int c2 = tx - ty - lane;      // x ≥ t_x + y - t_y ⟺ 32k ≥ c2 (at frame y)
    float prev[K];
#pragma unroll
    for (int k = 0; k < K; ++k) prev[k] = kNeg;  // "frame -1"
    int y = 0;
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kStages;
      bar_wait(full + s, (t / kStages) & 1);
      const float4* vs = ring + s * 2 * tile;
      const float4* ms = vs + tile;
      const int ng = (min(F, fy - t * F) + 3) >> 2;
      for (int j = 0; j < ng; ++j) {
        // value·mask of 4 frames; rows ≥ t_x are not copied and hold
        // stale words, and their cells are outside the band
        float pr[4][K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float4 v = vs[j * kRows + 32 * k + lane];
          const float4 m = ms[j * kRows + 32 * k + lane];
          pr[0][k] = __fmul_rn(v.x, m.x);
          pr[1][k] = __fmul_rn(v.y, m.y);
          pr[2][k] = __fmul_rn(v.z, m.z);
          pr[3][k] = __fmul_rn(v.w, m.w);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c, ++y, ++c2) {
          float rot[K], sk[K];
#pragma unroll
          for (int k = 0; k < K; ++k) rot[k] = __shfl_sync(kAll, prev[k], (lane + 31) & 31);
#pragma unroll
          for (int k = 0; k < K; ++k) sk[k] = lane > 0 ? rot[k] : (k > 0 ? rot[k - 1] : kNeg);
          const float first = lane == 0 ? (y == 0 ? 0.f : kNeg) : sk[0];  // x == 0
          const int c1 = c2 + d;      // x == y at 32k == c1
          const int hi = min(c1, e);  // valid: c2 ≤ 32k ≤ hi
          uint32_t w[K];
          float cur[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float p = prev[k];
            w[k] = __ballot_sync(kAll, sk[k] > p);
            const float v_cur = 32 * k == c1 ? kNeg : p;
            const float v_prev = k == 0 ? first : sk[k];
            const float cand = __fadd_rn(pr[c][k], fmaxf(v_cur, v_prev));
            cur[k] = 32 * k >= c2 && 32 * k <= hi ? cand : kNeg;
          }
          if (lane == 0) store_words<K>(bits + y * K, w);
#pragma unroll
          for (int k = 0; k < K; ++k) prev[k] = cur[k];
        }
      }
      bar_arrive(empty + s);  // this lane has read the stage
    }
    __syncwarp();  // lane 0's words are in shared memory
    if (lane == 0) *dp_busy = 0;
    // Backtrace, in blocks of 32 frames from the top. Lane l takes frame
    // y0 - l and the 32 tokens the index may reach within the block,
    // [i - 31, i], as one window of the frame's bit string (a funnel shift
    // of two words), with the diagonal (token == frame) set and tokens
    // ≤ 0 cleared: bit c of the window says whether the index moves at
    // token i - 31 + c. Then every lane walks the block from the windows:
    // the chain from one frame to the next is a shift, an and and a
    // subtraction, with no memory on it.
    uint32_t* win = reinterpret_cast<uint32_t*>(ring);  // the ring is free now
    int i = tx - 1;
    for (int y0 = fy - 1; y0 >= 0; y0 -= 32) {
      const int yl = y0 - lane;
      uint32_t mv = 0;
      if (yl >= 0 && i > 0) {
        const uint32_t* row = bits + yl * K;
        const int base = i - 31;
        mv = base >= 0 ? __funnelshift_r(row[base >> 5], row[i >> 5], base & 31)
                       : row[0] << (31 - i);
        if (yl >= base && yl <= i) mv |= 1u << (yl - base);
        if (base <= 0) mv &= 1 - base >= 32 ? 0u : ~((1u << (1 - base)) - 1u);
      }
      win[lane] = mv;
      __syncwarp();
      uint32_t m[32];
#pragma unroll
      for (int s = 0; s < 32; s += 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(win + s);
        m[s] = v.x, m[s + 1] = v.y, m[s + 2] = v.z, m[s + 3] = v.w;
      }
      __syncwarp();  // read before the next block rewrites them
      const int n = min(32, y0 + 1);
      int at = 31;  // the index is i - 31 + at
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        if (s < n) {
          if (lane == 0) idx[y0 - s] = i - 31 + at;
          at -= (m[s] >> at) & 1u;
        }
      }
      i += at - 31;
    }
  } else if (warp == 1) {
    // The copying warp: tile t (frames [tF, tF + F) < fy, rows < rx) into
    // stage t % kStages once the DP warp has released it, laid out
    // [F/4][rows] of float4 (4 frames of a row). One 16-byte copy
    // instruction takes 2 neighbouring chunks (32 bytes) of 16 rows, and 8
    // lanes side by side write 8 neighbouring rows: no bank conflict in
    // shared memory. 4-byte copies: 4 frames of 8 rows.
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kStages;
      if (t >= kStages) bar_wait(empty + s, (t / kStages - 1) & 1);
      float* vs = reinterpret_cast<float*>(ring + s * 2 * tile);
      float* ms = vs + 4 * tile;
      const int y0 = t * F;
      const int nf = min(F, fy - y0);
      const int n = vec_in ? (nf + 3) >> 2 : nf;  // pieces per row: 16- or 4-byte
      const int rb = vec_in ? 16 : 8;              // rows per instruction
      for (int xb = 0; xb < rx; xb += rb) {
        const int x = xb + lane % rb;
        if (x >= rx) continue;
        for (int cb = lane / rb; cb < n; cb += 32 / rb) {
          const int f = vec_in ? 4 * cb : cb;  // first frame of the piece
          const int at = ((f >> 2) * kRows + x) * 4 + (f & 3);
          const long long gl = static_cast<long long>(x) * Ty + y0 + f;
          if (vec_in) {
            copy16(vs + at, vb + gl);
            copy16(ms + at, mb + gl);
          } else {
            copy4(vs + at, vb + gl);
            copy4(ms + at, mb + gl);
          }
        }
      }
      bar_arrive_copies(full + s);
    }
  } else {
    // The last warp writes the path's zeros while the DP runs, pausing
    // after each store until the DP is done: at full rate its stores
    // slowed the DP warp by ~10% (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).
    const long long n = static_cast<long long>(Tx) * Ty;
    if (vec_out) {
      float4* p4 = reinterpret_cast<float4*>(pb);
      for (long long k = lane; k < n >> 2; k += 32) {
        p4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (*dp_busy) __nanosleep(32);
      }
    } else {
      for (long long k = lane; k < n; k += 32) {
        pb[k] = 0.f;
        if (*dp_busy) __nanosleep(32);
      }
    }
  }

  __syncthreads();
  // the path's ones: frame y < t_y on token idx[y], times the mask
  for (int y = threadIdx.x; y < fy; y += blockDim.x) {
    const int x = idx[y];
    if (x >= 0) {
      const long long at = static_cast<long long>(x) * Ty + y;
      pb[at] = mb[at];
    }
  }
}

// ---------------------------------------------------------------- wide route

__global__ void __launch_bounds__(kWideThreads)
mas_wide(const float* __restrict__ value, const float* __restrict__ mask,
         float* __restrict__ path, int Tx, int Ty, int tile_y, int vec_out) {
  extern __shared__ __align__(16) float wsm[];
  int* idx = reinterpret_cast<int*>(wsm);                 // Ty (+pad)
  float* col = wsm + ((Ty + 3) & ~3);                     // 2 × Tx
  float* tile = col + 2 * Tx;                             // tile_y × (Tx + 1)
  __shared__ float red[2 * kWideThreads / 32];

  const long long item = static_cast<long long>(blockIdx.x) * Tx * Ty;
  const float* vb = value + item;
  const float* mb = mask + item;
  float* pb = path + item;
  uint8_t* bb = reinterpret_cast<uint8_t*>(pb);  // (Ty, Tx) bytes, overwritten by the path

  int tx, ty;
  item_lengths(mb, Tx, Ty, red, tx, ty);

  for (int x = threadIdx.x; x < Tx; x += kWideThreads) col[Tx + x] = kNeg;  // "frame -1"

  for (int y0 = 0; y0 < Ty; y0 += tile_y) {
    const int nt = min(tile_y, Ty - y0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < Tx * nt; i += kWideThreads) {
      const int x = i / nt;
      const int yy = i - x * nt;
      const long long g = static_cast<long long>(x) * Ty + y0 + yy;
      tile[yy * (Tx + 1) + x] = __fmul_rn(vb[g], mb[g]);
    }
    __syncthreads();
    for (int yy = 0; yy < nt; ++yy) {
      const int y = y0 + yy;
      const float* prv = col + ((y & 1) ^ 1) * Tx;
      float* cur = col + (y & 1) * Tx;
      for (int x = threadIdx.x; x < Tx; x += kWideThreads) {
        const float p = prv[x];
        const float s = x > 0 ? prv[x - 1] : kNeg;
        bb[static_cast<long long>(y) * Tx + x] = s > p ? 1 : 0;
        const float v_cur = x == y ? kNeg : p;
        const float v_prev = x == 0 ? (y == 0 ? 0.f : kNeg) : s;
        const float cand = __fadd_rn(tile[yy * (Tx + 1) + x], fmaxf(v_cur, v_prev));
        const bool valid = x <= y && x >= tx + y - ty && x < tx && y < ty;
        cur[x] = valid ? cand : kNeg;
      }
      __syncthreads();
    }
  }

  if (threadIdx.x == 0) {
    int index = tx - 1;
    for (int y = Ty - 1; y >= 0; --y) {
      const bool active = y < ty;
      idx[y] = active ? index : -1;
      const bool diag = index > 0 && index < Tx && bb[static_cast<long long>(y) * Tx + index];
      if (active && index != 0 && (index == y || diag)) --index;
    }
  }
  __syncthreads();
  write_path(pb, mb, idx, Tx, Ty, vec_out);
}

// ---------------------------------------------------------------- launch

constexpr int kWarpKs[] = {1, 2, 3, 4, 6, 8, 12, 16};

template <int K>
cudaError_t launch_warp(const float* v, const float* m, float* p, int B, int Tx, int Ty,
                        int F, int smem, int vec_in, int vec_out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mas_warp<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mas_warp<K><<<B, 32 * kWarps, smem, stream>>>(v, m, p, Tx, Ty, F, vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

// The plan for a (Tx, Ty) shape: plan[0] the route (0 warp, 1 wide, -1 no
// route fits), plan[1] K (warp) or 0, plan[2] F (warp: frames per ring
// tile) or tile_y (wide), plan[3] dynamic shared memory in bytes.
extern "C" void maximum_path_mas_plan(int Tx, int Ty, int* plan) {
  plan[0] = -1;
  plan[1] = plan[2] = plan[3] = 0;
  if (Tx <= 0 || Ty <= 0) return;
  if (Tx <= kMaxWarpTx) {
    int K = 0;
    for (int k : kWarpKs)
      if (K == 0 && 32 * k >= Tx) K = k;
    const long long ty4 = (Ty + 3) & ~3;
    // mbarriers, bits, idx, the sums, the DP's busy flag
    const long long fixed = 16LL * kStages + 4LL * (ty4 * K + ty4 + 2 * kWarps + 1);
    const long long per_frame = 4LL * 2 * kStages * 32 * K;
    long long F = (kSmemBudget - fixed) / per_frame;
    F = F < kMaxTileF ? F : kMaxTileF;
    F = (F < ty4 ? F : ty4) & ~3LL;
    if (F >= 4) {
      plan[0] = 0;
      plan[1] = K;
      plan[2] = static_cast<int>(F);
      plan[3] = static_cast<int>(fixed + per_frame * F);
      return;
    }
  }
  const long long fixed = 4LL * (2LL * Tx + ((Ty + 3) & ~3));
  const long long per_frame = 4LL * (Tx + 1);
  const long long budget = kSmemBudget - 4LL * 2 * kWideThreads / 32;  // minus `red`
  const long long fit = (budget - fixed) / per_frame;
  if (fit < 1) return;
  plan[0] = 1;
  plan[2] = static_cast<int>(fit < kMaxTileY ? fit : kMaxTileY);
  plan[3] = static_cast<int>(fixed + per_frame * plan[2]);
}

// value, mask, path: contiguous f32 (B, Tx, Ty). Returns the launch's
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// no route takes.
extern "C" int maximum_path_mas(const void* value, const void* mask, void* path, int B, int Tx,
                                int Ty, void* stream) {
  int plan[4];
  maximum_path_mas_plan(Tx, Ty, plan);
  if (B <= 0 || plan[0] < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* v = static_cast<const float*>(value);
  const auto* m = static_cast<const float*>(mask);
  auto* p = static_cast<float*>(path);
  auto s = static_cast<cudaStream_t>(stream);
  auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const int vec_in = Ty % 4 == 0 && aligned(value) && aligned(mask);
  const int vec_out = Ty % 4 == 0 && aligned(path);
  cudaError_t err;
  if (plan[0] == 1) {
    err = cudaFuncSetAttribute(mas_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, plan[3]);
    if (err != cudaSuccess) return static_cast<int>(err);
    mas_wide<<<B, kWideThreads, plan[3], s>>>(v, m, p, Tx, Ty, plan[2], vec_out);
    return static_cast<int>(cudaGetLastError());
  }
  const int F = plan[2], smem = plan[3];
  switch (plan[1]) {
    case 1: err = launch_warp<1>(v, m, p, B, Tx, Ty, F, smem, vec_in, vec_out, s); break;
    case 2: err = launch_warp<2>(v, m, p, B, Tx, Ty, F, smem, vec_in, vec_out, s); break;
    case 3: err = launch_warp<3>(v, m, p, B, Tx, Ty, F, smem, vec_in, vec_out, s); break;
    case 4: err = launch_warp<4>(v, m, p, B, Tx, Ty, F, smem, vec_in, vec_out, s); break;
    case 6: err = launch_warp<6>(v, m, p, B, Tx, Ty, F, smem, vec_in, vec_out, s); break;
    case 8: err = launch_warp<8>(v, m, p, B, Tx, Ty, F, smem, vec_in, vec_out, s); break;
    case 12: err = launch_warp<12>(v, m, p, B, Tx, Ty, F, smem, vec_in, vec_out, s); break;
    case 16: err = launch_warp<16>(v, m, p, B, Tx, Ty, F, smem, vec_in, vec_out, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
