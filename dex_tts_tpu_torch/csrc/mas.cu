// Monotonic alignment search (MAS) for DeX-TTS training, Hopper.
//
// Replaces the TPU kernel dex_tts_tpu/ops/mas.py `_mas_kernel`, launched
// by `maximum_path_pallas`: the Viterbi DP of the reference's Cython
// kernel (DEX-TTS/model/monotonic_align/core.pyx), the path equal to
// `maximum_path_scan` on every cell.
//
// What bounds it on this card: neither bytes nor operations. At the
// train step's shape (B=32, Tx=96, Ty=256, f32) value and mask are read
// once and the path written once, 9.4 MB → 2.8 µs at 3.35 TB/s, and the DP
// is ~10 operations per cell. The DP is serial over frames: each frame's
// column needs the previous one, so one item takes Ty dependent steps, and
// the backtrace another Ty. The time is Ty × (a barrier plus a few
// shared-memory round trips), about 1 µs per frame, plus the backtrace's
// Ty dependent loads.
//
// Design (simple and correct first):
//   * one CTA per item, 256 threads; a thread owns tokens x, x + 256, …, so
//     any Tx works; the previous and current value columns live in shared
//     memory (double buffer), one barrier per frame;
//   * value[b, :, y] is strided by Ty, so tiles of up to 32 frames × Tx are
//     staged in shared memory with loads contiguous along y (value·mask,
//     rows padded by one word);
//   * the forward pass writes one "diagonal beats stay" byte per cell
//     (shifted > prev, mas.py:270) into a (B, Ty, Tx) scratch buffer that
//     the wrapper allocates; one thread replays them backwards from
//     t_x - 1 (ties as mas.py:235), recording the token of each frame in
//     shared memory; then all threads write the whole path, zeros
//     included, times the mask, contiguous along y;
//   * t_x and t_y are the mask sums (mask[b, :, 0] and mask[b, 0, :]);
//     frames ≥ t_y emit nothing;
//   * value·mask and the DP's additions use __fmul_rn/__fadd_rn: no fused
//     multiply-add, so the arithmetic rounds as the plain version's does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kThreads = 256;
constexpr int kMaxTileY = 32;
constexpr int kSmemBudget = 200 * 1024;

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kThreads)
mas_kernel(const float* __restrict__ value, const float* __restrict__ mask,
           float* __restrict__ path, uint8_t* __restrict__ bits, int Tx,
           int Ty, int tile_y) {
  extern __shared__ float smem[];
  float* col = smem;                                  // 2 × Tx
  float* tile = col + 2 * Tx;                         // tile_y × (Tx + 1)
  int* idx = reinterpret_cast<int*>(tile + tile_y * (Tx + 1));  // Ty
  __shared__ float red[kThreads / 32];

  const long long item = static_cast<long long>(blockIdx.x) * Tx * Ty;
  const float* vb = value + item;
  const float* mb = mask + item;
  float* pb = path + item;
  uint8_t* bb = bits + item;

  float sx = 0.f, sy = 0.f;
  for (int x = threadIdx.x; x < Tx; x += kThreads) sx += mb[static_cast<long long>(x) * Ty];
  for (int y = threadIdx.x; y < Ty; y += kThreads) sy += mb[y];
  const int tx = static_cast<int>(block_sum(sx, red));
  const int ty = static_cast<int>(block_sum(sy, red));

  for (int x = threadIdx.x; x < Tx; x += kThreads) col[Tx + x] = kNeg;  // "frame -1"

  for (int y0 = 0; y0 < Ty; y0 += tile_y) {
    const int nt = min(tile_y, Ty - y0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < Tx * nt; i += kThreads) {
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
      for (int x = threadIdx.x; x < Tx; x += kThreads) {
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
  for (long long i = threadIdx.x; i < static_cast<long long>(Tx) * Ty; i += kThreads) {
    const int x = static_cast<int>(i / Ty);
    const int y = static_cast<int>(i - static_cast<long long>(x) * Ty);
    pb[i] = idx[y] == x ? mb[i] : 0.f;
  }
}

}  // namespace

// value, mask, path: contiguous f32 (B, Tx, Ty); bits: (B, Ty, Tx) bytes of
// scratch. Returns the launch's cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes whose columns do not fit shared memory.
extern "C" int maximum_path_mas(const void* value, const void* mask, void* path,
                                void* bits, int B, int Tx, int Ty, void* stream) {
  if (B <= 0 || Tx <= 0 || Ty <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long fixed = 4LL * (2LL * Tx + Ty);
  const long long per_frame = 4LL * (Tx + 1);
  const long long fit = (kSmemBudget - fixed) / per_frame;
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tile_y = static_cast<int>(fit < kMaxTileY ? fit : kMaxTileY);
  const int smem = static_cast<int>(fixed + per_frame * tile_y);
  cudaError_t err = cudaFuncSetAttribute(
      mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mas_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(mask),
      static_cast<float*>(path), static_cast<uint8_t*>(bits), Tx, Ty, tile_y);
  return static_cast<int>(cudaGetLastError());
}
