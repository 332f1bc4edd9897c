// Flash attention for the DiT's multi-head self-attention, Hopper: the
// forward (with its log-sum-exp for training) and the backward.
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
// bound by operations, so the work goes to the tensor cores (wgmma, the
// only path to their full rate) and the T×T scores never leave registers.
//
// bf16 forward (flash_fwd_bf16): one CTA per (128-query tile, b·h), the
// tiles of one (b, h) launched next to each other so that its K and V stay
// in L2 while they are read; three warpgroups, warp-specialised:
//   * a producer warpgroup (setmaxnreg.dec to 24) whose one thread starts
//     TMA loads: the Q tile once, then 128-key K and V tiles through a
//     3-stage ring (224 KB of shared memory in all) with full/empty
//     mbarriers, so loads run a tile or more ahead of the tensor cores;
//   * two consumer warpgroups (setmaxnreg.inc to 240) of 64 query rows;
//     S = Q·Kᵀ by wgmma m64n128k16 with both operands in shared memory,
//     the online softmax in registers in f32 (exp2, the scale hd^-½ folded
//     with log2 e into the f32 scores), P rounded to bf16 in registers (as
//     the JAX einsum branch rounds its weights to the compute type), then
//     O += P·V by wgmma with A from registers and V as an MN-major B
//     operand. Each consumer starts S of tile n and P·V of tile n − 1
//     together and runs the softmax of tile n while that P·V is on the
//     tensor cores; the two consumers take turns to start (two named
//     barriers), so one's softmax runs under the other's products; a
//     consumer releases a ring slot after its P·V wait;
//   * TMA reads q, k, v through 4-D tensor maps (hd, H, T, B) built per
//     call from the views' strides: rows ≥ T of a batch item come back as
//     zeros, keys ≥ T are scored −inf, queries ≥ T are not stored, so any
//     T works with no padding copy. hd = 128 bf16 is 256 bytes, twice the
//     128-byte swizzle span, so every tile is two 64-column boxes with the
//     128-byte swizzle, which the wgmma descriptors describe;
//   * with a non-null `lse` (training) each query's natural-log
//     log-sum-exp of the scaled scores goes to lse[b, h, t] (f32); that is
//     a second instantiation, so inference carries no log-sum-exp code.
// The f32 variant is plain FMA on the CUDA cores (no TF32): 4 threads per
// query, each holding 32 of the 128 dims.
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
//   * bf16, one pass (flash_bwd_bf16): one CTA per (128-key block, b·h),
//     warp-specialised as the forward. The producer loads the block's K
//     and V once by TMA, then streams 64-query Q and dO tiles through a
//     2-stage ring; its warp writes each tile's lse and D (f32 rows, plain
//     loads: T·4 bytes need not be a multiple of 16, which a tensor map
//     would require) into the stage and arrives on its full barrier. Each
//     consumer warpgroup owns 64 keys: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ by wgmma
//     from shared memory, Pᵀ and dSᵀ in f32 registers, dV += bf16(Pᵀ)·dO
//     and dK += bf16(dSᵀ)·Q by wgmma with A from registers; S and dP are
//     computed once. dSᵀ goes to shared memory in bf16 (double-buffered,
//     one barrier of the two consumers per tile), and each consumer forms
//     the tile's dQ partial dS·K over all 128 keys for its half of hd; the
//     partial goes through shared memory into an f32 accumulator of
//     ⌈T/64⌉·64·hd values per (b, h) by one TMA bulk reduce-add, so the
//     consumers run no atomics. A second small kernel
//     (flash_bwd_dq_convert) writes dq = bf16(scale·accumulator), as
//     FlashAttention-3 does.
//   * queries ≥ T are zero rows with lse = +inf (P = 0), keys ≥ T zero
//     rows whose P is forced to 0 and whose dK/dV are not stored; any T.
//   * the f32 variants: dK/dV and dQ kernels, 4 threads per key (dK/dV) or
//     per query (dQ), each holding 32 dims, 32-row tiles, FMA on the CUDA
//     cores.
// Inputs are read through strides (views of the DiT's (B, T, 3, H, hd)
// projection); gradients are written through strides into one
// (B, T, 3, H, hd) buffer.
//
// The bf16 kernels need sm_90a (wgmma, setmaxnreg, TMA). The tensor maps
// are encoded on the host by cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library links no libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------- Hopper building blocks ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one 64-column box of a 4-D (hd, H, T, B) tensor map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int h, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(h), "r"(t), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a tile in the 128-byte-swizzled layout
// TMA writes (rows of 128 bytes, 8-row atoms of 1024 bytes, 1024-aligned
// bases). K-major operands: `lbo` unused, `sbo` the 8-row atom stride.
// MN-major operands: `lbo` the stride between 64-element atoms along M/N,
// `sbo` the stride between 8-row groups along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving register reads or writes across a wgmma
// wait (the tensor cores read and write these registers asynchronously)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

#define WG_D32                                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_D64                                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_F8(d, i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F32(d) WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
#define WG_F64(d) WG_F32(d), WG_F8(d, 32), WG_F8(d, 40), WG_F8(d, 48), WG_F8(d, 56)

// D(64×128, f32) (+)= A(64×16) · B(16×128), A and B from shared memory,
// both K-major; `acc` 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F64(d)
      : "l"(da), "l"(db), "r"(acc));
}

// D(64×128, f32) += A(64×16, bf16 registers) · B(16×128), B MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64×64, f32) (+)= A(64×16) · B(16×64) from shared memory; kTrans: both
// operands MN-major (else both K-major)
template <int kTrans>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, %35, %35;\n}\n"
      : WG_F32(d)
      : "l"(da), "l"(db), "r"(acc), "n"(kTrans));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The f32 accumulator of an m64nN wgmma, per thread: d[4i + e] is row
// 16·warp + g + 8·(e >> 1), column 8i + 2·tq + (e & 1) (g = lane / 4, tq =
// lane % 4). Two neighbouring 8-column groups of it are, rounded to bf16,
// the register A operand of one k16 step.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    a[j][0] = pack_bf16(d[8 * j], d[8 * j + 1]);
    a[j][1] = pack_bf16(d[8 * j + 2], d[8 * j + 3]);
    a[j][2] = pack_bf16(d[8 * j + 4], d[8 * j + 5]);
    a[j][3] = pack_bf16(d[8 * j + 6], d[8 * j + 7]);
  }
}

constexpr int kBox = 64;                 // hd columns per TMA box (128 bytes)
constexpr uint32_t kAtom = 1024;         // 8 rows × 128 bytes
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kThreads = 384;            // producer + two consumer warpgroups

// ------------------------------------------------------ bf16 forward ---

constexpr int kTileQ = 128;   // queries per CTA: two consumer warpgroups × 64
constexpr int kTileK = 128;   // keys per K/V ring stage
constexpr int kFwdStages = 3;
constexpr uint32_t kTileBytes = kTileK * kBox * 2;          // one 128-row box, 16 KB
constexpr int kFwdQ = 0;                                    // Q: two boxes
constexpr int kFwdKV = 2 * kTileBytes;                      // stage s: K boxes, then V boxes
constexpr int kFwdStage = 4 * kTileBytes;
constexpr int kFwdBar = kFwdKV + kFwdStages * kFwdStage;    // q, full[3], empty[3]
constexpr int kFwdSmem = kFwdBar + 64 + 1024;               // + slack for 1024-alignment

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// The online softmax of one 64×128 score tile held as an m64n128
// accumulator (rows g and g + 8 of each warp's 16): keys ≥ T scored −inf,
// scores scaled into log2 units, running max and sum updated; the tile
// becomes P = exp2(s − max) in place. → the factor for the output so far.
__device__ __forceinline__ void online_softmax(float (&sc)[64], float (&m_run)[2],
                                               float (&l_run)[2], float (&alpha)[2], int k0,
                                               int T, int tq, float scale_log2) {
  if (k0 + kTileK > T) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (k0 + 8 * (i >> 2) + 2 * tq + (i & 1) >= T) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] *= scale_log2;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    base[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = exp2f(m_run[r] - base[r]);
    m_run[r] = m_new;
  }
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = exp2f(sc[i] - base[(i >> 1) & 1]);
    sc[i] = p;
    rsum[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rsum[r];
}

template <bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, int T, int H, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + kFwdBar);
  uint64_t* q_full = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + kFwdStages;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int t0 = blockIdx.x * kTileQ;
  const int n_tiles = (T + kTileK - 1) / kTileK;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_arrive_tx(q_full, 2 * kTileBytes);
      tma_load(sm + kFwdQ, &mq, q_full, 0, h, t0, b);
      tma_load(sm + kFwdQ + kTileBytes, &mq, q_full, kBox, h, t0, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kFwdStages;
        mbar_wait(&empty[s], ((kt / kFwdStages) & 1) ^ 1);
        unsigned char* kv = sm + kFwdKV + s * kFwdStage;
        mbar_arrive_tx(&full[s], 4 * kTileBytes);
        tma_load(kv, &mk, &full[s], 0, h, kt * kTileK, b);
        tma_load(kv + kTileBytes, &mk, &full[s], kBox, h, kt * kTileK, b);
        tma_load(kv + 2 * kTileBytes, &mv, &full[s], 0, h, kt * kTileK, b);
        tma_load(kv + 3 * kTileBytes, &mv, &full[s], kBox, h, kt * kTileK, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = threadIdx.x / 128 - 1;  // consumer warpgroup: query rows 64c..64c+63
    const int w = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const uint32_t q_base = smem_u32(sm + kFwdQ) + c * 64 * 128;
    const uint32_t kv_base = smem_u32(sm + kFwdKV);

    // S = Q·Kᵀ of the tile in stage s: 64 queries × 128 keys, 8 k16 steps
    // over hd (4 per box); started, not waited on
    auto mma_s = [&](float (&sc)[64], int s) {
      const uint32_t k_base = kv_base + s * kFwdStage;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kTileBytes + (kk & 3) * 32;
        wgmma_ss_n128(sc, sw128_desc(q_base + off, 16, kAtom), sw128_desc(k_base + off, 16, kAtom),
                      kk);
      }
      wgmma_commit();
    };
    // O += P·V of the tile in stage s: P (bf16) from registers, V
    // MN-major, 8 k16 steps over keys; started, not waited on
    auto mma_pv = [&](float (&acc)[64], const uint32_t (&pf)[8][4], int s) {
      const uint32_t v_base = kv_base + s * kFwdStage + 2 * kTileBytes;
#pragma unroll
      for (int j = 0; j < kTileK / 16; ++j) {
        wgmma_rs_n128(acc, pf[j], sw128_desc(v_base + j * 2 * kAtom, kTileBytes, kAtom));
      }
      wgmma_commit();
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    // turns to start products: consumer c waits on barrier 1 + c, then
    // hands the turn on (consumer 0 first; each consumer starts products n_tiles + 1
    // times, and consumer 1 skips its last hand-on, which no one waits for)
    auto gemm_turn = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory"); };
    auto pass_turn = [&]() { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory"); };
    if (c == 1) pass_turn();

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float alpha[2];
    float sc[64];
    uint32_t pf[8][4];

    // tile 0: S, softmax, P
    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    gemm_turn();
    wgmma_fence();
    mma_s(sc, 0);
    pass_turn();
    wgmma_wait_all();
    fence_regs(sc);
    online_softmax(sc, m_run, l_run, alpha, 0, T, tq, scale_log2);
    acc_to_a<128>(pf, sc);

    // tile kt: S of kt runs on the tensor cores with P·V of kt − 1 behind
    // it, and the softmax of kt overlaps that P·V
    for (int kt = 1; kt < n_tiles; ++kt) {
      const int s = kt % kFwdStages;
      const int prev = (kt - 1) % kFwdStages;
      mbar_wait(&full[s], (kt / kFwdStages) & 1);
      gemm_turn();
      wgmma_fence();
      mma_s(sc, s);
      mma_pv(acc, pf, prev);
      pass_turn();
      wgmma_wait_one();  // S done; P·V may still run
      fence_regs(sc);
      online_softmax(sc, m_run, l_run, alpha, kt * kTileK, T, tq, scale_log2);
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pf);
      release(prev);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
      acc_to_a<128>(pf, sc);
    }
    gemm_turn();
    wgmma_fence();
    mma_pv(acc, pf, (n_tiles - 1) % kFwdStages);
    if (c == 0) pass_turn();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pf);
    release((n_tiles - 1) % kFwdStages);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      inv[r] = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
    }
    const int r0 = t0 + c * 64 + w * 16 + g;
    const int r1 = r0 + 8;
    if (kLse && tq == 0) {  // natural-log log-sum-exp of the scaled scores
      float* lb = lse + static_cast<long long>(blockIdx.y) * T;
      if (r0 < T) lb[r0] = (m_run[0] + log2f(l_run[0])) * kLn2;
      if (r1 < T) lb[r1] = (m_run[1] + log2f(l_run[1])) * kLn2;
    }
    const long long o_st = static_cast<long long>(H) * kHeadDim;
    __nv_bfloat16* ob = o + static_cast<long long>(b) * T * o_st + h * kHeadDim;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = 8 * i + 2 * tq;
      if (r0 < T) {
        *reinterpret_cast<uint32_t*>(ob + r0 * o_st + col) =
            pack_bf16(acc[4 * i] * inv[0], acc[4 * i + 1] * inv[0]);
      }
      if (r1 < T) {
        *reinterpret_cast<uint32_t*>(ob + r1 * o_st + col) =
            pack_bf16(acc[4 * i + 2] * inv[1], acc[4 * i + 3] * inv[1]);
      }
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

// ----------------------------------------------------- bf16 backward ---

constexpr int kBwdTileQ = 64;                               // queries per ring stage
constexpr uint32_t kQBoxBytes = kBwdTileQ * kBox * 2;       // one 64-row box, 8 KB
constexpr int kBwdK = 0;                                    // K: two 128-row boxes
constexpr int kBwdV = 2 * kTileBytes;                       // V: two 128-row boxes
constexpr int kBwdQ = 4 * kTileBytes;                       // stage s: Q boxes, then dO boxes
constexpr int kBwdStage = 4 * kQBoxBytes;
constexpr int kDsBytes = kTileK * kBwdTileQ * 2;            // dSᵀ: 128 keys × 64 queries, bf16
constexpr int kBwdDs = kBwdQ + 2 * kBwdStage;               // two dSᵀ buffers
constexpr int kDqBytes = kBwdTileQ * 64 * 4;                // a dQ partial: 64 queries × 64 dims, f32
constexpr int kBwdDq = kBwdDs + 2 * kDsBytes;               // one dQ partial per consumer
constexpr int kBwdStats = kBwdDq + 2 * kDqBytes;            // stage s: lse·log2 e [64], D [64]
constexpr int kBwdBar = kBwdStats + 2 * 2 * kBwdTileQ * 4;  // kv, full[2], empty[2]
constexpr int kBwdSmem = kBwdBar + 64 + 1024;

struct BwdBf16Args {
  const float* lse;    // (B, H, T), natural log
  const float* delta;  // (B, H, T), rowsum(dO∘O)
  float* dq_acc;       // f32, Tpad·hd per (b, h) in 64×64 blocks (flash_bwd_dq_convert), zeroed
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  Strides sdk, sdv;
  int T, H;
  float scale_log2, scale;
};

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_bf16(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
               const BwdBf16Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + kBwdBar);
  uint64_t* kv_full = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 3;
  float* stats = reinterpret_cast<float*>(sm + kBwdStats);
  const int T = a.T;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int k0 = blockIdx.x * kTileK;
  const int n_q = (T + kBwdTileQ - 1) / kBwdTileQ;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes, after their lse/D stores
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_tx(kv_full, 4 * kTileBytes);
        tma_load(sm + kBwdK, &mk, kv_full, 0, h, k0, b);
        tma_load(sm + kBwdK + kTileBytes, &mk, kv_full, kBox, h, k0, b);
        tma_load(sm + kBwdV, &mv, kv_full, 0, h, k0, b);
        tma_load(sm + kBwdV + kTileBytes, &mv, kv_full, kBox, h, k0, b);
      }
      const float* lb = a.lse + static_cast<long long>(bh) * T;
      const float* db = a.delta + static_cast<long long>(bh) * T;
      for (int it = 0; it < n_q; ++it) {
        const int s = it & 1;
        mbar_wait(&empty[s], ((it >> 1) & 1) ^ 1);
        const int q0 = it * kBwdTileQ;
        float* st = stats + s * 2 * kBwdTileQ;
        for (int i = lane; i < kBwdTileQ; i += 32) {
          const int q = q0 + i;
          st[i] = q < T ? lb[q] * kLog2e : INFINITY;  // P = 0 for queries ≥ T
          st[kBwdTileQ + i] = q < T ? db[q] : 0.f;
        }
        if (lane == 0) {
          unsigned char* qd = sm + kBwdQ + s * kBwdStage;
          mbar_arrive_tx(&full[s], 4 * kQBoxBytes);
          tma_load(qd, &mq, &full[s], 0, h, q0, b);
          tma_load(qd + kQBoxBytes, &mq, &full[s], kBox, h, q0, b);
          tma_load(qd + 2 * kQBoxBytes, &mdo, &full[s], 0, h, q0, b);
          tma_load(qd + 3 * kQBoxBytes, &mdo, &full[s], kBox, h, q0, b);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = threadIdx.x / 128 - 1;  // consumer warpgroup: keys k0 + 64c .. + 63
    const int lt = threadIdx.x & 127;
    const int w = lt >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const uint32_t k_rows = smem_u32(sm + kBwdK) + c * 64 * 128;  // K-major A: this group's keys
    const uint32_t v_rows = smem_u32(sm + kBwdV) + c * 64 * 128;
    const uint32_t k_cols = smem_u32(sm + kBwdK) + c * kTileBytes;  // MN-major B: hd half c
    const int key_l0 = c * 64 + w * 16 + g;  // this thread's keys: key_l0 and key_l0 + 8
    const bool kok0 = k0 + key_l0 < T;
    const bool kok1 = k0 + key_l0 + 8 < T;

    float dv[64];
    float dk[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dv[i] = dk[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_q; ++it) {
      const int s = it & 1;
      mbar_wait(&full[s], (it >> 1) & 1);
      const uint32_t q_base = smem_u32(sm + kBwdQ + s * kBwdStage);
      const uint32_t do_base = q_base + 2 * kQBoxBytes;
      const float* st = stats + s * 2 * kBwdTileQ;

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 64 keys × 64 queries, 8 k16 steps over hd
      float sT[32];
      float dpT[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        wgmma_ss_n64<0>(sT, sw128_desc(k_rows + (kk >> 2) * kTileBytes + (kk & 3) * 32, 16, kAtom),
                        sw128_desc(q_base + (kk >> 2) * kQBoxBytes + (kk & 3) * 32, 16, kAtom), kk);
      }
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        wgmma_ss_n64<0>(dpT, sw128_desc(v_rows + (kk >> 2) * kTileBytes + (kk & 3) * 32, 16, kAtom),
                        sw128_desc(do_base + (kk >> 2) * kQBoxBytes + (kk & 3) * 32, 16, kAtom), kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sT);
      fence_regs(dpT);

      // Pᵀ = exp(Sᵀ·scale − lse) and dSᵀ = Pᵀ∘(dPᵀ − D) in f32; row = key,
      // column = query 8·(i / 4) + 2·tq + (i & 1)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qi = 8 * (i >> 2) + 2 * tq + (i & 1);
        const bool kok = (i & 2) ? kok1 : kok0;
        const float p = kok ? exp2f(sT[i] * a.scale_log2 - st[qi]) : 0.f;
        sT[i] = p;
        dpT[i] = p * (dpT[i] - st[kBwdTileQ + qi]);
      }
      uint32_t pf[4][4];
      uint32_t sf[4][4];
      acc_to_a<64>(pf, sT);
      acc_to_a<64>(sf, dpT);

      // dSᵀ in bf16 into this tile's buffer: row = key (128 bytes = 64
      // queries), 16-byte chunk q/8 stored at chunk (q/8) ^ (key % 8), the
      // 128-byte swizzle the dQ product's descriptor reads
      unsigned char* ds = sm + kBwdDs + (it & 1) * kDsBytes;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_l0 + 8 * (e & 1);
          const int chunk = 2 * j + (e >> 1);
          *reinterpret_cast<uint32_t*>(ds + key * 128 + ((chunk ^ (key & 7)) << 4) + tq * 4) =
              sf[j][e];
        }
      }

      // dV += Pᵀ·dO and dK += dSᵀ·Q: A from registers, dO and Q MN-major
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBwdTileQ / 16; ++j) {
        wgmma_rs_n128(dv, pf[j], sw128_desc(do_base + j * 2 * kAtom, kQBoxBytes, kAtom));
      }
#pragma unroll
      for (int j = 0; j < kBwdTileQ / 16; ++j) {
        wgmma_rs_n128(dk, sf[j], sw128_desc(q_base + j * 2 * kAtom, kQBoxBytes, kAtom));
      }
      wgmma_commit();

      // both consumers' halves of dSᵀ written and visible to the tensor
      // cores; then dQ partial = dS·K for hd half c over all 128 keys (dS
      // and K both MN-major)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      const uint32_t ds_base = smem_u32(ds);
      float dq[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        wgmma_ss_n64<1>(dq, sw128_desc(ds_base + kk * 2 * kAtom, kAtom, kAtom),
                        sw128_desc(k_cols + kk * 2 * kAtom, kTileBytes, kAtom), kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(dq);
      fence_regs(pf);
      fence_regs(sf);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);

      // the partial, through shared memory laid out as the warps hold it
      // (flash_bwd_dq_convert reads that order), into its 64×64 block of
      // the f32 accumulator by one bulk reduce-add (the TMA unit adds; the
      // blocks of the key blocks come in an order that changes from run to
      // run); the buffer is rewritten once the last reduce has read it
      float* dq_s = reinterpret_cast<float*>(sm + kBwdDq + c * kDqBytes);
      if (lt == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          *reinterpret_cast<float2*>(dq_s + ((w * 8 + i) * 2 + half) * 64 + lane * 2) =
              make_float2(dq[4 * i + 2 * half], dq[4 * i + 2 * half + 1]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
      if (lt == 0) {
        const float* dst =
            a.dq_acc + ((static_cast<long long>(bh) * n_q + it) * 2 + c) * (kDqBytes / 4);
        asm volatile(
            "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
            "r"(smem_u32(dq_s)), "r"(kDqBytes)
            : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (lt == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

    const int kr0 = k0 + key_l0;
    const int kr1 = kr0 + 8;
    __nv_bfloat16* dkb = a.dk + b * a.sdk.b + h * a.sdk.h;
    __nv_bfloat16* dvb = a.dv + b * a.sdv.b + h * a.sdv.h;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = 8 * i + 2 * tq;
      if (kok0) {
        *reinterpret_cast<uint32_t*>(dkb + kr0 * a.sdk.t + col) =
            pack_bf16(dk[4 * i] * a.scale, dk[4 * i + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvb + kr0 * a.sdv.t + col) = pack_bf16(dv[4 * i], dv[4 * i + 1]);
      }
      if (kok1) {
        *reinterpret_cast<uint32_t*>(dkb + kr1 * a.sdk.t + col) =
            pack_bf16(dk[4 * i + 2] * a.scale, dk[4 * i + 3] * a.scale);
        *reinterpret_cast<uint32_t*>(dvb + kr1 * a.sdv.t + col) =
            pack_bf16(dv[4 * i + 2], dv[4 * i + 3]);
      }
    }
  }
}

// dq = bf16(scale · accumulator) for t < T, through dq's strides; one
// thread per 8 values (a 16-byte store). The accumulator holds, per
// (b·h, 64-query tile, 64-dim half), a block of 64 × 64 f32 in the order of
// the consumer's m64n64 accumulator: query 16w + 8·half + g and dims 8i ..
// 8i + 7 of the half sit at ((w·8 + i)·2 + half)·64 + 8g.
__global__ void __launch_bounds__(256)
flash_bwd_dq_convert(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq, int B, int T,
                     int H, int Tpad, Strides sdq, float scale) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * H * T * (kHeadDim / 8)) return;
  const int chunk = static_cast<int>(idx % (kHeadDim / 8));
  const long long row = idx / (kHeadDim / 8);
  const int t = static_cast<int>(row % T);
  const int bh = static_cast<int>(row / T);
  const int r = t % kBwdTileQ;
  const long long block = (static_cast<long long>(bh) * (Tpad / kBwdTileQ) + t / kBwdTileQ) * 2 +
                          chunk / 8;
  const float4* src = reinterpret_cast<const float4*>(
      acc + block * (kDqBytes / 4) + (((r >> 4) * 8 + chunk % 8) * 2 + ((r >> 3) & 1)) * 64 +
      (r & 7) * 8);
  const float4 x = src[0];
  const float4 y = src[1];
  const uint4 out = make_uint4(pack_bf16(x.x * scale, x.y * scale), pack_bf16(x.z * scale, x.w * scale),
                               pack_bf16(y.x * scale, y.y * scale), pack_bf16(y.z * scale, y.w * scale));
  *reinterpret_cast<uint4*>(dq + (bh / H) * sdq.b + t * sdq.t + (bh % H) * sdq.h + chunk * 8) = out;
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

// `s`: byte strides (head, time, batch) of the f32 q, k, v, dout, dq, dk, dv
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
  for (int i = 0; i < 7; ++i) *all[i] = Strides{s[3 * i + 2] / 4, s[3 * i + 1] / 4, s[3 * i] / 4};
  a.T = T;
  a.H = H;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  return a;
}

// -------------------------------------------------------------- host ---

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda's), found through the runtime (no libcuda link)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// The 4-D tensor map (hd, H, T, B) of a bf16 (B, T, H, 128) view whose byte
// strides of H, T and B are s[0..2]; boxes of 64 columns × `rows` rows,
// 128-byte swizzle, rows ≥ T read as zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int B, int T, int H, const long long* s,
                int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHeadDim), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s[0]), static_cast<cuuint64_t>(s[1]),
                                 static_cast<cuuint64_t>(s[2])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBox), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// element strides (batch, time, head) from byte strides (head, time, batch)
Strides elem_strides(const long long* s, int elem) {
  return Strides{s[2] / elem, s[1] / elem, s[0] / elem};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `strides` (host memory): byte strides
// of the head, time and batch dimensions of q, k, v, in that order (the
// tensor maps' order). `lse` is null for inference, else an f32 (B, H, T)
// output. Returns the launch's cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                   int dtype, int B, int T, int H, int head_dim,
                                   const long long* strides, float scale, void* stream) {
  if (head_dim != kHeadDim || B <= 0 || T <= 0 || H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    CUtensorMap mq, mk, mv;
    if (!encode_map(&mq, q, B, T, H, strides, kTileQ) ||
        !encode_map(&mk, k, B, T, H, strides + 3, kTileK) ||
        !encode_map(&mv, v, B, T, H, strides + 6, kTileK)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto kernel = lse != nullptr ? flash_fwd_bf16<true> : flash_fwd_bf16<false>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3((T + kTileQ - 1) / kTileQ, B * H), kThreads, kFwdSmem, st>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), T, H, scale_log2);
  } else if (dtype == 0) {
    const Strides sq = elem_strides(strides, 4);
    const Strides sk = elem_strides(strides + 3, 4);
    const Strides sv = elem_strides(strides + 6, 4);
    const dim3 grid(B * H, (T + kF32BlockQ - 1) / kF32BlockQ);
    auto kernel = lse != nullptr ? flash_fwd_f32<true> : flash_fwd_f32<false>;
    kernel<<<grid, 128, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), T, H, sq.b, sq.t, sq.h, sk.b, sk.t, sk.h,
        sv.b, sv.t, sv.h, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward: dq, dk, dv from q, k, v, dout, the f32 (B, H, T) lse and
// delta. `strides` (host memory): byte strides (head, time, batch) of q,
// k, v, dout, dq, dk, dv in that order. bf16 launches the one-pass kernel
// into `dq_acc`, a zeroed f32 (B, H, ⌈T/64⌉·64, 128) accumulator, and then
// the dQ convert; f32 (dq_acc unused) the dK/dV and the dQ kernel.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dq, void* dk,
                                   void* dv, void* dq_acc, int dtype, int B, int T, int H,
                                   int head_dim, const long long* strides, float scale,
                                   void* stream) {
  if (head_dim != kHeadDim || B <= 0 || T <= 0 || H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    CUtensorMap mq, mk, mv, mdo;
    if (!encode_map(&mq, q, B, T, H, strides, kBwdTileQ) ||
        !encode_map(&mk, k, B, T, H, strides + 3, kTileK) ||
        !encode_map(&mv, v, B, T, H, strides + 6, kTileK) ||
        !encode_map(&mdo, dout, B, T, H, strides + 9, kBwdTileQ)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int t_pad = (T + kBwdTileQ - 1) / kBwdTileQ * kBwdTileQ;
    const BwdBf16Args a{static_cast<const float*>(lse), static_cast<const float*>(delta),
                        static_cast<float*>(dq_acc), static_cast<__nv_bfloat16*>(dk),
                        static_cast<__nv_bfloat16*>(dv), elem_strides(strides + 15, 2),
                        elem_strides(strides + 18, 2), T, H, scale * kLog2e, scale};
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_bf16,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_bf16<<<dim3((T + kTileK - 1) / kTileK, B * H), kThreads, kBwdSmem, st>>>(mq, mk, mv,
                                                                                       mdo, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n = static_cast<long long>(B) * H * T * (kHeadDim / 8);
    flash_bwd_dq_convert<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(dq_acc), static_cast<__nv_bfloat16*>(dq), B, T, H, t_pad,
        elem_strides(strides + 12, 2), scale);
  } else if (dtype == 0) {
    const BwdArgs a = make_args(q, k, v, dout, lse, delta, dq, dk, dv, T, H, strides, scale);
    flash_bwd_dkv_f32<<<dim3(B * H, (T + kF32BlockK - 1) / kF32BlockK), 128, 0, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_f32<<<dim3(B * H, (T + kF32BlockQ - 1) / kF32BlockQ), 128, 0, st>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
