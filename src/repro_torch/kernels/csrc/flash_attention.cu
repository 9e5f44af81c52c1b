// Flash attention (blocked online softmax) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (called by flash_attention).
//
//   q (B, Sq, H, D), k, v (B, Skv, KVH, D)  ->  o (B, Sq, H, D), type of q
//
// Semantics of the reference: scores are the float32 product q.k times
// scale = D**-0.5; with `causal`, a key j is visible to the query at absolute
// position q_offset + i only if j <= q_offset + i, and masked scores are
// NEG_INF = -1e30 (ref.py:14); the running max m, denominator l and
// accumulator are float32; p = exp(s - m) is rounded to v's type before P.V
// (flash_attention.py:59), l sums the unrounded p; o = acc / l.
// GQA / MQA: the kv head of the flattened index bh is
// (bh / H) * KVH + (bh % H) / (H / KVH), read in place: k and v are never
// repeated in memory. The layouts are the reference's, read through strides
// (or tensor maps), so the wrapper transposes nothing.
//
// The TPU kernel walks the kv blocks as a sequential grid axis with m / l /
// acc in VMEM scratch. Here one block owns one (b*h, query tile) and walks
// the kv tiles in a loop, m / l / acc in registers. Any Sq and Skv: rows of
// a ragged query tile are zero-filled and not written back, and keys past
// Skv score -inf, so they weigh exactly 0 (with q_offset >= 0 key 0 is
// visible to every row, so m is finite after the first tile and no NaN
// forms). Causal kv tiles wholly above the diagonal are never loaded; query
// tiles run longest first (blockIdx.x reversed).
//
// Two kernels, one contract:
// * flash_fwd_wgmma (bfloat16, the serving path): TMA loads into an
//   mbarrier ring, both products on wgmma; see its note below. It takes the
//   head dims of the configs (32, 64, 112, 128) and 16-byte aligned
//   operands; any other bf16 call returns cudaErrorInvalidValue.
// * flash_fwd (float32, any head dim up to 128): float32 FMAs on the CUDA
//   cores, the tiles staged in shared memory.
//   Thread (ty, tx) of a 16 x 16 block owns query rows ty + 16 i (i < 4),
//   score columns tx + 16 j (j < 2) of a 32-key tile and output columns
//   tx + 16 c (c < 8, c * 16 + tx < D). The q and k tiles are padded to a
//   pitch of 129 floats so that both the row reads and the column reads of
//   the score loop are free of bank conflicts. 74 KB of shared memory per
//   block, three blocks per SM.
//
// Bound: at the serving path's shape (4, 2048, 16, 128) causal in bf16 the
// least time is set by operations (4 * B * H * D * visible pairs, 68.75
// GFLOP, at the tensor cores' 989 TFLOP/s: 0.0695 ms), not by bytes. The
// wgmma kernel runs it in 0.18 device ms on an H100 (38 % of the bound;
// scaled_dot_product_attention 0.14); chip_smoke.py measures it and
// PERF.md keeps the numbers.
//
// Plain C interface (bound with ctypes): flash_attention_f32 /
// flash_attention_bf16 return the cudaError_t of the launch. Nothing is
// allocated and nothing synchronises here. Compile without fast-math.
// The bf16 kernel's tensor maps are encoded with the driver's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library links nothing beyond the CUDA runtime.

#include <math_constants.h>

#include "hopper.cuh"          // mbarriers, TMA, wgmma, tensor maps

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 32;           // keys per kv tile
constexpr int THREADS = 256;     // 16 x 16
constexpr int D_MAX = 128;
constexpr int QP = D_MAX + 1;    // pitch (floats) of the q and k tiles
constexpr int PP = BK + 1;       // pitch (floats) of the p tile
constexpr int RPT = BQ / 16;     // query rows per thread
constexpr int SPT = BK / 16;     // score columns per thread
constexpr int OPT = D_MAX / 16;  // output columns per thread (at most)
constexpr float NEG_INF = -1e30f;
constexpr size_t SMEM_BYTES = sizeof(float) * (BQ * QP + BK * QP + BK * D_MAX + BQ * PP);

// max / sum over the 16 lanes that share a query row (one half-warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          float* __restrict__ o, int Sq, int Skv, int H, int KVH, int D, int causal,
          int64_t q_offset, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][QP]
  float* ks = qs + BQ * QP;       // [BK][QP]
  float* vs = ks + BK * QP;       // [BK][D_MAX]
  float* ps = vs + BK * D_MAX;    // [BQ][PP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / KVH);

  const int64_t q_pitch = (int64_t)H * D;     // elements between query rows
  const int64_t kv_pitch = (int64_t)KVH * D;  // elements between key rows
  const float* qb = q + (int64_t)b * Sq * q_pitch + (int64_t)(bh % H) * D;
  float* ob = o + (int64_t)b * Sq * q_pitch + (int64_t)(bh % H) * D;
  const float* kb = k + (int64_t)b * Skv * kv_pitch + (int64_t)kvh * D;
  const float* vb = v + (int64_t)b * Skv * kv_pitch + (int64_t)kvh * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    qs[r * QP + c] = q0 + r < Sq ? qb[(int64_t)(q0 + r) * q_pitch + c] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OPT; ++c) acc[i][c] = 0.f;
  }

  // causal: no row of this tile sees a key past q_offset + q0 + BQ - 1
  int64_t kv_end = Skv;
  if (causal && q_offset + q0 + BQ < kv_end) kv_end = q_offset + q0 + BQ;
  const int n_tiles = (int)((kv_end + BK - 1) / BK);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's ks / vs / ps are consumed (and qs is written)
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e - r * D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < Skv) {
        const int64_t off = (int64_t)(k0 + r) * kv_pitch + c;
        kv = kb[off];
        vv = vb[off];
      }
      ks[r * QP + c] = kv;
      vs[r * D_MAX + c] = vv;
    }
    __syncthreads();

    float s[RPT][SPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kk[SPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < SPT; ++j) kk[j] = ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < SPT; ++j) s[i][j] = fmaf(qv[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int64_t qpos = q_offset + q0 + ty + 16 * i;
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int kj = k0 + tx + 16 * j;
        float sv = s[i][j] * scale;
        if (kj >= Skv) sv = -CUDART_INF_F;
        else if (causal && qpos < kj) sv = NEG_INF;
        s[i][j] = sv;
        mt = fmaxf(mt, sv);
      }
      const float m_new = fmaxf(m[i], row_max(mt));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile (m = -inf)
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int key = 0; key < BK; ++key) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty + 16 * i) * PP + key];
#pragma unroll
      for (int c = 0; c < OPT; ++c) {
        if (tx + 16 * c < D) {
          const float vv = vs[key * D_MAX + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int c = 0; c < OPT; ++c)
      if (tx + 16 * c < D) ob[(int64_t)r * q_pitch + tx + 16 * c] = acc[i][c] / l[i];
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on Hopper's tensor cores: TMA, an mbarrier ring and wgmma.
//
// One block of 288 threads owns a 128-row query tile of one (b, h): two
// consumer warpgroups (warps 0-3 and 4-7) of 64 rows each, wgmma's M, and
// one producer warp (warp 8) whose first lane issues every load.
// * Shared memory, by TMA: Q once (128 rows), then K and V tiles of 128 keys
//   in a ring of STAGES (3 at D = 128, 4 below), each stage with a K-full,
//   a V-full and an empty mbarrier. The producer refills a stage as soon as
//   all eight consumer warps have released it, so loads run ahead of the
//   math by STAGES - 1 tiles. Every tile is stored as boxes of ROW-byte rows
//   (64 bf16 columns with 128-byte swizzle; D = 32 in one 64-byte-swizzled
//   box), the layout wgmma's descriptors read without bank conflicts.
// * S = Q K^T: wgmma m64n128k16, both operands in shared memory, K-major as
//   stored (D / 16 instructions a tile).
// * Online softmax on the accumulator fragments, in registers. Each thread
//   holds 2 rows x 32 scores. The mask runs only on tiles that the causal
//   diagonal or the end of Skv crosses. The scale and log2(e) fold into one
//   FMA before the special-function unit's 2^x (ex2.approx.ftz):
//   p = 2^(s c - m c), c = D**-0.5 log2(e). The masking sentinels are
//   applied to the unscaled score (-1e30 masked, -inf past Skv), which
//   changes no reachable result: key 0 is visible to every row, so masked
//   keys weigh exactly 0 either way. Against the plain version's
//   exp(s scale - m) the largest difference at the path shape stays one
//   bf16 unit of the output (0.015625 at |o| < 4), as with expf.
// * O += P V: wgmma m64nDk16 with P from registers (RS): the S fragments,
//   rounded pairwise to bf16, are the A fragments, so P never touches
//   shared memory; V is MN-major, read through the descriptor's transpose
//   bit. l sums the unrounded p.
// * Epilogue: O / l rounded to bf16 into this warpgroup's own (finished) Q
//   rows, swizzled as the Q boxes, then one TMA store a box, which clips
//   rows past Sq and columns past D.
// Registers: 165 a thread at D = 128, no spills, under the 168 that ptxas
// allows this 288-thread block (as it would 384 threads). That leaves no
// room for a second set of S accumulators, so the two products of a tile
// are issued one after the other: a ping-pong schedule that batched
// P_{t-1} V with S_t was serialized by ptxas for want of registers, and
// ran slower.
// Head dim 112 runs on the 128-wide tiles: the second box reads zeros past
// column 112 (TMA fills out-of-bounds reads with 0) and the store is clipped
// there. TMA zero-fills keys past Skv too, which would score 0, so the Skv
// mask stays.
// Fragment layout of a wgmma accumulator (m64nN, f32): warp w of the
// warpgroup owns rows 16 w .. 16 w + 15; with g = lane / 4, t = lane % 4,
// element 4 j + e is row 16 w + g + 8 (e / 2), column 8 j + 2 t + (e % 2).
// The A fragment of m64k16 in registers is mma.m16n8k16's: a0 = (g, 2t..),
// a1 = (g + 8, 2t..), a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..), the
// lower-indexed element of each pair in the low 16 bits.
// ---------------------------------------------------------------------------
constexpr int BM = 128;                   // query rows per block
constexpr int BN = 128;                   // keys per kv tile (the S product is m64n128)
constexpr int CONSUMER_WARPS = 8;         // two warpgroups
constexpr int WG_THREADS = 288;           // + one producer warp
constexpr int SMEM_OPT_IN = 232448;       // a block's shared memory on sm_90
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int DP = D == 112 ? 128 : D;             // columns a tile holds
  static constexpr int ROW = DP * 2 < 128 ? DP * 2 : 128;   // bytes per swizzled row
  static constexpr int BOXC = ROW / 2;                      // columns per TMA box
  static constexpr int NBOX = DP / BOXC;
  static constexpr uint64_t LAYOUT = ROW == 128 ? 1 : 2;    // descriptor: 128B / 64B swizzle
  static constexpr uint32_t SWZ = ROW == 128 ? 7 : 3;       // address bits 7.. XORed into 4..
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;              // one K (or V) tile
  static constexpr int BAR_BYTES = 128;
  static constexpr int FIT = (SMEM_OPT_IN - 1024 - BAR_BYTES - Q_BYTES) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
  static_assert(STAGES >= 2 && (1 + 3 * STAGES) * 8 <= BAR_BYTES, "shared memory plan");
  static_assert(D == 32 || D == 64 || D == 112 || D == 128, "head dims of the configs");
};

// 2^x on the special-function unit; flushes results below 2^-126 to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for one warpgroup's 64 rows and a 128-key tile, issued, not waited for
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[BN / 2], uint32_t q_base, uint32_t kb) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < T::DP / 16; ++kk) {
    const uint32_t box = kk * 16 / T::BOXC, col = (kk * 16 % T::BOXC) * 2;
    wgmma_ss_n128(sc, gmma_desc(q_base + box * BM * T::ROW + col, 16, 8 * T::ROW, T::LAYOUT),
                  gmma_desc(kb + box * BN * T::ROW + col, 16, 8 * T::ROW, T::LAYOUT), kk > 0);
  }
}

// O += P V for a 128-key tile, P from registers, issued, not waited for
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Tile<D>::DP / 2], const uint32_t (&pa)[BN / 16][4],
                                         uint32_t vb) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    mma_rs<T::DP>(o, pa[kk], gmma_desc(vb + kk * 16 * T::ROW, BN * T::ROW, 8 * T::ROW, T::LAYOUT));
}

// The online softmax of one score tile on its accumulator fragments (rows
// g: elements 0, 1; g + 8: elements 2, 3): masks it where the diagonal or
// the end of Skv crosses it, makes P as bf16 A fragments, and rescales O.
template <int D>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], float (&o)[Tile<D>::DP / 2],
                                             uint32_t (&pa)[BN / 16][4], float& m0, float& m1,
                                             float& l0, float& l1, int k0, int Skv, int causal,
                                             int64_t qp0, int64_t qp1, int64_t wg_first,
                                             int tq, float c) {
  constexpr int SN = BN / 2, ON = Tile<D>::DP / 2;
  if (k0 + BN > Skv || (causal && (int64_t)k0 + BN - 1 > wg_first)) {
#pragma unroll
    for (int j = 0; j < SN / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * tq + (e & 1);
        if (col >= Skv) sc[4 * j + e] = -CUDART_INF_F;
        else if (causal && (e < 2 ? qp0 : qp1) < col) sc[4 * j + e] = NEG_INF;
      }
    }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < SN / 4; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
  }
  const float al0 = exp2_approx((m0 - mx0) * c);   // 0 on the first tile (m = -inf)
  const float al1 = exp2_approx((m1 - mx1) * c);
  const float nb0 = -mx0 * c, nb1 = -mx1 * c;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < SN / 4; ++j) {
    const float p0 = exp2_approx(fmaf(sc[4 * j], c, nb0));
    const float p1 = exp2_approx(fmaf(sc[4 * j + 1], c, nb0));
    const float p2 = exp2_approx(fmaf(sc[4 * j + 2], c, nb1));
    const float p3 = exp2_approx(fmaf(sc[4 * j + 3], c, nb1));
    rs0 += p0 + p1;
    rs1 += p2 + p3;
    pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);      // row g:     a0 / a2
    pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);  // row g + 8: a1 / a3
  }
  l0 = l0 * al0 + rs0;   // this thread's share; the row's four lanes are summed at the end
  l1 = l1 * al1 + rs1;
  m0 = mx0;
  m1 = mx1;
#pragma unroll
  for (int n = 0; n < ON / 4; ++n) {
    o[4 * n] *= al0;
    o[4 * n + 1] *= al0;
    o[4 * n + 2] *= al1;
    o[4 * n + 3] *= al1;
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                int Sq, int Skv, int H, int KVH, int causal, int64_t q_offset, float scale_log2) {
  using T = Tile<D>;
  constexpr int SN = BN / 2;        // score accumulators a thread
  constexpr int ON = T::DP / 2;     // output accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ks = qs + T::Q_BYTES;                       // [STAGES][NBOX][BN][ROW]
  uint8_t* vs = ks + T::STAGES * T::KV_BYTES;          // [STAGES][NBOX][BN][ROW]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + T::STAGES * T::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + T::STAGES;
  uint64_t* kv_empty = v_full + T::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  // causal: no row of this tile sees a key past q_offset + q0 + BM - 1
  int64_t kv_end = Skv;
  if (causal && q_offset + q0 + BM < kv_end) kv_end = q_offset + q0 + BM;
  const int n_tiles = (int)((kv_end + BN - 1) / BN);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // producer: Q once, then K and V a tile at a time into the ring
    if (lane == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int x = 0; x < T::NBOX; ++x)
        tma_load(qs + x * BM * T::ROW, &qmap, q_full, x * T::BOXC, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % T::STAGES;
        if (t >= T::STAGES) mbar_wait(&kv_empty[s], ((t / T::STAGES) - 1) & 1);
        mbar_expect_tx(&k_full[s], T::KV_BYTES);
#pragma unroll
        for (int x = 0; x < T::NBOX; ++x)
          tma_load(ks + s * T::KV_BYTES + x * BN * T::ROW, &kmap, &k_full[s], x * T::BOXC, kvh,
                   t * BN, b);
        mbar_expect_tx(&v_full[s], T::KV_BYTES);
#pragma unroll
        for (int x = 0; x < T::NBOX; ++x)
          tma_load(vs + s * T::KV_BYTES + x * BN * T::ROW, &vmap, &v_full[s], x * T::BOXC, kvh,
                   t * BN, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. q0 + 64 wg + 63
  const int wg = warp >> 2, lw = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t qp0 = q_offset + q0 + wg * 64 + lw * 16 + g, qp1 = qp0 + 8;
  const int64_t wg_first = q_offset + q0 + wg * 64;   // the warpgroup's first position
  const uint32_t q_base = smem_addr(qs) + wg * 64 * T::ROW;
  const uint32_t k_base = smem_addr(ks), v_base = smem_addr(vs);

  float o[ON], sc[SN];
#pragma unroll
  for (int i = 0; i < ON; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < SN; ++i) sc[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  uint32_t pa[BN / 16][4];

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % T::STAGES;
    const uint32_t parity = (t / T::STAGES) & 1;
    mbar_wait(&k_full[s], parity);
    fence_regs(sc);
    wgmma_fence();
    issue_s<D>(sc, q_base, k_base + s * T::KV_BYTES);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    softmax_tile<D>(sc, o, pa, m0, m1, l0, l1, t * BN, Skv, causal, qp0, qp1, wg_first, tq,
                    scale_log2);
    mbar_wait(&v_full[s], parity);
    fence_regs(o);
    wgmma_fence();
    issue_pv<D>(o, pa, v_base + s * T::KV_BYTES);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&kv_empty[s]);   // this warp is done with the stage
  }

  // epilogue: O / l in bf16 into this warpgroup's Q rows (no longer read),
  // swizzled as the boxes, then one TMA store a box
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const uint32_t r0 = wg * 64 + lw * 16 + g;
#pragma unroll
  for (int n = 0; n < ON / 4; ++n) {
    const uint32_t col = 8 * n + 2 * tq;
    const uint32_t off = (col / T::BOXC) * BM * T::ROW + r0 * T::ROW + (col % T::BOXC) * 2;
    const uint32_t off8 = off + 8 * T::ROW;
    *reinterpret_cast<uint32_t*>(qs + (off ^ (((off >> 7) & T::SWZ) << 4))) =
        pack_bf16(o[4 * n] / l0, o[4 * n + 1] / l0);
    *reinterpret_cast<uint32_t*>(qs + (off8 ^ (((off8 >> 7) & T::SWZ) << 4))) =
        pack_bf16(o[4 * n + 2] / l1, o[4 * n + 3] / l1);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (lw == 0 && lane == 0 && q0 + wg * 64 < Sq) {
#pragma unroll
    for (int x = 0; x < T::NBOX; ++x)
      tma_store(&omap, qs + x * BM * T::ROW + wg * 64 * T::ROW, x * T::BOXC, h, q0 + wg * 64, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// shapes either kernel takes (int indices, grid.y <= 65535)
bool valid(int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KVH, int64_t D,
           int64_t q_offset) {
  return B >= 1 && Sq >= 1 && Skv >= 1 && H >= 1 && KVH >= 1 && H % KVH == 0 && D >= 1 &&
         D <= D_MAX && q_offset >= 0 && B * H <= 65535 && Sq <= 0x7fffffffLL - BM &&
         Skv <= 0x7fffffffLL - BN;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
                 int64_t Skv, int64_t H, int64_t KVH, int causal, int64_t q_offset, float scale,
                 cudaStream_t stream) {
  using T = Tile<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapSwizzle sw = T::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap qm, km, vm, om;
  if (!(tensor_map(encode, &qm, q, D, H, Sq, B, T::BOXC, BM, sw) &&
        tensor_map(encode, &km, k, D, KVH, Skv, B, T::BOXC, BN, sw) &&
        tensor_map(encode, &vm, v, D, KVH, Skv, B, T::BOXC, BN, sw) &&
        tensor_map(encode, &om, o, D, H, Sq, B, T::BOXC, BM / 2, sw)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BM - 1) / BM), (unsigned)(B * H));
  flash_fwd_wgmma<D><<<grid, WG_THREADS, T::SMEM, stream>>>(
      qm, km, vm, om, (int)Sq, (int)Skv, (int)H, (int)KVH, causal, q_offset, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int64_t B,
                        int64_t Sq, int64_t Skv, int64_t H, int64_t KVH, int64_t D, int causal,
                        int64_t q_offset, float scale, void* stream) {
  if (!valid(B, Sq, Skv, H, KVH, D, q_offset)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * H));
  flash_fwd<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), (int)Sq, (int)Skv, (int)H, (int)KVH, (int)D, causal, q_offset,
      scale);
  return (int)cudaGetLastError();
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int64_t B,
                         int64_t Sq, int64_t Skv, int64_t H, int64_t KVH, int64_t D, int causal,
                         int64_t q_offset, float scale, void* stream) {
  if (!valid(B, Sq, Skv, H, KVH, D, q_offset) ||
      !(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_wgmma<32>(q, k, v, o, B, Sq, Skv, H, KVH, causal, q_offset, scale, st);
    case 64: return launch_wgmma<64>(q, k, v, o, B, Sq, Skv, H, KVH, causal, q_offset, scale, st);
    case 112:
      return launch_wgmma<112>(q, k, v, o, B, Sq, Skv, H, KVH, causal, q_offset, scale, st);
    case 128:
      return launch_wgmma<128>(q, k, v, o, B, Sq, Skv, H, KVH, causal, q_offset, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int64_t flash_attention_max_head_dim() { return D_MAX; }

}  // extern "C"
