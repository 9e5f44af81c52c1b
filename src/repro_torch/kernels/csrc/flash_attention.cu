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
// repeated in memory. The layouts are the reference's, read through strides,
// so the wrapper transposes nothing.
//
// The TPU kernel walks the kv blocks as a sequential grid axis with m / l /
// acc in VMEM scratch. Here one block owns one (b*h, 64-row query tile) and
// walks the kv tiles in a loop, m / l / acc in registers. Any Sq and Skv:
// the ragged query tile is zero-filled and not written back, and keys past
// Skv score -inf, so they weigh exactly 0 (with q_offset >= 0 key 0 is
// visible to every row, so m is finite after the first tile and no NaN
// forms). Causal kv tiles wholly above the diagonal are skipped; query tiles
// run longest first (blockIdx.x reversed).
//
// Two kernels, one contract:
// * flash_fwd_mma (bfloat16 — the serving path): the products on the tensor
//   cores through mma.sync.m16n8k16 with float32 accumulation; see its note
//   below. It takes the head dims of the configs (32, 64, 112, 128) and
//   16-byte aligned operands; any other bf16 call returns
//   cudaErrorInvalidValue.
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
// least time is set by operations (4 * B * H * D * visible pairs at the
// tensor cores' 989 TFLOP/s), not by bytes. Neither kernel pipelines its
// loads (no cp.async / TMA) nor uses wgmma: they are the simple, exact forms,
// and their distance from the bound is in PERF.md.
//
// Plain C interface (bound with ctypes): flash_attention_f32 /
// flash_attention_bf16 return the cudaError_t of the launch. Nothing is
// allocated and nothing synchronises here. Compile without fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

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
// bfloat16 on the tensor cores: mma.sync.m16n8k16 (bf16 in, float32 out).
// One block of 4 warps owns a 64-row query tile; warp w owns rows
// 16 w .. 16 w + 15 and keeps its q fragments in registers for the whole
// walk. A kv tile of 64 keys is staged in shared memory as raw bf16 (rows
// padded by 8 elements, so the fragment loads hit 32 distinct banks). The
// score fragments of q.k become, after the online-softmax update, the A
// fragments of P.V directly (rounded to bf16 as the reference rounds p), so
// P never leaves registers. One instance per head dim of the configs.
// Fragment layouts (PTX ISA, mma.m16n8k16, g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                           a3 = (g+8, 2t+8..)
//   B (16 x 8, k-major):    b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16 x 8):             c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// The lower-indexed element of each pair sits in the low 16 bits.
// ---------------------------------------------------------------------------
constexpr int MMA_BQ = 64;
constexpr int MMA_BK = 64;
constexpr int MMA_THREADS = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq,
              int Skv, int H, int KVH, int causal, int64_t q_offset, float scale) {
  constexpr int KP = D + 8;          // padded row pitch (elements) of the kv tiles
  constexpr int QK_STEPS = D / 16;   // k-steps of q.k
  constexpr int S_TILES = MMA_BK / 8;
  constexpr int PV_STEPS = MMA_BK / 16;
  constexpr int O_TILES = D / 8;
  constexpr int CHUNKS = D / 8;      // 16-byte chunks per kv row
  __shared__ __align__(16) uint16_t ks[MMA_BK * KP];
  __shared__ __align__(16) uint16_t vs[MMA_BK * KP];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);

  const int64_t q_pitch = (int64_t)H * D;
  const int64_t kv_pitch = (int64_t)KVH * D;
  const uint16_t* qb = reinterpret_cast<const uint16_t*>(q) + (int64_t)b * Sq * q_pitch +
                       (int64_t)h * D;
  uint16_t* ob = reinterpret_cast<uint16_t*>(o) + (int64_t)b * Sq * q_pitch + (int64_t)h * D;
  const uint16_t* kb = reinterpret_cast<const uint16_t*>(k) + (int64_t)b * Skv * kv_pitch +
                       (int64_t)kvh * D;
  const uint16_t* vb = reinterpret_cast<const uint16_t*>(v) + (int64_t)b * Skv * kv_pitch +
                       (int64_t)kvh * D;

  // this thread's two query rows, and their q fragments
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[QK_STEPS][4];
#pragma unroll
  for (int kk = 0; kk < QK_STEPS; ++kk) {
    const int c = 16 * kk + 2 * t;
    qa[kk][0] = r0 < Sq ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_pitch + c) : 0u;
    qa[kk][1] = r1 < Sq ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_pitch + c) : 0u;
    qa[kk][2] = r0 < Sq ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_pitch + c + 8) : 0u;
    qa[kk][3] = r1 < Sq ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_pitch + c + 8) : 0u;
  }

  float oacc[O_TILES][4];
#pragma unroll
  for (int n = 0; n < O_TILES; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  const int64_t qp0 = q_offset + r0, qp1 = q_offset + r1;

  int64_t kv_end = Skv;
  if (causal && q_offset + q0 + MMA_BQ < kv_end) kv_end = q_offset + q0 + MMA_BQ;
  const int n_tiles = (int)((kv_end + MMA_BK - 1) / MMA_BK);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * MMA_BK;
    __syncthreads();  // the previous tile's ks / vs are consumed
    for (int e = tid; e < MMA_BK * CHUNKS; e += MMA_THREADS) {
      const int r = e / CHUNKS, c = (e - r * CHUNKS) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < Skv) {
        const int64_t off = (int64_t)(k0 + r) * kv_pitch + c;
        kv = *reinterpret_cast<const uint4*>(kb + off);
        vv = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(ks + r * KP + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * KP + c) = vv;
    }
    __syncthreads();

    // s = q . k^T for this warp's 16 rows and the tile's 64 keys
    float s[S_TILES][4];
#pragma unroll
    for (int j = 0; j < S_TILES; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < QK_STEPS; ++kk) {
#pragma unroll
      for (int j = 0; j < S_TILES; ++j) {
        const uint16_t* kr = ks + (8 * j + g) * KP + 16 * kk + 2 * t;
        mma_bf16(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, mask, online softmax (rows r0: elements 0, 1; r1: elements 2, 3)
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < S_TILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        float sv = s[j][e] * scale;
        if (col >= Skv) sv = -CUDART_INF_F;
        else if (causal && (e < 2 ? qp0 : qp1) < col) sv = NEG_INF;
        s[j][e] = sv;
        if (e < 2) mx0 = fmaxf(mx0, sv);
        else mx1 = fmaxf(mx1, sv);
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);  // 0 on the first tile
    float rs0 = 0.f, rs1 = 0.f;
    uint32_t pa[PV_STEPS][4];
#pragma unroll
    for (int j = 0; j < S_TILES; ++j) {
      const float p0 = expf(s[j][0] - mn0), p1 = expf(s[j][1] - mn0);
      const float p2 = expf(s[j][2] - mn1), p3 = expf(s[j][3] - mn1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);      // row g:   a0 / a2
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);  // row g+8: a1 / a3
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, o_);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, o_);
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < O_TILES; ++n) {
      oacc[n][0] *= al0;
      oacc[n][1] *= al0;
      oacc[n][2] *= al1;
      oacc[n][3] *= al1;
    }

    // o += p . v
#pragma unroll
    for (int kk = 0; kk < PV_STEPS; ++kk) {
      const uint16_t* v0 = vs + (16 * kk + 2 * t) * KP + g;
#pragma unroll
      for (int n = 0; n < O_TILES; ++n) {
        const uint16_t* vn = v0 + 8 * n;
        mma_bf16(oacc[n], pa[kk], pack_raw(vn[0], vn[KP]), pack_raw(vn[8 * KP], vn[9 * KP]));
      }
    }
  }

#pragma unroll
  for (int n = 0; n < O_TILES; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_pitch + c) =
          pack_bf16(oacc[n][0] / l0, oacc[n][1] / l0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_pitch + c) =
          pack_bf16(oacc[n][2] / l1, oacc[n][3] / l1);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// shapes either kernel takes (int indices, grid.y <= 65535)
bool valid(int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KVH, int64_t D,
           int64_t q_offset) {
  return B >= 1 && Sq >= 1 && Skv >= 1 && H >= 1 && KVH >= 1 && H % KVH == 0 && D >= 1 &&
         D <= D_MAX && q_offset >= 0 && B * H <= 65535 && Sq <= 0x7fffffffLL - MMA_BQ &&
         Skv <= 0x7fffffffLL - MMA_BK;
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
               int64_t Skv, int64_t H, int64_t KVH, int causal, int64_t q_offset, float scale,
               cudaStream_t stream) {
  const dim3 grid((unsigned)((Sq + MMA_BQ - 1) / MMA_BQ), (unsigned)(B * H));
  flash_fwd_mma<D><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), (int)Sq, (int)Skv,
      (int)H, (int)KVH, causal, q_offset, scale);
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
    case 32: return launch_mma<32>(q, k, v, o, B, Sq, Skv, H, KVH, causal, q_offset, scale, st);
    case 64: return launch_mma<64>(q, k, v, o, B, Sq, Skv, H, KVH, causal, q_offset, scale, st);
    case 112: return launch_mma<112>(q, k, v, o, B, Sq, Skv, H, KVH, causal, q_offset, scale, st);
    case 128: return launch_mma<128>(q, k, v, o, B, Sq, Skv, H, KVH, causal, q_offset, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int64_t flash_attention_max_head_dim() { return D_MAX; }

}  // extern "C"
