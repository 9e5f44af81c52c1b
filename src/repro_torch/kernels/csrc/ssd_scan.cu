// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel (called
// by ssd_scan), and holds to the contract of the plain version
// (repro_torch.kernels.ref.ssd_scan), initial state included.
//
//   x (b, s, h, p), dt (b, s, h) float32, A, D (h,) float32,
//   B, C (b, s, g, n) of x's type, h % g == 0, s % chunk == 0,
//   initial state (b, h, p, n) float32 or none (zeros)
//   -> y (b, s, h, p) in x's type, final state (b, h, p, n) float32.
//
// Per (batch, head) and chunk, with the (n, p) state entering the chunk:
//     cum     = cumsum(A dt)                            (within the chunk)
//     y_intra = ((C B^T) * exp(cum_i - cum_j)[j <= i] * dt_j) x
//     y_inter = exp(cum_i) * (C_i . state)
//     y       = round_T((y_intra + y_inter) + D x)      (rounded once)
//     state  <- state exp(cum_last) + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
// Every product of the TPU kernel's body is here: C B^T, M x, C . state and
// the state update, with the cumsum and the decays. The wrapper only
// allocates the outputs (and the wgmma instance's scratch).
//
// Two instances, one contract:
// * ssd_chunk_scan_wgmma and its two companions (bfloat16, p = 64,
//   n in {64, 128}, chunk % 64 == 0: every config's heads), the SSD block
//   decomposition on the tensor cores; see its note below.
// * ssd_chunk_scan, the general instance (float32, and any p <= 64,
//   n <= 128 with n % 4 == 0), described next.
//
// The general instance. The TPU keeps the state in VMEM across a sequential
// grid axis; here one block of 256 threads owns one (batch, head) and walks
// the chunks itself.
// A 256 x 256 float32 score tile (256 KB) does not fit a block's 227 KB of
// shared memory, so the chunk is cut into 64-row query tiles, each against the
// key tiles at or below it (the upper triangle is never computed, and exp is
// never taken where j > i: at A dt ~ -11 a step the masked region would
// overflow). Every query tile of a chunk reads the state entering the chunk;
// the state is updated only after the last one is written. Each thread owns a
// 4 x 4 micro-tile of a 64 x 64 tile (rows ty + 16 r, columns tx + 16 c); the
// C and B tiles sit in shared memory as float rows padded by 4 (conflict-free
// 16-byte reads along n). B and C are read by group in place, never repeated
// per head.
//
// Bound by operations on the CUDA cores: about 21 GFLOP (float32, 67
// TFLOP/s) at the serving path's (4, 2048, 32, 64), n = 128, chunk 256,
// against 77 MB of traffic (0.023 ms at 3.35 TB/s). This version is simple:
// one block per SM at the path shape (137 KB of shared memory), the products
// from shared memory on the CUDA cores, B reloaded from L2 for every query
// tile, and only b * h blocks (32 at batch 1).
//
// The within-chunk cumsum is summed in double and rounded to float once, as
// the plain version does: the sums reach about -2,800 inside a chunk, where a
// float32 sum in another order would move the decays by 2.4e-4. expf is IEEE
// (no fast-math).
//
// Plain C interface (bound with ctypes): ssd_scan_f32 / ssd_scan_bf16 (the
// general instance) and ssd_scan_bf16_wgmma return the cudaError_t of the
// launch. Nothing is allocated and nothing synchronises here.

#include "hopper.cuh"          // mbarriers, TMA, wgmma, tensor maps

namespace {

constexpr int TILE = 64;        // rows of a query or key tile
constexpr int THREADS = 256;    // 16 x 16, each a 4 x 4 micro-tile of 64 x 64
constexpr int MAX_P = 64;       // columns of x a block holds (4 x 16)
constexpr int MAX_N = 128;      // state rows a block updates (8 x 16)
constexpr int PAD = 4;          // row padding of the B, C and M tiles
constexpr int64_t MAX_SMEM = 232448;   // a Hopper block's opt-in shared memory

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float lane(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// TILE rows of `width` elements (row r at src + r * stride) into dst (pitch
// `pitch`), as float; rows from `rows` on are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const T* src, int64_t stride,
                                          int rows, int width) {
  for (int i = threadIdx.x; i < TILE * width; i += THREADS) {
    const int r = i / width, k = i - r * width;
    dst[r * pitch + k] = r < rows ? to_f(src[r * stride + k]) : 0.f;
  }
}

// cum[i] = sum_{j <= i} a dt[j] for i < len, by one warp: each lane sums a run
// of consecutive steps, the lanes' totals are scanned by shuffles. In double,
// where these sums are exact to far below float precision, so the order does
// not show after the one rounding to float.
__device__ void chunk_cumsum(const float* dts, float* cum, float a, int len, int ln) {
  const int per = (len + 31) / 32;
  const int lo = min(ln * per, len), hi = min(lo + per, len);
  double local = 0.0;
  for (int i = lo; i < hi; ++i) local += (double)(a * dts[i]);
  double incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (ln >= o) incl += v;
  }
  double run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (ln == 0) run = 0.0;
  for (int i = lo; i < hi; ++i) {
    run += (double)(a * dts[i]);
    cum[i] = (float)run;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ B,
               const T* __restrict__ C, const float* __restrict__ D,
               const float* __restrict__ init, T* __restrict__ y,
               float* __restrict__ final_state, int64_t s, int h, int p, int g, int n,
               int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t bb = blockIdx.x / h;
  const int hh = blockIdx.x % h;
  const int gi = hh / (h / g);
  const int np = n * p, nld = n + PAD, mld = TILE + PAD;
  float* st = smem;                   // [n][p]  state entering the chunk
  float* cs = st + np;                // [TILE][nld]  C rows of the query tile
  float* bs = cs + TILE * nld;        // [TILE][nld]  B rows of the key tile
  float* xs = bs + TILE * nld;        // [TILE][p]    x rows of the key tile
  float* ms = xs + TILE * p;          // [TILE][mld]  M of (query, key) tile
  float* cum = ms + TILE * mld;       // [chunk]
  float* dts = cum + chunk;           // [chunk]
  float* tail = dts + chunk;          // [chunk]  exp(cum_last - cum_j) dt_j

  const float a = A[hh], dskip = D[hh];
  const int64_t xrow = (int64_t)h * p, bcrow = (int64_t)g * n;   // one time step
  const T* xh = x + bb * s * xrow + (int64_t)hh * p;
  T* yh = y + bb * s * xrow + (int64_t)hh * p;
  const T* Bg = B + bb * s * bcrow + (int64_t)gi * n;
  const T* Cg = C + bb * s * bcrow + (int64_t)gi * n;
  const float* dth = dt + bb * s * h + hh;

  int col[4];                         // this thread's columns of x / y / state,
#pragma unroll                        // clamped into range (results masked)
  for (int c = 0; c < 4; ++c) col[c] = min(tx + 16 * c, p - 1);

  const float* ini = init ? init + (bb * h + hh) * (int64_t)np : nullptr;
  for (int i = tid; i < np; i += THREADS) {        // (p, n) in memory -> [n][p]
    const int pp = i / n, k = i - pp * n;
    st[k * p + pp] = ini ? ini[i] : 0.f;
  }

  const int nchunks = (int)(s / chunk);
  const int ntiles = (chunk + TILE - 1) / TILE;
  for (int c = 0; c < nchunks; ++c) {
    const int64_t t0 = (int64_t)c * chunk;
    __syncthreads();                  // the previous chunk's state is written
    for (int i = tid; i < chunk; i += THREADS) dts[i] = dth[(t0 + i) * h];
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, cum, a, chunk, tid);
    __syncthreads();
    const float cum_last = cum[chunk - 1];
    for (int i = tid; i < chunk; i += THREADS) tail[i] = expf(cum_last - cum[i]) * dts[i];

    for (int qt = 0; qt < ntiles; ++qt) {
      const int q0 = qt * TILE;
      load_rows(cs, nld, Cg + (t0 + q0) * bcrow, bcrow, min(TILE, chunk - q0), n);
      __syncthreads();

      // y_inter = exp(cum_i) * (C_i . state), the state entering the chunk
      float yi[4][4] = {}, acc[4][4] = {};
      for (int k = 0; k < n; k += 4) {
        float4 cr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cr[r] = ld4(cs + (ty + 16 * r) * nld + k);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float sv[4];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) sv[cc] = st[(k + u) * p + col[cc]];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) yi[r][cc] += lane(cr[r], u) * sv[cc];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = q0 + ty + 16 * r;
        const float e = i < chunk ? expf(cum[i]) : 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) yi[r][cc] *= e;
      }

      // y_intra over the key tiles at or below this query tile
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * TILE;
        const int krows = min(TILE, chunk - k0);
        load_rows(bs, nld, Bg + (t0 + k0) * bcrow, bcrow, krows, n);
        load_rows(xs, p, xh + (t0 + k0) * xrow, xrow, krows, p);
        __syncthreads();
        float sc[4][4] = {};
        for (int k = 0; k < n; k += 4) {
          float4 cr[4], br[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cr[r] = ld4(cs + (ty + 16 * r) * nld + k);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) br[cc] = ld4(bs + (tx + 16 * cc) * nld + k);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              sc[r][cc] += cr[r].x * br[cc].x;
              sc[r][cc] += cr[r].y * br[cc].y;
              sc[r][cc] += cr[r].z * br[cc].z;
              sc[r][cc] += cr[r].w * br[cc].w;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = q0 + ty + 16 * r;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int j = k0 + tx + 16 * cc;
            float m = 0.f;
            if (j <= i && i < chunk) m = sc[r][cc] * expf(cum[i] - cum[j]) * dts[j];
            ms[(ty + 16 * r) * mld + tx + 16 * cc] = m;
          }
        }
        __syncthreads();
        for (int jj = 0; jj < TILE; jj += 4) {
          float4 mr[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) mr[r] = ld4(ms + (ty + 16 * r) * mld + jj);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float xv[4];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) xv[cc] = xs[(jj + u) * p + col[cc]];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) acc[r][cc] += lane(mr[r], u) * xv[cc];
            }
          }
        }
        __syncthreads();              // bs / xs / ms are consumed
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = q0 + ty + 16 * r;
        if (i >= chunk) continue;
        const int64_t off = (t0 + i) * xrow;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int cl = tx + 16 * cc;
          if (cl >= p) continue;
          const float xv = to_f(xh[off + cl]);
          yh[off + cl] = from_f<T>((acc[r][cc] + yi[r][cc]) + dskip * xv);
        }
      }
    }

    // state <- state exp(cum_last) + sum_j tail_j B_j x_j^T, after every query
    // tile of the chunk has read the entering state
    float up[8][4] = {};
    for (int kt = 0; kt < ntiles; ++kt) {
      const int k0 = kt * TILE;
      const int krows = min(TILE, chunk - k0);
      __syncthreads();
      load_rows(bs, nld, Bg + (t0 + k0) * bcrow, bcrow, krows, n);
      load_rows(xs, p, xh + (t0 + k0) * xrow, xrow, krows, p);
      __syncthreads();
      for (int jj = 0; jj < krows; ++jj) {
        const float w = tail[k0 + jj];
        float xv[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) xv[cc] = xs[jj * p + col[cc]];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float bv = bs[jj * nld + min(ty + 16 * r, n - 1)] * w;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) up[r][cc] += bv * xv[cc];
        }
      }
    }
    const float dec = expf(cum_last);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int k = ty + 16 * r;
      if (k >= n) continue;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int cl = tx + 16 * cc;
        if (cl < p) st[k * p + cl] = st[k * p + cl] * dec + up[r][cc];
      }
    }
  }

  __syncthreads();
  float* fs = final_state + (bb * h + hh) * (int64_t)np;
  for (int i = tid; i < np; i += THREADS) {        // [n][p] -> (p, n) in memory
    const int pp = i / n, k = i - pp * n;
    fs[i] = st[k * p + pp];
  }
}

int64_t smem_bytes(int64_t p, int64_t n, int64_t chunk) {
  return (n * p + 2 * TILE * (n + PAD) + TILE * p + TILE * (TILE + PAD) + 3 * chunk) *
         (int64_t)sizeof(float);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
           const void* D, const void* init, void* y, void* final_state, int64_t b,
           int64_t s, int64_t h, int64_t p, int64_t g, int64_t n, int64_t chunk,
           cudaStream_t stream) {
  if (b < 1 || s < 1 || h < 1 || p < 1 || g < 1 || n < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  if (s % chunk || h % g || p > MAX_P || n > MAX_N || n % 4 || b * h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = smem_bytes(p, n, chunk);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan<T><<<(unsigned)(b * h), THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(D), static_cast<const float*>(init), static_cast<T*>(y),
      static_cast<float*>(final_state), s, (int)h, (int)p, (int)g, (int)n, (int)chunk);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16 on Hopper's tensor cores: the SSD block decomposition
// (arXiv:2405.21060, section 6) in three launches on the stream, with
// scratch the wrapper allocates: `cd` (b, h, s, 2) float32, the within-chunk
// cumsum beside dt of each step; `states` (b, h, nc, n, p) float32, the
// chunk states; `hin` (b, h, nc, n / 64, 2, 64, 64) bf16, the state entering
// each chunk as hi and lo tiles in the layout wgmma reads (nc = s / chunk).
// Operand tiles are 64 rows of 64 bf16 (128-byte rows, 128-byte swizzle),
// loaded by TMA through 4-D maps over (columns, heads or groups, steps,
// batch): B and C are read by group in place.
//
// 1. ssd_chunk_state, grid (b h, nc), a warpgroup per 64 state rows: the
//    chunk's cumsum (double, rounded to float once, as above) into cd, then
//    S_c = B^T (tail * x), tail_j = exp(cum_last - cum_j) dt_j, over the
//    chunk's 64-step sub-tiles in a two-stage TMA ring. B^T is wgmma's A
//    operand, read MN-major from B's own tile.
// 2. ssd_state_pass, grid (b h, n p / 1024), four state elements a thread:
//    hin[c] = H, then H <- exp(cum_last,c) H + S_c; the last H is the final
//    state. Elementwise, bound by bytes.
// 3. ssd_chunk_scan_wgmma, grid (b h, nc, chunk / 64), one warpgroup per
//    64-row query tile, longest tiles first. C and hin[c] arrive by one
//    barrier (hin by a plain bulk copy) while key tile 0 loads:
//    O = exp(cum_i) (C . H_in); then for every 64-key tile at or below the
//    diagonal (a two-stage ring), S = C B^T with both K-major,
//    M = S exp(cum_i - cum_j) dt_j for j <= i (exp never taken above the
//    diagonal, where it would overflow), O += M x with M from registers (as
//    P in flash_attention.cu) and x MN-major; y = round(O + D x) once.
//    75 KB of shared memory and 152 registers: three blocks an SM.
//
// Accuracy. C B^T multiplies bf16 inputs: exact products, float32 sums. The
// products with a float32 operand (tail * x, H_in and M) split it into
// hi = bf16(v) and lo = bf16(v - hi) and run both into one accumulator, an
// error of at most 2^-16 of each term. (Rounding M to bf16 once, as Mamba2's
// own kernels do, costs 2^-9 of each term, far above the tolerance where y is
// small.)
//
// Bound by bytes on the tensor cores: at the path shape 13.3 GFLOP take
// 0.013 ms at 989 TFLOP/s, the 77 MB that must move 0.023 ms. The scratch
// adds 33.5 MB of chunk states written and read once, and 33.5 MB of
// entering states written once and read by each of a chunk's query tiles.
// On an H100 the three launches take 0.04, 0.03 and 0.13 ms there
// (chip_smoke.py, PERF.md); chunk_scan is held back by filling shared
// memory (C, H_in and the key tiles, ~108 KB a block, mostly from L2) and by
// the latency of each tile's two dependent products. Two variants ran
// slower and were dropped: issuing the next tile's S with the current M x
// (ptxas then fences the in-flight register operands, C7519), and two
// warpgroups a block sharing H_in and the key tiles (37 % fewer bytes, but
// the warpgroups wait on each other at every tile).
// ---------------------------------------------------------------------------
constexpr int WROWS = 64;                 // rows of every tile: steps, or state rows
constexpr int WP = 64;                    // the head dim this instance takes
constexpr int ROWB = 128;                 // bytes of a tile row: 64 bf16
constexpr int TILE_B = WROWS * ROWB;      // one 64 x 64 bf16 tile, one TMA box
constexpr int WG = 128;                   // threads of a warpgroup
constexpr int PASS_THREADS = 256;

template <int N>
struct StatePlan {                        // ssd_chunk_state's shared memory
  static constexpr int NB = N / 64;                       // 64-column boxes of a B tile
  static constexpr int THREADS = WG * NB;                 // a warpgroup per 64 state rows
  static constexpr int STAGE = NB * TILE_B + 2 * TILE_B;  // B, x (then hi), lo
  static constexpr int TILES = 2 * STAGE;
  static int64_t smem(int64_t L) { return 1024 + TILES + 3 * L * 4 + 2 * 8; }
};

template <int N>
struct ScanPlan {                         // ssd_chunk_scan_wgmma's shared memory
  static constexpr int NB = N / 64;
  static constexpr int C_BYTES = NB * TILE_B;             // C of the query tile
  static constexpr int STAGE = NB * TILE_B + TILE_B;      // B and x of a key tile
  static constexpr int H_BYTES = NB * 2 * TILE_B;         // H_in, hi and lo
  static constexpr int SECOND = STAGE > H_BYTES ? STAGE : H_BYTES;   // H_in, then stage 1
  static constexpr int SMEM = 1024 + C_BYTES + STAGE + SECOND + 3 * 8;
};

// hi = bf16(a), bf16(b) and lo = bf16 of what they leave, as packed pairs
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack_bf16(a - h.x, b - h.y);
}

// w times the 8 bf16 of `in`, split into hi and lo
__device__ __forceinline__ void split8(const uint4& in, float w, uint4& hi, uint4& lo) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&in);
  uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
  uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(v[i]);
    split2(f.x * w, f.y * w, h[i], l[i]);
  }
}

template <int N>
__global__ void __launch_bounds__(StatePlan<N>::THREADS)
ssd_chunk_state(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap bmap,
                const float* __restrict__ dt, const float* __restrict__ A,
                float* __restrict__ cd, float* __restrict__ states, int64_t s, int h, int g,
                int L) {
  using P = StatePlan<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = align1024(smem_raw);   // [2][B (NB boxes) | x, then hi | lo]
  float* dts = reinterpret_cast<float*>(tiles + P::TILES);
  float* cum = dts + L;
  float* tail = cum + L;
  uint64_t* full = reinterpret_cast<uint64_t*>(tail + L);

  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int bb = bh / h, hh = bh % h, gi = hh / (h / g);
  const int t0 = c * L, nsub = L / WROWS;

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int u) {               // sub-tile u (B, x) into stage u % 2
    uint8_t* st = tiles + (u & 1) * P::STAGE;
    uint64_t* bar = &full[u & 1];
    mbar_expect_tx(bar, (P::NB + 1) * TILE_B);
#pragma unroll
    for (int x = 0; x < P::NB; ++x)
      tma_load(st + x * TILE_B, &bmap, bar, x * 64, gi, t0 + u * WROWS, bb);
    tma_load(st + P::NB * TILE_B, &xmap, bar, 0, hh, t0 + u * WROWS, bb);
  };
  if (tid == 0) {
    prefetch_map(&xmap);
    prefetch_map(&bmap);
    issue(0);
    if (nsub > 1) issue(1);
  }

  const float* dth = dt + ((int64_t)bb * s + t0) * h + hh;
  for (int i = tid; i < L; i += P::THREADS) dts[i] = dth[(int64_t)i * h];
  __syncthreads();
  if (warp == 0) chunk_cumsum(dts, cum, A[hh], L, ln);
  __syncthreads();
  const float cum_last = cum[L - 1];
  float2* cdg = reinterpret_cast<float2*>(cd) + (int64_t)bh * s + t0;
  for (int i = tid; i < L; i += P::THREADS) {
    cdg[i] = make_float2(cum[i], dts[i]);
    tail[i] = expf(cum_last - cum[i]) * dts[i];
  }
  __syncthreads();

  // S_c (n x p) += B^T (n x 64 steps) . (tail x) (64 steps x p), hi and lo
  const int wg = warp >> 2;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int u = 0; u < nsub; ++u) {
    uint8_t* st = tiles + (u & 1) * P::STAGE;
    uint8_t* xs = st + P::NB * TILE_B;
    uint8_t* lo = xs + TILE_B;
    mbar_wait(&full[u & 1], (u >> 1) & 1);
    // the swizzle permutes 16-byte chunks within a 128-byte row, so chunk q
    // is in step q / 8 wherever it sits, and hi / lo keep x's layout
    for (int q = tid; q < TILE_B / 16; q += P::THREADS) {
      uint4 hi4, lo4;
      split8(*reinterpret_cast<const uint4*>(xs + 16 * q), tail[u * WROWS + (q >> 3)], hi4, lo4);
      *reinterpret_cast<uint4*>(xs + 16 * q) = hi4;
      *reinterpret_cast<uint4*>(lo + 16 * q) = lo4;
    }
    fence_proxy_async();
    __syncthreads();
    fence_regs(acc);
    wgmma_fence();
    const uint32_t a_base = smem_addr(st) + wg * TILE_B;
    const uint32_t h_base = smem_addr(xs), l_base = smem_addr(lo);
#pragma unroll
    for (int kk = 0; kk < WROWS / 16; ++kk) {
      const uint64_t da = gmma_desc(a_base + kk * 16 * ROWB, TILE_B, 8 * ROWB, 1);
      wgmma_ss_n64<1, 1>(acc, da, gmma_desc(h_base + kk * 16 * ROWB, TILE_B, 8 * ROWB, 1), 1);
      wgmma_ss_n64<1, 1>(acc, da, gmma_desc(l_base + kk * 16 * ROWB, TILE_B, 8 * ROWB, 1), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();                      // every warpgroup is done with the stage
    if (tid == 0 && u + 2 < nsub) issue(u + 2);
  }

  float* out = states + ((int64_t)bh * nc + c) * (N * WP);
  const int r0 = wg * 64 + (warp & 3) * 16 + (ln >> 2), tq = ln & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(out + r0 * WP + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (r0 + 8) * WP + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass(const float* __restrict__ states, const float* __restrict__ cd,
               const float* __restrict__ init, uint8_t* __restrict__ hin,
               float* __restrict__ final_state, int64_t s, int n, int L, int nc) {
  const int64_t bh = blockIdx.x;
  const int np = n * WP;
  const int e = (blockIdx.y * PASS_THREADS + threadIdx.x) * 4;   // state row k, columns pp..pp+3
  if (e >= np) return;
  const int k = e / WP, pp = e % WP, r = k % WROWS;
  float4 H = make_float4(0.f, 0.f, 0.f, 0.f);
  if (init) {                             // (p, n) in memory
    const float* ip = init + bh * np + k;
    H = make_float4(ip[pp * n], ip[(pp + 1) * n], ip[(pp + 2) * n], ip[(pp + 3) * n]);
  }
  const float4* sp = reinterpret_cast<const float4*>(states + bh * nc * np + e);
  const int64_t stride = np / 4;          // one chunk's states, in float4
  // this thread's 4 bf16 in the hi tile of its 64 state rows (lo: one tile on)
  uint8_t* hp = hin + (bh * nc * (n / WROWS) + k / WROWS) * (2 * TILE_B) + r * ROWB +
                (((pp >> 3) ^ (r & 7)) << 4) + (pp & 7) * 2;
  const int64_t hstride = (int64_t)(n / WROWS) * 2 * TILE_B;   // one chunk's hi / lo tiles
  const float* last = cd + (bh * s + (L - 1)) * 2;
  float4 next = sp[0];
  for (int c = 0; c < nc; ++c) {
    const float4 up = next;
    if (c + 1 < nc) next = sp[(c + 1) * stride];
    const float dec = expf(last[(int64_t)c * L * 2]);
    uint2 hi, lo;
    split2(H.x, H.y, hi.x, lo.x);
    split2(H.z, H.w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(hp + c * hstride) = hi;
    *reinterpret_cast<uint2*>(hp + c * hstride + TILE_B) = lo;
    H = make_float4(H.x * dec + up.x, H.y * dec + up.y, H.z * dec + up.z, H.w * dec + up.w);
  }
  float* fp = final_state + bh * np + k;
  fp[pp * n] = H.x;
  fp[(pp + 1) * n] = H.y;
  fp[(pp + 2) * n] = H.z;
  fp[(pp + 3) * n] = H.w;
}

template <int N>
__global__ void __launch_bounds__(WG)
ssd_chunk_scan_wgmma(const __grid_constant__ CUtensorMap cmap,
                     const __grid_constant__ CUtensorMap bmap,
                     const __grid_constant__ CUtensorMap xmap, const float* __restrict__ cd,
                     const uint8_t* __restrict__ hin, const float* __restrict__ D,
                     __nv_bfloat16* __restrict__ y, int64_t s, int h, int g, int L) {
  using P = ScanPlan<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* cs = align1024(smem_raw);      // C of the query tile (NB boxes)
  uint8_t* st0 = cs + P::C_BYTES;         // stage 0: B (NB boxes), x of a key tile
  uint8_t* st1 = st0 + P::STAGE;          // H_in (hi, lo per 64 rows); then stage 1
  uint64_t* bars = reinterpret_cast<uint64_t*>(st1 + P::SECOND);   // C and H_in, stages

  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31, tq = ln & 3;
  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int bb = bh / h, hh = bh % h, gi = hh / (h / g);
  const int t0 = c * L, q0 = qt * WROWS, ntiles = qt + 1;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int t) {               // key tile t (B, x) into stage t % 2
    uint8_t* st = (t & 1) ? st1 : st0;
    uint64_t* bar = &bars[1 + (t & 1)];
    mbar_expect_tx(bar, P::STAGE);
#pragma unroll
    for (int x = 0; x < P::NB; ++x)
      tma_load(st + x * TILE_B, &bmap, bar, x * 64, gi, t0 + t * WROWS, bb);
    tma_load(st + P::NB * TILE_B, &xmap, bar, 0, hh, t0 + t * WROWS, bb);
  };
  if (tid == 0) {
    prefetch_map(&cmap);
    prefetch_map(&bmap);
    prefetch_map(&xmap);
    mbar_expect_tx(&bars[0], P::C_BYTES + P::H_BYTES);
#pragma unroll
    for (int x = 0; x < P::NB; ++x)
      tma_load(cs + x * TILE_B, &cmap, &bars[0], x * 64, gi, t0 + q0, bb);
    bulk_load(st1, hin + ((int64_t)bh * nc + c) * P::H_BYTES, P::H_BYTES, &bars[0]);
    issue(0);
  }

  // this thread's rows r_lo, r_lo + 8 of the tile; (cum, dt) pairs of the chunk
  const int r_lo = warp * 16 + (ln >> 2), i0 = q0 + r_lo, i1 = i0 + 8;
  const float2* cdc = reinterpret_cast<const float2*>(cd) + (int64_t)bh * s + t0;
  const float ci0 = cdc[i0].x, ci1 = cdc[i1].x;

  // O = exp(cum_i) (C . H_in): A = C (K-major), B = H_in hi and lo (MN-major)
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  const uint32_t c_base = smem_addr(cs), h_base = smem_addr(st1);
  mbar_wait(&bars[0], 0);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t hb = h_base + (kk >> 2) * 2 * TILE_B + (kk & 3) * 16 * ROWB;
    const uint64_t da = gmma_desc(c_base + (kk >> 2) * TILE_B + (kk & 3) * 32, 16, 8 * ROWB, 1);
    wgmma_ss_n64<0, 1>(o, da, gmma_desc(hb, TILE_B, 8 * ROWB, 1), 1);
    wgmma_ss_n64<0, 1>(o, da, gmma_desc(hb + TILE_B, TILE_B, 8 * ROWB, 1), 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j] *= e0;
    o[4 * j + 1] *= e0;
    o[4 * j + 2] *= e1;
    o[4 * j + 3] *= e1;
  }
  __syncthreads();                        // st1 is free for key tile 1
  if (tid == 0 && ntiles > 1) issue(1);

  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const uint32_t b_base = smem_addr((t & 1) ? st1 : st0);
    const uint32_t x_base = b_base + P::NB * TILE_B;
    const int k0 = t * WROWS;
    float4 kd[8];                         // (cum, dt) of this thread's key pairs
#pragma unroll
    for (int j = 0; j < 8; ++j) kd[j] = *reinterpret_cast<const float4*>(cdc + k0 + 8 * j + 2 * tq);
    mbar_wait(&bars[1 + (t & 1)], (t >> 1) & 1);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t off = (kk >> 2) * TILE_B + (kk & 3) * 32;
      wgmma_ss_n64<0, 0>(sc, gmma_desc(c_base + off, 16, 8 * ROWB, 1),
                         gmma_desc(b_base + off, 16, 8 * ROWB, 1), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // M = S exp(cum_i - cum_j) dt_j where j <= i, as bf16 hi / lo A fragments
    const bool diag = t == qt;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kj = k0 + 8 * j + 2 * tq;
      const float cj0 = kd[j].x, d0 = kd[j].y, cj1 = kd[j].z, d1 = kd[j].w;
      const float m0 = (!diag || kj <= i0) ? sc[4 * j] * expf(ci0 - cj0) * d0 : 0.f;
      const float m1 = (!diag || kj + 1 <= i0) ? sc[4 * j + 1] * expf(ci0 - cj1) * d1 : 0.f;
      const float m2 = (!diag || kj <= i1) ? sc[4 * j + 2] * expf(ci1 - cj0) * d0 : 0.f;
      const float m3 = (!diag || kj + 1 <= i1) ? sc[4 * j + 3] * expf(ci1 - cj1) * d1 : 0.f;
      split2(m0, m1, ah[j / 2][(j & 1) * 2], al[j / 2][(j & 1) * 2]);            // row g
      split2(m2, m3, ah[j / 2][(j & 1) * 2 + 1], al[j / 2][(j & 1) * 2 + 1]);    // row g + 8
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = gmma_desc(x_base + kk * 16 * ROWB, TILE_B, 8 * ROWB, 1);
      wgmma_rs_n64(o, ah[kk], db);
      wgmma_rs_n64(o, al[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();                      // the stage is consumed
    if (tid == 0 && t + 2 < ntiles) issue(t + 2);
  }

  // y = round(O + D x) once; x of the query rows is the diagonal key tile's
  const uint8_t* xd = ((qt & 1) ? st1 : st0) + P::NB * TILE_B;
  const float dskip = D[hh];
  const int64_t yrow = (int64_t)h * WP;
  __nv_bfloat16* yq = y + (((int64_t)bb * s + t0 + q0) * h + hh) * WP;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r_lo + 8 * half;
      const int off = r * ROWB + col * 2;
      const uint32_t xv = *reinterpret_cast<const uint32_t*>(xd + (off ^ ((r & 7) << 4)));
      const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv));
      *reinterpret_cast<uint32_t*>(yq + r * yrow + col) =
          pack_bf16(o[4 * j + 2 * half] + dskip * xf.x, o[4 * j + 2 * half + 1] + dskip * xf.y);
    }
  }
}

template <int N>
int launch_wgmma(const void* x, const void* dt, const void* A, const void* B, const void* C,
                 const void* D, const void* init, void* y, void* final_state, void* cd,
                 void* states, void* hin, int64_t b, int64_t s, int64_t h, int64_t g,
                 int64_t chunk, cudaStream_t stream) {
  using SP = StatePlan<N>;
  using CP = ScanPlan<N>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap xm, bm, cm;
  if (!(tensor_map(encode, &xm, x, WP, h, s, b, 64, WROWS, sw) &&
        tensor_map(encode, &bm, B, N, g, s, b, 64, WROWS, sw) &&
        tensor_map(encode, &cm, C, N, g, s, b, 64, WROWS, sw)))
    return (int)cudaErrorInvalidValue;
  const int64_t nc = s / chunk, sm_state = SP::smem(chunk);
  if (sm_state > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_state);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_scan_wgmma<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, CP::SMEM);
  if (err != cudaSuccess) return (int)err;
  float* cdf = static_cast<float*>(cd);
  float* stf = static_cast<float*>(states);
  uint8_t* hinb = static_cast<uint8_t*>(hin);
  ssd_chunk_state<N><<<dim3((unsigned)(b * h), (unsigned)nc), SP::THREADS, (size_t)sm_state,
                       stream>>>(xm, bm, static_cast<const float*>(dt),
                                 static_cast<const float*>(A), cdf, stf, s, (int)h, (int)g,
                                 (int)chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_state_pass<<<dim3((unsigned)(b * h), (N * WP / 4 + PASS_THREADS - 1) / PASS_THREADS),
                   PASS_THREADS, 0, stream>>>(stf, cdf, static_cast<const float*>(init), hinb,
                                              static_cast<float*>(final_state), s, N,
                                              (int)chunk, (int)nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_chunk_scan_wgmma<N><<<dim3((unsigned)(b * h), (unsigned)nc, (unsigned)(chunk / WROWS)), WG,
                            CP::SMEM, stream>>>(cm, bm, xm, cdf, hinb,
                                                static_cast<const float*>(D),
                                                static_cast<__nv_bfloat16*>(y), s, (int)h,
                                                (int)g, (int)chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* B, const void* C,
                 const void* D, const void* init, void* y, void* final_state, int64_t b,
                 int64_t s, int64_t h, int64_t p, int64_t g, int64_t n, int64_t chunk,
                 void* stream) {
  return launch<float>(x, dt, A, B, C, D, init, y, final_state, b, s, h, p, g, n, chunk,
                       static_cast<cudaStream_t>(stream));
}

int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* B, const void* C,
                  const void* D, const void* init, void* y, void* final_state, int64_t b,
                  int64_t s, int64_t h, int64_t p, int64_t g, int64_t n, int64_t chunk,
                  void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, B, C, D, init, y, final_state, b, s, h, p, g, n,
                               chunk, static_cast<cudaStream_t>(stream));
}

// the wgmma instance; cd, states and hin are the caller's scratch (see
// the note above ssd_chunk_state), 16-byte aligned
int ssd_scan_bf16_wgmma(const void* x, const void* dt, const void* A, const void* B,
                        const void* C, const void* D, const void* init, void* y,
                        void* final_state, void* cd, void* states, void* hin, int64_t b,
                        int64_t s, int64_t h, int64_t p, int64_t g, int64_t n, int64_t chunk,
                        void* stream) {
  if (b < 1 || s < 1 || h < 1 || g < 1 || p != WP || chunk < WROWS || chunk % WROWS ||
      s % chunk || h % g || b * h > 0x7fffffffLL || s / chunk > 65535 ||
      s > 0x7fffffffLL - chunk)
    return (int)cudaErrorInvalidValue;
  if (!(aligned16(x) && aligned16(B) && aligned16(C) && aligned16(cd) && aligned16(states) &&
        aligned16(hin)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 64:
      return launch_wgmma<64>(x, dt, A, B, C, D, init, y, final_state, cd, states, hin, b, s, h,
                              g, chunk, st);
    case 128:
      return launch_wgmma<128>(x, dt, A, B, C, D, init, y, final_state, cd, states, hin, b, s,
                               h, g, chunk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int64_t ssd_scan_max_p() { return MAX_P; }
int64_t ssd_scan_max_n() { return MAX_N; }

}  // extern "C"
