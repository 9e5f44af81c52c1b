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
// Per (batch, head), over the chunks in order, with the (n, p) state entering
// the chunk held in shared memory:
//     cum     = cumsum(A dt)                            (within the chunk)
//     y_intra = ((C B^T) * exp(cum_i - cum_j)[j <= i] * dt_j) x
//     y_inter = exp(cum_i) * (C_i . state)
//     y       = round_T((y_intra + y_inter) + D x)      (rounded once)
//     state  <- state exp(cum_last) + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
// Every product of the TPU kernel's body is here: C B^T, M x, C . state and
// the state update, with the cumsum and the decays. The wrapper only
// allocates the outputs.
//
// Design. The TPU keeps the state in VMEM across a sequential grid axis; here
// one block of 256 threads owns one (batch, head) and walks the chunks itself.
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
// Bound by operations: about 21 GFLOP (float32, CUDA cores, 67 TFLOP/s) at the
// serving path's (4, 2048, 32, 64), n = 128, chunk 256, against 77 MB of
// traffic (0.023 ms at 3.35 TB/s). This first version is simple: one block per
// SM at the path shape (137 KB of shared memory), the products from shared
// memory on the CUDA cores, B reloaded from L2 for every query tile.
//
// The within-chunk cumsum is summed in double and rounded to float once, as
// the plain version does: the sums reach about -2,800 inside a chunk, where a
// float32 sum in another order would move the decays by 2.4e-4. expf is IEEE
// (no fast-math).
//
// Plain C interface (bound with ctypes): ssd_scan_f32 / ssd_scan_bf16 return
// the cudaError_t of the launch. Nothing is allocated and nothing
// synchronises here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

int64_t ssd_scan_max_p() { return MAX_P; }
int64_t ssd_scan_max_n() { return MAX_N; }

}  // extern "C"
