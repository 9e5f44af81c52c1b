// Segmented max-plus Lindley scan for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lindley_scan.py::_lindley_kernel.
//
// Per row of a (B, n) pair of arrays this computes the inclusive scan of the
// max-plus maps (u, v): w -> max(w + u, v) under
//     combine(a, b) = (a.u + b.u, max(a.v + b.u, b.v))      a EARLIER than b
// and writes W = max(U, V) of every prefix map. A message is (X_n, 0), the
// first message of a server (segment head) is (-inf, 0) and padding is the
// identity (0, -inf). combine is associative but NOT commutative, and the
// infinities carry meaning: the file must be compiled without fast-math, and
// no step ever subtracts (inf - inf never forms).
//
// Bound by bytes: the least traffic is 3*sizeof(T) per element (read u, read
// v, write W). Rows are few (1..64) and long (up to millions), and thread
// blocks run in no order, so the scan axis is split into tiles and the row is
// scanned reduce-then-scan in three launches:
//   1. lindley_tile_reduce : one block per (row, tile) composes its tile into
//                            one aggregate map;
//   2. lindley_carry_scan  : one block per row turns the aggregates into each
//                            tile's carry-in (exclusive scan, tiny);
//   3. lindley_tile_scan   : one block per (row, tile) rescans its tile from
//                            its carry-in and writes W.
// The inputs are therefore read twice: 5*sizeof(T) per element in all.
//
// Inside a block a tile goes to shared memory with coalesced loads (thread t
// takes elements t, t + THREADS, ...) and is then read back blocked (thread t
// owns ITEMS consecutive elements), so the per-thread work is a serial
// combine and only one aggregate per thread goes through the shuffle scan.
// ITEMS is odd so the blocked reads are free of bank conflicts.
//
// Plain C interface (bound with ctypes): lindley_scan_f32 / lindley_scan_f64.
// All offsets are 64-bit. Nothing is allocated and nothing synchronises here.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 7;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;

template <typename T> struct Map { T u, v; };

template <typename T> __device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() { return -CUDART_INF_F; }
template <> __device__ __forceinline__ double neg_inf<double>() { return -CUDART_INF; }

__device__ __forceinline__ float mx(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double mx(double a, double b) { return fmax(a, b); }

template <typename T> __device__ __forceinline__ Map<T> identity() {
  return Map<T>{T(0), neg_inf<T>()};
}

// a is the EARLIER map, b the later one.
template <typename T>
__device__ __forceinline__ Map<T> combine(const Map<T>& a, const Map<T>& b) {
  return Map<T>{a.u + b.u, mx(a.v + b.u, b.v)};
}

template <typename T>
__device__ __forceinline__ Map<T> shfl_up(const Map<T>& x, int delta) {
  return Map<T>{__shfl_up_sync(0xffffffffu, x.u, delta),
                __shfl_up_sync(0xffffffffu, x.v, delta)};
}

// Inclusive scan across the 32 lanes of a warp, lane order = element order.
template <typename T>
__device__ __forceinline__ Map<T> warp_inclusive(Map<T> x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Map<T> y = shfl_up(x, d);
    if (lane >= d) x = combine(y, x);
  }
  return x;
}

// Block-wide scan of one map per thread, thread order = element order.
// Returns the EXCLUSIVE prefix of the calling thread; *total is the
// composition of all THREADS maps. warp_agg is WARPS maps of shared memory.
template <typename T>
__device__ __forceinline__ Map<T> block_exclusive(const Map<T>& x, Map<T>* warp_agg,
                                                  Map<T>* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Map<T> inc = warp_inclusive(x, lane);
  if (lane == 31) warp_agg[warp] = inc;
  __syncthreads();
  Map<T> before = identity<T>();   // all warps before this one
  Map<T> all = identity<T>();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    Map<T> a = warp_agg[w];
    if (w < warp) before = combine(before, a);
    all = combine(all, a);
  }
  Map<T> prev = shfl_up(inc, 1);   // inclusive of the lane before
  if (lane == 0) prev = identity<T>();
  *total = all;
  return combine(before, prev);
}

// Coalesced load of one tile into shared memory; the ragged edge past n is
// filled with the identity, which cannot change any real prefix.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ u, const T* __restrict__ v,
                                          int64_t row_off, int64_t start, int64_t n,
                                          T* su, T* sv) {
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int k = i * THREADS + threadIdx.x;
    const int64_t g = start + k;
    const bool in = g < n;
    su[k] = in ? u[row_off + g] : T(0);
    sv[k] = in ? v[row_off + g] : neg_inf<T>();
  }
  __syncthreads();
}

// The calling thread's ITEMS consecutive elements, composed in order.
template <typename T>
__device__ __forceinline__ Map<T> thread_reduce(const T* su, const T* sv) {
  const int base = threadIdx.x * ITEMS;
  Map<T> acc{su[base], sv[base]};
#pragma unroll
  for (int i = 1; i < ITEMS; ++i) acc = combine(acc, Map<T>{su[base + i], sv[base + i]});
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lindley_tile_reduce(const T* __restrict__ u, const T* __restrict__ v, T* __restrict__ agg_u,
                    T* __restrict__ agg_v, int64_t n, int64_t tiles) {
  __shared__ T su[TILE];
  __shared__ T sv[TILE];
  __shared__ Map<T> warp_agg[WARPS];
  const int64_t row = blockIdx.y;
  const int64_t tile = blockIdx.x;
  load_tile(u, v, row * n, tile * TILE, n, su, sv);
  Map<T> total;
  block_exclusive(thread_reduce(su, sv), warp_agg, &total);
  if (threadIdx.x == 0) {
    agg_u[row * tiles + tile] = total.u;
    agg_v[row * tiles + tile] = total.v;
  }
}

// In place: agg[row, t] becomes the composition of tiles 0..t-1 of the row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
lindley_carry_scan(T* __restrict__ agg_u, T* __restrict__ agg_v, int64_t tiles) {
  __shared__ Map<T> warp_agg[WARPS];
  const int64_t off = int64_t(blockIdx.x) * tiles;
  Map<T> carry = identity<T>();
  for (int64_t base = 0; base < tiles; base += THREADS) {
    const int64_t t = base + threadIdx.x;
    const bool in = t < tiles;
    Map<T> x = in ? Map<T>{agg_u[off + t], agg_v[off + t]} : identity<T>();
    Map<T> total;
    Map<T> excl = block_exclusive(x, warp_agg, &total);
    if (in) {
      Map<T> c = combine(carry, excl);
      agg_u[off + t] = c.u;
      agg_v[off + t] = c.v;
    }
    carry = combine(carry, total);
    __syncthreads();               // warp_agg is reused by the next round
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lindley_tile_scan(const T* __restrict__ u, const T* __restrict__ v,
                  const T* __restrict__ carry_u, const T* __restrict__ carry_v,
                  T* __restrict__ w, int64_t n, int64_t tiles) {
  __shared__ T su[TILE];
  __shared__ T sv[TILE];
  __shared__ Map<T> warp_agg[WARPS];
  const int64_t row = blockIdx.y;
  const int64_t tile = blockIdx.x;
  const int64_t start = tile * TILE;
  load_tile(u, v, row * n, start, n, su, sv);
  Map<T> total;
  Map<T> excl = block_exclusive(thread_reduce(su, sv), warp_agg, &total);
  Map<T> run = combine(Map<T>{carry_u[row * tiles + tile], carry_v[row * tiles + tile]}, excl);
  const int base = threadIdx.x * ITEMS;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    run = combine(run, Map<T>{su[base + i], sv[base + i]});
    su[base + i] = mx(run.u, run.v);       // own slots only: no other thread reads them
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int k = i * THREADS + threadIdx.x;
    const int64_t g = start + k;
    if (g < n) w[row * n + g] = su[k];
  }
}

template <typename T>
int launch(const T* u, const T* v, T* w, T* agg_u, T* agg_v, int64_t rows, int64_t n,
           cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return int(cudaErrorInvalidValue);
  const int64_t tiles = (n + TILE - 1) / TILE;
  if (rows > 65535 || tiles > 2147483647LL) return int(cudaErrorInvalidValue);
  const dim3 grid((unsigned)tiles, (unsigned)rows);
  lindley_tile_reduce<T><<<grid, THREADS, 0, stream>>>(u, v, agg_u, agg_v, n, tiles);
  lindley_carry_scan<T><<<(unsigned)rows, THREADS, 0, stream>>>(agg_u, agg_v, tiles);
  lindley_tile_scan<T><<<grid, THREADS, 0, stream>>>(u, v, agg_u, agg_v, w, n, tiles);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Elements per tile: the wrapper sizes the (rows, tiles) scratch from it.
int64_t lindley_scan_tile() { return TILE; }

int lindley_scan_f32(const void* u, const void* v, void* w, void* agg_u, void* agg_v,
                     int64_t rows, int64_t n, void* stream) {
  return launch<float>((const float*)u, (const float*)v, (float*)w, (float*)agg_u,
                       (float*)agg_v, rows, n, (cudaStream_t)stream);
}

int lindley_scan_f64(const void* u, const void* v, void* w, void* agg_u, void* agg_v,
                     int64_t rows, int64_t n, void* stream) {
  return launch<double>((const double*)u, (const double*)v, (double*)w, (double*)agg_u,
                        (double*)agg_v, rows, n, (cudaStream_t)stream);
}

}  // extern "C"
