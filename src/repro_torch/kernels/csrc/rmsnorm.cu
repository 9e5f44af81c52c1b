// Fused RMSNorm for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel.
//
// For every row of x (rows, d) and a scale (d,) of x's type:
//     y = (x * rsqrt(mean(x^2) + eps)).astype(T) * scale        (in T)
// The statistics are taken in float32; the normalised row is rounded to the
// output type BEFORE the multiply by scale, and that multiply is done in the
// output type (for bf16: the float product of two bf16 values, rounded once),
// the order of the reference's ref.rmsnorm. torch.nn.functional.rms_norm
// multiplies before it rounds, so it is not the same function in bf16.
//
// Bound by bytes: the least traffic is one read of x and one write of y (the
// scale row stays in L1/L2). The row lives in registers: a group of LANES
// threads owns a row (a whole warp for d >= 32 vectors, 4 to 16 lanes for
// narrower rows such as the qk-norm's 128), each lane issues all of its
// VPL 16-byte loads before it sums, the group reduces with shuffles and
// writes from the same registers. No shared memory, so residency is set by
// registers alone and every resident row has all of its loads in flight.
// Rows wider than 512 vectors (bf16 d > 4,096, float32 d > 2,048) take a
// warp each and read x a second time, from L2, in the same kernel; so do
// rows whose width is not a multiple of 16 bytes or whose pointers are not
// 16-byte aligned, with scalar accesses. Rows up to 12,288 are taken.
// On an H100 the serving path's (8192, 1024) bf16 call takes about 0.0105
// device ms against a 0.0100 ms bound (95 %) and
// torch.nn.functional.rms_norm's 0.012; chip_smoke.py measures it and
// PERF.md keeps the numbers.
//
// Plain C interface (bound with ctypes): rmsnorm_f32 / rmsnorm_bf16 return
// the cudaError_t of the launch. Nothing is allocated and nothing
// synchronises here. Compile without fast-math: rsqrtf and the division
// must be IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int64_t MAX_D = 12288;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// sum over the LANES lanes of an aligned group
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y = round_T(x * inv) * scale, in T
template <typename T>
__device__ __forceinline__ T normed(float xv, float inv, T s) {
  return from_f<T>(to_f(from_f<T>(xv * inv)) * to_f(s));
}

// blocks an SM must hold: rows of 8 vectors a lane (bf16 d = 2,048) fit 4
// blocks of 256 threads in 64 registers, where the compiler would take 74
// and leave 3; the other widths need no cap
template <int VPL>
struct Residency {
  static constexpr int blocks = VPL == 8 ? 4 : 1;
};

// The row in registers: LANES lanes a row, VPL 16-byte vectors a lane
// (vector j * LANES + lane of the row), d a multiple of 16 / sizeof(T).
template <typename T, int LANES, int VPL>
__global__ void __launch_bounds__(BLOCK, Residency<VPL>::blocks)
rmsnorm_regs(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
             int64_t rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  const int64_t row = ((int64_t)blockIdx.x * BLOCK + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  const bool live = row < rows;   // dead lanes still take part in the shuffles
  const T* xr = x + row * d;
  T* yr = out + row * d;

  uint4 xv[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = (j * LANES + lane) * V;
    xv[j] = live && i < d ? *reinterpret_cast<const uint4*>(xr + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const T* e = reinterpret_cast<const T*>(&xv[j]);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float f = to_f(e[k]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(group_sum<LANES>(ss) / (float)d + eps);
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = (j * LANES + lane) * V;
    if (live && i < d) {
      const uint4 sraw = *reinterpret_cast<const uint4*>(scale + i);
      const T* s = reinterpret_cast<const T*>(&sraw);
      const T* e = reinterpret_cast<const T*>(&xv[j]);
      uint4 oraw;
      T* o = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = normed<T>(to_f(e[k]), inv, s[k]);
      *reinterpret_cast<uint4*>(yr + i) = oraw;
    }
  }
}

// A warp a row, x read twice (the second read from L2): rows wider than the
// register path holds (VEC, 16-byte accesses) or not 16-byte shaped (scalar).
template <typename T, bool VEC>
__global__ void __launch_bounds__(BLOCK)
rmsnorm_reread(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
               int64_t rows, int d, float eps) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  const int64_t row = (int64_t)blockIdx.x * (BLOCK / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;   // the whole warp: one row
  const T* xr = x + row * d;
  T* yr = out + row * d;

  float ss = 0.f;
  for (int i = lane * V; i < d; i += 32 * V) {
    if (VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) ss += to_f(e[k]) * to_f(e[k]);
    } else {
      const float f = to_f(xr[i]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(group_sum<32>(ss) / (float)d + eps);
  for (int i = lane * V; i < d; i += 32 * V) {
    if (VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const uint4 sraw = *reinterpret_cast<const uint4*>(scale + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      const T* s = reinterpret_cast<const T*>(&sraw);
      uint4 oraw;
      T* o = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = normed<T>(to_f(e[k]), inv, s[k]);
      *reinterpret_cast<uint4*>(yr + i) = oraw;
    } else {
      yr[i] = normed<T>(to_f(xr[i]), inv, scale[i]);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, int LANES, int VPL>
void launch_regs(const T* x, const T* s, T* y, int64_t rows, int d, float eps, cudaStream_t st) {
  constexpr int64_t per_block = BLOCK / LANES;
  rmsnorm_regs<T, LANES, VPL><<<(unsigned)((rows + per_block - 1) / per_block), BLOCK, 0, st>>>(
      x, s, y, rows, d, eps);
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int64_t rows, int64_t d, float eps,
           cudaStream_t st) {
  constexpr int64_t V = 16 / sizeof(T);
  if (rows < 1 || d < 1 || d > MAX_D || (rows + BLOCK / 32 - 1) / (BLOCK / 32) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* s = static_cast<const T*>(scale);
  T* y = static_cast<T*>(out);
  const int di = (int)d;
  const int64_t warp_blocks = (rows + BLOCK / 32 - 1) / (BLOCK / 32);
  if (d % V != 0 || !(aligned16(x) && aligned16(scale) && aligned16(out))) {
    rmsnorm_reread<T, false><<<(unsigned)warp_blocks, BLOCK, 0, st>>>(xt, s, y, rows, di, eps);
    return (int)cudaGetLastError();
  }
  const int64_t n = d / V;   // 16-byte vectors a row
  if (n <= 4) launch_regs<T, 4, 1>(xt, s, y, rows, di, eps, st);
  else if (n <= 8) launch_regs<T, 8, 1>(xt, s, y, rows, di, eps, st);
  else if (n <= 16) launch_regs<T, 16, 1>(xt, s, y, rows, di, eps, st);
  else if (n <= 32) launch_regs<T, 32, 1>(xt, s, y, rows, di, eps, st);
  else if (n <= 64) launch_regs<T, 32, 2>(xt, s, y, rows, di, eps, st);
  else if (n <= 128) launch_regs<T, 32, 4>(xt, s, y, rows, di, eps, st);
  else if (n <= 256) launch_regs<T, 32, 8>(xt, s, y, rows, di, eps, st);
  else if (n <= 512) launch_regs<T, 32, 16>(xt, s, y, rows, di, eps, st);
  else rmsnorm_reread<T, true><<<(unsigned)warp_blocks, BLOCK, 0, st>>>(xt, s, y, rows, di, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rmsnorm_f32(const void* x, const void* scale, void* out, int64_t rows, int64_t d,
                float eps, void* stream) {
  return launch<float>(x, scale, out, rows, d, eps, static_cast<cudaStream_t>(stream));
}

int rmsnorm_bf16(const void* x, const void* scale, void* out, int64_t rows, int64_t d,
                 float eps, void* stream) {
  return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, static_cast<cudaStream_t>(stream));
}

int64_t rmsnorm_max_d() { return MAX_D; }

}  // extern "C"
