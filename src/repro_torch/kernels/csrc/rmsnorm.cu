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
// scale row stays in L1/L2). One warp owns one row and holds it whole, as
// float, in shared memory between the two passes (sum of squares, then the
// scaled write), so x is read from device memory once. Rows of d <= 12,288
// fit (48 KB of dynamic shared memory per block without opt-in); a block
// holds as many warps (1..8) as fit in that budget. Loads and stores are
// 16 bytes a lane where d and the pointers allow it, else scalar.
//
// Plain C interface (bound with ctypes): rmsnorm_f32 / rmsnorm_bf16 return
// the cudaError_t of the launch. Nothing is allocated and nothing
// synchronises here. Compile without fast-math: rsqrtf and the division
// must be IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 8;
constexpr int64_t SMEM_BUDGET = 48 * 1024;
constexpr int64_t MAX_D = SMEM_BUDGET / sizeof(float);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y = round_T(x * inv) * scale, in T
template <typename T>
__device__ __forceinline__ T normed(float xv, float inv, T s) {
  return from_f<T>(to_f(from_f<T>(xv * inv)) * to_f(s));
}

// VEC: 16-byte accesses (d % (16 / sizeof(T)) == 0 and aligned pointers).
template <typename T, bool VEC>
__global__ void rmsnorm_rows(const T* __restrict__ x, const T* __restrict__ scale,
                             T* __restrict__ out, int64_t rows, int d, float eps) {
  extern __shared__ float buf[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;
  float* r = buf + (int64_t)warp * d;
  const T* xr = x + row * d;
  T* yr = out + row * d;
  constexpr int V = 16 / sizeof(T);

  float ss = 0.f;
  if (VEC) {
    for (int i = lane * V; i < d; i += 32 * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      float f[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        f[j] = to_f(e[j]);
        ss += f[j] * f[j];
      }
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(r + i + j) = make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f(xr[i]);
      r[i] = f;
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / (float)d + eps);
  __syncwarp();

  if (VEC) {
    for (int i = lane * V; i < d; i += 32 * V) {
      const uint4 sraw = *reinterpret_cast<const uint4*>(scale + i);
      const T* s = reinterpret_cast<const T*>(&sraw);
      uint4 oraw;
      T* o = reinterpret_cast<T*>(&oraw);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = normed<T>(r[i + j], inv, s[j]);
      *reinterpret_cast<uint4*>(yr + i) = oraw;
    }
  } else {
    for (int i = lane; i < d; i += 32) yr[i] = normed<T>(r[i], inv, scale[i]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
int launch(const void* x, const void* scale, void* out, int64_t rows, int64_t d,
           float eps, cudaStream_t stream) {
  if (rows < 1 || d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  int64_t warps = SMEM_BUDGET / (d * (int64_t)sizeof(float));
  warps = warps < 1 ? 1 : (warps > MAX_WARPS ? MAX_WARPS : warps);
  const int64_t blocks = (rows + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(warps * d * sizeof(float));
  const bool vec = d % (16 / (int64_t)sizeof(T)) == 0 && aligned16(x) && aligned16(scale) &&
                   aligned16(out);
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  T* ot = static_cast<T*>(out);
  if (vec)
    rmsnorm_rows<T, true><<<(unsigned)blocks, (unsigned)(warps * 32), smem, stream>>>(
        xt, st, ot, rows, (int)d, eps);
  else
    rmsnorm_rows<T, false><<<(unsigned)blocks, (unsigned)(warps * 32), smem, stream>>>(
        xt, st, ot, rows, (int)d, eps);
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
