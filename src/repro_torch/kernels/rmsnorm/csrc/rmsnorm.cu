// RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas
// (body _rmsnorm_kernel).  Same arithmetic: fp32 sum of squares over the last
// dim, output rounded once to x's dtype.
//
// Bound on the card: bytes.  Each element is read once and written once, with
// a handful of flops per element, so the roofline is (2 * rows * D * size +
// D * scale_size) / 3.35 TB/s.  Design: a row is reduced by a group of
// threads (one warp when D < 1024, 256 threads when D >= 1024) with
// coalesced strided loads, a warp-shuffle sum and, for 256-thread rows, one
// shared-memory step across warps; the second pass re-reads the row (it is
// still in L1/L2) and writes the output.  Many rows per block keep small-D
// calls (qk-norm over head_dim) from launching one tiny block per row.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

// TPR = threads per row (32 or 256); kThreads / TPR rows per block.
template <typename TX, typename TS, int TPR>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(
    const TX* __restrict__ x, const TS* __restrict__ scale, TX* __restrict__ out,
    long long rows, int D, float eps) {
  constexpr int kRowsPerBlock = kThreads / TPR;
  constexpr int kWarpsPerRow = TPR / 32;
  __shared__ float partial[kThreads / 32];

  const int local_row = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + local_row;
  const bool valid = row < rows;
  const TX* xr = x + row * D;

  float ss = 0.f;
  if (valid) {
    for (int i = t; i < D; i += TPR) {
      const float v = to_f(xr[i]);
      ss = fmaf(v, v, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (kWarpsPerRow > 1) {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) partial[warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerRow; ++w) ss += partial[local_row * kWarpsPerRow + w];
  }
  if (!valid) return;
  const float inv = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);
  TX* outr = out + row * D;
  for (int i = t; i < D; i += TPR) {
    outr[i] = from_f<TX>(to_f(xr[i]) * inv * to_f(scale[i]));
  }
}

template <typename TX, typename TS>
cudaError_t launch(const void* x, const void* scale, void* out, long long rows, int D,
                   float eps, cudaStream_t stream) {
  if (D >= 1024) {
    constexpr int TPR = 256;
    const long long blocks = (rows + kThreads / TPR - 1) / (kThreads / TPR);
    rmsnorm_kernel<TX, TS, TPR><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TS*>(scale), static_cast<TX*>(out),
        rows, D, eps);
  } else {
    constexpr int TPR = 32;
    const long long blocks = (rows + kThreads / TPR - 1) / (kThreads / TPR);
    rmsnorm_kernel<TX, TS, TPR><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TS*>(scale), static_cast<TX*>(out),
        rows, D, eps);
  }
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_scale(const void* x, const void* scale, void* out, long long rows,
                           int D, float eps, int s_dtype, cudaStream_t stream) {
  switch (s_dtype) {
    case 0: return launch<TX, float>(x, scale, out, rows, D, eps, stream);
    case 1: return launch<TX, __nv_bfloat16>(x, scale, out, rows, D, eps, stream);
    case 2: return launch<TX, __half>(x, scale, out, rows, D, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16.
extern "C" int repro_rmsnorm_fwd(const void* x, const void* scale, void* out, long long rows,
                                 int D, float eps, int x_dtype, int s_dtype, void* stream) {
  // clear any error left by an earlier launch so the return value is ours
  cudaGetLastError();
  if (rows <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (x_dtype) {
    case 0: err = dispatch_scale<float>(x, scale, out, rows, D, eps, s_dtype, s); break;
    case 1: err = dispatch_scale<__nv_bfloat16>(x, scale, out, rows, D, eps, s_dtype, s); break;
    case 2: err = dispatch_scale<__half>(x, scale, out, rows, D, eps, s_dtype, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
