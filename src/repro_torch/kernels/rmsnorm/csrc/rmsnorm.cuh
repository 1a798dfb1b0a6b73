// Pieces shared by K2's forward (rmsnorm.cu) and backward (rmsnorm_bwd.cu).
//
// Layout of a row: a row of D elements is read as nvec = D / VEC packs of VEC
// elements (VEC = 16 bytes / sizeof(TX) on the vector templates, 1 on the
// scalar ones) by a group of `tpr` threads.  Pack j of thread t is pack index
// j * tpr + t, so neighbouring threads touch neighbouring 16-byte chunks and a
// warp's load is one contiguous run of memory.  `tpr` is a power of two up to
// 32 (several rows per warp) or a multiple of 32 up to kMaxThreads (a row over
// several warps); a block holds blockDim.x / tpr rows.  The host side picks
// (VEC, NV, tpr) in kernels/rmsnorm/ops.py::_template.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;   // block size bound (__launch_bounds__)
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// v rounded to T and back: the rounding a tensor of dtype T applies
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// N elements of T moved as one access: 16-byte vector instructions where the
// pack is 16 bytes or more (pointers 16-byte aligned), else one 8/4/2-byte word
template <typename T, int N> struct alignas(N * sizeof(T) >= 16 ? 16 : N * sizeof(T)) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load(const T* p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const Pack<T, N>& v) {
  *reinterpret_cast<Pack<T, N>*>(p) = v;
}

// Sum of `v` over the tpr threads of each row group.  tpr <= 32: a butterfly
// inside the group's lanes.  tpr > 32: each warp's butterfly, then the row's
// warps through shared memory `red` (kMaxWarps floats per value), in warp
// order.  Every thread of the block must call it (it holds __syncthreads when
// tpr > 32); the leading barrier lets a loop reuse `red`.
template <int K>
__device__ __forceinline__ void group_sum(float (&v)[K], int tpr, float (*red)[kMaxWarps]) {
  const int width = tpr < 32 ? tpr : 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o < width) {
#pragma unroll
      for (int i = 0; i < K; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
    }
  }
  if (tpr > 32) {
    const int warp = threadIdx.x >> 5;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int i = 0; i < K; ++i) red[i][warp] = v[i];
    }
    __syncthreads();
    const int first = (threadIdx.x / tpr) * (tpr >> 5);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float s = 0.f;
      for (int w = 0; w < (tpr >> 5); ++w) s += red[i][first + w];
      v[i] = s;
    }
  }
}

}  // namespace
