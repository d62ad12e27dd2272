// Shared helpers of the port's kernels: element conversion and packed
// vector access.  Compiled for sm_90a; every entry point is extern "C" and
// returns the cudaError_t of its launch (0 when the launch was accepted).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V consecutive elements read or written in one access: 16 bytes for four
// f32, 8 bytes for four bf16 (the alignment makes nvcc emit vector loads).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

inline bool aligned(const void* p, size_t bytes) {
  return p == nullptr || (reinterpret_cast<size_t>(p) % bytes) == 0;
}

}  // namespace repro
