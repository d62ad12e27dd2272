// Shared helpers of the port's kernels: element conversion, packed vector
// access, asynchronous copies, launch plans and the kernel-attribute
// grant.  Compiled for
// sm_90a; every entry point is extern "C" and returns the cudaError_t of
// its launch (0 when the launch was accepted).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

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

// ---------------------------------------------------------------- copies --
// cp.async of 16, 8 or 4 bytes from global to shared memory; with ok false
// nothing is read and the destination is zero-filled (src must still be a
// valid address).  16-byte copies bypass L1 (.cg), the smaller ones cannot.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp8(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// One launch of a kernel: what a launcher passes to <<<...>>>.  Each
// launcher builds its LaunchPlan with the same function as the matching
// *_plan entry point, which reports it to the host (kernels/plans.py holds
// its own copy of the arithmetic, checked against these on the card).
struct LaunchPlan {
  const void* fn;   // the kernel
  dim3 grid;
  int threads;
  size_t smem;      // dynamic shared bytes
  int cluster = 1;  // blocks of a thread-block cluster along grid x
};

// Values write_plan writes for one launch.
constexpr int kPlanValues = 7;

// Writes one launch as kPlanValues values at out: grid x, y, z, threads
// per block, the kernel's static shared bytes (cudaFuncGetAttributes), the
// dynamic shared bytes the launcher passes and the cluster size.
inline int write_plan(const LaunchPlan& lp, long long* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, lp.fn);
  if (e != cudaSuccess) {
    cudaGetLastError();  // leave no error behind for the next launch check
    return e;
  }
  out[0] = lp.grid.x;
  out[1] = lp.grid.y;
  out[2] = lp.grid.z;
  out[3] = lp.threads;
  out[4] = (long long)a.sharedSizeBytes;
  out[5] = (long long)lp.smem;
  out[6] = lp.cluster;
  return 0;
}

// A *_plan entry point's output: out[0] the number of launches, then
// kPlanValues values (write_plan) for each, in launch order.
inline int write_plans(const LaunchPlan* lps, int n, long long* out) {
  out[0] = n;
  for (int i = 0; i < n; ++i) {
    const int e = write_plan(lps[i], out + 1 + kPlanValues * i);
    if (e) return e;
  }
  return 0;
}

constexpr int kMaxDevices = 64;

// Per device and kernel instantiation (0 .. N-1): the most dynamic shared
// bytes the runtime has accepted for the kernel.  A launcher asks the
// runtime (cudaFuncSetAttribute) only for a size past the mark, so a steady
// caller pays no attribute call.  A launcher of clusters past the portable
// 8 blocks asks with nonportable_cluster, and the first grant of the
// instantiation (the mark starts at 0) also allows those sizes.  The mark
// is read without a lock on every launch and raised under the lock after
// the runtime accepts, so it never exceeds the attribute that is set.  One
// object per source file: its kernels' instantiations are numbered by that
// file.
template <int N>
struct SmemGrants {
  std::atomic<long long> granted[kMaxDevices][N];
  std::atomic<long long> sets;  // cudaFuncSetAttribute calls, refused too
  std::mutex lock;

  cudaError_t grant(const void* fn, int inst, size_t bytes,
                    bool nonportable_cluster = false) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const long long want = (long long)bytes;
    const bool tracked = dev >= 0 && dev < kMaxDevices;
    if (tracked && want <= granted[dev][inst].load(std::memory_order_acquire))
      return cudaSuccess;
    std::lock_guard<std::mutex> hold(lock);
    if (tracked && want <= granted[dev][inst].load(std::memory_order_relaxed))
      return cudaSuccess;
    sets.fetch_add(1, std::memory_order_relaxed);
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)want);
    if (e != cudaSuccess) {
      cudaGetLastError();  // a refused size leaves no error behind
      return e;
    }
    if (nonportable_cluster) {
      sets.fetch_add(1, std::memory_order_relaxed);
      e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) {
        cudaGetLastError();
        return e;
      }
    }
    if (tracked) granted[dev][inst].store(want, std::memory_order_release);
    return cudaSuccess;
  }

  // The bytes granted to instantiation inst on the current device (-1 on
  // an untracked device) into *out.
  cudaError_t granted_here(int inst, long long* out) const {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    *out = dev >= 0 && dev < kMaxDevices ? granted[dev][inst].load() : -1;
    return cudaSuccess;
  }
};

}  // namespace repro
