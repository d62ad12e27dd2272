// GradIP reduction: g * sum(gp * z) in f32 over the sparse coordinates.
//
// Replaces the TPU kernel of src/repro/kernels/gradip_reduce.py
// (gradip_reduce, _gradip_kernel), whose grid runs in order and carries the
// sum in one VMEM accumulator from step to step.
//
// What bounds it on an H100: bytes.  8 bytes read per element (gp and z) for
// one multiply-add; at the slice's n = 1.24e6 coordinates that is ~10 MB,
// about 3 us at 3.35 TB/s, so at this size the two launches, not the memory,
// set its time.
//
// Design: blocks run in no order on the card, so the sequential accumulator
// becomes a two-pass reduction with no atomics.  Pass 1: a fixed number of
// blocks (at most kMaxPartials), each thread summing a grid-stride slice of
// 16-byte packs, then a warp-shuffle and shared-memory tree per block into
// one f32 partial.  Pass 2: one block sums the partials in a fixed tree and
// multiplies by g.  The grid depends only on n, so the order of every
// addition, and thus the result, is the same from run to run.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPartials = 1024;

__device__ __forceinline__ float block_sum(float x, float* sh) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) sh[warp] = x;
  __syncthreads();
  x = threadIdx.x < blockDim.x / 32 ? sh[threadIdx.x] : 0.f;
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;  // valid in thread 0
}

template <int V>
__global__ void __launch_bounds__(kThreads)
gradip_partials(const float* __restrict__ gp, const float* __restrict__ z,
                float* __restrict__ partials, long long n) {
  __shared__ float sh[kThreads / 32];
  const long long nv = n / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.f;
  for (long long i = tid; i < nv; i += stride) {
    const Pack<float, V> a = reinterpret_cast<const Pack<float, V>*>(gp)[i];
    const Pack<float, V> b = reinterpret_cast<const Pack<float, V>*>(z)[i];
#pragma unroll
    for (int j = 0; j < V; ++j) acc = fmaf(a.v[j], b.v[j], acc);
  }
  for (long long i = nv * V + tid; i < n; i += stride) acc = fmaf(gp[i], z[i], acc);
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kMaxPartials)
gradip_finish(const float* __restrict__ partials, int n_partials, float g,
              float* __restrict__ out) {
  __shared__ float sh[kMaxPartials / 32];
  float x = threadIdx.x < n_partials ? partials[threadIdx.x] : 0.f;
  x = block_sum(x, sh);
  if (threadIdx.x == 0) out[0] = g * x;
}

// The two launches of one call: partial sums, then the finishing sum.
int plans(long long n, bool vec, LaunchPlan* lps) {
  const int v = vec ? 4 : 1;
  long long blocks = (n / v + n % v + kThreads - 1) / kThreads;
  if (blocks > kMaxPartials) blocks = kMaxPartials;
  if (blocks < 1) blocks = 1;
  lps[0] = {vec ? reinterpret_cast<const void*>(gradip_partials<4>)
                : reinterpret_cast<const void*>(gradip_partials<1>),
            dim3((unsigned)blocks), kThreads, 0};
  lps[1] = {reinterpret_cast<const void*>(gradip_finish), dim3(1),
            kMaxPartials, 0};
  return 2;
}

}  // namespace

// partials: scratch of at least kMaxPartials floats; out: one float.
extern "C" int gradip_reduce(const float* gp, const float* z, float g,
                             float* partials, float* out, long long n,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned(gp, 16) && aligned(z, 16);
  LaunchPlan lps[2];
  plans(n, vec, lps);
  if (vec) {
    gradip_partials<4><<<lps[0].grid, lps[0].threads, 0, st>>>(gp, z,
                                                              partials, n);
  } else {
    gradip_partials<1><<<lps[0].grid, lps[0].threads, 0, st>>>(gp, z,
                                                              partials, n);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gradip_finish<<<lps[1].grid, lps[1].threads, 0, st>>>(
      partials, (int)lps[0].grid.x, g, out);
  return cudaGetLastError();
}

// The launches gradip_reduce makes for n elements, packed (vec = 1) or not.
extern "C" int gradip_reduce_plan(long long n, int vec, long long* out) {
  LaunchPlan lps[2];
  return write_plans(lps, plans(n, vec != 0, lps), out);
}
