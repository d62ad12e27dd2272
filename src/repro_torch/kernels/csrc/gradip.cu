// GradIP reduction: g * sum(gp * z) in f32 over the sparse coordinates.
//
// Replaces the TPU kernel of src/repro/kernels/gradip_reduce.py
// (gradip_reduce, _gradip_kernel), whose grid runs in order and carries the
// sum in one VMEM accumulator from step to step.
//
// What bounds it on an H100: bytes.  8 bytes read per element (gp and z) for
// one multiply-add; at the slice's n = 1.24e6 coordinates that is ~10 MB,
// about 3 us at 3.35 TB/s.  At that size the host sets the time of a call
// (the wrapper's Python, the ctypes call and the launch, ~10 us), so the
// design spends one launch and no allocation but the output.
//
// Design: one launch, the last-block-done reduction (CUDA's
// threadFenceReduction sample).  Blocks run in no order on the card, so the
// sequential accumulator becomes per-block partial sums: each of a fixed
// number of blocks (at most kMaxPartials) sums a grid-stride slice of
// 16-byte packs per thread, reduces it by warp shuffles and a shared-memory
// tree, writes its partial, fences, and draws a ticket.  The block that
// draws the last ticket reads the partials in index order, sums them by a
// fixed tree, multiplies by g and writes the result.  The grid depends only
// on n and on the operands' alignment, and each block's slice and each tree
// only on the grid, so the order of every addition, and thus the result, is
// the same from call to call whichever block finishes first.
//
// Why not a thread-block cluster (partials summed through distributed
// shared memory): it needs no scratch, but a cluster has at most 16 blocks,
// so 16 SMs would stream what 132 can; at n = 1e7 (80 MB) that is the
// kernel's time.  The last-block-done form streams with the whole card and
// needs a small scratch: the partials and the ticket, which the wrapper
// keeps per (device, stream), zeroed once.  atomicInc wraps the ticket back
// to 0 on the last draw, so each call leaves the scratch ready for the next
// on its stream; two streams never share a ticket.  That holds for eager
// launches only: a CUDA graph would freeze the capture stream's scratch
// into its launch and replay it on any stream, beside eager calls on the
// capture stream, so the launcher refuses a capturing stream (and the
// wrapper refuses to make a scratch during capture).
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
  x = threadIdx.x < kThreads / 32 ? sh[threadIdx.x] : 0.f;
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;  // valid in thread 0
}

// partials: one float per block (at most kMaxPartials); ticket: 0 between
// calls, and 0 again when the last block has drawn.
template <int V>
__global__ void __launch_bounds__(kThreads)
gradip_reduce_kernel(const float* __restrict__ gp, const float* __restrict__ z,
                     float g, float* partials, unsigned* ticket,
                     float* __restrict__ out, long long n) {
  __shared__ float sh[kThreads / 32];
  const long long nv = n / V;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.f;
  for (long long i = tid; i < nv; i += stride) {
    const Pack<float, V> a = reinterpret_cast<const Pack<float, V>*>(gp)[i];
    const Pack<float, V> b = reinterpret_cast<const Pack<float, V>*>(z)[i];
#pragma unroll
    for (int j = 0; j < V; ++j) acc = fmaf(a.v[j], b.v[j], acc);
  }
  for (long long i = nv * V + tid; i < n; i += stride) {
    acc = fmaf(gp[i], z[i], acc);
  }
  acc = block_sum(acc, sh);
  bool drew_last = false;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    __threadfence();  // the partial is visible card-wide before the ticket
    // wraps to 0 on the last draw: the ticket is ready for the next call
    drew_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  if (!__syncthreads_or(drew_last)) return;
  __threadfence();
  // the last block: partials in index order, each thread a fixed stride of
  // them, then the same tree; read through L2 (__ldcg), where the other
  // blocks' writes are
  float x = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) {
    x += __ldcg(partials + i);
  }
  x = block_sum(x, sh);
  if (threadIdx.x == 0) *out = g * x;
}

LaunchPlan plan(long long n, bool vec) {
  const int v = vec ? 4 : 1;
  long long blocks = (n / v + n % v + kThreads - 1) / kThreads;
  if (blocks > kMaxPartials) blocks = kMaxPartials;
  if (blocks < 1) blocks = 1;
  return {vec ? reinterpret_cast<const void*>(gradip_reduce_kernel<4>)
              : reinterpret_cast<const void*>(gradip_reduce_kernel<1>),
          dim3((unsigned)blocks), kThreads, 0};
}

}  // namespace

// scratch: kMaxPartials floats, then the ticket (kernels/plans.py
// GRADIP_MAX_PARTIALS + 1 words), zeroed before the first call on this
// stream; each call leaves its ticket at 0 again.  out: one float.  A
// stream under graph capture is refused, before anything is enqueued.
extern "C" int gradip_reduce(const float* gp, const float* z, float g,
                             void* scratch, float* out, long long n,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  const cudaError_t e = cudaStreamIsCapturing(st, &capture);
  if (e != cudaSuccess) return e;
  if (capture != cudaStreamCaptureStatusNone) {
    return cudaErrorStreamCaptureUnsupported;
  }
  const bool vec = aligned(gp, 16) && aligned(z, 16);
  const LaunchPlan lp = plan(n, vec);
  float* partials = static_cast<float*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(partials + kMaxPartials);
  if (vec) {
    gradip_reduce_kernel<4><<<lp.grid, lp.threads, 0, st>>>(
        gp, z, g, partials, ticket, out, n);
  } else {
    gradip_reduce_kernel<1><<<lp.grid, lp.threads, 0, st>>>(
        gp, z, g, partials, ticket, out, n);
  }
  return cudaGetLastError();
}

// The launch gradip_reduce makes for n elements, packed (vec = 1) or not.
extern "C" int gradip_reduce_plan(long long n, int vec, long long* out) {
  const LaunchPlan lp = plan(n, vec != 0);
  return write_plans(&lp, 1, out);
}
