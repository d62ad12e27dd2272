// x * 2, one tile of block_rows x cols per block, staged in shared memory.
//
// Replaces the Pallas kernel of the static analyzer's memory-ceiling
// fixtures, src/repro/analysis/fixtures.py (_memory_bad_vmem at :173 and
// _memory_good at :221, kernel(x_ref, o_ref): o = x * 2, one block over the
// whole array).  There the block's working set is its input and output
// refs in VMEM; here it is the input tile and the output tile in dynamic
// shared memory, so the analyzer's memory-ceiling rule measures the same
// sum: 2 * block_rows * cols * 4 bytes.
//
// The kernel is trivial on purpose: its job is to be the thing the rule
// measures.  At [128, 128] f32 in one block it asks for 131,072 bytes,
// which fit a Hopper block's 232,448 (opt-in); at [2048, 2048] in one block
// it asks for 33,554,432, and cudaFuncSetAttribute refuses that, so the
// launch never happens and the entry point returns the error.
//
// What bounds it: bytes (8 per element), 39 ns at [128, 128]; one block
// there is one SM streaming 128 KB, whose time is the latency of its load
// rounds, so each thread issues up to kUnroll 16-byte loads before it
// stores any (a scalar path where x, y or cols do not allow 16 bytes).  At
// these sizes the host sets the time of a call: the wrapper's Python, the
// ctypes call and the launch.  So the launcher asks the runtime for more
// dynamic shared memory only when a launch needs more than this device has
// already granted the kernel: a per-device high-water mark, raised only
// when the runtime accepts, so a steady caller pays no cudaFuncSetAttribute.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <int V>
__global__ void __launch_bounds__(kThreads)
fixture_double_kernel(const float* __restrict__ x, float* __restrict__ y,
                      long long n, long long tile) {
  using P = Pack<float, V>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* s_in = reinterpret_cast<P*>(smem_raw);  // [tile / V]: the input tile
  P* s_out = s_in + tile / V;                // [tile / V]: the output tile
  const long long base = (long long)blockIdx.x * tile;
  const long long m = (n - base < tile ? n - base : tile) / V;  // packs
  const P* xs = reinterpret_cast<const P*>(x + base);
  P* ys = reinterpret_cast<P*>(y + base);
  for (long long i0 = threadIdx.x; i0 < m; i0 += kThreads * kUnroll) {
    P r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i < m) r[u] = xs[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i < m) s_in[i] = r[u];
    }
  }
  __syncthreads();
  for (long long i = threadIdx.x; i < m; i += kThreads) {
    P a = s_in[i];
#pragma unroll
    for (int j = 0; j < V; ++j) a.v[j] *= 2.f;
    s_out[i] = a;
  }
  __syncthreads();
  for (long long i = threadIdx.x; i < m; i += kThreads) ys[i] = s_out[i];
}

LaunchPlan plan(int rows, int cols, int block_rows, bool vec) {
  const long long tile = (long long)block_rows * cols;
  return {vec ? reinterpret_cast<const void*>(fixture_double_kernel<4>)
              : reinterpret_cast<const void*>(fixture_double_kernel<1>),
          dim3((unsigned)((rows + block_rows - 1) / block_rows)), kThreads,
          (size_t)(2 * tile * (long long)sizeof(float))};
}

// Per device and instantiation (0 scalar, 1 vector): the high-water mark
// of the dynamic shared bytes granted (common.cuh).
SmemGrants<2> g_grants;

}  // namespace

// x, y [rows, cols] f32, contiguous; each block doubles block_rows rows.
extern "C" int fixture_double(const float* x, float* y, int rows, int cols,
                              int block_rows, void* stream) {
  if (rows < 1 || cols < 1 || block_rows < 1) return cudaErrorInvalidValue;
  const bool vec = cols % 4 == 0 && aligned(x, 16) && aligned(y, 16);
  const LaunchPlan lp = plan(rows, cols, block_rows, vec);
  const cudaError_t e = g_grants.grant(lp.fn, vec ? 1 : 0, lp.smem);
  if (e != cudaSuccess) return e;
  const long long n = (long long)rows * cols;
  const long long tile = (long long)block_rows * cols;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    fixture_double_kernel<4><<<lp.grid, lp.threads, lp.smem, st>>>(x, y, n,
                                                                   tile);
  } else {
    fixture_double_kernel<1><<<lp.grid, lp.threads, lp.smem, st>>>(x, y, n,
                                                                   tile);
  }
  return cudaGetLastError();
}

// The launch fixture_double makes at these shapes (write_plans), for x and
// y both 16-byte aligned (aligned = 1) or not.
extern "C" int fixture_double_plan(int rows, int cols, int block_rows,
                                   int aligned, long long* out) {
  if (rows < 1 || cols < 1 || block_rows < 1) return cudaErrorInvalidValue;
  const LaunchPlan lp = plan(rows, cols, block_rows,
                             aligned != 0 && cols % 4 == 0);
  return write_plans(&lp, 1, out);
}

// The launcher's state on the current device: out[0] and out[1] the
// dynamic shared bytes granted to the scalar and the vector kernel, out[2]
// the cudaFuncSetAttribute calls made in this process, refused ones too.
extern "C" int fixture_double_smem_state(long long* out) {
  for (int inst = 0; inst < 2; ++inst) {
    const cudaError_t e = g_grants.granted_here(inst, out + inst);
    if (e != cudaSuccess) return e;
  }
  out[2] = g_grants.sets.load();
  return 0;
}
