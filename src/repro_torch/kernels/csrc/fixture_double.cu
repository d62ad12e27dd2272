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
// launch never happens and the entry point returns the error.  What bounds
// it: bytes (8 per element) and, at these sizes, the launch itself.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fixture_double_kernel(const float* __restrict__ x, float* __restrict__ y,
                      long long n, long long tile) {
  extern __shared__ float smem[];
  float* s_in = smem;          // [tile]: the input tile
  float* s_out = smem + tile;  // [tile]: the output tile
  const long long base = (long long)blockIdx.x * tile;
  const long long m = n - base < tile ? n - base : tile;
  for (long long i = threadIdx.x; i < m; i += kThreads) s_in[i] = x[base + i];
  __syncthreads();
  for (long long i = threadIdx.x; i < m; i += kThreads) {
    s_out[i] = s_in[i] * 2.f;
  }
  __syncthreads();
  for (long long i = threadIdx.x; i < m; i += kThreads) y[base + i] = s_out[i];
}

LaunchPlan plan(int rows, int cols, int block_rows) {
  const long long tile = (long long)block_rows * cols;
  return {reinterpret_cast<const void*>(fixture_double_kernel),
          dim3((unsigned)((rows + block_rows - 1) / block_rows)), kThreads,
          (size_t)(2 * tile * (long long)sizeof(float))};
}

}  // namespace

// x, y [rows, cols] f32, contiguous; each block doubles block_rows rows.
extern "C" int fixture_double(const float* x, float* y, int rows, int cols,
                              int block_rows, void* stream) {
  if (rows < 1 || cols < 1 || block_rows < 1) return cudaErrorInvalidValue;
  const LaunchPlan lp = plan(rows, cols, block_rows);
  cudaError_t e = cudaFuncSetAttribute(
      fixture_double_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lp.smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused size leaves no error for the next launch
    return e;
  }
  fixture_double_kernel<<<lp.grid, lp.threads, lp.smem,
                          static_cast<cudaStream_t>(stream)>>>(
      x, y, (long long)rows * cols, (long long)block_rows * cols);
  return cudaGetLastError();
}

// The launch fixture_double makes at these shapes (write_plans).
extern "C" int fixture_double_plan(int rows, int cols, int block_rows,
                                   long long* out) {
  if (rows < 1 || cols < 1 || block_rows < 1) return cudaErrorInvalidValue;
  const LaunchPlan lp = plan(rows, cols, block_rows);
  return write_plans(&lp, 1, out);
}
