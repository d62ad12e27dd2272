// Mamba-1 selective scan: h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,
// y_t = <h_t, C_t>, from h = 0, for every (batch row, channel).
//
// Replaces the TPU kernel of src/repro/kernels/mamba_scan.py (mamba_scan,
// _kernel; reached through repro.kernels.ops.mamba_scan_op).  There the
// grid is (B, E/128, S/256) with the sequence axis innermost and in order,
// and the state h [128, N] carries in a VMEM scratch from one grid step to
// the next; its wrapper needs S and E divisible by the blocks.
//
// What bounds it on an H100: at the slice's shape (dt, x [4, 512, 16384]
// f32, N 16) it reads dt and x and writes y, 3 x 134 MB, plus B, C, A and
// h_last: ~408 MB, 0.122 ms at 3.35 TB/s.  It also takes B*S*E*N = 537 M
// exponentials, 0.128 ms at the special-function units' rate (16 a clock
// per SM, 132 SMs, 1.98 GHz boost), so the exponentials bound it, a little
// above the bytes; its ~3 GFLOP of f32 multiply-adds are far below either.
//
// Design (simple and right first):
// * one thread per (row b, channel e), with h[N] in registers; a block
//   covers 128 consecutive channels of one row and loops over all of S
//   itself, so the TPU's sequential grid axis becomes that loop and nothing
//   carries across blocks;
// * B_t and C_t are the same for every channel of a row: a tile of 64 steps
//   of both is staged in shared memory and read as broadcasts;
// * dt and x are read, and y written, coalesced across channels; 16 steps
//   of dt and x are loaded into registers together, so their loads are in
//   flight at once.  Positions past S read dt = x = 0, which leaves h as it
//   is (exp(0) = 1 and no input), so the step loop needs no branch and
//   h_last is the state after the last position;
// * y_t sums h * C over n in order; expf (not __expf), in f32; no atomics,
//   so two calls are bit-equal.
// Any B, S >= 1 and E (the ragged channel edge is masked); N is 8 or 16.
// Later work: a chunked two-pass scan across blocks, for more parallelism
// at small B, and cp.async prefetch of the next steps of dt and x.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kTile = 64;      // steps of B and C staged in shared memory
constexpr int kSub = 16;       // steps of dt and x held in registers

template <int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ x,
                  const float* __restrict__ A, float* __restrict__ y,
                  float* __restrict__ h_last, int S, int E) {
  __shared__ float sB[kTile * N];
  __shared__ float sC[kTile * N];
  const int b = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const bool live = e < E;
  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[(size_t)e * N + n] : 0.f;
    h[n] = 0.f;
  }
  const size_t row = (size_t)b * S;  // the (b, t = 0) row of dt, x, y, B, C
  for (int t0 = 0; t0 < S; t0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
      const int t = t0 + i / N;
      const size_t off = (row + t) * N + i % N;
      sB[i] = t < S ? Bm[off] : 0.f;
      sC[i] = t < S ? Cm[off] : 0.f;
    }
    __syncthreads();
    for (int s0 = 0; s0 < kTile; s0 += kSub) {
      float rdt[kSub], rx[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int t = t0 + s0 + j;
        const bool in = live && t < S;
        const size_t off = (row + t) * E + e;
        rdt[j] = in ? dt[off] : 0.f;
        rx[j] = in ? x[off] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float* bt = sB + (s0 + j) * N;
        const float* ct = sC + (s0 + j) * N;
        const float dtx = rdt[j] * rx[j];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(rdt[j] * a[n]) * h[n] + dtx * bt[n];
          acc += h[n] * ct[n];
        }
        const int t = t0 + s0 + j;
        if (live && t < S) y[(row + t) * E + e] = acc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[((size_t)b * E + e) * N + n] = h[n];
  }
}

template <int N>
LaunchPlan plan(int B, int E) {
  return {reinterpret_cast<const void*>(mamba_scan_kernel<N>),
          dim3((E + kThreads - 1) / kThreads, B), kThreads, 0};
}

}  // namespace

// dt, x, y [B, S, E]; Bm, Cm [B, S, N]; A [E, N]; h_last [B, E, N]; all f32
// and contiguous.  N must be 8 or 16.
extern "C" int mamba_scan(const float* dt, const float* Bm, const float* Cm,
                          const float* x, const float* A, float* y,
                          float* h_last, int B, int S, int E, int N,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 16) {
    const LaunchPlan lp = plan<16>(B, E);
    mamba_scan_kernel<16><<<lp.grid, lp.threads, 0, st>>>(
        dt, Bm, Cm, x, A, y, h_last, S, E);
  } else if (N == 8) {
    const LaunchPlan lp = plan<8>(B, E);
    mamba_scan_kernel<8><<<lp.grid, lp.threads, 0, st>>>(
        dt, Bm, Cm, x, A, y, h_last, S, E);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The launch mamba_scan makes at these shapes (write_plans).
extern "C" int mamba_scan_plan(int B, int S, int E, int N, long long* out) {
  (void)S;  // the grid covers channels and rows; each block loops over S
  LaunchPlan lp;
  if (N == 16) {
    lp = plan<16>(B, E);
  } else if (N == 8) {
    lp = plan<8>(B, E);
  } else {
    return cudaErrorInvalidValue;
  }
  return write_plans(&lp, 1, out);
}
