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
// above the bytes.  Its f32 work and shared loads (~9 instructions per
// (t, n)) are issued at 128 a clock per SM, so issue slots come next; at
// 16 warps an SM (128 registers a thread) the latency of the serial steps
// and the shuffles is what the scheduler has to hide.
//
// Design: the sequence axis is parallel within a warp.
// * A block of 4 warps covers 32 consecutive channels of one row and walks
//   S in tiles of 64 steps.  Each warp scans 8 channels at a time, 4 lanes
//   a channel, and each lane takes 16 consecutive steps of the tile
//   (lane = 4 * channel + segment).  4 blocks an SM: while one waits at a
//   barrier or for its copies, three scan.
// * dt and x ([64 steps x 32 channels], rows of 128 bytes) and B_t, C_t
//   ([64 x N], one contiguous run) are staged with 16-byte cp.async, two
//   tiles deep: the next tile's loads fly while this one is scanned.  Each
//   16-step segment of a tile sits 8 floats past the last, so a lane's
//   reads of its own steps hit distinct banks, and the 8 channels of a warp
//   that share a segment read B and C as one broadcast (an eighth of the
//   shared-memory wavefronts of a warp on one channel).
// * Per state n, each lane forms a_t = exp2(dt_t * A'_n) with A' = A log2 e
//   scaled once per channel (one ex2.approx, MUFU.EX2, per (t, n): no range
//   reduction) and b_t = dt_t x_t B_t,n, and steps its 16 positions from
//   h = 0, keeping each step's state h0_j and decay from the segment's
//   start P_j = a_0 ... a_j: the segment is the map h -> P h + h0.  A
//   shuffle scan over the channel's 4 lanes, (P1, Q1) then (P2, Q2) =
//   (P1 P2, P2 Q1 + Q2), and the carry from the previous tile give each
//   lane its entering state h_in; then h_j = P_j h_in + h0_j, 16
//   independent multiply-adds (no second exponential, no second serial
//   chain), and y_t += h_t,n C_t,n.  The segment's last lane leaves the
//   state after the tile in shared memory: the next tile's carry, and
//   after the last tile h_last.
// * y goes back through the x slots of the tile (each lane overwrites only
//   what it read) and leaves coalesced, 16 bytes a thread.
// A is [B / a_rows, E, N]: each run of a_rows batch rows shares one A (the
// model's call passes a_rows = B, one A; the stacked forward's folded call,
// ops.mamba_scan's vmap rule, one A per member).
// Positions past S read dt = x = B = C = 0 (zero-filled copies), which
// leaves h as it is (exp2(0) = 1 and no input), so h_last is the state
// after the last position; channels past E are masked on the way out.  Any
// B, S >= 1 and E; 16-byte copies where E % 4 == 0 and every operand is
// 16-byte aligned, 4-byte copies otherwise.  N is 8 or 16.  y_t sums over n
// in order; no atomics, so two calls are bit-equal.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kSeg = 4;                  // lanes (16-step segments) a channel
constexpr int kK = 16;                   // steps a lane
constexpr int kTile = kSeg * kK;         // steps a tile
constexpr int kWarps = 4;
constexpr int kMinBlocks = 4;            // blocks an SM (128 registers)
constexpr int kThreads = 32 * kWarps;
constexpr int kChan = kWarps * 32 / kSeg;  // channels a block
constexpr int kPad = 32 / kSeg;          // floats between segments
constexpr int kSegX = kK * kChan + kPad;  // floats a segment of dt or x
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
__host__ __device__ constexpr int seg_bc() {
  return kK * N + kPad;  // floats a segment of B or C
}

// One tile's buffer: dt, x (then y), B, C.
template <int N>
__host__ __device__ constexpr int buffer_floats() {
  return 2 * kSeg * kSegX + 2 * kSeg * seg_bc<N>();
}

// Dynamic shared bytes: two buffers, then A' and the carry, [kChan][N]
// each.
template <int N>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * buffer_floats<N>() + 2 * kChan * N);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Row r of a tile (0 .. kTile-1) -> its offset in a [kSeg] x stride layout.
__device__ __forceinline__ int row_at(int r, int seg_stride, int row_len) {
  return (r / kK) * seg_stride + (r % kK) * row_len;
}

struct Params {
  const float *dt, *Bm, *Cm, *x, *A;
  float *y, *h_last;
  int S, E;
  int a_rows;  // batch rows a slice of A serves
  bool vec;    // 16-byte copies
};

// Issue the copies of tile t0.. of row b, channels e0.., into buf.
template <int N>
__device__ void load_tile(const Params& p, float* buf, int b, int e0,
                          int t0) {
  float* sdt = buf;
  float* sx = sdt + kSeg * kSegX;
  float* sB = sx + kSeg * kSegX;
  float* sC = sB + kSeg * seg_bc<N>();
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)b * p.S;
  if (p.vec) {
    constexpr int CPR = kChan / 4;  // 16-byte chunks a row of dt or x
#pragma unroll
    for (int i = tid; i < kTile * CPR; i += kThreads) {
      const int r = i / CPR, e = e0 + (i % CPR) * 4, t = t0 + r;
      const bool ok = t < p.S && e < p.E;
      const size_t off = ok ? (row0 + t) * p.E + e : 0;
      const int so = row_at(r, kSegX, kChan) + (i % CPR) * 4;
      cp16(sdt + so, p.dt + off, ok);
      cp16(sx + so, p.x + off, ok);
    }
    constexpr int CB = N / 4;  // 16-byte chunks a step of B or C
#pragma unroll
    for (int i = tid; i < kTile * CB; i += kThreads) {
      const int r = i / CB, t = t0 + r;
      const bool ok = t < p.S;
      const size_t off = ok ? (row0 + t) * N + (i % CB) * 4 : 0;
      const int so = row_at(r, seg_bc<N>(), N) + (i % CB) * 4;
      cp16(sB + so, p.Bm + off, ok);
      cp16(sC + so, p.Cm + off, ok);
    }
  } else {
    for (int i = tid; i < kTile * kChan; i += kThreads) {
      const int r = i / kChan, e = e0 + i % kChan, t = t0 + r;
      const bool ok = t < p.S && e < p.E;
      const size_t off = ok ? (row0 + t) * p.E + e : 0;
      const int so = row_at(r, kSegX, kChan) + i % kChan;
      cp4(sdt + so, p.dt + off, ok);
      cp4(sx + so, p.x + off, ok);
    }
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, t = t0 + r;
      const bool ok = t < p.S;
      const size_t off = ok ? (row0 + t) * N + i % N : 0;
      const int so = row_at(r, seg_bc<N>(), N) + i % N;
      cp4(sB + so, p.Bm + off, ok);
      cp4(sC + so, p.Cm + off, ok);
    }
  }
}

// Write the tile's y (in the x slots of buf) to rows t0.. of row b.
__device__ void store_y(const Params& p, const float* buf, int b, int e0,
                        int t0) {
  const float* sy = buf + kSeg * kSegX;
  const size_t row0 = (size_t)b * p.S;
  if (p.vec) {
    constexpr int CPR = kChan / 4;
    for (int i = threadIdx.x; i < kTile * CPR; i += kThreads) {
      const int r = i / CPR, e = e0 + (i % CPR) * 4, t = t0 + r;
      if (t < p.S && e < p.E)
        *reinterpret_cast<float4*>(p.y + (row0 + t) * p.E + e) =
            *reinterpret_cast<const float4*>(
                sy + row_at(r, kSegX, kChan) + (i % CPR) * 4);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kChan; i += kThreads) {
      const int r = i / kChan, e = e0 + i % kChan, t = t0 + r;
      if (t < p.S && e < p.E)
        p.y[(row0 + t) * p.E + e] = sy[row_at(r, kSegX, kChan) + i % kChan];
    }
  }
}

// Scan one tile in buf: this lane's channel ch, segment s.  sA holds A'
// and sH the carry, [kChan][N].
template <int N>
__device__ __forceinline__ void scan_tile(float* buf, const float* sA,
                                          float* sH, int ch, int s) {
  const float* sdt = buf + s * kSegX + ch;
  float* sx = buf + kSeg * kSegX + s * kSegX + ch;
  const float* sB = buf + 2 * kSeg * kSegX + s * seg_bc<N>();
  const float* sC = sB + kSeg * seg_bc<N>();
  float dt[kK], dtx[kK], y[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    dt[j] = sdt[j * kChan];
    dtx[j] = dt[j] * sx[j * kChan];
    y[j] = 0.f;
  }
#pragma unroll 1
  for (int n = 0; n < N; ++n) {
    const float an = sA[ch * N + n];
    // the segment's steps from h = 0: h0_j, and the decay from its start,
    // P_j = a_0 ... a_j, so that h_j = P_j h_in + h0_j
    float P[kK], h0[kK];
    P[0] = ex2(dt[0] * an);
    h0[0] = dtx[0] * sB[n];
#pragma unroll
    for (int j = 1; j < kK; ++j) {
      const float a = ex2(dt[j] * an);
      P[j] = P[j - 1] * a;
      h0[j] = fmaf(a, h0[j - 1], dtx[j] * sB[j * N + n]);
    }
    // inclusive scan of the maps h -> P h + Q over the channel's segments,
    // earlier maps first
    float Ps = P[kK - 1], Qs = h0[kK - 1];
#pragma unroll
    for (int d = 1; d < kSeg; d *= 2) {
      const float Pu = __shfl_up_sync(0xffffffffu, Ps, d, kSeg);
      const float Qu = __shfl_up_sync(0xffffffffu, Qs, d, kSeg);
      if (s >= d) {
        Qs = fmaf(Ps, Qu, Qs);
        Ps *= Pu;
      }
    }
    const float Pe = __shfl_up_sync(0xffffffffu, Ps, 1, kSeg);
    const float Qe = __shfl_up_sync(0xffffffffu, Qs, 1, kSeg);
    const float carry = sH[ch * N + n];
    const float h_in = s == 0 ? carry : fmaf(Pe, carry, Qe);
#pragma unroll
    for (int j = 0; j < kK; ++j)
      y[j] = fmaf(fmaf(P[j], h_in, h0[j]), sC[j * N + n], y[j]);
    __syncwarp();  // every lane has read the carry
    if (s == kSeg - 1) sH[ch * N + n] = fmaf(P[kK - 1], h_in, h0[kK - 1]);
  }
#pragma unroll
  for (int j = 0; j < kK; ++j) sx[j * kChan] = y[j];
}

template <int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    mamba_scan_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BUF = buffer_floats<N>();
  float* sA = smem + 2 * BUF;
  float* sH = sA + kChan * N;
  const int b = blockIdx.y, e0 = blockIdx.x * kChan;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = warp * (32 / kSeg) + lane / kSeg, s = lane % kSeg;
  const float* A = p.A + (size_t)(b / p.a_rows) * p.E * N;

  load_tile<N>(p, smem, b, e0, 0);
  cp_commit();
  for (int i = tid; i < kChan * N; i += kThreads) {
    const int e = e0 + i / N;
    sA[i] = e < p.E ? A[(size_t)e * N + i % N] * kLog2e : 0.f;
    sH[i] = 0.f;
  }
  const int n_tiles = (p.S + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    cp_wait<0>();
    // tile it has landed, and every thread is done with tile it - 1, so
    // its buffer takes tile it + 1
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_tile<N>(p, smem + ((it + 1) & 1) * BUF, b, e0, (it + 1) * kTile);
      cp_commit();
    }
    scan_tile<N>(smem + (it & 1) * BUF, sA, sH, ch, s);
    __syncthreads();
    store_y(p, smem + (it & 1) * BUF, b, e0, it * kTile);
  }
  for (int i = tid; i < kChan * N; i += kThreads) {
    const int e = e0 + i / N;
    if (e < p.E) p.h_last[((size_t)b * p.E + e) * N + i % N] = sH[i];
  }
}

template <int N>
LaunchPlan plan(int B, int E) {
  return {reinterpret_cast<const void*>(mamba_scan_kernel<N>),
          dim3((E + kChan - 1) / kChan, B), kThreads, smem_bytes<N>()};
}

SmemGrants<2> g_grants;  // N = 16, then 8

template <int N>
cudaError_t launch(const Params& p, int B, cudaStream_t st) {
  const LaunchPlan lp = plan<N>(B, p.E);
  const cudaError_t e = g_grants.grant(lp.fn, N == 16 ? 0 : 1, lp.smem);
  if (e != cudaSuccess) return e;
  mamba_scan_kernel<N><<<lp.grid, lp.threads, lp.smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dt, x, y [B, S, E]; Bm, Cm [B, S, N]; A [B / a_rows, E, N]; h_last
// [B, E, N]; all f32 and contiguous.  N must be 8 or 16, S >= 1, and a_rows
// >= 1 must divide B.
extern "C" int mamba_scan(const float* dt, const float* Bm, const float* Cm,
                          const float* x, const float* A, float* y,
                          float* h_last, int B, int S, int E, int N,
                          int a_rows, void* stream) {
  if ((N != 16 && N != 8) || S < 1) return cudaErrorInvalidValue;
  if (B == 0 || E == 0) return 0;
  if (a_rows < 1 || B % a_rows) return cudaErrorInvalidValue;
  const bool vec = E % 4 == 0 && aligned(dt, 16) && aligned(x, 16) &&
                   aligned(y, 16) && aligned(Bm, 16) && aligned(Cm, 16);
  const Params p{dt, Bm, Cm, x, A, y, h_last, S, E, a_rows, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return N == 16 ? launch<16>(p, B, st) : launch<8>(p, B, st);
}

// The launch mamba_scan makes at these shapes (write_plans).
extern "C" int mamba_scan_plan(int B, int S, int E, int N, long long* out) {
  (void)S;  // the grid covers channels and rows; each block walks S
  if (N != 16 && N != 8) return cudaErrorInvalidValue;
  if (B == 0 || E == 0) return write_plans(nullptr, 0, out);
  const LaunchPlan lp = N == 16 ? plan<16>(B, E) : plan<8>(B, E);
  return write_plans(&lp, 1, out);
}
