// Flash-attention forward: blockwise online-softmax GQA attention that
// returns O and the per-row logsumexp.
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py
// (_fwd_call, _flash_attn_kernel).  There the grid is (B, KVH, S/bq, S/bk)
// and the KV axis runs in order, carrying the running max, normalizer and
// accumulator in VMEM scratch from one grid step to the next.
//
// What bounds it on an H100: operations.  At the slice's shape (B=16,
// S=512, 32 query heads over 8 KV heads, head_dim 64, causal) one call does
// about 17 GFLOP of score and value products against ~170 MB of q, k, v, O
// and lse: ~100 FLOP per byte.  In f32 on the CUDA cores (67 TFLOP/s) that is
// ~0.26 ms of arithmetic against ~0.05 ms of memory.
//
// Design (simple and right first; wgmma and TMA come later):
// * one block per (batch row, KV head, query block); the sequential KV grid
//   axis of the TPU becomes a loop inside the block over 64-key tiles;
// * the G query heads of a group are folded into the score rows: a block
//   holds kRows = 64 rows, BQ = 64 / G queries times G heads, so K and V are
//   loaded once per group and never repeated;
// * q, k and v are read in the model's own layout ([B, S, H, dh] and
//   [B, S, KVH, dh]; H = KVH * G with head h*G + g in group h), so no
//   transpose or pad pass runs before the kernel; the ragged edge of S is
//   masked here (keys at positions >= lengths[b] <= S are dead, query rows
//   past S are not written);
// * scores, the running max m, the normalizer l and the rescale factor live
//   in shared memory, the output accumulator in registers, all in f32 (bf16
//   operands are widened on load);
// * the TPU kernel's block-pruning predicate (_block_needed) skips tiles
//   with no live (query, key) pair, and masked lanes get an explicit p = 0,
//   as there (a fully masked row keeps m = -1e30, where exp(s - m) is 1).
// Scores use CUDA-core FMAs over a 4x4 register tile per thread.
// head_dim 64, 128 and 256 (Gemma-2).  The tiles stay 64 x 64 at every
// head_dim, so shared memory grows with it: 65.5, 113.5 and 209.5 KiB a
// block, the last within the 227 KiB a Hopper block may opt into (one
// block per SM at head_dim 256).
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kRows = 64;     // score rows per block: BQ queries x G heads
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  float* lse;
  int S, KVH, G, BQ, window, causal;
  float softcap, scale;
};

__device__ __forceinline__ bool live(int key, int pos, int L, int window,
                                     int causal) {
  bool ok = key < L;
  if (causal) ok = ok && key <= pos;
  if (window) ok = ok && key > pos - window;
  return ok;
}

template <int DH>
constexpr size_t smem_floats() {
  return (size_t)kRows * (DH + 1) + (size_t)kBK * (DH + 1) +
         (size_t)kBK * DH + (size_t)kRows * (kBK + 1) + 3 * kRows;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd(Params p) {
  constexpr int DP = DH + 1;   // padded rows: column reads hit distinct banks
  constexpr int SP = kBK + 1;
  constexpr int DJ = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                 // [kRows][DP]
  float* sK = sQ + kRows * DP;      // [kBK][DP]
  float* sV = sK + kBK * DP;        // [kBK][DH]
  float* sS = sV + kBK * DH;        // [kRows][SP]: scores, then p
  float* sM = sS + kRows * SP;      // running max per row
  float* sL = sM + kRows;           // normalizer per row
  float* sA = sL + kRows;           // this tile's rescale factor per row

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int b = blockIdx.z, h = blockIdx.y;
  const int S = p.S, KVH = p.KVH, G = p.G;
  const int q0 = blockIdx.x * p.BQ;
  const int R = p.BQ * G;           // live rows of this block
  const int L = p.lengths[b];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long head_stride = (long long)G * DH;  // q/o elements per (s, h)

  // row r <-> query q0 + r / G, query head h * G + r % G
  for (int i = tid; i < kRows * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int s = q0 + r / G;
    float x = 0.f;
    if (r < R && s < S) {
      x = to_f(q[(((long long)b * S + s) * KVH + h) * head_stride +
                 (r % G) * DH + d]);
    }
    sQ[r * DP + d] = x;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  __syncthreads();

  const int n_tiles = (S + kBK - 1) / kBK;
  const int warp = tid / 32, lane = tid % 32;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    // _block_needed: does the tile hold a live pair for any row here?
    bool needed = k0 < L;
    if (p.causal) needed = needed && k0 <= q0 + p.BQ - 1;
    if (p.window) needed = needed && k0 + kBK - 1 > q0 - p.window;
    if (!needed) continue;  // uniform over the block

    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int c = i / DH, d = i % DH;
      const int key = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (key < S) {
        const long long off = (((long long)b * S + key) * KVH + h) * DH + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      sK[c * DP + d] = kx;
      sV[c * DH + d] = vx;
    }
    __syncthreads();

    // scores: thread (ty, tx) owns rows 4*ty + i and columns tx + 16*j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < DH; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(4 * ty + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int pos = q0 + r / G;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float s = sc[i][j] * p.scale;
        if (p.softcap != 0.f) s = tanhf(s / p.softcap) * p.softcap;
        if (!live(k0 + c, pos, L, p.window, p.causal)) s = kNegInf;
        sS[r * SP + c] = s;
      }
    }
    __syncthreads();

    // online-softmax statistics, one warp per row (two columns per lane)
    for (int r = warp; r < kRows; r += kThreads / 32) {
      const int pos = q0 + r / G;
      const float s0 = sS[r * SP + lane], s1 = sS[r * SP + lane + 32];
      float mx = fmaxf(s0, s1);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 =
          live(k0 + lane, pos, L, p.window, p.causal) ? expf(s0 - m_new) : 0.f;
      const float p1 = live(k0 + lane + 32, pos, L, p.window, p.causal)
                           ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sS[r * SP + lane] = p0;
      sS[r * SP + lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v; thread owns rows 4*ty + i, dims tx + 16*j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[4 * ty + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sS[(4 * ty + i) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // sK, sV and sS are overwritten by the next tile
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const int s = q0 + r / G;
    if (r >= R || s >= S) continue;
    const float l = fmaxf(sL[r], 1e-30f);
    const long long row = (((long long)b * S + s) * KVH + h) * head_stride +
                          (r % G) * DH;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[row + tx + 16 * j] = from_f<T>(acc[i][j] / l);
    if (tx == 0) {
      p.lse[(((long long)b * KVH + h) * S + s) * G + r % G] = sM[r] + logf(l);
    }
  }
}

static_assert(sizeof(float) * smem_floats<256>() <= 227 * 1024,
              "head_dim 256 exceeds a Hopper block's shared memory");

template <typename T, int DH>
LaunchPlan plan(const Params& p, int B) {
  return {reinterpret_cast<const void*>(flash_fwd<T, DH>),
          dim3((p.S + p.BQ - 1) / p.BQ, p.KVH, B), kThreads,
          sizeof(float) * smem_floats<DH>()};
}

template <typename T, int DH>
cudaError_t launch(const Params& p, int B, cudaStream_t st) {
  const LaunchPlan lp = plan<T, DH>(p, B);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lp.smem);
  if (e != cudaSuccess) return e;
  flash_fwd<T, DH><<<lp.grid, lp.threads, lp.smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The launch flash_attn_fwd makes at these shapes (write_plans).
extern "C" int flash_attn_fwd_plan(int B, int S, int KVH, int G, int dh,
                                   int is_bf16, long long* out) {
  if (G < 1 || G > kRows) return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return write_plans(nullptr, 0, out);
  Params p{};
  p.S = S;
  p.KVH = KVH;
  p.G = G;
  p.BQ = kRows / G;
  LaunchPlan lp;
  if (dh == 64) {
    lp = is_bf16 ? plan<__nv_bfloat16, 64>(p, B) : plan<float, 64>(p, B);
  } else if (dh == 128) {
    lp = is_bf16 ? plan<__nv_bfloat16, 128>(p, B) : plan<float, 128>(p, B);
  } else if (dh == 256) {
    lp = is_bf16 ? plan<__nv_bfloat16, 256>(p, B) : plan<float, 256>(p, B);
  } else {
    return cudaErrorInvalidValue;
  }
  return write_plans(&lp, 1, out);
}

// q [B, S, KVH*G, dh], k and v [B, S, KVH, dh], contiguous, f32 or bf16;
// lengths [B] int32 (<= S); o like q; lse [B, KVH, S, G] f32.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const int* lengths, void* o, float* lse, int B,
                              int S, int KVH, int G, int dh, int window,
                              float softcap, int causal, float scale,
                              int is_bf16, void* stream) {
  if (G < 1 || G > kRows) return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const Params p{q, k, v, lengths, o, lse, S, KVH, G, kRows / G, window,
                 causal, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 64) {
    return is_bf16 ? launch<__nv_bfloat16, 64>(p, B, st)
                   : launch<float, 64>(p, B, st);
  }
  if (dh == 128) {
    return is_bf16 ? launch<__nv_bfloat16, 128>(p, B, st)
                   : launch<float, 128>(p, B, st);
  }
  if (dh == 256) {
    return is_bf16 ? launch<__nv_bfloat16, 256>(p, B, st)
                   : launch<float, 256>(p, B, st);
  }
  return cudaErrorInvalidValue;
}
