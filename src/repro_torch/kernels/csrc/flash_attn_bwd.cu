// Flash-attention backward: dQ, and dK with dV, by recomputation from the
// forward's per-row logsumexp.
//
// Replaces the two TPU kernels of src/repro/kernels/flash_attention.py:
// _bwd_dq_call (_flash_attn_bwd_dq_kernel), grid (B, KVH, S/bq, S/bk) with
// the KV axis innermost accumulating dQ in VMEM scratch, and _bwd_dkv_call
// (_flash_attn_bwd_dkv_kernel), grid (B, KVH, S/bk, S/bq) with the query
// axis innermost accumulating dK and dV.  Both recompute, per tile,
//
//     s  = q k^T * scale   (tanh-capped when softcap > 0)
//     p  = exp(s - lse)    (explicitly 0 on masked lanes)
//     dp = dO v^T
//     ds = p (dp - delta)  (times 1 - (s/cap)^2 when capped)
//
// and dQ = ds k * scale, dK = ds^T q * scale, dV = p^T dO; delta =
// rowsum(dO * O) comes in from the wrapper, as on the TPU.
//
// What bounds them on an H100: operations.  At the first-order shape (B=4,
// S=512, 32 query heads over 8 KV heads, head_dim 64, causal) the dQ pass
// does 6*dh FLOP per live (query, key) pair, 6.45 GFLOP, against ~59 MB of
// q, k, v, dO, lse, delta and dQ; the dK/dV pass 8*dh, 8.61 GFLOP.  In f32
// on the CUDA cores (67 TFLOP/s) that is ~0.10 and ~0.13 ms of arithmetic
// against ~0.02 ms of memory.
//
// Design (simple and right first; wgmma and TMA come later):
// * the TPU's sequential accumulating grid axis becomes a loop inside one
//   block, so every output element is written by exactly one block: no
//   atomics, and two calls give bit-equal results;
// * dQ: one block per (batch row, KV head, 64 score rows = BQ queries x G
//   heads folded, as in flash_attn.cu), looping over 64-key tiles with the
//   forward's pruning predicate (_block_needed); dQ accumulates in
//   registers;
// * dK/dV: one block per (batch row, KV head, 64-key tile), looping over
//   the folded query tiles that can see the tile, from the causal frontier
//   up to the window's end; dK and dV accumulate in registers;
// * operands are read in the model layout ([B, S, H, dh], [B, S, KVH, dh])
//   and widened to f32 on load; the ragged edge of S and keys past
//   lengths[b] are masked here; outputs are f32 (the wrapper casts);
// * q, dO, k and v tiles, p and ds live in shared memory (above 48 KB at
//   both head dims, so the launch opts in), CUDA-core FMAs over a 4x4
//   register tile per thread.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kRows = 64;  // score rows per query tile: BQ queries x G heads
constexpr int kBK = 64;    // keys per tile
constexpr int kThreads = 256;
constexpr int kSP = kBK + 1;  // padded row of the p and ds tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int* lengths;
  const float* lse;    // [B, KVH, S, G]
  const float* delta;  // [B, KVH, S, G]
  float* dq;           // [B, S, KVH*G, dh]
  float* dk;           // [B, S, KVH, dh]
  float* dv;
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

// _block_needed: does the key tile at k0 hold a live pair for a row of the
// query tile at q0?
__device__ __forceinline__ bool tile_needed(const Params& p, int L, int q0,
                                            int k0) {
  bool needed = k0 < L;
  if (p.causal) needed = needed && k0 <= q0 + p.BQ - 1;
  if (p.window) needed = needed && k0 + kBK - 1 > q0 - p.window;
  return needed;
}

// Folded rows of a [B, S, KVH*G, DH] tensor into dst [kRows][DH + 1]: row r
// <-> query q0 + r / G, head h*G + r % G; rows past R or S read as 0.
template <typename T, int DH>
__device__ void load_rows(float* dst, const void* src_, const Params& p,
                          int b, int h, int q0) {
  const T* src = static_cast<const T*>(src_);
  const int R = p.BQ * p.G;
  for (int i = threadIdx.x; i < kRows * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int s = q0 + r / p.G;
    float x = 0.f;
    if (r < R && s < p.S) {
      x = to_f(src[((((long long)b * p.S + s) * p.KVH + h) * p.G + r % p.G) *
                       DH + d]);
    }
    dst[r * (DH + 1) + d] = x;
  }
}

// Keys k0.. of a [B, S, KVH, DH] tensor into dst [kBK][DH + 1]; past S: 0.
template <typename T, int DH>
__device__ void load_keys(float* dst, const void* src_, const Params& p,
                          int b, int h, int k0) {
  const T* src = static_cast<const T*>(src_);
  for (int i = threadIdx.x; i < kBK * DH; i += kThreads) {
    const int c = i / DH, d = i % DH;
    const int key = k0 + c;
    dst[c * (DH + 1) + d] =
        key < p.S ? to_f(src[(((long long)b * p.S + key) * p.KVH + h) * DH +
                             d])
                  : 0.f;
  }
}

__device__ void load_row_stats(float* sLse, float* sDelta, const Params& p,
                               int b, int h, int q0) {
  const int R = p.BQ * p.G;
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int s = q0 + r / p.G;
    const bool ok = r < R && s < p.S;
    const long long i =
        (((long long)b * p.KVH + h) * p.S + s) * p.G + r % p.G;
    sLse[r] = ok ? p.lse[i] : 0.f;
    sDelta[r] = ok ? p.delta[i] : 0.f;
  }
}

// p and ds of one (query tile, key tile) into sP (when non-null) and sDS,
// [kRows][kSP]; thread (ty, tx) computes rows 4*ty + i and keys tx + 16*j.
template <int DH>
__device__ void tile_p_ds(const float* sQ, const float* sDO, const float* sK,
                          const float* sV, const float* sLse,
                          const float* sDelta, float* sP, float* sDS,
                          const Params& p, int L, int q0, int k0) {
  constexpr int DP = DH + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int R = p.BQ * p.G;
  float sc[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < DH; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = sQ[(4 * ty + i) * DP + d];
      oa[i] = sDO[(4 * ty + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = sK[(tx + 16 * j) * DP + d];
      vb[j] = sV[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const int pos = q0 + r / p.G;
    const bool row_ok = r < R && pos < p.S;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float s = sc[i][j] * p.scale;
      if (p.softcap != 0.f) s = tanhf(s / p.softcap) * p.softcap;
      float pr = 0.f, ds = 0.f;
      if (row_ok && live(k0 + c, pos, L, p.window, p.causal)) {
        pr = expf(s - sLse[r]);
        ds = pr * (dp[i][j] - sDelta[r]);
        if (p.softcap != 0.f) {
          const float t = s / p.softcap;  // s is the capped logit
          ds *= 1.f - t * t;
        }
      }
      if (sP != nullptr) sP[r * kSP + c] = pr;
      sDS[r * kSP + c] = ds;
    }
  }
}

template <int DH>
constexpr size_t dq_smem_floats() {
  return 2 * (size_t)kRows * (DH + 1) + 2 * (size_t)kBK * (DH + 1) +
         (size_t)kRows * kSP + 2 * kRows;
}

template <int DH>
constexpr size_t dkv_smem_floats() {
  return 2 * (size_t)kRows * (DH + 1) + 2 * (size_t)kBK * (DH + 1) +
         2 * (size_t)kRows * kSP + 2 * kRows;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(Params p) {
  constexpr int DP = DH + 1;
  constexpr int DJ = DH / 16;  // dQ columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                // [kRows][DP]
  float* sDO = sQ + kRows * DP;    // [kRows][DP]
  float* sK = sDO + kRows * DP;    // [kBK][DP]
  float* sV = sK + kBK * DP;       // [kBK][DP]
  float* sDS = sV + kBK * DP;      // [kRows][kSP]
  float* sLse = sDS + kRows * kSP;
  float* sDelta = sLse + kRows;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * p.BQ;
  const int L = p.lengths[b];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<T, DH>(sQ, p.q, p, b, h, q0);
  load_rows<T, DH>(sDO, p.dout, p, b, h, q0);
  load_row_stats(sLse, sDelta, p, b, h, q0);
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  __syncthreads();

  const int n_tiles = (p.S + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    if (!tile_needed(p, L, q0, k0)) continue;  // uniform over the block
    load_keys<T, DH>(sK, p.k, p, b, h, k0);
    load_keys<T, DH>(sV, p.v, p, b, h, k0);
    __syncthreads();
    tile_p_ds<DH>(sQ, sDO, sK, sV, sLse, sDelta, nullptr, sDS, p, L, q0, k0);
    __syncthreads();
    // dQ += ds @ k: thread owns rows 4*ty + i, dims tx + 16*j
    for (int c = 0; c < kBK; ++c) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sDS[(4 * ty + i) * kSP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = sK[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
    __syncthreads();  // sK, sV and sDS are overwritten by the next tile
  }

  const int R = p.BQ * p.G;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const int s = q0 + r / p.G;
    if (r >= R || s >= p.S) continue;
    const long long row =
        ((((long long)b * p.S + s) * p.KVH + h) * p.G + r % p.G) * DH;
#pragma unroll
    for (int j = 0; j < DJ; ++j) p.dq[row + tx + 16 * j] = acc[i][j] * p.scale;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv(Params p) {
  constexpr int DP = DH + 1;
  constexpr int DJ = DH / 16;  // dK/dV columns per thread
  extern __shared__ float smem[];
  float* sK = smem;                // [kBK][DP]
  float* sV = sK + kBK * DP;       // [kBK][DP]
  float* sQ = sV + kBK * DP;       // [kRows][DP]
  float* sDO = sQ + kRows * DP;    // [kRows][DP]
  float* sP = sDO + kRows * DP;    // [kRows][kSP]
  float* sDS = sP + kRows * kSP;   // [kRows][kSP]
  float* sLse = sDS + kRows * kSP;
  float* sDelta = sLse + kRows;

  const int b = blockIdx.z, h = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const int L = p.lengths[b];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int R = p.BQ * p.G;

  load_keys<T, DH>(sK, p.k, p, b, h, k0);
  load_keys<T, DH>(sV, p.v, p, b, h, k0);
  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // the query tiles that can see this key tile: from the causal frontier
  // (the tile holding query k0) to the last one inside the window
  const int n_q = (p.S + p.BQ - 1) / p.BQ;
  const int t_begin = p.causal ? k0 / p.BQ : 0;
  int t_end = n_q;
  if (p.window) t_end = min(n_q, (k0 + kBK - 1 + p.window + p.BQ - 1) / p.BQ);
  for (int t = t_begin; t < t_end; ++t) {
    const int q0 = t * p.BQ;
    if (!tile_needed(p, L, q0, k0)) continue;  // uniform over the block
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, DH>(sQ, p.q, p, b, h, q0);
    load_rows<T, DH>(sDO, p.dout, p, b, h, q0);
    load_row_stats(sLse, sDelta, p, b, h, q0);
    __syncthreads();
    tile_p_ds<DH>(sQ, sDO, sK, sV, sLse, sDelta, sP, sDS, p, L, q0, k0);
    __syncthreads();
    // dV += p^T dO, dK += ds^T q: thread owns keys 4*ty + i, dims tx + 16*j
    for (int r = 0; r < R; ++r) {
      float pv[4], dsv[4], qv[DJ], ov[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[r * kSP + 4 * ty + i];
        dsv[i] = sDS[r * kSP + 4 * ty + i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        qv[j] = sQ[r * DP + tx + 16 * j];
        ov[j] = sDO[r * DP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv[i][j] = fmaf(pv[i], ov[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= p.S) continue;
    const long long row = (((long long)b * p.S + key) * p.KVH + h) * DH;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      p.dk[row + tx + 16 * j] = dk[i][j] * p.scale;
      p.dv[row + tx + 16 * j] = dv[i][j];
    }
  }
}

template <typename T, int DH>
LaunchPlan plan_dq(const Params& p, int B) {
  return {reinterpret_cast<const void*>(flash_bwd_dq<T, DH>),
          dim3((p.S + p.BQ - 1) / p.BQ, p.KVH, B), kThreads,
          sizeof(float) * dq_smem_floats<DH>()};
}

template <typename T, int DH>
LaunchPlan plan_dkv(const Params& p, int B) {
  return {reinterpret_cast<const void*>(flash_bwd_dkv<T, DH>),
          dim3((p.S + kBK - 1) / kBK, p.KVH, B), kThreads,
          sizeof(float) * dkv_smem_floats<DH>()};
}

template <typename T, int DH>
cudaError_t launch_dq(const Params& p, int B, cudaStream_t st) {
  const LaunchPlan lp = plan_dq<T, DH>(p, B);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lp.smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dq<T, DH><<<lp.grid, lp.threads, lp.smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const Params& p, int B, cudaStream_t st) {
  const LaunchPlan lp = plan_dkv<T, DH>(p, B);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lp.smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dkv<T, DH><<<lp.grid, lp.threads, lp.smem, st>>>(p);
  return cudaGetLastError();
}

int check_shape(int B, int S, int G, int dh) {
  if (G < 1 || G > kRows || (dh != 64 && dh != 128)) {
    return cudaErrorInvalidValue;
  }
  return (B == 0 || S == 0) ? -1 : 0;  // -1: nothing to launch
}

}  // namespace

// q, dout [B, S, KVH*G, dh] and k, v [B, S, KVH, dh], contiguous, all f32
// or all bf16; lengths [B] int32 (<= S); lse, delta [B, KVH, S, G] f32;
// dq [B, S, KVH*G, dh] f32.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const int* lengths,
                                 const float* lse, const float* delta,
                                 float* dq, int B, int S, int KVH, int G,
                                 int dh, int window, float softcap,
                                 int causal, float scale, int is_bf16,
                                 void* stream) {
  const int rc = check_shape(B, S, G, dh);
  if (rc) return rc < 0 ? 0 : rc;
  const Params p{q, k, v, dout, lengths, lse, delta, dq, nullptr, nullptr,
                 S, KVH, G, kRows / G, window, causal, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 64) {
    return is_bf16 ? launch_dq<__nv_bfloat16, 64>(p, B, st)
                   : launch_dq<float, 64>(p, B, st);
  }
  return is_bf16 ? launch_dq<__nv_bfloat16, 128>(p, B, st)
                 : launch_dq<float, 128>(p, B, st);
}

// Arguments as flash_attn_bwd_dq; dk, dv [B, S, KVH, dh] f32.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const int* lengths, const float* lse,
                                  const float* delta, float* dk, float* dv,
                                  int B, int S, int KVH, int G, int dh,
                                  int window, float softcap, int causal,
                                  float scale, int is_bf16, void* stream) {
  const int rc = check_shape(B, S, G, dh);
  if (rc) return rc < 0 ? 0 : rc;
  const Params p{q, k, v, dout, lengths, lse, delta, nullptr, dk, dv,
                 S, KVH, G, kRows / G, window, causal, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 64) {
    return is_bf16 ? launch_dkv<__nv_bfloat16, 64>(p, B, st)
                   : launch_dkv<float, 64>(p, B, st);
  }
  return is_bf16 ? launch_dkv<__nv_bfloat16, 128>(p, B, st)
                 : launch_dkv<float, 128>(p, B, st);
}

// The launch flash_attn_bwd_dq (dkv = 0) or flash_attn_bwd_dkv (dkv = 1)
// makes at these shapes (write_plans).
extern "C" int flash_attn_bwd_plan(int dkv, int B, int S, int KVH, int G,
                                   int dh, int is_bf16, long long* out) {
  const int rc = check_shape(B, S, G, dh);
  if (rc > 0) return rc;
  if (rc < 0) return write_plans(nullptr, 0, out);
  Params p{};
  p.S = S;
  p.KVH = KVH;
  p.G = G;
  p.BQ = kRows / G;
  LaunchPlan lp;
  if (dh == 64) {
    lp = dkv ? (is_bf16 ? plan_dkv<__nv_bfloat16, 64>(p, B)
                        : plan_dkv<float, 64>(p, B))
             : (is_bf16 ? plan_dq<__nv_bfloat16, 64>(p, B)
                        : plan_dq<float, 64>(p, B));
  } else {
    lp = dkv ? (is_bf16 ? plan_dkv<__nv_bfloat16, 128>(p, B)
                        : plan_dkv<float, 128>(p, B))
             : (is_bf16 ? plan_dq<__nv_bfloat16, 128>(p, B)
                        : plan_dq<float, 128>(p, B));
  }
  return write_plans(&lp, 1, out);
}
