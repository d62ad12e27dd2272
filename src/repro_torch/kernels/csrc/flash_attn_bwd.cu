// Flash-attention backward: dQ, and dK with dV, by recomputation from the
// forward's per-row logsumexp, on the tensor cores at f32 accuracy.
//
// Replaces the two TPU kernels of src/repro/kernels/flash_attention.py:
// _bwd_dq_call (:285, _flash_attn_bwd_dq_kernel), grid (B, KVH, S/bq,
// S/bk) with the KV axis innermost accumulating dQ in VMEM scratch, and
// _bwd_dkv_call (:310, _flash_attn_bwd_dkv_kernel), grid (B, KVH, S/bk,
// S/bq) with the query axis innermost accumulating dK and dV.  Both
// recompute, per tile,
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
// does 6*dh FLOP per live (query, key) pair, 6.44 GFLOP, against ~59 MB of
// q, k, v, dO, lse, delta and dQ (~0.02 ms); the dK/dV pass 8*dh, 8.61
// GFLOP.  On the CUDA cores in f32 (67 TFLOP/s) that is 0.096 and 0.128 ms.
// As 3xTF32 on the tensor cores (three TF32 products for each f32 one, 495
// TFLOP/s), 3 x 6.44 and 3 x 8.61 GFLOP: about 0.039 and 0.052 ms.
//
// Design:
// * precision, fixed here (torch.backends.cuda.matmul.allow_tf32 is not
//   read): all five products (s, dp, and dQ or dK and dV) run as
//   mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.  Each f32 operand
//   is split as hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi) (that
//   rounding in two integer operations, tf32_rna), and each product is
//   lo*hi + hi*lo + hi*hi accumulated in f32 (3xTF32): over a 64x64x64
//   tile it stays within ~5e-7 of max|exact| where one TF32 pass misses by
//   ~3e-4 (tests/test_torch_tf32_split.py emulates both).  A bf16 operand
//   widened to f32 is exact in TF32 (lo = 0), so with bf16 inputs s and dp
//   take one pass and the products with p or ds two.  The tensor cores sum
//   a tile's few k-steps; the long sum over tiles (dQ over key tiles, dK
//   and dV over query tiles: 8,704 rows at Gemma's 4352 x G 2) is taken in
//   IEEE f32 adds, which keeps it as close to f64 as the plain version;
// * the TPU's sequential accumulating grid axis becomes a loop inside one
//   block, so every output element is written by exactly one block: no
//   atomics, and two calls give bit-equal results;
// * dQ: one block per (batch row, KV head, R score rows = BQ queries x G
//   heads folded, as in flash_attn.cu), looping over 32-key tiles with the
//   forward's pruning predicate (_block_needed); blocks of the latest query
//   tiles, the heaviest under causal masking, launch first;
// * dK/dV: one block per (batch row, KV head, pair of 32-key tiles t and
//   n-1-t), each tile looping over the query tiles that can see it, from
//   the causal frontier up to the window's end: under causal masking the
//   two ranges sum to the same length for every t, so every block does the
//   same work (34 query tiles at the first-order shape, 256 blocks);
// * R score rows a query tile, a tiling chosen per call (TilingsOf,
//   plans.py FLASH_BWD_TILINGS): 64 (the default) or 32 at head_dim 64 and
//   128, and 32 at 256 (so G <= 32 there), where two 64-row tiles and the
//   streamed ones would not fit; G <= R.  8 warps, each an m16 strip of
//   the block's tile and a share of its columns; 32 keys a tile in every
//   tiling (at 16 the dK/dV warps would hold one n8 tile of dK at head_dim
//   64, where they take two at a time, and at 64 the f32 tiles outgrow a
//   block's shared memory);
// * copies: the streamed tiles (k, v in dQ; q, dO, lse and delta in dK/dV)
//   are double-buffered with cp.async (16-byte .cg for the operands,
//   4-byte for the row statistics), the next tile's copy in flight while
//   the current one computes; rows past S or the folded R, and keys past S,
//   are zero-filled by the copy; operands stay in their own type in shared
//   memory (bf16 widens at the fragment load);
// * splits: an operand element is split when a fragment load reads it,
//   except where it would be split many times: p and ds are split once
//   when written, and f32 k and v tiles once when they land (dQ at
//   head_dim <= 128, dK/dV at 128; kPreKeysDq, kPreKeysDkv), each into a
//   hi and a lo plane;
// * layout: the 16-byte chunks of a tile row are permuted by the row (swz),
//   so that fragment loads along either axis of a tile (k as B of q k^T,
//   then of ds k) hit 32 distinct banks and a chunk stays whole for
//   cp.async;
// * operands are read in the model layout ([B, S, H, dh], [B, S, KVH, dh]),
//   16-byte aligned (a pointer off it is refused); keys past lengths[b] are
//   masked here; outputs are f32 (the wrapper casts);
// * the dynamic shared memory (32-230 KB) is granted through the
//   per-device high-water mark of common.cuh: one attribute call per
//   instantiation (kernel, type, head_dim, tiling) and device, not one per
//   launch;
// * flash_attn_bwd_probe, a launch outside the wrapped path, has each block
//   record the tiles it walked and its clocks (the balance above, read on
//   the card), and runs the one-pass TF32 control of the split.
// The split, the fragment loaders, the tile layout and the copies are
// shared with the forward (tf32_mma.cuh).
#include <cstdint>
#include <tuple>

#include "common.cuh"
#include "tf32_mma.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;  // keys per tile, both kernels
constexpr int kSmemSM = 233472;  // an H100 SM's shared memory, 1 KB/block

// A tiling: R score rows a query tile (BQ = R / G queries x G heads
// folded) and BK keys a tile.
template <int R_, int BK_ = kBK>
struct Tiling {
  static constexpr int R = R_, BK = BK_;
};
// The tilings of each head dim, the default first (plans.py
// FLASH_BWD_TILINGS repeats them).
template <int DH>
struct TilingsOf {
  using type = std::tuple<Tiling<64>, Tiling<32>>;
};
template <>
struct TilingsOf<256> {
  using type = std::tuple<Tiling<32>>;
};
constexpr int kTilings = 2;  // at most, per head dim

// f32 key tiles are split once when they land, their lo planes beside
// them, where the shared memory allows: in dQ (double-buffered k and v, 4
// warps loading each element) at head_dim <= 128, in dK/dV (k and v for
// a whole key tile) at 128 only, as at 64 the planes would cut it to one
// block an SM, which costs more than the splits save; otherwise, and for
// bf16 (exact), each fragment load splits
template <typename T, int DH>
constexpr bool kPreKeysDq = !kExactTf32<T> && DH <= 128;
template <typename T, int DH>
constexpr bool kPreKeysDkv = !kExactTf32<T> && DH == 128;

// dQ: q and dO [R][DH]; k and v [2][kBK][DH] (T); ds as TF32 hi and lo
// [2][R][kBK], lse and delta [R] (f32); with kPreKeysDq the lo planes of
// k and v [2][2][kBK][DH].
template <typename T, int DH, int R>
constexpr size_t kDqSmem =
    sizeof(T) * (2 * R * DH + 4 * kBK * DH) +
    sizeof(float) * (2 * R * kBK + 2 * R) +
    (kPreKeysDq<T, DH> ? sizeof(uint32_t) * 4 * kBK * DH : 0);

// dK/dV: k and v [kBK][DH]; q and dO [2][R][DH] (T); p^T and ds^T as hi
// and lo [4][kBK][R], lse and delta [2][R] (f32); with kPreKeysDkv the
// lo planes of k and v [2][kBK][DH].
template <typename T, int DH, int R>
constexpr size_t kDkvSmem =
    sizeof(T) * (2 * kBK * DH + 4 * R * DH) +
    sizeof(float) * (4 * kBK * R + 4 * R) +
    (kPreKeysDkv<T, DH> ? sizeof(uint32_t) * 2 * kBK * DH : 0);

// blocks an SM is to hold: 2 where their shared memory fits and head_dim
// <= 128 (the registers are then capped at 128 by __launch_bounds__; at
// 256 that would spill), else 1
template <int DH, size_t kSmem>
constexpr int kMinBlocks =
    DH <= 128 && 2 * (kSmem + 1024) <= (size_t)kSmemSM ? 2 : 1;

constexpr size_t kSmemOptin = 232448;  // a Hopper block's opt-in limit
static_assert(kDqSmem<float, 256, 32> <= kSmemOptin, "dQ tiles at dh 256");
static_assert(kDkvSmem<float, 256, 32> <= kSmemOptin, "dK/dV tiles, dh 256");
static_assert(kDqSmem<float, 128, 64> <= kSmemOptin, "dQ tiles at dh 128");
static_assert(kDkvSmem<float, 128, 64> <= kSmemOptin, "dK/dV tiles, dh 128");
static_assert(kMinBlocks<64, kDqSmem<float, 64, 64>> == 2, "dQ: 2 per SM");
static_assert(kMinBlocks<64, kDkvSmem<float, 64, 64>> == 2, "dK/dV: 2 an SM");

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
  long long* blocks;  // per-block record (flash_attn_bwd_probe), or null
};

// lse and delta of the folded rows q0.. into [R] each; past the rows: 0.
template <int R>
__device__ void copy_stats(float* sLse, float* sDelta, const Params& p,
                           int b, int h, int q0, float inv_g) {
  const int r = threadIdx.x;
  if (r >= R) return;
  const int rq = div_g(r, inv_g);
  const int s = q0 + rq;
  const bool ok = r < p.BQ * p.G && s < p.S;
  const long long i =
      ok ? (((long long)b * p.KVH + h) * p.S + s) * p.G + (r - rq * p.G) : 0;
  cp4(sLse + r, p.lse + i, ok);
  cp4(sDelta + r, p.delta + i, ok);
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

// The first key tile from t (before end) the query tile at q0 needs.
__device__ __forceinline__ int next_key_tile(const Params& p, int L, int q0,
                                             int t, int end) {
  while (t < end && !tile_needed(p, L, q0, t * kBK)) ++t;
  return t;
}

// The first query tile from t (before end) that needs the key tile at k0.
__device__ __forceinline__ int next_query_tile(const Params& p, int L, int k0,
                                               int t, int end) {
  while (t < end && !tile_needed(p, L, t * p.BQ, k0)) ++t;
  return t;
}

// p and ds of one score from its s and dp accumulators.
__device__ __forceinline__ void p_ds(float acc_s, float acc_dp, float lse,
                                     float delta, bool ok, const Params& p,
                                     float& pr, float& ds) {
  float s = acc_s * p.scale;
  if (p.softcap != 0.f) s = tanhf(s / p.softcap) * p.softcap;
  pr = 0.f;
  ds = 0.f;
  if (ok) {
    pr = expf(s - lse);
    ds = pr * (acc_dp - delta);
    if (p.softcap != 0.f) {
      const float t = s / p.softcap;  // s is the capped logit
      ds *= 1.f - t * t;
    }
  }
}

// ----------------------------------------------------------------- dQ ----
// kOne (flash_attn_bwd_probe's precision control only): every product
// one TF32 pass, hi*hi.
template <typename T, int DH, int R, bool kOne = false>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DH, kDqSmem<T, DH, R>>)
    flash_bwd_dq(Params p) {
  constexpr int MT = R / 16;               // m16 tiles over the rows
  constexpr int WPM = kWarps / MT;         // warps sharing an m16 tile
  constexpr int SN = (kBK / 8) / WPM;      // s, dp n8 tiles per warp
  constexpr int QN = (DH / 8) / WPM;       // dQ n8 tiles per warp
  constexpr bool kX = kExactTf32<T> || kOne;  // no operand lo terms
  constexpr bool kPre = kPreKeysDq<T, DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sDO = sQ + R * DH;
  T* sK = sDO + R * DH;       // [2][kBK * DH]
  T* sV = sK + 2 * kBK * DH;  // [2][kBK * DH]
  uint32_t* sDSh = reinterpret_cast<uint32_t*>(sV + 2 * kBK * DH);
  uint32_t* sDSl = sDSh + R * kBK;
  float* sLse = reinterpret_cast<float*>(sDSl + R * kBK);
  float* sDelta = sLse + R;
  uint32_t* sKl = reinterpret_cast<uint32_t*>(sDelta + R);  // with kPre
  uint32_t* sVl = sKl + 2 * kBK * DH;
  const Opnd<T, DH> oQ{sQ, nullptr}, oDO{sDO, nullptr};
  const Opnd<float, kBK, true> oDS{reinterpret_cast<const float*>(sDSh),
                                   sDSl};

  const long long c0 = p.blocks ? clock64() : 0;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * p.BQ;  // heaviest first
  const int L = min(max(p.lengths[b], 0), p.S);  // clamped here
  const float inv_g = 1.f / p.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int m0 = 16 * (warp % MT), wn = warp / MT;
  const int n_k = (p.S + kBK - 1) / kBK;
  const int rows = p.BQ * p.G;
  // this thread's score rows m0 + g + 8 * hf: their query, or -1 past R or S
  int pos[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = m0 + g + 8 * hf;
    pos[hf] = q0 + div_g(r, inv_g);
    if (r >= rows || pos[hf] >= p.S) pos[hf] = -1;
  }

  copy_rows<T, DH, R, kThreads>(sQ, p.q, p, b, h, q0, inv_g);
  copy_rows<T, DH, R, kThreads>(sDO, p.dout, p, b, h, q0, inv_g);
  copy_stats<R>(sLse, sDelta, p, b, h, q0, inv_g);
  int t = next_key_tile(p, L, q0, 0, n_k);
  if (t < n_k) {
    copy_keys<T, DH, kBK, kThreads>(sK, p.k, p, b, h, t * kBK);
    copy_keys<T, DH, kBK, kThreads>(sV, p.v, p, b, h, t * kBK);
  }
  cp_commit();

  float acc[QN][4];
  zero(acc);
  int walked = 0;
  for (int buf = 0; t < n_k; buf ^= 1, ++walked) {  // uniform over the block
    const int k0 = t * kBK;
    const int t_next = next_key_tile(p, L, q0, t + 1, n_k);
    if (t_next < n_k) {
      const int o = (buf ^ 1) * kBK * DH;
      copy_keys<T, DH, kBK, kThreads>(sK + o, p.k, p, b, h, t_next * kBK);
      copy_keys<T, DH, kBK, kThreads>(sV + o, p.v, p, b, h, t_next * kBK);
    }
    cp_commit();
    cp_wait<1>();  // this tile (and q, dO, the statistics) have landed
    const int o = buf * kBK * DH;
    if constexpr (kPre) {
      split_chunks<kBK, DH, kThreads>(reinterpret_cast<float*>(sK + o),
                                      sKl + o);
      split_chunks<kBK, DH, kThreads>(reinterpret_cast<float*>(sV + o),
                                      sVl + o);
    }
    __syncthreads();
    const Opnd<T, DH, kPre> cK{sK + o, sKl + o}, cV{sV + o, sVl + o};

    // s = q k^T and dp = dO v^T: rows m0.., keys 8 * (wn * SN + j)..
    float s[SN][4], dp[SN][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < DH; kk += 8) {
      uint32_t qh[4], ql[4], oh[4], ol[4];
      uint32_t kh[SN][2], kl[SN][2], vh[SN][2], vl[SN][2];
      frag_a(oQ, m0, kk, lane, qh, ql);
      frag_a(oDO, m0, kk, lane, oh, ol);
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        const int n0 = 8 * (wn * SN + j);
        frag_b_nk(cK, kk, n0, lane, kh[j], kl[j]);
        frag_b_nk(cV, kk, n0, lane, vh[j], vl[j]);
      }
      if (!kX) {
        mma_row(s, 0, ql, kh);
        mma_row(dp, 0, ol, vh);
        mma_row(s, 0, qh, kl);
        mma_row(dp, 0, oh, vl);
      }
      mma_row(s, 0, qh, kh);
      mma_row(dp, 0, oh, vh);
    }
    // ds, split, into shared memory; accumulator i holds row g + 8 * (i /
    // 2), column c2 + i % 2 of its n8 tile
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0 + g + 8 * hf;
        const int c = 8 * (wn * SN + j) + c2;
        float pr, d0, d1;
        p_ds(s[j][2 * hf], dp[j][2 * hf], sLse[r], sDelta[r],
             pos[hf] >= 0 && live(k0 + c, pos[hf], L, p.window, p.causal),
             p, pr, d0);
        p_ds(s[j][2 * hf + 1], dp[j][2 * hf + 1], sLse[r], sDelta[r],
             pos[hf] >= 0 && live(k0 + c + 1, pos[hf], L, p.window, p.causal),
             p, pr, d1);
        st_split<kBK>(sDSh, sDSl, r, c, d0, d1);
      }
    __syncthreads();

    // dQ += ds k: rows m0.., dims 8 * (wn * QN + j).., two n8 tiles at a
    // time; the tile's sum goes into acc in f32 adds
    float part[QN][4];
    zero(part);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t dh[4], dl[4];
      frag_a(oDS, m0, kk, lane, dh, dl);
#pragma unroll
      for (int j = 0; j < QN; j += 2) {
        uint32_t kh[2][2], kl[2][2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          frag_b_kn(cK, kk, 8 * (wn * QN + j + u), lane, kh[u], kl[u]);
        }
        if (!kOne) mma_row(part, j, dl, kh);
        if (!kX) mma_row(part, j, dh, kl);
        mma_row(part, j, dh, kh);
      }
    }
    add_into(acc, part);
    __syncthreads();  // this tile's k, v and ds are overwritten next
    t = t_next;
  }
  cp_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (pos[hf] < 0) continue;
    const int r = m0 + g + 8 * hf;
    float* row = p.dq + ((((long long)b * p.S + pos[hf]) * p.KVH + h) * p.G +
                         (r - (pos[hf] - q0) * p.G)) * DH;
#pragma unroll
    for (int j = 0; j < QN; ++j) {
      *reinterpret_cast<float2*>(row + 8 * (wn * QN + j) + c2) = make_float2(
          acc[j][2 * hf] * p.scale, acc[j][2 * hf + 1] * p.scale);
    }
  }
  record(p.blocks, walked, c0);
}

// -------------------------------------------------------------- dK/dV ----
template <typename T, int DH, int R, bool kOne = false>
__global__ void __launch_bounds__(kThreads,
                                  kMinBlocks<DH, kDkvSmem<T, DH, R>>)
    flash_bwd_dkv(Params p) {
  constexpr int MT = kBK / 16;             // m16 tiles over the keys
  constexpr int WPM = kWarps / MT;         // warps sharing an m16 tile
  constexpr int SN = (R / 8) / WPM;        // s^T, dp^T n8 tiles per warp
  constexpr int KN = (DH / 8) / WPM;       // dK, dV n8 tiles per warp
  constexpr bool kX = kExactTf32<T> || kOne;  // no operand lo terms
  constexpr bool kPre = kPreKeysDkv<T, DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kBK * DH;
  T* sQ = sV + kBK * DH;     // [2][R * DH]
  T* sDO = sQ + 2 * R * DH;  // [2][R * DH]
  uint32_t* sPh = reinterpret_cast<uint32_t*>(sDO + 2 * R * DH);  // [kBK][R]
  uint32_t* sPl = sPh + kBK * R;
  uint32_t* sDSh = sPl + kBK * R;
  uint32_t* sDSl = sDSh + kBK * R;
  float* sLse = reinterpret_cast<float*>(sDSl + kBK * R);  // [2][R]
  float* sDelta = sLse + 2 * R;                             // [2][R]
  uint32_t* sKl = reinterpret_cast<uint32_t*>(sDelta + 2 * R);  // with kPre
  uint32_t* sVl = sKl + kBK * DH;
  const Opnd<T, DH, kPre> oK{sK, sKl}, oV{sV, sVl};
  const Opnd<float, R, true> oP{reinterpret_cast<const float*>(sPh), sPl};
  const Opnd<float, R, true> oDS{reinterpret_cast<const float*>(sDSh), sDSl};

  const long long c0 = p.blocks ? clock64() : 0;
  const int b = blockIdx.z, h = blockIdx.y;
  const int L = min(max(p.lengths[b], 0), p.S);
  const float inv_g = 1.f / p.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int m0 = 16 * (warp % MT), wn = warp / MT;
  const int rows = p.BQ * p.G;
  const int n_k = (p.S + kBK - 1) / kBK;
  const int n_q = (p.S + p.BQ - 1) / p.BQ;
  // this thread's score rows 8 * (wn * SN + j) + c2 + e: their query's
  // offset in a query tile, or a large value past the folded rows
  int rq[SN][2];
#pragma unroll
  for (int j = 0; j < SN; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * (wn * SN + j) + c2 + e;
      rq[j][e] = r < rows ? div_g(r, inv_g) : p.S;
    }

  // key tiles x and n_k - 1 - x (one tile where they meet)
  int walked = 0;
  for (int pass = 0; pass < 2; ++pass) {
    const int kt = pass == 0 ? blockIdx.x : n_k - 1 - blockIdx.x;
    if (pass == 1 && kt == (int)blockIdx.x) break;
    const int k0 = kt * kBK;
    // the query tiles that can see this key tile: from the causal frontier
    // (the tile holding query k0) to the last one inside the window
    const int t_begin = p.causal ? k0 / p.BQ : 0;
    int t_end = n_q;
    if (p.window) {
      t_end = min(n_q, (k0 + kBK - 1 + p.window + p.BQ - 1) / p.BQ);
    }

    __syncthreads();  // the previous pass's readers of k and v are done
    copy_keys<T, DH, kBK, kThreads>(sK, p.k, p, b, h, k0);
    copy_keys<T, DH, kBK, kThreads>(sV, p.v, p, b, h, k0);
    int t = next_query_tile(p, L, k0, t_begin, t_end);
    if (t < t_end) {
      copy_rows<T, DH, R, kThreads>(sQ, p.q, p, b, h, t * p.BQ, inv_g);
      copy_rows<T, DH, R, kThreads>(sDO, p.dout, p, b, h, t * p.BQ, inv_g);
      copy_stats<R>(sLse, sDelta, p, b, h, t * p.BQ, inv_g);
    }
    cp_commit();

    float dk[KN][4], dv[KN][4];
    zero(dk);
    zero(dv);
    for (int buf = 0, fresh = 1; t < t_end; buf ^= 1, fresh = 0, ++walked) {
      const int q0 = t * p.BQ;  // (the loop is uniform over the block)
      const int t_next = next_query_tile(p, L, k0, t + 1, t_end);
      if (t_next < t_end) {
        const int o = (buf ^ 1) * R * DH;
        const int q1 = t_next * p.BQ;
        copy_rows<T, DH, R, kThreads>(sQ + o, p.q, p, b, h, q1, inv_g);
        copy_rows<T, DH, R, kThreads>(sDO + o, p.dout, p, b, h, q1, inv_g);
        copy_stats<R>(sLse + (buf ^ 1) * R, sDelta + (buf ^ 1) * R, p, b, h,
                      t_next * p.BQ, inv_g);
      }
      cp_commit();
      cp_wait<1>();  // this query tile (and k, v) have landed
      if constexpr (kPre) {
        if (fresh) {
          split_chunks<kBK, DH, kThreads>(reinterpret_cast<float*>(sK), sKl);
          split_chunks<kBK, DH, kThreads>(reinterpret_cast<float*>(sV), sVl);
        }
      }
      __syncthreads();
      const Opnd<T, DH> cQ{sQ + buf * R * DH, nullptr};
      const Opnd<T, DH> cDO{sDO + buf * R * DH, nullptr};
      const float* cLse = sLse + buf * R;
      const float* cDelta = sDelta + buf * R;

      // s^T = k q^T and dp^T = v dO^T: keys m0.., rows 8 * (wn * SN + j)..
      float s[SN][4], dp[SN][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int kk = 0; kk < DH; kk += 8) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        uint32_t qh[SN][2], ql[SN][2], oh[SN][2], ol[SN][2];
        frag_a(oK, m0, kk, lane, kh, kl);
        frag_a(oV, m0, kk, lane, vh, vl);
#pragma unroll
        for (int j = 0; j < SN; ++j) {
          const int n0 = 8 * (wn * SN + j);
          frag_b_nk(cQ, kk, n0, lane, qh[j], ql[j]);
          frag_b_nk(cDO, kk, n0, lane, oh[j], ol[j]);
        }
        if (!kX) {
          mma_row(s, 0, kl, qh);
          mma_row(dp, 0, vl, oh);
          mma_row(s, 0, kh, ql);
          mma_row(dp, 0, vh, ol);
        }
        mma_row(s, 0, kh, qh);
        mma_row(dp, 0, vh, oh);
      }
      // p^T and ds^T, split, into shared memory: accumulator i holds key
      // g + 8 * (i / 2), row c2 + i % 2 of its n8 tile
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int key = m0 + g + 8 * hf;
          const int c = 8 * (wn * SN + j) + c2;
          float pr[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pos = q0 + rq[j][e];
            const bool ok = pos < p.S &&
                            live(k0 + key, pos, L, p.window, p.causal);
            p_ds(s[j][2 * hf + e], dp[j][2 * hf + e], cLse[c + e],
                 cDelta[c + e], ok, p, pr[e], ds[e]);
          }
          st_split<R>(sPh, sPl, key, c, pr[0], pr[1]);
          st_split<R>(sDSh, sDSl, key, c, ds[0], ds[1]);
        }
      __syncthreads();

      // dV += p^T dO, dK += ds^T q: keys m0.., dims 8 * (wn * KN + j)..,
      // two n8 tiles at a time; the tile's sums go into dk, dv in f32 adds
      float dkt[KN][4], dvt[KN][4];
      zero(dkt);
      zero(dvt);
#pragma unroll
      for (int kk = 0; kk < R; kk += 8) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        frag_a(oP, m0, kk, lane, ph, pl);
        frag_a(oDS, m0, kk, lane, dh, dl);
#pragma unroll
        for (int j = 0; j < KN; j += 2) {
          uint32_t oh[2][2], ol[2][2], qh[2][2], ql[2][2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int n0 = 8 * (wn * KN + j + u);
            frag_b_kn(cDO, kk, n0, lane, oh[u], ol[u]);
            frag_b_kn(cQ, kk, n0, lane, qh[u], ql[u]);
          }
          if (!kOne) {
            mma_row(dvt, j, pl, oh);
            mma_row(dkt, j, dl, qh);
          }
          if (!kX) {
            mma_row(dvt, j, ph, ol);
            mma_row(dkt, j, dh, ql);
          }
          mma_row(dvt, j, ph, oh);
          mma_row(dkt, j, dh, qh);
        }
      }
      add_into(dk, dkt);
      add_into(dv, dvt);
      __syncthreads();  // this tile's q, dO, p^T and ds^T are overwritten
      t = t_next;
    }
    cp_wait<0>();

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = k0 + m0 + g + 8 * hf;
      if (key >= p.S) continue;
      const long long row = (((long long)b * p.S + key) * p.KVH + h) * DH;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const int d = 8 * (wn * KN + j) + c2;
        *reinterpret_cast<float2*>(p.dk + row + d) = make_float2(
            dk[j][2 * hf] * p.scale, dk[j][2 * hf + 1] * p.scale);
        *reinterpret_cast<float2*>(p.dv + row + d) =
            make_float2(dv[j][2 * hf], dv[j][2 * hf + 1]);
      }
    }
  }
  record(p.blocks, walked, c0);
}

// ------------------------------------------------------------- launchers --
// Sets p.BQ for the tiling and returns the launch.
template <bool DKV, typename T, int DH, int R, bool kOne = false>
LaunchPlan plan(Params& p, int B) {
  p.BQ = R / p.G;
  if (DKV) {
    const int n_k = (p.S + kBK - 1) / kBK;
    return {reinterpret_cast<const void*>(flash_bwd_dkv<T, DH, R, kOne>),
            dim3((n_k + 1) / 2, p.KVH, B), kThreads, kDkvSmem<T, DH, R>};
  }
  return {reinterpret_cast<const void*>(flash_bwd_dq<T, DH, R, kOne>),
          dim3((p.S + p.BQ - 1) / p.BQ, p.KVH, B), kThreads,
          kDqSmem<T, DH, R>};
}

// Instantiations for the grant: (dQ then dK/dV) x (f32 then bf16) x (head
// dim 64, 128, 256) x the head dim's tilings in TilingsOf order.  The
// probe's one-pass controls have grants of their own, so that the count of
// attribute calls (flash_attn_bwd_smem_state) is the wrapped path's.
constexpr int kInstances = 2 * 2 * 3 * kTilings;
SmemGrants<kInstances> g_grants;
SmemGrants<kInstances> g_one_pass_grants;

int instance(int dkv, int is_bf16, int dh, int tiling) {
  const int d = dh == 64 ? 0 : dh == 128 ? 1 : 2;
  return ((2 * (dkv != 0) + (is_bf16 != 0)) * 3 + d) * kTilings + tiling;
}

template <bool DKV, typename T, int DH, int R, bool kOne = false>
cudaError_t launch(Params p, int B, int tiling, cudaStream_t st) {
  const LaunchPlan lp = plan<DKV, T, DH, R, kOne>(p, B);
  const cudaError_t e =
      (kOne ? g_one_pass_grants : g_grants)
          .grant(lp.fn, instance(DKV, kExactTf32<T>, DH, tiling), lp.smem);
  if (e != cudaSuccess) return e;
  if (DKV) {
    flash_bwd_dkv<T, DH, R, kOne><<<lp.grid, lp.threads, lp.smem, st>>>(p);
  } else {
    flash_bwd_dq<T, DH, R, kOne><<<lp.grid, lp.threads, lp.smem, st>>>(p);
  }
  return cudaGetLastError();
}

template <typename T_, int DH_, int R_>
struct Inst {
  using T = T_;
  static constexpr int DH = DH_, R = R_;
};

// f(Inst<T, DH, R>{}, i) for the tiling (rows, bk) of head dim DH, i its
// index in TilingsOf<DH>; cudaErrorInvalidValue where DH has no such
// tiling (never a default).
template <typename T, int DH, typename F, typename... Ts>
cudaError_t visit_tilings(int rows, int bk, F& f, std::tuple<Ts...>*) {
  cudaError_t e = cudaErrorInvalidValue;
  bool found = false;
  int i = 0;
  auto one = [&](auto t) {
    using Ti = decltype(t);
    if (!found && rows == Ti::R && bk == Ti::BK) {
      found = true;
      e = f(Inst<T, DH, Ti::R>{}, i);
    }
    ++i;
  };
  (one(Ts{}), ...);
  return e;
}

template <typename T, int DH, typename F>
cudaError_t visit_dh(int rows, int bk, F& f) {
  return visit_tilings<T, DH>(
      rows, bk, f, static_cast<typename TilingsOf<DH>::type*>(nullptr));
}

// f(Inst{}, i) for head dim dh (64, 128 or 256), the operand type and the
// tiling (rows, bk).
template <typename F>
cudaError_t visit(int dh, int is_bf16, int rows, int bk, F&& f) {
  if (dh == 64) {
    return is_bf16 ? visit_dh<__nv_bfloat16, 64>(rows, bk, f)
                   : visit_dh<float, 64>(rows, bk, f);
  }
  if (dh == 128) {
    return is_bf16 ? visit_dh<__nv_bfloat16, 128>(rows, bk, f)
                   : visit_dh<float, 128>(rows, bk, f);
  }
  return is_bf16 ? visit_dh<__nv_bfloat16, 256>(rows, bk, f)
                 : visit_dh<float, 256>(rows, bk, f);
}

template <bool DKV>
cudaError_t dispatch(const Params& p, int B, int dh, int is_bf16, int rows,
                     int bk, bool empty, cudaStream_t st) {
  return visit(dh, is_bf16, rows, bk, [&](auto i, int tiling) {
    using I = decltype(i);
    if (empty) return cudaSuccess;  // nothing to launch
    return launch<DKV, typename I::T, I::DH, I::R>(p, B, tiling, st);
  });
}

// head_dim 64, 128 or 256, and 1 <= G <= the tiling's score rows (the
// tiling itself is checked by visit).
int check_shape(int B, int S, int G, int dh, int rows) {
  if (dh != 64 && dh != 128 && dh != 256) return cudaErrorInvalidValue;
  if (G < 1 || G > rows) return cudaErrorInvalidValue;
  return (B == 0 || S == 0) ? -1 : 0;  // -1: nothing to launch
}

// The kernels read the operands in 16-byte chunks.
bool operands_aligned(const void* q, const void* k, const void* v,
                      const void* dout) {
  return aligned(q, 16) && aligned(k, 16) && aligned(v, 16) &&
         aligned(dout, 16);
}

}  // namespace

// q, dout [B, S, KVH*G, dh] and k, v [B, S, KVH, dh], contiguous and
// 16-byte aligned, all f32 or all bf16; lengths [B] int32 (clamped to
// [0, S] here); lse, delta [B, KVH, S, G] f32; dq [B, S, KVH*G, dh] f32.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const int* lengths,
                                 const float* lse, const float* delta,
                                 float* dq, int B, int S, int KVH, int G,
                                 int dh, int window, float softcap,
                                 int causal, float scale, int is_bf16,
                                 int rows, int bk, void* stream) {
  const int rc = check_shape(B, S, G, dh, rows);
  if (rc > 0) return rc;
  if (!operands_aligned(q, k, v, dout)) return cudaErrorMisalignedAddress;
  const Params p{q, k, v, dout, lengths, lse, delta, dq, nullptr, nullptr,
                 S, KVH, G, 0, window, causal, softcap, scale};
  return dispatch<false>(p, B, dh, is_bf16, rows, bk, rc < 0,
                         static_cast<cudaStream_t>(stream));
}

// Arguments as flash_attn_bwd_dq; dk, dv [B, S, KVH, dh] f32.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const int* lengths, const float* lse,
                                  const float* delta, float* dk, float* dv,
                                  int B, int S, int KVH, int G, int dh,
                                  int window, float softcap, int causal,
                                  float scale, int is_bf16, int rows, int bk,
                                  void* stream) {
  const int rc = check_shape(B, S, G, dh, rows);
  if (rc > 0) return rc;
  if (!operands_aligned(q, k, v, dout)) return cudaErrorMisalignedAddress;
  const Params p{q, k, v, dout, lengths, lse, delta, nullptr, dk, dv,
                 S, KVH, G, 0, window, causal, softcap, scale};
  return dispatch<true>(p, B, dh, is_bf16, rows, bk, rc < 0,
                        static_cast<cudaStream_t>(stream));
}

// A measurement launch beside the wrapped path: the dQ (dkv = 0, into dq)
// or dK/dV kernel (dkv = 1, into dk, dv) on flash_attn_bwd_dq's operands
// and tiling, each block writing the tiles it walked and the SM clocks it
// took into blocks[2 * i] and blocks[2 * i + 1], i its linear index
// (blockIdx.x fastest; the grid of flash_attn_bwd_plan).  With one_pass
// (f32 at head dim 64 or 256, the default tiling only) every product
// takes one TF32 pass, hi*hi: the precision control of the 3xTF32 split.
extern "C" int flash_attn_bwd_probe(int dkv, int one_pass, const void* q,
                                    const void* k, const void* v,
                                    const void* dout, const int* lengths,
                                    const float* lse, const float* delta,
                                    float* dq, float* dk, float* dv, int B,
                                    int S, int KVH, int G, int dh, int window,
                                    float softcap, int causal, float scale,
                                    int is_bf16, int rows, int bk,
                                    long long* blocks, void* stream) {
  const int rc = check_shape(B, S, G, dh, rows);
  if (rc > 0) return rc;
  if (!operands_aligned(q, k, v, dout)) return cudaErrorMisalignedAddress;
  const Params p{q, k, v, dout, lengths, lse, delta, dq, dk, dv,
                 S, KVH, G, 0, window, causal, softcap, scale, blocks};
  const auto st = static_cast<cudaStream_t>(stream);
  if (!one_pass) {
    return dkv ? dispatch<true>(p, B, dh, is_bf16, rows, bk, rc < 0, st)
               : dispatch<false>(p, B, dh, is_bf16, rows, bk, rc < 0, st);
  }
  if (is_bf16 || bk != kBK || dh == 128 ||
      rows != (dh == 256 ? 32 : 64)) {
    return cudaErrorInvalidValue;
  }
  if (rc < 0) return 0;
  if (dh == 64) {
    return dkv ? launch<true, float, 64, 64, true>(p, B, 0, st)
               : launch<false, float, 64, 64, true>(p, B, 0, st);
  }
  return dkv ? launch<true, float, 256, 32, true>(p, B, 0, st)
             : launch<false, float, 256, 32, true>(p, B, 0, st);
}

// The launch flash_attn_bwd_dq (dkv = 0) or flash_attn_bwd_dkv (dkv = 1)
// makes at these shapes and tiling (write_plans); an unknown tiling is
// cudaErrorInvalidValue.
extern "C" int flash_attn_bwd_plan(int dkv, int B, int S, int KVH, int G,
                                   int dh, int is_bf16, int rows, int bk,
                                   long long* out) {
  const int rc = check_shape(B, S, G, dh, rows);
  if (rc > 0) return rc;
  Params p{};
  p.S = S;
  p.KVH = KVH;
  p.G = G;
  LaunchPlan lp{};
  const cudaError_t e = visit(dh, is_bf16, rows, bk, [&](auto i, int) {
    using I = decltype(i);
    lp = dkv ? plan<true, typename I::T, I::DH, I::R>(p, B)
             : plan<false, typename I::T, I::DH, I::R>(p, B);
    return cudaSuccess;
  });
  if (e != cudaSuccess) return e;
  if (rc < 0) return write_plans(nullptr, 0, out);
  return write_plans(&lp, 1, out);
}

// The launcher's grant for one instantiation on the current device:
// out[0] the dynamic shared bytes granted to the dQ (dkv = 0) or dK/dV
// kernel of that head dim, type and tiling (0: none yet), out[1] the
// cudaFuncSetAttribute calls both kernels' launches made in this process.
extern "C" int flash_attn_bwd_smem_state(int dkv, int dh, int is_bf16,
                                         int rows, int bk, long long* out) {
  if (dh != 64 && dh != 128 && dh != 256) return cudaErrorInvalidValue;
  int tiling = -1;
  const cudaError_t found = visit(dh, is_bf16, rows, bk, [&](auto, int i) {
    tiling = i;
    return cudaSuccess;
  });
  if (found != cudaSuccess) return found;
  const cudaError_t e =
      g_grants.granted_here(instance(dkv, is_bf16, dh, tiling), out);
  if (e != cudaSuccess) return e;
  out[1] = g_grants.sets.load();
  return 0;
}
