// Flash-decode attention: one query token per batch row against a
// fixed-capacity KV cache, softmax over each row's live prefix.
//
// Replaces the TPU kernel of src/repro/kernels/decode_attention.py
// (decode_attention, _decode_attn_kernel).  There the grid is
// (B, KVH, S/512) with the cache axis innermost and in order, carrying the
// running max, normalizer and value accumulator in VMEM scratch from one
// grid step to the next; the wrapper pads the cache to a block multiple.
//
// What bounds it on an H100: bytes.  Each live cache position is read once
// for K and once for V (2 * KVH * dh * itemsize bytes) and meets G query
// rows, so a call does ~G FMAs per byte read in f32: far below the card's
// balance point.  At the serving shape (B=8, KVH=8, G=4, dh=64, 2048 live
// positions, f32) that is 67 MB, ~20 us at 3.35 TB/s.
//
// Design: split-S inside one thread-block cluster per (KV head, batch
// row), one launch a call.  Hopper blocks run in no order, and one block
// per (row, KV head) would give only B * KVH = 64 blocks for 132 SMs at
// the serving shape, so each cluster's blocks are the splits of the cache:
// cluster = min(16, ceil(S / 256)) blocks, chunk = ceil(S / cluster)
// positions each (8 x 256 at the serving shape: 512 blocks; 16 x 272 on
// Gemma-2's 4352-position global cache: 128).  Sizes past the portable 8
// are allowed once per instantiation with the shared-memory grant.
// * Each block walks its chunk's live positions in tiles of BK = 2048 / dh
//   keys (32, 16, 8), K and V copied with cp.async into kStages stages (4
//   elements a copy: 16 bytes f32, 8 bytes bf16; rows padded by one copy
//   so a warp's row reads hit distinct banks), the next tiles in flight
//   while this one is computed.  Positions at or past the row's live
//   length are never read: those slots are zero-filled, and a split that
//   starts past it copies nothing.  Time scales with the live prefix.
// * Scores take the TPU kernel's order: s = (q.k) * scale, then tanh
//   softcap, then the mask.  The per-tile work is arranged for shared-
//   memory traffic, which bounds a block's walk: each warp forms q.k over
//   a quarter of the head dim (16 elements a lane, a key on every 32 / BK
//   lanes), so a lane reads its 16 elements of k once for all G heads of
//   the group; the four quarters meet in order where one warp per head
//   keeps the online softmax (masked keys get an explicit p = 0); for
//   p v each thread owns 4 output columns of every head over a quarter of
//   the tile's keys, reading each v once for all heads, and the key
//   groups' parts are summed in a fixed order once, at the end of the
//   split.  Three barriers a tile.
// * The combine: every block leaves its unnormalised accumulator and its
//   (max, sum) per query head in its shared memory; after a cluster
//   barrier the first block reads the live splits' from distributed shared
//   memory in split order (so two calls are bit-equal) and writes O; a
//   second barrier keeps every block's shared memory until it has.  A row
//   of length 0 has no live split and gets zeros (the port's rule; the TPU
//   kernel averages V over the padded capacity there).  No scratch in
//   device memory and no per-stream state: the launch can be captured in
//   a CUDA graph.
// q [B, KVH, G, dh] and the cache [B, S, KVH, dh] are read in the model's
// own layouts (cache row stride KVH * dh); the ragged edge is masked here,
// so the cache needs no padding.  f32 accumulation; bf16 operands are
// widened on load and the output is rounded to q's type.
#include <cooperative_groups.h>

#include "common.cuh"

using namespace repro;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 16;
constexpr int kVec = 4;          // cache elements per async copy
constexpr int kMaxCluster = 16;  // splits of one (row, KV head)
constexpr int kSplitKeys = 256;  // the chunk a cluster size aims at
constexpr int kStages = 2;       // K/V tiles in flight or in use
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* length;
  void* o;  // [B, KVH, G, dh]
  int S, KVH, G, chunk;
  float softcap, scale;
};

__device__ __forceinline__ int live_length(const Params& p, int b) {
  return min(max(p.length[b], 0), p.S);
}

inline int cluster_size(int S) {
  const int n = (S + kSplitKeys - 1) / kSplitKeys;
  return S <= 0 ? 1 : n < kMaxCluster ? n : kMaxCluster;
}

template <int DH>
__host__ __device__ constexpr int tile_keys() {
  return 2048 / DH;  // 32, 16, 8 positions for dh 64, 128, 256
}

// Elements a row of a K or V tile: dh plus one copy's 4 elements (16
// bytes f32, 8 bf16), so the rows a warp reads start in distinct banks.
template <int DH>
__host__ __device__ constexpr int row_elems() {
  return DH + kVec;
}

// Warps that hold a distinct key group's partial accumulator at the end
// of a split (4 at head_dim 64 and 128, 2 at 256): see decode_attn.
template <int DH>
__host__ __device__ constexpr int red_slots() {
  return kThreads / (DH / 4) > 4 ? 4 : kThreads / (DH / 4);
}

// f32 words before the K/V stages: q (its rows padded by 4 floats; the
// accumulator for the combine afterwards), each warp's partial scores,
// the probabilities, and the running max, sum and rescale factor per
// query head.
template <int DH>
__host__ __device__ constexpr int head_floats(int G) {
  return G * (DH + 4) + 4 * G * tile_keys<DH>() + G * (tile_keys<DH>() + 1) +
         3 * G;
}

// The head, then the K/V stages, which the end of a split reuses for the
// key groups' partial accumulators ([red_slots][G][dh] f32).
template <typename T, int DH>
size_t smem_bytes(int G) {
  const size_t f = (size_t)head_floats<DH>(G);
  const size_t kv =
      sizeof(T) * 2 * kStages * (size_t)tile_keys<DH>() * row_elems<DH>();
  const size_t red = sizeof(float) * red_slots<DH>() * (size_t)G * DH;
  return sizeof(float) * ((f + 3) / 4 * 4) + (kv > red ? kv : red);
}

// 4 cache elements as f32 from shared memory (16 bytes f32, 8 bytes bf16).
__device__ __forceinline__ void load4(const float* s, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* s, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(s);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

template <typename T>
__device__ __forceinline__ void copy4(T* dst, const T* src, bool ok) {
  if constexpr (sizeof(T) == 4) {
    cp16(dst, src, ok);
  } else {
    cp8(dst, src, ok);
  }
}

// Issue the copies of keys k0 .. k0 + BK - 1 (those below k_end; zeros
// past it) of row b, head h into the stage sK, sV.
template <typename T, int DH>
__device__ void load_tile(const Params& p, const T* k, const T* v, T* sK,
                          T* sV, int b, int h, int k0, int k_end) {
  constexpr int BK = tile_keys<DH>(), RS = row_elems<DH>();
  constexpr int CPR = DH / kVec;  // copies a row
  for (int i = threadIdx.x; i < BK * CPR; i += kThreads) {
    const int c = i / CPR, d = (i % CPR) * kVec, key = k0 + c;
    const bool ok = key < k_end;
    const long long off =
        ok ? (((long long)b * p.S + key) * p.KVH + h) * DH + d : 0;
    copy4(sK + c * RS + d, k + off, ok);
    copy4(sV + c * RS + d, v + off, ok);
  }
}

// GB: the most query heads a group this instantiation takes (4 or kMaxG),
// the length of each thread's per-head register arrays.
template <typename T, int DH, int GB>
__global__ void __launch_bounds__(kThreads) decode_attn(Params p) {
  constexpr int BK = tile_keys<DH>(), RS = row_elems<DH>();
  constexpr int QS = DH + 4;        // f32 row of q / acc
  constexpr int SP = BK + 1;
  constexpr int LPK = 32 / BK;      // lanes a key in a warp's q.k
  constexpr int DQ = DH / 4 / LPK;  // q.k elements a lane: 16
  constexpr int NDC = DH / 4;       // 4-wide output columns
  constexpr int KG = kThreads / NDC;  // key groups of p v: 8, 4, 2
  constexpr int KPT = BK / KG;      // keys a thread a tile: 4
  constexpr int R = red_slots<DH>();
  static_assert(BK <= 32 && DQ == 16 && KPT * KG == BK, "tile shapes");
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank(), n_split = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = p.G;
  const int L = live_length(p, b);
  const int k_begin = split * p.chunk;
  const int k_end = min(k_begin + p.chunk, L);

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;              // [G][QS]: q, then the accumulator
  float* sP = sQ + G * QS;       // [4 warps][G][BK]: partial scores
  float* sS = sP + 4 * G * BK;   // [G][SP]: probabilities
  float* sM = sS + G * SP;       // running max per query head
  float* sL = sM + G;            // running sum per query head
  float* sA = sL + G;            // this tile's rescale factor
  T* sK = reinterpret_cast<T*>(smem + (head_floats<DH>(G) + 3) / 4 * 4);
  T* sV = sK + kStages * BK * RS;  // [kStages][BK][RS] each
  float* sR = reinterpret_cast<float*>(sK);  // [R][G][DH] after the walk

  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // q.k: this thread's key and 16 elements of the head dim
  const int qc = lane % BK, qd = warp * (DH / 4) + (lane / BK) * DQ;
  // p v: its 4 output columns and key group
  const int dc = tid % NDC, kg = tid / NDC;
  float acc[GB][4];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;

  if (k_begin < k_end) {  // uniform over the block
    const int n_tiles = (k_end - k_begin + BK - 1) / BK;
    // tiles 0 .. kStages - 2 in flight, a commit group each (empty past
    // the last tile, so that group i always holds tile i)
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_tiles)
        load_tile<T, DH>(p, k, v, sK + st * BK * RS, sV + st * BK * RS, b,
                         h, k_begin + st * BK, k_end);
      cp_commit();
    }
    const T* q = static_cast<const T*>(p.q);
    const long long q_off = ((long long)b * p.KVH + h) * G * DH;
    for (int i = tid; i < G * DH; i += kThreads)
      sQ[(i / DH) * QS + i % DH] = to_f(q[q_off + i]);
    for (int g = tid; g < G; g += kThreads) {
      sM[g] = kNegInf;
      sL[g] = 0.f;
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = k_begin + it * BK;
      const T* tK = sK + (it % kStages) * BK * RS;
      const T* tV = sV + (it % kStages) * BK * RS;
      cp_wait<kStages - 2>();
      // tile it has landed, and every thread is done with tile it - 1, so
      // its stage takes tile it + kStages - 1
      __syncthreads();
      const int nx = it + kStages - 1;
      if (nx < n_tiles) {
        const int at = (nx % kStages) * BK * RS;
        load_tile<T, DH>(p, k, v, sK + at, sV + at, b, h, k_begin + nx * BK,
                         k_end);
      }
      cp_commit();

      // q.k: each warp takes a quarter of the head dim, LPK lanes a key
      // within it; every head of the group meets the same 16 elements of
      // k, read once
      {
        float kf[DQ];
#pragma unroll
        for (int j = 0; j < DQ; j += 4) load4(tK + qc * RS + qd + j, kf + j);
        float part[GB];
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          part[g] = 0.f;
          if (g < G) {
            const float* qr = sQ + g * QS + qd;
            float s2[2] = {0.f, 0.f};
#pragma unroll
            for (int j = 0; j < DQ; j += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + j);
              s2[0] = fmaf(qv.x, kf[j], s2[0]);
              s2[1] = fmaf(qv.y, kf[j + 1], s2[1]);
              s2[0] = fmaf(qv.z, kf[j + 2], s2[0]);
              s2[1] = fmaf(qv.w, kf[j + 3], s2[1]);
            }
            part[g] = s2[0] + s2[1];
          }
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
#pragma unroll
          for (int o = BK; o < 32; o *= 2)
            part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
          if (g < G && lane < BK) sP[(warp * G + g) * BK + qc] = part[g];
        }
      }
      __syncthreads();

      // the scores and their online-softmax statistics, a warp per head
      // and a key a lane: the four warps' partial sums in order, the
      // scale, the tanh softcap, then the mask
      for (int g = warp; g < G; g += kThreads / 32) {
        const bool in = lane < BK && k0 + lane < k_end;
        float s = kNegInf;
        if (lane < BK) {
          const float* pr = sP + g * BK + lane;
          s = ((pr[0] + pr[G * BK]) + (pr[2 * G * BK] + pr[3 * G * BK])) *
              p.scale;
          if (p.softcap != 0.f) s = tanhf(s / p.softcap) * p.softcap;
          if (!in) s = kNegInf;
        }
        float mx = s;
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = sM[g];
        const float m_new = fmaxf(m_prev, mx);
        // explicit zero: a masked lane has s = m = -1e30 on an empty tile
        // tail, where exp(s - m) would be 1
        const float pj = in ? expf(s - m_new) : 0.f;
        if (lane < BK) sS[g * SP + lane] = pj;
        float sum = pj;
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          sA[g] = alpha;
          sL[g] = sL[g] * alpha + sum;
          sM[g] = m_new;
        }
      }
      __syncthreads();

      // p v: this thread's 4 columns of every head over keys kg + KG * i,
      // each v read once for all heads; acc holds its key group's part
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g < G) {
          const float a = sA[g];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] *= a;
        }
      }
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int c = kg + KG * i;
        float vf[4];
        load4(tV + c * RS + 4 * dc, vf);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < G) {
            const float pg = sS[g * SP + c];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
          }
        }
      }
    }
    // the key groups' parts, summed in a fixed order: pairs within a warp
    // (head_dim 64), then the R warps' slots through shared memory, which
    // the K/V stages leave free once every thread is done with them
    if (KG > R) {
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
    }
    __syncthreads();
    if (KG <= R || lane < 16) {
      const int r = kg / (KG / R);
#pragma unroll
      for (int g = 0; g < GB; ++g)
        if (g < G)
          *reinterpret_cast<float4*>(sR + (r * G + g) * DH + 4 * dc) =
              make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    }
    __syncthreads();
    for (int i = tid; i < G * DH; i += kThreads) {
      float a = sR[i];
#pragma unroll
      for (int r = 1; r < R; ++r) a += sR[r * G * DH + i];
      sQ[(i / DH) * QS + i % DH] = a;
    }
  }
  cluster.sync();  // every split's accumulator and (max, sum) are in place

  if (split == 0) {
    const int n_live = min((L + p.chunk - 1) / p.chunk, n_split);
    T* o = static_cast<T*>(p.o);
    const long long o_off = ((long long)b * p.KVH + h) * G * DH;
    for (int i = tid; i < G * DH; i += kThreads) {
      const int g = i / DH, d = i % DH;
      float m = kNegInf;
      for (int s = 0; s < n_live; ++s)
        m = fmaxf(m, cluster.map_shared_rank(sM, s)[g]);
      float num = 0.f, den = 0.f;
      for (int s = 0; s < n_live; ++s) {
        const float w = expf(cluster.map_shared_rank(sM, s)[g] - m);
        den = fmaf(cluster.map_shared_rank(sL, s)[g], w, den);
        num = fmaf(cluster.map_shared_rank(sQ, s)[g * QS + d], w, num);
      }
      o[o_off + i] = from_f<T>(n_live ? num / den : 0.f);
    }
  }
  cluster.sync();  // no block leaves while the first still reads its memory
}

template <typename T, int DH, int GB>
LaunchPlan plan_gb(const Params& p, int B) {
  const int cs = cluster_size(p.S);
  return {reinterpret_cast<const void*>(decode_attn<T, DH, GB>),
          dim3(cs, p.KVH, B), kThreads, smem_bytes<T, DH>(p.G), cs};
}

// Groups of up to 4 heads (every model the port runs) keep 4 heads of
// per-thread state; larger groups up to kMaxG.
template <typename T, int DH>
LaunchPlan plan(const Params& p, int B) {
  return p.G <= 4 ? plan_gb<T, DH, 4>(p, B) : plan_gb<T, DH, kMaxG>(p, B);
}

// Instantiations for the grant: G <= 4 then G <= kMaxG; in each f32 then
// bf16; in each head_dim 64, 128, 256.
constexpr int kInstances = 12;
SmemGrants<kInstances> g_grants;

int instance(int is_bf16, int dh, int G) {
  return 6 * (G > 4) + 3 * (is_bf16 != 0) + (dh == 64 ? 0 : dh == 128 ? 1 : 2);
}

template <typename T, int DH>
cudaError_t launch(Params p, int B, cudaStream_t st) {
  const LaunchPlan lp = plan<T, DH>(p, B);
  cudaError_t e = g_grants.grant(
      lp.fn, instance(sizeof(T) == 2, DH, p.G), lp.smem, true);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = lp.grid;
  cfg.blockDim = dim3(lp.threads);
  cfg.dynamicSmemBytes = lp.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = lp.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&p};
  e = cudaLaunchKernelExC(&cfg, lp.fn, args);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  return cudaGetLastError();
}

Params params(int S, int KVH, int G) {
  Params p{};
  p.S = S;
  p.KVH = KVH;
  p.G = G;
  p.chunk = S <= 0 ? 1 : (S + cluster_size(S) - 1) / cluster_size(S);
  return p;
}

}  // namespace

// q [B, KVH, G, dh]; k, v [B, S, KVH, dh]; all contiguous, f32 or bf16,
// k and v aligned to 4 elements; length [B] int32 (clamped to [0, S]
// here); o like q.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const int* length, void* o, int B, int S,
                            int KVH, int G, int dh, float softcap,
                            float scale, int is_bf16, void* stream) {
  if (G < 1 || G > kMaxG || !aligned(k, kVec * (is_bf16 ? 2 : 4)) ||
      !aligned(v, kVec * (is_bf16 ? 2 : 4)))
    return cudaErrorInvalidValue;
  if (B == 0 || KVH == 0) return 0;
  Params p = params(S, KVH, G);
  p.q = q;
  p.k = k;
  p.v = v;
  p.length = length;
  p.o = o;
  p.softcap = softcap;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return is_bf16 ? launch<__nv_bfloat16, 64>(p, B, st)
                     : launch<float, 64>(p, B, st);
    case 128:
      return is_bf16 ? launch<__nv_bfloat16, 128>(p, B, st)
                     : launch<float, 128>(p, B, st);
    case 256:
      return is_bf16 ? launch<__nv_bfloat16, 256>(p, B, st)
                     : launch<float, 256>(p, B, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The launch flash_decode makes at these shapes (write_plans).
extern "C" int flash_decode_plan(int B, int S, int KVH, int G, int dh,
                                 int is_bf16, long long* out) {
  if (G < 1 || G > kMaxG) return cudaErrorInvalidValue;
  if (B == 0 || KVH == 0) return write_plans(nullptr, 0, out);
  const Params p = params(S, KVH, G);
  LaunchPlan lp;
  switch (dh) {
    case 64:
      lp = is_bf16 ? plan<__nv_bfloat16, 64>(p, B) : plan<float, 64>(p, B);
      break;
    case 128:
      lp = is_bf16 ? plan<__nv_bfloat16, 128>(p, B) : plan<float, 128>(p, B);
      break;
    case 256:
      lp = is_bf16 ? plan<__nv_bfloat16, 256>(p, B) : plan<float, 256>(p, B);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return write_plans(&lp, 1, out);
}

// The launcher's grant for one instantiation on the current device:
// out[0] the dynamic shared bytes granted to the kernel of that head dim,
// type and group size G (0: none yet), out[1] the cudaFuncSetAttribute
// calls the decode launches made in this process.
extern "C" int flash_decode_smem_state(int dh, int is_bf16, int G,
                                       long long* out) {
  if ((dh != 64 && dh != 128 && dh != 256) || G < 1 || G > kMaxG)
    return cudaErrorInvalidValue;
  const cudaError_t e =
      g_grants.granted_here(instance(is_bf16, dh, G), out);
  if (e != cudaSuccess) return e;
  out[1] = g_grants.sets.load();
  return 0;
}
