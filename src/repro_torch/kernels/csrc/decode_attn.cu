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
// Design: split-S with a fixed-order combine (design (b)), because Hopper
// blocks run in no order and one block per (row, KV head) would give only
// B * KVH = 64 blocks for 132 SMs at the serving shape.
// * pass 1 (decode_split): one block per (split of `chunk` cache
//   positions, KV head, batch row); the wrapper chooses the chunk (256)
//   and sizes the split scratch from it, and the kernel takes it as an
//   argument, so the two cannot disagree.  It reads only positions below the
//   row's live length: a split that starts at or past it returns at once
//   and writes nothing, so time scales with the live prefix and not with
//   the cache's capacity.  Inside, the TPU's sequential grid axis becomes a
//   loop over tiles of BK positions (BK * dh = 4096 elements) held in
//   shared memory, each loaded with 16-byte (f32) or 8-byte (bf16) vector
//   loads that are all in flight before the first store; the G query heads of the group share each K/V tile (no
//   G-fold repeat).  Scores take the TPU kernel's order: s = (q.k) * scale,
//   then tanh softcap, then the mask.  Masked lanes get an explicit p = 0.
//   The split writes its unnormalised accumulator and its (max, sum) per
//   query head, in f32.
// * pass 2 (decode_combine): one block per (KV head, batch row) merges the
//   live splits in split order, so two calls are bit-equal.  A row of
//   length 0 has no live split and gets zeros (the port's rule; the TPU
//   kernel averages V over the padded capacity there).
// q [B, KVH, G, dh] and the cache [B, S, KVH, dh] are read in the model's
// own layouts (cache row stride KVH * dh); the ragged edge is masked here,
// so the cache needs no padding.  f32 accumulation; bf16 operands are
// widened on load and the output is rounded to q's type.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 16;
constexpr int kVec = 4;       // cache elements per vector load
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* length;
  float* part_o;   // [B, KVH, n_split, G, dh]: unnormalised accumulators
  float* part_ml;  // [B, KVH, n_split, G, 2]: (max, sum) per query head
  void* o;         // [B, KVH, G, dh]
  int S, KVH, G, chunk, n_split;
  float softcap, scale;
};

__device__ __forceinline__ int live_length(const Params& p, int b) {
  return min(max(p.length[b], 0), p.S);
}

template <int DH>
__host__ __device__ constexpr int tile_keys() {
  return 4096 / DH;  // 64, 32, 16 positions for dh 64, 128, 256
}

template <int DH>
size_t split_smem_bytes(int G) {
  constexpr int BK = tile_keys<DH>();
  return sizeof(float) * ((size_t)G * DH + (size_t)BK * (DH + 1) +
                          (size_t)BK * DH + (size_t)G * (BK + 1) + 3 * G);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) decode_split(Params p) {
  constexpr int BK = tile_keys<DH>();
  constexpr int DP = DH + 1;   // padded rows: column reads hit distinct banks
  constexpr int SP = BK + 1;
  constexpr int MAXJ = kMaxG * DH / kThreads;  // accumulators per thread
  constexpr int CJ = (BK + 31) / 32;           // score columns per lane
  constexpr int NV = BK * DH / kVec / kThreads;  // vector loads per operand
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = live_length(p, b);
  const int k_begin = split * p.chunk;
  if (k_begin >= L) return;  // uniform over the block; never read
  const int k_end = min(k_begin + p.chunk, L);
  const int G = p.G, KVH = p.KVH, S = p.S;

  extern __shared__ float smem[];
  float* sQ = smem;              // [G][DH]
  float* sK = sQ + G * DH;       // [BK][DP]
  float* sV = sK + BK * DP;      // [BK][DH]
  float* sS = sV + BK * DH;      // [G][SP]: scores, then p
  float* sM = sS + G * SP;       // running max per query head
  float* sL = sM + G;            // running sum per query head
  float* sA = sL + G;            // this tile's rescale factor

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int tid = threadIdx.x;
  const long long q_off = ((long long)b * KVH + h) * G * DH;
  for (int i = tid; i < G * DH; i += kThreads) sQ[i] = to_f(q[q_off + i]);
  for (int g = tid; g < G; g += kThreads) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }
  float acc[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) acc[j] = 0.f;
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // all of the tile's vector loads are issued before the first store to
    // shared memory, so each thread keeps 2 * NV loads in flight
    Pack<T, kVec> kp[NV], vp[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = (tid + j * kThreads) * kVec;
      const int key = k0 + i / DH;
      if (key < k_end) {
        const long long off =
            (((long long)b * S + key) * KVH + h) * DH + i % DH;
        kp[j] = *reinterpret_cast<const Pack<T, kVec>*>(k + off);
        vp[j] = *reinterpret_cast<const Pack<T, kVec>*>(v + off);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kp[j].v[e] = vp[j].v[e] = from_f<T>(0.f);
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = (tid + j * kThreads) * kVec;
      const int c = i / DH, d = i % DH;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        sK[c * DP + d + e] = to_f(kp[j].v[e]);
        sV[c * DH + d + e] = to_f(vp[j].v[e]);
      }
    }
    __syncthreads();

    for (int i = tid; i < G * BK; i += kThreads) {
      const int g = i / BK, c = i % BK;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) dot = fmaf(sQ[g * DH + d], sK[c * DP + d], dot);
      float s = dot * p.scale;
      if (p.softcap != 0.f) s = tanhf(s / p.softcap) * p.softcap;
      if (k0 + c >= k_end) s = kNegInf;
      sS[g * SP + c] = s;
    }
    __syncthreads();

    // online-softmax statistics, one warp per query head
    for (int g = warp; g < G; g += kThreads / 32) {
      float sv[CJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = lane + 32 * j;
        sv[j] = c < BK ? sS[g * SP + c] : kNegInf;
        mx = fmaxf(mx, sv[j]);
      }
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = lane + 32 * j;
        // explicit zero: a masked lane has s = m = -1e30 on an empty tile
        // tail, where exp(s - m) would be 1
        const float pj = (c < BK && k0 + c < k_end) ? expf(sv[j] - m_new) : 0.f;
        if (c < BK) sS[g * SP + c] = pj;
        sum += pj;
      }
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

    // acc = acc * alpha + p @ v; thread owns outputs tid + kThreads * j
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int o = tid + kThreads * j;
      if (o < G * DH) {
        const int g = o / DH, d = o % DH;
        float a = acc[j] * sA[g];
#pragma unroll 8
        for (int c = 0; c < BK; ++c) a = fmaf(sS[g * SP + c], sV[c * DH + d], a);
        acc[j] = a;
      }
    }
    __syncthreads();  // sK, sV and sS are overwritten by the next tile
  }

  const long long base = ((long long)b * KVH + h) * p.n_split + split;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int o = tid + kThreads * j;
    if (o < G * DH) p.part_o[base * G * DH + o] = acc[j];
  }
  for (int g = tid; g < G; g += kThreads) {
    p.part_ml[(base * G + g) * 2] = sM[g];
    p.part_ml[(base * G + g) * 2 + 1] = sL[g];
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) decode_combine(Params p) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = p.G;
  const int n_live = (live_length(p, b) + p.chunk - 1) / p.chunk;
  const long long base = ((long long)b * p.KVH + h) * p.n_split;
  T* o = static_cast<T*>(p.o);
  const long long o_off = ((long long)b * p.KVH + h) * G * DH;
  for (int i = threadIdx.x; i < G * DH; i += blockDim.x) {
    const int g = i / DH;
    float m = kNegInf;
    for (int s = 0; s < n_live; ++s)
      m = fmaxf(m, p.part_ml[((base + s) * G + g) * 2]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float* ml = p.part_ml + ((base + s) * G + g) * 2;
      const float w = expf(ml[0] - m);
      den = fmaf(ml[1], w, den);
      num = fmaf(p.part_o[(base + s) * G * DH + i], w, num);
    }
    o[o_off + i] = from_f<T>(n_live ? num / den : 0.f);
  }
}

template <typename T, int DH>
LaunchPlan plan_split(const Params& p, int B) {
  return {reinterpret_cast<const void*>(decode_split<T, DH>),
          dim3(p.n_split, p.KVH, B), kThreads, split_smem_bytes<DH>(p.G)};
}

template <typename T, int DH>
LaunchPlan plan_combine(const Params& p, int B) {
  return {reinterpret_cast<const void*>(decode_combine<T, DH>),
          dim3(p.KVH, B), kThreads, 0};
}

// The launches of one call: the split pass (none when S = 0), then the
// combine pass.  Returns how many it wrote.
template <typename T, int DH>
int plans(const Params& p, int B, LaunchPlan* lps) {
  int n = 0;
  if (p.S > 0) lps[n++] = plan_split<T, DH>(p, B);
  lps[n++] = plan_combine<T, DH>(p, B);
  return n;
}

template <typename T, int DH>
cudaError_t launch(const Params& p, int B, cudaStream_t st) {
  LaunchPlan lps[2];
  const int n = plans<T, DH>(p, B, lps);
  if (n == 2) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)lps[0].smem);
    if (e != cudaSuccess) return e;
    decode_split<T, DH><<<lps[0].grid, lps[0].threads, lps[0].smem, st>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const LaunchPlan& c = lps[n - 1];
  decode_combine<T, DH><<<c.grid, c.threads, c.smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q [B, KVH, G, dh]; k, v [B, S, KVH, dh]; all contiguous, f32 or bf16,
// k and v aligned to 4 elements;
// length [B] int32; `chunk` cache positions per split; part_o
// [B, KVH, n_split, G, dh] and part_ml [B, KVH, n_split, G, 2] f32 scratch,
// n_split = ceil(S / chunk); o like q.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const int* length, float* part_o, float* part_ml,
                            void* o, int B, int S, int KVH, int G, int dh,
                            int chunk, float softcap, float scale,
                            int is_bf16, void* stream) {
  if (G < 1 || G > kMaxG || chunk < 1 ||
      !aligned(k, kVec * (is_bf16 ? 2 : 4)) ||
      !aligned(v, kVec * (is_bf16 ? 2 : 4)))
    return cudaErrorInvalidValue;
  if (B == 0 || KVH == 0) return 0;
  const Params p{q, k, v, length, part_o, part_ml, o, S, KVH, G, chunk,
                 (S + chunk - 1) / chunk, softcap, scale};
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

// The launches flash_decode makes at these shapes (write_plans).
extern "C" int flash_decode_plan(int B, int S, int KVH, int G, int dh,
                                 int chunk, int is_bf16, long long* out) {
  if (G < 1 || G > kMaxG || chunk < 1) return cudaErrorInvalidValue;
  if (B == 0 || KVH == 0) return write_plans(nullptr, 0, out);
  Params p{};
  p.S = S;
  p.KVH = KVH;
  p.G = G;
  p.chunk = chunk;
  p.n_split = (S + chunk - 1) / chunk;
  LaunchPlan lps[2];
  int n;
  switch (dh) {
    case 64:
      n = is_bf16 ? plans<__nv_bfloat16, 64>(p, B, lps)
                  : plans<float, 64>(p, B, lps);
      break;
    case 128:
      n = is_bf16 ? plans<__nv_bfloat16, 128>(p, B, lps)
                  : plans<float, 128>(p, B, lps);
      break;
    case 256:
      n = is_bf16 ? plans<__nv_bfloat16, 256>(p, B, lps)
                  : plans<float, 256>(p, B, lps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return write_plans(lps, n, out);
}
