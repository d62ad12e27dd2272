// Flash-attention forward: blockwise online-softmax GQA attention that
// returns O and the per-row logsumexp, on the tensor cores at f32 accuracy.
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py
// (_fwd_call :159, _flash_attn_kernel).  There the grid is (B, KVH, S/bq,
// S/bk) and the KV axis runs in order, carrying the running max,
// normalizer and accumulator in VMEM scratch from one grid step to the
// next.
//
// What bounds it on an H100: operations.  At the slice's shape (B=16,
// S=512, 32 query heads over 8 KV heads, head_dim 64, causal) one call does
// 4*dh FLOP per live (query, key) pair, 17.2 GFLOP, against ~170 MB of q,
// k, v, O and lse (~0.05 ms).  On the CUDA cores in f32 (67 TFLOP/s) that
// is 0.257 ms; as 3xTF32 on the tensor cores (three TF32 products for each
// f32 one, 495 TFLOP/s), 0.104 ms.
//
// Design:
// * precision, fixed here (torch.backends.cuda.matmul.allow_tf32 is not
//   read): both products, q k^T and p v, run as mma.sync m16n8k8 tf32 in
//   3xTF32 (tf32_mma.cuh), f32-accurate; bf16 operands are exact in TF32,
//   so with bf16 inputs q k^T takes one pass and p v two (p is f32).  A
//   tile's p v sum is taken on the tensor cores, the long sum over key
//   tiles as O = O * alpha + tile in one IEEE fmaf;
// * one block per (KV head, batch row, query tile) of R score rows, R / 16
//   warps: BQ = R / G queries times the G heads of a group folded, so k
//   and v are loaded once per group (G <= R); the TPU's sequential KV grid
//   axis becomes a loop over key tiles of BK keys, pruned by the TPU
//   kernel's predicate (_block_needed).  (R, BK) is a tiling, chosen per
//   call from a fixed set per head_dim (Tilings below, plans.py
//   FLASH_FWD_TILINGS): the first of each set, R = 64 with BK = 32 at
//   head_dim 64 and 16 at 128 and 256, is what a call that pins nothing
//   and finds no tuned pick launches (kernels/autotune.py measures the
//   others);
// * each warp owns an m16 strip of rows across every key of a tile: its
//   scores stay in the mma accumulators and the online softmax (running max
//   m, normalizer l, rescale alpha) runs in registers with quad shuffles,
//   with no block barrier.  p goes to p v's A operand without leaving the
//   registers: an accumulator holds keys 2c and 2c + 1 of each 8 where an
//   A fragment wants c and c + 4, so the v tile lands with the even keys
//   of each 8 in rows 0-3 and the odd in rows 4-7 (key_row), and a B
//   fragment then holds the keys the thread's p has.  p is split once, in
//   registers; masked lanes get an explicit p = 0, and a fully masked row
//   keeps m = -1e30 and writes zeros;
// * occupancy first: the kernel is bound by the latency of its dependent
//   mma.sync chains more than by their issue, so the tiles are sized for
//   blocks in flight (with the default tilings 3 an SM at head_dim 64, 2
//   at 128, 1 at 256; kMinBlocks derives it from each tiling's shared
//   memory and a register budget per (head_dim, BK)) and the
//   f32 k and v tiles are split by the fragment loads, not once into lo
//   planes, which would cost a block an SM; q stays resident for the
//   block, split once into hi and lo planes in f32 when it lands; a bf16
//   element is widened exactly;
// * copies: k and v tiles are double-buffered with 16-byte cp.async.cg, the
//   next tile's copy in flight while the current one computes; keys past S
//   and rows past the folded R or S are zero-filled by the copy; the
//   16-byte chunks of a tile row are permuted by the row (swz), so fragment
//   loads hit 32 distinct banks;
// * under causal masking the query tiles that walk the most key tiles
//   launch first: the grid's slowest axis runs from the last query tile to
//   the first, over every (KV head, batch row) of each;
// * one block owns each output row: no split over keys and no atomics, so
//   two calls give bit-equal O and lse;
// * operands are read in the model layout ([B, S, H, dh], [B, S, KVH, dh])
//   and must be 16-byte aligned; keys past lengths[b] are masked here;
// * the dynamic shared memory (24-192 KB) is granted through the
//   per-device high-water mark of common.cuh: one attribute call per
//   instantiation (type, head_dim, tiling) and device, not one per launch;
// * flash_attn_fwd_probe, a launch outside the wrapped path, has each block
//   record the key tiles it walked and its clocks, and runs the one-pass
//   TF32 control of the split.
#include <cstdint>
#include <tuple>

#include "common.cuh"
#include "tf32_mma.cuh"

using namespace repro;

namespace {

constexpr float kNegInf = -1e30f;

// A tiling: R score rows a block (R / 16 warps; BQ = R / G queries) and BK
// keys a tile.
template <int R_, int BK_>
struct Tiling {
  static constexpr int R = R_, BK = BK_;
};
// The tilings of each head dim, the default first (plans.py
// FLASH_FWD_TILINGS repeats them).
template <int DH>
struct TilingsOf;
template <>
struct TilingsOf<64> {
  using type = std::tuple<Tiling<64, 32>, Tiling<64, 64>, Tiling<128, 32>,
                          Tiling<128, 64>>;
};
template <>
struct TilingsOf<128> {
  using type = std::tuple<Tiling<64, 16>, Tiling<64, 32>, Tiling<128, 16>,
                          Tiling<128, 32>>;
};
template <>
struct TilingsOf<256> {  // (32, 16) spills 152 bytes: not kept
  using type = std::tuple<Tiling<64, 16>, Tiling<64, 8>, Tiling<32, 8>>;
};
constexpr int kTilings = 4;  // at most, per head dim

// output n8 tiles per p v pass (its accumulators' count)
template <int DH>
constexpr int kUOf = DH == 256 ? 4 : 8;

// q [R][DH] (f32: hi bits and a lo plane; bf16: as read); k and v
// [2][BK][DH] (T).
template <typename T, int DH, int R, int BK>
constexpr size_t kSmem =
    (kExactTf32<T> ? sizeof(T) : 2 * sizeof(uint32_t)) * R * DH +
    sizeof(T) * 4 * BK * DH;

// registers a thread of the tiling needs without spilling: 168 at head
// dim 64 with 32-key tiles (170 is the cap that three 4-warp blocks an SM
// leave), all 255 otherwise
template <int DH, int BK>
constexpr int kRegs = DH == 64 && BK <= 32 ? 168 : 255;

// Blocks an SM is to hold: as many as the shared memory (1 KB reserved a
// block) and the registers allow, at least 1; __launch_bounds__ then caps
// the registers at 65536 / (threads x blocks).
constexpr int min_blocks(size_t smem, int threads, int regs) {
  int blocks = int(233472 / (smem + 1024));
  if (65536 / (threads * regs) < blocks) blocks = 65536 / (threads * regs);
  return blocks < 1 ? 1 : blocks;
}
// The default tilings in f32: 3 at head_dim 64 (64 KB each, 170
// registers), 2 at 128 (96 KB), 1 at 256.
template <typename T, int DH, int R, int BK>
constexpr int kMinBlocks = min_blocks(kSmem<T, DH, R, BK>, 2 * R,
                                      kRegs<DH, BK>);

constexpr size_t kSmemOptin = 232448;  // a Hopper block's opt-in limit
static_assert(kSmem<float, 64, 128, 64> <= kSmemOptin, "tiles at dh 64");
static_assert(kSmem<float, 128, 128, 32> <= kSmemOptin, "tiles at dh 128");
static_assert(kSmem<float, 256, 64, 16> <= kSmemOptin, "tiles at dh 256");
static_assert(kMinBlocks<float, 64, 64, 32> == 3, "three blocks an SM");
static_assert(kMinBlocks<float, 128, 64, 16> == 2, "two blocks an SM");
static_assert(kMinBlocks<float, 256, 64, 16> == 1, "one block an SM");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  float* lse;  // [B, KVH, S, G]
  int S, KVH, G, BQ, window, causal;
  float softcap, scale;
  long long* blocks;  // per-block record (flash_attn_fwd_probe), or null
};

// _block_needed: does the key tile at k0 hold a live pair for a row of the
// query tile at q0?
template <int BK>
__device__ __forceinline__ bool tile_needed(const Params& p, int L, int q0,
                                            int k0) {
  bool needed = k0 < L;
  if (p.causal) needed = needed && k0 <= q0 + p.BQ - 1;
  if (p.window) needed = needed && k0 + BK - 1 > q0 - p.window;
  return needed;
}

// The first key tile from t (before end) the query tile at q0 needs.
template <int BK>
__device__ __forceinline__ int next_key_tile(const Params& p, int L, int q0,
                                             int t, int end) {
  while (t < end && !tile_needed<BK>(p, L, q0, t * BK)) ++t;
  return t;
}

__device__ __forceinline__ void store2(float* o, float x, float y) {
  *reinterpret_cast<float2*>(o) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x, y);
}

// kOne (flash_attn_fwd_probe's precision control only): every product one
// TF32 pass, hi*hi.
template <typename T, int DH, int R, int BK, bool kOne = false>
__global__ void __launch_bounds__(2 * R, kMinBlocks<T, DH, R, BK>)
    flash_fwd(Params p) {
  constexpr int kThreads = 2 * R;     // R / 16 warps
  constexpr int SN = BK / 8;          // score n8 tiles (p v k-steps) a tile
  static_assert(SN <= 8, "ok_bits holds 32 lanes' masks");
  constexpr int ON = DH / 8;          // output n8 tiles
  constexpr int U = kUOf<DH>;         // output n8 tiles per p v pass
  constexpr int KS = SN < 4 ? 2 : 1;  // score accumulators per n8 tile
  constexpr bool kQf = !kExactTf32<T>;          // q as hi and lo planes
  constexpr bool kX = kExactTf32<T> || kOne;    // no operand lo terms
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [R][DH]
  uint32_t* sQl = reinterpret_cast<uint32_t*>(sQ + R * DH);  // f32
  T* sK = reinterpret_cast<T*>(sQl + (kQf ? R * DH : 0));  // [2][BK*DH]
  T* sV = sK + 2 * BK * DH;  // [2][BK*DH], rows as key_row<true>
  const Opnd<T, DH, kQf> oQ{sQ, sQl};

  const long long c0 = p.blocks ? clock64() : 0;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * p.BQ;  // heaviest first
  const int L = min(max(p.lengths[b], 0), p.S);  // clamped here
  const float inv_g = 1.f / p.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int m0 = 16 * warp;
  const int n_k = (p.S + BK - 1) / BK;
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
  int t = next_key_tile<BK>(p, L, q0, 0, n_k);
  if (t < n_k) {
    copy_keys<T, DH, BK, kThreads>(sK, p.k, p, b, h, t * BK);
    copy_keys<T, DH, BK, kThreads, true>(sV, p.v, p, b, h, t * BK);
  }
  cp_commit();

  float acc[ON][4];  // O, unnormalized: rows m0 + g (+ 8), dims 8 * n + c2
  zero(acc);
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's columns' share of l
  int walked = 0;
  for (int buf = 0; t < n_k; buf ^= 1, ++walked) {  // uniform over the block
    const int k0 = t * BK;
    const int t_next = next_key_tile<BK>(p, L, q0, t + 1, n_k);
    if (t_next < n_k) {
      const int o = (buf ^ 1) * BK * DH;
      copy_keys<T, DH, BK, kThreads>(sK + o, p.k, p, b, h, t_next * BK);
      copy_keys<T, DH, BK, kThreads, true>(sV + o, p.v, p, b, h,
                                           t_next * BK);
    }
    cp_commit();
    cp_wait<1>();  // this tile (and q) have landed
    if constexpr (kQf) {
      if (walked == 0) {
        split_chunks<R, DH, kThreads>(reinterpret_cast<float*>(sQ), sQl);
      }
    }
    __syncthreads();
    const int o = buf * BK * DH;
    const Opnd<T, DH> cK{sK + o, nullptr}, cV{sV + o, nullptr};

    // s = q k^T: rows m0.., keys 8 * j + c2 (+ 1); k-steps alternate
    // between KS accumulators where a tile has few n8 tiles
    float s[KS][SN][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) zero(s[ks]);
#pragma unroll
    for (int kk = 0; kk < DH; kk += 8) {
      float(&sa)[SN][4] = s[(kk / 8) % KS];
      uint32_t qh[4], ql[4], kh[SN][2], kl[SN][2];
      frag_a(oQ, m0, kk, lane, qh, ql);
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        frag_b_nk(cK, kk, 8 * j, lane, kh[j], kl[j]);
      }
      if (!kX) {
        mma_row(sa, 0, ql, kh);
        mma_row(sa, 0, qh, kl);
      }
      mma_row(sa, 0, qh, kh);
    }
    if constexpr (KS == 2) add_into(s[0], s[1]);

    // scale, cap and mask; the rows' max over the tile (quad shuffles)
    const bool full = k0 + BK <= L && (!p.causal || k0 + BK - 1 <= q0) &&
                      (!p.window || k0 > q0 + p.BQ - 1 - p.window);
    unsigned ok_bits = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        float x = s[0][j][e] * p.scale;
        if (p.softcap != 0.f) x = tanhf(x / p.softcap) * p.softcap;
        const bool ok = full || (pos[hf] >= 0 &&
                                 live(k0 + 8 * j + c2 + (e & 1), pos[hf], L,
                                      p.window, p.causal));
        ok_bits |= (ok ? 1u : 0u) << (4 * j + e);
        s[0][j][e] = ok ? x : kNegInf;
        mx[hf] = fmaxf(mx[hf], s[0][j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m_run[hf], mx[hf]);
      alpha[hf] = expf(m_run[hf] - m_new);
      m_run[hf] = m_new;
    }

    // p = exp(s - m), 0 on masked lanes, split once into the A fragments of
    // p v: k-step j's a0..a3 are (row g, key 2c), (g + 8, 2c), (g, 2c + 1),
    // (g + 8, 2c + 1) of n8 tile j, the accumulator's elements 0, 2, 1, 3
    uint32_t ph[SN][4], pl[SN][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = (ok_bits >> (4 * j + e)) & 1u
                             ? expf(s[0][j][e] - m_run[e >> 1])
                             : 0.f;
        sum[e >> 1] += pr;
        const int a = 2 * (e & 1) + (e >> 1);
        if (kOne) {
          ph[j][a] = tf32_rna(pr);
        } else {
          split(pr, ph[j][a], pl[j][a]);
        }
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l_run[hf] = l_run[hf] * alpha[hf] + sum[hf];

    // O = O * alpha + p v, U output n8 tiles at a time: the tile's sum on
    // the tensor cores, the rescale and add in one IEEE fmaf
#pragma unroll
    for (int n = 0; n < ON; n += U) {
      float part[U][4];
      zero(part);
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        uint32_t vh[U][2], vl[U][2];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          frag_b_kn(cV, 8 * j, 8 * (n + u), lane, vh[u], vl[u]);
        }
        if (!kOne) mma_row(part, 0, pl[j], vh);
        if (!kX) mma_row(part, 0, ph[j], vl);
        mma_row(part, 0, ph[j], vh);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[n + u][i] = fmaf(acc[n + u][i], alpha[i >> 1], part[u][i]);
        }
    }
    __syncthreads();  // this tile's k and v are overwritten next
    t = t_next;
  }
  cp_wait<0>();

  T* out = static_cast<T*>(p.o);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_run[hf];  // the row's l: its quad's four shares
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    if (pos[hf] < 0) continue;
    const int gi = m0 + g + 8 * hf - (pos[hf] - q0) * p.G;  // head in group
    const long long row = ((long long)b * p.S + pos[hf]) * p.KVH + h;
    T* o = out + (row * p.G + gi) * DH;
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      store2(o + 8 * n + c2, acc[n][2 * hf] / l, acc[n][2 * hf + 1] / l);
    }
    if ((lane & 3) == 0) {
      p.lse[(((long long)b * p.KVH + h) * p.S + pos[hf]) * p.G + gi] =
          m_run[hf] + logf(l);
    }
  }
  record(p.blocks, walked, c0);
}

// ------------------------------------------------------------- launchers --
template <typename T, int DH, int R, int BK, bool kOne = false>
LaunchPlan plan(const Params& p, int B) {
  return {reinterpret_cast<const void*>(flash_fwd<T, DH, R, BK, kOne>),
          dim3(p.KVH, B, (p.S + p.BQ - 1) / p.BQ), 2 * R,
          kSmem<T, DH, R, BK>};
}

// Instantiations for the grant: (f32 then bf16) x (head_dim 64, 128, 256)
// x the head dim's tilings in TilingsOf order.  The probe's one-pass
// controls have grants of their own, so that the count of attribute calls
// (flash_attn_fwd_smem_state) is the wrapped path's.
constexpr int kInstances = 2 * 3 * kTilings;
SmemGrants<kInstances> g_grants;
SmemGrants<kInstances> g_one_pass_grants;

int instance(int is_bf16, int dh, int tiling) {
  return (3 * (is_bf16 != 0) + (dh == 64 ? 0 : dh == 128 ? 1 : 2)) *
             kTilings + tiling;
}

template <typename T, int DH, int R, int BK, bool kOne = false>
cudaError_t launch(const Params& p, int B, int tiling, cudaStream_t st) {
  const LaunchPlan lp = plan<T, DH, R, BK, kOne>(p, B);
  const cudaError_t e = (kOne ? g_one_pass_grants : g_grants)
                            .grant(lp.fn, instance(kExactTf32<T>, DH, tiling),
                                   lp.smem);
  if (e != cudaSuccess) return e;
  flash_fwd<T, DH, R, BK, kOne><<<lp.grid, lp.threads, lp.smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T_, int DH_, int R_, int BK_>
struct Inst {
  using T = T_;
  static constexpr int DH = DH_, R = R_, BK = BK_;
};

// f(Inst<T, DH, R, BK>{}, i) for the tiling (rows, bk) of head dim DH, i
// its index in TilingsOf<DH>; cudaErrorInvalidValue where DH has no such
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
      e = f(Inst<T, DH, Ti::R, Ti::BK>{}, i);
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

// head_dim 64, 128 or 256, 1 <= G <= rows, and a grid the card takes (the
// tiling itself is checked by visit).
int check_shape(int B, int S, int G, int dh, int rows) {
  if (dh != 64 && dh != 128 && dh != 256) return cudaErrorInvalidValue;
  if (rows < 1 || G < 1 || G > rows) return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return -1;  // nothing to launch
  if (B > 65535 || (S + rows / G - 1) / (rows / G) > 65535) {
    return cudaErrorInvalidValue;
  }
  return 0;
}

Params params(const void* q, const void* k, const void* v, const int* lengths,
              void* o, float* lse, int S, int KVH, int G, int rows,
              int window, float softcap, int causal, float scale,
              long long* blocks) {
  return Params{q, k, v, lengths, o, lse, S, KVH, G, rows / G, window,
                causal, softcap, scale, blocks};
}

}  // namespace

// The launch flash_attn_fwd makes at these shapes and tiling (write_plans);
// an unknown tiling is cudaErrorInvalidValue.
extern "C" int flash_attn_fwd_plan(int B, int S, int KVH, int G, int dh,
                                   int is_bf16, int rows, int bk,
                                   long long* out) {
  const int rc = check_shape(B, S, G, dh, rows);
  if (rc > 0) return rc;
  const Params p = params(nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, S, KVH, G, rows, 0, 0.f, 1, 1.f, nullptr);
  LaunchPlan lp{};
  const cudaError_t e = visit(dh, is_bf16, rows, bk, [&](auto i, int) {
    using I = decltype(i);
    lp = plan<typename I::T, I::DH, I::R, I::BK>(p, B);
    return cudaSuccess;
  });
  if (e != cudaSuccess) return e;
  if (rc < 0) return write_plans(nullptr, 0, out);
  return write_plans(&lp, 1, out);
}

// q [B, S, KVH*G, dh], k and v [B, S, KVH, dh], contiguous and 16-byte
// aligned, all f32 or all bf16; lengths [B] int32 (clamped to [0, S]
// here); o like q; lse [B, KVH, S, G] f32.  (rows, bk) one of the head
// dim's tilings (TilingsOf), else cudaErrorInvalidValue.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const int* lengths, void* o, float* lse, int B,
                              int S, int KVH, int G, int dh, int window,
                              float softcap, int causal, float scale,
                              int is_bf16, int rows, int bk, void* stream) {
  const int rc = check_shape(B, S, G, dh, rows);
  if (rc > 0) return rc;
  if (!(aligned(q, 16) && aligned(k, 16) && aligned(v, 16))) {
    return cudaErrorMisalignedAddress;
  }
  const Params p = params(q, k, v, lengths, o, lse, S, KVH, G, rows, window,
                          softcap, causal, scale, nullptr);
  const auto st = static_cast<cudaStream_t>(stream);
  return visit(dh, is_bf16, rows, bk, [&](auto i, int tiling) {
    using I = decltype(i);
    if (rc < 0) return cudaSuccess;  // an empty call: nothing to launch
    return launch<typename I::T, I::DH, I::R, I::BK>(p, B, tiling, st);
  });
}

// A measurement launch beside the wrapped path, on flash_attn_fwd's
// operands and tiling: each block writes the key tiles it walked and the
// SM clocks it took into blocks[2 * i] and blocks[2 * i + 1], i its linear
// index (blockIdx.x fastest; the grid of flash_attn_fwd_plan).  With
// one_pass (f32 at head_dim 64 or 256, the default tiling only) both
// products take one TF32 pass, hi*hi: the precision control of the 3xTF32
// split.
extern "C" int flash_attn_fwd_probe(int one_pass, const void* q,
                                    const void* k, const void* v,
                                    const int* lengths, void* o, float* lse,
                                    int B, int S, int KVH, int G, int dh,
                                    int window, float softcap, int causal,
                                    float scale, int is_bf16, int rows,
                                    int bk, long long* blocks,
                                    void* stream) {
  const int rc = check_shape(B, S, G, dh, rows);
  if (rc > 0) return rc;
  if (!(aligned(q, 16) && aligned(k, 16) && aligned(v, 16))) {
    return cudaErrorMisalignedAddress;
  }
  const Params p = params(q, k, v, lengths, o, lse, S, KVH, G, rows, window,
                          softcap, causal, scale, blocks);
  const auto st = static_cast<cudaStream_t>(stream);
  if (!one_pass) {
    return visit(dh, is_bf16, rows, bk, [&](auto i, int tiling) {
      using I = decltype(i);
      if (rc < 0) return cudaSuccess;
      return launch<typename I::T, I::DH, I::R, I::BK>(p, B, tiling, st);
    });
  }
  if (is_bf16 || rows != 64 || !((dh == 64 && bk == 32) ||
                                 (dh == 256 && bk == 16))) {
    return cudaErrorInvalidValue;
  }
  if (rc < 0) return 0;
  return dh == 64 ? launch<float, 64, 64, 32, true>(p, B, 0, st)
                  : launch<float, 256, 64, 16, true>(p, B, 0, st);
}

// The launcher's grant for one instantiation on the current device:
// out[0] the dynamic shared bytes granted to the kernel of that head dim,
// type and tiling (0: none yet), out[1] the cudaFuncSetAttribute calls the
// forward's launches made in this process.
extern "C" int flash_attn_fwd_smem_state(int dh, int is_bf16, int rows,
                                         int bk, long long* out) {
  if (dh != 64 && dh != 128 && dh != 256) return cudaErrorInvalidValue;
  int tiling = -1;
  const cudaError_t found = visit(dh, is_bf16, rows, bk, [&](auto, int i) {
    tiling = i;
    return cudaSuccess;
  });
  if (found != cudaSuccess) return found;
  const cudaError_t e =
      g_grants.granted_here(instance(is_bf16, dh, tiling), out);
  if (e != cudaSuccess) return e;
  out[1] = g_grants.sets.load();
  return 0;
}
