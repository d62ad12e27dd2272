// Tensor-core helpers shared by the flash-attention kernels (flash_attn.cu,
// flash_attn_bwd.cu): f32 products at f32 accuracy on TF32 tensor cores
// (3xTF32), the swizzled tile layout their fragment loads read, copies of
// tiles in the model layout (cp.async, common.cuh), and the attention
// masks.
//
// 3xTF32: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 on operands
// split as hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi); a product is
// lo*hi + hi*lo + hi*hi accumulated in f32.  A bf16 operand widened to f32
// is exact in TF32 (lo = 0), so its lo terms are skipped by type.
// tests/test_torch_tf32_split.py emulates the split in numpy.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro {

// a bf16 operand widened to f32 is exact in TF32 (lo = 0)
template <typename T>
inline constexpr bool kExactTf32 = std::is_same<T, __nv_bfloat16>::value;

// r / G for 0 <= r < 2^16 and G <= 64, from inv_g = 1 / G: (r + 0.5) / G
// lies at least 0.5 / G from an integer, far beyond float's error here.
__device__ __forceinline__ int div_g(int r, float inv_g) {
  return __float2int_rd((static_cast<float>(r) + 0.5f) * inv_g);
}

// ------------------------------------------------------------ tensor cores --
// cvt.rna.tf32.f32 for finite x: nearest, ties away from zero, on the 13
// low mantissa bits (a carry into the exponent is the rounding up).  Two
// integer operations; the cvt instruction itself lowers to a longer
// sequence on sm_90.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j0 + u] += a b[u] for u < U: one term of the 3xTF32 product over U n8
// tiles.  The callers issue the terms lo*hi, hi*lo (skipped where lo is 0
// by type), then hi*hi, each across several accumulators, so that an
// accumulator's next product is independent ones away.
template <int U, int J>
__device__ __forceinline__ void mma_row(float (&d)[J][4], int j0,
                                        const uint32_t (&a)[4],
                                        const uint32_t (&b)[U][2]) {
#pragma unroll
  for (int u = 0; u < U; ++u) mma_tf32(d[j0 + u], a, b[u]);
}

// ----------------------------------------------------------- tile layout --
// The 16-byte chunk a row's chunk j lands in is j ^ swz(row).  With f32
// (4 per chunk) the permutation flips column bits 2-4 by row bits 0-2 so
// that the 32 lanes of a fragment load, 8 rows x 4 columns or 4 rows x 8
// columns, hit 32 banks; with bf16 (8 per chunk, two per bank) the same
// holds for the 16 words such a load touches.
template <typename T>
__device__ __forceinline__ int swz(int r);
template <>
__device__ __forceinline__ int swz<float>(int r) {
  return ((r & 3) << 1) | ((r >> 2) & 1);
}
template <>
__device__ __forceinline__ int swz<__nv_bfloat16>(int r) {
  return r & 7;
}

// Offset of element (r, c) in a tile of W columns of T (W / (16 /
// sizeof(T)) >= 8 chunks, so the permutation stays inside the row).
template <typename T, int W>
__device__ __forceinline__ int at(int r, int c) {
  constexpr int E = 16 / sizeof(T);
  static_assert(W % (8 * E) == 0, "a tile row holds a multiple of 8 chunks");
  return r * W + ((c / E) ^ swz<T>(r)) * E + c % E;
}

// An operand tile in shared memory, [rows][W] of T.  Unless kPre, an
// element is split when loaded: hi = cvt.rna.tf32(x), lo =
// cvt.rna.tf32(x - hi), and a widened bf16 is hi alone.  With kPre (f32)
// the tile was split once after it landed (split_chunks): t holds the hi
// bits in place and lo the lo plane, so a load is two reads.
template <typename T, int W, bool kPre = false>
struct Opnd {
  const T* t;
  const uint32_t* lo;

  __device__ __forceinline__ void get(int r, int c, uint32_t& h,
                                      uint32_t& l) const {
    const int o = at<T, W>(r, c);
    if constexpr (kPre) {
      h = reinterpret_cast<const uint32_t*>(t)[o];
      l = lo[o];
    } else if constexpr (kExactTf32<T>) {
      h = __float_as_uint(to_f(t[o]));
      l = 0u;
    } else {
      split(to_f(t[o]), h, l);
    }
  }
};

// The A fragment (16 x 8, row-major) at rows m0.., columns k0.. of a tile.
template <typename O>
__device__ __forceinline__ void frag_a(const O& x, int m0, int k0, int lane,
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
  const int g = lane >> 2, c = lane & 3;
  x.get(m0 + g, k0 + c, h[0], l[0]);
  x.get(m0 + g + 8, k0 + c, h[1], l[1]);
  x.get(m0 + g, k0 + c + 4, h[2], l[2]);
  x.get(m0 + g + 8, k0 + c + 4, h[3], l[3]);
}

// The B fragment (8 x 8, k x n) of a tile stored [n][k]: k^T of q k^T.
template <typename O>
__device__ __forceinline__ void frag_b_nk(const O& x, int k0, int n0,
                                          int lane, uint32_t (&h)[2],
                                          uint32_t (&l)[2]) {
  const int g = lane >> 2, c = lane & 3;
  x.get(n0 + g, k0 + c, h[0], l[0]);
  x.get(n0 + g, k0 + c + 4, h[1], l[1]);
}

// The B fragment of a tile stored [k][n]: k of ds k.
template <typename O>
__device__ __forceinline__ void frag_b_kn(const O& x, int k0, int n0,
                                          int lane, uint32_t (&h)[2],
                                          uint32_t (&l)[2]) {
  const int g = lane >> 2, c = lane & 3;
  x.get(k0 + c, n0 + g, h[0], l[0]);
  x.get(k0 + c + 4, n0 + g, h[1], l[1]);
}

// Two neighbouring scores (r, c), (r, c + 1), c even, into the hi and lo
// planes of a p or ds tile (split once, here).
template <int W>
__device__ __forceinline__ void st_split(uint32_t* hp, uint32_t* lp, int r,
                                         int c, float x0, float x1) {
  uint2 h, l;
  split(x0, h.x, l.x);
  split(x1, h.y, l.y);
  const int o = at<float, W>(r, c);
  *reinterpret_cast<uint2*>(hp + o) = h;
  *reinterpret_cast<uint2*>(lp + o) = l;
}

// Split, in place, the 16-byte chunks of an f32 tile ([ROWS][DH]) that this
// thread copied (copy_rows' and copy_keys' assignment of chunks to
// threads), once they have landed: the hi bits over the elements, the lo
// plane into lo.  No other thread reads them before the next barrier.
template <int ROWS, int DH, int THREADS>
__device__ __forceinline__ void split_chunks(float* t, uint32_t* lo) {
  constexpr int CPR = DH / 4;
  static_assert(ROWS * CPR % THREADS == 0, "whole rounds of chunks");
#pragma unroll
  for (int n = 0; n < ROWS * CPR / THREADS; ++n) {
    const int i = threadIdx.x + n * THREADS;
    const int c = i / CPR, j = i % CPR;
    const int o = c * DH + (j ^ swz<float>(c)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(t + o);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(t + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// Folded rows q0.. of a [B, S, KVH*G, DH] tensor into a [R][DH] tile: row r
// <-> query q0 + r / G, head h*G + r % G; rows past BQ*G or S: zeros.  P
// holds S, KVH, G and BQ (the kernel's parameters).
template <typename T, int DH, int R, int THREADS, typename P>
__device__ void copy_rows(T* dst, const void* src_, const P& p, int b, int h,
                          int q0, float inv_g) {
  constexpr int E = 16 / sizeof(T), CPR = DH / E;  // chunks per row
  const T* src = static_cast<const T*>(src_);
  static_assert(R * CPR % THREADS == 0, "whole rounds of chunks");
  const int rows = p.BQ * p.G;
#pragma unroll
  for (int n = 0; n < R * CPR / THREADS; ++n) {
    const int i = threadIdx.x + n * THREADS;
    const int r = i / CPR, j = i % CPR;
    const int rq = div_g(r, inv_g);
    const int s = q0 + rq;
    const bool ok = r < rows && s < p.S;
    const T* g = ok ? src + ((((long long)b * p.S + s) * p.KVH + h) * p.G +
                             (r - rq * p.G)) * DH + j * E
                    : src;
    cp16(dst + r * DH + (j ^ swz<T>(r)) * E, g, ok);
  }
}

// The tile row key c of a key tile lands in: c itself, or with kPairRows
// the even keys of each 8 in rows 0-3 and the odd ones in rows 4-7, so
// that a B fragment (rows k and k + 4) holds keys 2k and 2k + 1: the
// columns an m16n8 accumulator holds per thread (flash_attn.cu's p v).
template <bool kPairRows>
__device__ __forceinline__ int key_row(int c) {
  if constexpr (kPairRows) {
    return (c & ~7) | ((c & 7) >> 1) | ((c & 1) << 2);
  } else {
    return c;
  }
}

// Keys k0.. of a [B, S, KVH, DH] tensor into a [BK][DH] tile (rows as
// key_row); keys past S: 0.
template <typename T, int DH, int BK, int THREADS, bool kPairRows = false,
          typename P>
__device__ void copy_keys(T* dst, const void* src_, const P& p, int b, int h,
                          int k0) {
  constexpr int E = 16 / sizeof(T), CPR = DH / E;
  static_assert(BK * CPR % THREADS == 0, "whole rounds of chunks");
  const T* src = static_cast<const T*>(src_);
#pragma unroll
  for (int n = 0; n < BK * CPR / THREADS; ++n) {
    const int i = threadIdx.x + n * THREADS;
    const int c = i / CPR, j = i % CPR;
    const int key = k0 + c;
    const bool ok = key < p.S;
    const T* g =
        ok ? src + (((long long)b * p.S + key) * p.KVH + h) * DH + j * E : src;
    const int r = key_row<kPairRows>(c);
    cp16(dst + r * DH + (j ^ swz<T>(r)) * E, g, ok);
  }
}

// ------------------------------------------------------------- the masks --
__device__ __forceinline__ bool live(int key, int pos, int L, int window,
                                     int causal) {
  bool ok = key < L;
  if (causal) ok = ok && key <= pos;
  if (window) ok = ok && key > pos - window;
  return ok;
}

template <int J>
__device__ __forceinline__ void zero(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] = 0.f;
}

// sum += part, in IEEE f32 adds: a tile's products accumulate on the
// tensor cores (a few k-steps), the long sum over tiles here.
template <int J>
__device__ __forceinline__ void add_into(float (&sum)[J][4],
                                         const float (&part)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) sum[j][i] += part[j][i];
}

// With blocks set (a probe launch), once every thread is done: the tiles
// this block walked and the SM clocks since c0, at 2 * (its linear index,
// blockIdx.x fastest).  Uniform over the block.
__device__ __forceinline__ void record(long long* blocks, int tiles,
                                       long long c0) {
  if (blocks == nullptr) return;
  __syncthreads();
  if (threadIdx.x != 0) return;
  const long long at = blockIdx.x + (long long)gridDim.x *
                       (blockIdx.y + (long long)gridDim.y * blockIdx.z);
  blocks[2 * at] = tiles;
  blocks[2 * at + 1] = clock64() - c0;
}

}  // namespace repro
