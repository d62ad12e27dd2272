// Fused sparse-ZO perturb and update on the flat parameter vector.
//
// Replaces the TPU kernels of src/repro/kernels/zo_update.py:
//   dual_perturb  (:40, _dual_perturb_kernel, _dual_perturb_premasked_kernel)
//   fused_update  (:90, _fused_update_kernel, _fused_update_premasked_kernel)
//
// What bounds them on an H100: bytes.  Each element is read once and written
// once or twice around one or two multiplies and an add, about 0.2 FLOP per
// byte, where the f32 CUDA cores would bind only above ~20 FLOP per byte.
// At N = 1.24e9 f32 (Llama-3.2-1B) dual_perturb moves 16 B per element (w and
// z in, w+ and w- out), ~19.8 GB, 5.9 ms at 3.35 TB/s; fused_update moves
// 12 B per element, 4.4 ms.
//
// dual_perturb: a grid-stride loop over packs of four elements (16 bytes of
// f32, or 8 bytes of bf16 w beside 16 bytes of f32 z and m), with a few
// blocks per SM, so that the only work is keeping loads in flight.
//
// fused_update is a stream that keeps more bytes in flight per thread and
// touches the caches less:
// * each block owns one chunk of kThreads x kUnroll packs (16,384 f32
//   elements), and the grid covers n exactly: the chunk's offsets are
//   computed once, in 32 bits inside the chunk;
// * each thread issues its kUnroll = 16 loads of w, of z (and of m) before
//   any arithmetic, 256 bytes of f32 per operand in flight (8 and 32 were
//   no faster on the card), pack u of a thread at u * kThreads +
//   threadIdx.x so that each round of loads is one coalesced sweep of the
//   block;
// * loads and stores are streaming (ld.global.cs / st.global.cs: evict
//   first), as every byte is touched once;
// * a ragged last chunk takes a guarded copy of the same loop, and the
//   n % 4 tail one element a thread of the last block.
// No shared memory and no reduction.  The two roundings of the TPU kernel
// (the f32 product, then the add in w's dtype) are spelled __fmul_rn /
// __fadd_rn so that nvcc cannot contract them into one FMA: the client's
// update, the plain version and the server's replay then agree bit for bit.
#include <cstring>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// s*z(*m) in f32, rounded to w's dtype, and back in f32 for the add
template <typename T, bool HAS_M>
__device__ __forceinline__ float scaled(float s, float z, float m) {
  float p = __fmul_rn(s, z);
  if constexpr (HAS_M) p = __fmul_rn(p, m);
  return to_f(from_f<T>(p));
}

template <typename T, bool HAS_M, int V>
__global__ void __launch_bounds__(kThreads)
dual_perturb_kernel(const T* __restrict__ w, const float* __restrict__ z,
                    const float* __restrict__ m,
                    const float* __restrict__ eps, T* __restrict__ plus,
                    T* __restrict__ minus, long long n) {
  const float e = *eps;
  const long long nv = n / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = tid; i < nv; i += stride) {
    const Pack<T, V> wv = reinterpret_cast<const Pack<T, V>*>(w)[i];
    const Pack<float, V> zv = reinterpret_cast<const Pack<float, V>*>(z)[i];
    Pack<float, V> mv;
    if constexpr (HAS_M) mv = reinterpret_cast<const Pack<float, V>*>(m)[i];
    Pack<T, V> pv, qv;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float mj = 1.f;
      if constexpr (HAS_M) mj = mv.v[j];
      const float a = scaled<T, HAS_M>(e, zv.v[j], mj);
      const float x = to_f(wv.v[j]);
      pv.v[j] = from_f<T>(__fadd_rn(x, a));
      qv.v[j] = from_f<T>(__fsub_rn(x, a));
    }
    reinterpret_cast<Pack<T, V>*>(plus)[i] = pv;
    reinterpret_cast<Pack<T, V>*>(minus)[i] = qv;
  }
  for (long long i = nv * V + tid; i < n; i += stride) {  // the n % V tail
    const float a = scaled<T, HAS_M>(e, z[i], HAS_M ? m[i] : 1.f);
    const float x = to_f(w[i]);
    plus[i] = from_f<T>(__fadd_rn(x, a));
    minus[i] = from_f<T>(__fsub_rn(x, a));
  }
}

// A pack read or written with the streaming cache hint (evict first).
template <typename P>
__device__ __forceinline__ P ld_cs(const P* a) {
  static_assert(sizeof(P) == 16 || sizeof(P) == 8 || sizeof(P) == 4 ||
                sizeof(P) == 2, "a 2, 4, 8 or 16-byte pack");
  P x;
  if constexpr (sizeof(P) == 16) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(a));
    memcpy(&x, &u, 16);
  } else if constexpr (sizeof(P) == 8) {
    const uint2 u = __ldcs(reinterpret_cast<const uint2*>(a));
    memcpy(&x, &u, 8);
  } else if constexpr (sizeof(P) == 4) {
    const unsigned u = __ldcs(reinterpret_cast<const unsigned*>(a));
    memcpy(&x, &u, 4);
  } else {
    const unsigned short u =
        __ldcs(reinterpret_cast<const unsigned short*>(a));
    memcpy(&x, &u, 2);
  }
  return x;
}

template <typename P>
__device__ __forceinline__ void st_cs(P* a, const P& x) {
  if constexpr (sizeof(P) == 16) {
    uint4 u;
    memcpy(&u, &x, 16);
    __stcs(reinterpret_cast<uint4*>(a), u);
  } else if constexpr (sizeof(P) == 8) {
    uint2 u;
    memcpy(&u, &x, 8);
    __stcs(reinterpret_cast<uint2*>(a), u);
  } else if constexpr (sizeof(P) == 4) {
    unsigned u;
    memcpy(&u, &x, 4);
    __stcs(reinterpret_cast<unsigned*>(a), u);
  } else {
    unsigned short u;
    memcpy(&u, &x, 2);
    __stcs(reinterpret_cast<unsigned short*>(a), u);
  }
}

constexpr int kUnroll = 16;  // packs a thread has in flight per operand

// out = w + round_T(s z (m)) over packs [0, np) of the chunk at w, z, m,
// out (np = kThreads * kUnroll but in the last chunk); GUARD: the ragged
// last chunk.
template <typename T, bool HAS_M, int V, bool GUARD>
__device__ __forceinline__ void update_chunk(const Pack<T, V>* w,
                                             const Pack<float, V>* z,
                                             const Pack<float, V>* m,
                                             Pack<T, V>* out, float sc,
                                             int np) {
  Pack<T, V> wv[kUnroll];
  Pack<float, V> zv[kUnroll], mv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = u * kThreads + threadIdx.x;
    if (!GUARD || i < np) {
      wv[u] = ld_cs(w + i);
      zv[u] = ld_cs(z + i);
      if constexpr (HAS_M) mv[u] = ld_cs(m + i);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = u * kThreads + threadIdx.x;
    if (GUARD && i >= np) continue;
    Pack<T, V> ov;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float mj = 1.f;
      if constexpr (HAS_M) mj = mv[u].v[j];
      ov.v[j] = from_f<T>(
          __fadd_rn(to_f(wv[u].v[j]), scaled<T, HAS_M>(sc, zv[u].v[j], mj)));
    }
    st_cs(out + i, ov);
  }
}

// One block per chunk of kThreads * kUnroll packs of V elements; the last
// block also takes the n % V elements past the packs.
template <typename T, bool HAS_M, int V>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const T* __restrict__ w, const float* __restrict__ z,
                    const float* __restrict__ m, const float* __restrict__ s,
                    T* __restrict__ out, long long n) {
  constexpr int kChunk = kThreads * kUnroll;
  const float sc = *s;
  const long long np = n / V;
  const long long p0 = (long long)blockIdx.x * kChunk;
  const auto* wp = reinterpret_cast<const Pack<T, V>*>(w) + p0;
  const auto* zp = reinterpret_cast<const Pack<float, V>*>(z) + p0;
  const auto* mp =
      HAS_M ? reinterpret_cast<const Pack<float, V>*>(m) + p0 : nullptr;
  auto* op = reinterpret_cast<Pack<T, V>*>(out) + p0;
  if (p0 + kChunk <= np) {
    update_chunk<T, HAS_M, V, false>(wp, zp, mp, op, sc, kChunk);
  } else if (p0 < np) {
    update_chunk<T, HAS_M, V, true>(wp, zp, mp, op, sc, (int)(np - p0));
  }
  if (blockIdx.x == gridDim.x - 1) {
    for (long long i = np * V + threadIdx.x; i < n; i += kThreads) {
      out[i] = from_f<T>(__fadd_rn(
          to_f(w[i]), scaled<T, HAS_M>(sc, z[i], HAS_M ? m[i] : 1.f)));
    }
  }
}

int grid_for(long long n, int v) {
  long long work = n / v + (n % v);
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T, bool HAS_M, int V>
LaunchPlan dual_plan(long long n) {
  return {reinterpret_cast<const void*>(dual_perturb_kernel<T, HAS_M, V>),
          dim3(grid_for(n, V)), kThreads, 0};
}

// fused_update: one block per chunk of kThreads * kUnroll packs (at least
// one block, which takes an n below one pack).
template <typename T, bool HAS_M, int V>
LaunchPlan update_plan(long long n) {
  const long long chunks = (n / V + kThreads * kUnroll - 1) /
                           (kThreads * kUnroll);
  return {reinterpret_cast<const void*>(fused_update_kernel<T, HAS_M, V>),
          dim3(chunks < 1 ? 1 : (unsigned)chunks), kThreads, 0};
}

template <typename T, bool HAS_M, int V>
cudaError_t dual_launch(const void* w, const float* z, const float* m,
                        const float* eps, void* plus, void* minus,
                        long long n, cudaStream_t st) {
  const LaunchPlan lp = dual_plan<T, HAS_M, V>(n);
  dual_perturb_kernel<T, HAS_M, V><<<lp.grid, lp.threads, 0, st>>>(
      static_cast<const T*>(w), z, m, eps, static_cast<T*>(plus),
      static_cast<T*>(minus), n);
  return cudaGetLastError();
}

template <typename T, bool HAS_M, int V>
cudaError_t update_launch(const void* w, const float* z, const float* m,
                          const float* s, void* out, long long n,
                          cudaStream_t st) {
  const LaunchPlan lp = update_plan<T, HAS_M, V>(n);
  fused_update_kernel<T, HAS_M, V><<<lp.grid, lp.threads, 0, st>>>(
      static_cast<const T*>(w), z, m, s, static_cast<T*>(out), n);
  return cudaGetLastError();
}

// Picks the instantiation for (w dtype, mask or not, packed or scalar).
template <template <typename, bool, int> class F, typename... A>
auto dispatch(int w_bf16, bool has_m, bool vec, A... args) {
  if (w_bf16) {
    if (has_m) return vec ? F<__nv_bfloat16, true, 4>::run(args...)
                          : F<__nv_bfloat16, true, 1>::run(args...);
    return vec ? F<__nv_bfloat16, false, 4>::run(args...)
               : F<__nv_bfloat16, false, 1>::run(args...);
  }
  if (has_m) return vec ? F<float, true, 4>::run(args...)
                        : F<float, true, 1>::run(args...);
  return vec ? F<float, false, 4>::run(args...)
             : F<float, false, 1>::run(args...);
}

template <typename T, bool HAS_M, int V>
struct Dual {
  template <typename... A>
  static cudaError_t run(A... a) { return dual_launch<T, HAS_M, V>(a...); }
};

template <typename T, bool HAS_M, int V>
struct Update {
  template <typename... A>
  static cudaError_t run(A... a) { return update_launch<T, HAS_M, V>(a...); }
};

template <typename T, bool HAS_M, int V>
struct DualPlan {
  static LaunchPlan run(long long n) { return dual_plan<T, HAS_M, V>(n); }
};

template <typename T, bool HAS_M, int V>
struct UpdatePlan {
  static LaunchPlan run(long long n) { return update_plan<T, HAS_M, V>(n); }
};

}  // namespace

extern "C" int zo_dual_perturb(const void* w, const float* z, const float* m,
                               const float* eps, void* plus, void* minus,
                               long long n, int w_bf16, void* stream) {
  if (n <= 0) return 0;
  const size_t wb = w_bf16 ? 8 : 16;
  const bool vec = aligned(w, wb) && aligned(plus, wb) &&
                   aligned(minus, wb) && aligned(z, 16) && aligned(m, 16);
  return dispatch<Dual>(w_bf16, m != nullptr, vec, w, z, m, eps, plus, minus,
                        n, static_cast<cudaStream_t>(stream));
}

extern "C" int zo_fused_update(const void* w, const float* z, const float* m,
                               const float* s, void* out, long long n,
                               int w_bf16, void* stream) {
  if (n <= 0) return 0;
  const size_t wb = w_bf16 ? 8 : 16;
  const bool vec = aligned(w, wb) && aligned(out, wb) && aligned(z, 16) &&
                   aligned(m, 16);
  return dispatch<Update>(w_bf16, m != nullptr, vec, w, z, m, s, out, n,
                          static_cast<cudaStream_t>(stream));
}

// The launch zo_dual_perturb (update = 0) or zo_fused_update (update = 1)
// makes for n elements of w (bf16 or f32), with or without m, packed
// (vec = 1: every operand 16-byte aligned, 8 for bf16 w) or not.
extern "C" int zo_update_plan(int update, long long n, int w_bf16, int has_m,
                              int vec, long long* out) {
  if (n <= 0) return write_plans(nullptr, 0, out);
  const LaunchPlan lp =
      update ? dispatch<UpdatePlan>(w_bf16, has_m != 0, vec != 0, n)
             : dispatch<DualPlan>(w_bf16, has_m != 0, vec != 0, n);
  return write_plans(&lp, 1, out);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
