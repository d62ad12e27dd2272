// Fused sparse-ZO perturb and update on the flat parameter vector.
//
// Replaces the TPU kernels of src/repro/kernels/zo_update.py:
//   dual_perturb  (_dual_perturb_kernel, _dual_perturb_premasked_kernel)
//   fused_update  (_fused_update_kernel, _fused_update_premasked_kernel)
//
// What bounds them on an H100: bytes.  Each element is read once and written
// once or twice around one or two multiplies and an add, about 0.2 FLOP per
// byte, where the f32 CUDA cores would bind only above ~20 FLOP per byte.
// At N = 1.24e9 f32 (Llama-3.2-1B) dual_perturb moves 16 B per element (w and
// z in, w+ and w- out), ~19.8 GB, 5.9 ms at 3.35 TB/s; fused_update moves
// 12 B per element, 4.4 ms.
//
// Design: a grid-stride loop over packs of four elements (16 bytes of f32,
// or 8 bytes of bf16 w beside 16 bytes of f32 z and m), with a few blocks
// per SM, so that the only work is keeping loads in flight.  No shared
// memory and no reduction.  The two roundings of the TPU kernel (the f32
// product, then the add in w's dtype) are spelled __fmul_rn / __fadd_rn so
// that nvcc cannot contract them into one FMA: the client's update, the
// plain version and the server's replay then agree bit for bit.
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

template <typename T, bool HAS_M, int V>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const T* __restrict__ w, const float* __restrict__ z,
                    const float* __restrict__ m, const float* __restrict__ s,
                    T* __restrict__ out, long long n) {
  const float sc = *s;
  const long long nv = n / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = tid; i < nv; i += stride) {
    const Pack<T, V> wv = reinterpret_cast<const Pack<T, V>*>(w)[i];
    const Pack<float, V> zv = reinterpret_cast<const Pack<float, V>*>(z)[i];
    Pack<float, V> mv;
    if constexpr (HAS_M) mv = reinterpret_cast<const Pack<float, V>*>(m)[i];
    Pack<T, V> ov;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float mj = 1.f;
      if constexpr (HAS_M) mj = mv.v[j];
      ov.v[j] = from_f<T>(
          __fadd_rn(to_f(wv.v[j]), scaled<T, HAS_M>(sc, zv.v[j], mj)));
    }
    reinterpret_cast<Pack<T, V>*>(out)[i] = ov;
  }
  for (long long i = nv * V + tid; i < n; i += stride) {
    out[i] = from_f<T>(
        __fadd_rn(to_f(w[i]), scaled<T, HAS_M>(sc, z[i], HAS_M ? m[i] : 1.f)));
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
cudaError_t dual_launch(const void* w, const float* z, const float* m,
                        const float* eps, void* plus, void* minus,
                        long long n, cudaStream_t st) {
  dual_perturb_kernel<T, HAS_M, V><<<grid_for(n, V), kThreads, 0, st>>>(
      static_cast<const T*>(w), z, m, eps, static_cast<T*>(plus),
      static_cast<T*>(minus), n);
  return cudaGetLastError();
}

template <typename T, bool HAS_M, int V>
cudaError_t update_launch(const void* w, const float* z, const float* m,
                          const float* s, void* out, long long n,
                          cudaStream_t st) {
  fused_update_kernel<T, HAS_M, V><<<grid_for(n, V), kThreads, 0, st>>>(
      static_cast<const T*>(w), z, m, s, static_cast<T*>(out), n);
  return cudaGetLastError();
}

// Picks the instantiation for (w dtype, mask or not, packed or scalar).
template <template <typename, bool, int> class F, typename... A>
cudaError_t dispatch(int w_bf16, bool has_m, bool vec, A... args) {
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

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
