// Non-overlapping 1-D max pool on Hopper (sm_90a), forward and backward, for
// RawNet3's bf16 pools: x (B, T, C) bf16 -> (B, T / w, C), floor mode.
//
// Replaces the TPU kernel adaa_tpu/ops/pallas_pool.py (max_pool_1d -> _pool_fn:
// _fwd_kernel, _bwd_kernel). Python wrapper, plain-torch version and launch
// counts: ops/pool.py.
//
// Numerics (as the JAX kernel): the w window slots of one output row are the
// w consecutive input rows t2 * w .. t2 * w + w - 1, compared in f32 (exact for
// bf16 values). The forward writes their max in bf16. The backward recomputes
// the max and writes the cotangent g to the FIRST slot equal to it and zeros
// to every other slot; the dropped tail rows T mod w get zeros.
//
// What bounds it on an H100: it is a pure streaming pass with no arithmetic to
// speak of. At RawNet3 layer 1 (64, 6435, 1024), the forward reads 843 MB and
// writes 169 MB (0.30 ms at 3.35 TB/s); the backward reads x and g and writes
// dx (1.85 GB, 0.55 ms). So the design is only about the memory stream: one
// thread per 8 channels of one output row, 16-byte loads and stores,
// neighbouring threads on neighbouring channels, every byte touched once. The
// (8, 128) tiling, the VMEM budget and the row-tile search of the TPU kernel
// do not carry over. A channel count that is not a multiple of 8 takes the
// scalar variant of the same kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int V>
struct Vec;  // V bf16 values moved as one load
template <>
struct Vec<8> {
  using T = uint4;
};
template <>
struct Vec<1> {
  using T = __nv_bfloat16;
};

template <int V>
__device__ __forceinline__ void unpack(const typename Vec<V>::T& v, float (&f)[V]) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = __bfloat162float(h[i]);
}

template <int V>
__device__ __forceinline__ typename Vec<V>::T pack(const float (&f)[V]) {
  typename Vec<V>::T v;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < V; ++i) h[i] = __float2bfloat16_rn(f[i]);
  return v;
}

// One thread per (sample, output row, V channels).
template <int V>
__global__ void __launch_bounds__(THREADS)
    pool_fwd_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                    int t, int c, int w, long long n_items) {
  using VT = typename Vec<V>::T;
  const long long item = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (item >= n_items) return;
  const int cv = c / V;
  const long long row = item / cv;  // b * t2 + r
  const int ch = (int)(item % cv) * V;
  const int t2 = t / w;
  const long long b = row / t2, r = row % t2;
  const __nv_bfloat16* src = x + (b * t + r * w) * c + ch;
  float m[V];
  unpack<V>(*reinterpret_cast<const VT*>(src), m);
  for (int i = 1; i < w; ++i) {
    float v[V];
    unpack<V>(*reinterpret_cast<const VT*>(src + (long long)i * c), v);
#pragma unroll
    for (int k = 0; k < V; ++k) m[k] = fmaxf(m[k], v[k]);
  }
  *reinterpret_cast<VT*>(out + row * c + ch) = pack<V>(m);
}

// One thread per (sample, output row or the tail, V channels): recompute the
// max, route g to the first slot equal to it, zeros elsewhere. Row index t2 of
// a sample (when T mod w != 0) is its tail, which gets zeros.
template <int V>
__global__ void __launch_bounds__(THREADS)
    pool_bwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                    __nv_bfloat16* __restrict__ dx, int t, int c, int w, long long n_items) {
  using VT = typename Vec<V>::T;
  const long long item = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (item >= n_items) return;
  const int cv = c / V;
  const int t2 = t / w, rem = t - t2 * w;
  const int rows_per_sample = t2 + (rem > 0);
  const long long row = item / cv;
  const int ch = (int)(item % cv) * V;
  const long long b = row / rows_per_sample, r = row % rows_per_sample;
  const long long base = (b * t + r * w) * c + ch;
  float zero[V];
#pragma unroll
  for (int k = 0; k < V; ++k) zero[k] = 0.f;
  if (r == t2) {  // the dropped tail
    for (int i = 0; i < rem; ++i) *reinterpret_cast<VT*>(dx + base + (long long)i * c) = pack<V>(zero);
    return;
  }
  float m[V];
  unpack<V>(*reinterpret_cast<const VT*>(x + base), m);
  for (int i = 1; i < w; ++i) {
    float v[V];
    unpack<V>(*reinterpret_cast<const VT*>(x + base + (long long)i * c), v);
#pragma unroll
    for (int k = 0; k < V; ++k) m[k] = fmaxf(m[k], v[k]);
  }
  float gv[V];
  unpack<V>(*reinterpret_cast<const VT*>(g + (b * t2 + r) * c + ch), gv);
  bool taken[V];
#pragma unroll
  for (int k = 0; k < V; ++k) taken[k] = false;
  for (int i = 0; i < w; ++i) {
    float v[V], d[V];
    unpack<V>(*reinterpret_cast<const VT*>(x + base + (long long)i * c), v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const bool hit = v[k] == m[k] && !taken[k];
      d[k] = hit ? gv[k] : 0.f;
      taken[k] = taken[k] || v[k] == m[k];
    }
    *reinterpret_cast<VT*>(dx + base + (long long)i * c) = pack<V>(d);
  }
}

unsigned blocks_for(long long n_items) { return (unsigned)((n_items + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// x (B, T, C) bf16 -> out (B, T / w, C) bf16. Returns cudaGetLastError() as int.
int pool_fwd(const void* x, void* out, int batch, int t, int c, int w, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = c % 8 == 0;
  const long long n_items = (long long)batch * (t / w) * (vec ? c / 8 : c);
  if (n_items == 0) return 0;
  if (vec) {
    pool_fwd_kernel<8><<<blocks_for(n_items), THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, t, c, w, n_items);
  } else {
    pool_fwd_kernel<1><<<blocks_for(n_items), THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, t, c, w, n_items);
  }
  return (int)cudaGetLastError();
}

// x (B, T, C), g (B, T / w, C) -> dx (B, T, C), all bf16.
int pool_bwd(const void* x, const void* g, void* dx, int batch, int t, int c, int w, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = c % 8 == 0;
  const long long rows = (long long)batch * (t / w + (t % w > 0));
  const long long n_items = rows * (vec ? c / 8 : c);
  if (n_items == 0) return 0;
  if (vec) {
    pool_bwd_kernel<8><<<blocks_for(n_items), THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (__nv_bfloat16*)dx, t, c, w, n_items);
  } else {
    pool_bwd_kernel<1><<<blocks_for(n_items), THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (__nv_bfloat16*)dx, t, c, w, n_items);
  }
  return (int)cudaGetLastError();
}

const char* pool_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
