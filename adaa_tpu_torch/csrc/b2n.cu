// RawNet3's eval-mode Bottle2neck block body on Hopper (sm_90a), forward and dx
// backward: x (B, T, Cin) bf16 -> y, o (B, T, 1024) bf16, for the three blocks
// of RawNet3 (Cin 256 with a 1x1 projection residual at dilation 2, Cin 1024
// with the identity residual at dilations 3 and 4).
//
// Replaces the TPU kernel adaa_tpu/ops/pallas_b2n.py (fused_bottle2neck ->
// _fwd_call/_fwd_kernel, _bwd_call/_bwd_kernel). Python wrapper, plain-torch
// version, the pool that follows and launch counts: ops/b2n.py.
//
// Numerics (as the JAX kernel): every product has bf16 operands and f32 sums
// (tensor cores, wmma m16n16k16 bf16 -> f32); h = relu(x W1 + b1) s1 + t1 and
// the chain stay f32, each chain conv's input is zeroed outside [0, T) and
// rounded to bf16 at the product; cat holds the bf16 chain outputs and h's
// eighth split; o = relu(cat W3 + b3) s3 + t3 is stored in bf16; y = o + res
// in f32 is stored in bf16 (res = the bf16 x, or x W_r). The products of the
// affines are kept apart from their sums (__fmul_rn, __fadd_rn), as the plain
// version computes them. The backward takes conv3's mask from o
// (bf16(o) != bf16(t3)), rounds dq to bf16 before its product with W3^T,
// descends the chain with the masks sp_i != tc_i and carries din into the
// level below, masks with z + b1 > 0, and writes
// dx = bf16(dz1) W1^T + (bf16(dy) W_r^T or dy) in bf16.
//
// What bounds it on an H100: the products. At B = 64, RawNet3's three blocks
// do ~2.1 TFLOP forward (layer 1, T = 6435: conv1 0.22, chain 0.28, conv3 0.86,
// residual 0.22) and ~2x that in the backward, i.e. ~2 ms forward at the bf16
// tensor-core peak, while the bytes each block must move are ~2-4 GB (~1 ms).
// The TPU kernel kept a 480-row time tile with halos of up to 2 * 7 * d rows
// of all 1024 channels in VMEM (~2 MB); a Hopper block has at most 227 KB of
// shared memory. So the block body runs as three stages with the
// intermediates in device memory:
//   (a) a tile GEMM for conv1 whose epilogue writes h (f32, the 7 chain
//       strips), h's eighth split into cat (bf16) and conv1's relu mask (bits);
//   (b) a chain kernel: one block holds a 256-row time region (a central tile
//       plus a halo of at least 7 d rows each side) of one 128-wide strip in
//       shared memory, as bf16 operands, and runs the 7 levels in order; each
//       level's epilogue forms the next level's bf16 input in place of the
//       TPU kernel's sublane rolls (a dilated tap is a row offset into the
//       same buffer), writes cat for the central rows and the level's relu
//       mask (bits);
//   (c) a tile GEMM for conv3 (and the residual projection into the same
//       accumulator tile), writing o and y.
// The backward mirrors it: a GEMM with W3^T whose A operand is dq formed from
// dy and o on its way into shared memory, the chain descent (masks read back from the
// forward, so the halo is 7 d rows, not the TPU kernel's 14 d of recompute),
// then the GEMM with W1^T plus the residual's W_r^T into the same tile. One
// templated bf16 tile GEMM (128 x 128 x 32, 8 warps, register double
// buffering, an A-operand loader and epilogue functors) serves all six
// products; no product goes to cuBLAS. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int PLANES = 1024, WIDTH = 128, NUMS = 7, CHAIN = NUMS * WIDTH;
constexpr int MASK1_WORDS = PLANES / 32, CMASK_WORDS = CHAIN / 32;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float relu_affine(float z, float s, float t) {
  return __fadd_rn(__fmul_rn(fmaxf(z, 0.f), s), t);
}

__device__ __forceinline__ void store_bf16x4(bf16* dst, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = v;
}

__device__ __forceinline__ void load_bf16x4(const bf16* src, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = __bfloat162float(h[j]);
}

// 32 f32 values -> 32 bf16 at dst (16-byte aligned), as 4 x 16-byte stores.
__device__ __forceinline__ void store_bf16x32(bf16* dst, const float (&v)[32]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 u;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 p = __floats2bfloat162_rn(v[8 * q + 2 * k], v[8 * q + 2 * k + 1]);
      w[k] = *reinterpret_cast<uint32_t*>(&p);
    }
    reinterpret_cast<uint4*>(dst)[q] = u;
  }
}

// ---------------------------------------------------------------------------
// Tile GEMM: C[M, N] = A[M, K] B[K, N], A from a loader functor, B bf16
// row-major; optionally a second product into the same tile (DUAL).
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32, GT = 256;
constexpr int LDA_S = BK + 8, LDB_S = BN + 8, LDC_S = BN + 4;
constexpr int SA_BYTES = BM * LDA_S * 2, SB_BYTES = BK * LDB_S * 2;
constexpr size_t GEMM_SMEM = 2 * SA_BYTES + 2 * SB_BYTES + (size_t)BM * LDC_S * 4;

// A-operand loaders: fetch() issues the global loads of 8 bf16 at (row, k);
// finish() turns them into the 8 bf16 operands when they are stored to shared
// memory, after the current tile's products, so the loads' latency overlaps
// them.
struct LoadPlain {  // a row-major (M, lda) matrix
  const bf16* a;
  int lda;
  using Raw = uint4;
  __device__ Raw fetch(long long row, int k) const {
    return *reinterpret_cast<const uint4*>(a + row * lda + k);
  }
  __device__ Raw zero() const { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ uint4 finish(const Raw& r, int) const { return r; }
};

struct LoadDq {  // dq = bf16(bf16(o) != bf16(t3) ? dy * s3 : 0)
  const bf16* dy;
  const bf16* o;
  const float* s3;
  const float* t3;
  struct Raw {
    uint4 dy, o;
  };
  __device__ Raw fetch(long long row, int k) const {
    return {*reinterpret_cast<const uint4*>(dy + row * PLANES + k),
            *reinterpret_cast<const uint4*>(o + row * PLANES + k)};
  }
  __device__ Raw zero() const { return {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)}; }
  __device__ uint4 finish(const Raw& r, int k) const {
    const bf16* d = reinterpret_cast<const bf16*>(&r.dy);
    const bf16* oo = reinterpret_cast<const bf16*>(&r.o);
    uint4 out;
    bf16* rr = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float t3b = __bfloat162float(__float2bfloat16_rn(t3[k + j]));
      const bool live = __bfloat162float(oo[j]) != t3b;
      rr[j] = __float2bfloat16_rn(live ? __fmul_rn(__bfloat162float(d[j]), s3[k + j]) : 0.f);
    }
    return out;
  }
};

// Epilogues: called per (row, 4 columns) by all 32 lanes of a warp for one
// row (lane l holds columns col0 + 4 l); v may be changed in place.
struct EpiNone {
  __device__ void operator()(long long, int, float4&, int) const {}
};

struct EpiStore {  // bf16(v) -> out (M, ld)
  bf16* out;
  int ld;
  __device__ void operator()(long long row, int col, float4& v, int) const {
    store_bf16x4(out + row * ld + col, v.x, v.y, v.z, v.w);
  }
};

struct EpiAdd {  // bf16(v + add) -> out, add bf16 (M, lda)
  const bf16* add;
  int lda;
  bf16* out;
  int ld;
  __device__ void operator()(long long row, int col, float4& v, int) const {
    float a[4];
    load_bf16x4(add + row * lda + col, a);
    store_bf16x4(out + row * ld + col, __fadd_rn(v.x, a[0]), __fadd_rn(v.y, a[1]),
                 __fadd_rn(v.z, a[2]), __fadd_rn(v.w, a[3]));
  }
};

struct EpiH {  // conv1: h (f32 chain strips), cat's eighth split (bf16), mask1 bits
  const float* b1;
  const float* s1;
  const float* t1;
  float* h;
  bf16* cat;
  uint32_t* mask1;
  __device__ void operator()(long long row, int col, float4& v, int lane) const {
    const float z[4] = {v.x, v.y, v.z, v.w};
    float hv[4];
    uint32_t nib = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float zz = __fadd_rn(z[j], b1[col + j]);
      nib |= (uint32_t)(zz > 0.f) << j;
      hv[j] = relu_affine(zz, s1[col + j], t1[col + j]);
    }
    if (col < CHAIN) {
      *reinterpret_cast<float4*>(h + row * CHAIN + col) = make_float4(hv[0], hv[1], hv[2], hv[3]);
    } else {
      store_bf16x4(cat + row * PLANES + col, hv[0], hv[1], hv[2], hv[3]);
    }
    // lanes 8k .. 8k+7 hold the 32 columns of one mask word
    uint32_t w = nib << (4 * (lane & 7));
    w |= __shfl_xor_sync(0xffffffffu, w, 1);
    w |= __shfl_xor_sync(0xffffffffu, w, 2);
    w |= __shfl_xor_sync(0xffffffffu, w, 4);
    if ((lane & 7) == 0) mask1[row * MASK1_WORDS + col / 32] = w;
  }
};

struct EpiO {  // conv3: o (bf16 out, and f32 into v); with x: y = bf16(o + x)
  const float* b3;
  const float* s3;
  const float* t3;
  bf16* o;
  const bf16* x;  // identity residual, or nullptr (the projection follows)
  bf16* y;
  __device__ void operator()(long long row, int col, float4& v, int) const {
    float ov[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) ov[j] = relu_affine(__fadd_rn(ov[j], b3[col + j]), s3[col + j], t3[col + j]);
    store_bf16x4(o + row * PLANES + col, ov[0], ov[1], ov[2], ov[3]);
    v = make_float4(ov[0], ov[1], ov[2], ov[3]);
    if (x != nullptr) {
      float xv[4];
      load_bf16x4(x + row * PLANES + col, xv);
      store_bf16x4(y + row * PLANES + col, __fadd_rn(ov[0], xv[0]), __fadd_rn(ov[1], xv[1]),
                   __fadd_rn(ov[2], xv[2]), __fadd_rn(ov[3], xv[3]));
    }
  }
};

struct EpiDcat {  // dq W3^T: dcat (f32 chain strips); h's split straight to dz1
  float* dcat;
  bf16* dz1;
  const uint32_t* mask1;
  const float* s1;
  __device__ void operator()(long long row, int col, float4& v, int) const {
    if (col < CHAIN) {
      *reinterpret_cast<float4*>(dcat + row * CHAIN + col) = v;
      return;
    }
    const uint32_t w = mask1[row * MASK1_WORDS + col / 32] >> (col % 32);
    const float d[4] = {v.x, v.y, v.z, v.w};
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = (w >> j) & 1u ? __fmul_rn(d[j], s1[col + j]) : 0.f;
    store_bf16x4(dz1 + row * PLANES + col, r[0], r[1], r[2], r[3]);
  }
};

template <class ALoad>
__device__ __forceinline__ void gemm_phase(const ALoad& aload, const bf16* __restrict__ bmat,
                                           int ldb, int k_total, long long m0, int n0,
                                           long long m_total, bf16* s_a, bf16* s_b,
                                           FragC (&acc)[4][2]) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }
  typename ALoad::Raw ra[2];
  uint4 rb[2];
  int k_loaded = 0;
  auto load = [&](int k0) {
    k_loaded = k0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * GT;
      const int r = idx >> 2, kc = (idx & 3) * 8;
      const long long row = m0 + r;
      ra[i] = row < m_total ? aload.fetch(row, k0 + kc) : aload.zero();
      const int br = idx >> 4, nc = (idx & 15) * 8;
      rb[i] = *reinterpret_cast<const uint4*>(bmat + (long long)(k0 + br) * ldb + n0 + nc);
    }
  };
  auto store = [&](int stage) {
    bf16* a = s_a + stage * BM * LDA_S;
    bf16* b = s_b + stage * BK * LDB_S;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * GT;
      *reinterpret_cast<uint4*>(a + (idx >> 2) * LDA_S + (idx & 3) * 8) =
          aload.finish(ra[i], k_loaded + (idx & 3) * 8);
      *reinterpret_cast<uint4*>(b + (idx >> 4) * LDB_S + (idx & 15) * 8) = rb[i];
    }
  };
  const int nk = k_total / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * BK);
    const bf16* a = s_a + (kt & 1) * BM * LDA_S;
    const bf16* b = s_b + (kt & 1) * BK * LDB_S;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa[4];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(fa[i], a + (wm * 64 + i * 16) * LDA_S + kk, LDA_S);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], b + kk * LDB_S + wn * 32 + j * 16, LDB_S);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    if (kt + 1 < nk) store((kt + 1) & 1);
    __syncthreads();
  }
}

template <class Epi>
__device__ __forceinline__ void gemm_epilogue(const Epi& epi, float* s_c, long long m0, int n0,
                                              long long m_total, bool write_back) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += GT / 32) {
    const long long row = m0 + r;
    if (row >= m_total) break;  // warp-uniform: rows only grow
    float4* p = reinterpret_cast<float4*>(s_c + r * LDC_S + lane * 4);
    float4 v = *p;
    epi(row, n0 + lane * 4, v, lane);
    if (write_back) *p = v;
  }
}

template <class A1, class E1, class A2, class E2, bool DUAL>
__global__ void __launch_bounds__(GT, 2)
    gemm_kernel(A1 a1, const bf16* __restrict__ b1, int ldb1, int k1, E1 e1, A2 a2,
                const bf16* __restrict__ b2, int ldb2, int k2, E2 e2, long long m_total) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_b = reinterpret_cast<bf16*>(smem + 2 * SA_BYTES);
  float* s_c = reinterpret_cast<float*>(smem + 2 * SA_BYTES + 2 * SB_BYTES);
  const long long m0 = (long long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  FragC acc[4][2];
  gemm_phase(a1, b1, ldb1, k1, m0, n0, m_total, s_a, s_b, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s_c + (wm * 64 + i * 16) * LDC_S + wn * 32 + j * 16, acc[i][j],
                              LDC_S, wmma::mem_row_major);
  }
  __syncthreads();
  gemm_epilogue(e1, s_c, m0, n0, m_total, DUAL);
  if constexpr (DUAL) {
    __syncthreads();
    gemm_phase(a2, b2, ldb2, k2, m0, n0, m_total, s_a, s_b, acc);
    // the tile in s_c (phase 1's value after its epilogue) plus the second
    // product, element by element: both fragments share one layout
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* p = s_c + (wm * 64 + i * 16) * LDC_S + wn * 32 + j * 16;
        FragC prev;
        wmma::load_matrix_sync(prev, p, LDC_S, wmma::mem_row_major);
#pragma unroll
        for (int e = 0; e < prev.num_elements; ++e) acc[i][j].x[e] = __fadd_rn(prev.x[e], acc[i][j].x[e]);
        wmma::store_matrix_sync(p, acc[i][j], LDC_S, wmma::mem_row_major);
      }
    }
    __syncthreads();
    gemm_epilogue(e2, s_c, m0, n0, m_total, false);
  }
}

template <class A1, class E1, class A2, class E2, bool DUAL>
int launch_gemm(A1 a1, const bf16* b1, int ldb1, int k1, E1 e1, A2 a2, const bf16* b2, int ldb2,
                int k2, E2 e2, long long m_total, int n_total, cudaStream_t s) {
  auto kern = gemm_kernel<A1, E1, A2, E2, DUAL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)GEMM_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_total / BN, (unsigned)((m_total + BM - 1) / BM));
  kern<<<grid, GT, GEMM_SMEM, s>>>(a1, b1, ldb1, k1, e1, a2, b2, ldb2, k2, e2, m_total);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The res2net chain: 7 dilated k=3 convs of width 128, forward or descent.
// ---------------------------------------------------------------------------

constexpr int CR = 256;           // region rows per block: halo + central tile + halo
constexpr int PADR = 8;           // zero rows above and below the region (>= dilation)
constexpr int LDS = WIDTH + 16;   // 288-byte rows: any row offset is a legal fragment pointer
constexpr int STG_LD = 64 + 4;    // per-warp f32 staging of 16 x 64
constexpr size_t CHAIN_BUF = (size_t)(CR + 2 * PADR) * LDS * sizeof(bf16);
constexpr size_t CHAIN_SMEM = 2 * CHAIN_BUF + (size_t)(GT / 32) * 16 * STG_LD * sizeof(float);

template <int D>
struct ChainTile {
  static constexpr int H = D == 2 ? 16 : 32;  // halo rows each side, >= 7 D
  static constexpr int TM = CR - 2 * H;       // central rows
  static_assert(H >= NUMS * D && D <= PADR, "halo");
};

struct ChainArgs {
  const float* src;       // forward: h (M, 896); descent: dcat (M, 896)
  const bf16* w;          // (21 * 128, 128): forward wc; descent: its blocks transposed
  const float* bc;        // (896) forward only
  const float* sc;        // (896)
  const float* tc;        // (896) forward only
  const uint32_t* mask1;  // (M, 32) descent only
  const float* s1;        // (1024) descent only
  uint32_t* cmask;        // (M, 28): written forward, read by the descent
  bf16* out;              // (M, 1024) cols 0..895: forward cat, descent dz1
  int t;
};

template <int D, bool DESCENT>
__global__ void __launch_bounds__(GT, 1) chain_kernel(ChainArgs a) {
  using Tile = ChainTile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* bufs[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem + CHAIN_BUF)};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stg = reinterpret_cast<float*>(smem + 2 * CHAIN_BUF) + warp * 16 * STG_LD;
  const int t0 = blockIdx.x * Tile::TM;
  const long long rowbase = (long long)blockIdx.y * a.t;

  // zero both buffers (the pad rows stay zero), then the first level's input
  for (int i = tid; i < (int)(2 * CHAIN_BUF / sizeof(uint4)); i += GT)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int first = DESCENT ? NUMS - 1 : 0;
  for (int i = tid; i < CR * (WIDTH / 8); i += GT) {
    const int r = i / (WIDTH / 8), c8 = (i % (WIDTH / 8)) * 8;
    const int pos = t0 - Tile::H + r;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
    if (pos >= 0 && pos < a.t) {
      const long long g = rowbase + pos;
      const float* s = a.src + g * CHAIN + first * WIDTH + c8;
      if (DESCENT) {
        const uint32_t w = a.cmask[g * CMASK_WORDS + (first * WIDTH + c8) / 32] >> (c8 % 32);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = (w >> j) & 1u ? __fmul_rn(s[j], a.sc[first * WIDTH + c8 + j]) : 0.f;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = s[j];
      }
    }
    uint4 u;
    uint32_t* uw = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      uw[k] = *reinterpret_cast<uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(bufs[0] + (PADR + r) * LDS + c8) = u;
  }
  __syncthreads();

  for (int q = 0; q < NUMS; ++q) {
    const int lvl = DESCENT ? NUMS - 1 - q : q;
    const bf16* cur = bufs[q & 1];
    bf16* nxt = bufs[(q + 1) & 1];
    // 16 units of 32 rows x 64 columns, two per warp
    for (int u = warp; u < 16; u += GT / 32) {
      const int r0 = (u >> 1) * 32, c0 = (u & 1) * 64;
      FragC acc[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[m][n], 0.f);
      }
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        // forward tap s reads row r + (s - 1) D; the transposed tap row r - (s - 1) D
        const int shift = DESCENT ? -(s - 1) * D : (s - 1) * D;
        const bf16* wb = a.w + (size_t)(lvl * 3 + s) * WIDTH * WIDTH;
#pragma unroll
        for (int kk = 0; kk < WIDTH; kk += 16) {
          // the weights come from L2: issue all four loads before the products
          FragB fb[4];
#pragma unroll
          for (int n = 0; n < 4; ++n) wmma::load_matrix_sync(fb[n], wb + kk * WIDTH + c0 + n * 16, WIDTH);
          FragA fa[2];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            wmma::load_matrix_sync(fa[m], cur + (PADR + r0 + m * 16 + shift) * LDS + kk, LDS);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            wmma::mma_sync(acc[0][n], fa[0], fb[n], acc[0][n]);
            wmma::mma_sync(acc[1][n], fa[1], fb[n], acc[1][n]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
          wmma::store_matrix_sync(stg + n * 16, acc[m][n], STG_LD, wmma::mem_row_major);
        __syncwarp();
        // lane: one row of the 16, 32 consecutive columns (one mask word)
        const int r = r0 + m * 16 + (lane >> 1), ch = c0 + (lane & 1) * 32;
        const int pos = t0 - Tile::H + r;
        const bool inb = pos >= 0 && pos < a.t;
        const bool central = r >= Tile::H && r < Tile::H + Tile::TM && pos < a.t;
        const long long g = rowbase + pos;
        const int col = lvl * WIDTH + ch;  // column within the 896 chain columns
        float v[32];
        const float* sv = stg + (lane >> 1) * STG_LD + (lane & 1) * 32;
#pragma unroll
        for (int j = 0; j < 32; ++j) v[j] = sv[j];
        float nx[32];
        if (!DESCENT) {
          uint32_t word = 0;
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            v[j] = relu_affine(__fadd_rn(v[j], a.bc[col + j]), a.sc[col + j], a.tc[col + j]);
            word |= (uint32_t)(v[j] != a.tc[col + j]) << j;
          }
          if (central) {
            store_bf16x32(a.out + g * PLANES + col, v);
            a.cmask[g * CMASK_WORDS + col / 32] = word;
          }
          if (lvl + 1 < NUMS) {
            const float* hn = a.src + g * CHAIN + col + WIDTH;
#pragma unroll
            for (int j = 0; j < 32; ++j) nx[j] = inb ? __fadd_rn(v[j], hn[j]) : 0.f;
            store_bf16x32(nxt + (PADR + r) * LDS + ch, nx);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 32; ++j) v[j] = inb ? v[j] : 0.f;  // din
          if (central) {
            const uint32_t w1 = a.mask1[g * MASK1_WORDS + col / 32];
#pragma unroll
            for (int j = 0; j < 32; ++j) nx[j] = (w1 >> j) & 1u ? __fmul_rn(v[j], a.s1[col + j]) : 0.f;
            store_bf16x32(a.out + g * PLANES + col, nx);
          }
          if (lvl > 0) {
            const int pcol = col - WIDTH;  // the level below
            const uint32_t wm = inb ? a.cmask[g * CMASK_WORDS + pcol / 32] : 0u;
            const float* dc = a.src + g * CHAIN + pcol;
#pragma unroll
            for (int j = 0; j < 32; ++j)
              nx[j] = (wm >> j) & 1u ? __fmul_rn(__fadd_rn(dc[j], v[j]), a.sc[pcol + j]) : 0.f;
            store_bf16x32(nxt + (PADR + r) * LDS + ch, nx);
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

template <int D, bool DESCENT>
int launch_chain(const ChainArgs& a, int batch, cudaStream_t s) {
  auto kern = chain_kernel<D, DESCENT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)CHAIN_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.t + ChainTile<D>::TM - 1) / ChainTile<D>::TM, batch);
  kern<<<grid, GT, CHAIN_SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool DESCENT>
int chain(int dilation, const ChainArgs& a, int batch, cudaStream_t s) {
  if (dilation == 2) return launch_chain<2, DESCENT>(a, batch, s);
  if (dilation == 3) return launch_chain<3, DESCENT>(a, batch, s);
  if (dilation == 4) return launch_chain<4, DESCENT>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Forward. x (B, T, Cin) bf16; w1 (Cin, 1024), wc (2688, 128), w3 (1024, 1024),
// wr (Cin, 1024) or null, bf16; b1 s1 t1 b3 s3 t3 (1024), bc sc tc (896) f32.
// Scratch: h (B T, 896) f32, cat (B T, 1024) bf16. Out: y, o (B, T, 1024) bf16,
// mask1 (B T, 32) and cmask (B T, 28) bit words. Returns cudaGetLastError().
int b2n_fwd(const void* x, const void* w1, const void* b1, const void* s1, const void* t1,
            const void* wc, const void* bc, const void* sc, const void* tc, const void* w3,
            const void* b3, const void* s3, const void* t3, const void* wr, void* h, void* cat,
            void* y, void* o, void* mask1, void* cmask, int batch, int t, int cin, int dilation,
            int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (cin % BN != 0 || (wr == nullptr && cin != PLANES)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long m = (long long)batch * t;
  const bf16* xb = (const bf16*)x;
  int err = launch_gemm<LoadPlain, EpiH, LoadPlain, EpiNone, false>(
      LoadPlain{xb, cin}, (const bf16*)w1, PLANES, cin,
      EpiH{(const float*)b1, (const float*)s1, (const float*)t1, (float*)h, (bf16*)cat,
           (uint32_t*)mask1},
      LoadPlain{nullptr, 0}, nullptr, 0, 0, EpiNone{}, m, PLANES, s);
  if (err) return err;
  ChainArgs ca{(const float*)h, (const bf16*)wc, (const float*)bc, (const float*)sc,
               (const float*)tc, nullptr, nullptr, (uint32_t*)cmask, (bf16*)cat, t};
  err = chain<false>(dilation, ca, batch, s);
  if (err) return err;
  const LoadPlain a_cat{(const bf16*)cat, PLANES};
  if (wr != nullptr) {
    return launch_gemm<LoadPlain, EpiO, LoadPlain, EpiStore, true>(
        a_cat, (const bf16*)w3, PLANES, PLANES,
        EpiO{(const float*)b3, (const float*)s3, (const float*)t3, (bf16*)o, nullptr, (bf16*)y},
        LoadPlain{xb, cin}, (const bf16*)wr, PLANES, cin, EpiStore{(bf16*)y, PLANES}, m, PLANES, s);
  }
  return launch_gemm<LoadPlain, EpiO, LoadPlain, EpiNone, false>(
      a_cat, (const bf16*)w3, PLANES, PLANES,
      EpiO{(const float*)b3, (const float*)s3, (const float*)t3, (bf16*)o, xb, (bf16*)y},
      LoadPlain{nullptr, 0}, nullptr, 0, 0, EpiNone{}, m, PLANES, s);
}

// dx backward. dy, o (B, T, 1024) bf16; mask1, cmask from the forward; s1
// (1024), sc (896), s3 t3 (1024) f32; wct (2688, 128) = wc's blocks transposed,
// w3t (1024, 1024), w1t (1024, Cin), wrt (1024, Cin) or null, bf16. Scratch:
// dcat (B T, 896) f32, dz1 (B T, 1024) bf16. Out: dx (B, T, Cin) bf16.
int b2n_bwd(const void* dy, const void* o, const void* mask1, const void* cmask, const void* s1,
            const void* wct, const void* sc, const void* s3, const void* t3, const void* w3t,
            const void* w1t, const void* wrt, void* dcat, void* dz1, void* dx, int batch, int t,
            int cin, int dilation, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (cin % BN != 0 || (wrt == nullptr && cin != PLANES)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long m = (long long)batch * t;
  const bf16* dyb = (const bf16*)dy;
  int err = launch_gemm<LoadDq, EpiDcat, LoadPlain, EpiNone, false>(
      LoadDq{dyb, (const bf16*)o, (const float*)s3, (const float*)t3}, (const bf16*)w3t, PLANES,
      PLANES, EpiDcat{(float*)dcat, (bf16*)dz1, (const uint32_t*)mask1, (const float*)s1},
      LoadPlain{nullptr, 0}, nullptr, 0, 0, EpiNone{}, m, PLANES, s);
  if (err) return err;
  ChainArgs ca{(const float*)dcat, (const bf16*)wct, nullptr, (const float*)sc, nullptr,
               (const uint32_t*)mask1, (const float*)s1, (uint32_t*)cmask, (bf16*)dz1, t};
  err = chain<true>(dilation, ca, batch, s);
  if (err) return err;
  const LoadPlain a_dz1{(const bf16*)dz1, PLANES};
  if (wrt != nullptr) {
    return launch_gemm<LoadPlain, EpiNone, LoadPlain, EpiStore, true>(
        a_dz1, (const bf16*)w1t, cin, PLANES, EpiNone{}, LoadPlain{dyb, PLANES},
        (const bf16*)wrt, cin, PLANES, EpiStore{(bf16*)dx, cin}, m, cin, s);
  }
  return launch_gemm<LoadPlain, EpiAdd, LoadPlain, EpiNone, false>(
      a_dz1, (const bf16*)w1t, cin, PLANES, EpiAdd{dyb, PLANES, (bf16*)dx, cin},
      LoadPlain{nullptr, 0}, nullptr, 0, 0, EpiNone{}, m, cin, s);
}

const char* b2n_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
