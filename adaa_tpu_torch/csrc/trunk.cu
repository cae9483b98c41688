// LCNN mid-trunk segment on Hopper (sm_90a): conv 3x3 (SAME) + MFM + floor
// 2x2 max pool, forward (with the tie mask the backward takes) and dx
// backward, for the two segments of ops/trunk.py (A: (B, 202, 40, 32) ->
// (B, 101, 20, 48), c_out 96; B: (B, 101, 20, 48) -> (B, 50, 10, 64), c_out
// 128).
//
// Replaces the TPU kernel adaa_tpu/ops/pallas_trunk.py (fused_segment ->
// _conv3_op: _fwd_kernel, _bwd_kernel). Python wrapper, plain-torch version,
// the weight packings, the tile plans and shared-memory budgets, and launch
// counts: ops/trunk.py. PTX building blocks (bulk copies, mbarriers,
// ldmatrix, wgmma): hopper.cuh.
//
// Layouts: am (B, T, F, C2) f32 channels last; out and g (B, T/2, F/2, HALF)
// f32; mask (B, T/2, F/2, HALF) uint8; dx (B, T, F, C2) f32. The weights come
// packed by ops/trunk.py as the byte image of a wgmma B operand in shared
// memory (K-major, 128-byte swizzled boxes of N rows x 64 k):
//   forward  wf[n][k]: k = tap C2 + ci (tap = 3 dt + df), column n = 8 j + 2 q
//            + e holds conv channel e HALF + q NJ + j (NJ = C_OUT / 8), so an
//            MFM pair sits in adjacent accumulator columns and a thread's NJ
//            pooled channels are contiguous;
//   backward wd[ci][k]: k = tap C_OUT + co.
//
// Numerics (as the JAX op): am is rounded to bf16 where it is staged, the
// exact bf16 products are summed in f32 (wgmma), the f32 bias is added, then
// the MFM max over channel halves and the 2x2 max over the floor-pooled
// window, in the order (((c00 v c01) v (c10 v c11)) v (c20 v c21)) v (c30 v
// c31) (candidate c_qh: pool position q = 2 pt + pf, MFM half h). The forward
// that feeds a backward writes, per pooled output channel, the bits 4 pt +
// 2 pf + h of the candidates equal to the max (layer 0's numbering). The
// backward forms dy = bf16(g / popcount) on the set bits, else 0, and dx is
// the transposed conv of that bf16 dy with the bf16 weights, summed in f32.
//
// What bounds it on an H100: at B = 256 the forward does 171 GFLOP of bf16
// products over both segments (0.17 ms at 989 TFLOP/s) and moves ~0.5 GB
// (am read, out and the mask written); the backward's dx GEMM is as large
// and reads g and the mask, writes dx. The design:
//   forward: an implicit GEMM, M = the conv outputs that reach the pool, N =
//     C_OUT, K = 9 C2, on wgmma m64nC_OUTk16 with A from registers. Persistent
//     blocks of two warpgroups (no producer warp, so ptxas may give each
//     thread up to 255 registers) keep the packed weights in shared memory.
//     A tile is 64 pooled pixels of one sample; one thread copies its band of
//     am rows (contiguous in memory) with a bulk copy into an f32 staging
//     buffer while the block computes the previous tile; the block converts it
//     to a bf16 band with the SAME zero ring, its columns split by parity so
//     that the 8 rows of an ldmatrix are consecutive pixels. Rows r and r + 8
//     of a warp's accumulator are the two columns of 8 pooled pixels, and the
//     two conv rows run one after the other into one accumulator, so MFM and
//     pool are in-thread maxima and only the f32 pooled output (and the mask)
//     leave the block. Segment B's conv row 100 reaches no pool and is not
//     computed.
//   backward: an implicit GEMM, M = the input pixels, N = C2, K = 9 C_OUT, on
//     wgmma m64nC2k16. A tile is 128 dx pixels; the bulk copy brings the g and
//     mask rows of its pooled rows, and the block forms the bf16 dy band (with
//     a one-pixel halo, zero outside the conv outputs that reach the pool) in
//     shared memory: nothing is recomputed, no dy goes to device memory, no
//     atomics, and the result is deterministic. Segment B's last dx row (100)
//     receives only through the taps from dy row 99.
// Nothing goes to cuBLAS or cuDNN.

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

// Layout constants shared with ops/trunk.py (which plans the launches).
constexpr int THREADS = 256;  // two warpgroups; each thread owns accumulator rows
constexpr int SMEM_ALIGN = 1024, SMEM_LIMIT = 232448;
constexpr int FWD_SUBTILE = 64;  // pooled pixels per forward sub-tile (32 per warpgroup)
constexpr int DX_SUBTILE = 128;  // dx pixels per backward sub-tile (64 per warpgroup)
constexpr int PIXEL_PAD = 16;  // bytes after a staged pixel's channels: ldmatrix without conflicts
constexpr int BARRIER_BYTES = 16;

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A tile is FS forward (DS dx) sub-tiles, computed one after the other from
// one band: larger tiles stage fewer halo rows per pixel, as far as shared
// memory allows.
template <int T_, int F_, int C2_, int COUT_, int FS, int DS>
struct Segment {
  static constexpr int T = T_, F = F_, C2 = C2_, C_OUT = COUT_;
  static constexpr int FWD_SUB = FS, DX_SUB = DS;
  static constexpr int FWD_TILE = FS * FWD_SUBTILE, DX_TILE = DS * DX_SUBTILE;
  static constexpr int HALF = C_OUT / 2, NJ = C_OUT / 8;
  static constexpr int T_OUT = T / 2, F_OUT = F / 2, NP = T_OUT * F_OUT;  // pooled, per sample
  static constexpr int T2 = 2 * T_OUT, F2 = 2 * F_OUT;  // conv rows / cols that reach the pool
  static constexpr int NPIX = T * F;
  // forward
  static constexpr int KC = C2 / 16;  // k-steps per tap
  static constexpr int W_FWD_BYTES = cdiv(9 * C2, 64) * C_OUT * 128;
  static constexpr int SPAN_F = (F_OUT - 1 + FWD_TILE - 1) / F_OUT + 1;  // pooled rows of a tile
  static constexpr int BAND_ROWS = 2 * SPAN_F + 2;
  static constexpr int WH = (F + 2) / 2;  // staged columns per parity plane
  static constexpr int PPF = 2 * C2 + PIXEL_PAD;
  static constexpr int BAND_BYTES = BAND_ROWS * 2 * WH * PPF;
  static constexpr int STAGE_BYTES = BAND_ROWS * F * C2 * 4;
  static constexpr int FWD_SMEM =
      W_FWD_BYTES + STAGE_BYTES + BAND_BYTES + BARRIER_BYTES + SMEM_ALIGN;
  static constexpr int FWD_TILES = cdiv(NP, FWD_TILE);
  // backward
  static constexpr int KCD = C_OUT / 16;
  static constexpr int W_DX_BYTES = cdiv(9 * C_OUT, 64) * C2 * 128;
  static constexpr int SPAN_D = (F - 1 + DX_TILE - 1) / F + 1;  // dx rows of a tile
  static constexpr int DY_ROWS = SPAN_D + 2;
  static constexpr int G_ROWS = DY_ROWS / 2 + 1;
  static constexpr int PPD = 2 * C_OUT + PIXEL_PAD;
  static constexpr int DY_BYTES = DY_ROWS * (F + 2) * PPD;
  static constexpr int G_BYTES = G_ROWS * F_OUT * HALF * 4;
  static constexpr int M_BYTES = G_ROWS * F_OUT * HALF;
  static constexpr int DX_SMEM =
      W_DX_BYTES + G_BYTES + M_BYTES + DY_BYTES + BARRIER_BYTES + SMEM_ALIGN;
  static constexpr int DX_TILES = cdiv(NPIX, DX_TILE);

  static_assert(F % 2 == 0 && C2 % 16 == 0 && C_OUT % 16 == 0 && HALF % 8 == 0, "shapes");
  static_assert((PPF / 16) % 2 == 1 && (PPD / 16) % 2 == 1, "odd 16-byte pixel pitch");
  static_assert((F * C2 * 4) % 16 == 0 && (F_OUT * HALF) % 16 == 0, "bulk copy rows");
  static_assert(FWD_SMEM <= SMEM_LIMIT && DX_SMEM <= SMEM_LIMIT, "shared memory");
};
using SegA = Segment<202, 40, 32, 96, 2, 2>;
using SegB = Segment<101, 20, 48, 128, 1, 1>;

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((SMEM_ALIGN - (a & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The packed weights into shared memory (once per block), made visible to
// wgmma's async proxy.
__device__ __forceinline__ void load_weights(unsigned char* wsm, const uint4* __restrict__ w,
                                             int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += THREADS)
    reinterpret_cast<uint4*>(wsm)[i] = __ldg(w + i);
  fence_proxy_async();
}

// One k-step's B descriptor: k-step kk of a packed operand with N rows.
template <int N>
__device__ __forceinline__ uint64_t b_desc(const unsigned char* wsm, int kk) {
  return smem_desc(wsm + (kk >> 2) * N * 128 + 32 * (kk & 3));
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

struct FwdTile {
  int b, p0, np;  // sample, first pooled pixel, valid pixels
  int tp_lo;      // first pooled row
  int r0;         // input row of band row 0 (2 tp_lo - 1)
  int s_lo, s_hi; // input rows [s_lo, s_hi) in the image, staged
};

template <class S>
__device__ __forceinline__ FwdTile fwd_tile(int tile) {
  FwdTile t;
  t.b = tile / S::FWD_TILES;
  t.p0 = (tile % S::FWD_TILES) * S::FWD_TILE;
  t.np = min(S::FWD_TILE, S::NP - t.p0);
  t.tp_lo = t.p0 / S::F_OUT;
  const int tp_hi = (t.p0 + t.np - 1) / S::F_OUT;
  t.r0 = 2 * t.tp_lo - 1;
  t.s_lo = max(t.r0, 0);
  t.s_hi = min(2 * tp_hi + 3, S::T);
  return t;
}

template <class S>
__device__ __forceinline__ void fwd_stage(const float* __restrict__ am, float* stage,
                                          uint64_t* bar, int tile) {
  const FwdTile t = fwd_tile<S>(tile);
  const uint32_t bytes = (uint32_t)(t.s_hi - t.s_lo) * S::F * S::C2 * 4;
  fence_proxy_async();
  mbar_expect_tx(bar, bytes);
  bulk_load(stage, am + ((size_t)t.b * S::T + t.s_lo) * S::F * S::C2, bytes, bar);
}

// f32 staging -> the bf16 band: band row br is input row r0 + br, staged
// column s is input column s - 1, in parity plane s % 2 at index s / 2.
template <class S>
__device__ __forceinline__ void fwd_band(const float* stage, unsigned char* band,
                                         const FwdTile& t) {
  constexpr int CH8 = S::C2 / 8;
  for (int i = threadIdx.x; i < S::BAND_ROWS * (S::F + 2) * CH8; i += THREADS) {
    const int k8 = i % CH8, s = (i / CH8) % (S::F + 2), br = i / (CH8 * (S::F + 2));
    const int r = t.r0 + br, f = s - 1;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r >= t.s_lo && r < t.s_hi && f >= 0 && f < S::F) {
      const float4* src = reinterpret_cast<const float4*>(
          stage + ((r - t.s_lo) * S::F + f) * S::C2 + 8 * k8);
      const float4 a = src[0], b = src[1];
      u = make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                     pack_bf16x2(b.z, b.w));
    }
    *reinterpret_cast<uint4*>(band + ((br * 2 + (s & 1)) * S::WH + (s >> 1)) * S::PPF +
                              16 * k8) = u;
  }
}

template <class S>
__global__ void __launch_bounds__(THREADS, 1)
    trunk_fwd_kernel(const float* __restrict__ am, const uint4* __restrict__ wpk,
                     const float* __restrict__ bias, float* __restrict__ out,
                     uint32_t* __restrict__ mask, int tiles) {
  constexpr int N = S::C_OUT, NJ = S::NJ, KC = S::KC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* wsm = align_smem(smem_raw);
  float* stage = reinterpret_cast<float*>(wsm + S::W_FWD_BYTES);
  unsigned char* band = wsm + S::W_FWD_BYTES + S::STAGE_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(band + S::BAND_BYTES);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q = lane & 3;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  load_weights(wsm, wpk, S::W_FWD_BYTES);
  __syncthreads();
  if (tid == 0 && (int)blockIdx.x < tiles) fwd_stage<S>(am, stage, bar, blockIdx.x);

  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, phase ^= 1u) {
    const FwdTile t = fwd_tile<S>(tile);
    mbar_wait(bar, phase);
    fwd_band<S>(stage, band, t);
    __syncthreads();  // the band is complete and the staging free
    if (tid == 0 && tile + (int)gridDim.x < tiles)
      fwd_stage<S>(am, stage, bar, tile + gridDim.x);

    // sub-tile by sub-tile: pooled pixels sub0 + [0, 64), 32 per warpgroup
#pragma unroll 1
    for (int sub0 = t.p0; sub0 < t.p0 + t.np; sub0 += FWD_SUBTILE) {
      // this lane's ldmatrix row: pooled pixel 8 warp + m % 8 of the
      // warpgroup's 32, conv column 2 fp + m / 8
      const int m = lane & 15, cp = m >> 3;
      const int pc = min(sub0 + 32 * wg + 8 * warp + (m & 7), t.p0 + t.np - 1);
      const int tp = pc / S::F_OUT - t.tp_lo, fp = pc % S::F_OUT;
      uint32_t col_off[3];
#pragma unroll
      for (int df = 0; df < 3; ++df)
        col_off[df] = (((cp + df) & 1) * S::WH + fp + ((cp + df) >> 1)) * S::PPF;
      const uint32_t base = smem_u32(band) + (lane >> 4) * 16;

      float best[NJ];
      uint32_t bits[NJ];
#pragma unroll
      for (int pt = 0; pt < 2; ++pt) {
        AccN<N> acc;
        uint32_t fr[2][KC][4];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int dt = tap / 3, df = tap % 3;
          const uint32_t addr = base + (2 * tp + pt + dt) * 2 * S::WH * S::PPF + col_off[df];
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) ldmatrix_x4(fr[tap & 1][kc], addr + 32 * kc);
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < KC; ++kc)
            wgmma_rs_n<N>(acc, fr[tap & 1][kc], b_desc<N>(wsm, tap * KC + kc), tap + kc > 0);
          wgmma_commit();
          wgmma_wait<1>();  // the previous tap's products are done with its fragments
          if (tap > 0) {
#pragma unroll
            for (int kc = 0; kc < KC; ++kc) fence_regs(fr[(tap - 1) & 1][kc]);
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) fence_regs(fr[0][kc]);
        fence_acc(acc);

        // rows r (pf = 0) and r + 8 (pf = 1); columns 8 j + 2 q + h
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = q * NJ + j;
          const float b0 = __ldg(bias + c), b1 = __ldg(bias + S::HALF + c);
          const float lo0 = acc.d[4 * j] + b0, hi0 = acc.d[4 * j + 1] + b1;
          const float lo1 = acc.d[4 * j + 2] + b0, hi1 = acc.d[4 * j + 3] + b1;
          float v = pt == 0 ? fmaxf(lo0, hi0) : fmaxf(best[j], fmaxf(lo0, hi0));
          v = fmaxf(v, fmaxf(lo1, hi1));
          const uint32_t eq = (uint32_t)(lo0 == v) | ((uint32_t)(hi0 == v) << 1) |
                              ((uint32_t)(lo1 == v) << 2) | ((uint32_t)(hi1 == v) << 3);
          if (pt == 0) {
            bits[j] = eq;
          } else {
            bits[j] = (best[j] == v ? bits[j] : 0u) | (eq << 4);
          }
          best[j] = v;
        }
      }

      const int p = sub0 + 32 * wg + 8 * warp + (lane >> 2);
      if (p < t.p0 + t.np) {
        const size_t o = ((size_t)t.b * S::NP + p) * S::HALF + q * NJ;
        float4* dst = reinterpret_cast<float4*>(out + o);
#pragma unroll
        for (int k = 0; k < NJ / 4; ++k)
          dst[k] = make_float4(best[4 * k], best[4 * k + 1], best[4 * k + 2], best[4 * k + 3]);
        if (mask != nullptr) {
          uint32_t* mw = mask + o / 4;
#pragma unroll
          for (int k = 0; k < NJ / 4; ++k)
            mw[k] = bits[4 * k] | (bits[4 * k + 1] << 8) | (bits[4 * k + 2] << 16) |
                    (bits[4 * k + 3] << 24);
        }
      }
    }
    __syncthreads();  // every read of the band is done
  }
}

// ---------------------------------------------------------------------------
// Backward: dx
// ---------------------------------------------------------------------------

struct DxTile {
  int b, p0, np;   // sample, first dx pixel, valid pixels
  int t_lo;        // first dx row
  int d_lo;        // dy row of band row 0 (t_lo - 1)
  int e_lo, e_hi;  // dy rows [e_lo, e_hi] that reach the pool, formed
  int g_lo;        // first staged pooled row (e_lo / 2)
  int g_rows;      // staged pooled rows
};

template <class S>
__device__ __forceinline__ DxTile dx_tile(int tile) {
  DxTile t;
  t.b = tile / S::DX_TILES;
  t.p0 = (tile % S::DX_TILES) * S::DX_TILE;
  t.np = min(S::DX_TILE, S::NPIX - t.p0);
  t.t_lo = t.p0 / S::F;
  const int t_hi = (t.p0 + t.np - 1) / S::F;
  t.d_lo = t.t_lo - 1;
  t.e_lo = max(t.d_lo, 0);
  t.e_hi = min(t_hi + 1, S::T2 - 1);
  t.g_lo = t.e_lo / 2;
  t.g_rows = t.e_hi / 2 - t.g_lo + 1;
  return t;
}

template <class S>
__device__ __forceinline__ void dx_stage(const float* __restrict__ g,
                                         const unsigned char* __restrict__ mask, float* gst,
                                         unsigned char* mst, uint64_t* bar, int tile) {
  const DxTile t = dx_tile<S>(tile);
  const size_t row0 = ((size_t)t.b * S::T_OUT + t.g_lo) * S::F_OUT * S::HALF;
  const uint32_t n = (uint32_t)t.g_rows * S::F_OUT * S::HALF;
  fence_proxy_async();
  mbar_expect_tx(bar, 5 * n);
  bulk_load(gst, g + row0, 4 * n, bar);
  bulk_load(mst, mask + row0, n, bar);
}

// The dy band: band row br is dy row d_lo + br, column c is dy column c - 1
// (columns 0 and F + 1 stay zero from the start). One staged pooled pixel's
// 8 channels of one half at a time: bf16(g / popcount) once per channel,
// then the 16-byte chunks of its 4 conv outputs x 2 MFM halves, each value
// where its candidate's bit is set, else 0. Band rows that no staged pooled
// row covers (above the image, or below the conv rows that reach the pool)
// are zeroed.
template <class S>
__device__ __forceinline__ void dy_band(const float* gst, const unsigned char* mst,
                                        unsigned char* band, const DxTile& t) {
  constexpr int CH8 = S::HALF / 8, ROW8 = S::F * S::C_OUT / 8;
  const int c_lo = max(2 * t.g_lo - t.d_lo, 0);
  const int c_hi = min(2 * (t.g_lo + t.g_rows) - 1 - t.d_lo, S::DY_ROWS - 1);
  const int n_zero = c_lo + S::DY_ROWS - 1 - c_hi;
  for (int i = threadIdx.x; i < n_zero * ROW8; i += THREADS) {
    const int r = i / ROW8, br = r < c_lo ? r : c_hi + 1 + r - c_lo, k = i % ROW8;
    *reinterpret_cast<uint4*>(band + (br * (S::F + 2) + 1 + k / (S::C_OUT / 8)) * S::PPD +
                              16 * (k % (S::C_OUT / 8))) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < t.g_rows * S::F_OUT * CH8; i += THREADS) {
    const int k8 = i % CH8, pp = i / CH8, lr = pp / S::F_OUT, fp = pp % S::F_OUT;
    const int off = pp * S::HALF + 8 * k8;
    const float4* gp = reinterpret_cast<const float4*>(gst + off);
    const float4 g0 = gp[0], g1 = gp[1];
    const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const uint2 mw = *reinterpret_cast<const uint2*>(mst + off);
    uint32_t bytes[8];
    float gq[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      bytes[e] = ((e < 4 ? mw.x : mw.y) >> (8 * (e & 3))) & 0xffu;
      const int cnt = __popc(bytes[e]);
      gq[e] = gv[e];
      if (cnt > 1) gq[e] = __fdiv_rn(gv[e], (float)cnt);
    }
#pragma unroll
    for (int pt = 0; pt < 2; ++pt) {
      const int br = 2 * (t.g_lo + lr) + pt - t.d_lo;
      if (br < 0 || br >= S::DY_ROWS) continue;
#pragma unroll
      for (int pf = 0; pf < 2; ++pf) {
        unsigned char* px = band + (br * (S::F + 2) + 2 * fp + pf + 1) * S::PPD + 16 * k8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int bit = 4 * pt + 2 * pf + h;
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = (bytes[e] >> bit) & 1u ? gq[e] : 0.f;
          *reinterpret_cast<uint4*>(px + h * S::HALF * 2) =
              make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                         pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
        }
      }
    }
  }
}

template <class S>
__global__ void __launch_bounds__(THREADS, 1)
    trunk_dx_kernel(const float* __restrict__ g, const unsigned char* __restrict__ mask,
                    const uint4* __restrict__ wpk, float* __restrict__ dx, int tiles) {
  constexpr int N = S::C2, KC = S::KCD;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* wsm = align_smem(smem_raw);
  float* gst = reinterpret_cast<float*>(wsm + S::W_DX_BYTES);
  unsigned char* mst = wsm + S::W_DX_BYTES + S::G_BYTES;
  unsigned char* band = mst + S::M_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(band + S::DY_BYTES);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q = lane & 3;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  load_weights(wsm, wpk, S::W_DX_BYTES);
  for (int i = tid; i < S::DY_ROWS * 2 * (S::C_OUT / 8); i += THREADS) {  // the halo columns
    const int k = i % (S::C_OUT / 8), c = (i / (S::C_OUT / 8)) % 2, br = i / (S::C_OUT / 4);
    *reinterpret_cast<uint4*>(band + (br * (S::F + 2) + c * (S::F + 1)) * S::PPD + 16 * k) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  if (tid == 0 && (int)blockIdx.x < tiles) dx_stage<S>(g, mask, gst, mst, bar, blockIdx.x);

  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, phase ^= 1u) {
    const DxTile t = dx_tile<S>(tile);
    mbar_wait(bar, phase);
    dy_band<S>(gst, mst, band, t);
    __syncthreads();
    if (tid == 0 && tile + (int)gridDim.x < tiles)
      dx_stage<S>(g, mask, gst, mst, bar, tile + gridDim.x);

    // sub-tile by sub-tile: dx pixels sub0 + [0, 128), 64 per warpgroup
#pragma unroll 1
    for (int sub0 = t.p0; sub0 < t.p0 + t.np; sub0 += DX_SUBTILE) {
      // this lane's ldmatrix row: dx pixel (tt, f) reads dy (tt + 1 - dt, f + 1 - df)
      const int pc = min(sub0 + 64 * wg + 16 * warp + (lane & 15), t.p0 + t.np - 1);
      const int tt = pc / S::F - t.t_lo, f = pc % S::F;
      const uint32_t base = smem_u32(band) + (tt * (S::F + 2) + f) * S::PPD + (lane >> 4) * 16;

      AccN<N> acc;
      uint32_t fr[2][KC][4];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dt = tap / 3, df = tap % 3;
        const uint32_t addr = base + ((2 - dt) * (S::F + 2) + 2 - df) * S::PPD;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) ldmatrix_x4(fr[tap & 1][kc], addr + 32 * kc);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
          wgmma_rs_n<N>(acc, fr[tap & 1][kc], b_desc<N>(wsm, tap * KC + kc), tap + kc > 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (tap > 0) {
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) fence_regs(fr[(tap - 1) & 1][kc]);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) fence_regs(fr[0][kc]);
      fence_acc(acc);

#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = sub0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * hh;
        if (p >= t.p0 + t.np) continue;
        float* o = dx + ((size_t)t.b * S::NPIX + p) * S::C2 + 2 * q;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc.d[4 * j + 2 * hh],
                                                              acc.d[4 * j + 2 * hh + 1]);
      }
    }
    __syncthreads();  // every read of the band is done
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// cudaFuncSetAttribute once per kernel and device in this process.
template <class K>
cudaError_t allow_smem(K kern, int bytes, int device, uint32_t& done) {
  if (device < 0 || device >= 32) return cudaErrorInvalidDevice;
  if (done & (1u << device)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= 1u << device;
  return err;
}

// plan: tile, tiles per sample, grid, band rows, staging bytes, smem bytes
// (ops/trunk.py:fwd_plan)
template <class S>
int launch_fwd(const void* am, const void* wpk, const void* bias, void* out, void* mask,
               int batch, const int* plan, int device, cudaStream_t s) {
  const int tiles = batch * S::FWD_TILES, grid = plan[2];
  if (plan[0] != S::FWD_TILE || plan[1] != S::FWD_TILES || grid < 1 || grid > tiles ||
      plan[3] != S::BAND_ROWS || plan[4] != S::STAGE_BYTES || plan[5] != S::FWD_SMEM)
    return (int)cudaErrorInvalidValue;
  static uint32_t done = 0;
  const cudaError_t err = allow_smem(trunk_fwd_kernel<S>, S::FWD_SMEM, device, done);
  if (err != cudaSuccess) return (int)err;
  trunk_fwd_kernel<S><<<grid, THREADS, S::FWD_SMEM, s>>>(
      (const float*)am, (const uint4*)wpk, (const float*)bias, (float*)out, (uint32_t*)mask,
      tiles);
  return (int)cudaGetLastError();
}

// plan: tile, tiles per sample, grid, dy rows, g rows, smem bytes
// (ops/trunk.py:bwd_plan)
template <class S>
int launch_bwd(const void* g, const void* mask, const void* wpk, void* dx, int batch,
               const int* plan, int device, cudaStream_t s) {
  const int tiles = batch * S::DX_TILES, grid = plan[2];
  if (plan[0] != S::DX_TILE || plan[1] != S::DX_TILES || grid < 1 || grid > tiles ||
      plan[3] != S::DY_ROWS || plan[4] != S::G_ROWS || plan[5] != S::DX_SMEM)
    return (int)cudaErrorInvalidValue;
  static uint32_t done = 0;
  const cudaError_t err = allow_smem(trunk_dx_kernel<S>, S::DX_SMEM, device, done);
  if (err != cudaSuccess) return (int)err;
  trunk_dx_kernel<S><<<grid, THREADS, S::DX_SMEM, s>>>(
      (const float*)g, (const unsigned char*)mask, (const uint4*)wpk, (float*)dx, tiles);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// segment: 0 = A (conv6 after conv3), 1 = B (conv13 after conv10). Forward:
// am (B, T, F, C2) f32, wpk the packed forward weights, bias (C_OUT) f32 ->
// out (B, T/2, F/2, HALF) f32 and, unless mask is null, the tie mask (B, T/2,
// F/2, HALF) uint8. Both launch on `stream` and return a cudaError_t as int
// (0 on success); 1 (cudaErrorInvalidValue) for an unknown segment, a plan
// that breaks the kernel's constants or a pointer that is not 16-byte aligned.
int trunk_fwd(const void* am, const void* wpk, const void* bias, void* out, void* mask,
              int batch, int segment, const int* plan, int device, void* stream) {
  if (!aligned16(am) || !aligned16(wpk) || !aligned16(out) || !aligned16(mask))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (segment == 0) return launch_fwd<SegA>(am, wpk, bias, out, mask, batch, plan, device, s);
  if (segment == 1) return launch_fwd<SegB>(am, wpk, bias, out, mask, batch, plan, device, s);
  return (int)cudaErrorInvalidValue;
}

// Backward: the cotangent g (B, T/2, F/2, HALF) f32 and the forward's mask,
// wpk the packed backward weights -> dx (B, T, F, C2) f32.
int trunk_bwd(const void* g, const void* mask, const void* wpk, void* dx, int batch,
              int segment, const int* plan, int device, void* stream) {
  if (!aligned16(g) || !aligned16(mask) || !aligned16(wpk) || !aligned16(dx))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (segment == 0) return launch_bwd<SegA>(g, mask, wpk, dx, batch, plan, device, s);
  if (segment == 1) return launch_bwd<SegB>(g, mask, wpk, dx, batch, plan, device, s);
  return (int)cudaErrorInvalidValue;
}

const char* trunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
