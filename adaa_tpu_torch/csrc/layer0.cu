// LCNN's first block on Hopper (sm_90a): conv 5x5 (1 -> 64, pad 2) + MFM
// (64 -> 32) + 2x2 max pool, forward with winner index and dx backward.
//
// Replaces the TPU kernel adaa_tpu/ops/pallas_layer0.py
// (fused_conv0_mfm_pool: _fwd_kernel, _fwd_mask_kernel, _bwd_kernel).
// Python wrapper, plain-torch twin, the weight packings, the launch plans and
// launch counts: ops/layer0.py. PTX building blocks (bulk copies, mbarriers,
// wgmma): hopper.cuh.
//
// Layouts (as the JAX op): x (B, 404, 80) bf16 or f32; out (B, 202, 40, 32)
// in x's dtype, channels last; idx (B, 202, 40, 32) uint8; g like out; dx
// like x. The weights come packed by ops/layer0.py as the byte images of
// wgmma B operands in shared memory (K-major, 128-byte swizzled rows of 64 k):
//   forward  wf[n][k]: k = tap = 5 dt + df (25, padded with zeros to 32; the
//            row's k 32..63 are zero and never read), column n = 8 j + 2 q + e
//            holds conv channel 32 e + 8 q + j, so an MFM pair sits in
//            adjacent accumulator columns and a thread's 8 pooled channels
//            8 q .. 8 q + 7 are contiguous;
//   backward wd[n][k]: n = 6 a + b (36, padded to 48) is the offset (a, b) in
//            a pooled pixel's 6 x 6 block of dx (its conv outputs' 5 x 5
//            windows together); k = 16 kk + 8 hh + 2 q + e, kk = 4 pp + kc,
//            is conv output pp = 2 pt + pf of the pooled pixel and conv
//            channel 32 e + 8 q + 2 kc + hh; the value is that channel's tap
//            (a - pt, b - pf), zero outside the 5 x 5 kernel.
//
// Numerics (as the JAX op): x and the weights are rounded to bf16, the exact
// products are summed in f32 (wgmma) and the f32 bias is added after the sum.
// A pooled output's 8 candidates are numbered c = 4 t_parity + 2 f_parity +
// mfm_half; they are compared in increasing c with a strict >, so the winner
// index is the lowest c on exact ties. An output within FIXUP_TOL of zero
// (below) is recomputed in the plain version's order. The backward rounds the
// cotangent to bf16, sends it whole to the winner, and sums dx in f32.
//
// What bounds it on an H100: at B = 256 the forward reads 16.5 MB of x and
// writes 132 MB of bf16 output plus 66 MB of index; the backward reads those
// back and writes dx: ~0.2 GB each way, 0.064 ms at 3.35 TB/s. The products
// (26.5 GFLOP forward with K padded to 32) are 0.034 ms on the tensor cores.
// The design keeps them off the critical path:
//   forward: an implicit GEMM, M = the conv outputs, N = 64, K = 32 (two k16
//     steps), on wgmma m64n64k16 with A from registers. Persistent blocks of
//     two warpgroups keep the packed weights (8 KB) in shared memory. A tile
//     is 256 consecutive pooled pixels of one sample; one thread bulk-copies
//     the input rows of the next two tiles (contiguous in memory) into two
//     staging buffers while the block computes; the block converts a tile's
//     rows into a band of quads: entry (r, c) holds rows r, r + 1 x columns
//     c, c + 1 in bf16, zero outside the image, so one 8-byte load gives a
//     tap for both conv rows and both conv columns of a pooled pixel (x has
//     one channel, so no ldmatrix: each thread gathers its fragment's 8 taps
//     itself, from a tap table made once). A warpgroup product covers 32
//     pooled pixels: rows r and r + 8 of a warp's accumulator are the two
//     columns of one pooled pixel, and the two conv rows go into two
//     accumulators, so MFM, pool and the winner are in-thread. Stores: 16
//     bytes of bf16 out (8 channels) and 8 bytes of index per thread.
//   backward: for each pooled pixel, its 6 x 6 block of dx, D = dy W, as
//     wgmma m64n48k16 (M = 64 pooled pixels per warpgroup, K = 4 conv outputs
//     x 64 channels, N = the 36 offsets), then dx(t, f) = the sum of the 9
//     blocks that cover it. A tile is 8 dx rows x one half of the columns
//     (40), which the blocks of 6 x 21 pooled pixels cover: one product per
//     warpgroup. Each thread loads its two pooled pixels' 8 channels of g (16
//     bytes bf16) and winner index (8 bytes), the next tile's while this one
//     computes, and forms the A fragment in registers: dy(p, c) is g where
//     the winner is p's candidate, else 0, so no dy goes to device memory.
//     D goes to shared memory in f32 (126 x 36), and each thread sums a dx
//     pixel's 9 terms from there: no atomics, and the result is deterministic.
// Nothing goes to cuBLAS or cuDNN.

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Layout constants shared with ops/layer0.py (which plans the launches).
constexpr int T_IN = 404, F_IN = 80;
constexpr int T_OUT = T_IN / 2, F_OUT = F_IN / 2, NP = T_OUT * F_OUT;
constexpr int C_OUT = 32;  // after MFM; the conv has 2 C_OUT channels
constexpr int TAPS = 25;   // 5 x 5, pad 2
constexpr int THREADS = 256;  // two warpgroups
constexpr int SMEM_ALIGN = 1024, SMEM_LIMIT = 232448;
constexpr int BARRIER_BYTES = 16;
// forward
constexpr int FWD_TILE = 256;    // pooled pixels per tile
constexpr int FWD_SUBTILE = 32;  // pooled pixels per warpgroup product
constexpr int FWD_TILES = cdiv(NP, FWD_TILE);  // per sample
constexpr int SPAN = (F_OUT - 1 + FWD_TILE - 1) / F_OUT + 1;  // pooled rows of a tile
constexpr int BAND_ROWS = 2 * SPAN + 4;  // input rows: conv rows and the 2-row halo
constexpr int BAND_PAD = 8;  // zero columns on each side: the interior starts on a chunk of 8
constexpr int BAND_PITCH = F_IN + 2 * BAND_PAD;  // columns of the band
constexpr int BAND_BYTES = BAND_ROWS * BAND_PITCH * 8;  // a quad of 4 bf16 per (row, column)
constexpr int STAGE_BYTES = BAND_ROWS * F_IN * 4;  // f32 rows at most
constexpr int STAGES = 2;  // staging buffers: the next two tiles' rows are in flight
constexpr int W_FWD_BYTES = 64 * 128;
constexpr int W_TAB_BYTES = 2 * C_OUT * TAPS * 4;  // the bf16-rounded weights as f32, OIHW
constexpr int SCALE_BYTES = FWD_TILE * 4 + 64 * 4;  // a tile's pixel scales, the 6x6 weights
constexpr int FWD_SMEM = W_FWD_BYTES + STAGES * STAGE_BYTES + BAND_BYTES + W_TAB_BYTES +
                         SCALE_BYTES + STAGES * BARRIER_BYTES + SMEM_ALIGN;
// An output whose magnitude is at most FIXUP_TOL x (S + max |bias|) is
// recomputed as 25 sequential f32 FMAs over the taps in order, + bias (the
// plain version's order). S, per pooled pixel, is sum over its 6 x 6 input
// patch of |x| M, M at each patch offset the largest |w| any of its four conv
// outputs puts there: S bounds sum |x w| of every candidate. The tensor-core
// sum's error is a few f32 ulps of that (measured <= 1.1e-7 of the tighter
// per-output scale on an H100), so below FIXUP_TOL x S it could land more
// than a bf16 ulp from the plain value. Only the candidates within that of
// the max are recomputed: the others cannot win.
constexpr float FIXUP_TOL = 0x1p-12f;
// backward
constexpr int DX_ROWS = 8;          // dx rows per tile
constexpr int DX_COLS = F_IN / 2;   // dx columns per tile: one half
constexpr int DX_TILES = 2 * cdiv(T_IN, DX_ROWS);  // per sample
constexpr int DP_ROWS = DX_ROWS / 2 + 2;  // pooled rows whose 6x6 dx blocks reach a tile
constexpr int DP_COLS = DX_COLS / 2 + 1;  // pooled columns (the one outside the image dropped)
constexpr int DP = DP_ROWS * DP_COLS;     // one 64-row product per warpgroup
constexpr int D_N = 48;      // the 6 x 6 block's 36 dx offsets, padded to a wgmma width
constexpr int D_PITCH = 36;  // f32 per pooled pixel of the D tile in shared memory
constexpr int D_BYTES = DP * D_PITCH * 4;
constexpr int DX_K = 4 * 2 * C_OUT;  // (conv row, conv column, MFM half, channel) of a pooled pixel
constexpr int W_DX_BYTES = (DX_K / 64) * D_N * 128;
constexpr int DX_SMEM = W_DX_BYTES + D_BYTES + SMEM_ALIGN;

static_assert(FWD_TILE % (2 * FWD_SUBTILE) == 0 && DP <= 128, "two warpgroups");
static_assert(DX_ROWS % 2 == 0 && F_IN % 16 == 0 && (F_IN * 2) % 16 == 0, "shapes");
static_assert(FWD_SMEM <= SMEM_LIMIT && DX_SMEM <= SMEM_LIMIT, "shared memory");

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((SMEM_ALIGN - (a & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 consecutive values as 8 bf16 (rounded to nearest even).
__device__ __forceinline__ uint4 load8_bf16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8_bf16(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                    pack_bf16x2(b.z, b.w));
}

// 8 channels to out: 16 bytes of bf16, or 32 bytes of f32.
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                            pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// The packed weights into shared memory (once per block), made visible to
// wgmma's async proxy.
__device__ __forceinline__ void load_weights(unsigned char* wsm, const uint4* __restrict__ w,
                                             int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += THREADS)
    reinterpret_cast<uint4*>(wsm)[i] = __ldg(w + i);
  fence_proxy_async();
}

// k-step kk of a packed operand with N rows: box kk / 4, 32 bytes a k-step.
template <int N>
__device__ __forceinline__ uint64_t b_desc(const unsigned char* wsm, int kk) {
  return smem_desc(wsm + (kk >> 2) * N * 128 + 32 * (kk & 3));
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

struct FwdTile {
  int b, p0, np;   // sample, first pooled pixel, valid pixels
  int tp_lo;       // first pooled row
  int r0;          // input row of band row 0 (2 tp_lo - 2)
  int s_lo, s_hi;  // input rows [s_lo, s_hi) in the image, staged
};

__device__ __forceinline__ FwdTile fwd_tile(int tile) {
  FwdTile t;
  t.b = tile / FWD_TILES;
  t.p0 = (tile % FWD_TILES) * FWD_TILE;
  t.np = min(FWD_TILE, NP - t.p0);
  t.tp_lo = t.p0 / F_OUT;
  const int tp_hi = (t.p0 + t.np - 1) / F_OUT;
  t.r0 = 2 * t.tp_lo - 2;
  t.s_lo = max(t.r0, 0);
  t.s_hi = min(2 * tp_hi + 4, T_IN);
  return t;
}

template <typename T>
__device__ __forceinline__ void fwd_stage(const T* __restrict__ x, T* stage, uint64_t* bar,
                                          int tile) {
  const FwdTile t = fwd_tile(tile);
  const uint32_t bytes = (uint32_t)(t.s_hi - t.s_lo) * F_IN * sizeof(T);
  fence_proxy_async();
  mbar_expect_tx(bar, bytes);
  bulk_load(stage, x + ((size_t)t.b * T_IN + t.s_lo) * F_IN, bytes, bar);
}

// One bf16 of staged input row r at band column col (input column col -
// BAND_PAD), as the low half of a word; zero outside the image.
template <typename T>
__device__ __forceinline__ uint32_t band_elem(const T* stage, const FwdTile& t, int r, int col) {
  const int f = col - BAND_PAD;
  if (f < 0 || f >= F_IN || r < t.s_lo || r >= t.s_hi) return 0u;
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(
      static_cast<float>(stage[(r - t.s_lo) * F_IN + f])));
}

// 8 bf16 of staged input row r at band columns 8 c .. 8 c + 7; zero outside.
template <typename T>
__device__ __forceinline__ uint4 band_chunk(const T* stage, const FwdTile& t, int r, int c) {
  if (c < BAND_PAD / 8 || c >= (BAND_PAD + F_IN) / 8 || r < t.s_lo || r >= t.s_hi)
    return make_uint4(0u, 0u, 0u, 0u);
  return load8_bf16(stage + (r - t.s_lo) * F_IN + 8 * c - BAND_PAD);
}

// staging -> the band of quads: quad (br, c) holds, as two words, band rows
// br and br + 1 (input rows r0 + br ..) at band columns c and c + 1 (input
// columns c - BAND_PAD ..), the low half the left one: one 8-byte load gives
// a tap for both conv rows and both conv columns of a pooled pixel.
template <typename T>
__device__ __forceinline__ void fwd_band(const T* stage, uint4* band, const FwdTile& t) {
  constexpr int CH = BAND_PITCH / 8;
  for (int i = threadIdx.x; i < BAND_ROWS * CH; i += THREADS) {
    const int br = i / CH, c = i % CH, r = t.r0 + br;
    const uint4 u = band_chunk(stage, t, r, c), v = band_chunk(stage, t, r + 1, c);
    const uint32_t ua[5] = {u.x, u.y, u.z, u.w, band_elem(stage, t, r, 8 * c + 8)};
    const uint32_t va[5] = {v.x, v.y, v.z, v.w, band_elem(stage, t, r + 1, 8 * c + 8)};
    uint4* dst = band + (br * BAND_PITCH + 8 * c) / 2;
#pragma unroll
    for (int m = 0; m < 4; ++m)  // quads 2 m and 2 m + 1
      dst[m] = make_uint4(ua[m], va[m], __byte_perm(ua[m], ua[m + 1], 0x5432),
                          __byte_perm(va[m], va[m + 1], 0x5432));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    layer0_fwd_kernel(const T* __restrict__ x, const uint4* __restrict__ wpk,
                      const float* __restrict__ w, const float* __restrict__ bias,
                      T* __restrict__ out, uint8_t* __restrict__ idx, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[THREADS / 32];
  unsigned char* wsm = align_smem(smem_raw);
  T* stage = reinterpret_cast<T*>(wsm + W_FWD_BYTES);  // STAGES buffers
  uint4* band = reinterpret_cast<uint4*>(wsm + W_FWD_BYTES + STAGES * STAGE_BYTES);
  float* wtab = reinterpret_cast<float*>(band) + BAND_BYTES / 4;
  float* scale = wtab + 2 * C_OUT * TAPS;  // [FWD_TILE] per pooled pixel of the tile
  float* m6 = scale + FWD_TILE;            // [36] the 6x6 patch weights
  uint64_t* bar = reinterpret_cast<uint64_t*>(m6 + 64);  // [STAGES]
  const uint2* quads = reinterpret_cast<const uint2*>(band);
  const unsigned short* halves = reinterpret_cast<const unsigned short*>(band);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q = lane & 3;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bar + i, 1);
    fence_barrier_init();
  }
  load_weights(wsm, wpk, W_FWD_BYTES);
  // the fix-up's weight table, and max |bias|
  for (int i = tid; i < 2 * C_OUT * TAPS; i += THREADS)
    wtab[i] = __bfloat162float(__float2bfloat16_rn(__ldg(w + i)));
  float bmax = tid < 2 * C_OUT ? fabsf(__ldg(bias + tid)) : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, o));
  if (lane == 0) red[tid >> 5] = bmax;

  // this thread's A-fragment taps: register (kk, hh) holds k = 16 kk + 8 hh +
  // 2 q + e, e = 0, 1 (low, high half); off[4 kk + 2 hh + e] is the tap's quad
  // offset (taps 25..31 read offset 0 and are masked to zero)
  int off[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = 16 * (i >> 2) + 8 * ((i >> 1) & 1) + 2 * q + (i & 1);
    off[i] = k < TAPS ? (k / 5) * BAND_PITCH + k % 5 : 0;
  }
  const uint32_t pad_mask = q == 0 ? 0x0000FFFFu : 0u;  // k = 24 + 2 q + e < 25 only for q = e = 0
  __syncthreads();
  bmax = red[0];
#pragma unroll
  for (int i = 1; i < THREADS / 32; ++i) bmax = fmaxf(bmax, red[i]);
  if (tid < 36) {  // M(a, b) = max over the conv outputs (pt, pf) of max_c |w_c(a - pt, b - pf)|
    const int pa = tid / 6, pb = tid % 6;
    float mx = 0.f;
    for (int c = 0; c < 2 * C_OUT; ++c) {
      for (int pt = 0; pt < 2; ++pt) {
        for (int pf = 0; pf < 2; ++pf) {
          const int dt = pa - pt, df = pb - pf;
          if (dt >= 0 && dt < 5 && df >= 0 && df < 5)
            mx = fmaxf(mx, fabsf(wtab[c * TAPS + 5 * dt + df]));
        }
      }
    }
    m6[tid] = mx;
  }
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      if ((int)blockIdx.x + i * (int)gridDim.x < tiles)
        fwd_stage<T>(x, stage + i * (STAGE_BYTES / sizeof(T)), bar + i, blockIdx.x + i * gridDim.x);
    }
  }

  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const FwdTile t = fwd_tile(tile);
    const int sb = it % STAGES;
    T* st = stage + sb * (STAGE_BYTES / sizeof(T));
    mbar_wait(bar + sb, (uint32_t)(it / STAGES) & 1u);
    fwd_band<T>(st, band, t);
    __syncthreads();  // the band is complete and this staging buffer free
    if (tid == 0 && tile + STAGES * (int)gridDim.x < tiles)
      fwd_stage<T>(x, st, bar + sb, tile + STAGES * gridDim.x);
    // the fix-up's scale of each pooled pixel: sum over its 6 x 6 patch of |x| M
    for (int i = tid; i < t.np; i += THREADS) {
      const int pp = t.p0 + i;
      const int b0 = 2 * (pp / F_OUT - t.tp_lo) * BAND_PITCH + 2 * (pp % F_OUT) + BAND_PAD - 2;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const uint2 qv = quads[b0 + 2 * i * BAND_PITCH + 2 * j];
          const float* mr = m6 + 12 * i + 2 * j;
          sum = fmaf(fabsf(__uint_as_float(qv.x << 16)), mr[0], sum);
          sum = fmaf(fabsf(__uint_as_float(qv.x & 0xFFFF0000u)), mr[1], sum);
          sum = fmaf(fabsf(__uint_as_float(qv.y << 16)), mr[6], sum);
          sum = fmaf(fabsf(__uint_as_float(qv.y & 0xFFFF0000u)), mr[7], sum);
        }
      }
      scale[i] = sum;
    }
    __syncthreads();  // the scales are complete

#pragma unroll 1
    for (int sub0 = t.p0 + FWD_SUBTILE * wg; sub0 < t.p0 + t.np; sub0 += 2 * FWD_SUBTILE) {
      // this thread's pooled pixel: rows lane / 4 (column 2 fp) and lane / 4 + 8
      // (column 2 fp + 1) of its warp's 16 accumulator rows
      const int p = sub0 + 8 * warp + (lane >> 2);
      const int pc = min(p, t.p0 + t.np - 1);
      const int tp = pc / F_OUT - t.tp_lo, fp = pc % F_OUT;
      const int base = 2 * tp * BAND_PITCH + 2 * fp + BAND_PAD - 2;

      uint2 qd[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) qd[i] = quads[base + off[i]];
      uint32_t a[2][2][4];  // [pt][kk][fragment register 2 hh + pf]
#pragma unroll
      for (int pt = 0; pt < 2; ++pt) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * kk + 2 * hh;
            const uint32_t lo = pt ? qd[i].y : qd[i].x, hi = pt ? qd[i + 1].y : qd[i + 1].x;
#pragma unroll
            for (int pf = 0; pf < 2; ++pf) {
              uint32_t v = __byte_perm(lo, hi, pf ? 0x7632 : 0x5410);
              if (kk == 1 && hh == 1) v &= pad_mask;
              a[pt][kk][2 * hh + pf] = v;
            }
          }
        }
      }
      AccN<64> acc[2];
      wgmma_fence();
#pragma unroll
      for (int pt = 0; pt < 2; ++pt) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_rs_n<64>(acc[pt], a[pt][kk], b_desc<64>(wsm, kk), kk);
      }
      wgmma_commit();
      const float tol = FIXUP_TOL * (scale[pc - t.p0] + bmax);
      wgmma_wait<0>();
#pragma unroll
      for (int pt = 0; pt < 2; ++pt) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) fence_regs(a[pt][kk]);
        fence_acc(acc[pt]);
      }

      // candidate c = 4 pt + 2 pf + e is acc[pt].d[4 j + 2 pf + e] + bias
      float best[8];
      uint32_t win_lo = 0u, win_hi = 0u;
      uint64_t nears = 0u;  // byte j: output j's candidates to recompute, if any
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float b0 = __ldg(bias + 8 * q + j), b1 = __ldg(bias + C_OUT + 8 * q + j);
        float v = acc[0].d[4 * j] + b0;
        uint32_t win = 0u;
#pragma unroll
        for (int c = 1; c < 8; ++c) {
          const float y = acc[c >> 2].d[4 * j + (c & 3)] + ((c & 1) ? b1 : b0);
          if (y > v) {  // strict: the lowest index wins ties
            v = y;
            win = (uint32_t)c;
          }
        }
        if (fabsf(v) <= tol) {  // rare: the candidates within tol of the max
          uint32_t near = 0u;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float y = acc[c >> 2].d[4 * j + (c & 3)] + ((c & 1) ? b1 : b0);
            near |= (uint32_t)(y >= v - tol) << c;
          }
          nears |= (uint64_t)near << (8 * j);
        }
        best[j] = v;
        if (j < 4) {
          win_lo |= win << (8 * j);
        } else {
          win_hi |= win << (8 * (j - 4));
        }
      }
      if (p < t.p0 + t.np) {
        const size_t o = ((size_t)t.b * NP + p) * C_OUT + 8 * q;
        store8(out + o, best);
        if (idx != nullptr) *reinterpret_cast<uint2*>(idx + o) = make_uint2(win_lo, win_hi);
        // the fix-up, in the plain version's order, over the same outputs
#pragma unroll 1
        while (nears != 0u) {
          const int j = (__ffsll((long long)nears) - 1) >> 3;
          uint32_t near = (uint32_t)(nears >> (8 * j)) & 0xFFu;
          nears &= ~(0xFFull << (8 * j));
          float v = 0.f;
          uint32_t win = 0u;
          bool first = true;
          while (near != 0u) {
            const int c = __ffs(near) - 1;
            near &= near - 1u;
            const int ch = C_OUT * (c & 1) + 8 * q + j;
            const unsigned short* xp = halves + 4 * base + 2 * (c >> 2) + ((c >> 1) & 1);
            const float* wr = wtab + ch * TAPS;
            float y = 0.f;
#pragma unroll
            for (int dt = 0; dt < 5; ++dt) {
#pragma unroll
              for (int df = 0; df < 5; ++df)
                y = fmaf(__uint_as_float((uint32_t)xp[4 * (dt * BAND_PITCH + df)] << 16),
                         wr[5 * dt + df], y);
            }
            y += __ldg(bias + ch);
            if (first || y > v) {
              v = y;
              win = (uint32_t)c;
              first = false;
            }
          }
          store1(out + o + j, v);
          if (idx != nullptr) idx[o + j] = (uint8_t)win;
        }
      }
    }
    __syncthreads();  // every read of the band is done
  }
}

// ---------------------------------------------------------------------------
// Backward: dx
// ---------------------------------------------------------------------------

// g of 8 channels as bf16 pairs (rounded to nearest even)
__device__ __forceinline__ uint4 load_g8(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load_g8(const float* p) { return load8_bf16(p); }

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    layer0_dx_kernel(const uint8_t* __restrict__ idx, const T* __restrict__ g,
                     const uint4* __restrict__ wpk, T* __restrict__ dx, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* wsm = align_smem(smem_raw);
  float* ds = reinterpret_cast<float*>(wsm + W_DX_BYTES);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q = lane & 3;
  load_weights(wsm, wpk, W_DX_BYTES);
  __syncthreads();

  // this thread's accumulator rows h = 0, 1: pooled pixels p[h] of a tile,
  // and their 8 channels 8 q .. 8 q + 7 of (bf16 g, winner); zero outside the
  // image. The next tile's are loaded while this one computes.
  int p[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) p[h] = 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
  uint4 gnext[2];
  uint2 inext[2];
  auto load_rows = [&](int tile) {
    const int b = tile / DX_TILES, rt = (tile % DX_TILES) >> 1, half = tile & 1;
    const int pr0 = (DX_ROWS / 2) * rt - 1, pcb = half ? F_OUT / 2 - 1 : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pr = pr0 + p[h] / DP_COLS, pc = pcb + p[h] % DP_COLS;
      gnext[h] = make_uint4(0u, 0u, 0u, 0u);
      inext[h] = make_uint2(0u, 0u);
      if (tile < tiles && p[h] < DP && pr >= 0 && pr < T_OUT) {
        const size_t o = (((size_t)b * T_OUT + pr) * F_OUT + pc) * C_OUT + 8 * q;
        gnext[h] = load_g8(g + o);
        inext[h] = __ldg(reinterpret_cast<const uint2*>(idx + o));
      }
    }
  };
  load_rows(blockIdx.x);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / DX_TILES, rt = (tile % DX_TILES) >> 1, half = tile & 1;
    const int pcb = half ? F_OUT / 2 - 1 : 0;  // pooled column of D tile column 0
    uint32_t gv[2][4], wn[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      gv[h][0] = gnext[h].x, gv[h][1] = gnext[h].y, gv[h][2] = gnext[h].z, gv[h][3] = gnext[h].w;
      wn[h][0] = inext[h].x, wn[h][1] = inext[h].y;
    }
    load_rows(tile + gridDim.x);

    // D (64 pooled pixels x 48) = A (64 x 256) B (256 x 48): k-step kk = 4 pp
    // + kc holds conv output pp = 2 pt + pf; register 2 hh + h holds, for
    // row h, channel 8 q + 2 kc + hh's dy of MFM half 0 (low) and 1 (high):
    // g where the winner is candidate 2 pp + e, else 0. Per (row, channel):
    // the conv output the winner lies in, and g shifted into the winner's half
    uint32_t gsh[2][8], wpp[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int cl = 0; cl < 8; ++cl) {
        const uint32_t gbits = (gv[h][cl >> 1] >> (16 * (cl & 1))) & 0xFFFFu;
        const uint32_t win = (wn[h][cl >> 2] >> (8 * (cl & 3))) & 0xFFu;
        gsh[h][cl] = gbits << (16 * (win & 1u));
        wpp[h][cl] = win >> 1;
      }
    }
    AccN<D_N> acc;
    uint32_t a[2][4][4];
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cl = 2 * kc + hh;
            a[pp & 1][kc][2 * hh + h] = wpp[h][cl] == (uint32_t)pp ? gsh[h][cl] : 0u;
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs_n<D_N>(acc, a[pp & 1][kc], b_desc<D_N>(wsm, 4 * pp + kc), pp + kc > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous conv output's products are done with its fragments
      if (pp > 0) {
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) fence_regs(a[(pp - 1) & 1][kc]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) fence_regs(a[1][kc]);
    fence_acc(acc);

    // the D tile: pooled pixel p's 36 dx offsets 6 a + b (columns 8 j + 2 q + e)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (p[h] >= DP) continue;
      float* dp = ds + p[h] * D_PITCH + 2 * q;
#pragma unroll
      for (int j = 0; j < D_N / 8; ++j) {
        if (8 * j + 2 * q < D_PITCH)
          *reinterpret_cast<float2*>(dp + 8 * j) = make_float2(acc.d[4 * j + 2 * h],
                                                               acc.d[4 * j + 2 * h + 1]);
      }
    }
    __syncthreads();  // D is complete

    // dx(t, f) = sum over the pooled pixels (pr, pc), pr = t / 2 - 1 + u and
    // pc = f / 2 - 1 + v, of D(pr, pc) at offset (t - 2 pr + 2, f - 2 pc + 2)
    for (int i = tid; i < DX_ROWS * DX_COLS; i += THREADS) {
      const int r = i / DX_COLS, f = DX_COLS * half + i % DX_COLS;
      const int t = DX_ROWS * rt + r;
      if (t >= T_IN) continue;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int row = (r >> 1) + u, oa = (r & 1) + 4 - 2 * u;
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const int pc = (f >> 1) - 1 + v;
          if (pc < 0 || pc >= F_OUT) continue;
          sum += ds[(row * DP_COLS + pc - pcb) * D_PITCH + 6 * oa + (f & 1) + 4 - 2 * v];
        }
      }
      store1(dx + ((size_t)b * T_IN + t) * F_IN + f, sum);
    }
    __syncthreads();  // every read of D is done
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
// (ops/layer0.py:fwd_plan)
template <typename T>
int launch_fwd(const void* x, const void* wpk, const void* w, const void* bias, void* out,
               void* idx, int batch, const int* plan, int device, cudaStream_t s) {
  const int tiles = batch * FWD_TILES, grid = plan[2];
  if (plan[0] != FWD_TILE || plan[1] != FWD_TILES || grid < 1 || grid > tiles ||
      plan[3] != BAND_ROWS || plan[4] != STAGE_BYTES || plan[5] != FWD_SMEM)
    return (int)cudaErrorInvalidValue;
  static uint32_t done = 0;
  const cudaError_t err = allow_smem(layer0_fwd_kernel<T>, FWD_SMEM, device, done);
  if (err != cudaSuccess) return (int)err;
  layer0_fwd_kernel<T><<<grid, THREADS, FWD_SMEM, s>>>(
      (const T*)x, (const uint4*)wpk, (const float*)w, (const float*)bias, (T*)out,
      (uint8_t*)idx, tiles);
  return (int)cudaGetLastError();
}

// plan: dx rows per tile, tiles per sample, grid, D pooled rows, D pooled
// columns, smem bytes
// (ops/layer0.py:bwd_plan)
template <typename T>
int launch_bwd(const void* idx, const void* g, const void* wpk, void* dx, int batch,
               const int* plan, int device, cudaStream_t s) {
  const int tiles = batch * DX_TILES, grid = plan[2];
  if (plan[0] != DX_ROWS || plan[1] != DX_TILES || grid < 1 || grid > tiles ||
      plan[3] != DP_ROWS || plan[4] != DP_COLS || plan[5] != DX_SMEM)
    return (int)cudaErrorInvalidValue;
  static uint32_t done = 0;
  const cudaError_t err = allow_smem(layer0_dx_kernel<T>, DX_SMEM, device, done);
  if (err != cudaSuccess) return (int)err;
  layer0_dx_kernel<T><<<grid, THREADS, DX_SMEM, s>>>(
      (const uint8_t*)idx, (const T*)g, (const uint4*)wpk, (T*)dx, tiles);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Forward: x (B, 404, 80) bf16 (x_is_bf16) or f32, wpk the packed forward
// weights, w the weights OIHW (64, 1, 5, 5) f32 (the fix-up's), bias (64) f32
// -> out (B, 202, 40, 32) in x's dtype and, unless idx is null, the winner
// index (B, 202, 40, 32) uint8. Both entry points launch
// on `stream` and return a cudaError_t as int (0 on success); 1
// (cudaErrorInvalidValue) for a plan that breaks the kernel's constants or a
// pointer that is not 16-byte aligned.
int layer0_fwd(const void* x, const void* wpk, const void* w, const void* bias, void* out,
               void* idx, int batch, int x_is_bf16, const int* plan, int device,
               void* stream) {
  if (!aligned16(x) || !aligned16(wpk) || !aligned16(out) || !aligned16(idx))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_is_bf16) return launch_fwd<bf16>(x, wpk, w, bias, out, idx, batch, plan, device, s);
  return launch_fwd<float>(x, wpk, w, bias, out, idx, batch, plan, device, s);
}

// Backward: the forward's winner index and the cotangent g (B, 202, 40, 32),
// g in the dtype of dx (bf16 with is_bf16, else f32), wpk the packed backward
// weights -> dx (B, 404, 80).
int layer0_bwd(const void* idx, const void* g, const void* wpk, void* dx, int batch,
               int is_bf16, const int* plan, int device, void* stream) {
  if (!aligned16(idx) || !aligned16(g) || !aligned16(wpk) || !aligned16(dx))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return launch_bwd<bf16>(idx, g, wpk, dx, batch, plan, device, s);
  return launch_bwd<float>(idx, g, wpk, dx, batch, plan, device, s);
}

const char* layer0_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
