// Fused cepstral frontend on Hopper (sm_90a): hann-400 windowed DFT (n_fft
// 512, hop 160) -> power -> 257 -> 128 filterbank -> 10 log10(max(., 1e-10))
// -> ortho DCT 128 -> 80, forward only, for 64,600-sample waves (404 frames).
// The filterbank is an input, so the same kernel computes LFCC (linear) and
// MFCC (HTK mel).
//
// Replaces the TPU kernel adaa_tpu/ops/pallas_lfcc.py (lfcc_pallas,
// mfcc_pallas -> _lfcc_tiles / _kernel). Python wrapper, plain-torch version
// and launch count: ops/lfcc_fused.py.
//
// Layouts: xp (B, 65112) f32, the wave reflect-padded by 256 on each side (the
// wrapper pads); kt (400, 512) f32, the DFT matrix restricted to the window's
// 400 non-zero taps, its columns packed as below; nyq (400) f32, the real row
// of bin 256 (its imaginary row is sin(pi n) ~ 0); filt (257, 128) f32;
// franges (128, 2) int32, each filter's non-zero bins [lo, hi); dct (128, 80)
// f32; out (B, 80, 404) f32.
//
// Numerics: every product is f32 on the CUDA cores (the TPU kernel's dots are
// f32 Precision.HIGHEST); only the summation order differs from the plain
// version.
//
// What bounds it on an H100: at B = 256 it reads 67 MB and writes 33 MB (0.03 ms
// at 3.35 TB/s) but does ~51 GFLOP of f32 work, ~0.8 ms at the 67 TFLOP/s of
// the CUDA cores, so it is bound by f32 FMAs. The design keeps every
// intermediate on chip: a block takes one batch row and 64 frames, stages the
// frames' overlapping wave span (10,480 samples) in shared memory once, and
// streams the DFT matrix through shared memory in 40-row chunks. Each warp owns
// 8 frames and each lane 2 bins (re and im interleaved in kt's columns), so a
// lane's 32 accumulators turn into 16 powers in registers; a 64-bin tile of
// powers goes through shared memory into the filterbank, whose outputs (32 per
// thread) stay in registers across the 4 tiles and the Nyquist bin, and only
// the 80 x 64 cepstra are written. Per 32 FMAs a lane makes 8 broadcast loads
// of the wave and one float4 load of the matrix. The TPU kernel's four shifted
// hop-row copies and lane padding were for mosaic and are gone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_FRAMES = 404;
constexpr int HOP = 160;
constexpr int WIN = 400;
constexpr int WIN_OFF = 56;  // (n_fft - win) / 2: the window's first tap
constexpr int XP_LEN = 64600 + 512;
constexpr int N_FILT = 128;
constexpr int N_CEP = 80;
constexpr int NYQ_BIN = 256;

constexpr int TF = 64;          // frames per block
constexpr int THREADS = 256;    // 8 warps
constexpr int FPW = TF / (THREADS / 32);  // frames per warp: 8
constexpr int BIN_TILE = 64;    // bins per tile, 2 per lane
constexpr int COLS = 2 * BIN_TILE;        // (re, im) columns per tile
constexpr int N_TILES = 4;      // bins 0..255; bin 256 separately
constexpr int KT_COLS = N_TILES * COLS;   // 512
constexpr int KC = 40;          // DFT rows staged per chunk
constexpr int SPAN = (TF - 1) * HOP + WIN;  // wave samples of one tile
constexpr int PT_STRIDE = BIN_TILE + 1;
constexpr int DB_STRIDE = N_FILT + 1;
constexpr int BANKED = TF * N_FILT / THREADS;  // filterbank outputs per thread
constexpr float DB_SCALE = 4.342944819032518f;  // 10 / ln(10)
constexpr size_t SMEM_BYTES = sizeof(float) * (SPAN + KC * COLS + TF * PT_STRIDE);

static_assert(WIN % KC == 0, "chunks must cover the window");
static_assert(THREADS == 2 * N_FILT, "filterbank: 2 threads per filter");
static_assert(TF * DB_STRIDE <= SPAN, "the dB tile reuses the wave buffer");

// banked[i] (frame fb0 + 2 i, filter m) += sum over the filter's bins in
// [base, base + width) of pt[frame][bin - base] * filt[bin][m]
__device__ __forceinline__ void accumulate_filterbank(
    float (&banked)[BANKED], const float* pt, const float* __restrict__ filt,
    int m, int fb0, int lo, int hi, int base, int width) {
  const int k0 = max(lo, base), k1 = min(hi, base + width);
  for (int k = k0; k < k1; ++k) {
    const float w = __ldg(filt + k * N_FILT + m);
#pragma unroll
    for (int i = 0; i < BANKED; ++i) {
      banked[i] = fmaf(pt[(fb0 + 2 * i) * PT_STRIDE + k - base], w, banked[i]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    lfcc_kernel(const float* __restrict__ xp, const float* __restrict__ kt,
                const float* __restrict__ nyq, const float* __restrict__ filt,
                const int* __restrict__ franges, const float* __restrict__ dct,
                float* __restrict__ out) {
  extern __shared__ float smem[];
  float* ws = smem;              // [SPAN] wave; later [TF][DB_STRIDE] dB
  float* ks = ws + SPAN;         // [KC][COLS] chunk of the DFT matrix
  float* pt = ks + KC * COLS;    // [TF][PT_STRIDE] powers of one bin tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, f0 = blockIdx.x * TF;
  const int n_valid = min(TF, N_FRAMES - f0);
  const float* xb = xp + (size_t)b * XP_LEN + (size_t)f0 * HOP + WIN_OFF;
  const int span_valid = (n_valid - 1) * HOP + WIN;
  for (int i = tid; i < SPAN; i += THREADS) ws[i] = i < span_valid ? xb[i] : 0.f;

  const int m = tid & (N_FILT - 1);  // this thread's filter
  const int fb0 = tid / N_FILT;      // and frames fb0, fb0 + 2, ...
  const int lo = franges[2 * m], hi = franges[2 * m + 1];
  float banked[BANKED];
#pragma unroll
  for (int i = 0; i < BANKED; ++i) banked[i] = 0.f;

  const float* wf = ws + warp * FPW * HOP;  // this warp's first frame
  for (int j = 0; j < N_TILES; ++j) {
    // columns of lane l: re(2l), im(2l), re(2l + 1), im(2l + 1) of the tile
    float acc[FPW][4];
#pragma unroll
    for (int i = 0; i < FPW; ++i) {
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
    for (int n0 = 0; n0 < WIN; n0 += KC) {
      __syncthreads();  // ks free, and ws staged before the first chunk
      for (int i = tid; i < KC * COLS / 4; i += THREADS) {
        const int r = i / (COLS / 4), c4 = i % (COLS / 4);
        reinterpret_cast<float4*>(ks)[i] = __ldg(
            reinterpret_cast<const float4*>(kt + (size_t)(n0 + r) * KT_COLS + j * COLS) + c4);
      }
      __syncthreads();
#pragma unroll 4
      for (int n = 0; n < KC; ++n) {
        const float4 kv = reinterpret_cast<const float4*>(ks + n * COLS)[lane];
#pragma unroll
        for (int i = 0; i < FPW; ++i) {
          const float xv = wf[i * HOP + n0 + n];  // broadcast
          acc[i][0] = fmaf(xv, kv.x, acc[i][0]);
          acc[i][1] = fmaf(xv, kv.y, acc[i][1]);
          acc[i][2] = fmaf(xv, kv.z, acc[i][2]);
          acc[i][3] = fmaf(xv, kv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // the previous tile's filterbank has read pt
#pragma unroll
    for (int i = 0; i < FPW; ++i) {
      float* row = pt + (warp * FPW + i) * PT_STRIDE + 2 * lane;
      row[0] = acc[i][0] * acc[i][0] + acc[i][1] * acc[i][1];
      row[1] = acc[i][2] * acc[i][2] + acc[i][3] * acc[i][3];
    }
    __syncthreads();
    accumulate_filterbank(banked, pt, filt, m, fb0, lo, hi, j * BIN_TILE, BIN_TILE);
  }

  // the Nyquist bin: one dot product per frame, a warp per frame
  __syncthreads();
  for (int i = 0; i < FPW; ++i) {
    const float* xf = wf + i * HOP;
    float s = 0.f;
    for (int n = lane; n < WIN; n += 32) s = fmaf(xf[n], __ldg(nyq + n), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) pt[(warp * FPW + i) * PT_STRIDE] = s * s;
  }
  __syncthreads();
  accumulate_filterbank(banked, pt, filt, m, fb0, lo, hi, NYQ_BIN, 1);

  __syncthreads();  // the Nyquist pass has read ws
  float* dbs = ws;
#pragma unroll
  for (int i = 0; i < BANKED; ++i) {
    dbs[(fb0 + 2 * i) * DB_STRIDE + m] = DB_SCALE * logf(fmaxf(banked[i], 1e-10f));
  }
  __syncthreads();
  for (int idx = tid; idx < N_CEP * TF; idx += THREADS) {
    const int c = idx / TF, f = idx % TF;
    if (f >= n_valid) continue;
    const float* d = dbs + f * DB_STRIDE;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < N_FILT; ++k) s = fmaf(d[k], __ldg(dct + k * N_CEP + c), s);
    out[((size_t)b * N_CEP + c) * N_FRAMES + f0 + f] = s;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() as int (0 on success).
int lfcc_fwd(const void* xp, const void* kt, const void* nyq, const void* filt,
             const void* franges, const void* dct, void* out, int batch,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(lfcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N_FRAMES + TF - 1) / TF, batch);
  lfcc_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)xp, (const float*)kt, (const float*)nyq, (const float*)filt,
      (const int*)franges, (const float*)dct, (float*)out);
  return (int)cudaGetLastError();
}

const char* lfcc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
