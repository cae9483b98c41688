// Fused cepstral frontend on Hopper (sm_90a): reflect pad -> hann-400
// windowed real FFT (n_fft 512, hop 160) -> power -> 257 -> 128 filterbank ->
// 10 log10(max(., 1e-10)) -> ortho DCT 128 -> 80, forward only, for
// 64,600-sample waves (404 frames). The filterbank is an input, so the same
// kernel computes LFCC (linear) and MFCC (HTK mel).
//
// Replaces the TPU kernel adaa_tpu/ops/pallas_lfcc.py (lfcc_pallas,
// mfcc_pallas -> _lfcc_tiles / _kernel). Python wrapper, the FFT's tables,
// plain-torch version and launch count: ops/lfcc_fused.py.
//
// Layouts: x (B, 64600) f32, read as it is: sample i < 0 of a frame reads
// x[-i] and i >= 64600 reads x[2 * 64599 - i] (the reflect pad by 256);
// tab f32, the FFT's tables (below); cs64 (2, 512) float64, cos and sin of
// 2 pi m / 512; filt (257, 128) f32; franges (128, 2)
// int32, each filter's non-zero bins [lo, hi); dct (128, 80) f32; out (B, 80,
// 404) f32.
//
// The FFT: frame f's windowed samples u[n] = win[n] x[160 f - 256 + n], n <
// 512 (win is zero outside the 400 taps at 56), are packed as z[m] = u[2 m] +
// i u[2 m + 1], m < 256, and Z = DFT256(z) runs in three passes, one warp per
// frame, 8 points a lane in registers, through shared memory between passes:
//   pass 1 (radix 8, lane n2 < 32): A[k1][n2] = W256^(n2 k1) DFT8_n1(z[32 n1 + n2]);
//   pass 2 (radix 8, lane (k1, m2) = (l / 4, l % 4)):
//     B[k1][m2][k2a] = W32^(m2 k2a) DFT8_m1(A[k1][4 m1 + m2]);
//   pass 3 (radix 4, lanes (k1, k2a) = (c % 8, c / 8), c = l, l + 32):
//     Z[k1 + 8 k2a + 64 k2b] = DFT4_m2(B[k1][m2][k2a]);
// then the real split, X[k] = (Z[k] + conj Z[256 - k]) / 2 + W512^k (Z[k] -
// conj Z[256 - k]) / 2i for k <= 256 (Z[256] = Z[0]), and the power |X[k]|^2;
// a bin whose power is tiny against the frame's energy is recomputed as a
// float64 direct DFT (TINY_BIN below).
// The twiddles W256, W32 and W512 and the window are computed in float64 on
// the host and rounded to f32 (tab: win[512], then W256^(n2 k1) at 32 k1 + n2,
// W32^(m2 k2a) at 4 k2a + m2, W512^k at k, each as all real parts then all
// imaginary parts). The exchange buffers are padded so that no pass has bank
// conflicts (strides 36 and 33).
//
// Numerics: f32 on the CUDA cores, as the TPU kernel's f32 Precision.HIGHEST
// dots, except the rare tiny bins, which are exact float64 direct DFTs. The
// FFT sums in another order than the plain version's DFT product (the same
// function); its rounding error grows as log2 of the length instead of with
// it. At a bin near a spectral zero, though, any two f32 computations of the
// power differ by a large fraction of it, and a one-bin mel filter carries
// that into the cepstra: those bins are computed exactly instead.
//
// What bounds it on an H100: at B = 256 it reads 66 MB of x and writes 33 MB
// of cepstra (0.030 ms at 3.35 TB/s) and does ~3.6 GFLOP of f32 work (the FFT
// ~13.8 k a frame with the window, split and power; the filterbank's non-zero
// weights; the DCT's 20.5 k), 0.054 ms at 67 TFLOP/s. The design keeps every
// intermediate on chip: a block takes one wave and 32 frames, stages their
// wave span (5,360 samples, reflected at the edges) in shared memory once,
// each warp transforms 4 frames into a 32 x 257 power tile in shared memory,
// the filterbank keeps its outputs in registers (16 per thread, sparse ranges
// of bins), and the DCT blocks 5 cepstra x 2 frames per thread. Only the 80
// x 32 cepstra are written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WAVE = 64600;
constexpr int N_FRAMES = 404;
constexpr int HOP = 160;
constexpr int WIN = 400;
constexpr int WIN_OFF = 56;  // (n_fft - win) / 2: the window's first tap
constexpr int PAD = 256;     // the reflect pad, n_fft / 2
constexpr int N_FILT = 128;
constexpr int N_CEP = 80;

constexpr int TF = 32;          // frames per block
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int SPAN = (TF - 1) * HOP + WIN;  // wave samples of one block
constexpr int PT_STRIDE = 260;  // power tile row: 257 bins, padded
constexpr int DB_STRIDE = N_FILT + 1;
constexpr int BANKED = TF * N_FILT / THREADS;  // filterbank outputs per thread
constexpr int A_STRIDE = 36;    // pass 1 -> 2 buffer: A[k1][n2] at 36 k1 + n2
constexpr int B_STRIDE = 33;    // pass 2 -> 3 buffer: B[k1][m2][k2a] at 33 k2a + 4 k1 + m2
constexpr int BUF1 = 8 * A_STRIDE;  // A, then Z (256) in natural order
constexpr int BUF2 = 8 * B_STRIDE;
constexpr int FFT_FLOATS = 2 * (BUF1 + BUF2);  // per warp: real and imaginary planes
constexpr float DB_SCALE = 4.342944819032518f;  // 10 / ln(10)
// A bin whose f32 power is below TINY_BIN x the frame's energy sum u^2 is
// recomputed as a float64 direct DFT: there the f32 FFT's absolute error, a
// few f32 ulps of the frame's norm, is no longer small against the bin, and a
// filter of one or two bins (the low mel filters) would carry it into the dB.
// Above it, a bin's power is within ~1.5e-4 of its own value (6.7e-4 dB).
// Rare: the deep zeros of a mirror-symmetric (reflected) edge frame, whose
// spectrum is real up to its phase, and ~3e-4 of the bins of a [0, 1] wave,
// whose DC term holds most of the energy.
constexpr float TINY_BIN = 0x1p-16f;
constexpr float SQRT1_2 = 0.70710678118654752f;
// tab offsets
constexpr int TAB_WIN = 0, TAB_W256 = 512, TAB_W32 = TAB_W256 + 2 * 256,
              TAB_W512 = TAB_W32 + 2 * 32, TAB_LEN = TAB_W512 + 2 * 256;
constexpr size_t SMEM_BYTES =
    sizeof(float) * (SPAN + WARPS * FFT_FLOATS + TF * PT_STRIDE);

static_assert(TF * DB_STRIDE <= SPAN, "the dB tile reuses the wave buffer");
static_assert(THREADS == 2 * N_FILT, "filterbank: 2 threads per filter");
static_assert(TF % WARPS == 0 && SPAN % 2 == 0, "frames per warp, float2 wave reads");

struct C2 {
  float re, im;
};
__device__ __forceinline__ C2 cadd(C2 a, C2 b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ C2 csub(C2 a, C2 b) { return {a.re - b.re, a.im - b.im}; }
__device__ __forceinline__ C2 cmul(C2 a, C2 b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
__device__ __forceinline__ C2 mul_mi(C2 a) { return {a.im, -a.re}; }  // -i a

// Y[k] = sum_n v[n] W4^(n k), in place, natural order
__device__ __forceinline__ void dft4(C2& a0, C2& a1, C2& a2, C2& a3) {
  const C2 t0 = cadd(a0, a2), t1 = csub(a0, a2), t2 = cadd(a1, a3), t3 = mul_mi(csub(a1, a3));
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, t3);
  a3 = csub(t1, t3);
}

// Y[k] = sum_n v[n] W8^(n k), in place, natural order: two DFT4s of the even
// and odd points, combined with W8^k
__device__ __forceinline__ void dft8(C2 (&v)[8]) {
  C2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  C2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  o1 = {SQRT1_2 * (o1.re + o1.im), SQRT1_2 * (o1.im - o1.re)};   // W8^1 = (1 - i) / sqrt 2
  o2 = mul_mi(o2);                                               // W8^2 = -i
  o3 = {SQRT1_2 * (o3.im - o3.re), -SQRT1_2 * (o3.re + o3.im)};  // W8^3 = -(1 + i) / sqrt 2
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

__device__ __forceinline__ C2 tw(const float* __restrict__ tab, int off, int n, int i) {
  return {__ldg(tab + off + i), __ldg(tab + off + n + i)};
}

// One frame: the windowed samples at ws (the frame's first window tap) ->
// its 257 powers in prow. buf1, buf2: the warp's exchange buffers; cs64:
// cos and sin of 2 pi m / 512 in float64 (the direct DFT of tiny bins).
__device__ __forceinline__ void frame_power(const float* ws, const float* __restrict__ tab,
                                            const double* __restrict__ cs64, float* buf1,
                                            float* buf2, float* prow, int lane) {
  float* re1 = buf1;
  float* im1 = buf1 + BUF1;
  float* re2 = buf2;
  float* im2 = buf2 + BUF2;
  C2 v[8];
  // pass 1: z[32 n1 + lane] = (u[64 n1 + 2 lane], u[64 n1 + 2 lane + 1])
#pragma unroll
  for (int n1 = 0; n1 < 8; ++n1) {
    const int n = 64 * n1 + 2 * lane;
    if (n >= WIN_OFF && n < WIN_OFF + WIN) {
      const float2 s = *reinterpret_cast<const float2*>(ws + n - WIN_OFF);
      v[n1] = {__ldg(tab + TAB_WIN + n) * s.x, __ldg(tab + TAB_WIN + n + 1) * s.y};
    } else {
      v[n1] = {0.f, 0.f};
    }
  }
  float energy = 0.f;  // sum of u^2 over the frame
#pragma unroll
  for (int n1 = 0; n1 < 8; ++n1)
    energy = fmaf(v[n1].re, v[n1].re, fmaf(v[n1].im, v[n1].im, energy));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) energy += __shfl_xor_sync(0xffffffffu, energy, o);
  dft8(v);
#pragma unroll
  for (int k1 = 0; k1 < 8; ++k1) {
    const C2 a = k1 == 0 ? v[0] : cmul(v[k1], tw(tab, TAB_W256, 256, 32 * k1 + lane));
    re1[A_STRIDE * k1 + lane] = a.re;
    im1[A_STRIDE * k1 + lane] = a.im;
  }
  __syncwarp();
  // pass 2: lane (k1, m2) = (lane / 4, lane % 4)
  {
    const int k1 = lane >> 2, m2 = lane & 3;
#pragma unroll
    for (int m1 = 0; m1 < 8; ++m1) {
      const int i = A_STRIDE * k1 + 4 * m1 + m2;
      v[m1] = {re1[i], im1[i]};
    }
    dft8(v);
#pragma unroll
    for (int k2a = 0; k2a < 8; ++k2a) {
      const C2 b = k2a == 0 ? v[0] : cmul(v[k2a], tw(tab, TAB_W32, 32, 4 * k2a + m2));
      re2[B_STRIDE * k2a + 4 * k1 + m2] = b.re;
      im2[B_STRIDE * k2a + 4 * k1 + m2] = b.im;
    }
  }
  __syncwarp();
  // pass 3: lanes (k1, k2a) = (c % 8, c / 8), c = lane, lane + 32; Z in
  // natural order into buf1 (A is no longer needed)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h, k1 = c & 7, k2a = c >> 3;
    const int i = B_STRIDE * k2a + 4 * k1;
    C2 a0 = {re2[i], im2[i]}, a1 = {re2[i + 1], im2[i + 1]};
    C2 a2 = {re2[i + 2], im2[i + 2]}, a3 = {re2[i + 3], im2[i + 3]};
    dft4(a0, a1, a2, a3);
    const int k = k1 + 8 * k2a;
    re1[k] = a0.re, im1[k] = a0.im;
    re1[k + 64] = a1.re, im1[k + 64] = a1.im;
    re1[k + 128] = a2.re, im1[k + 128] = a2.im;
    re1[k + 192] = a3.re, im1[k + 192] = a3.im;
  }
  __syncwarp();
  // the real split and the power: bins k = lane + 32 i, and 256
  const float tiny = TINY_BIN * energy;
  uint32_t flags = 0u;  // bit i: bin lane + 32 i is tiny
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = lane + 32 * i, km = (256 - k) & 255;
    const C2 zk = {re1[k], im1[k]}, zm = {re1[km], im1[km]};
    const C2 e = {0.5f * (zk.re + zm.re), 0.5f * (zk.im - zm.im)};
    const C2 o = {0.5f * (zk.im + zm.im), -0.5f * (zk.re - zm.re)};
    const C2 xk = cadd(e, cmul(o, tw(tab, TAB_W512, 256, k)));
    const float pk = xk.re * xk.re + xk.im * xk.im;
    prow[k] = pk;
    flags |= (uint32_t)(pk < tiny) << i;
  }
  if (lane == 0) {
    const float x256 = re1[0] - im1[0];
    prow[256] = x256 * x256;
    flags |= (uint32_t)(x256 * x256 < tiny) << 8;
  }
  __syncwarp();  // buf1 is read before the next frame's pass 1 writes it; prow is written
  if (!__any_sync(0xffffffffu, flags != 0u)) return;
  // tiny bins, the whole warp on one at a time: X[k] = sum_n u[n] exp(-2 pi i k n / 512)
  // in float64 (u[n] = win[n] x is exact there)
#pragma unroll 1
  for (int i = 0; i < 9; ++i) {
    uint32_t who = __ballot_sync(0xffffffffu, (flags >> i) & 1u);
    while (who != 0u) {
      const int k = i == 8 ? 256 : __ffs(who) - 1 + 32 * i;
      who &= who - 1u;
      double re = 0.0, im = 0.0;
      for (int n = WIN_OFF + lane; n < WIN_OFF + WIN; n += 32) {
        const double u = (double)__ldg(tab + TAB_WIN + n) * (double)ws[n - WIN_OFF];
        const int m = (k * n) & 511;
        re = fma(u, __ldg(cs64 + m), re);
        im = fma(-u, __ldg(cs64 + 512 + m), im);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        re += __shfl_xor_sync(0xffffffffu, re, o);
        im += __shfl_xor_sync(0xffffffffu, im, o);
      }
      if (lane == 0) prow[k] = (float)fma(re, re, im * im);
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS, 2)
    lfcc_kernel(const float* __restrict__ x, const float* __restrict__ tab,
                const double* __restrict__ cs64, const float* __restrict__ filt,
                const int* __restrict__ franges,
                const float* __restrict__ dct, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* ws = smem;                        // [SPAN] wave; later [TF][DB_STRIDE] dB
  float* fft = ws + SPAN;                  // [WARPS][FFT_FLOATS]
  float* pt = fft + WARPS * FFT_FLOATS;    // [TF][PT_STRIDE] powers

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, f0 = blockIdx.x * TF;
  const int n_valid = min(TF, N_FRAMES - f0);
  // sample s of the span is wave index i0 + s, reflected at both ends
  const float* xb = x + (size_t)b * WAVE;
  const int i0 = f0 * HOP - PAD + WIN_OFF;
  const int span_valid = (n_valid - 1) * HOP + WIN;
  // all of a thread's loads are issued before the first store waits on one
  constexpr int PER_THREAD = (SPAN + THREADS - 1) / THREADS;
  float staged[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int s = tid + j * THREADS;
    int i = i0 + s;
    i = i < 0 ? -i : (i >= WAVE ? 2 * (WAVE - 1) - i : i);
    staged[j] = s < span_valid ? __ldg(xb + i) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    if (tid + j * THREADS < SPAN) ws[tid + j * THREADS] = staged[j];
  }
  __syncthreads();

  float* buf1 = fft + warp * FFT_FLOATS;
  float* buf2 = buf1 + 2 * BUF1;
  for (int fl = warp; fl < TF; fl += WARPS)
    frame_power(ws + fl * HOP, tab, cs64, buf1, buf2, pt + fl * PT_STRIDE, lane);
  __syncthreads();

  // filterbank: thread (filter m, frames fb0, fb0 + 2, ...), outputs in registers
  const int m = tid & (N_FILT - 1), fb0 = tid / N_FILT;
  const int lo = __ldg(franges + 2 * m), hi = __ldg(franges + 2 * m + 1);
  float banked[BANKED];
#pragma unroll
  for (int i = 0; i < BANKED; ++i) banked[i] = 0.f;
  for (int k = lo; k < hi; ++k) {
    const float w = __ldg(filt + k * N_FILT + m);
#pragma unroll
    for (int i = 0; i < BANKED; ++i)
      banked[i] = fmaf(pt[(fb0 + 2 * i) * PT_STRIDE + k], w, banked[i]);
  }
  float* dbs = ws;  // every read of the wave is done (the __syncthreads above)
#pragma unroll
  for (int i = 0; i < BANKED; ++i)
    dbs[(fb0 + 2 * i) * DB_STRIDE + m] = DB_SCALE * logf(fmaxf(banked[i], 1e-10f));
  __syncthreads();

  // DCT: thread (cepstra 5 cg .. 5 cg + 4, frames fg and fg + 16)
  const int cg = tid >> 4, fg = tid & 15;
  float acc[5][2];
#pragma unroll
  for (int c = 0; c < 5; ++c) acc[c][0] = acc[c][1] = 0.f;
  const float* d0 = dbs + fg * DB_STRIDE;
  const float* d1 = dbs + (fg + 16) * DB_STRIDE;
#pragma unroll 4
  for (int k = 0; k < N_FILT; ++k) {
    const float a = d0[k], bb = d1[k];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float w = __ldg(dct + k * N_CEP + 5 * cg + c);
      acc[c][0] = fmaf(a, w, acc[c][0]);
      acc[c][1] = fmaf(bb, w, acc[c][1]);
    }
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    float* o = out + ((size_t)b * N_CEP + 5 * cg + c) * N_FRAMES + f0;
    if (fg < n_valid) o[fg] = acc[c][0];
    if (fg + 16 < n_valid) o[fg + 16] = acc[c][1];
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t as int (0 on success); 1
// (cudaErrorInvalidValue) when the table's length is not the kernel's.
int lfcc_fwd(const void* x, const void* tab, int tab_len, const void* cs64,
             const void* filt, const void* franges, const void* dct, void* out, int batch,
             int device, void* stream) {
  if (tab_len != TAB_LEN) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static uint32_t done = 0;  // cudaFuncSetAttribute once per device in this process
  if (device < 0 || device >= 32) return (int)cudaErrorInvalidDevice;
  if (!(done & (1u << device))) {
    err = cudaFuncSetAttribute(lfcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    done |= 1u << device;
  }
  const dim3 grid((N_FRAMES + TF - 1) / TF, batch);
  lfcc_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)tab, (const double*)cs64, (const float*)filt,
      (const int*)franges,
      (const float*)dct, (float*)out);
  return (int)cudaGetLastError();
}

const char* lfcc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
