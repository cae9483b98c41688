// LCNN's first block on Hopper (sm_90a): conv 5x5 (1 -> 64, pad 2) + MFM
// (64 -> 32) + 2x2 max pool, forward with winner index and dx backward.
//
// Replaces the TPU kernel adaa_tpu/ops/pallas_layer0.py
// (fused_conv0_mfm_pool: _fwd_kernel, _fwd_mask_kernel, _bwd_kernel).
// Python wrapper, plain-torch twin and launch counts: ops/layer0.py.
//
// Layouts (as the JAX op): x (B, 404, 80) bf16 or f32; w (64, 1, 5, 5) f32
// (OIHW, so w[c * 25 + dt * 5 + df]); bias (64) f32; out (B, 202, 40, 32) in
// x's dtype, channels last; idx (B, 202, 40, 32) uint8.
//
// Numerics: x and w are rounded to bf16, products accumulate in f32 and the
// f32 bias is added after the sum. A pooled output's 8 candidates are numbered
// c = 4 * t_parity + 2 * f_parity + mfm_half (the JAX kernel's numbering);
// the winner index is the lowest c on exact ties. The backward rounds the
// cotangent to bf16, sends it whole to the winner, and accumulates dx in f32.
//
// What bounds it on an H100: at B = 256 the forward reads 16.5 MB and writes
// 132 MB of bf16 output plus 66 MB of index; the backward reads those back and
// writes dx. That is ~0.2 GB, 0.07 ms at 3.35 TB/s. The arithmetic is 26 GFLOP
// per direction; on the CUDA cores (67 TFLOP/s f32) that is ~0.4 ms, so this
// simple design is bound by instruction issue, not memory. It never
// materialises the (B, 404, 80, 64) conv output: each forward thread computes
// its 8 candidates from a 6x6 input patch held in registers (input tile staged
// in shared memory); each backward thread owns a 2x2 block of dx and, channel
// by channel, decodes the 3x3 pooled (bf16 cotangent, winner) words around it
// into the 6x6 conv-output cotangents of both MFM halves in registers, then
// gathers its 4 x 25 taps from them: no atomics, and per channel 9 loads of
// packed words plus 25 broadcast weight loads feed 200 FMAs. Moving the products onto the tensor cores (wgmma with TMA-fed
// tiles) is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T_IN = 404;
constexpr int F_IN = 80;
constexpr int C_OUT = 32;  // after MFM; the conv has 2 * C_OUT channels
constexpr int K = 5;
constexpr int PAD = 2;
constexpr int TAPS = K * K;
constexpr int T_OUT = T_IN / 2;
constexpr int F_OUT = F_IN / 2;

// forward: a block is one sample x FWD_TT pooled rows x all 40 pooled cols;
// lane = output channel, each warp walks the tile's positions
constexpr int FWD_TT = 2;
constexpr int FWD_WARPS = 8;
constexpr int FWD_ROWS = 2 * FWD_TT + K - 1;  // input rows incl. halo
constexpr int FWD_COLS = F_IN + K - 1;        // input cols incl. zero pad

// backward: a block is one sample x BWD_TR input rows (the last block is
// ragged) x all 80 input cols; a thread owns a 2x2 block of dx
constexpr int BWD_TR = 8;
constexpr int BWD_TILES = (T_IN + BWD_TR - 1) / BWD_TR;
constexpr int BWD_PR = BWD_TR / 2 + 2;  // pooled rows staged, with halo
constexpr int BWD_PF = F_OUT + 2;       // pooled cols staged, with halo
constexpr uint32_t NO_WINNER = 0xFFu;   // equals no candidate index 0..7

static_assert(T_OUT % FWD_TT == 0, "forward tiles must cover T_OUT");
static_assert(BWD_TR % 2 == 0 && T_IN % 2 == 0, "2x2 dx blocks");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(FWD_WARPS * 32)
    layer0_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ out,
                      uint8_t* __restrict__ idx) {
  __shared__ float xs[FWD_ROWS][FWD_COLS];
  const int b = blockIdx.y;
  const int tp0 = blockIdx.x * FWD_TT;  // first pooled row of the tile
  const int t_base = 2 * tp0 - PAD;     // input row held in xs[0]
  const T* xb = x + (size_t)b * T_IN * F_IN;
  for (int i = threadIdx.x; i < FWD_ROWS * FWD_COLS; i += blockDim.x) {
    const int r = i / FWD_COLS, c = i % FWD_COLS;
    const int t = t_base + r, f = c - PAD;
    float v = 0.f;
    if (t >= 0 && t < T_IN && f >= 0 && f < F_IN) {
      v = round_bf16(load_f(xb + t * F_IN + f));
    }
    xs[r][c] = v;
  }

  const int ch = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float w0[TAPS], w1[TAPS];  // this lane's two conv channels (MFM halves)
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    w0[k] = round_bf16(w[ch * TAPS + k]);
    w1[k] = round_bf16(w[(ch + C_OUT) * TAPS + k]);
  }
  const float b0 = bias[ch], b1 = bias[ch + C_OUT];
  __syncthreads();

  for (int pos = warp; pos < FWD_TT * F_OUT; pos += FWD_WARPS) {
    const int tl = pos / F_OUT, fp = pos % F_OUT;
    float patch[K + 1][K + 1];  // input rows 2t'-2.., cols 2f'-2.., broadcast
#pragma unroll
    for (int r = 0; r < K + 1; ++r) {
#pragma unroll
      for (int c = 0; c < K + 1; ++c) patch[r][c] = xs[2 * tl + r][2 * fp + c];
    }
    float best = 0.f;
    int winner = 0;
#pragma unroll
    for (int cand = 0; cand < 8; ++cand) {
      const int pt = cand >> 2, pf = (cand >> 1) & 1, half = cand & 1;
      float acc = 0.f;
#pragma unroll
      for (int dt = 0; dt < K; ++dt) {
#pragma unroll
        for (int df = 0; df < K; ++df) {
          const float wk = half ? w1[dt * K + df] : w0[dt * K + df];
          acc = fmaf(patch[pt + dt][pf + df], wk, acc);
        }
      }
      acc += half ? b1 : b0;
      if (cand == 0 || acc > best) {  // strict: lowest index wins ties
        best = acc;
        winner = cand;
      }
    }
    const size_t o = (((size_t)b * T_OUT + tp0 + tl) * F_OUT + fp) * C_OUT + ch;
    store_f(out + o, best);
    if (idx != nullptr) idx[o] = (uint8_t)winner;
  }
}

template <typename T>
__global__ void __launch_bounds__(F_OUT * BWD_TR / 2)
    layer0_bwd_kernel(const uint8_t* __restrict__ idx, const T* __restrict__ g,
                      const float* __restrict__ w, T* __restrict__ dx) {
  // word = bf16(g) << 16 | winner; NO_WINNER outside the pooled grid
  __shared__ uint32_t gs[BWD_PR][C_OUT][BWD_PF];
  __shared__ float2 ws[C_OUT][TAPS];  // bf16-rounded (channel, channel + 32)
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BWD_TR;
  const int p_base = t0 / 2 - 1;  // pooled row held in gs[0]
  const int tid = threadIdx.y * F_OUT + threadIdx.x;
  const int nthreads = F_OUT * BWD_TR / 2;

  for (int i = tid; i < TAPS * C_OUT; i += nthreads) {
    const int ch = i / TAPS, k = i % TAPS;
    ws[ch][k] = make_float2(round_bf16(w[ch * TAPS + k]),
                            round_bf16(w[(ch + C_OUT) * TAPS + k]));
  }
  const size_t gb = (size_t)b * T_OUT * F_OUT * C_OUT;
  for (int i = tid; i < BWD_PR * BWD_PF * C_OUT; i += nthreads) {
    const int ch = i % C_OUT;
    const int pf = (i / C_OUT) % BWD_PF;
    const int pr = i / (C_OUT * BWD_PF);
    const int tp = p_base + pr, fp = pf - 1;
    uint32_t v = NO_WINNER;
    if (tp >= 0 && tp < T_OUT && fp >= 0 && fp < F_OUT) {
      const size_t o = gb + ((size_t)tp * F_OUT + fp) * C_OUT + ch;
      const __nv_bfloat16 gq = __float2bfloat16_rn(load_f(g + o));
      v = ((uint32_t)__bfloat16_as_ushort(gq) << 16) | (uint32_t)idx[o];
    }
    gs[pr][ch][pf] = v;
  }
  __syncthreads();

  // This thread's dx block: rows t, t+1 and cols f, f+1 (t, f even). The
  // conv outputs that reach it are rows t-2..t+3 and cols f-2..f+3 (offsets
  // ro, co in 0..5), i.e. pooled rows/cols ty..ty+2 and tx..tx+2 of the
  // staged tile; offset parity (ro & 1, co & 1) is the output's parity.
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = t0 + 2 * ty, f = 2 * tx;
  float acc[2][2][2] = {};  // [row][col][mfm half]: independent FMA chains
  for (int ch = 0; ch < C_OUT; ++ch) {
    float g0[6][6], g1[6][6];  // conv-output cotangents of channels ch, ch + 32
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const uint32_t v = gs[ty + r][ch][tx + c];
        const float gv = __uint_as_float(v & 0xFFFF0000u);
        const uint32_t winner = v & 0xFFu;
#pragma unroll
        for (int pt = 0; pt < 2; ++pt) {
#pragma unroll
          for (int pf = 0; pf < 2; ++pf) {
            const uint32_t cand = 4 * pt + 2 * pf;  // + mfm half
            g0[2 * r + pt][2 * c + pf] = winner == cand ? gv : 0.f;
            g1[2 * r + pt][2 * c + pf] = winner == cand + 1 ? gv : 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int dt = 0; dt < K; ++dt) {
#pragma unroll
      for (int df = 0; df < K; ++df) {
        const float2 wk = ws[ch][dt * K + df];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            // input (t + a, f + c) <- output offset (a + 4 - dt, c + 4 - df)
            const int ro = a + 4 - dt, co = c + 4 - df;
            acc[a][c][0] = fmaf(g0[ro][co], wk.x, acc[a][c][0]);
            acc[a][c][1] = fmaf(g1[ro][co], wk.y, acc[a][c][1]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (t + a >= T_IN) continue;  // ragged last tile
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      store_f(dx + ((size_t)b * T_IN + t + a) * F_IN + f + c,
              acc[a][c][0] + acc[a][c][1]);
    }
  }
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` and return cudaGetLastError() as int
// (0 on success). idx may be null in the forward (no gradient wanted).
int layer0_fwd(const void* x, const void* w, const void* bias, void* out,
               void* idx, int batch, int x_is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(T_OUT / FWD_TT, batch);
  cudaStream_t s = (cudaStream_t)stream;
  if (x_is_bf16) {
    layer0_fwd_kernel<__nv_bfloat16><<<grid, FWD_WARPS * 32, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)w, (const float*)bias,
        (__nv_bfloat16*)out, (uint8_t*)idx);
  } else {
    layer0_fwd_kernel<float><<<grid, FWD_WARPS * 32, 0, s>>>(
        (const float*)x, (const float*)w, (const float*)bias, (float*)out,
        (uint8_t*)idx);
  }
  return (int)cudaGetLastError();
}

int layer0_bwd(const void* idx, const void* g, const void* w, void* dx,
               int batch, int x_is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BWD_TILES, batch);
  const dim3 block(F_OUT, BWD_TR / 2);
  cudaStream_t s = (cudaStream_t)stream;
  if (x_is_bf16) {
    layer0_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const uint8_t*)idx, (const __nv_bfloat16*)g, (const float*)w,
        (__nv_bfloat16*)dx);
  } else {
    layer0_bwd_kernel<float><<<grid, block, 0, s>>>(
        (const uint8_t*)idx, (const float*)g, (const float*)w, (float*)dx);
  }
  return (int)cudaGetLastError();
}

const char* layer0_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
