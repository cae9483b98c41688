// LCNN mid-trunk segment on Hopper (sm_90a): conv 3x3 (SAME) + MFM + floor
// 2x2 max pool, forward and dx backward, for the two segments of
// ops/trunk.py (A: (B, 202, 40, 32) -> (B, 101, 20, 48), c_out 96;
// B: (B, 101, 20, 48) -> (B, 50, 10, 64), c_out 128).
//
// Replaces the TPU kernel adaa_tpu/ops/pallas_trunk.py (fused_segment ->
// _conv3_op: _fwd_kernel, _bwd_kernel). Python wrapper, plain-torch version
// and launch counts: ops/trunk.py.
//
// Layouts: am (B, T, F, C2) f32 channels last; wpk (C2, 9, 8, 2 CH) f32, the
// bf16-rounded OIHW weight packed so that channel group g's CH low and CH high
// MFM channels of one (input channel, tap) are 2 CH contiguous floats; bias
// (C_OUT) f32; out and g (B, T/2, F/2, HALF) f32; dy scratch (B, C_OUT, 2 T/2,
// 2 F/2) bf16; wtk (C_OUT, 3, 3, C2) f32 bf16-rounded; dx (B, T, F, C2) f32.
//
// Numerics (as the JAX op): am is rounded to bf16 where it is loaded, the
// exact bf16 products are summed in f32, the f32 bias is added, then the MFM
// max over channel halves and the 2x2 max over the floor-pooled window. The
// backward recomputes the 8 candidates (4 pool positions x 2 MFM halves) of
// each pooled output with the forward's own code, counts those equal to the
// max and sends bf16(g / max(cnt, 1)) to each of them (ties split evenly);
// dx is the transposed conv of that bf16 cotangent with the bf16 weights,
// summed in f32.
//
// What bounds it on an H100: at B = 256 the segment-A forward does 114 GFLOP
// and moves 0.36 GB (0.12 ms on the bf16 tensor cores, 0.11 ms of memory
// traffic); this first design runs the products on the CUDA cores in f32
// (57 G FMAs, >= 1.7 ms at 67 TFLOP/s), so it is bound by FMA issue. A block
// is one sample x 32 pooled pixels x all channels: each warp takes one of 8
// channel groups and each lane one pooled pixel, whose 4x4 input patch per
// input channel sits in registers and feeds 4 positions x 2 CH channels x 9
// taps; the weights are warp-uniform broadcast loads. The input rows of the
// tile (with halo and the SAME zero ring) are staged in shared memory once.
// The backward is two kernels on one stream: the recompute writes the bf16
// conv-output cotangent (the JAX kernel's dy) to a scratch buffer, and the dx
// kernel gathers each 2x2 block of dx from a 4x4 dy patch per output channel,
// so there are no atomics and the result is deterministic. None of the TPU
// kernel's parity planes, bordered planes, t'-chunks, halo rows or XLA halo
// merge carries over: they were for mosaic. Tensor-core products (mma/wgmma)
// and keeping dy on chip are the next steps for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps = 8 channel groups
constexpr int GROUPS = THREADS / 32;
constexpr int TILE = 32;      // pooled pixels (or 2x2 dx blocks) per block

template <int T_, int F_, int C2_, int COUT_>
struct Segment {
  static constexpr int T = T_, F = F_, C2 = C2_, C_OUT = COUT_;
  static constexpr int HALF = C_OUT / 2;
  static constexpr int T_OUT = T / 2, F_OUT = F / 2, NP = T_OUT * F_OUT;
  static constexpr int T2 = 2 * T_OUT, F2 = 2 * F_OUT;  // conv rows/cols pooled
  static constexpr int CH = HALF / GROUPS;  // MFM channels per group
  static constexpr int CI = C2 / GROUPS;    // dx channels per group
  static constexpr int NBT = (T + 1) / 2, NBF = F / 2, NB = NBT * NBF;  // dx blocks
  static constexpr int W = F + 2;  // staged columns, with the zero ring
  // staged rows: a tile spans at most this many pooled (or block) rows
  static constexpr int IN_ROWS = 2 * ((TILE + F_OUT - 2) / F_OUT + 1) + 2;
  static constexpr int DY_ROWS = 2 * ((TILE + NBF - 2) / NBF + 1) + 2;
  static constexpr size_t FWD_SMEM = sizeof(float) * C2 * IN_ROWS * W;
  static constexpr size_t DX_SMEM = sizeof(__nv_bfloat16) * C_OUT * DY_ROWS * W;
  static_assert(HALF % GROUPS == 0 && C2 % GROUPS == 0, "channel groups");
  static_assert((2 * CH) % 4 == 0 && CI % 2 == 0, "vector weight loads");
  static_assert(F % 2 == 0, "dx blocks cover F");
};
using SegA = Segment<202, 40, 32, 96>;
using SegB = Segment<101, 20, 48, 128>;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Stage am rows [row0, row0 + IN_ROWS) x cols [-1, F] of one sample as
// xs[ci][row][col], bf16-rounded, zero outside the image.
template <class S>
__device__ __forceinline__ void stage_input(float* xs, const float* __restrict__ am, int row0) {
  for (int i = threadIdx.x; i < S::IN_ROWS * S::W * S::C2; i += THREADS) {
    const int ci = i % S::C2, c = (i / S::C2) % S::W, r = i / (S::C2 * S::W);
    const int t = row0 + r, f = c - 1;
    float v = 0.f;
    if (t >= 0 && t < S::T && f >= 0 && f < S::F) v = round_bf16(am[(t * S::F + f) * S::C2 + ci]);
    xs[(ci * S::IN_ROWS + r) * S::W + c] = v;
  }
}

// The 8 candidates of one pooled pixel for channel group g, without bias:
// acc[2 pt + pf][h][c] is conv output (2 tp + pt, 2 fp + pf), channel
// h * HALF + g * CH + c. xs points at the patch's top-left staged cell.
template <class S>
__device__ __forceinline__ void conv_candidates(const float* xs, const float* __restrict__ wg,
                                                float (&acc)[4][2][S::CH]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < S::CH; ++c) acc[q][h][c] = 0.f;
    }
  }
  for (int ci = 0; ci < S::C2; ++ci) {
    const float* xc = xs + ci * S::IN_ROWS * S::W;
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = xc[i * S::W + j];
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dt = tap / 3, df = tap % 3;
      const float4* w4 = reinterpret_cast<const float4*>(
          wg + (size_t)(ci * 9 + tap) * GROUPS * 2 * S::CH);
      float wv[2 * S::CH];
#pragma unroll
      for (int k = 0; k < S::CH / 2; ++k) {
        const float4 v = __ldg(w4 + k);
        wv[4 * k] = v.x; wv[4 * k + 1] = v.y; wv[4 * k + 2] = v.z; wv[4 * k + 3] = v.w;
      }
#pragma unroll
      for (int pt = 0; pt < 2; ++pt) {
#pragma unroll
        for (int pf = 0; pf < 2; ++pf) {
          const float x = p[pt + dt][pf + df];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int c = 0; c < S::CH; ++c) {
              acc[2 * pt + pf][h][c] = fmaf(x, wv[h * S::CH + c], acc[2 * pt + pf][h][c]);
            }
          }
        }
      }
    }
  }
}

template <class S>
__global__ void __launch_bounds__(THREADS)
    trunk_fwd_kernel(const float* __restrict__ am, const float* __restrict__ wpk,
                     const float* __restrict__ bias, float* __restrict__ out) {
  extern __shared__ float xs[];
  const int b = blockIdx.y, p0 = blockIdx.x * TILE;
  const int r_lo = p0 / S::F_OUT;
  stage_input<S>(xs, am + (size_t)b * S::T * S::F * S::C2, 2 * r_lo - 1);
  __syncthreads();
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int p = min(p0 + lane, S::NP - 1);  // idle lanes recompute the last pixel
  const int tp = p / S::F_OUT, fp = p % S::F_OUT;
  float acc[4][2][S::CH];
  conv_candidates<S>(xs + 2 * (tp - r_lo) * S::W + 2 * fp, wpk + g * 2 * S::CH, acc);
  if (p0 + lane >= S::NP) return;
  float* o = out + ((size_t)b * S::NP + p) * S::HALF + g * S::CH;
#pragma unroll
  for (int c = 0; c < S::CH; ++c) {
    const float b0 = bias[g * S::CH + c], b1 = bias[S::HALF + g * S::CH + c];
    float best = fmaxf(acc[0][0][c] + b0, acc[0][1][c] + b1);
#pragma unroll
    for (int q = 1; q < 4; ++q) best = fmaxf(best, fmaxf(acc[q][0][c] + b0, acc[q][1][c] + b1));
    o[c] = best;
  }
}

// Backward, part 1: recompute the candidates and write the conv-output
// cotangent dy (B, C_OUT, T2, F2) bf16: bf16(g / cnt) where a candidate
// equals its pooled max, else 0.
template <class S>
__global__ void __launch_bounds__(THREADS)
    trunk_dy_kernel(const float* __restrict__ am, const float* __restrict__ wpk,
                    const float* __restrict__ bias, const float* __restrict__ gout,
                    __nv_bfloat16* __restrict__ dy) {
  extern __shared__ float xs[];
  const int b = blockIdx.y, p0 = blockIdx.x * TILE;
  const int r_lo = p0 / S::F_OUT;
  stage_input<S>(xs, am + (size_t)b * S::T * S::F * S::C2, 2 * r_lo - 1);
  __syncthreads();
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int p = min(p0 + lane, S::NP - 1);
  const int tp = p / S::F_OUT, fp = p % S::F_OUT;
  float acc[4][2][S::CH];
  conv_candidates<S>(xs + 2 * (tp - r_lo) * S::W + 2 * fp, wpk + g * 2 * S::CH, acc);
  if (p0 + lane >= S::NP) return;
  const float* gp = gout + ((size_t)b * S::NP + p) * S::HALF + g * S::CH;
#pragma unroll
  for (int c = 0; c < S::CH; ++c) {
    const float bh[2] = {bias[g * S::CH + c], bias[S::HALF + g * S::CH + c]};
    float v[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q][0] = acc[q][0][c] + bh[0];
      v[q][1] = acc[q][1][c] + bh[1];
    }
    float best = fmaxf(v[0][0], v[0][1]);  // the forward's order of maxima
#pragma unroll
    for (int q = 1; q < 4; ++q) best = fmaxf(best, fmaxf(v[q][0], v[q][1]));
    float cnt = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) cnt += (v[q][0] == best) + (v[q][1] == best);
    const __nv_bfloat16 gq = __float2bfloat16_rn(gp[c] / fmaxf(cnt, 1.f));
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = h * S::HALF + g * S::CH + c;
#pragma unroll
      for (int pt = 0; pt < 2; ++pt) {
        __nv_bfloat162 pair;
        pair.x = v[2 * pt][h] == best ? gq : zero;
        pair.y = v[2 * pt + 1][h] == best ? gq : zero;
        const size_t o = (((size_t)b * S::C_OUT + co) * S::T2 + 2 * tp + pt) * S::F2 + 2 * fp;
        *reinterpret_cast<__nv_bfloat162*>(dy + o) = pair;
      }
    }
  }
}

// Backward, part 2: dx[t][f][ci] = sum over taps and output channels of
// dy[t + 1 - dt][f + 1 - df][co] * w[co][ci][dt][df]. A lane owns a 2x2
// block of dx and channel group g's CI input channels.
template <class S>
__global__ void __launch_bounds__(THREADS)
    trunk_dx_kernel(const __nv_bfloat16* __restrict__ dy, const float* __restrict__ wtk,
                    float* __restrict__ dx) {
  extern __shared__ __nv_bfloat16 dys[];  // [C_OUT][DY_ROWS][W]
  const int b = blockIdx.y, q0 = blockIdx.x * TILE;
  const int r_lo = q0 / S::NBF;
  const int row0 = 2 * r_lo - 1;  // dy row staged first
  const __nv_bfloat16* dyb = dy + (size_t)b * S::C_OUT * S::T2 * S::F2;
  for (int i = threadIdx.x; i < S::C_OUT * S::DY_ROWS * S::W; i += THREADS) {
    const int c = i % S::W, r = (i / S::W) % S::DY_ROWS, co = i / (S::W * S::DY_ROWS);
    const int t = row0 + r, f = c - 1;
    __nv_bfloat16 v = __float2bfloat16_rn(0.f);
    if (t >= 0 && t < S::T2 && f >= 0 && f < S::F2) v = dyb[((size_t)co * S::T2 + t) * S::F2 + f];
    dys[i] = v;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int q = min(q0 + lane, S::NB - 1);
  const int bt = q / S::NBF, bf = q % S::NBF;
  float acc[2][2][S::CI];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int k = 0; k < S::CI; ++k) acc[a][c][k] = 0.f;
    }
  }
  const __nv_bfloat16* patch = dys + 2 * (bt - r_lo) * S::W + 2 * bf;
  for (int co = 0; co < S::C_OUT; ++co) {
    const __nv_bfloat16* d = patch + co * S::DY_ROWS * S::W;
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = __bfloat162float(d[i * S::W + j]);
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dt = tap / 3, df = tap % 3;
      const float2* w2 = reinterpret_cast<const float2*>(
          wtk + ((size_t)co * 9 + tap) * S::C2 + g * S::CI);
      float wv[S::CI];
#pragma unroll
      for (int k = 0; k < S::CI / 2; ++k) {
        const float2 v = __ldg(w2 + k);
        wv[2 * k] = v.x; wv[2 * k + 1] = v.y;
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float x = p[a + 2 - dt][c + 2 - df];
#pragma unroll
          for (int k = 0; k < S::CI; ++k) acc[a][c][k] = fmaf(x, wv[k], acc[a][c][k]);
        }
      }
    }
  }
  if (q0 + lane >= S::NB) return;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int t = 2 * bt + a;
    if (t >= S::T) continue;  // odd T: the last block row has one dx row
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float* o = dx + (((size_t)b * S::T + t) * S::F + 2 * bf + c) * S::C2 + g * S::CI;
#pragma unroll
      for (int k = 0; k < S::CI; ++k) o[k] = acc[a][c][k];
    }
  }
}

template <class S>
int launch_fwd(const void* am, const void* wpk, const void* bias, void* out, int batch,
               cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(trunk_fwd_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S::NP + TILE - 1) / TILE, batch);
  trunk_fwd_kernel<S><<<grid, THREADS, S::FWD_SMEM, s>>>(
      (const float*)am, (const float*)wpk, (const float*)bias, (float*)out);
  return (int)cudaGetLastError();
}

template <class S>
int launch_bwd(const void* am, const void* wpk, const void* bias, const void* g, void* dy,
               const void* wtk, void* dx, int batch, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(trunk_dy_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(trunk_dx_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::DX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_dy((S::NP + TILE - 1) / TILE, batch);
  trunk_dy_kernel<S><<<grid_dy, THREADS, S::FWD_SMEM, s>>>(
      (const float*)am, (const float*)wpk, (const float*)bias, (const float*)g,
      (__nv_bfloat16*)dy);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_dx((S::NB + TILE - 1) / TILE, batch);
  trunk_dx_kernel<S><<<grid_dx, THREADS, S::DX_SMEM, s>>>(
      (const __nv_bfloat16*)dy, (const float*)wtk, (float*)dx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// segment: 0 = A (conv6 after conv3), 1 = B (conv13 after conv10). Both
// launch on `stream` and return cudaGetLastError() as int (0 on success);
// 1 (cudaErrorInvalidValue) for an unknown segment.
int trunk_fwd(const void* am, const void* wpk, const void* bias, void* out, int batch,
              int segment, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (segment == 0) return launch_fwd<SegA>(am, wpk, bias, out, batch, s);
  if (segment == 1) return launch_fwd<SegB>(am, wpk, bias, out, batch, s);
  return (int)cudaErrorInvalidValue;
}

int trunk_bwd(const void* am, const void* wpk, const void* bias, const void* g, void* dy,
              const void* wtk, void* dx, int batch, int segment, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (segment == 0) return launch_bwd<SegA>(am, wpk, bias, g, dy, wtk, dx, batch, s);
  if (segment == 1) return launch_bwd<SegB>(am, wpk, bias, g, dy, wtk, dx, batch, s);
  return (int)cudaErrorInvalidValue;
}

const char* trunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
