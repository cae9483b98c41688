// RawNet3's eval-mode Bottle2neck block body on Hopper (sm_90a), forward and dx
// backward: x (B, T, Cin) bf16 -> y, o (B, T, 1024) bf16, for the three blocks
// of RawNet3 (Cin 256 with a 1x1 projection residual at dilation 2, Cin 1024
// with the identity residual at dilations 3 and 4).
//
// Replaces the TPU kernel adaa_tpu/ops/pallas_b2n.py (fused_bottle2neck ->
// _fwd_call/_fwd_kernel :179, _bwd_call/_bwd_kernel :211). Python wrapper,
// plain-torch version, the operand packings, tile and region plans and shared
// memory budgets, the pool that follows and launch counts: ops/b2n.py.
// PTX building blocks (TMA, mbarriers, wgmma, setmaxnreg): hopper.cuh.
//
// Numerics (as the JAX kernel): every product has bf16 operands and f32 sums
// (tensor cores, wgmma bf16 -> f32); h = relu(x W1 + b1) s1 + t1 and the chain
// stay f32, each chain conv's input is zeroed outside [0, T) and rounded to
// bf16 at the product; cat holds the bf16 chain outputs and h's eighth split;
// o = relu(cat W3 + b3) s3 + t3 is stored in bf16; y = o + res in f32 is
// stored in bf16 (res = the bf16 x, or x W_r). The products of the affines
// are kept apart from their sums (__fmul_rn, __fadd_rn), as the plain version
// computes them. The backward takes conv3's mask from o (bf16(o) !=
// bf16(t3)), rounds dq to bf16 before its product with W3^T, descends the
// chain with the masks sp_i != tc_i and carries din into the level below,
// masks with z + b1 > 0, and writes dx = bf16(dz1) W1^T + (bf16(dy) W_r^T or
// dy) in bf16.
//
// What bounds it on an H100. The products: at B = 64 RawNet3's three blocks
// do ~2.1 TFLOP each way (layer 1, T = 6435: conv1 0.22, chain 0.28, conv3
// 0.86, residual 0.22), 2.14 ms at the bf16 tensor-core peak. And the
// intermediates: the TPU kernel kept a 480-row tile with halos of all 1024
// channels in VMEM (~2 MB); a Hopper block has 227 KB of shared memory, so
// the body runs as three stages with h (f32), cat (bf16) and, backward, dcat
// (f32) and dz1 (bf16) in device memory: ~8.4 GB forward and ~9.5 GB
// backward over the three blocks, ~2.5 ms and ~2.8 ms at 3.35 TB/s.
//
// The design, per stage:
//   (a), (c) and the backward's dq W3^T and dx: one persistent, warp-
//       specialised tile GEMM (gemm_kernel). 128 x 128 output tiles, walked
//       with N fastest so the 132 blocks share a few A row-tiles in L2 and
//       the whole weight stays there. A producer thread TMA-loads 128 x 64
//       boxes of A and of the pre-transposed weight (128-byte swizzle) into a
//       ring of 4-5 stages guarded by mbarriers; two consumer warpgroups (64
//       rows each; setmaxnreg 232 against the producer's 40, though ptxas
//       allocates the launch bound's 168 to both) run wgmma m64n128k16 from
//       shared memory with one k-block in flight. The epilogues work on the
//       wgmma accumulator layout in registers (relu mask words gathered
//       across the 4 lanes of a row) and write the outputs into swizzled
//       shared-memory staging, which one thread stores with TMA while the
//       warpgroup runs its next tile's products, so the output traffic (h and
//       dcat in f32) overlaps them. dq = bf16(bf16(o) != bf16(t3) ? dy s3 : 0)
//       is formed in registers from ldmatrix-ed dy and o boxes and fed to the
//       register-A wgmma: dq never goes to device memory. That kernel stages
//       its f32 output in two halves, so its 48 KB ring slots fit 4 stages.
//       The projection residual is a second product into a second
//       accumulator after conv3's epilogue (o kept in f32 in the first),
//       then y = o + res.
//   (b) the res2net chain (chain_kernel): one block holds a 256-row time
//       region (central rows plus a halo of exactly 7 d rows each side) of
//       one sequence as bf16 rows 272 bytes apart in shared memory, and runs
//       the 7 levels in order. A level's three 128 x 128 taps (96 KB) arrive
//       by TMA into shared memory, once per block and level. A dilated tap is
//       a row offset of d, which no swizzled descriptor can express, so the
//       activation goes through ldmatrix into registers and wgmma takes A
//       from registers, the taps from shared memory. The two warpgroups hold
//       all 256 rows' accumulators, so a level's epilogue overwrites its
//       input in place after one barrier: the next level's bf16 input, cat and
//       the relu mask words for the central rows, in the descent dz1 through
//       conv1's mask.
// Nothing goes to cuBLAS.

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int PLANES = 1024, WIDTH = 128, NUMS = 7, CHAIN = NUMS * WIDTH;
// The relu masks are bit words stored word-major, (words, M): word w of row
// g at w * M + g, so the words of 8 consecutive rows (the rows of one
// accumulator fragment) fill one 32-byte sector.

// Layout constants shared with ops/b2n.py (which plans the launches).
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int BOX_BYTES = 128 * BK * 2;  // one 128 x 64 bf16 TMA box
// A GEMM ring slot: a box of A and one of B^T, and for the dq form a box of o.
template <bool DQ>
__host__ __device__ constexpr int stage_bytes() {
  return (DQ ? 3 : 2) * BOX_BYTES;
}
constexpr int SMEM_ALIGN = 1024, SMEM_LIMIT = 232448;
constexpr int THREADS = 384, CONSUMERS = 256;  // warpgroups 0, 1 consume; 2 produces
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int CR = 256, PADR = 4, LDS = WIDTH + 8;  // chain region rows, pad rows, row pitch
constexpr int TAP_SLOTS = 3, TAP_BYTES = 2 * BOX_BYTES;  // one level's taps
constexpr int ACT_BYTES = (CR + 2 * PADR) * LDS * 2;
constexpr int CHAIN_SMEM_MIN = TAP_SLOTS * TAP_BYTES + ACT_BYTES + 16 + SMEM_ALIGN;

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((SMEM_ALIGN - (a & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1));
}

__device__ __forceinline__ float relu_affine(float z, float s, float t) {
  return __fadd_rn(__fmul_rn(fmaxf(z, 0.f), s), t);
}

__device__ __forceinline__ void st_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Loads of what a kernel only reads go through the read-only path (__ldg):
// the compiler may then issue them ahead of the stores around them.
__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

__device__ __forceinline__ float2 ld_f2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ uint32_t ld_word(const uint32_t* p) { return __ldg(p); }

// The 4 lanes of one accumulator row hold 8 columns of each 32 between them.
__device__ __forceinline__ uint32_t quad_or(uint32_t w) {
  w |= __shfl_xor_sync(0xffffffffu, w, 1);
  w |= __shfl_xor_sync(0xffffffffu, w, 2);
  return w;
}

__device__ __forceinline__ uint32_t bits2(bool a, bool b) {
  return (uint32_t)a | ((uint32_t)b << 1);
}

// ---------------------------------------------------------------------------
// Epilogues. Each consumer warpgroup owns 64 rows x 128 columns of a tile. An
// epilogue's write() turns the accumulator (this thread: rows r0 and r0 + 8 of
// the 64, columns 8 j + 2 q + {0, 1}, q = lane % 4) into the warpgroup's 32 KB
// of output staging, as TMA boxes of 64 rows x 128 bytes with the 128-byte
// swizzle (f32: four boxes of 32 columns; bf16: two of 64); issue(), run by
// one thread once the staging is complete, stores the boxes with TMA while
// the warpgroup goes on to its next tile's products.
// ---------------------------------------------------------------------------

constexpr int STG_BYTES = 32 * 1024;  // output staging per consumer warpgroup
constexpr int OBOX = 64 * 128;        // one output box

// The dq form's kernel stages its f32 output in two parts of 16 KB, so its
// larger ring slots (an o box beside dy's) fit one more stage.
template <bool DQ>
__host__ __device__ constexpr int staging_bytes() {
  return DQ ? STG_BYTES / 2 : STG_BYTES;
}

struct GemmMaps {
  CUtensorMap a1, a1o, b1, a2, b2;  // operands; a1o: o, for the dq form of a1 = dy
  CUtensorMap c0, c1;               // outputs
};

struct Tile {  // an epilogue thread's place
  long long row0;       // global row of its first row (the second is row0 + 8)
  int r0, n0, q;        // that row within the 64; the tile's first column; lane % 4
  long long m;          // rows of the plane
  int wrow;             // global row of the warpgroup's first row
  unsigned char* stg;   // the warpgroup's staging
};

__device__ __forceinline__ unsigned char* swizzled(unsigned char* box, int r, int byte) {
  return box + r * 128 + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
}

__device__ __forceinline__ void stage_f32x2(unsigned char* stg, int r, int c, float a, float b) {
  *reinterpret_cast<float2*>(swizzled(stg + (c >> 5) * OBOX, r, (c & 31) * 4)) =
      make_float2(a, b);
}

__device__ __forceinline__ void stage_bf16x2(unsigned char* stg, int r, int c, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(swizzled(stg + (c >> 6) * OBOX, r, (c & 63) * 2)) =
      __floats2bfloat162_rn(a, b);
}

// Staged boxes -> the output map: f32 boxes are 32 columns wide, bf16 64.
__device__ __forceinline__ void store_tile(const CUtensorMap* map, const unsigned char* stg,
                                           bool f32, const Tile& t) {
  const int boxes = f32 ? 4 : 2, cols = f32 ? 32 : 64;
  for (int i = 0; i < boxes; ++i) tma_store_2d(map, stg + i * OBOX, t.n0 + i * cols, t.wrow);
}

struct EpiNone {
  static constexpr int PARTS = 1;
  __device__ void write(Acc&, const Tile&, int) const {}
  __device__ void issue(const GemmMaps&, const Tile&, int) const {}
};

struct EpiH {  // conv1: h (f32 chain strips) -> c0, cat's eighth split (bf16) -> c1, mask1 bits
  static constexpr int PARTS = 1;
  const float* b1;
  const float* s1;
  const float* t1;
  uint32_t* mask1;
  __device__ void write(Acc& a, const Tile& t, int) const {
    uint32_t words[2][4] = {};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t.q, col = t.n0 + c;
      const float2 b = ld_f2(b1 + col), s = ld_f2(s1 + col), tt = ld_f2(t1 + col);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float z0 = __fadd_rn(a.d[4 * j + 2 * hh], b.x);
        const float z1 = __fadd_rn(a.d[4 * j + 2 * hh + 1], b.y);
        words[hh][j >> 2] |= bits2(z0 > 0.f, z1 > 0.f) << (8 * (j & 3) + 2 * t.q);
        const float h0 = relu_affine(z0, s.x, tt.x), h1 = relu_affine(z1, s.y, tt.y);
        if (t.n0 < CHAIN) {
          stage_f32x2(t.stg, t.r0 + 8 * hh, c, h0, h1);
        } else {
          stage_bf16x2(t.stg, t.r0 + 8 * hh, c, h0, h1);
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t w = quad_or(words[hh][k]);
        const long long row = t.row0 + 8 * hh;
        if (t.q == 0 && row < t.m) mask1[(t.n0 / 32 + k) * t.m + row] = w;
      }
    }
  }
  __device__ void issue(const GemmMaps& maps, const Tile& t, int) const {
    if (t.n0 < CHAIN) {
      store_tile(&maps.c0, t.stg, true, t);
    } else {
      store_tile(&maps.c1, t.stg, false, t);
    }
  }
};

// conv3: o (bf16) -> c0, and o in f32 kept in the accumulator; with the
// identity residual x, y = bf16(o + x) -> c1
struct EpiO {
  static constexpr int PARTS = 1;
  const float* b3;
  const float* s3;
  const float* t3;
  const bf16* x;  // identity residual, or nullptr (the projection follows)
  __device__ void write(Acc& a, const Tile& t, int) const {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t.q, col = t.n0 + c;
      const float2 b = ld_f2(b3 + col), s = ld_f2(s3 + col), tt = ld_f2(t3 + col);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float& v0 = a.d[4 * j + 2 * hh];
        float& v1 = a.d[4 * j + 2 * hh + 1];
        v0 = relu_affine(__fadd_rn(v0, b.x), s.x, tt.x);
        v1 = relu_affine(__fadd_rn(v1, b.y), s.y, tt.y);
        stage_bf16x2(t.stg, t.r0 + 8 * hh, c, v0, v1);
        if (x != nullptr) {
          const long long row = t.row0 + 8 * hh;
          const float2 xv = row < t.m ? ld_bf16x2(x + row * PLANES + col) : make_float2(0.f, 0.f);
          stage_bf16x2(t.stg + STG_BYTES / 2, t.r0 + 8 * hh, c, __fadd_rn(v0, xv.x),
                       __fadd_rn(v1, xv.y));
        }
      }
    }
  }
  __device__ void issue(const GemmMaps& maps, const Tile& t, int) const {
    store_tile(&maps.c0, t.stg, false, t);
    if (x != nullptr) store_tile(&maps.c1, t.stg + STG_BYTES / 2, false, t);
  }
};

struct EpiAdd {  // bf16(v + add) -> c0, add bf16 (M, lda)
  static constexpr int PARTS = 1;
  const bf16* add;
  int lda;
  __device__ void write(Acc& a, const Tile& t, int) const {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t.q, col = t.n0 + c;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long row = t.row0 + 8 * hh;
        const float2 v = row < t.m ? ld_bf16x2(add + row * lda + col) : make_float2(0.f, 0.f);
        stage_bf16x2(t.stg, t.r0 + 8 * hh, c, __fadd_rn(a.d[4 * j + 2 * hh], v.x),
                     __fadd_rn(a.d[4 * j + 2 * hh + 1], v.y));
      }
    }
  }
  __device__ void issue(const GemmMaps& maps, const Tile& t, int) const {
    store_tile(&maps.c0, t.stg, false, t);
  }
};

// dq W3^T: dcat (f32 chain strips) -> c0, in two parts of 64 columns (16 KB
// of staging each); h's split straight to dz1 (bf16) -> c1, in part 0
struct EpiDcat {
  static constexpr int PARTS = 2;
  const uint32_t* mask1;
  const float* s1;
  __device__ void write(Acc& a, const Tile& t, int part) const {
    if (t.n0 >= CHAIN && part > 0) return;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = t.r0 + 8 * hh;
        if (t.n0 < CHAIN) {
          // unrolled over both parts so the accumulator index is a constant
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            const int j = 8 * pp + jj;
            if (pp == part)
              stage_f32x2(t.stg, r, 8 * jj + 2 * t.q, a.d[4 * j + 2 * hh], a.d[4 * j + 2 * hh + 1]);
          }
        } else {
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            const int j = 8 * pp + jj, c = 8 * j + 2 * t.q, col = t.n0 + c;
            const long long row = t.row0 + 8 * hh;
            const uint32_t w =
                row < t.m ? ld_word(mask1 + (col / 32) * t.m + row) >> (col % 32) : 0u;
            const float2 s = ld_f2(s1 + col);
            stage_bf16x2(t.stg, r, c, (w & 1u) ? __fmul_rn(a.d[4 * j + 2 * hh], s.x) : 0.f,
                         (w & 2u) ? __fmul_rn(a.d[4 * j + 2 * hh + 1], s.y) : 0.f);
          }
        }
      }
    }
  }
  __device__ void issue(const GemmMaps& maps, const Tile& t, int part) const {
    if (t.n0 < CHAIN) {
      for (int i = 0; i < 2; ++i)
        tma_store_2d(&maps.c0, t.stg + i * OBOX, t.n0 + 64 * part + 32 * i, t.wrow);
    } else if (part == 0) {
      store_tile(&maps.c1, t.stg, false, t);
    }
  }
};

struct EpiSum {  // the dual product: bf16(first + second) -> c1 (staged in the second half)
  __device__ void write(const Acc& first, Acc& a, const Tile& t) const {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * j + 2 * hh;
        stage_bf16x2(t.stg + STG_BYTES / 2, t.r0 + 8 * hh, 8 * j + 2 * t.q,
                     __fadd_rn(first.d[i], a.d[i]), __fadd_rn(first.d[i + 1], a.d[i + 1]));
      }
    }
  }
  __device__ void issue(const GemmMaps& maps, const Tile& t, int) const {
    store_tile(&maps.c1, t.stg + STG_BYTES / 2, false, t);
  }
};

// ---------------------------------------------------------------------------
// The tile GEMM: C[M, N] = A[M, K] B[K, N], with B given as B^T (N, K)
// row-major; optionally a second product (DUAL) into a second accumulator.
// ---------------------------------------------------------------------------

struct GemmShape {  // ops/b2n.py:gemm_plan
  long long m;
  int k1, k2;  // depths of the two products (k2 = 0: one product)
  int m_tiles, n_tiles, stages;
};

// dq = bf16(bf16(o) != bf16(t3) ? dy * s3 : 0): conv3's mask from o, as the
// plain version takes it
struct Dq {
  const float* s3;
  const float* t3;
};

// The dq form of the A operand, in registers: each warp ldmatrix-es its 16
// rows of the dy box and of the o box (swizzled: the 16-byte chunk c of row
// r sits at chunk c ^ (r % 8)) into wgmma A fragments and forms dq from
// them; wgmma takes A from registers.
// Fragment i of k-step kk: rows lane / 4 + 8 (i % 2), columns
// 16 kk + 8 (i / 2) + 2 (lane % 4) + {0, 1} of the k-block.
__device__ __forceinline__ void dq_fragments(const unsigned char* dy, const unsigned char* o,
                                             int kb, const Dq& dq, uint32_t (&fr)[BK / 16][4]) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane & 15);  // this lane's ldmatrix row
  uint32_t fo[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const int off = r * 128 + (((2 * kk + (lane >> 4)) ^ (lane & 7)) << 4);
    ldmatrix_x4(fr[kk], smem_u32(dy) + off);
    ldmatrix_x4(fo[kk], smem_u32(o) + off);
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = kb * BK + 16 * kk + 8 * (i >> 1) + 2 * q;
      const float2 s = ld_f2(dq.s3 + col), t = ld_f2(dq.t3 + col);
      const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&fr[kk][i]));
      const float2 ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&fo[kk][i]));
      const float2 tb = __bfloat1622float2(__floats2bfloat162_rn(t.x, t.y));
      __nv_bfloat162 v = __floats2bfloat162_rn(ov.x != tb.x ? __fmul_rn(d.x, s.x) : 0.f,
                                               ov.y != tb.y ? __fmul_rn(d.y, s.y) : 0.f);
      fr[kk][i] = *reinterpret_cast<uint32_t*>(&v);
    }
  }
}

// One product for this warpgroup's 64 x 128 part of the tile, consuming nkb
// k-blocks from the ring. With A from shared memory one k-block's wgmmas stay
// in flight while the next one waits for its data, and each stage is handed
// back once its wgmmas end; with the dq form, A is in registers, which a
// wgmma reads while in flight, so each k-block's wgmmas end before the next
// and its stage goes back at once.
template <bool DQ>
__device__ __forceinline__ void consume(Acc& acc, int nkb, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, Ring& ring, int stages, int wg,
                                        const Dq& dq) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc.d[i] = 0.f;
  const bool leader = (threadIdx.x & 31) == 0;
  if constexpr (DQ) {
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(full + ring.stage, ring.phase);
      const unsigned char* st = smem + ring.stage * stage_bytes<true>();
      uint32_t fr[BK / 16][4];
      dq_fragments(st + wg * 64 * 128, st + 2 * BOX_BYTES + wg * 64 * 128, kb, dq, fr);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, fr[kk], smem_desc(st + BOX_BYTES + 32 * kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(fr[kk]);
      if (leader) mbar_arrive(empty + ring.stage);
      ring.advance(stages);
    }
    fence_acc(acc);
    return;
  }
  int prev = -1;
  for (int kb = 0; kb < nkb; ++kb) {
    mbar_wait(full + ring.stage, ring.phase);
    unsigned char* st = smem + ring.stage * stage_bytes<false>();
    unsigned char* a = st + wg * 64 * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss(acc, smem_desc(a + 32 * kk), smem_desc(st + BOX_BYTES + 32 * kk), 1);
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && leader) mbar_arrive(empty + prev);
    prev = ring.stage;
    ring.advance(stages);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (prev >= 0 && leader) mbar_arrive(empty + prev);
}

// The warpgroup's staging is complete: one thread stores it.
template <class Epi>
__device__ __forceinline__ void publish(const Epi& epi, const GemmMaps& maps, const Tile& t,
                                        int wg, bool elected, int part = 0) {
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (elected) {
    epi.issue(maps, t, part);
    bulk_commit();
  }
}

// Wait until the last stores are done with the staging.
__device__ __forceinline__ void staging_free(int wg, bool elected) {
  if (elected) bulk_wait_read<0>();
  named_barrier(1 + wg, 128);
}

template <bool DQ, bool DUAL, class E1, class E2>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ GemmMaps maps, GemmShape g, Dq dq, E1 e1, E2 e2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  constexpr int STAGE = stage_bytes<DQ>(), STG = staging_bytes<DQ>();
  unsigned char* staging = smem + g.stages * STAGE;  // then 2 x STG of output staging
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * STG);
  uint64_t* empty = full + g.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int tiles = g.m_tiles * g.n_tiles;
  const int kb1 = g.k1 / BK, kb2 = DUAL ? g.k2 / BK : 0;
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      Ring ring;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / g.n_tiles) * BM, n0 = (tile % g.n_tiles) * BN;
        for (int kb = 0; kb < kb1 + kb2; ++kb) {
          mbar_wait(empty + ring.stage, ring.phase ^ 1u);
          unsigned char* st = smem + ring.stage * STAGE;
          uint64_t* bar = full + ring.stage;
          const bool first = kb < kb1;
          const int k0 = (first ? kb : kb - kb1) * BK;
          mbar_expect_tx(bar, (DQ && first ? 3 : 2) * BOX_BYTES);
          tma_load_2d(st, first ? &maps.a1 : &maps.a2, bar, k0, m0);
          tma_load_2d(st + BOX_BYTES, first ? &maps.b1 : &maps.b2, bar, k0, n0);
          if (DQ && first) tma_load_2d(st + 2 * BOX_BYTES, &maps.a1o, bar, k0, m0);
          ring.advance(g.stages);
        }
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int lane = threadIdx.x & 31;
    const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const bool elected = (threadIdx.x & 127) == 0;
    Ring ring;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int wrow = (tile / g.n_tiles) * BM + 64 * wg;
      const Tile t{wrow + r0, r0, (tile % g.n_tiles) * BN, lane & 3, g.m, wrow,
                   staging + wg * STG};
      Acc acc;
      consume<DQ>(acc, kb1, smem, full, empty, ring, g.stages, wg, dq);
#pragma unroll 1
      for (int part = 0; part < E1::PARTS; ++part) {
        staging_free(wg, elected);
        e1.write(acc, t, part);
        publish(e1, maps, t, wg, elected, part);
      }
      if constexpr (DUAL) {
        Acc acc2;
        consume<false>(acc2, kb2, smem, full, empty, ring, g.stages, wg, dq);
        e2.write(acc, acc2, t);
        publish(e2, maps, t, wg, elected);
      }
    }
    if (elected) bulk_wait<0>();
  }
}

// plan: m_tiles, n_tiles, grid, stages, smem bytes (ops/b2n.py:gemm_plan)
template <bool DQ, bool DUAL, class E1, class E2>
int launch_gemm(const GemmMaps& maps, long long m, int n, int k1, int k2, const int* plan,
                const Dq& dq, E1 e1, E2 e2, cudaStream_t s) {
  const GemmShape g{m, k1, k2, plan[0], plan[1], plan[3]};
  const int grid = plan[2], smem = plan[4];
  if (g.m_tiles != (int)((m + BM - 1) / BM) || g.n_tiles * BN != n || k1 % BK || k2 % BK ||
      grid < 1 || grid > g.m_tiles * g.n_tiles || g.stages < 2 ||
      smem < g.stages * (stage_bytes<DQ>() + 16) + 2 * staging_bytes<DQ>() + SMEM_ALIGN ||
      smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  auto kern = gemm_kernel<DQ, DUAL, E1, E2>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, THREADS, smem, s>>>(maps, g, dq, e1, e2);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The res2net chain: 7 dilated k=3 convs of width 128, forward or descent.
// A block: two warpgroups, two 64-row slabs of the 256-row region each, and
// no producer warp, so that ptxas may give every thread up to 255 registers
// (all 256 rows' accumulators are live at once). A level's three taps sit in
// three slots; thread 0 refills them with the next level's taps by TMA as
// soon as every warpgroup is done with them, so the load overlaps the
// epilogue. The epilogue takes the thread's four rows one by one: a row's
// loads from device memory all in flight together, then its stores.
// ---------------------------------------------------------------------------

constexpr int CHAIN_THREADS = 256;

struct ChainArgs {
  const float* src;       // forward: h (M, 896); descent: dcat (M, 896)
  const float* bc;        // (896) forward only
  const float* sc;        // (896)
  const float* tc;        // (896) forward only
  const uint32_t* mask1;  // (32, M) descent only
  const float* s1;        // (1024) descent only
  uint32_t* cmask;        // (28, M): written forward, read by the descent
  bf16* out;              // (M, 1024) cols 0..895: forward cat, descent dz1
  long long m;            // B T
  int t, dilation, halo, central;
};

template <bool DESCENT>
__device__ __forceinline__ int level_of(int lv) {
  return DESCENT ? NUMS - 1 - lv : lv;
}

// The strip of `src` a level's epilogue reads: forward h of the level above,
// descent dcat of the level below (none for the last level).
template <bool DESCENT>
__device__ __forceinline__ int source_col(int lvl) {
  if (DESCENT) return lvl > 0 ? (lvl - 1) * WIDTH : -1;
  return lvl + 1 < NUMS ? (lvl + 1) * WIDTH : -1;
}

// Thread 0: level lv's taps into the slots (tap (lvl, s) is rows
// [(3 lvl + s) 128, +128) of the packed (2688, 128) weight).
template <bool DESCENT>
__device__ __forceinline__ void fetch_taps(const CUtensorMap* taps, unsigned char* slots,
                                           uint64_t* full, int lv) {
  if (threadIdx.x != 0) return;
  const int lvl = level_of<DESCENT>(lv);
  mbar_expect_tx(full, TAP_SLOTS * TAP_BYTES);
  for (int s = 0; s < TAP_SLOTS; ++s) {
    tma_load_2d(slots + s * TAP_BYTES, taps, full, 0, (3 * lvl + s) * WIDTH);
    tma_load_2d(slots + s * TAP_BYTES + BOX_BYTES, taps, full, BK, (3 * lvl + s) * WIDTH);
  }
}

// What a level's epilogue reads from device memory for one row of a thread:
// the forward's h of the level above, or the descent's dcat of the level
// below, and the descent's mask words.
struct RowLoads {
  float2 src[16];
  uint32_t w_out[4], w_in[4];  // descent: mask1 of this level, cmask of the level below
};

// One of the thread's four rows (gi: slab gi / 2, fragment row 8 (gi % 2)):
// where it lies in the region and the sequence.
template <bool DESCENT>
struct ChainRow {
  int r;  // region row
  bool inb, central;
  long long g;  // global row (0 outside the sequence)
  __device__ ChainRow(const ChainArgs& a, int gi) {
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    r = 128 * wg + 64 * (gi >> 1) + 16 * warp + (lane >> 2) + 8 * (gi & 1);
    const int pos = blockIdx.x * a.central - a.halo + r;
    inb = pos >= 0 && pos < a.t;
    central = inb && r >= a.halo && r < a.halo + a.central;
    g = (long long)blockIdx.y * a.t + (inb ? pos : 0);
  }
  __device__ void load(const ChainArgs& a, int lvl, RowLoads& l) const {
    const int q = threadIdx.x & 3, scol = source_col<DESCENT>(lvl);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      l.src[j] = inb && scol >= 0 ? ld_f2(a.src + g * CHAIN + scol + 8 * j + 2 * q)
                                  : make_float2(0.f, 0.f);
    if (DESCENT) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        l.w_out[k] = central ? ld_word(a.mask1 + (lvl * 4 + k) * a.m + g) : 0u;
        l.w_in[k] = inb && scol >= 0 ? ld_word(a.cmask + (lvl * 4 - 4 + k) * a.m + g) : 0u;
      }
    }
  }
  // the level's outputs of this row from its accumulator half hh: cat or dz1
  // and the mask words for the central rows, the next level's bf16 input
  __device__ void finish(const ChainArgs& a, int lvl, const Acc& acc, int hh,
                         const RowLoads& l, bf16* act) const {
    const int q = threadIdx.x & 3;
    const bool next = source_col<DESCENT>(lvl) >= 0;
    bf16* nxt = act + (PADR + r) * LDS;
    if (!DESCENT) {
      uint32_t words[4] = {};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int ch = 8 * j + 2 * q, col = lvl * WIDTH + ch;
        const float2 b = ld_f2(a.bc + col), sc = ld_f2(a.sc + col), tc = ld_f2(a.tc + col);
        const float v0 = relu_affine(__fadd_rn(acc.d[4 * j + 2 * hh], b.x), sc.x, tc.x);
        const float v1 = relu_affine(__fadd_rn(acc.d[4 * j + 2 * hh + 1], b.y), sc.y, tc.y);
        words[j >> 2] |= bits2(v0 != tc.x, v1 != tc.y) << (8 * (j & 3) + 2 * q);
        if (central) st_bf16x2(a.out + g * PLANES + col, v0, v1);
        if (next)
          st_bf16x2(nxt + ch, inb ? __fadd_rn(v0, l.src[j].x) : 0.f,
                    inb ? __fadd_rn(v1, l.src[j].y) : 0.f);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t w = quad_or(words[k]);
        if (central && q == 0) a.cmask[(lvl * 4 + k) * a.m + g] = w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int ch = 8 * j + 2 * q, col = lvl * WIDTH + ch;
        const float v0 = inb ? acc.d[4 * j + 2 * hh] : 0.f;  // din
        const float v1 = inb ? acc.d[4 * j + 2 * hh + 1] : 0.f;
        const int bit = ch % 32;  // the pair's place in its mask words
        if (central) {
          const uint32_t w1 = l.w_out[j >> 2] >> bit;
          const float2 s = ld_f2(a.s1 + col);
          st_bf16x2(a.out + g * PLANES + col, (w1 & 1u) ? __fmul_rn(v0, s.x) : 0.f,
                    (w1 & 2u) ? __fmul_rn(v1, s.y) : 0.f);
        }
        if (next) {
          const uint32_t wm = l.w_in[j >> 2] >> bit;
          const float2 s = ld_f2(a.sc + col - WIDTH);
          st_bf16x2(nxt + ch, (wm & 1u) ? __fmul_rn(__fadd_rn(l.src[j].x, v0), s.x) : 0.f,
                    (wm & 2u) ? __fmul_rn(__fadd_rn(l.src[j].y, v1), s.y) : 0.f);
        }
      }
    }
  }
};

template <bool DESCENT>
__global__ void __launch_bounds__(CHAIN_THREADS, 1)
    chain_kernel(const __grid_constant__ CUtensorMap taps, ChainArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* slots = align_smem(smem_raw);
  bf16* act = reinterpret_cast<bf16*>(slots + TAP_SLOTS * TAP_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + TAP_SLOTS * TAP_BYTES + ACT_BYTES);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int t0 = blockIdx.x * a.central;
  const long long rowbase = (long long)blockIdx.y * a.t;
  if (tid == 0) {
    mbar_init(full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  fetch_taps<DESCENT>(&taps, slots, full, 0);

  // the pad rows stay zero; region rows get the first level's bf16 input
  for (int i = tid; i < 2 * PADR * LDS / 8; i += CHAIN_THREADS) {
    const int r = i / (LDS / 8), c8 = (i % (LDS / 8)) * 8;
    const int row = r < PADR ? r : CR + r;  // rows 0..3 and 260..263
    *reinterpret_cast<uint4*>(act + row * LDS + c8) = make_uint4(0u, 0u, 0u, 0u);
  }
  const int first = level_of<DESCENT>(0);
  for (int i = tid; i < CR * (WIDTH / 8); i += CHAIN_THREADS) {
    const int r = i / (WIDTH / 8), c8 = (i % (WIDTH / 8)) * 8;
    const int pos = t0 - a.halo + r;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
    if (pos >= 0 && pos < a.t) {
      const long long g = rowbase + pos;
      const float* s = a.src + g * CHAIN + first * WIDTH + c8;
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(s));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(s + 4));
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      if (DESCENT) {
        const uint32_t w =
            ld_word(a.cmask + ((first * WIDTH + c8) / 32) * a.m + g) >> (c8 % 32);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = (w >> j) & 1u ? __fmul_rn(sv[j], __ldg(a.sc + first * WIDTH + c8 + j)) : 0.f;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = sv[j];
      }
    }
    uint4 u;
    uint32_t* uw = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      uw[k] = *reinterpret_cast<uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(act + (PADR + r) * LDS + c8) = u;
  }
  __syncthreads();

  const ChainRow<DESCENT> rows[4] = {ChainRow<DESCENT>(a, 0), ChainRow<DESCENT>(a, 1),
                                     ChainRow<DESCENT>(a, 2), ChainRow<DESCENT>(a, 3)};
  for (int lv = 0; lv < NUMS; ++lv) {
    const int lvl = level_of<DESCENT>(lv);
    // this warpgroup's two 64-row slabs: region rows 128 wg + 64 m ..
    Acc acc[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m].d[i] = 0.f;
    }
    mbar_wait(full, lv & 1);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const unsigned char* slot = slots + s * TAP_BYTES;
      // forward tap s reads row r + (s - 1) d; the transposed tap row r - (s - 1) d
      const int shift = (DESCENT ? 1 - s : s - 1) * a.dilation;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // ldmatrix.x4: lane l addresses row l % 16 of the warp's 16, columns 8 (l / 16) ..
        const int r = 128 * wg + 64 * m + 16 * warp + (lane & 15) + shift;
        const uint32_t base = smem_u32(act + (PADR + r) * LDS + (lane >> 4) * 8);
        uint32_t fr[WIDTH / 16][4];
#pragma unroll
        for (int kk = 0; kk < WIDTH / 16; ++kk) ldmatrix_x4(fr[kk], base + 32 * kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WIDTH / 16; ++kk)
          wgmma_rs(acc[m], fr[kk], smem_desc(slot + (kk >> 2) * BOX_BYTES + 32 * (kk & 3)), 1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int kk = 0; kk < WIDTH / 16; ++kk) fence_regs(fr[kk]);
        fence_acc(acc[m]);
      }
    }
    __syncthreads();  // every read of this level's input and taps is done
    if (lv + 1 < NUMS) fetch_taps<DESCENT>(&taps, slots, full, lv + 1);

    // row by row: the row's loads in flight together, then its stores
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      RowLoads l;
      rows[gi].load(a, lvl, l);
      rows[gi].finish(a, lvl, acc[gi >> 1], gi & 1, l, act);
    }
    __syncthreads();  // the next level's input is complete
  }
}

// plan: regions, halo, central, smem bytes (ops/b2n.py:chain_plan)
template <bool DESCENT>
int launch_chain(const bf16* taps, ChainArgs a, const int* plan, int batch, cudaStream_t s) {
  const int regions = plan[0], smem = plan[3];
  a.halo = plan[1];
  a.central = plan[2];
  if (a.dilation < 1 || a.dilation > PADR || a.halo < NUMS * a.dilation ||
      a.central != CR - 2 * a.halo || a.central < 1 || (long long)regions * a.central < a.t ||
      (long long)(regions - 1) * a.central >= a.t || smem < CHAIN_SMEM_MIN || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t err = make_map(&map, taps, 3 * NUMS * WIDTH, WIDTH, WIDTH);
  if (err != cudaSuccess) return (int)err;
  auto kern = chain_kernel<DESCENT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(regions, batch), CHAIN_THREADS, smem, s>>>(map, a);
  return (int)cudaGetLastError();
}

// Operands in 128-row boxes; outputs (out = true) in 64-row boxes, f32 or bf16.
cudaError_t map_or(CUtensorMap* map, const void* base, long long rows, int cols, cudaError_t prev,
                   bool out = false, bool f32 = false) {
  if (prev != cudaSuccess) return prev;
  return make_map(map, base, (uint64_t)rows, (uint64_t)cols, out ? 64 : 128, f32);
}

}  // namespace

extern "C" {

// Forward. x (B, T, Cin) bf16; w1t (1024, Cin) = W1^T, wct (2688, 128) = the
// chain taps each transposed, w3t (1024, 1024) = W3^T, wrt (1024, Cin) = Wr^T
// or null, bf16; b1 s1 t1 b3 s3 t3 (1024), bc sc tc (896) f32. Scratch: h
// (B T, 896) f32, cat (B T, 1024) bf16. Out: y, o (B, T, 1024) bf16, and the
// relu masks as bit words for the backward: mask1 (32, B T) of conv1, cmask
// (28, B T) of the chain. plan: 14 ints from
// ops/b2n.py:fwd_plan. Returns a cudaError_t.
int b2n_fwd(const void* x, const void* w1t, const void* b1, const void* s1, const void* t1,
            const void* wct, const void* bc, const void* sc, const void* tc, const void* w3t,
            const void* b3, const void* s3, const void* t3, const void* wrt, void* h, void* cat,
            void* y, void* o, void* mask1, void* cmask, int batch, int t, int cin, int dilation,
            const int* plan, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (cin % BN != 0 || (wrt == nullptr && cin != PLANES)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long m = (long long)batch * t;
  const bf16* xb = (const bf16*)x;
  const Dq no_dq{nullptr, nullptr};

  GemmMaps g1 = {};
  e = map_or(&g1.a1, x, m, cin, cudaSuccess);
  e = map_or(&g1.b1, w1t, PLANES, cin, e);
  e = map_or(&g1.c0, h, m, CHAIN, e, true, true);
  e = map_or(&g1.c1, cat, m, PLANES, e, true);
  if (e != cudaSuccess) return (int)e;
  int err = launch_gemm<false, false>(
      g1, m, PLANES, cin, 0, plan, no_dq,
      EpiH{(const float*)b1, (const float*)s1, (const float*)t1, (uint32_t*)mask1}, EpiNone{}, s);
  if (err) return err;

  ChainArgs ca{(const float*)h, (const float*)bc, (const float*)sc, (const float*)tc,
               nullptr, nullptr, (uint32_t*)cmask, (bf16*)cat, m, t, dilation, 0, 0};
  err = launch_chain<false>((const bf16*)wct, ca, plan + 5, batch, s);
  if (err) return err;

  GemmMaps g3 = {};
  e = map_or(&g3.a1, cat, m, PLANES, cudaSuccess);
  e = map_or(&g3.b1, w3t, PLANES, PLANES, e);
  e = map_or(&g3.c0, o, m, PLANES, e, true);
  e = map_or(&g3.c1, y, m, PLANES, e, true);
  if (wrt != nullptr) {
    e = map_or(&g3.a2, x, m, cin, e);
    e = map_or(&g3.b2, wrt, PLANES, cin, e);
  }
  if (e != cudaSuccess) return (int)e;
  const EpiO epi_o{(const float*)b3, (const float*)s3, (const float*)t3,
                   wrt == nullptr ? xb : nullptr};
  if (wrt != nullptr)
    return launch_gemm<false, true>(g3, m, PLANES, PLANES, cin, plan + 9, no_dq, epi_o, EpiSum{},
                                    s);
  return launch_gemm<false, false>(g3, m, PLANES, PLANES, 0, plan + 9, no_dq, epi_o, EpiNone{},
                                   s);
}

// dx backward. dy, o (B, T, 1024) bf16; mask1, cmask from the forward; s1 s3
// t3 (1024), sc (896) f32; wc (2688, 128) the chain taps as they are, w3
// (1024, 1024), w1 (Cin, 1024), wr (Cin, 1024) or null, bf16 (each the
// transpose of the product's weight, as the GEMM takes it). Scratch: dcat
// (B T, 896) f32, dz1 (B T, 1024) bf16. Out: dx (B, T, Cin) bf16. plan: 14
// ints from ops/b2n.py:bwd_plan.
int b2n_bwd(const void* dy, const void* o, const void* mask1, const void* cmask,
            const void* s1, const void* wc, const void* sc, const void* s3, const void* t3,
            const void* w3,
            const void* w1, const void* wr, void* dcat, void* dz1, void* dx, int batch, int t,
            int cin, int dilation, const int* plan, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (cin % BN != 0 || (wr == nullptr && cin != PLANES)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long m = (long long)batch * t;

  GemmMaps gq = {};
  e = map_or(&gq.a1, dy, m, PLANES, cudaSuccess);
  e = map_or(&gq.a1o, o, m, PLANES, e);
  e = map_or(&gq.b1, w3, PLANES, PLANES, e);
  e = map_or(&gq.c0, dcat, m, CHAIN, e, true, true);
  e = map_or(&gq.c1, dz1, m, PLANES, e, true);
  if (e != cudaSuccess) return (int)e;
  int err = launch_gemm<true, false>(gq, m, PLANES, PLANES, 0, plan,
                                     Dq{(const float*)s3, (const float*)t3},
                                     EpiDcat{(const uint32_t*)mask1, (const float*)s1}, EpiNone{}, s);
  if (err) return err;

  ChainArgs ca{(const float*)dcat, nullptr, (const float*)sc, nullptr,
               (const uint32_t*)mask1, (const float*)s1, (uint32_t*)cmask, (bf16*)dz1,
               m, t, dilation, 0, 0};
  err = launch_chain<true>((const bf16*)wc, ca, plan + 5, batch, s);
  if (err) return err;

  GemmMaps gx = {};
  e = map_or(&gx.a1, dz1, m, PLANES, cudaSuccess);
  e = map_or(&gx.b1, w1, cin, PLANES, e);
  e = map_or(&gx.c0, dx, m, cin, e, true);
  e = map_or(&gx.c1, dx, m, cin, e, true);
  if (wr != nullptr) {
    e = map_or(&gx.a2, dy, m, PLANES, e);
    e = map_or(&gx.b2, wr, cin, PLANES, e);
  }
  if (e != cudaSuccess) return (int)e;
  const Dq no_dq{nullptr, nullptr};
  if (wr != nullptr)
    return launch_gemm<false, true>(gx, m, cin, PLANES, PLANES, plan + 9, no_dq, EpiNone{},
                                    EpiSum{}, s);
  return launch_gemm<false, false>(gx, m, cin, PLANES, 0, plan + 9, no_dq,
                                   EpiAdd{(const bf16*)dy, PLANES}, EpiNone{}, s);
}

const char* b2n_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
