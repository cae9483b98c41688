"""RawNet3's eval-mode Bottle2neck block body, fused: (B, T, Cin) -> bf16 (B, T // pool, 1024).

Replaces the TPU kernel ``adaa_tpu/ops/pallas_b2n.py``
(``fused_bottle2neck`` -> ``_fwd_call``/``_fwd_kernel``,
``_bwd_call``/``_bwd_kernel``) with CUDA C++ kernels for Hopper
(``adaa_tpu_torch/csrc/b2n.cu`` with ``csrc/hopper.cuh``, built by
``ops/_build.py``): wgmma + TMA tile GEMMs and a chain kernel that keeps
a level's taps in shared memory. The CUDA source's header says what
bounds them on an H100 and how the design deals with that. This module
decides what the kernels take and checks: the weights packed as their
B operands (``packed_weights``), the chain's regions (``chain_plan``),
the persistent GEMMs' tiles, rings and shared memory (``gemm_plan``,
``gemm_tiles``), passed to the C side as ``fwd_plan`` / ``bwd_plan``.

What it computes, with the JAX kernel's rounding points (BNs folded to
``relu(z + b) * s + t`` by the caller, ``B2NParams``):

* forward: x rounded to bf16; ``h = relu(x @ W1 + b1) * s1 + t1`` in f32;
  the res2net chain of 7 dilated k=3 convs of width 128, each input
  ``sp_{i-1} + h_i`` (f32) zeroed outside [0, T) and rounded to bf16 at
  the product, ``sp_i = relu(conv + bc_i) * sc_i + tc_i`` in f32; ``cat``
  in bf16 (the seven ``sp_i`` and h's eighth split);
  ``o = relu(cat @ W3 + b3) * s3 + t3``, stored in bf16;
  ``y = o + residual`` in f32, stored in bf16, the residual being the bf16
  x or ``x_bf16 @ Wr``. Every product has bf16 operands and f32 sums.
* backward, dx only: conv3's mask ``bf16(o) != bf16(t3)``, ``dq`` rounded
  to bf16 before the product with W3^T, the descent through the chain
  with each level's mask ``sp_i != tc_i`` (f32) and ``din`` carried into
  the level below, conv1's mask ``z + b1 > 0``, and
  ``dx = bf16(dz1) @ W1^T + (bf16(dy) @ Wr^T or dy)``, stored in bf16.
  A weight gradient raises (the JAX op poisons it with NaN).
* the pool that follows (and its backward ``where(y == repeat(out), g,
  0)``, so every tie gets the cotangent) stays plain torch, as it is XLA
  in JAX.

``fused_bottle2neck`` launches the kernels for a CUDA tensor and runs
the plain-torch version only for a CPU tensor; a CUDA tensor never
falls back. ``fused_bottle2neck_reference`` is the plain version
itself, called explicitly to check the kernels. ``LAUNCHES`` counts
launches of the forward and of the backward (each one call of the C
side, which runs three kernels in order: a GEMM, the chain, a GEMM).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from adaa_tpu_torch.ops import _build
from adaa_tpu_torch.ops.layer0 import ieee_f32

PLANES = 1024
SCALE = 8
WIDTH = PLANES // SCALE  # 128
NUMS = SCALE - 1  # 7
CHAIN = NUMS * WIDTH  # 896
DILATIONS = (2, 3, 4)  # the kernels are built for RawNet3's three blocks
MASK1_WORDS = PLANES // 32  # conv1 relu mask: one bit per channel
CMASK_WORDS = CHAIN // 32  # the chain's relu masks

LAUNCHES = {"fwd": 0, "bwd": 0}


class B2NParams(NamedTuple):
    """Folded eval-mode parameters (BNs as y = relu(z) * s + t affines)."""

    w1: torch.Tensor  # (Cin, 1024) bf16
    b1: torch.Tensor  # (1024,) f32
    s1: torch.Tensor
    t1: torch.Tensor
    wc: torch.Tensor  # (21 * 128, 128) bf16: rows [(i * 3 + s) * 128, +128) = tap s of conv i
    bc: torch.Tensor  # (896,) f32: [i * 128, +128) = conv i
    sc: torch.Tensor
    tc: torch.Tensor
    w3: torch.Tensor  # (1024, 1024) bf16
    b3: torch.Tensor  # (1024,) f32
    s3: torch.Tensor
    t3: torch.Tensor
    wr: Optional[torch.Tensor]  # (Cin, 1024) bf16, None = identity residual


def _validate(x: torch.Tensor, p: B2NParams, dilation: int, pool: int) -> None:
    if x.dim() != 3 or x.shape[1] < 1:
        raise ValueError(f"x must be (B, T, Cin), got {tuple(x.shape)}")
    cin = x.shape[2]
    if pool and x.shape[1] % pool != 0:
        raise ValueError(f"fused_bottle2neck: T={x.shape[1]} not divisible by pool={pool}")
    shapes = {"w1": (cin, PLANES), "wc": (3 * NUMS * WIDTH, WIDTH), "w3": (PLANES, PLANES),
              "b1": (PLANES,), "s1": (PLANES,), "t1": (PLANES,), "b3": (PLANES,),
              "s3": (PLANES,), "t3": (PLANES,), "bc": (CHAIN,), "sc": (CHAIN,), "tc": (CHAIN,)}
    for name, want in shapes.items():
        got = tuple(getattr(p, name).shape)
        if got != want:
            raise ValueError(f"{name} must be {want}, got {got}")
    if p.wr is None and cin != PLANES:
        raise ValueError(f"an identity residual needs Cin={PLANES}, got {cin}")
    if p.wr is not None and tuple(p.wr.shape) != (cin, PLANES):
        raise ValueError(f"wr must be {(cin, PLANES)}, got {tuple(p.wr.shape)}")
    if any(t is not None and t.device != x.device for t in p):
        raise ValueError("x and the parameters must be on one device")


# --------------------------------------------------------------------------
# Kernel layouts and plans: csrc/b2n.cu takes what these give it, and
# checks it against its own constants
# --------------------------------------------------------------------------

SMEM_LIMIT = 232_448  # the shared memory one Hopper block may use
SMEM_ALIGN = 1024  # the 128-byte swizzle's period: the C side aligns its base
GEMM_BM = GEMM_BN = 128  # output tile
GEMM_BK = 64  # one swizzled 128-byte row of bf16
BOX_BYTES = 128 * GEMM_BK * 2  # one 128 x 64 TMA box
GEMM_STAGING = 2 * 32 * 1024  # output staging: 64 x 128 f32 per consumer warpgroup
DQ_STAGING = GEMM_STAGING // 2  # the dq form's kernel stages its f32 output in two parts
BARRIER_BYTES = 16  # two mbarriers: a GEMM ring slot's full and empty; the chain's one

CHAIN_REGION = 256  # rows a chain block holds: central rows and two halos
CHAIN_PAD = 4  # zero rows above and below the region (>= the largest dilation)
CHAIN_LDS = WIDTH + 8  # the region's bf16 row pitch: 272 bytes, ldmatrix without conflicts
CHAIN_TAP_SLOTS = 3  # one level's 128 x 128 taps (32 KB each)
TAP_BYTES = 2 * BOX_BYTES


class GemmPlan(NamedTuple):
    """A persistent tile GEMM: ``grid`` blocks walk the ``m_tiles x n_tiles``
    output tiles (``gemm_tiles``) through a ring of ``stages`` slots."""

    m_tiles: int
    n_tiles: int
    grid: int
    stages: int
    smem_bytes: int


def gemm_plan(m: int, n: int, dq: bool, sms: int) -> GemmPlan:
    """The plan of one (m, K) x (K, n) product. A ring slot holds a 128 x 64
    box of A and of B^T, and for the dq form (``dq``) a box of o beside
    dy's; as many slots as fit beside the output staging (half as much for
    the dq form)."""
    if n % GEMM_BN:
        raise ValueError(f"N={n} is not a multiple of {GEMM_BN}")
    stage = (3 if dq else 2) * BOX_BYTES
    staging = DQ_STAGING if dq else GEMM_STAGING
    stages = (SMEM_LIMIT - SMEM_ALIGN - staging) // (stage + BARRIER_BYTES)
    m_tiles, n_tiles = -(-m // GEMM_BM), n // GEMM_BN
    smem = stages * (stage + BARRIER_BYTES) + staging + SMEM_ALIGN
    return GemmPlan(m_tiles, n_tiles, min(m_tiles * n_tiles, sms), stages, smem)


def gemm_tiles(plan: GemmPlan):
    """The (m_tile, n_tile) sequence of each block, as the kernel walks it:
    block b takes tiles b, b + grid, ..., N fastest, so the blocks in flight
    share a few A row-tiles and the whole weight in L2."""
    total = plan.m_tiles * plan.n_tiles
    return [[divmod(i, plan.n_tiles) for i in range(b, total, plan.grid)]
            for b in range(plan.grid)]


class ChainPlan(NamedTuple):
    """The chain kernel's regions: block (i, b) holds rows
    [i * central - halo, + region) of sequence b and writes the central ones."""

    region: int
    halo: int
    central: int
    regions: int
    smem_bytes: int


def chain_plan(dilation: int, t: int) -> ChainPlan:
    """A halo of exactly 7 d rows each side: after the 7 levels, the rows a
    halo's far edge got wrong (its taps read the zero pad) reach no
    central row."""
    if not 1 <= dilation <= CHAIN_PAD:
        raise ValueError(f"the chain kernel takes dilations 1..{CHAIN_PAD}, got {dilation}")
    halo = NUMS * dilation
    central = CHAIN_REGION - 2 * halo
    smem = (CHAIN_TAP_SLOTS * TAP_BYTES + BARRIER_BYTES
            + (CHAIN_REGION + 2 * CHAIN_PAD) * CHAIN_LDS * 2 + SMEM_ALIGN)
    return ChainPlan(CHAIN_REGION, halo, central, -(-t // central), smem)


def chain_regions(plan: ChainPlan, t: int):
    """(first region row, first central row, end of the central rows) of
    each region of a sequence of length t."""
    return [(i * plan.central - plan.halo, i * plan.central, min((i + 1) * plan.central, t))
            for i in range(plan.regions)]


def fwd_plan(batch: int, t: int, cin: int, dilation: int, sms: int) -> Tuple[int, ...]:
    """The forward's 14 plan ints: conv1's GEMM, the chain, conv3's GEMM."""
    m = batch * t
    c = chain_plan(dilation, t)
    return (*gemm_plan(m, PLANES, False, sms), c.regions, c.halo, c.central, c.smem_bytes,
            *gemm_plan(m, PLANES, False, sms))


def bwd_plan(batch: int, t: int, cin: int, dilation: int, sms: int) -> Tuple[int, ...]:
    """The backward's 14 plan ints: dq W3^T's GEMM, the descent, dx's GEMM."""
    m = batch * t
    c = chain_plan(dilation, t)
    return (*gemm_plan(m, PLANES, True, sms), c.regions, c.halo, c.central, c.smem_bytes,
            *gemm_plan(m, cin, False, sms))


def transposed_chain_weights(wc: torch.Tensor) -> torch.Tensor:
    """(21 * 128, 128) -> the same blocks, each transposed."""
    return wc.reshape(3 * NUMS, WIDTH, WIDTH).transpose(1, 2).reshape(-1, WIDTH).contiguous()


def packed_weights(p: B2NParams, backward: bool) -> dict:
    """The weights as the kernels' B operands take them: B^T, (N, K) with K
    contiguous. The forward's products x W1, cat W3, x Wr and the chain's
    taps take the transposes; the backward's dq W3^T, dz1 W1^T, dy Wr^T and
    the transposed taps take the weights as they are stored."""
    if backward:
        packed = {"w3": p.w3, "wc": p.wc, "w1": p.w1, "wr": p.wr}
    else:
        packed = {"w1t": p.w1.t(), "wct": transposed_chain_weights(p.wc), "w3t": p.w3.t(),
                  "wrt": None if p.wr is None else p.wr.t()}
    return {k: _bf(v) for k, v in packed.items()}


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

_PTR, _I32, _PLAN = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
# the C functions' parameters: pointers, batch t cin dilation, the plan, the
# device, the stream
ARGTYPES = {"b2n_fwd": [_PTR] * 20 + [_I32] * 4 + [_PLAN, _I32, _PTR],
            "b2n_bwd": [_PTR] * 15 + [_I32] * 4 + [_PLAN, _I32, _PTR]}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("b2n")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I32
    lib.b2n_error_string.argtypes = [_I32]
    lib.b2n_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_array(plan: Tuple[int, ...]):
    return (ctypes.c_int * len(plan))(*plan)


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"b2n {what} launch failed: CUDA error {err} "
                           f"({lib.b2n_error_string(err).decode()})")


def _kernel_args(a: torch.Tensor, cin: int, dilation: int) -> None:
    if not a.is_cuda:
        raise ValueError("the b2n kernels take CUDA tensors")
    if dilation not in DILATIONS:
        raise ValueError(f"the b2n kernels are built for dilations {DILATIONS}, got {dilation}")
    if cin % 128:
        raise ValueError(f"the b2n kernels need Cin to be a multiple of 128, got {cin}")
    if a.shape[0] * a.shape[1] * max(cin, PLANES) >= 2 ** 31:
        raise ValueError("the b2n kernels take fewer than 2**31 elements per plane")


def _bf(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.detach().to(torch.bfloat16).contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def kernel_fwd(x: torch.Tensor, p: B2NParams, dilation: int
               ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Launch the forward: x (B, T, Cin) -> (y, o, masks): the relu masks of
    conv1 and the chain as bits, which the backward takes with o."""
    b, t, cin = x.shape
    _kernel_args(x, cin, dilation)
    rows = b * t
    dev = x.device
    xb = _bf(x)
    h = torch.empty((rows, CHAIN), dtype=torch.float32, device=dev)  # scratch
    cat = torch.empty((rows, PLANES), dtype=torch.bfloat16, device=dev)  # scratch
    y = torch.empty((b, t, PLANES), dtype=torch.bfloat16, device=dev)
    o = torch.empty_like(y)
    # relu masks as bit words, word-major: word w of row g at [w, g]
    mask1 = torch.empty((MASK1_WORDS, rows), dtype=torch.int32, device=dev)
    cmask = torch.empty((CMASK_WORDS, rows), dtype=torch.int32, device=dev)
    wp = packed_weights(p, backward=False)
    w = [wp["w1t"], _f32(p.b1), _f32(p.s1), _f32(p.t1), wp["wct"], _f32(p.bc), _f32(p.sc),
         _f32(p.tc), wp["w3t"], _f32(p.b3), _f32(p.s3), _f32(p.t3), wp["wrt"]]
    plan = _plan_array(fwd_plan(b, t, cin, dilation, _sms(dev.index)))
    lib = _library()
    with torch.cuda.device(dev):  # the C side selects the same device
        err = lib.b2n_fwd(xb.data_ptr(), *[_ptr(a) for a in w], h.data_ptr(), cat.data_ptr(),
                          y.data_ptr(), o.data_ptr(), mask1.data_ptr(), cmask.data_ptr(),
                          b, t, cin, dilation, plan, dev.index,
                          torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, err, "forward")
    LAUNCHES["fwd"] += 1
    return y, o, (mask1, cmask)


def kernel_bwd(dy: torch.Tensor, o: torch.Tensor, masks: Tuple[torch.Tensor, torch.Tensor],
               p: B2NParams, dilation: int, cin: int) -> torch.Tensor:
    """Launch the dx kernels: (dy, o (B, T, 1024) bf16, the forward's masks) -> dx (B, T, Cin)."""
    _kernel_args(dy, cin, dilation)
    b, t, _ = dy.shape
    rows = b * t
    dev = dy.device
    dyb, ob = _bf(dy), o.contiguous()
    mask1, cmask = masks
    dcat = torch.empty((rows, CHAIN), dtype=torch.float32, device=dev)  # scratch
    dz1 = torch.empty((rows, PLANES), dtype=torch.bfloat16, device=dev)  # scratch
    dx = torch.empty((b, t, cin), dtype=torch.bfloat16, device=dev)
    wp = packed_weights(p, backward=True)
    w = [_f32(p.s1), wp["wc"], _f32(p.sc), _f32(p.s3), _f32(p.t3), wp["w3"], wp["w1"], wp["wr"]]
    plan = _plan_array(bwd_plan(b, t, cin, dilation, _sms(dev.index)))
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.b2n_bwd(dyb.data_ptr(), ob.data_ptr(), mask1.data_ptr(), cmask.data_ptr(),
                          *[_ptr(a) for a in w], dcat.data_ptr(), dz1.data_ptr(), dx.data_ptr(),
                          b, t, cin, dilation, plan, dev.index,
                          torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, err, "backward")
    LAUNCHES["bwd"] += 1
    return dx


# --------------------------------------------------------------------------
# Plain-torch version
# --------------------------------------------------------------------------

def _r(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in f32."""
    return t.to(torch.bfloat16).float()


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact products of bf16 values summed in f32 (TF32 off)."""
    with ieee_f32():
        return torch.matmul(a, w.detach().float())


def shift_time(a: torch.Tensor, k: int) -> torch.Tensor:
    """(B, T, C): out[:, t] = a[:, t + k], zero outside [0, T) (a conv tap)."""
    if k == 0:
        return a
    t = a.shape[1]
    return F.pad(a, (0, 0, abs(k), abs(k)))[:, abs(k) + k: abs(k) + k + t]


def _affine(z: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.relu(z) * s.float() + t.float()


def _chain(h: torch.Tensor, p: B2NParams, d: int):
    """The 7-conv chain on the f32 h -> the f32 sp_i planes."""
    sps, sp = [], None
    for i in range(NUMS):
        sl = slice(WIDTH * i, WIDTH * (i + 1))
        spin = h[..., sl] if i == 0 else sp + h[..., sl]
        z = p.bc[sl].float()
        for s in range(3):
            w = p.wc[(i * 3 + s) * WIDTH: (i * 3 + s + 1) * WIDTH]
            z = z + _mm(shift_time(_r(spin), (s - 1) * d), w)
        sp = _affine(z, p.sc[sl], p.tc[sl])
        sps.append(sp)
    return sps


def _conv1(xb: torch.Tensor, p: B2NParams):
    z = _mm(xb, p.w1)
    return z, _affine(z + p.b1.float(), p.s1, p.t1)


def reference_fwd(x: torch.Tensor, p: B2NParams, dilation: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' forward in plain torch -> (y, o), both (B, T, 1024) bf16."""
    xb = _r(x)
    _, h = _conv1(xb, p)
    cat = torch.cat([_r(sp) for sp in _chain(h, p, dilation)] + [_r(h[..., CHAIN:])], dim=-1)
    o = _affine(_mm(cat, p.w3) + p.b3.float(), p.s3, p.t3)
    res = xb if p.wr is None else _mm(xb, p.wr)
    return (o + res).to(torch.bfloat16), o.to(torch.bfloat16)


def reference_bwd(x: torch.Tensor, dy: torch.Tensor, o: torch.Tensor, p: B2NParams,
                  dilation: int) -> torch.Tensor:
    """The kernels' dx in plain torch, recomputing conv1 and the chain as
    the JAX kernel does -> (B, T, Cin) bf16."""
    xb = _r(x)
    z, h = _conv1(xb, p)
    sps = _chain(h, p, dilation)
    dyf = _r(dy)
    mask3 = o.float() != _r(p.t3)
    dq = _r(torch.where(mask3, dyf * p.s3.float(), 0.0))
    dcat = _mm(dq, p.w3.t())
    dh = [None] * NUMS + [dcat[..., CHAIN:]]
    carry = None
    for i in range(NUMS - 1, -1, -1):
        sl = slice(WIDTH * i, WIDTH * (i + 1))
        dsp = dcat[..., sl] if carry is None else dcat[..., sl] + carry
        dz = torch.where(sps[i] != p.tc[sl].float(), dsp * p.sc[sl].float(), 0.0)
        din = torch.zeros_like(dz)
        for s in range(3):
            w = p.wc[(i * 3 + s) * WIDTH: (i * 3 + s + 1) * WIDTH]
            din = din + _mm(shift_time(_r(dz), -(s - 1) * dilation), w.t())
        dh[i] = carry = din
    dz1 = torch.where(z + p.b1.float() > 0.0, torch.cat(dh, dim=-1) * p.s1.float(), 0.0)
    dx = _mm(_r(dz1), p.w1.t())
    dx = dx + (dyf if p.wr is None else _mm(dyf, p.wr.t()))
    return dx.to(torch.bfloat16)


# --------------------------------------------------------------------------
# autograd
# --------------------------------------------------------------------------

def _pool(y: torch.Tensor, pool: int) -> torch.Tensor:
    if not pool:
        return y
    b, t, c = y.shape
    return y.reshape(b, t // pool, pool, c).amax(dim=2)


def _unpool(y: torch.Tensor, out: torch.Tensor, g: torch.Tensor, pool: int) -> torch.Tensor:
    """The pool's backward: g to every slot equal to its window's max."""
    if not pool:
        return g.to(torch.bfloat16)
    b, t, c = y.shape
    yw = y.reshape(b, t // pool, pool, c)
    dy = torch.where(yw == out[:, :, None], g.to(torch.bfloat16)[:, :, None], 0.0)
    return dy.reshape(b, t, c)


class _FusedBottle2neck(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dilation, pool, use_kernel, *params):
        p = B2NParams(*params)
        ctx.dilation, ctx.pool, ctx.use_kernel, ctx.p = dilation, pool, use_kernel, p
        if use_kernel:
            y, o, masks = kernel_fwd(x, p, dilation)
        else:
            (y, o), masks = reference_fwd(x, p, dilation), None
        out = _pool(y, pool)
        ctx.masks = masks
        ctx.save_for_backward(x, y, o, out)
        return out

    @staticmethod
    def backward(ctx, g):
        if any(ctx.needs_input_grad[4:]):
            raise RuntimeError("fused_bottle2neck computes dx only (need_dw=False): its "
                               "parameters must not require grad")
        x, y, o, out = ctx.saved_tensors
        dy = _unpool(y, out, g, ctx.pool)
        if ctx.use_kernel:
            dx = kernel_bwd(dy, o, ctx.masks, ctx.p, ctx.dilation, x.shape[2])
        else:
            dx = reference_bwd(x, dy, o, ctx.p, ctx.dilation)
        return (dx.to(x.dtype), None, None, None) + (None,) * len(ctx.p)


def fused_bottle2neck(x: torch.Tensor, p: B2NParams, dilation: int, pool: int,
                      need_dw: bool = False) -> torch.Tensor:
    """Eval-mode Bottle2neck body + pool: x (B, T, Cin) -> bf16
    (B, T // pool, 1024) (or (B, T, 1024) for pool=0), pre-AFMS.

    A CUDA tensor runs the Hopper kernels (a failed build or launch
    raises); a CPU tensor runs the plain-torch version.
    """
    _validate(x, p, dilation, pool)
    if need_dw:
        raise NotImplementedError(
            "weight gradients of the fused Bottle2neck come with the training slice "
            "(ROADMAP.md, queue 1)")
    if x.is_cuda:
        use_kernel = True
    elif x.device.type == "cpu":
        use_kernel = False
    else:
        raise ValueError(f"no fused Bottle2neck implementation for device {x.device}")
    return _FusedBottle2neck.apply(x, dilation, pool, use_kernel, *p)


def fused_bottle2neck_reference(x: torch.Tensor, p: B2NParams, dilation: int,
                                pool: int) -> torch.Tensor:
    """The plain-torch version on any device (the kernels' check)."""
    _validate(x, p, dilation, pool)
    return _FusedBottle2neck.apply(x, dilation, pool, False, *p)
