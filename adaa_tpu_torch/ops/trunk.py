"""LCNN mid-trunk segments: conv1x1 + MFM, then conv3x3 + MFM + 2x2 max pool.

Replaces the TPU kernel ``adaa_tpu/ops/pallas_trunk.py``
(``fused_segment`` -> ``_conv3_op``: ``_fwd_kernel``, ``_bwd_kernel``)
with CUDA C++ kernels for Hopper (``adaa_tpu_torch/csrc/trunk.cu`` with
``csrc/hopper.cuh``, built by ``ops/_build.py``): implicit GEMMs on
wgmma with the packed weights resident in shared memory. The CUDA
source's header says what bounds them on an H100 and how the design
deals with that. This module decides what the kernels take and checks:
the weights packed as their wgmma B operands (``pack_weights``), the
tiles, bands and shared memory of each
launch (``fwd_plan``, ``bwd_plan``, ``fwd_tiles``, ``dx_tiles``).

What it computes, as the JAX op does (channels-last layouts, OIHW
weights with any eval-mode BN folded in by the caller):

* conv1x1 + MFM in plain torch, differentiated by autograd: bf16
  operands, f32 accumulation, f32 bias; the MFM output ``am`` stays f32
  (the port's default trunk rounds its conv store to bf16 before the
  bias instead, so the two paths are kept apart). ``torch.maximum``
  splits the gradient of a tie 1/2-1/2, as ``jnp.maximum`` does.
* conv3x3 (SAME) + MFM + floor 2x2 max pool as one op: ``am`` rounded
  to bf16, exact products summed in f32, the f32 bias, the maxima; f32
  out, cast to x's dtype. A forward whose ``am`` requires grad also
  writes the tie mask: per pooled output channel, bit ``4 pt + 2 pf + h``
  set where that candidate (pool position (pt, pf), MFM half h) equals
  the max. The backward is dx only and takes the mask and the cotangent:
  ``bf16(g / popcount)`` to each set candidate (ties split evenly), then
  the transposed conv with bf16 weights and f32 sums. A weight gradient
  raises (the JAX op poisons it with NaN).

Ties follow a different rule on each of the port's paths: here they
split evenly, layer 0 gives all to the lowest index, and the default
trunk's eqmask gives the full cotangent to every tie.

``fused_segment`` launches the kernels for a CUDA tensor and runs the
plain-torch version only for a CPU tensor; a CUDA tensor never falls
back. ``fused_segment_reference`` is the plain version itself, called
explicitly to check the kernels. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from adaa_tpu_torch.ops import _build
from adaa_tpu_torch.ops.layer0 import ieee_f32
from adaa_tpu_torch.ops.wgmma_layout import cdiv as _cdiv, operand_bytes, swizzle_operand

MAX_BATCH = 65_535  # the kernels count tiles (batch x tiles per sample) in 32-bit ints

LAUNCHES = {"fwd": 0, "bwd": 0}


class SegmentSpec(NamedTuple):
    t: int      # input time extent
    f: int      # input freq extent
    c_in: int
    c_mid: int  # conv1x1 output channels (MFM halves them)
    c_out: int  # conv3x3 output channels (MFM halves them)

    @property
    def c2(self) -> int:  # conv3x3 input channels
        return self.c_mid // 2

    @property
    def half(self) -> int:  # output channels
        return self.c_out // 2

    @property
    def t_out(self) -> int:
        return self.t // 2

    @property
    def f_out(self) -> int:
        return self.f // 2


SEGMENT_A = SegmentSpec(202, 40, 32, 64, 96)   # conv3 / conv6 + pool
SEGMENT_B = SegmentSpec(101, 20, 48, 96, 128)  # conv10 / conv13 + pool
SEGMENTS = (SEGMENT_A, SEGMENT_B)  # position = the kernels' segment id


def _segment_id(spec: SegmentSpec) -> int:
    if spec not in SEGMENTS:
        raise ValueError(f"the kernels are built for {SEGMENTS}, got {spec}")
    return SEGMENTS.index(spec)


def _validate(x, wa, ba, wb, bb, spec: SegmentSpec) -> None:
    _segment_id(spec)
    if (x.dim() != 4 or tuple(x.shape[1:]) != (spec.t, spec.f, spec.c_in)
            or not 1 <= x.shape[0] <= MAX_BATCH):
        raise ValueError(f"x must be (1 <= B <= {MAX_BATCH}, {spec.t}, {spec.f}, "
                         f"{spec.c_in}), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    shapes = {"wa": (tuple(wa.shape), (spec.c_mid, spec.c_in, 1, 1)),
              "ba": (tuple(ba.shape), (spec.c_mid,)),
              "wb": (tuple(wb.shape), (spec.c_out, spec.c2, 3, 3)),
              "bb": (tuple(bb.shape), (spec.c_out,))}
    for name, (got, want) in shapes.items():
        if got != want:
            raise ValueError(f"{name} must be {want}, got {got}")
    if any(t.device != x.device for t in (wa, ba, wb, bb)):
        raise ValueError("x and the weights must be on one device")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.bfloat16).float()


# --------------------------------------------------------------------------
# Kernel layouts and plans: csrc/trunk.cu takes what these give it, and
# checks it against its own constants
# --------------------------------------------------------------------------

SMEM_LIMIT = 232_448  # the shared memory one Hopper block may use
SMEM_ALIGN = 1024  # the 128-byte swizzle's period: the C side aligns its base
BARRIER_BYTES = 16
FWD_SUBTILE = 64  # pooled pixels per forward sub-tile: 32 per warpgroup
DX_SUBTILE = 128  # dx pixels per backward sub-tile: 64 per warpgroup
# sub-tiles per (forward, dx) tile of each segment: a tile's sub-tiles share
# one band, so larger tiles stage fewer halo rows per pixel, as far as shared
# memory allows (segment B's weights take half of it)
SUBTILES = ((2, 2), (1, 1))
PIXEL_PAD = 16  # bytes after a staged pixel: an odd number of 16-byte units per pixel


class FwdPlan(NamedTuple):
    """The forward's launch: ``grid`` persistent blocks walk ``batch x tiles``
    tiles of ``tile`` pooled pixels (``fwd_tiles``); a block holds the packed
    weights, an f32 staging buffer of ``stage_bytes`` and the bf16 band of
    ``band_rows`` input rows."""

    tile: int
    tiles: int
    grid: int
    band_rows: int
    stage_bytes: int
    smem_bytes: int


class BwdPlan(NamedTuple):
    """The dx launch: tiles of ``tile`` dx pixels (``dx_tiles``); a block holds
    the packed weights, ``g_rows`` pooled rows of g and the mask, and the bf16
    dy band of ``dy_rows`` rows (with the halo)."""

    tile: int
    tiles: int
    grid: int
    dy_rows: int
    g_rows: int
    smem_bytes: int


def fwd_tile(spec: SegmentSpec) -> int:
    """Pooled pixels per forward tile."""
    return SUBTILES[_segment_id(spec)][0] * FWD_SUBTILE


def dx_tile(spec: SegmentSpec) -> int:
    """dx pixels per backward tile."""
    return SUBTILES[_segment_id(spec)][1] * DX_SUBTILE


def _fwd_span(spec: SegmentSpec) -> int:
    """Pooled rows that a forward tile's consecutive pooled pixels span at most."""
    return (spec.f_out - 1 + fwd_tile(spec) - 1) // spec.f_out + 1


def _dx_span(spec: SegmentSpec) -> int:
    """dx rows that a dx tile's consecutive pixels span at most."""
    return (spec.f - 1 + dx_tile(spec) - 1) // spec.f + 1


def fwd_plan(spec: SegmentSpec, batch: int, sms: int) -> FwdPlan:
    band_rows = 2 * _fwd_span(spec) + 2  # conv rows and their halo
    stage = band_rows * spec.f * spec.c2 * 4
    band = band_rows * (spec.f + 2) * (2 * spec.c2 + PIXEL_PAD)
    smem = operand_bytes(spec.c_out, 9 * spec.c2) + stage + band + BARRIER_BYTES + SMEM_ALIGN
    tile = fwd_tile(spec)
    tiles = _cdiv(spec.t_out * spec.f_out, tile)
    return FwdPlan(tile, tiles, min(batch * tiles, sms), band_rows, stage, smem)


def bwd_plan(spec: SegmentSpec, batch: int, sms: int) -> BwdPlan:
    dy_rows = _dx_span(spec) + 2
    g_rows = dy_rows // 2 + 1
    band = dy_rows * (spec.f + 2) * (2 * spec.c_out + PIXEL_PAD)
    g_bytes = g_rows * spec.f_out * spec.half * 5  # f32 g and the uint8 mask
    smem = operand_bytes(spec.c2, 9 * spec.c_out) + g_bytes + band + BARRIER_BYTES + SMEM_ALIGN
    tile = dx_tile(spec)
    tiles = _cdiv(spec.t * spec.f, tile)
    return BwdPlan(tile, tiles, min(batch * tiles, sms), dy_rows, g_rows, smem)


class FwdTile(NamedTuple):
    p0: int     # first pooled pixel of the sample
    np: int     # pooled pixels
    r0: int     # input row of band row 0
    s_lo: int   # input rows [s_lo, s_hi) staged from the image
    s_hi: int


class DxTile(NamedTuple):
    p0: int     # first dx pixel of the sample
    np: int
    d_lo: int   # dy row of band row 0
    e_lo: int   # dy rows [e_lo, e_hi] formed from g and the mask
    e_hi: int
    g_lo: int   # pooled rows [g_lo, g_lo + g_rows) staged
    g_rows: int


def fwd_tiles(spec: SegmentSpec) -> List[FwdTile]:
    """One sample's forward tiles, as the kernel cuts them."""
    n, tile = spec.t_out * spec.f_out, fwd_tile(spec)
    out = []
    for p0 in range(0, n, tile):
        np_ = min(tile, n - p0)
        tp_lo, tp_hi = p0 // spec.f_out, (p0 + np_ - 1) // spec.f_out
        r0 = 2 * tp_lo - 1
        out.append(FwdTile(p0, np_, r0, max(r0, 0), min(2 * tp_hi + 3, spec.t)))
    return out


def dx_tiles(spec: SegmentSpec) -> List[DxTile]:
    """One sample's dx tiles, as the kernel cuts them."""
    n, tile = spec.t * spec.f, dx_tile(spec)
    out = []
    for p0 in range(0, n, tile):
        np_ = min(tile, n - p0)
        t_lo, t_hi = p0 // spec.f, (p0 + np_ - 1) // spec.f
        e_lo, e_hi = max(t_lo - 1, 0), min(t_hi + 1, 2 * spec.t_out - 1)
        out.append(DxTile(p0, np_, t_lo - 1, e_lo, e_hi, e_lo // 2, e_hi // 2 - e_lo // 2 + 1))
    return out


def forward_columns(spec: SegmentSpec) -> torch.Tensor:
    """The conv channel of each forward accumulator column n = 8 j + 2 q + e:
    e * half + q * (c_out / 8) + j, so an MFM pair sits in adjacent columns
    and a thread's (q's) pooled channels are contiguous."""
    n = torch.arange(spec.c_out)
    j, q, e = n // 8, (n % 8) // 2, n % 2
    return e * spec.half + q * (spec.c_out // 8) + j


def forward_layout(w: torch.Tensor, spec: SegmentSpec) -> torch.Tensor:
    """OIHW (c_out, c2, 3, 3) -> the forward's B operand (c_out, 9 c2): row n
    holds conv channel ``forward_columns(spec)[n]``, k = (3 dt + df) c2 + ci."""
    w = w[forward_columns(spec).to(w.device)]
    return w.permute(0, 2, 3, 1).reshape(spec.c_out, 9 * spec.c2)


def backward_layout(w: torch.Tensor, spec: SegmentSpec) -> torch.Tensor:
    """OIHW (c_out, c2, 3, 3) -> the dx product's B operand (c2, 9 c_out):
    k = (3 dt + df) c_out + co."""
    return w.permute(1, 2, 3, 0).reshape(spec.c2, 9 * spec.c_out)


@functools.lru_cache(maxsize=None)
def _pack_index(spec: SegmentSpec, backward: bool, device: torch.device) -> torch.Tensor:
    """For each element of a packed image, its index in the flat OIHW weight
    (0 in the k padding, which no k-step reads); made once per segment,
    direction and device, so that a packing is one gather on the device."""
    ids = torch.arange(1, spec.c_out * spec.c2 * 9 + 1).reshape(spec.c_out, spec.c2, 3, 3)
    layout = backward_layout if backward else forward_layout
    return (swizzle_operand(layout(ids, spec).contiguous()) - 1).clamp(min=0).to(device)


def pack_weights(wb: torch.Tensor, spec: SegmentSpec, backward: bool) -> torch.Tensor:
    """The bf16 weights as the shared-memory image of the forward's (or,
    with ``backward``, the dx product's) B operand, flat."""
    return torch.take(wb.detach().to(torch.bfloat16), _pack_index(spec, backward, wb.device))


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

_PTR, _I32, _PLAN = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
# the C functions' parameters: pointers, batch, segment, the plan, the device,
# the stream
ARGTYPES = {"trunk_fwd": [_PTR] * 5 + [_I32] * 2 + [_PLAN, _I32, _PTR],
            "trunk_bwd": [_PTR] * 4 + [_I32] * 2 + [_PLAN, _I32, _PTR]}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("trunk")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I32
    lib.trunk_error_string.argtypes = [_I32]
    lib.trunk_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _plan_array(spec: SegmentSpec, backward: bool, batch: int, index: int):
    """The plan of one launch as the C side takes it (made once per shape)."""
    plan = (bwd_plan if backward else fwd_plan)(spec, batch, _sms(index))
    return (ctypes.c_int * len(plan))(*plan)


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"trunk {what} launch failed: CUDA error {err} "
                           f"({lib.trunk_error_string(err).decode()})")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned start, as the bulk copies need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def kernel_fwd(am: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor, spec: SegmentSpec,
               with_mask: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward: am (B, T, F, c2) -> (out (B, T/2, F/2, half) f32,
    the tie mask (same shape, uint8) with ``with_mask``, else None)."""
    if not am.is_cuda:
        raise ValueError("kernel_fwd takes CUDA tensors")
    seg = _segment_id(spec)
    am = _aligned(am.detach().float())
    wpk = pack_weights(wb, spec, backward=False)
    bias = bb.detach().float().contiguous()
    b = am.shape[0]
    shape = (b, spec.t_out, spec.f_out, spec.half)
    out = torch.empty(shape, dtype=torch.float32, device=am.device)
    mask = torch.empty(shape, dtype=torch.uint8, device=am.device) if with_mask else None
    plan = _plan_array(spec, False, b, am.device.index)
    lib = _library()
    with torch.cuda.device(am.device):  # the C side selects the same device
        err = lib.trunk_fwd(am.data_ptr(), wpk.data_ptr(), bias.data_ptr(), out.data_ptr(),
                            None if mask is None else mask.data_ptr(), b, seg, plan,
                            am.device.index, torch.cuda.current_stream(am.device).cuda_stream)
    _check(lib, err, "forward")
    LAUNCHES["fwd"] += 1
    return out, mask


def kernel_bwd(mask: torch.Tensor, g: torch.Tensor, wb: torch.Tensor, spec: SegmentSpec,
               wpk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the dx kernel: (the forward's tie mask, cotangent, both (B, T/2,
    F/2, half)) -> dx (B, T, F, c2) f32. ``wpk``: the packed backward
    weights, if the caller has them."""
    if not (mask.is_cuda and g.is_cuda):
        raise ValueError("kernel_bwd takes CUDA tensors")
    seg = _segment_id(spec)
    b = g.shape[0]
    shape = (b, spec.t_out, spec.f_out, spec.half)
    if tuple(g.shape) != shape or tuple(mask.shape) != shape or mask.dtype != torch.uint8:
        raise ValueError(f"g and the uint8 mask must be {shape}")
    g, mask = _aligned(g.float()), _aligned(mask)
    if wpk is None:
        wpk = pack_weights(wb, spec, backward=True)
    dx = torch.empty((b, spec.t, spec.f, spec.c2), dtype=torch.float32, device=g.device)
    plan = _plan_array(spec, True, b, g.device.index)
    lib = _library()
    with torch.cuda.device(g.device):
        err = lib.trunk_bwd(g.data_ptr(), mask.data_ptr(), wpk.data_ptr(), dx.data_ptr(), b,
                            seg, plan, g.device.index,
                            torch.cuda.current_stream(g.device).cuda_stream)
    _check(lib, err, "backward")
    LAUNCHES["bwd"] += 1
    return dx


# --------------------------------------------------------------------------
# Plain-torch version
# --------------------------------------------------------------------------

def _candidates(am: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor,
                spec: SegmentSpec) -> torch.Tensor:
    """Conv outputs + bias that reach the floor pool, as
    (B, h, half, t_out, pt, f_out, pf): full f32 on exact bf16 products."""
    b = am.shape[0]
    with ieee_f32():
        y = F.conv2d(_bf16(am).permute(0, 3, 1, 2), _bf16(wb), padding=1)
    y = y[:, :, : 2 * spec.t_out, : 2 * spec.f_out] + bb.detach().float()[:, None, None]
    return y.reshape(b, 2, spec.half, spec.t_out, 2, spec.f_out, 2)


# bit 4 pt + 2 pf + h of a candidate, laid out as _candidates' (h, pt, pf) axes
_BIT_WEIGHTS = (2 ** (4 * torch.arange(2)[None, :, None] + 2 * torch.arange(2)[None, None, :]
                      + torch.arange(2)[:, None, None])).to(torch.int32)


def _pool_and_mask(am, wb, bb, spec: SegmentSpec, with_mask: bool):
    y = _candidates(am, wb, bb, spec)
    pool = y.amax(dim=(1, 4, 6), keepdim=True)
    out = pool.reshape(am.shape[0], spec.half, spec.t_out, spec.f_out).permute(0, 2, 3, 1)
    if not with_mask:
        return out.contiguous(), None
    w = _BIT_WEIGHTS.to(am.device)[None, :, None, None, :, None, :]  # (1, h, 1, 1, pt, 1, pf)
    mask = ((y == pool).to(torch.int32) * w).sum(dim=(1, 4, 6))  # (B, half, t_out, f_out)
    return out.contiguous(), mask.permute(0, 2, 3, 1).to(torch.uint8).contiguous()


def reference_fwd(am: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor,
                  spec: SegmentSpec) -> torch.Tensor:
    """The kernel's forward in plain torch -> (B, T/2, F/2, half) f32."""
    return _pool_and_mask(am, wb, bb, spec, False)[0]


def reference_mask(am: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor,
                   spec: SegmentSpec) -> torch.Tensor:
    """The tie mask in plain torch: (B, T/2, F/2, half) uint8, bit
    4 pt + 2 pf + h set where that candidate equals the pooled max."""
    return _pool_and_mask(am, wb, bb, spec, True)[1]


def reference_dy(mask: torch.Tensor, g: torch.Tensor, spec: SegmentSpec) -> torch.Tensor:
    """The conv-output cotangent from the mask: bf16(g / popcount) on the
    set candidates, else 0 -> (B, c_out, T, F) f32 (the rows and columns
    the floor pool drops are 0)."""
    b = g.shape[0]
    m = mask.to(torch.int32).permute(0, 3, 1, 2)  # (B, half, t_out, f_out)
    bits = torch.stack([(m >> k) & 1 for k in range(8)], dim=-1)  # (..., bit)
    cnt = bits.sum(dim=-1).clamp(min=1).float()
    inv = (g.float().permute(0, 3, 1, 2) / cnt).to(torch.bfloat16).float()
    # bit 4 pt + 2 pf + h -> (B, half, t_out, f_out, pt, pf, h)
    sel = bits.reshape(b, spec.half, spec.t_out, spec.f_out, 2, 2, 2).float()
    dy = sel * inv[..., None, None, None]
    dy = dy.permute(0, 6, 1, 2, 4, 3, 5).reshape(b, spec.c_out, 2 * spec.t_out, 2 * spec.f_out)
    return F.pad(dy, (0, spec.f - 2 * spec.f_out, 0, spec.t - 2 * spec.t_out))


def reference_dx(mask: torch.Tensor, g: torch.Tensor, wb: torch.Tensor,
                 spec: SegmentSpec) -> torch.Tensor:
    """dx from the mask and the cotangent: the f32 transposed conv of the
    bf16 dy with the bf16 weights -> (B, T, F, c2) f32."""
    with ieee_f32():
        dx = F.conv_transpose2d(reference_dy(mask, g, spec), _bf16(wb), padding=1)
    return dx.permute(0, 2, 3, 1).contiguous()


def reference_bwd(am: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor, g: torch.Tensor,
                  spec: SegmentSpec) -> torch.Tensor:
    """The kernels' dx in plain torch, from am: its mask, then dx."""
    return reference_dx(reference_mask(am, wb, bb, spec), g, wb, spec)


# --------------------------------------------------------------------------
# autograd
# --------------------------------------------------------------------------

class _Conv3MfmPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, am, wb, bb, spec, use_kernel):
        ctx.spec, ctx.use_kernel = spec, use_kernel
        with_mask = ctx.needs_input_grad[0]  # no mask for a forward without grad
        if use_kernel:
            out, mask = kernel_fwd(am, wb, bb, spec, with_mask)
            # packed once per forward, kept for the backward
            ctx.wpk = pack_weights(wb, spec, backward=True) if with_mask else None
        else:
            out, mask = _pool_and_mask(am, wb, bb, spec, with_mask)
        if with_mask:
            ctx.save_for_backward(mask, wb.detach())
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            raise RuntimeError(
                "fused_segment computes dx only (need_dw=False): its conv3x3 "
                "weight and bias must not require grad"
            )
        mask, wb = ctx.saved_tensors
        if ctx.use_kernel:
            dx = kernel_bwd(mask, g, wb, ctx.spec, ctx.wpk)
        else:
            dx = reference_dx(mask, g, wb, ctx.spec)
        return dx, None, None, None, None


def _segment(x, wa, ba, wb, bb, spec: SegmentSpec, use_kernel: bool) -> torch.Tensor:
    wa2 = wa.to(torch.bfloat16).float().reshape(spec.c_mid, spec.c_in)
    with ieee_f32():  # exact bf16 products, f32 sums
        acc = torch.matmul(x.to(torch.bfloat16).float(), wa2.T) + ba.float()
    am = torch.maximum(acc[..., : spec.c2], acc[..., spec.c2:])  # f32, not rounded
    return _Conv3MfmPool.apply(am, wb, bb, spec, use_kernel).to(x.dtype)


def fused_segment(x: torch.Tensor, wa: torch.Tensor, ba: torch.Tensor, wb: torch.Tensor,
                  bb: torch.Tensor, spec: SegmentSpec, need_dw: bool = False) -> torch.Tensor:
    """(B, T, F, c_in) -> (B, T/2, F/2, c_out/2) in x's dtype.

    wa OIHW (c_mid, c_in, 1, 1), wb OIHW (c_out, c_mid/2, 3, 3). A CUDA
    tensor runs the Hopper kernels (a failed build or launch raises); a
    CPU tensor runs the plain-torch version.
    """
    _validate(x, wa, ba, wb, bb, spec)
    if need_dw:
        raise NotImplementedError(
            "weight gradients of the fused trunk segment come with the training "
            "slice (ROADMAP.md, queue 1)"
        )
    if x.is_cuda:
        use_kernel = True
    elif x.device.type == "cpu":
        use_kernel = False
    else:
        raise ValueError(f"no fused trunk implementation for device {x.device}")
    return _segment(x, wa, ba, wb, bb, spec, use_kernel)


def fused_segment_reference(x: torch.Tensor, wa: torch.Tensor, ba: torch.Tensor,
                            wb: torch.Tensor, bb: torch.Tensor,
                            spec: SegmentSpec) -> torch.Tensor:
    """The plain-torch version on any device (the kernels' check)."""
    _validate(x, wa, ba, wb, bb, spec)
    return _segment(x, wa, ba, wb, bb, spec, False)
