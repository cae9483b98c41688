"""LCNN's fused first block: conv 5x5 (1 -> 64, pad 2) + MFM + 2x2 max pool.

Replaces the TPU kernel ``adaa_tpu/ops/pallas_layer0.py``
(``fused_conv0_mfm_pool``: ``_fwd_kernel``, ``_fwd_mask_kernel``,
``_bwd_kernel``) with CUDA C++ kernels for Hopper
(``adaa_tpu_torch/csrc/layer0.cu`` with ``csrc/hopper.cuh``, built by
``ops/_build.py``): the forward an implicit GEMM on wgmma, the dx a
wgmma product into tap space and a col2im in shared memory. The CUDA
source's header says what bounds them on an H100 and how the design
deals with that. This module decides what the kernels take: the
weights packed as their wgmma B operands (``pack_weights``, once per
weight tensor and version), the tiles and shared memory of each launch
(``fwd_plan``, ``bwd_plan``, ``fwd_tiles``, ``dx_tiles``); the C side
refuses a plan that breaks its constants.

What it computes, as the JAX op does (layouts included):

* forward: x (B, 404, 80) bf16 or f32 -> (B, 202, 40, 32) in x's dtype.
  x and the weights are rounded to bf16, the products accumulate in f32
  and the f32 bias is added. When a gradient is needed it also writes a
  winner index (uint8): the argmax over a pooled output's 8 candidates
  c = 4 * t_parity + 2 * f_parity + mfm_half, lowest c on exact ties.
* backward: dx only. The cotangent is rounded to bf16 and sent whole to
  the winner; dx accumulates in f32 and is stored in x's dtype. A
  weight gradient raises (the JAX op poisons it with NaN).

``fused_conv0_mfm_pool`` launches the kernel for a CUDA tensor and runs
the plain-torch twin only for a CPU tensor; a CUDA tensor never falls
back. ``fused_conv0_mfm_pool_reference`` is the twin itself, called
explicitly to check the kernel. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from adaa_tpu_torch.ops import _build, wgmma_layout

T_IN, F_IN = 404, 80
T_OUT, F_OUT = T_IN // 2, F_IN // 2
C_CONV, C_OUT, K = 64, 32, 5
MAX_BATCH = 65_535  # the kernels count tiles (batch x tiles per sample) in 32-bit ints

LAUNCHES = {"fwd": 0, "bwd": 0}


@contextlib.contextmanager
def ieee_f32():
    """Full-f32 convolutions and matmuls on CUDA (cuDNN defaults to TF32,
    which would round the twin's exact bf16 products)."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def bf16_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in bf16 units in the last place (0 = bit-equal
    up to the sign of zero), for checking the kernel against its twin."""

    def ordered(t):
        bits = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(a) - ordered(b)).abs()


def _validate(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dim() != 3 or tuple(x.shape[1:]) != (T_IN, F_IN) or not 1 <= x.shape[0] <= MAX_BATCH:
        raise ValueError(f"x must be (1 <= B <= {MAX_BATCH}, {T_IN}, {F_IN}), "
                         f"got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if tuple(w.shape) != (C_CONV, 1, K, K) or tuple(bias.shape) != (C_CONV,):
        raise ValueError(f"w must be ({C_CONV}, 1, {K}, {K}) and bias ({C_CONV},)")
    if w.device != x.device or bias.device != x.device:
        raise ValueError("x, w and bias must be on one device")


# --------------------------------------------------------------------------
# Kernel layouts and plans: csrc/layer0.cu takes what these give it, and
# checks it against its own constants
# --------------------------------------------------------------------------

TAPS = K * K
SMEM_LIMIT = 232_448  # the shared memory one Hopper block may use
SMEM_ALIGN = 1024  # the 128-byte swizzle's period: the C side aligns its base
BARRIER_BYTES = 16
THREADS = 256  # two warpgroups
BLOCKS_PER_SM = 2  # both kernels' __launch_bounds__
FWD_TILE = 256  # pooled pixels per forward tile
FWD_SUBTILE = 32  # pooled pixels per warpgroup product
BAND_PAD = 8  # zero bf16 columns on each side of the forward's band
BAND_PITCH = F_IN + 2 * BAND_PAD
W_TAB_BYTES = C_CONV * TAPS * 4  # the forward's fix-up table: bf16-rounded weights as f32
DX_ROWS, DX_COLS = 8, F_IN // 2  # a dx tile: 8 rows x one half of the columns
DP_ROWS, DP_COLS = DX_ROWS // 2 + 2, DX_COLS // 2 + 1  # pooled pixels whose 6x6 blocks reach it
D_N, D_PITCH = 48, 36  # a pooled pixel's 36 dx offsets: the product's width, the f32 pitch
DX_K = 4 * C_CONV  # (conv row, conv column, conv channel) of a pooled pixel
W_FWD_BYTES = wgmma_layout.operand_bytes(C_CONV, 32)  # 64 rows x 32 k, k padded to 64
STAGES = 2  # forward staging buffers: the next two tiles' rows are in flight
SCALE_BYTES = FWD_TILE * 4 + 64 * 4  # the fix-up's pixel scales and 6x6 patch weights
W_DX_BYTES = wgmma_layout.operand_bytes(D_N, DX_K)  # 48 dx offsets x 256


class FwdPlan(NamedTuple):
    """The forward's launch: ``grid`` persistent blocks walk ``batch x tiles``
    tiles of ``tile`` pooled pixels (``fwd_tiles``); a block holds the packed
    weights, two staging buffers of ``stage_bytes`` (a tile's input rows, f32
    at most), the band of ``band_rows`` input rows as quads (rows r, r + 1 x
    columns c, c + 1 in bf16), the fix-up's f32 weight table and its scales."""

    tile: int
    tiles: int
    grid: int
    band_rows: int
    stage_bytes: int
    smem_bytes: int


class BwdPlan(NamedTuple):
    """The dx launch: tiles of ``rows`` dx rows x one half of the columns
    (``dx_tiles``); a block holds the packed weights and the D tile: the 6x6
    dx blocks (f32) of ``d_rows`` x ``d_cols`` pooled pixels."""

    rows: int
    tiles: int
    grid: int
    d_rows: int
    d_cols: int
    smem_bytes: int


def _span() -> int:
    """Pooled rows that a forward tile's consecutive pooled pixels span at most."""
    return (F_OUT - 1 + FWD_TILE - 1) // F_OUT + 1


def fwd_plan(batch: int, sms: int) -> FwdPlan:
    band_rows = 2 * _span() + 4  # conv rows and the 2-row halo
    stage = band_rows * F_IN * 4
    band = band_rows * BAND_PITCH * 8  # a quad of 4 bf16 per (row, column)
    smem = (W_FWD_BYTES + STAGES * stage + band + W_TAB_BYTES + SCALE_BYTES
            + STAGES * BARRIER_BYTES + SMEM_ALIGN)
    tiles = wgmma_layout.cdiv(T_OUT * F_OUT, FWD_TILE)
    return FwdPlan(FWD_TILE, tiles, min(batch * tiles, BLOCKS_PER_SM * sms), band_rows, stage,
                   smem)


def bwd_plan(batch: int, sms: int) -> BwdPlan:
    smem = W_DX_BYTES + DP_ROWS * DP_COLS * D_PITCH * 4 + SMEM_ALIGN
    tiles = 2 * wgmma_layout.cdiv(T_IN, DX_ROWS)
    return BwdPlan(DX_ROWS, tiles, min(batch * tiles, BLOCKS_PER_SM * sms), DP_ROWS, DP_COLS,
                   smem)


class FwdTile(NamedTuple):
    p0: int    # first pooled pixel of the sample
    np: int    # pooled pixels
    tp_lo: int  # first pooled row
    r0: int    # input row of band row 0
    s_lo: int  # input rows [s_lo, s_hi) staged from the image
    s_hi: int


class DxTile(NamedTuple):
    t0: int   # first dx row
    f0: int   # first dx column
    pr0: int  # pooled row of D tile row 0
    pcb: int  # pooled column of D tile column 0


def fwd_tiles() -> List[FwdTile]:
    """One sample's forward tiles, as the kernel cuts them."""
    n, out = T_OUT * F_OUT, []
    for p0 in range(0, n, FWD_TILE):
        np_ = min(FWD_TILE, n - p0)
        tp_lo, tp_hi = p0 // F_OUT, (p0 + np_ - 1) // F_OUT
        r0 = 2 * tp_lo - 2
        out.append(FwdTile(p0, np_, tp_lo, r0, max(r0, 0), min(2 * tp_hi + 4, T_IN)))
    return out


def dx_tiles() -> List[DxTile]:
    """One sample's dx tiles, as the kernel cuts them (tile 2 rt + half)."""
    return [DxTile(DX_ROWS * rt, DX_COLS * half, DX_ROWS // 2 * rt - 1,
                   F_OUT // 2 - 1 if half else 0)
            for rt in range(wgmma_layout.cdiv(T_IN, DX_ROWS)) for half in range(2)]


def fragment_taps(q: int) -> List[int]:
    """The taps k = 16 kk + 8 hh + 2 q + e of a thread's A fragment, in the
    order (kk, hh, e); taps 25..31 are the zero padding of K."""
    return [16 * kk + 8 * hh + 2 * q + e for kk in range(2) for hh in range(2) for e in range(2)]


def forward_columns() -> torch.Tensor:
    """The conv channel of each forward accumulator column n = 8 j + 2 q + e:
    32 e + 8 q + j, so an MFM pair sits in adjacent columns and a thread's
    (q's) pooled channels 8 q .. 8 q + 7 are contiguous."""
    n = torch.arange(C_CONV)
    j, q, e = n // 8, (n % 8) // 2, n % 2
    return e * C_OUT + q * 8 + j


def backward_k() -> Tuple[torch.Tensor, torch.Tensor]:
    """Each k = 16 kk + 8 hh + 2 q + e of the dx product, kk = 4 pp + kc:
    (the pooled pixel's conv output pp = 2 pt + pf, the conv channel 32 e +
    8 q + 2 kc + hh), so a fragment register holds both MFM halves of one
    pooled channel of one conv output, and a thread's pooled channels are
    8 q .. 8 q + 7."""
    k = torch.arange(DX_K)
    kk, hh, q, e = k // 16, (k % 16) // 8, (k % 8) // 2, k % 2
    return kk // 4, e * C_OUT + q * 8 + 2 * (kk % 4) + hh


def forward_layout(w: torch.Tensor) -> torch.Tensor:
    """OIHW (64, 1, 5, 5) -> the forward's B operand (64, 32): row n holds
    conv channel ``forward_columns()[n]``, k = 5 dt + df, zero past 25."""
    w = w.reshape(C_CONV, TAPS)[forward_columns().to(w.device)]
    return F.pad(w, (0, 32 - TAPS))


def backward_layout(w: torch.Tensor) -> torch.Tensor:
    """OIHW (64, 1, 5, 5) -> the dx product's B operand (48, 256): row n =
    6 a + b (zero past 36) is the offset (a, b) in a pooled pixel's 6x6 dx
    block, whose rows and columns start 2 before its conv outputs'; k is
    ``backward_k()``'s (pp, channel), and the value the channel's tap
    (a - pt, b - pf), zero outside the 5x5 kernel."""
    pp, ch = backward_k()
    n = torch.arange(36)
    dt = (n // 6)[:, None] - (pp // 2)[None, :]
    df = (n % 6)[:, None] - (pp % 2)[None, :]
    inside = (dt >= 0) & (dt < K) & (df >= 0) & (df < K)
    tap = (dt.clamp(0, K - 1) * K + df.clamp(0, K - 1)).to(w.device)
    vals = w.reshape(C_CONV, TAPS)[ch.to(w.device)[None, :].expand(36, -1), tap]
    vals = torch.where(inside.to(w.device), vals, torch.zeros((), dtype=w.dtype, device=w.device))
    return F.pad(vals, (0, 0, 0, D_N - 36))


def pack_weights(w: torch.Tensor, backward: bool) -> torch.Tensor:
    """The bf16 weights as the shared-memory image of the forward's (or,
    with ``backward``, the dx product's) B operand, flat."""
    w = w.detach().to(torch.bfloat16)
    return wgmma_layout.swizzle_operand(backward_layout(w) if backward else forward_layout(w))


_PACKED: "OrderedDict" = OrderedDict()


def _operands(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (pack_weights(w, False), pack_weights(w, True),
            w.detach().float().contiguous())


def packed_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(forward image, backward image, the f32 weights the forward's fix-up
    reads) of ``w``, made once per weight tensor and version: the PGD steps
    reuse them. The entry keeps the weight's storage alive, so its address
    cannot name other weights."""
    if w.is_inference():  # no version counter to key on
        return _operands(w)
    key = (w.data_ptr(), w.device, w._version, w.dtype)
    hit = _PACKED.get(key)
    if hit is None:
        hit = (w.untyped_storage(), *_operands(w))
        _PACKED[key] = hit
        while len(_PACKED) > 8:
            _PACKED.popitem(last=False)
    return hit[1:]


def raw_stream(dev: torch.device) -> int:
    """The current CUDA stream of ``dev`` as the handle the C side takes
    (torch's own accessor, without building a Stream object per launch)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def device_scope(dev: torch.device):
    """The device the C side will select, made current for its call (and
    restored after) unless it already is: entering torch.cuda.device costs
    more host time than the launch."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

_PTR, _I32, _PLAN = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
# the C functions' parameters: pointers, batch, dtype flag, the plan, the
# device, the stream
ARGTYPES = {"layer0_fwd": [_PTR] * 6 + [_I32] * 2 + [_PLAN, _I32, _PTR],
            "layer0_bwd": [_PTR] * 4 + [_I32] * 2 + [_PLAN, _I32, _PTR]}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("layer0")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I32
    lib.layer0_error_string.argtypes = [_I32]
    lib.layer0_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _plan_array(backward: bool, batch: int, index: int):
    """The plan of one launch as the C side takes it (made once per shape)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    plan = (bwd_plan if backward else fwd_plan)(batch, sms)
    return (ctypes.c_int * len(plan))(*plan)


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"layer0 {what} launch failed: CUDA error {err} "
            f"({lib.layer0_error_string(err).decode()})"
        )


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned start, as the kernels' loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def kernel_fwd(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               with_index: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel on x's current stream -> (out, idx or None)."""
    if not x.is_cuda:
        raise ValueError("kernel_fwd takes CUDA tensors")
    x = _aligned(x)
    wpk, _, w32 = packed_weights(w)
    if bias.dtype != torch.float32 or not bias.is_contiguous():
        bias = bias.float().contiguous()
    b = x.shape[0]
    shape = (b, T_OUT, F_OUT, C_OUT)
    out = x.new_empty(shape)
    idx = x.new_empty(shape, dtype=torch.uint8) if with_index else None
    lib = _library()
    with device_scope(x.device):  # the C side selects the same device
        err = lib.layer0_fwd(
            x.data_ptr(), wpk.data_ptr(), w32.data_ptr(), bias.data_ptr(), out.data_ptr(),
            idx.data_ptr() if idx is not None else None,
            b, int(x.dtype == torch.bfloat16), _plan_array(False, b, x.device.index),
            x.device.index, raw_stream(x.device),
        )
    _check(lib, err, "forward")
    LAUNCHES["fwd"] += 1
    return out, idx


def kernel_bwd(idx: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Launch the dx kernel: (idx, cotangent (B, 202, 40, 32)) -> dx (B, 404, 80)."""
    if not (idx.is_cuda and g.is_cuda):
        raise ValueError("kernel_bwd takes CUDA tensors")
    if idx.dtype != torch.uint8 or tuple(idx.shape) != tuple(g.shape):
        raise ValueError("idx must be uint8 with the cotangent's shape")
    g = _aligned(g if g.dtype == dtype else g.to(dtype))
    idx = _aligned(idx)
    wpk = packed_weights(w)[1]
    b = g.shape[0]
    dx = g.new_empty((b, T_IN, F_IN))
    lib = _library()
    with device_scope(g.device):
        err = lib.layer0_bwd(
            idx.data_ptr(), g.data_ptr(), wpk.data_ptr(), dx.data_ptr(),
            b, int(dtype == torch.bfloat16), _plan_array(True, b, g.device.index),
            g.device.index, raw_stream(g.device),
        )
    _check(lib, err, "backward")
    LAUNCHES["bwd"] += 1
    return dx


# --------------------------------------------------------------------------
# Plain-torch twin
# --------------------------------------------------------------------------

def reference_fwd(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  with_index: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's forward in plain torch: an f32 conv of bf16-rounded
    operands (exact products), + bias, then the 8-candidate max."""
    b = x.shape[0]
    with ieee_f32():
        y = F.conv2d(
            x.to(torch.bfloat16).float()[:, None],
            w.detach().to(torch.bfloat16).float(),
            padding=K // 2,
        ) + bias.detach().float()[None, :, None, None]  # (B, 64, 404, 80)
    # (B, half, ch, t', t_parity, f', f_parity) -> (B, t', f', ch, 8)
    cand = (y.reshape(b, 2, C_OUT, T_OUT, 2, F_OUT, 2)
             .permute(0, 3, 5, 2, 4, 6, 1)
             .reshape(b, T_OUT, F_OUT, C_OUT, 8))
    out = cand.amax(dim=-1).to(x.dtype)
    # argmax returns the first maximal index: the lowest c on ties
    idx = cand.argmax(dim=-1).to(torch.uint8) if with_index else None
    return out, idx


def reference_bwd(idx: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """The kernel's dx in plain torch: the bf16 cotangent routed to the
    winner, then an f32 transposed conv."""
    b = g.shape[0]
    gq = g.to(torch.bfloat16).float()
    onehot = idx[..., None].long() == torch.arange(8, device=g.device)
    dcand = torch.where(onehot, gq[..., None], torch.zeros((), device=g.device))
    dy = (dcand.reshape(b, T_OUT, F_OUT, C_OUT, 2, 2, 2)
               .permute(0, 6, 3, 1, 4, 2, 5)
               .reshape(b, C_CONV, T_IN, F_IN))
    with ieee_f32():
        dx = F.conv_transpose2d(dy, w.detach().to(torch.bfloat16).float(), padding=K // 2)
    return dx[:, 0].to(dtype)


# --------------------------------------------------------------------------
# autograd
# --------------------------------------------------------------------------

class _Conv0MfmPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, use_kernel):
        with_index = ctx.needs_input_grad[0]
        fwd = kernel_fwd if use_kernel else reference_fwd
        out, idx = fwd(x, w, bias, with_index)
        ctx.use_kernel = use_kernel
        ctx.x_dtype = x.dtype
        if with_index:
            ctx.save_for_backward(idx, w.detach())
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            raise RuntimeError(
                "fused_conv0_mfm_pool computes dx only (need_dw=False): its "
                "weight and bias must not require grad"
            )
        idx, w = ctx.saved_tensors
        bwd = kernel_bwd if ctx.use_kernel else reference_bwd
        return bwd(idx, g, w, ctx.x_dtype), None, None, None


def fused_conv0_mfm_pool(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                         need_dw: bool = False) -> torch.Tensor:
    """(B, 404, 80) bf16/f32, w OIHW (64, 1, 5, 5), bias (64) -> (B, 202, 40, 32).

    A CUDA tensor runs the Hopper kernel (a failed build or launch
    raises); a CPU tensor runs the plain-torch twin.
    """
    _validate(x, w, bias)
    if need_dw:
        raise NotImplementedError(
            "weight gradients of the fused first block come with the training "
            "slice (ROADMAP.md, queue 2)"
        )
    if x.is_cuda:
        use_kernel = True
    elif x.device.type == "cpu":
        use_kernel = False
    else:
        raise ValueError(f"no layer-0 implementation for device {x.device}")
    return _Conv0MfmPool.apply(x, w, bias, use_kernel)


def fused_conv0_mfm_pool_reference(x: torch.Tensor, w: torch.Tensor,
                                   bias: torch.Tensor) -> torch.Tensor:
    """The plain-torch twin on any device (the kernel's check)."""
    _validate(x, w, bias)
    return _Conv0MfmPool.apply(x, w, bias, False)
