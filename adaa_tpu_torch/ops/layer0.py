"""LCNN's fused first block: conv 5x5 (1 -> 64, pad 2) + MFM + 2x2 max pool.

Replaces the TPU kernel ``adaa_tpu/ops/pallas_layer0.py``
(``fused_conv0_mfm_pool``: ``_fwd_kernel``, ``_fwd_mask_kernel``,
``_bwd_kernel``) with a CUDA C++ kernel for Hopper
(``adaa_tpu_torch/csrc/layer0.cu``, built by ``ops/_build.py``). The
CUDA source's header says what bounds it on an H100 and how this first,
simple design deals with that.

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
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from adaa_tpu_torch.ops import _build

T_IN, F_IN = 404, 80
T_OUT, F_OUT = T_IN // 2, F_IN // 2
C_CONV, C_OUT, K = 64, 32, 5
MAX_BATCH = 65_535  # the kernels put the batch on gridDim.y

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
# CUDA kernel
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("layer0")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.layer0_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.layer0_fwd.restype = i32
    lib.layer0_bwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.layer0_bwd.restype = i32
    lib.layer0_error_string.argtypes = [i32]
    lib.layer0_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"layer0 {what} launch failed: CUDA error {err} "
            f"({lib.layer0_error_string(err).decode()})"
        )


def kernel_fwd(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               with_index: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel on x's current stream -> (out, idx or None)."""
    if not x.is_cuda:
        raise ValueError("kernel_fwd takes CUDA tensors")
    x = x.contiguous()
    w = w.detach().float().contiguous()
    bias = bias.detach().float().contiguous()
    b = x.shape[0]
    out = torch.empty((b, T_OUT, F_OUT, C_OUT), dtype=x.dtype, device=x.device)
    idx = (torch.empty((b, T_OUT, F_OUT, C_OUT), dtype=torch.uint8, device=x.device)
           if with_index else None)
    lib = _library()
    with torch.cuda.device(x.device):  # the C side selects the same device
        err = lib.layer0_fwd(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            idx.data_ptr() if idx is not None else None,
            b, int(x.dtype == torch.bfloat16), x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream,
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
    g = g.to(dtype).contiguous()
    idx = idx.contiguous()
    w = w.detach().float().contiguous()
    b = g.shape[0]
    dx = torch.empty((b, T_IN, F_IN), dtype=dtype, device=g.device)
    lib = _library()
    with torch.cuda.device(g.device):
        err = lib.layer0_bwd(
            idx.data_ptr(), g.data_ptr(), w.data_ptr(), dx.data_ptr(),
            b, int(dtype == torch.bfloat16), g.device.index,
            torch.cuda.current_stream(g.device).cuda_stream,
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
