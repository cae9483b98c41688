"""LCNN mid-trunk segments: conv1x1 + MFM, then conv3x3 + MFM + 2x2 max pool.

Replaces the TPU kernel ``adaa_tpu/ops/pallas_trunk.py``
(``fused_segment`` -> ``_conv3_op``: ``_fwd_kernel``, ``_bwd_kernel``)
with a CUDA C++ kernel for Hopper (``adaa_tpu_torch/csrc/trunk.cu``,
built by ``ops/_build.py``). The CUDA source's header says what bounds
it on an H100 and how this first, simple design deals with that.

What it computes, as the JAX op does (channels-last layouts, OIHW
weights with any eval-mode BN folded in by the caller):

* conv1x1 + MFM in plain torch, differentiated by autograd: bf16
  operands, f32 accumulation, f32 bias; the MFM output ``am`` stays f32
  (the port's default trunk rounds its conv store to bf16 before the
  bias instead, so the two paths are kept apart). ``torch.maximum``
  splits the gradient of a tie 1/2-1/2, as ``jnp.maximum`` does.
* conv3x3 (SAME) + MFM + floor 2x2 max pool as one op: ``am`` rounded
  to bf16, exact products summed in f32, the f32 bias, the maxima; f32
  out, cast to x's dtype. Its backward is dx only: it recomputes the 8
  candidates of each pooled output, splits the cotangent evenly over
  those equal to the max (``bf16(g / cnt)`` to each) and runs the
  transposed conv with bf16 weights and f32 sums. A weight gradient
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
from typing import NamedTuple

import torch
import torch.nn.functional as F

from adaa_tpu_torch.ops import _build
from adaa_tpu_torch.ops.layer0 import ieee_f32

GROUPS = 8  # the kernels' channel groups (one warp each)
MAX_BATCH = 65_535  # the kernels put the batch on gridDim.y

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
# CUDA kernels
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("trunk")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.trunk_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.trunk_fwd.restype = i32
    lib.trunk_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.trunk_bwd.restype = i32
    lib.trunk_error_string.argtypes = [i32]
    lib.trunk_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"trunk {what} launch failed: CUDA error {err} "
                           f"({lib.trunk_error_string(err).decode()})")


def pack_forward_weights(wb: torch.Tensor, spec: SegmentSpec) -> torch.Tensor:
    """OIHW (c_out, c2, 3, 3) -> (c2, 9, GROUPS, 2 CH) f32, bf16-rounded:
    group g's CH low and CH high MFM channels of one (input channel, tap)
    side by side, CH = half / GROUPS."""
    ch = spec.half // GROUPS
    w = _bf16(wb).reshape(2, GROUPS, ch, spec.c2, 3, 3)  # (h, g, c, ci, dt, df)
    return w.permute(3, 4, 5, 1, 0, 2).reshape(spec.c2, 9, GROUPS, 2 * ch).contiguous()


def pack_backward_weights(wb: torch.Tensor) -> torch.Tensor:
    """OIHW (c_out, c2, 3, 3) -> (c_out, 3, 3, c2) f32, bf16-rounded."""
    return _bf16(wb).permute(0, 2, 3, 1).contiguous()


def kernel_fwd(am: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor,
               spec: SegmentSpec) -> torch.Tensor:
    """Launch the forward kernel: am (B, T, F, c2) -> (B, T/2, F/2, half) f32."""
    if not am.is_cuda:
        raise ValueError("kernel_fwd takes CUDA tensors")
    seg = _segment_id(spec)
    am = am.detach().float().contiguous()
    wpk = pack_forward_weights(wb, spec)
    bias = bb.detach().float().contiguous()
    b = am.shape[0]
    out = torch.empty((b, spec.t_out, spec.f_out, spec.half), dtype=torch.float32,
                      device=am.device)
    lib = _library()
    with torch.cuda.device(am.device):  # the C side selects the same device
        err = lib.trunk_fwd(am.data_ptr(), wpk.data_ptr(), bias.data_ptr(), out.data_ptr(),
                            b, seg, am.device.index,
                            torch.cuda.current_stream(am.device).cuda_stream)
    _check(lib, err, "forward")
    LAUNCHES["fwd"] += 1
    return out


def kernel_bwd(am: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor, g: torch.Tensor,
               spec: SegmentSpec) -> torch.Tensor:
    """Launch the dx kernels: (am, cotangent (B, T/2, F/2, half)) -> dx (B, T, F, c2) f32."""
    if not (am.is_cuda and g.is_cuda):
        raise ValueError("kernel_bwd takes CUDA tensors")
    seg = _segment_id(spec)
    am = am.detach().float().contiguous()
    g = g.float().contiguous()
    wpk = pack_forward_weights(wb, spec)
    wtk = pack_backward_weights(wb)
    bias = bb.detach().float().contiguous()
    b = am.shape[0]
    dy = torch.empty((b, spec.c_out, 2 * spec.t_out, 2 * spec.f_out), dtype=torch.bfloat16,
                     device=am.device)  # scratch: the conv-output cotangent
    dx = torch.empty_like(am)
    lib = _library()
    with torch.cuda.device(am.device):
        err = lib.trunk_bwd(am.data_ptr(), wpk.data_ptr(), bias.data_ptr(), g.data_ptr(),
                            dy.data_ptr(), wtk.data_ptr(), dx.data_ptr(), b, seg,
                            am.device.index, torch.cuda.current_stream(am.device).cuda_stream)
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


def reference_fwd(am: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor,
                  spec: SegmentSpec) -> torch.Tensor:
    """The kernel's forward in plain torch -> (B, T/2, F/2, half) f32."""
    return _candidates(am, wb, bb, spec).amax(dim=(1, 4, 6)).permute(0, 2, 3, 1).contiguous()


def reference_bwd(am: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor, g: torch.Tensor,
                  spec: SegmentSpec) -> torch.Tensor:
    """The kernel's dx in plain torch: ties split evenly, bf16 dy, then an
    f32 transposed conv with the bf16 weights -> (B, T, F, c2) f32."""
    y = _candidates(am, wb, bb, spec)
    pool = y.amax(dim=(1, 4, 6), keepdim=True)
    eq = y == pool
    cnt = eq.sum(dim=(1, 4, 6), keepdim=True).float()
    inv = g.float().permute(0, 3, 1, 2)[:, None, :, :, None, :, None] / cnt.clamp(min=1.0)
    dy = torch.where(eq, inv.to(torch.bfloat16).float(), torch.zeros((), device=am.device))
    dy = dy.reshape(am.shape[0], spec.c_out, 2 * spec.t_out, 2 * spec.f_out)
    dy = F.pad(dy, (0, spec.f - 2 * spec.f_out, 0, spec.t - 2 * spec.t_out))
    with ieee_f32():
        dx = F.conv_transpose2d(dy, _bf16(wb), padding=1)
    return dx.permute(0, 2, 3, 1).contiguous()


# --------------------------------------------------------------------------
# autograd
# --------------------------------------------------------------------------

class _Conv3MfmPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, am, wb, bb, spec, use_kernel):
        ctx.spec, ctx.use_kernel = spec, use_kernel
        ctx.save_for_backward(am, wb.detach(), bb.detach())
        return (kernel_fwd if use_kernel else reference_fwd)(am, wb, bb, spec)

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            raise RuntimeError(
                "fused_segment computes dx only (need_dw=False): its conv3x3 "
                "weight and bias must not require grad"
            )
        am, wb, bb = ctx.saved_tensors
        bwd = kernel_bwd if ctx.use_kernel else reference_bwd
        return bwd(am, wb, bb, g, ctx.spec), None, None, None, None


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
