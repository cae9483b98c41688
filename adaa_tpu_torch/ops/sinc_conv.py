"""RawNet3's strided sinc-filterbank convolution with a closed-form dx.

Port of ``adaa_tpu/ops/sinc_conv.py``: (B, L) x (F, K) -> (B, T, F),
T = (L - K) // stride + 1, as a ``torch.autograd.Function`` whose
backward is

    dL/dx[m] = sum_t G[t, m - t * stride],   G = g @ filters,

one (B, T, F) x (F, K') product (K' = K padded to a multiple of the
stride) and an overlap-add of the stride-sized chunks (``F.fold``).

Rounding points, as in JAX: with ``compute="bf16"`` the wave, the
filters and the cotangent enter the products as bf16 values, the
products accumulate in f32 (f32 products of bf16-rounded operands with
TF32 off, so each product is exact), and the frame buffer G is stored
at bf16 before the f32 overlap-add. A CPU tensor always computes in
f32, as the JAX op downgrades to f32 on the CPU; that is what lets the
CPU tests compare like with like.

The filter gradient is not computed: ``need_dw=True`` raises, and so
does a backward whose filters require grad (the JAX op poisons dW with
NaN on eval/attack paths; dW comes with training).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from adaa_tpu_torch.ops.layer0 import ieee_f32


def _cast(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).float() if bf16 else t.float()


class _SincConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, filters, stride, bf16):
        ctx.stride, ctx.bf16, ctx.length = stride, bf16, x.shape[1]
        ctx.save_for_backward(filters.detach())
        with ieee_f32():
            out = F.conv1d(_cast(x, bf16)[:, None], _cast(filters.detach(), bf16)[:, None],
                           stride=stride)  # (B, F, T)
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[1]:
            raise RuntimeError("sinc_conv computes dx only (need_dw=False): its filters "
                               "must not require grad")
        (filters,) = ctx.saved_tensors
        s, length = ctx.stride, ctx.length
        n_f, k = filters.shape
        c = -(-k // s)  # stride-chunks per kernel window
        b, t, _ = g.shape
        wpad = F.pad(_cast(filters, ctx.bf16), (0, c * s - k))  # (F, c * s)
        with ieee_f32():
            gg = torch.matmul(_cast(g, ctx.bf16), wpad)  # (B, T, c * s) frames
        if ctx.bf16:
            gg = gg.to(torch.bfloat16).float()  # the frame buffer at trunk width
        rows = t + c - 1
        dx = F.fold(gg.transpose(1, 2), output_size=(1, rows * s), kernel_size=(1, c * s),
                    stride=(1, s)).reshape(b, rows * s)
        dx = dx[:, :length] if rows * s >= length else F.pad(dx, (0, length - rows * s))
        return dx, None, None, None


def sinc_conv(x: torch.Tensor, filters: torch.Tensor, stride: int, need_dw: bool = False,
              compute: str = "f32") -> torch.Tensor:
    """Strided filterbank conv of raw waves: x (B, L) f32, filters (F, K)
    -> (B, T, F) f32. ``compute="bf16"`` rounds the product operands to
    bf16 on the card; a CPU tensor computes in f32."""
    if need_dw:
        raise NotImplementedError(
            "the sinc filterbank's weight gradient comes with the training slice "
            "(ROADMAP.md, queue 1)")
    if compute not in ("f32", "bf16"):
        raise ValueError(f"compute must be 'f32' or 'bf16', got {compute!r}")
    if x.dim() != 2 or filters.dim() != 2 or x.shape[1] < filters.shape[1]:
        raise ValueError(f"x must be (B, L >= K) and filters (F, K), got "
                         f"{tuple(x.shape)} and {tuple(filters.shape)}")
    bf16 = compute == "bf16" and x.device.type != "cpu"
    return _SincConv.apply(x, filters, stride, bf16)
