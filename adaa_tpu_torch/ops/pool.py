"""Non-overlapping 1-D max pool with a first-max backward, bf16, (B, T, C).

Replaces the TPU kernel ``adaa_tpu/ops/pallas_pool.py`` (``max_pool_1d``
-> ``_pool_fn``: ``_fwd_kernel``, ``_bwd_kernel``) with a CUDA C++ kernel
for Hopper (``adaa_tpu_torch/csrc/pool.cu``, built by ``ops/_build.py``).
The CUDA source's header says what bounds it on an H100 and how the
design deals with that.

What it computes, as the JAX op does: floor mode (the tail T mod w is
dropped, and gets a zero gradient), the max of each window compared in
f32, bf16 in and out. The backward sends the cotangent to the FIRST
slot of each window equal to its max (torch ``MaxPool1d``'s argmax
rule), zeros elsewhere. The default pool of the port
(``models/layers.py:max_pool_1d``) gives the whole cotangent to every
tie instead.

In RawNet3 only one pool reaches it: layer 1's w=5 pool of bf16
(B, 6435, 1024) (``AFMS`` makes every block's output f32, and the JAX
kernel takes bf16 only). It takes any B, T >= w and C.

``max_pool_1d`` launches the kernels for a CUDA tensor and runs the
plain-torch version only for a CPU tensor; a CUDA tensor never falls
back. ``max_pool_1d_reference`` is the plain version itself, called
explicitly to check the kernels. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from adaa_tpu_torch.ops import _build

LAUNCHES = {"fwd": 0, "bwd": 0}


def _validate(x: torch.Tensor, window: int) -> None:
    if x.dim() != 3 or window < 1 or x.shape[1] < window:
        raise ValueError(f"x must be (B, T >= window, C) with window >= 1, got "
                         f"{tuple(x.shape)} and window={window}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the pool kernel takes bfloat16, got {x.dtype}")
    if x.numel() >= 2 ** 31:
        raise ValueError("the pool kernel takes fewer than 2**31 elements")


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("pool")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pool_fwd.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.pool_fwd.restype = i32
    lib.pool_bwd.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.pool_bwd.restype = i32
    lib.pool_error_string.argtypes = [i32]
    lib.pool_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"pool {what} launch failed: CUDA error {err} "
                           f"({lib.pool_error_string(err).decode()})")


def kernel_fwd(x: torch.Tensor, window: int) -> torch.Tensor:
    """Launch the forward kernel: (B, T, C) bf16 -> (B, T // window, C)."""
    if not x.is_cuda:
        raise ValueError("kernel_fwd takes CUDA tensors")
    _validate(x, window)
    x = x.contiguous()
    b, t, c = x.shape
    out = torch.empty((b, t // window, c), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):  # the C side selects the same device
        err = lib.pool_fwd(x.data_ptr(), out.data_ptr(), b, t, c, window, x.device.index,
                           torch.cuda.current_stream(x.device).cuda_stream)
    _check(lib, err, "forward")
    LAUNCHES["fwd"] += 1
    return out


def kernel_bwd(x: torch.Tensor, g: torch.Tensor, window: int) -> torch.Tensor:
    """Launch the backward kernel: (x, cotangent (B, T // window, C)) -> dx (B, T, C)."""
    if not (x.is_cuda and g.is_cuda):
        raise ValueError("kernel_bwd takes CUDA tensors")
    _validate(x, window)
    b, t, c = x.shape
    if tuple(g.shape) != (b, t // window, c):
        raise ValueError(f"g must be {(b, t // window, c)}, got {tuple(g.shape)}")
    x = x.contiguous()
    g = g.to(torch.bfloat16).contiguous()
    dx = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.pool_bwd(x.data_ptr(), g.data_ptr(), dx.data_ptr(), b, t, c, window,
                           x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _check(lib, err, "backward")
    LAUNCHES["bwd"] += 1
    return dx


# --------------------------------------------------------------------------
# Plain-torch version
# --------------------------------------------------------------------------

def _windows(x: torch.Tensor, window: int) -> torch.Tensor:
    b, t, c = x.shape
    t2 = t // window
    return x[:, : t2 * window].reshape(b, t2, window, c)


def reference_fwd(x: torch.Tensor, window: int) -> torch.Tensor:
    """The kernel's forward in plain torch: reshape + amax (exact in bf16)."""
    return _windows(x, window).amax(dim=2)


def reference_bwd(x: torch.Tensor, g: torch.Tensor, window: int) -> torch.Tensor:
    """The kernel's backward in plain torch: a running ``taken`` mask sends
    g to the first slot equal to the window's max."""
    xw = _windows(x, window)
    m = xw.amax(dim=2)
    g = g.to(x.dtype)
    taken = torch.zeros_like(m, dtype=torch.bool)
    slots = []
    for i in range(window):
        is_max = xw[:, :, i] == m
        slots.append(torch.where(is_max & ~taken, g, torch.zeros((), dtype=x.dtype,
                                                                 device=x.device)))
        taken = taken | is_max
    dx = torch.stack(slots, dim=2).reshape(x.shape[0], -1, x.shape[2])
    return torch.nn.functional.pad(dx, (0, 0, 0, x.shape[1] - dx.shape[1]))


# --------------------------------------------------------------------------
# autograd
# --------------------------------------------------------------------------

class _MaxPool1dFirst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, use_kernel):
        ctx.window, ctx.use_kernel = window, use_kernel
        ctx.save_for_backward(x)
        return (kernel_fwd if use_kernel else reference_fwd)(x, window)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        bwd = kernel_bwd if ctx.use_kernel else reference_bwd
        return bwd(x, g, ctx.window), None, None


def max_pool_1d(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, T, C) bf16 -> (B, T // window, C). A CUDA tensor runs the Hopper
    kernels (a failed build or launch raises); a CPU tensor runs the
    plain-torch version."""
    _validate(x, window)
    if x.is_cuda:
        use_kernel = True
    elif x.device.type == "cpu":
        use_kernel = False
    else:
        raise ValueError(f"no pool implementation for device {x.device}")
    return _MaxPool1dFirst.apply(x, window, use_kernel)


def max_pool_1d_reference(x: torch.Tensor, window: int) -> torch.Tensor:
    """The plain-torch version on any device (the kernels' check)."""
    _validate(x, window)
    return _MaxPool1dFirst.apply(x, window, False)
