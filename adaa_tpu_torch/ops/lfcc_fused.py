"""Fused LFCC / MFCC forward for 64,600-sample waves: (B, 64600) -> (B, 80, 404).

Replaces the TPU kernel ``adaa_tpu/ops/pallas_lfcc.py`` (``lfcc_pallas``,
``mfcc_pallas`` -> ``_lfcc_tiles`` / ``_kernel``) with a CUDA C++ kernel
for Hopper (``adaa_tpu_torch/csrc/lfcc.cu``, built by ``ops/_build.py``):
a real FFT in shared memory instead of the TPU kernel's DFT product, with
the reflect pad done where the kernel reads x. The CUDA source's header
says what bounds it on an H100 and how the design deals with that; the
FFT's window and twiddle tables come from ``fft_table``.

What it computes, as the JAX op does: reflect padding by n_fft / 2, the
hann-400 windowed DFT (n_fft 512, hop 160), power, a 257 -> 128
filterbank (linear for LFCC, HTK mel for MFCC),
``(10 / ln 10) * ln(max(., 1e-10))`` and the ortho DCT 128 -> 80, every
product in f32. The gradient is not the kernel's: it recomputes through
the unfused f32 frontend (``frontends.lfcc`` / ``frontends.mfcc`` with
``compute="f32"``), as ``adaa_tpu/ops/frontends.py``'s custom VJP does.

``lfcc_fused`` / ``mfcc_fused`` launch the kernel for a CUDA tensor and
run the plain-torch version only for a CPU tensor; a CUDA tensor never
falls back. ``cepstra_fused_reference`` is the plain version itself,
called explicitly to check the kernel. ``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from adaa_tpu_torch.ops import _build
from adaa_tpu_torch.ops import filterbanks as fb
from adaa_tpu_torch.ops.layer0 import device_scope, ieee_f32, raw_stream
from adaa_tpu_torch.ops.stft import _dft_kernel, _padded_window, device_constant, hann_window

WAVE_LEN = 64_600
N_FFT, HOP, WIN, SR = 512, 160, 400, 16_000
N_BINS, N_FILTER, N_CEP, N_FRAMES = N_FFT // 2 + 1, 128, 80, 404
WIN_OFF = (N_FFT - WIN) // 2  # the window's first non-zero tap
DB_SCALE = 10.0 / math.log(10.0)
FILTERBANKS = ("linear", "mel")
MAX_BATCH = 65_535  # the kernel puts the batch on gridDim.y

LAUNCHES = {"fwd": 0}


def filterbank_matrix(kind: str) -> np.ndarray:
    """(257, 128) f32 row-major: linear (LFCC) or HTK mel with norm=None (MFCC)."""
    if kind == "linear":
        return np.ascontiguousarray(fb.linear_fbanks(N_BINS, 0.0, SR / 2, N_FILTER, SR))
    if kind == "mel":
        return np.ascontiguousarray(
            fb.melscale_fbanks(N_BINS, 0.0, SR / 2, N_FILTER, SR, None, "htk"))
    raise ValueError(f"filterbank must be one of {FILTERBANKS}, got {kind!r}")


TINY_BIN = 2.0 ** -16  # csrc/lfcc.cu: bins below this x the frame's energy go to float64
# The FFT's tables, as csrc/lfcc.cu reads them (offsets in floats)
TAB_WIN, TAB_W256, TAB_W32, TAB_W512 = 0, N_FFT, N_FFT + 2 * 256, N_FFT + 2 * 256 + 2 * 32
TAB_LEN = TAB_W512 + 2 * 256


def _twiddles(n: int, e: np.ndarray) -> np.ndarray:
    """exp(-2 pi i e / n) in float64, as all real parts then all imaginary parts."""
    ang = -2.0 * np.pi * e.astype(np.float64) / n
    return np.concatenate([np.cos(ang), np.sin(ang)])


@functools.lru_cache(maxsize=None)
def fft_table64() -> np.ndarray:
    """(TAB_LEN,) float64: the kernel's window and twiddles. The window: the
    f32 hann-400 zero-padded to 512. Then W256^(n2 k1) at 32 k1 + n2 (k1 <
    8, n2 < 32; pass 1), W32^(m2 k2a) at 4 k2a + m2 (k2a < 8, m2 < 4; pass
    2) and W512^k (k < 256; the real split)."""
    win = _padded_window(hann_window(WIN), N_FFT, WIN)
    k1, n2 = np.divmod(np.arange(256), 32)
    k2a, m2 = np.divmod(np.arange(32), 4)
    tab = np.concatenate([win, _twiddles(256, n2 * k1), _twiddles(32, m2 * k2a),
                          _twiddles(512, np.arange(256))])
    assert tab.shape == (TAB_LEN,)
    return tab


def fft_table() -> np.ndarray:
    """The kernel's table: ``fft_table64`` rounded once to f32."""
    return fft_table64().astype(np.float32)


@functools.lru_cache(maxsize=None)
def cos_sin_512() -> np.ndarray:
    """(2, 512) float64: cos and sin of 2 pi m / 512, for the kernel's float64
    direct DFT of bins too small for the f32 FFT."""
    ang = 2.0 * np.pi * np.arange(512) / 512
    return np.stack([np.cos(ang), np.sin(ang)])


def reflect_index(i: np.ndarray) -> np.ndarray:
    """The kernel's reflect: wave index i of the padded frames -> the sample
    it reads (the reflect pad by n_fft / 2, as F.pad(mode="reflect"))."""
    i = np.where(i < 0, -i, i)
    return np.where(i >= WAVE_LEN, 2 * (WAVE_LEN - 1) - i, i)


@functools.lru_cache(maxsize=None)
def _filter_ranges(kind: str) -> np.ndarray:
    """(128, 2) int32: each filter's non-zero bins as [lo, hi)."""
    nz = filterbank_matrix(kind) != 0
    out = np.zeros((N_FILTER, 2), np.int32)
    for m in range(N_FILTER):
        bins = np.flatnonzero(nz[:, m])
        if bins.size:
            out[m] = bins[0], bins[-1] + 1
    return out


def _dct_matrix() -> np.ndarray:
    # create_dct returns a transposed (column-major) view; the kernel
    # reads row-major
    return np.ascontiguousarray(fb.create_dct(N_CEP, N_FILTER, "ortho"))  # (128, 80)


def _validate(x: torch.Tensor, filterbank: str) -> None:
    if x.dim() != 2 or x.shape[1] != WAVE_LEN or not 1 <= x.shape[0] <= MAX_BATCH:
        raise ValueError(f"x must be (1 <= B <= {MAX_BATCH}, {WAVE_LEN}), got {tuple(x.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    if filterbank not in FILTERBANKS:
        raise ValueError(f"filterbank must be one of {FILTERBANKS}, got {filterbank!r}")


def _reflect_pad(x: torch.Tensor) -> torch.Tensor:
    pad = N_FFT // 2
    return F.pad(x.float()[:, None], (pad, pad), mode="reflect")[:, 0]  # (B, 65112)


# --------------------------------------------------------------------------
# CUDA kernel
# --------------------------------------------------------------------------

_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# x, the table and its length, cos / sin in float64, filt, franges, dct, out,
# batch, device, stream
ARGTYPES = {"lfcc_fwd": [_PTR, _PTR, _I32] + [_PTR] * 5 + [_I32, _I32, _PTR]}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("lfcc")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I32
    lib.lfcc_error_string.argtypes = [_I32]
    lib.lfcc_error_string.restype = ctypes.c_char_p
    return lib


def kernel_forward(x: torch.Tensor, filterbank: str = "linear") -> torch.Tensor:
    """Launch the kernel on x's current stream: (B, 64600) -> (B, 80, 404) f32.
    The kernel reads x itself and reflects the frames' edges (no padded copy)."""
    if not x.is_cuda:
        raise ValueError("kernel_forward takes CUDA tensors")
    if x.dtype != torch.float32 or not x.is_contiguous():
        x = x.float().contiguous()
    dev = x.device
    tab = device_constant(fft_table, (), dev)
    cs64 = device_constant(cos_sin_512, (), dev)
    filt = device_constant(filterbank_matrix, (filterbank,), dev)
    ranges = device_constant(_filter_ranges, (filterbank,), dev)
    dct = device_constant(_dct_matrix, (), dev)
    b = x.shape[0]
    out = x.new_empty((b, N_CEP, N_FRAMES))
    lib = _library()
    with device_scope(dev):  # the C side selects the same device
        err = lib.lfcc_fwd(x.data_ptr(), tab.data_ptr(), tab.numel(), cs64.data_ptr(),
                           filt.data_ptr(),
                           ranges.data_ptr(), dct.data_ptr(), out.data_ptr(), b,
                           dev.index, raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"lfcc forward launch failed: CUDA error {err} "
                           f"({lib.lfcc_error_string(err).decode()})")
    LAUNCHES["fwd"] += 1
    return out


# --------------------------------------------------------------------------
# Plain-torch version
# --------------------------------------------------------------------------

def reference_forward(x: torch.Tensor, filterbank: str = "linear") -> torch.Tensor:
    """The kernel's math in plain torch, full f32 (TF32 off) on any device:
    frames @ DFT matrix, power, filterbank, dB, DCT."""
    dev = x.device
    frames = _reflect_pad(x.detach()).unfold(-1, N_FFT, HOP)  # (B, 404, 512)
    kern = device_constant(_dft_kernel, (N_FFT, WIN, "hann"), dev)[:, 0, :]  # (514, 512)
    filt = device_constant(filterbank_matrix, (filterbank,), dev)
    dct = device_constant(_dct_matrix, (), dev)
    with ieee_f32():
        y = torch.matmul(frames, kern.T)  # (B, 404, 514)
        power = y[..., :N_BINS] ** 2 + y[..., N_BINS:] ** 2
        db = DB_SCALE * torch.log(torch.clamp(torch.matmul(power, filt), min=1e-10))
        cep = torch.matmul(db, dct)  # (B, 404, 80)
    return cep.transpose(1, 2).contiguous()


# --------------------------------------------------------------------------
# autograd
# --------------------------------------------------------------------------

class _FusedCepstra(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, filterbank, use_kernel):
        ctx.filterbank = filterbank
        ctx.save_for_backward(x)
        fwd = kernel_forward if use_kernel else reference_forward
        return fwd(x, filterbank)

    @staticmethod
    def backward(ctx, g):
        # the gradient recomputes through the unfused f32 frontend
        from adaa_tpu_torch.ops import frontends

        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            if ctx.filterbank == "linear":
                y = frontends.lfcc(xx, compute="f32", fused=False)
            else:
                y = frontends.mfcc(xx, compute="f32")
            (dx,) = torch.autograd.grad(y, xx, g)
        return dx, None, None


def cepstra_fused(x: torch.Tensor, filterbank: str = "linear") -> torch.Tensor:
    """(B, 64600) -> (B, 80, 404) f32 cepstra, differentiable in x.

    A CUDA tensor runs the Hopper kernel (a failed build or launch
    raises); a CPU tensor runs the plain-torch version.
    """
    _validate(x, filterbank)
    if x.is_cuda:
        use_kernel = True
    elif x.device.type == "cpu":
        use_kernel = False
    else:
        raise ValueError(f"no fused LFCC implementation for device {x.device}")
    return _FusedCepstra.apply(x, filterbank, use_kernel)


def cepstra_fused_reference(x: torch.Tensor, filterbank: str = "linear") -> torch.Tensor:
    """The plain-torch version on any device (the kernel's check), with
    the same gradient."""
    _validate(x, filterbank)
    return _FusedCepstra.apply(x, filterbank, False)


def lfcc_fused(x: torch.Tensor) -> torch.Tensor:
    """LFCC, the counterpart of ``pallas_lfcc.lfcc_pallas``."""
    return cepstra_fused(x, "linear")


def mfcc_fused(x: torch.Tensor) -> torch.Tensor:
    """MFCC, the counterpart of ``pallas_lfcc.mfcc_pallas``."""
    return cepstra_fused(x, "mel")
