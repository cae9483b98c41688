"""Short-time Fourier transform with torch.stft conventions.

Port of ``adaa_tpu/ops/stft.py``: centred reflect padding of
``n_fft // 2``, a window of ``win_length`` zero-padded symmetrically to
``n_fft``, onesided output with ``n_fft // 2 + 1`` bins, no
normalisation.

The windowed DFT is one plain matrix product of the hop-strided frames
(an ``unfold`` view) with the ``window * [cos | -sin]`` matrix. Its
gradient is autograd's: the matmul's transpose followed by
``unfold``'s overlap-add, which is the same sum as the JAX package's
closed-form VJP (``adaa_tpu/ops/stft.py:131-215``, written there only
because XLA:TPU compiles the strided-conv transpose badly).

Precision follows the JAX rule: ``compute="bf16"`` multiplies bf16
inputs with f32 accumulation and stores the spectrum in bf16, but only
on an accelerator; on the CPU it falls back to f32, decided per call
from the tensor's device.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window — matches ``torch.hann_window(periodic=True)``."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    return w.astype(dtype)


def _padded_window(window: Optional[np.ndarray], n_fft: int, win_length: int) -> np.ndarray:
    """Zero-pad the window to n_fft, centered (torch.stft semantics)."""
    if window is None:
        window = np.ones(win_length, dtype=np.float32)
    assert window.shape == (win_length,)
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[left : left + win_length] = window.astype(np.float64)
    return out


@functools.lru_cache(maxsize=16)
def _dft_kernel(n_fft: int, win_length: int, window_kind: str) -> np.ndarray:
    """Windowed real-DFT kernel, shape (2 * n_bins, 1, n_fft).

    Rows [0, n_bins) produce the real part, rows [n_bins, 2*n_bins) the
    imaginary part. The window is folded into the kernel.
    """
    if window_kind == "hann":
        window = hann_window(win_length)
    elif window_kind == "ones":
        window = None
    else:
        raise ValueError(f"unknown window kind {window_kind!r}")
    w = _padded_window(window, n_fft, win_length)  # (n_fft,) float64
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    f = np.arange(n_bins, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(f, n) / n_fft  # (n_bins, n_fft)
    real = np.cos(ang) * w[None, :]
    imag = -np.sin(ang) * w[None, :]
    kern = np.concatenate([real, imag], axis=0)[:, None, :]  # (2F, 1, n_fft)
    return kern.astype(np.float32)


@functools.lru_cache(maxsize=32)
def device_constant(builder, args: tuple, device: torch.device) -> torch.Tensor:
    """``builder(*args)`` (a cached numpy constant) as a tensor on ``device``.

    Cached so the hot loop never copies host memory to the card (a
    pageable host-to-device copy waits for the stream).
    """
    return torch.from_numpy(builder(*args)).to(device)


def frame_count(length: int, n_fft: int, hop_length: int, center: bool = True) -> int:
    if center:
        length = length + 2 * (n_fft // 2)
    return 1 + (length - n_fft) // hop_length


def stft(
    x: torch.Tensor,
    n_fft: int = 512,
    hop_length: int = 160,
    win_length: int = 400,
    window: str = "hann",
    center: bool = True,
    pad_mode: str = "reflect",
    compute: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real STFT of a batch of waves.

    Args:
      x: (..., L) float waveforms.
      window: "hann" (torchaudio Spectrogram default) or "ones"
        (``torch.stft`` called without a window).

    Returns:
      (real, imag), each (..., n_fft // 2 + 1, n_frames); bf16 when
      ``compute="bf16"`` on an accelerator, else f32.
    """
    batch_shape = x.shape[:-1]
    length = x.shape[-1]
    x2 = x.reshape(-1, length).to(torch.float32)
    if center:
        pad = n_fft // 2
        x2 = F.pad(x2[:, None, :], (pad, pad), mode=pad_mode)[:, 0, :]
    if compute == "bf16" and x2.device.type == "cpu":
        compute = "f32"  # bf16 compute only on the accelerator; checked per call

    kern = device_constant(_dft_kernel, (n_fft, win_length, window), x2.device)[:, 0, :]
    frames = x2.unfold(-1, n_fft, hop_length)  # (B, T, n_fft) view
    if compute == "bf16":
        # bf16 inputs, f32 accumulation, bf16 store (as the JAX fast path);
        # the cast sits after the unfold so the overlap-add of the
        # gradient accumulates in f32
        out = torch.matmul(frames.to(torch.bfloat16), kern.to(torch.bfloat16).T)
    else:
        out = torch.matmul(frames, kern.T)  # (B, T, 2F)
    out = out.transpose(1, 2)  # (B, 2F, T)

    n_bins = n_fft // 2 + 1
    n_frames = out.shape[-1]
    real = out[:, :n_bins, :]
    imag = out[:, n_bins:, :]
    return (
        real.reshape(batch_shape + (n_bins, n_frames)),
        imag.reshape(batch_shape + (n_bins, n_frames)),
    )


def spectrogram(
    x: torch.Tensor,
    n_fft: int = 512,
    hop_length: int = 160,
    win_length: int = 400,
    power: float = 2.0,
    compute: str = "f32",
) -> torch.Tensor:
    """``torchaudio.transforms.Spectrogram`` equivalent (power spectrum).

    Hann window, center/reflect, no normalization. Returns
    (..., n_fft // 2 + 1, n_frames).
    """
    real, imag = stft(
        x, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
        window="hann", compute=compute,
    )
    if real.dtype == torch.bfloat16:
        # square in f32, store bf16: the filterbank product consumes the
        # spectrum in bf16 regardless (frontends._banked_einsum)
        r32, i32 = real.float(), imag.float()
        mag2 = (r32 * r32 + i32 * i32).to(torch.bfloat16)
    else:
        mag2 = real * real + imag * imag
    if power == 2.0:
        return mag2
    return torch.pow(torch.sqrt(mag2).float(), power)
