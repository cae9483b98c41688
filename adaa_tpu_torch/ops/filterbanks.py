"""Triangular filterbanks + DCT matching torchaudio's published formulas.

Port of ``adaa_tpu/ops/filterbanks.py``. The constant matrices are the
same float64 numpy construction (the tests pin them bit-equal to the
original); only ``amplitude_to_db_power`` works on torch tensors. The
numpy part is copied rather than imported because importing
``adaa_tpu.ops`` loads jax.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _create_triangular_filterbank(all_freqs: np.ndarray, f_pts: np.ndarray) -> np.ndarray:
    """Triangular filterbank, shape (n_freqs, n_filters)."""
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_filter + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_filter + 2)
    down_slopes = (-1.0 * slopes[:, :-2]) / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down_slopes, up_slopes))


@functools.lru_cache(maxsize=16)
def linear_fbanks(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_filter: int,
    sample_rate: int,
) -> np.ndarray:
    """Linear-frequency triangular filterbank (torchaudio.functional.linear_fbanks)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    f_pts = np.linspace(f_min, f_max, n_filter + 2)
    return _create_triangular_filterbank(all_freqs, f_pts).astype(np.float32)


def hz_to_mel(freq, mel_scale: str = "htk"):
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)
    raise NotImplementedError(mel_scale)


def mel_to_hz(mels, mel_scale: str = "htk"):
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (np.asarray(mels, dtype=np.float64) / 2595.0) - 1.0)
    raise NotImplementedError(mel_scale)


@functools.lru_cache(maxsize=16)
def melscale_fbanks(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
    norm: str = None,
    mel_scale: str = "htk",
) -> np.ndarray:
    """Mel triangular filterbank (torchaudio.functional.melscale_fbanks)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_min = hz_to_mel(f_min, mel_scale)
    m_max = hz_to_mel(f_max, mel_scale)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)
    fb = _create_triangular_filterbank(all_freqs, f_pts)
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb *= enorm[None, :]
    elif norm is not None:
        raise NotImplementedError(norm)
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=16)
def create_dct(n_mfcc: int, n_mels: int, norm: str = "ortho") -> np.ndarray:
    """DCT-II matrix, shape (n_mels, n_mfcc) (torchaudio.functional.create_dct)."""
    n = np.arange(float(n_mels))
    k = np.arange(float(n_mfcc))[:, None]
    dct = np.cos(np.pi / float(n_mels) * (n + 0.5) * k)  # (n_mfcc, n_mels)
    if norm is None:
        dct *= 2.0
    else:
        assert norm == "ortho"
        dct[0] *= 1.0 / np.sqrt(2.0)
        dct *= np.sqrt(2.0 / float(n_mels))
    return dct.T.astype(np.float32)


def amplitude_to_db_power(x: torch.Tensor, amin: float = 1e-10) -> torch.Tensor:
    """``AmplitudeToDB('power', top_db=None)``: 10 * log10(clamp(x, amin)).

    db_multiplier = log10(max(amin, ref=1.0)) = 0, so no ref subtraction;
    top_db is None in both LFCC and MFCC transforms, so no clamping.
    """
    return 10.0 * torch.log10(torch.clamp(x, min=amin))
