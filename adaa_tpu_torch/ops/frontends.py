"""Differentiable audio frontends (LFCC / MFCC / mel_spec).

Port of ``adaa_tpu/ops/frontends.py``. The cepstral frontends (the
``_lfcc_xla`` path, and ``mfcc`` which shares every piece): STFT power
spectrum, a 257 -> 128 triangular filterbank, 10 * log10, and an ortho
DCT 128 -> n_coeff. Both map (B, 64600) -> (B, n_coeff, T) with T = 404
frames and differentiate with respect to the waveform (the attacks
backpropagate through the frontend).

``lfcc`` takes the fused kernel (``ops/lfcc_fused.py``, the counterpart
of ``adaa_tpu/ops/pallas_lfcc.py``) when it is switched on, as the JAX
``lfcc`` does under ``ADAA_PALLAS_FRONTEND=1``. ``mfcc`` stays unfused,
as in the JAX package.

``mel_spec`` (the reference's ``prepare_mel_scale_vector``): the STFT
with a rectangular window of ``win_length`` (``torch.stft`` called
without a window), the real and imaginary parts each projected on 80
htk mel filters (``norm=None``), then (abs, angle) stacked as
(..., 2, n_mels, T), always in f32.
"""
from __future__ import annotations

import functools
import os
from typing import Callable, List, Optional

import torch

from adaa_tpu_torch.ops import filterbanks as fb
from adaa_tpu_torch.ops import lfcc_fused
from adaa_tpu_torch.ops import stft as stft_ops
from adaa_tpu_torch.ops.stft import device_constant

SAMPLING_RATE = 16_000
WIN_LENGTH = 400  # 25 ms
HOP_LENGTH = 160  # 10 ms
N_FFT = 512


def fused_frontend_on(fused: Optional[bool] = None) -> bool:
    """The fused-LFCC switch: ``fused`` if given, else
    ``ADAA_PALLAS_FRONTEND == "1"``, read per call as the JAX package does."""
    return os.environ.get("ADAA_PALLAS_FRONTEND") == "1" if fused is None else fused


def lfcc(x: torch.Tensor, n_lfcc: int = 80, n_filter: int = 128,
         compute: str = "f32", fused: Optional[bool] = None,
         reference: bool = False) -> torch.Tensor:
    """(..., L) -> (..., n_lfcc, T). torchaudio.transforms.LFCC equivalent.

    With the fused switch on (``fused_frontend_on``), the default
    coefficients and a 2-D 64,600-sample input, the forward is the fused
    kernel in f32 whatever ``compute`` says (the JAX package's bf16 LCNN
    gets an f32 frontend under its switch too); ``reference=True`` runs
    that path's plain-torch version on any device. The gradient
    recomputes through the unfused f32 path.
    """
    if (n_lfcc == lfcc_fused.N_CEP and n_filter == lfcc_fused.N_FILTER and x.dim() == 2
            and x.shape[-1] == lfcc_fused.WAVE_LEN and fused_frontend_on(fused)):
        return (lfcc_fused.cepstra_fused_reference if reference
                else lfcc_fused.cepstra_fused)(x, "linear")
    spec = stft_ops.spectrogram(
        x, n_fft=N_FFT, hop_length=HOP_LENGTH, win_length=WIN_LENGTH,
        power=2.0, compute=compute,
    )  # (..., F, T)
    filt = device_constant(
        fb.linear_fbanks,
        (N_FFT // 2 + 1, 0.0, SAMPLING_RATE / 2, n_filter, SAMPLING_RATE),
        spec.device,
    )  # (F, n_filter)
    banked_db = fb.amplitude_to_db_power(_banked_einsum(spec, filt, compute))
    dct = device_constant(fb.create_dct, (n_lfcc, n_filter, "ortho"), spec.device)
    return _dct_einsum(banked_db, dct, compute)


def mfcc(x: torch.Tensor, n_mfcc: int = 80, n_mels: int = 128,
         compute: str = "f32") -> torch.Tensor:
    """(..., L) -> (..., n_mfcc, T). torchaudio.transforms.MFCC equivalent."""
    spec = stft_ops.spectrogram(
        x, n_fft=N_FFT, hop_length=HOP_LENGTH, win_length=WIN_LENGTH,
        power=2.0, compute=compute,
    )
    filt = device_constant(
        fb.melscale_fbanks,
        (N_FFT // 2 + 1, 0.0, SAMPLING_RATE / 2, n_mels, SAMPLING_RATE, None, "htk"),
        spec.device,
    )
    banked_db = fb.amplitude_to_db_power(_banked_einsum(spec, filt, compute))
    dct = device_constant(fb.create_dct, (n_mfcc, n_mels, "ortho"), spec.device)
    return _dct_einsum(banked_db, dct, compute)


def prepare_stft_features(x: torch.Tensor, n_mels: int = 80):
    """Mel-projected complex STFT -> (abs, angle), each (..., n_mels, T)."""
    real, imag = stft_ops.stft(x, n_fft=N_FFT, hop_length=HOP_LENGTH, win_length=WIN_LENGTH,
                               window="ones")
    filt = device_constant(
        fb.melscale_fbanks,
        (N_FFT // 2 + 1, 0.0, SAMPLING_RATE / 2, n_mels, SAMPLING_RATE, None, "htk"),
        real.device,
    )
    real_mel = torch.einsum("...ft,fm->...mt", real, filt)
    imag_mel = torch.einsum("...ft,fm->...mt", imag, filt)
    return torch.sqrt(real_mel * real_mel + imag_mel * imag_mel), torch.atan2(imag_mel, real_mel)


def mel_spec(x: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., 2, n_mels, T): stacked (abs, angle) channels."""
    abs_mel, angle_mel = prepare_stft_features(x)
    return torch.stack([abs_mel, angle_mel], dim=-3)


def _bf16_inputs(*ts: torch.Tensor):
    """Round to bf16 and back: an f32 product of the results is exactly a
    bf16 x bf16 product with f32 accumulation and an f32 result."""
    return [t.to(torch.bfloat16).float() for t in ts]


def _dct_einsum(banked_db: torch.Tensor, dct: torch.Tensor, compute: str) -> torch.Tensor:
    """Cepstral DCT; bf16 inputs with f32 accumulation on the accelerator's
    attack-surrogate path, f32 otherwise."""
    if compute == "bf16" and banked_db.device.type != "cpu":
        banked_db, dct = _bf16_inputs(banked_db, dct)
    return torch.einsum("...mt,mc->...ct", banked_db.float(), dct)


def _banked_einsum(spec: torch.Tensor, filt: torch.Tensor, compute: str) -> torch.Tensor:
    """Filterbank projection; bf16 inputs with f32 accumulation on the
    accelerator's attack-surrogate path, f32 otherwise."""
    if compute == "bf16" and spec.device.type != "cpu":
        spec, filt = _bf16_inputs(spec, filt)
    return torch.einsum("...ft,fm->...mt", spec.float(), filt)


def get_frontend(
    frontends: List[str], compute: str = "f32", fused: Optional[bool] = None,
    reference: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Dispatch mirroring ``adaa_tpu.ops.frontends.get_frontend``;
    ``fused`` and ``reference`` reach ``lfcc`` only, and ``mel_spec`` is
    always f32."""
    if "mfcc" in frontends:
        return functools.partial(mfcc, compute=compute)
    if "lfcc" in frontends:
        return functools.partial(lfcc, compute=compute, fused=fused, reference=reference)
    if "mel_spec" in frontends:
        return mel_spec
    raise ValueError(f"{frontends} frontend is not supported!")
