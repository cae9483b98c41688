"""ctypes bindings of the port's host DSP library (``csrc/dsp.cpp``).

The library is built at first use by ``ops/_build.py`` into
``adaa_tpu_torch/_build/libdsp.so`` (the host C++ compiler, the flags of
the JAX package's ``native/Makefile``), like the CUDA kernels, and a
failed build raises: there is no numpy fallback behind these functions.
The numpy twins (``data.base._sox_silence_py``, the ``np.tile`` pad) are
plain versions for the tests. The semantics are those of
``adaa_tpu/data/native.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

_F32P = ctypes.POINTER(ctypes.c_float)
_I16P = ctypes.POINTER(ctypes.c_int16)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)

ARGTYPES = {
    "adaa_normalize_i16": ([_I16P, _F32P, ctypes.c_int64], None),
    "adaa_sox_silence": ([_F32P, ctypes.c_int64, _F32P,
                          ctypes.c_int32, ctypes.c_int64, ctypes.c_float,
                          ctypes.c_int32, ctypes.c_int64, ctypes.c_float,
                          ctypes.c_int64], ctypes.c_int64),
    "adaa_gsm_roundtrip": ([_F32P, ctypes.c_int64, _F32P], ctypes.c_int64),
    "adaa_flac_decode": ([_U8P, ctypes.c_int64, _I32P, ctypes.c_int64, _I64P], ctypes.c_int64),
    "adaa_repeat_pad": ([_F32P, ctypes.c_int64, _F32P, ctypes.c_int64], None),
}

_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """``libdsp.so``, built from ``csrc/dsp.cpp`` on first use."""
    global _lib
    if _lib is None:
        from adaa_tpu_torch.ops import _build

        lib = _build.load("dsp")
        for name, (argtypes, restype) in ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
    return _lib


def _f32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).reshape(-1)


def normalize_i16(pcm: np.ndarray) -> np.ndarray:
    pcm = np.ascontiguousarray(pcm, np.int16)
    out = np.empty(pcm.shape, np.float32)
    library().adaa_normalize_i16(pcm.ctypes.data_as(_I16P), out.ctypes.data_as(_F32P), pcm.size)
    return out


def sox_silence(
    x: np.ndarray,
    sample_rate: int,
    start_periods: int = 1,
    start_duration_s: float = 0.2,
    start_threshold: float = 0.01,
    stop_periods: int = -1,
    stop_duration_s: float = 0.2,
    stop_threshold: float = 0.01,
) -> np.ndarray:
    """The sox ``silence`` effect (the exact silence.c state machine); see
    ``data.base.sox_silence`` for the semantics and its python twin."""
    x = _f32(x)
    out = np.empty_like(x)
    kept = library().adaa_sox_silence(
        x.ctypes.data_as(_F32P), x.size, out.ctypes.data_as(_F32P),
        start_periods, int(start_duration_s * sample_rate + 0.5), start_threshold,
        stop_periods, int(stop_duration_s * sample_rate + 0.5), stop_threshold,
        sample_rate // 50,
    )
    return out[:kept].copy()


def gsm_roundtrip(x: np.ndarray, sample_rate: int) -> np.ndarray:
    """GSM 06.10 encode + decode round trip. GSM codes whole 160-sample
    frames; sox and ffmpeg zero-pad the last partial frame, so the output
    is padded up to a multiple of 160."""
    x = _f32(x)
    out = np.zeros(-(-x.size // 160) * 160, np.float32)
    wrote = library().adaa_gsm_roundtrip(x.ctypes.data_as(_F32P), x.size,
                                         out.ctypes.data_as(_F32P))
    if wrote < 0:
        raise RuntimeError(f"GSM round trip failed on {x.size} samples")
    return out[:wrote].copy()


def flac_decode(path_or_bytes) -> Optional[tuple]:
    """Decode a FLAC file or buffer to (float32 (C, T) in [-1, 1],
    sample_rate), as ``data.base.load_audio``; None when the stream cannot
    be parsed. Reference decode site: src/datasets/base_dataset.py:165
    (torchaudio.load on ASVspoof2021-DF flac files)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
    else:
        raw = Path(path_or_bytes).read_bytes()
    lib = library()
    buf = np.frombuffer(raw, np.uint8)
    meta = np.zeros(4, np.int64)
    # the metadata pass returns the exact per-channel sample count, even
    # when STREAMINFO omits it (the decoder walks the frames counting)
    total = lib.adaa_flac_decode(buf.ctypes.data_as(_U8P), buf.size, None, 0,
                                 meta.ctypes.data_as(_I64P))
    if total < 0:
        return None
    channels, srate, bps = int(meta[0]), int(meta[1]), int(meta[2])
    out = np.empty(int(total) * channels, np.int32)
    n = lib.adaa_flac_decode(buf.ctypes.data_as(_U8P), buf.size, out.ctypes.data_as(_I32P),
                             out.size, meta.ctypes.data_as(_I64P))
    if n < 0:
        return None
    pcm = out[: n * channels].reshape(-1, channels).T
    return pcm.astype(np.float32) / np.float32(1 << (bps - 1)), srate


def repeat_pad(x: np.ndarray, cut: int) -> np.ndarray:
    x = _f32(x)
    if x.size == 0 and cut > 0:  # the C loop would never end
        raise ValueError("cannot repeat-pad an empty wave")
    out = np.empty(cut, np.float32)
    library().adaa_repeat_pad(x.ctypes.data_as(_F32P), x.size, out.ctypes.data_as(_F32P), cut)
    return out
