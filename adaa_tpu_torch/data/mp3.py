"""MP3 decode (and test-fixture encode) via the system codec libraries
(a copy of ``adaa_tpu/data/mp3.py``).

The FakeAVCeleb audio corpus is ``.mp3`` (reference
src/datasets/fakeavceleb_dataset.py:18-20,91-93; decoded at
base_dataset.py:165 via torchaudio). ``libmpg123`` (decoder) and
``libmp3lame`` (encoder) are standard system libraries; binding them
through ctypes gives a decode path with no Python packaging at all.

``mp3_decode`` returns float32 (C, T) in [-1, 1] plus the sample rate
(the ``torchaudio.load(normalize=True)`` contract). ``mp3_encode``
exists so tests and ``chip_smoke.py`` can write real MP3 streams (the
FakeAVCeleb mini-corpus).

Both return None when their library is absent; ``available()`` and
``encoder_available()`` say which is there, and ``data.base.load_audio``
raises naming libmpg123 for an ``.mp3`` without it.
"""
from __future__ import annotations

import ctypes
import logging
import os
import tempfile
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

LOGGER = logging.getLogger(__name__)

# mpg123.h constants
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_FLOAT_32 = 0x200

_mpg123 = None
_mpg123_tried = False
_lame = None
_lame_tried = False


def _load_mpg123():
    global _mpg123, _mpg123_tried
    if _mpg123 is not None or _mpg123_tried:
        return _mpg123
    _mpg123_tried = True
    try:
        lib = ctypes.CDLL("libmpg123.so.0")
    except OSError:
        LOGGER.info("libmpg123 unavailable; mp3 decode disabled")
        return None
    lib.mpg123_init()
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                  ctypes.c_int, ctypes.c_int]
    lib.mpg123_read.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    _mpg123 = lib
    return lib


def _load_lame():
    global _lame, _lame_tried
    if _lame is not None or _lame_tried:
        return _lame
    _lame_tried = True
    try:
        lib = ctypes.CDLL("libmp3lame.so.0")
    except OSError:
        LOGGER.info("libmp3lame unavailable; mp3 encode disabled")
        return None
    lib.lame_init.restype = ctypes.c_void_p
    for name in ("lame_set_in_samplerate", "lame_set_num_channels",
                 "lame_set_brate"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.lame_init_params.argtypes = [ctypes.c_void_p]
    lib.lame_encode_buffer.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
    ]
    lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int]
    lib.lame_close.argtypes = [ctypes.c_void_p]
    _lame = lib
    return lib


def available() -> bool:
    """Whether the system libmpg123 (the decoder) loads."""
    return _load_mpg123() is not None


def encoder_available() -> bool:
    """Whether the system libmp3lame (the encoder) loads."""
    return _load_lame() is not None


def mp3_decode(
    path_or_bytes: Union[str, Path, bytes, bytearray],
) -> Optional[Tuple[np.ndarray, int]]:
    """Decode MP3 to (float32 (C, T) in [-1, 1], sample_rate)."""
    lib = _load_mpg123()
    if lib is None:
        return None

    tmp = None
    if isinstance(path_or_bytes, (bytes, bytearray)):
        tmp = tempfile.NamedTemporaryFile(suffix=".mp3", delete=False)
        tmp.write(bytes(path_or_bytes))
        tmp.close()
        path = tmp.name
    else:
        path = str(path_or_bytes)

    try:
        err = ctypes.c_int(0)
        h = lib.mpg123_new(None, ctypes.byref(err))
        if not h:
            return None
        try:
            # format restrictions must be registered BEFORE open — the
            # stream's output format is negotiated at open time (with
            # them set afterwards mpg123 keeps emitting s16)
            lib.mpg123_format_none(h)
            for sr in (8000, 11025, 12000, 16000, 22050, 24000,
                       32000, 44100, 48000):
                lib.mpg123_format(h, sr, 3,  # MONO|STEREO
                                  _MPG123_ENC_FLOAT_32)
            if lib.mpg123_open(h, path.encode()) != _MPG123_OK:
                return None
            rate = ctypes.c_long()
            ch = ctypes.c_int()
            enc = ctypes.c_int()
            if (lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(ch),
                                     ctypes.byref(enc)) != _MPG123_OK):
                return None
            if enc.value != _MPG123_ENC_FLOAT_32:
                return None

            chunks = []
            bufsize = 1 << 18
            buf = (ctypes.c_char * bufsize)()
            done = ctypes.c_size_t()
            while True:
                r = lib.mpg123_read(h, buf, bufsize, ctypes.byref(done))
                if done.value:
                    chunks.append(bytes(buf[: done.value]))
                if r == _MPG123_DONE:
                    break
                if r not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                    if not chunks:
                        return None
                    break
            if not chunks:
                return None
            pcm = np.frombuffer(b"".join(chunks), np.float32)
            nch = max(ch.value, 1)
            pcm = pcm[: (pcm.size // nch) * nch].reshape(-1, nch).T
            return np.ascontiguousarray(pcm), int(rate.value)
        finally:
            lib.mpg123_close(h)
            lib.mpg123_delete(h)
    finally:
        if tmp is not None:
            os.unlink(tmp.name)


def mp3_encode(
    pcm: np.ndarray, sample_rate: int, bitrate_kbps: int = 128,
) -> Optional[bytes]:
    """Encode float32 (C, T) or (T,) PCM in [-1, 1] to an MP3 stream."""
    lib = _load_lame()
    if lib is None:
        return None
    pcm = np.asarray(pcm, np.float32)
    if pcm.ndim == 1:
        pcm = pcm[None, :]
    ch, n = pcm.shape
    if ch not in (1, 2):
        return None
    i16 = np.clip(pcm * 32767.0, -32768, 32767).astype(np.int16)
    left = np.ascontiguousarray(i16[0])
    right = np.ascontiguousarray(i16[1] if ch == 2 else i16[0])
    i16p = ctypes.POINTER(ctypes.c_int16)

    gfp = lib.lame_init()
    if not gfp:
        return None
    try:
        lib.lame_set_in_samplerate(gfp, sample_rate)
        lib.lame_set_num_channels(gfp, ch)
        lib.lame_set_brate(gfp, bitrate_kbps)
        if lib.lame_init_params(gfp) < 0:
            return None
        outsize = int(1.25 * n) + 7200
        out = (ctypes.c_char * outsize)()
        n1 = lib.lame_encode_buffer(
            gfp, left.ctypes.data_as(i16p), right.ctypes.data_as(i16p),
            n, out, outsize,
        )
        if n1 < 0:
            return None
        tail = (ctypes.c_char * 7200)()
        n2 = lib.lame_encode_flush(gfp, tail, 7200)
        return bytes(out[:n1]) + bytes(tail[:max(n2, 0)])
    finally:
        lib.lame_close(gfp)
