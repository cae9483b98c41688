"""Host-side audio preprocessing and the base datasets (port of
``adaa_tpu/data/base.py``; the same functions, bit for bit).

Replaces the reference's libsox pipeline (reference:
src/datasets/base_dataset.py) with numpy/scipy and the port's host
library (``csrc/dsp.cpp`` through ``data/native.py``):

* decode (wav through scipy; flac through the host library's decoder;
  mp3 through the system libmpg123, ``data/mp3.py``; other formats
  through the optional ``soundfile``),
* polyphase resampling to 16 kHz (sox ``rate`` -> scipy resample_poly),
* the sox ``silence 1 0.2 1% -1 0.2 1%`` gate (base_dataset.py:29-33)
  as an exact port of the sox silence.c state machine (sox_silence
  below, in the host library; its python twin ``_sox_silence_py``),
* repeat-pad / cut to 64_600 samples (base_dataset.py:343-355).

The *on-batch re-preprocessing* used by the raw adversarial eval path
(base_dataset.py:122-148) re-runs the canonical pipeline **with
default arguments — including the silence trim** — on every (attacked)
waveform; wavefake_preprocessing_on_batch reproduces that faithfully
(host round trip through the native trim, then one transfer back).

The host library is built at first use and a failed build raises: no
function here falls back to numpy in its place.
"""
from __future__ import annotations

import math
from fractions import Fraction
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from adaa_tpu_torch.data import native

# Constants mirror the reference (base_dataset.py:21-33)
WAVE_FAKE_INTERFACE = True
WAVE_FAKE_SR = 16_000
WAVE_FAKE_TRIM = True
WAVE_FAKE_NORMALIZE = True
WAVE_FAKE_CELL_PHONE = False
WAVE_FAKE_PAD = True
WAVE_FAKE_CUT = 64_600

# sox silence effect params: trim silence longer than 0.2 s and quieter
# than 1% (relative to full scale) from beginning and middle/end
SOX_SILENCE = [["silence", "1", "0.2", "1%", "-1", "0.2", "1%"]]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def load_audio(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Decode an audio file to float32 [-1, 1] mono-capable array (C, T).

    Equivalent of ``torchaudio.load(path, normalize=True)``
    (base_dataset.py:165). An ``.mp3`` needs the system libmpg123, and
    raises naming it when it is absent; formats other than wav, flac and
    mp3 (and a flac stream the host decoder cannot parse) need the
    optional 'soundfile'.
    """
    path = str(path)
    if path.endswith(".wav"):
        return _load_wav(path)
    if path.endswith(".flac"):
        decoded = native.flac_decode(path)
        if decoded is not None:
            return decoded
    if path.endswith(".mp3"):
        from adaa_tpu_torch.data import mp3 as _mp3

        if not _mp3.available():
            raise RuntimeError(f"Cannot decode {path}: mp3 needs the system libmpg123 "
                               "(libmpg123.so.0), which is not installed")
        decoded = _mp3.mp3_decode(path)
        if decoded is not None:
            return decoded
    try:
        import soundfile
    except ImportError:
        raise RuntimeError(
            f"Cannot decode {path}: no decoder for it here (wav, flac and mp3 have "
            "their own; other formats need the optional 'soundfile' dependency)"
        ) from None
    data, sr = soundfile.read(path, dtype="float32", always_2d=True)
    return data.T.astype(np.float32), int(sr)


def _load_wav(path: str) -> Tuple[np.ndarray, int]:
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[None, :]
    else:
        data = data.T
    return data, int(sr)


# ---------------------------------------------------------------------------
# DSP
# ---------------------------------------------------------------------------

def resample_wave(
    waveform: np.ndarray, sample_rate: int, target_sample_rate: int
) -> Tuple[np.ndarray, int]:
    """Polyphase resampler — equivalent of sox ``rate``
    (base_dataset.py:288-293)."""
    if sample_rate == target_sample_rate:
        return waveform, sample_rate
    from scipy.signal import resample_poly

    frac = Fraction(target_sample_rate, sample_rate)
    out = resample_poly(waveform, frac.numerator, frac.denominator, axis=-1)
    return out.astype(np.float32), target_sample_rate


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
    """Exact port of sox's ``silence`` effect state machine (sox 14.4.x
    silence.c) for mono float audio — the engine behind the reference's
    SOX_SILENCE trim (base_dataset.py:29-33, applied via
    ``torchaudio.sox_effects.apply_effects_tensor`` at :273-286).

    Semantics (defaults = the reference's ``silence 1 0.2 1% -1 0.2 1%``):

    * activity = sliding RMS over the trailing ``rate/50`` (20 ms)
      samples, including the current one, compared ``>= threshold``
      (1% of full scale);
    * leading trim (SILENCE_TRIM): input is discarded until
      ``start_duration`` (0.2 s) *consecutive* above-threshold samples
      are seen; that triggering run is then emitted;
    * copy mode (SILENCE_COPY): below-threshold samples accumulate in a
      holdoff buffer — short pauses (< 0.2 s) are flushed back out when
      sound resumes; once the holdoff fills, the silence is *discarded
      entirely* and, because ``stop_periods=-1`` (sox restart mode),
      the machine returns to SILENCE_TRIM with a cleared RMS window —
      so every interior/trailing silence >= 0.2 s is removed;
    * at EOF a partial trailing holdoff (< 0.2 s of silence) is
      flushed; a partial leading run is discarded (sox drain()).

    Runs in the host library (csrc/dsp.cpp); ``_sox_silence_py`` is its
    python twin (tests/test_torch_port_data.py holds the two, and the
    JAX package's, bit-equal).
    """
    return native.sox_silence(
        x, sample_rate, start_periods, start_duration_s,
        start_threshold, stop_periods, stop_duration_s, stop_threshold,
    )


def _sox_silence_py(
    x: np.ndarray,
    sample_rate: int,
    start_periods: int,
    start_duration_s: float,
    start_threshold: float,
    stop_periods: int,
    stop_duration_s: float,
    stop_threshold: float,
) -> np.ndarray:
    """Pure-python twin of the host library's adaa_sox_silence (exact
    silence.c state machine; see sox_silence docstring)."""
    n = x.shape[0]
    do_start = start_periods > 0
    restart = stop_periods < 0
    n_stop_periods = -stop_periods if restart else stop_periods
    do_stop = stop_periods != 0
    wsize = max(1, sample_rate // 50)
    start_dur = max(1, int(start_duration_s * sample_rate + 0.5))
    stop_dur = max(1, int(stop_duration_s * sample_rate + 0.5))

    win = np.zeros(wsize, np.float64)
    cur = 0
    rms_sum = 0.0
    mode = "TRIM" if do_start else "COPY"
    i = m = 0
    out = np.empty(n, np.float32)
    start_found = stop_found = 0
    hold_start = hold_len = 0
    shold_start = shold_len = 0
    xf = x.astype(np.float64)

    while i < n:
        s2 = xf[i] * xf[i]
        if mode == "TRIM":
            val = (rms_sum - win[cur] + s2) / wsize
            above = val >= 0 and math.sqrt(val) >= start_threshold
            rms_sum -= win[cur]
            win[cur] = s2
            rms_sum += win[cur]
            cur = (cur + 1) % wsize
            if above:
                if hold_len == 0:
                    hold_start = i
                hold_len += 1
                i += 1
                if hold_len >= start_dur:
                    start_found += 1
                    if start_found >= start_periods:
                        out[m : m + hold_len] = x[hold_start : hold_start + hold_len]
                        m += hold_len
                        hold_len = 0
                        mode = "COPY"
                    else:
                        hold_len = 0
            else:
                hold_len = 0
                i += 1
        else:  # COPY
            if not do_stop:
                out[m : m + (n - i)] = x[i:]
                m += n - i
                i = n
                break
            val = (rms_sum - win[cur] + s2) / wsize
            above = val >= 0 and math.sqrt(val) >= stop_threshold
            if above and shold_len > 0:
                # COPY_FLUSH: short pause kept; sample re-processed
                out[m : m + shold_len] = x[shold_start : shold_start + shold_len]
                m += shold_len
                shold_len = 0
                continue
            rms_sum -= win[cur]
            win[cur] = s2
            rms_sum += win[cur]
            cur = (cur + 1) % wsize
            if above:
                out[m] = x[i]
                m += 1
                i += 1
            else:
                if shold_len == 0:
                    shold_start = i
                shold_len += 1
                i += 1
                if shold_len >= stop_dur:
                    stop_found += 1
                    if stop_found >= n_stop_periods:
                        shold_len = 0
                        if restart:
                            stop_found = start_found = 0
                            hold_len = 0
                            win[:] = 0.0
                            rms_sum = 0.0
                            cur = 0
                            mode = "TRIM"
                        else:
                            return out[:m].copy()  # SILENCE_STOP
                    else:
                        out[m : m + shold_len] = x[shold_start : shold_start + shold_len]
                        m += shold_len
                        shold_len = 0
    # drain: flush partial trailing stop-holdoff; partial start run dropped
    if mode == "COPY" and shold_len > 0:
        out[m : m + shold_len] = x[shold_start : shold_start + shold_len]
        m += shold_len
    return out[:m].copy()


def apply_trim(
    waveform: np.ndarray, sample_rate: int
) -> Tuple[np.ndarray, int]:
    """Silence trim with the reference's sox parameters (SOX_SILENCE,
    base_dataset.py:29-33) via the exact silence.c port above. Like the
    reference's apply_trim (base_dataset.py:273-286), if the gate
    returns nothing (fully-silent input) the original audio is kept.
    """
    x = waveform
    squeeze = x.ndim == 2
    mono = x[0] if squeeze else x
    kept = sox_silence(mono, sample_rate)
    if kept.shape[-1] == 0:
        return waveform, sample_rate
    out = kept[None, :] if squeeze else kept
    return out.astype(np.float32), sample_rate


# ---------------------------------------------------------------------------
# Phone-call simulation (reference base_dataset.py:303-322: sox lowpass
# + compand + rate 8000 + GSM codec; off by default,
# WAVE_FAKE_CELL_PHONE=False at :25)
# ---------------------------------------------------------------------------

def lowpass_biquad(
    x: np.ndarray, sample_rate: int, cutoff: float, q: float = 0.7071067811865476
) -> np.ndarray:
    """sox ``lowpass <freq>`` — 2-pole Butterworth biquad (RBJ audio-EQ
    cookbook coefficients, sox biquads.c defaults Q=0.707)."""
    from scipy.signal import lfilter

    w0 = 2.0 * math.pi * cutoff / sample_rate
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    b = np.array([(1 - cw) / 2, 1 - cw, (1 - cw) / 2], np.float64)
    a = np.array([1 + alpha, -2 * cw, 1 - alpha], np.float64)
    return lfilter(b / a[0], a / a[0], x.astype(np.float64), axis=-1).astype(
        np.float32
    )


def compand(
    x: np.ndarray,
    sample_rate: int,
    attack_s: float = 0.02,
    decay_s: float = 0.05,
    tf_points=((-60.0, -60.0), (-30.0, -10.0), (-20.0, -8.0),
               (-5.0, -8.0), (-2.0, -8.0)),
    gain_db: float = -8.0,
    initial_volume_db: float = -7.0,
    delay_s: float = 0.05,
) -> np.ndarray:
    """sox ``compand`` (compand.c/compandt.c model) — defaults are the
    reference's phone-call parameters (base_dataset.py:307-315):
    ``compand 0.02,0.05 -60,-60,-30,-10,-20,-8,-5,-8,-2,-8 -8 -7 0.05``.

    Model (as in sox): a per-sample envelope follower
    ``v += (|x|-v) * (1-exp(-1/(rate*T)))`` with separate attack/decay
    time constants; the transfer function is piecewise-linear in the dB
    domain over the given (in,out) points with the makeup ``gain_db``
    folded into the outputs and — as sox's compandt.c does ("Add 0,0 if
    necessary") — an appended (0,0) point when the curve doesn't end at
    full scale; quiet inputs below the first point get that point's
    constant gain. The gain derived from the *current* envelope is
    applied to the sample ``delay_s`` earlier (lookahead delay buffer,
    flushed at EOF like sox's drain). Soft-knee radius is not
    implemented (the reference passes none).
    """
    mono = np.ascontiguousarray(x, np.float64).reshape(-1)
    n = mono.shape[0]

    pts = [(float(i), float(o) + gain_db) for i, o in tf_points]
    if pts[-1] != (0.0, gain_db):  # sox: append 0 dB point (+ gain)
        pts.append((0.0, 0.0 + gain_db))
    xs = np.array([p[0] for p in pts])
    ys = np.array([p[1] for p in pts])

    def transfer_gain(v: float) -> float:
        """linear gain for detected volume v (linear)."""
        if v <= 0.0:
            return 10.0 ** ((ys[0] - xs[0]) / 20.0)
        in_db = 20.0 * math.log10(v)
        if in_db <= xs[0]:
            out_db = in_db + (ys[0] - xs[0])  # slope-1 extension below
        else:
            out_db = float(np.interp(in_db, xs, ys))
        return 10.0 ** ((out_db - in_db) / 20.0)

    att = 1.0 - math.exp(-1.0 / (sample_rate * attack_s)) \
        if attack_s > 1.0 / sample_rate else 1.0
    dec = 1.0 - math.exp(-1.0 / (sample_rate * decay_s)) \
        if decay_s > 1.0 / sample_rate else 1.0

    delay = int(delay_s * sample_rate + 0.5)
    out = np.empty(n, np.float64)
    v = 10.0 ** (initial_volume_db / 20.0)
    m = 0
    for i in range(n):
        d = abs(mono[i]) - v
        v += d * (att if d > 0 else dec)
        if delay > 0:
            if i >= delay:  # gain from current volume, delayed sample
                out[m] = mono[i - delay] * transfer_gain(v)
                m += 1
        else:
            out[m] = mono[i] * transfer_gain(v)
            m += 1
    # drain: flush the delay buffer with the final envelope's gain
    if delay > 0:
        g = transfer_gain(v)
        tail = mono[n - min(delay, n):]
        out[m : m + tail.shape[0]] = tail * g
        m += tail.shape[0]
    return out[:m].astype(np.float32)


def gsm_codec_roundtrip(x: np.ndarray, sample_rate: int) -> np.ndarray:
    """GSM 06.10 full-rate encode+decode round trip — the reference's
    ``apply_codec(waveform, sample_rate, format="gsm")``
    (base_dataset.py:321), in the host library."""
    return native.gsm_roundtrip(np.asarray(x, np.float32).reshape(-1), sample_rate)


def process_phone_call(
    waveform: np.ndarray, sample_rate: int, codec: Optional[str] = "gsm"
) -> Tuple[np.ndarray, int]:
    """Phone-call simulation (reference base_dataset.py:303-322):
    ``lowpass 4000`` -> ``compand 0.02,0.05 -60,-60,-30,-10,-20,-8,-5,-8,
    -2,-8 -8 -7 0.05`` -> ``rate 8000`` -> GSM codec round trip.
    Like the reference, the output stays at 8 kHz (the canonical
    pipeline pads it to 64_600 at 8 kHz afterwards — quirk preserved).
    """
    squeeze = waveform.ndim == 2
    mono = waveform[0] if squeeze else waveform
    w = lowpass_biquad(mono, sample_rate, 4000.0)
    w = compand(w, sample_rate)
    w, sr = resample_wave(w, sample_rate, 8000)
    w = w.reshape(-1)
    if codec == "gsm":
        w = gsm_codec_roundtrip(w, sr)
    elif codec not in (None, "none"):
        raise ValueError(f"unsupported codec {codec!r}")
    out = w[None, :] if squeeze else w
    return out.astype(np.float32), sr


def apply_pad(waveform: np.ndarray, cut: int = WAVE_FAKE_CUT) -> np.ndarray:
    """Repeat-pad/cut to exactly ``cut`` samples
    (PadDataset.apply_pad, base_dataset.py:343-355)."""
    w = waveform[0] if waveform.ndim == 2 else waveform
    return native.repeat_pad(w, cut)


def _repeat_pad_py(w: np.ndarray, cut: int) -> np.ndarray:
    """numpy twin of the host library's repeat-pad/cut (``apply_pad``)."""
    length = w.shape[-1]
    if length >= cut:
        return w[:cut]
    num_repeats = int(cut / length) + 1
    return np.tile(w, num_repeats)[:cut]


def wavefake_preprocessing(
    waveform: np.ndarray,
    sample_rate: int,
    wave_fake_sr: Optional[int] = None,
    wave_fake_trim: Optional[bool] = None,
    wave_fake_cell_phone: Optional[bool] = None,
    wave_fake_pad: Optional[bool] = None,
    wave_fake_cut: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """Canonical pipeline (base_dataset.py:82-120): resample -> mono ->
    trim -> (phone-call sim, off by default) -> repeat-pad/cut."""
    wave_fake_sr = WAVE_FAKE_SR if wave_fake_sr is None else wave_fake_sr
    wave_fake_trim = WAVE_FAKE_TRIM if wave_fake_trim is None else wave_fake_trim
    wave_fake_cell_phone = (
        WAVE_FAKE_CELL_PHONE if wave_fake_cell_phone is None else wave_fake_cell_phone
    )
    wave_fake_pad = WAVE_FAKE_PAD if wave_fake_pad is None else wave_fake_pad
    wave_fake_cut = WAVE_FAKE_CUT if wave_fake_cut is None else wave_fake_cut

    if sample_rate != wave_fake_sr and wave_fake_sr != -1:
        waveform, sample_rate = resample_wave(waveform, sample_rate, wave_fake_sr)

    if waveform.ndim > 1 and waveform.shape[0] > 1:
        waveform = waveform[:1, ...]

    if wave_fake_trim:
        waveform, sample_rate = apply_trim(waveform, sample_rate)

    if wave_fake_cell_phone:
        waveform, sample_rate = process_phone_call(waveform, sample_rate)

    if wave_fake_pad:
        waveform = apply_pad(waveform, wave_fake_cut)

    return np.asarray(waveform, np.float32).reshape(-1), sample_rate


def wavefake_preprocessing_on_batch(
    batch_waveform, batch_sample_rate, *args, **kwargs
):
    """Batched re-preprocessing for the raw adversarial eval path —
    behavioral mirror of the reference's
    ``wavefake_preprocessing_on_batch`` (base_dataset.py:122-148):
    pull the batch to host, run the canonical per-sample pipeline
    **with default args** (resample -> trim -> repeat-pad/cut to
    64_600; trim IS on by default — the attacked waveform is
    silence-trimmed and re-padded before the victim sees it, exactly
    as in evaluate_models_on_adversarial_attacks.py:229-234), restack.

    Returns numpy arrays; the caller moves them back to its device (the
    reference restores the original device the same way). The host
    round trip matches the reference's; the per-sample trim runs in
    the host library's C gate.
    """
    bw = np.asarray(batch_waveform)
    srs = np.asarray(batch_sample_rate).reshape(-1)
    waves, out_srs = [], []
    for b in range(bw.shape[0]):
        w, s = wavefake_preprocessing(
            bw[b][None, :], int(srs[b]), *args, **kwargs
        )
        waves.append(w)
        out_srs.append(s)
    return np.stack(waves).astype(np.float32), np.asarray(out_srs, srs.dtype)


def find_wav_files(path_to_dir) -> Optional[list]:
    """All wav files under a directory tree, sorted
    (reference src/utils.py:18-30); None when none found."""
    paths = list(sorted(Path(path_to_dir).glob("**/*.wav")))
    if len(paths) == 0:
        return None
    return paths


class AudioDataset:
    """Generic directory-walking wav dataset
    (reference base_dataset.py:208-325): items are (waveform, sr) after
    optional resample + silence trim (+ phone-call sim, unsupported
    here as in our preprocessing — off by default in the reference)."""

    def __init__(
        self,
        directory_or_path_list,
        sample_rate: int = 16_000,
        amount: Optional[int] = None,
        normalize: bool = True,
        trim: bool = True,
        phone_call: bool = False,
    ) -> None:
        self.trim = trim
        self.sample_rate = sample_rate
        self.normalize = normalize
        self.phone_call = phone_call

        if isinstance(directory_or_path_list, list):
            paths = directory_or_path_list
        elif isinstance(directory_or_path_list, (str, Path)):
            directory = Path(directory_or_path_list)
            if not directory.exists():
                raise IOError(f"Directory does not exists: {directory}")
            paths = find_wav_files(directory)
            if paths is None:
                raise IOError(
                    f"Directory did not contain wav files: {directory}"
                )
        else:
            raise TypeError(
                "Supplied unsupported type for argument "
                f"directory_or_path_list {type(directory_or_path_list)}!"
            )
        if amount is not None:
            paths = paths[:amount]
        self._paths = paths

    def __getitem__(self, index: int):
        path = self._paths[index]
        waveform, sample_rate = load_audio(path)
        if sample_rate != self.sample_rate:
            waveform, sample_rate = resample_wave(
                waveform, sample_rate, self.sample_rate
            )
        if self.trim:
            waveform, sample_rate = apply_trim(waveform, sample_rate)
        if self.phone_call:
            waveform, sample_rate = process_phone_call(waveform, sample_rate)
        return waveform, sample_rate

    def __len__(self) -> int:
        return len(self._paths)


class PadDataset:
    """Wrap a (waveform, sr) dataset with repeat-pad/cut
    (reference base_dataset.py:328-358)."""

    def __init__(self, dataset, cut: int = WAVE_FAKE_CUT, label=None):
        self.dataset = dataset
        self.cut = cut  # max 4 sec (ASVSpoof default)
        self.label = label

    def __getitem__(self, index):
        waveform, sample_rate = self.dataset[index]
        waveform = apply_pad(waveform, self.cut)
        if self.label is None:
            return waveform, sample_rate
        return waveform, sample_rate, self.label

    def __len__(self):
        return len(self.dataset)
