"""The port's data layer (``adaa_tpu_torch.data``) vs ``adaa_tpu.data`` (CPU).

Tolerances: none. The DSP (the sox silence trim, repeat-pad, resampling,
the phone-call chain, PCM normalisation), the decoders and the canonical
preprocessing are equal bit for bit (``np.testing.assert_array_equal``);
the manifests of the three corpora (and ASVspoof2019-LA) and
``DetectionDataset`` are equal row for row and column for column, and the
port's loader over them yields the same arrays in the same order.

The JAX package's native library is built for this module apart from
``native/`` (``torch_port_common.jax_native``), so the build race of its
loader under xdist cannot reach these tests. The corpora come from
``tests/torch_port_corpus.py``.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy.io import wavfile

from adaa_tpu.data import base as jbase
from adaa_tpu.data import datasets as jds
from adaa_tpu.data import detection as jdet
from adaa_tpu.data.loader import DataLoader as JDataLoader
from adaa_tpu_torch.data import base as tbase
from adaa_tpu_torch.data import datasets as tds
from adaa_tpu_torch.data import detection as tdet
from adaa_tpu_torch.data import misc as tmisc
from adaa_tpu_torch.data import mp3 as tmp3
from adaa_tpu_torch.data import native as tnative
from adaa_tpu_torch.data.loader import DataLoader as TDataLoader
from adaa_tpu_torch.ops import _build
from tests import torch_port_corpus as corpus
from tests.oracles.flac_writer import encode_flac
from tests.torch_port_common import jax_native

HAVE_MP3 = tmp3.available() and tmp3.encoder_available()
needs_mp3 = pytest.mark.skipif(not HAVE_MP3, reason="system libmpg123 / libmp3lame absent")
SOX_ARGS = (1, 0.2, 0.01, -1, 0.2, 0.01)  # the reference's silence 1 0.2 1% -1 0.2 1%


@pytest.fixture(scope="module", autouse=True)
def jnative(jax_native):
    return jax_native


def _same(*arrays):
    for a in arrays[1:]:
        np.testing.assert_array_equal(a, arrays[0])
        assert a.dtype == arrays[0].dtype


def _trims(x, sr):
    """The trim four ways: port native and twin, JAX's route and twin."""
    return (tbase.sox_silence(x, sr), tbase._sox_silence_py(x, sr, *SOX_ARGS),
            jbase.sox_silence(x, sr), jbase._sox_silence_py(x, sr, *SOX_ARGS))


# --------------------------------------------------------------------------
# DSP, bit for bit
# --------------------------------------------------------------------------

def _tone(rng, n, sr):
    t = np.arange(n) / sr
    return (0.4 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)
            + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _with_silence(sr, silence_s, where, seed=0):
    """Loud 0.5 s tones with ``silence_s`` of 1e-4 noise at the start, in
    the middle, at the end or at all three."""
    rng = np.random.default_rng(seed)
    quiet = (1e-4 * rng.standard_normal(int(round(silence_s * sr)))).astype(np.float32)
    loud = [_tone(rng, sr // 2, sr) for _ in range(2)]
    parts = {"lead": [quiet, loud[0], loud[1]], "middle": [loud[0], quiet, loud[1]],
             "trail": [loud[0], loud[1], quiet],
             "everywhere": [quiet, loud[0], quiet, loud[1], quiet]}[where]
    return np.concatenate(parts)


@pytest.mark.parametrize("where", ["lead", "middle", "trail", "everywhere"])
@pytest.mark.parametrize("silence_s", [0.19, 0.2, 0.21])
@pytest.mark.parametrize("sr", [16_000, 8_000])
def test_sox_silence_matches_jax(sr, silence_s, where):
    """Silences around the 0.2 s holdoff: shorter pauses are kept, longer
    ones cut, in all four implementations alike."""
    x = _with_silence(sr, silence_s, where)
    got = _trims(x, sr)
    _same(*got)
    if where in ("lead", "everywhere") and silence_s >= 0.2:
        assert got[0].size < x.size


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), sr=st.sampled_from([8_000, 16_000]))
def test_sox_silence_matches_jax_on_random_segments(seed, sr):
    """Segments whose levels straddle the 1% gate (restarts, holdoff
    flushes, the window's drain)."""
    rng = np.random.default_rng(seed)
    segs = [(rng.standard_normal(int(rng.integers(50, sr // 4)))
             * rng.choice([0.0, 0.003, 0.01, 0.012, 0.05, 0.4])).astype(np.float32)
            for _ in range(int(rng.integers(1, 7)))]
    _same(*_trims(np.concatenate(segs), sr))


@pytest.mark.parametrize("wave", ["zeros", "noise"])
def test_fully_silent_wave_keeps_the_original(wave):
    x = np.zeros(16_000, np.float32) if wave == "zeros" else (
        1e-4 * np.random.default_rng(1).standard_normal(16_000)).astype(np.float32)
    for trims in _trims(x, 16_000):
        assert trims.size == 0
    for apply_trim in (tbase.apply_trim, jbase.apply_trim):
        out, sr = apply_trim(x[None, :], 16_000)
        assert sr == 16_000
        np.testing.assert_array_equal(out, x[None, :])


@pytest.mark.parametrize("length", [1, 1_000, 64_599, 64_600, 64_601, 200_000])
def test_apply_pad_matches_jax(length):
    x = np.random.default_rng(length).standard_normal(length).astype(np.float32)
    _same(tbase.apply_pad(x), tbase._repeat_pad_py(x, tbase.WAVE_FAKE_CUT), jbase.apply_pad(x),
          tbase.apply_pad(x[None, :]))
    assert tbase.apply_pad(x, 4_000).shape == (4_000,)
    _same(tbase.apply_pad(x, 4_000), jbase.apply_pad(x, 4_000))


def test_apply_pad_of_an_empty_wave_raises():
    with pytest.raises(ValueError, match="empty"):
        tbase.apply_pad(np.zeros(0, np.float32))


@pytest.mark.parametrize("sr", [22_050, 24_000, 44_100, 48_000])
def test_resample_wave_matches_jax(sr):
    x = _tone(np.random.default_rng(sr), sr, sr)[None, :]
    (got, got_sr), (want, want_sr) = tbase.resample_wave(x, sr, 16_000), jbase.resample_wave(x, sr, 16_000)
    assert got_sr == want_sr == 16_000 and got.shape == (1, 16_000)
    _same(want, got)
    assert tbase.resample_wave(x, sr, sr)[0] is x


@pytest.mark.parametrize("cutoff", [300.0, 4_000.0])
def test_lowpass_biquad_matches_jax(cutoff):
    x = np.random.default_rng(3).standard_normal((1, 8_000)).astype(np.float32)
    _same(jbase.lowpass_biquad(x, 16_000, cutoff), tbase.lowpass_biquad(x, 16_000, cutoff))


@pytest.mark.parametrize("delay_s", [0.05, 0.0])
def test_compand_matches_jax(delay_s):
    rng = np.random.default_rng(4)
    x = np.concatenate([_tone(rng, 4_000, 16_000), 0.001 * _tone(rng, 4_000, 16_000)])
    _same(jbase.compand(x, 16_000, delay_s=delay_s), tbase.compand(x, 16_000, delay_s=delay_s))


@pytest.mark.parametrize("n", [400, 8_000, 8_123])
def test_gsm_codec_roundtrip_matches_jax(n):
    x = _tone(np.random.default_rng(n), n, 8_000)
    got = tbase.gsm_codec_roundtrip(x, 8_000)
    assert got.shape == (-(-n // 160) * 160,)
    _same(jbase.gsm_codec_roundtrip(x, 8_000), got)


@pytest.mark.parametrize("codec", ["gsm", None])
def test_process_phone_call_matches_jax(codec):
    x = _tone(np.random.default_rng(5), 16_000, 16_000)[None, :]
    (got, got_sr), (want, want_sr) = (tbase.process_phone_call(x, 16_000, codec),
                                      jbase.process_phone_call(x, 16_000, codec))
    assert got_sr == want_sr == 8_000
    _same(want, got)


def test_normalize_i16(jnative):
    pcm = np.r_[np.array([-32768, -1, 0, 1, 32767], np.int16),
                np.random.default_rng(6).integers(-32768, 32768, 1000).astype(np.int16)]
    _same(pcm.astype(np.float32) / 32768.0, tnative.normalize_i16(pcm), jnative.normalize_i16(pcm))


# --------------------------------------------------------------------------
# The host library's build (ops/_build.py, host C++ branch)
# --------------------------------------------------------------------------

def test_dsp_library_is_the_ports_own():
    assert _build.source("dsp") == _build.SRC_DIR / "dsp.cpp"
    path = Path(tnative.library()._name)
    assert path == _build.BUILD_DIR / "libdsp.so"
    assert "native" not in path.parts


def test_host_build_uses_the_host_compiler(tmp_path, monkeypatch):
    """build() of a .cpp with a stand-in compiler: the Makefile's flags, a
    temporary file renamed into place, no rebuild when up to date, and a
    failed build raises."""
    src, out = tmp_path / "csrc", tmp_path / "build"
    src.mkdir()
    (src / "k.cpp").write_text("// host\n")
    calls = tmp_path / "calls"
    fake = tmp_path / "cxx"
    fake.write_text('#!/bin/sh\necho "$@" >> "%s"\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    ': > "$2"\n' % calls)
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "cxx_path", lambda: str(fake))
    lib = _build.build("k", src, out)
    args = calls.read_text().split()
    assert lib == out / "libk.so" and lib.exists()
    assert args[:len(_build.CXX_FLAGS)] == list(_build.CXX_FLAGS)
    assert args[-2] == str(out / f"libk.{os.getpid()}.so") and args[-1] == str(src / "k.cpp")
    os.utime(src / "k.cpp", (1000.0, 1000.0))
    _build.build("k", src, out)
    assert len(calls.read_text().splitlines()) == 1
    fake.write_text("#!/bin/sh\necho broken >&2\nexit 1\n")
    os.utime(src / "k.cpp", None)
    os.utime(lib, (1000.0, 1000.0))
    with pytest.raises(RuntimeError, match="broken"):
        _build.build("k", src, out)


def test_build_all_returns_each_builds_seconds():
    each_s = _build.build_all(("dsp",))
    assert list(each_s) == ["dsp"] and each_s["dsp"] >= 0.0
    assert not _build.stale(_build.BUILD_DIR / "libdsp.so", _build.source("dsp"))


# --------------------------------------------------------------------------
# Decode, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("dtype", ["int16", "int32", "uint8", "float32"])
def test_load_wav_matches_jax(tmp_path, dtype, channels):
    rng = np.random.default_rng(7)
    wave = rng.uniform(-0.9, 0.9, (3_000, channels)).squeeze()
    data = {"int16": (wave * 32767).astype(np.int16), "int32": (wave * 2**31).astype(np.int32),
            "uint8": (wave * 127 + 128).astype(np.uint8), "float32": wave.astype(np.float32)}[dtype]
    path = tmp_path / "x.wav"
    wavfile.write(path, 22_050, data)
    (got, sr), (want, want_sr) = tbase.load_audio(path), jbase.load_audio(path)
    assert sr == want_sr == 22_050 and got.shape == (channels, 3_000)
    _same(want, got)


def _pcm(rng, n=6_000, amp=3_000):
    x = np.cumsum(rng.standard_normal(n))
    return (x / np.abs(x).max() * amp).astype(np.int64)


@pytest.mark.parametrize("stream", ["fixed", "lpc", "verbatim_8bit", "independent", "left-side",
                                    "mid-side", "no_total"])
def test_load_flac_is_exact(tmp_path, stream):
    rng = np.random.default_rng(8)
    kw, pcm = {}, _pcm(rng)
    if stream == "lpc":
        kw = dict(kind="lpc", lpc_coefs=[60, -30, 2], lpc_shift=5)
    elif stream == "verbatim_8bit":
        pcm, kw = _pcm(rng, amp=100), dict(kind="verbatim", bps=8)
    elif stream in ("independent", "left-side", "mid-side"):
        right = (pcm * 0.7).astype(np.int64) + rng.integers(-50, 50, pcm.size)
        pcm, kw = np.stack([pcm, right], axis=1), dict(stereo_mode=stream)
    elif stream == "no_total":
        kw = dict(omit_total=True, blocksize=1_024)
    path = tmp_path / "x.flac"
    path.write_bytes(encode_flac(pcm, sample_rate=16_000, **{"kind": "fixed", "order": 2, **kw}))
    got, sr = tbase.load_audio(path)
    want = (np.asarray(pcm, np.float32) / np.float32(1 << (kw.get("bps", 16) - 1))).reshape(
        pcm.shape[0], -1).T
    assert sr == 16_000
    _same(want, got, jbase.load_audio(path)[0])


def test_unparseable_flac_raises(tmp_path):
    path = tmp_path / "x.flac"
    path.write_bytes(b"fLaC" + bytes(60))
    assert tnative.flac_decode(path) is None
    with pytest.raises(RuntimeError, match="soundfile"):
        tbase.load_audio(path)


@needs_mp3
@pytest.mark.parametrize("sr,channels", [(16_000, 1), (44_100, 1), (44_100, 2)])
def test_load_mp3_matches_jax(tmp_path, sr, channels):
    rng = np.random.default_rng(9)
    wave = np.stack([corpus.utterance(rng, sr, (1.0, 1.5))[: sr] for _ in range(channels)])
    path = tmp_path / "x.mp3"
    path.write_bytes(tmp3.mp3_encode(wave, sr))
    (got, got_sr), (want, want_sr) = tbase.load_audio(path), jbase.load_audio(path)
    assert got_sr == want_sr == sr and got.shape[0] == channels
    assert abs(got.shape[1] - sr) < 4 * 1152  # the codec's delay and frame padding
    _same(want, got)


def test_mp3_without_libmpg123_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tmp3, "available", lambda: False)
    path = tmp_path / "x.mp3"
    path.write_bytes(b"\xff\xfb" + bytes(100))
    with pytest.raises(RuntimeError, match="libmpg123"):
        tbase.load_audio(path)


def test_video2audio_names_its_dependency():
    with pytest.raises(RuntimeError, match="moviepy"):
        tmisc.fakeavceleb_video2audio("videos", "audio")


# --------------------------------------------------------------------------
# Preprocessing, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("sr", [16_000, 22_050, 48_000])
def test_wavefake_preprocessing_matches_jax(sr, raw):
    """Defaults (resample, trim, pad) and ``return_raw``'s arguments (no
    trim, no phone call; pad and cut still apply)."""
    wave = corpus.utterance(np.random.default_rng(sr), sr, (1.0, 5.0))[None, :]
    kw = dict(wave_fake_trim=False, wave_fake_cell_phone=False) if raw else {}
    (got, got_sr), (want, want_sr) = (tbase.wavefake_preprocessing(wave, sr, **kw),
                                      jbase.wavefake_preprocessing(wave, sr, **kw))
    assert got_sr == want_sr == 16_000 and got.shape == (tbase.WAVE_FAKE_CUT,)
    _same(want, got)


def test_wavefake_preprocessing_on_batch_matches_jax():
    rng = np.random.default_rng(10)
    batch = np.stack([tbase.apply_pad(corpus.utterance(rng, 16_000, (2.0, 4.5)))
                      for _ in range(4)])
    srs = np.full(4, 16_000, np.int32)
    (got, got_srs), (want, want_srs) = (tbase.wavefake_preprocessing_on_batch(batch, srs),
                                        jbase.wavefake_preprocessing_on_batch(batch, srs))
    assert got.shape == (4, tbase.WAVE_FAKE_CUT)
    _same(want, got)
    _same(want_srs, got_srs)
    assert not np.array_equal(got, batch)  # the trim cut a silence


# --------------------------------------------------------------------------
# Manifests and DetectionDataset, row for row
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    rng = np.random.default_rng(11)
    written = []
    roots = {
        "wavefake": corpus.wavefake(root / "WaveFake", 24, 8, rng, written, (0.8, 1.6)),
        "asvspoof2021": corpus.asvspoof2021_df(root / "DF", 14, 6, rng, written, (0.8, 1.6)),
        "asvspoof2019": corpus.asvspoof2019_la(root / "LA", 6, rng, written),
    }
    if HAVE_MP3:
        roots["fakeavceleb"] = corpus.fakeavceleb(root / "FakeAVCeleb_v1.2", 5, 6, rng, written,
                                                  (0.8, 1.6), sr=16_000)
    return roots


MANIFESTS = {"wavefake": (tds.WaveFakeDataset, jds.WaveFakeDataset),
             "asvspoof2021": (tds.DeepFakeASVSpoofDataset, jds.DeepFakeASVSpoofDataset),
             "asvspoof2019": (tds.ASVSpoofDataset, jds.ASVSpoofDataset),
             "fakeavceleb": (tds.FakeAVCelebDataset, jds.FakeAVCelebDataset)}


@pytest.mark.parametrize("subset", ["train", "test", "val"])
@pytest.mark.parametrize("name", list(MANIFESTS))
def test_manifest_matches_jax(corpora, name, subset):
    if name not in corpora:
        pytest.skip("system libmp3lame absent: no FakeAVCeleb corpus")
    tcls, jcls = MANIFESTS[name]
    got, want = tcls(corpora[name], subset=subset), jcls(corpora[name], subset=subset)
    assert len(got) > 0
    pd.testing.assert_frame_equal(got.samples, want.samples)


def _detection(module, corpora, **kw):
    return module.DetectionDataset(asvspoof_path=corpora["asvspoof2021"],
                                   wavefake_path=corpora["wavefake"],
                                   fakeavceleb_path=corpora.get("fakeavceleb"), **kw)


@pytest.mark.parametrize("subset", ["train", "val"])
@pytest.mark.parametrize("mode", [dict(), dict(oversample=False, undersample=True),
                                  dict(oversample=False), dict(reduced_number=9)],
                         ids=["oversample", "undersample", "neither", "reduced_number"])
def test_detection_dataset_matches_jax(corpora, mode, subset):
    np.random.seed(12)
    want = _detection(jdet, corpora, subset=subset, **mode)
    np.random.seed(12)
    got = _detection(tdet, corpora, subset=subset, **mode)
    pd.testing.assert_frame_equal(got.samples, want.samples)
    if mode.get("undersample") or mode == {}:
        assert (got.samples["label"] == "bonafide").sum() == (got.samples["label"] == "spoof").sum()


@pytest.mark.parametrize("raw", [False, True])
def test_loader_over_detection_dataset_matches_jax(corpora, raw):
    """Decode (wav, flac, mp3) + preprocessing through the manifests, batched
    by each package's loader under one ``np.random.seed``."""
    kw = dict(subset="train", return_meta=True, return_raw=raw)
    np.random.seed(13)
    jds_, jloader = _detection(jdet, corpora, **kw), None
    jloader = JDataLoader(jds_, batch_size=4, num_workers=2)
    want = list(jloader)
    np.random.seed(13)
    tds_ = _detection(tdet, corpora, **kw)
    got = list(TDataLoader(tds_, batch_size=4, num_workers=2))
    assert len(got) == len(want) == len(tds_) // 4
    for bt, bj in zip(got, want):
        for a, b in zip(bt[:3], bj[:3]):
            _same(b, a)
        assert bt[3] == bj[3]
    formats = {Path(p).suffix for b in got for p in b[3][1]}
    assert {".wav", ".flac"} <= formats and (".mp3" in formats) == HAVE_MP3
