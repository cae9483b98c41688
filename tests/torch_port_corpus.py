"""Mini-corpora in the published layouts of ASVspoof2021-DF, WaveFake,
FakeAVCeleb and ASVspoof2019-LA, written from a numpy seed.

Each utterance is a speech-like signal (harmonic tones with noise in
voiced segments of 0.3 s or more) with a leading, one or two interior and
a trailing silence of 0.1-0.6 s. The silences are noise at ~1e-4 of full
scale, as recorded silence is: far below the sox trim's 1% RMS gate, so
the trim keeps the pauses shorter than 0.2 s and cuts the longer ones, and
a last-ulp change of the audio cannot move a trim boundary. Spoofed
utterances carry a vocoder-like buzz.

Formats: ASVspoof 16 kHz FLAC (``tests/oracles/flac_writer.py``), WaveFake
WAV at LJSpeech's 22,050 Hz and JSUT's 48 kHz (24 kHz for its vocoder),
FakeAVCeleb MP3 at 44.1 kHz through the system ``libmp3lame``. Every writer
appends ``Written(path, fmt, sample_rate, pcm)`` records to a list, so a
caller can check that each file decodes to what was written (int16 PCM;
for an MP3, the float wave that was encoded).

Used by tests/test_torch_port_data.py, tests/test_torch_port_raw.py and
``chip_smoke.py`` phase 20, which loads it by its path (``tests/`` is not a
package, and an installed package named ``tests`` would shadow it).
Imports numpy, scipy, the FLAC test encoder (by its path, likewise) and
the port's mp3 encoder only.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import List, NamedTuple, Tuple

import numpy as np
from scipy.io import wavfile

_spec = importlib.util.spec_from_file_location(
    "flac_writer", Path(__file__).resolve().parent / "oracles" / "flac_writer.py")
_flac_writer = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_flac_writer)
encode_flac = _flac_writer.encode_flac

SILENCE_S = (0.1, 0.6)
VOICED_MIN_S = 0.3
FAKEAVCELEB_ATTACKS = ("faceswap-wav2lip", "fsgan-wav2lip", "wav2lip", "rtvc")


class Written(NamedTuple):
    path: Path
    fmt: str  # "wav", "flac" or "mp3"
    sample_rate: int
    pcm: np.ndarray  # int16 (T,) for wav and flac; the encoded float32 wave for mp3


def utterance(rng: np.random.Generator, sr: int, seconds: Tuple[float, float] = (1.0, 6.0),
              spoof: bool = False) -> np.ndarray:
    """One float32 utterance in [-1, 1] of ``seconds`` (a range) length."""
    silences = [rng.uniform(*SILENCE_S) for _ in range(2 + int(rng.integers(1, 3)))]
    n_voiced = len(silences) - 1
    total = max(rng.uniform(*seconds), sum(silences) + n_voiced * VOICED_MIN_S)
    cuts = np.sort(rng.uniform(0.0, 1.0, n_voiced - 1))
    spare = total - sum(silences) - n_voiced * VOICED_MIN_S
    voiced = VOICED_MIN_S + spare * np.diff(np.r_[0.0, cuts, 1.0])
    f0 = rng.uniform(80.0, 300.0)
    parts = []
    for i, sil in enumerate(silences):
        parts.append(1e-4 * rng.standard_normal(int(sil * sr)))
        if i == n_voiced:
            break
        n = int(voiced[i] * sr)
        t = np.arange(n) / sr
        phase = 2 * np.pi * f0 * (t + 0.002 * np.sin(2 * np.pi * 5.0 * t))
        seg = sum(0.25 / k * np.sin(k * phase + rng.uniform(0, 2 * np.pi)) for k in range(1, 5))
        if spoof:
            seg += 0.05 * np.sign(np.sin(4 * phase)) + 0.02 * rng.standard_normal(n)
        else:
            seg += 0.005 * rng.standard_normal(n)
        fade = min(n // 2, int(0.015 * sr))
        ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(fade) / fade)
        seg[:fade] *= ramp
        seg[n - fade:] *= ramp[::-1]
        parts.append(seg)
    return np.clip(np.concatenate(parts), -1.0, 1.0).astype(np.float32)


def int16(wave: np.ndarray) -> np.ndarray:
    return np.round(wave * 32767.0).astype(np.int16)


def write_wav(path: Path, wave: np.ndarray, sr: int, written: List[Written]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    pcm = int16(wave)
    wavfile.write(path, sr, pcm)
    written.append(Written(path, "wav", sr, pcm))


def write_flac(path: Path, wave: np.ndarray, sr: int, written: List[Written]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    pcm = int16(wave)
    path.write_bytes(encode_flac(pcm.astype(np.int64), sample_rate=sr, kind="fixed", order=2))
    written.append(Written(path, "flac", sr, pcm))


def write_mp3(path: Path, wave: np.ndarray, sr: int, written: List[Written]) -> None:
    from adaa_tpu_torch.data import mp3

    stream = mp3.mp3_encode(wave, sr)
    if stream is None:
        raise RuntimeError("mp3 encode needs the system libmp3lame")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(stream)
    written.append(Written(path, "mp3", sr, wave))


def asvspoof2021_df(root: Path, n_spoof: int, n_bonafide: int, rng: np.random.Generator,
                    written: List[Written], seconds=(1.0, 6.0)) -> Path:
    """``ASVspoof2021_DF_eval_part0{0..3}/ASVspoof2021_DF_eval/flac/*.flac`` and
    ``keys/CM/trial_metadata.txt`` (adaa_tpu/data/datasets.py:127-183)."""
    lines = []
    for i in range(n_spoof + n_bonafide):
        spoof = i < n_spoof
        name = f"DF_E_{i:07d}"
        part = root / f"ASVspoof2021_DF_eval_part{i % 4:02d}" / "ASVspoof2021_DF_eval" / "flac"
        write_flac(part / f"{name}.flac", utterance(rng, 16_000, seconds, spoof), 16_000, written)
        label = "spoof" if spoof else "bonafide"
        lines.append(f"LA_{i % 7:04d} {name} nocodec asvspoof A{i % 19:02d} {label} notrim eval")
    order = rng.permutation(len(lines))
    keys = root / "keys" / "CM"
    keys.mkdir(parents=True, exist_ok=True)
    (keys / "trial_metadata.txt").write_text("".join(lines[k] + "\n" for k in order))
    return root


def wavefake(root: Path, n_spoof: int, n_real: int, rng: np.random.Generator,
             written: List[Written], seconds=(1.0, 6.0)) -> Path:
    """``generated_audio/<corpus>_<vocoder>/*.wav`` and the LJSpeech and JSUT
    real trees (adaa_tpu/data/datasets.py:185-234)."""
    vocoders = (("ljspeech_melgan", 22_050), ("ljspeech_hifiGAN", 22_050),
                ("ljspeech_full_band_melgan", 22_050), ("jsut_parallel_wavegan", 24_000))
    for i in range(n_spoof):
        folder, sr = vocoders[i % len(vocoders)]
        stem = f"LJ{i:03d}-{i % 13:04d}" if folder.startswith("lj") else f"BASIC5000_{i:04d}"
        write_wav(root / "generated_audio" / folder / f"{stem}_gen.wav",
                  utterance(rng, sr, seconds, spoof=True), sr, written)
    for i in range(n_real):
        if i % 2:
            path, sr = root / "real_audio/jsut_ver1.1/basic5000/wav" / f"BASIC5000_{i:04d}.wav", 48_000
        else:
            path, sr = root / "real_audio/LJSpeech-1.1/wavs" / f"LJ{i:03d}-{i % 17:04d}.wav", 22_050
        write_wav(path, utterance(rng, sr, seconds), sr, written)
    return root


def fakeavceleb(root: Path, n_per_attack: int, n_real: int, rng: np.random.Generator,
                written: List[Written], seconds=(1.0, 6.0), sr: int = 44_100) -> Path:
    """``FakeAVCeleb-audio/meta_data.csv`` and the ``.mp3`` files it names
    (adaa_tpu/data/datasets.py:237-326)."""
    audio = root / "FakeAVCeleb-audio"
    rows = ["source,target1,method,category,type,race,gender,filename,path"]
    races = ("African", "Asian (East)", "Caucasian (European)")
    k = 0
    for method in (*FAKEAVCELEB_ATTACKS, "real"):
        for j in range(n_real if method == "real" else n_per_attack):
            kind = {"real": "RealVideo-RealAudio", "rtvc": "RealVideo-FakeAudio"}.get(
                method, "FakeVideo-FakeAudio")
            category = {"real": "A", "rtvc": "B"}.get(method, "D")
            race, gender = races[k % 3], ("men", "women")[k % 2]
            sub = f"{kind}/{race}/{gender}/id{k:05d}"
            name = f"{k:05d}_{j}"
            write_mp3(audio / sub / f"{name}.mp3",
                      utterance(rng, sr, seconds, spoof=method != "real"), sr, written)
            target = "-" if method == "real" else f"id{(k + 1):05d}"
            rows.append(f"id{k:05d},{target},{method},{category},{kind},{race},{gender},"
                        f"{name}.mp4,FakeAVCeleb/{sub}")
            k += 1
    audio.mkdir(parents=True, exist_ok=True)
    (audio / "meta_data.csv").write_text("\n".join(rows) + "\n")
    return root


def asvspoof2019_la(root: Path, n_per_part: int, rng: np.random.Generator,
                    written: List[Written]) -> Path:
    """``ASVspoof2019_LA_{train,dev,eval}/flac/*.flac`` and the CM protocols
    (adaa_tpu/data/datasets.py:342-387), with short utterances."""
    protocols = root / "ASVspoof2019_LA_cm_protocols"
    protocols.mkdir(parents=True, exist_ok=True)
    for part, suffix in (("train", "trn"), ("dev", "trl"), ("eval", "trl")):
        lines = []
        for i in range(n_per_part):
            name = f"LA_{part[0].upper()}_{i:07d}"
            attack = "-" if i % 3 == 0 else f"A{1 + i % 19:02d}"
            write_flac(root / f"ASVspoof2019_LA_{part}" / "flac" / f"{name}.flac",
                       utterance(rng, 16_000, (0.2, 0.4), attack != "-"), 16_000, written)
            label = "bonafide" if attack == "-" else "spoof"
            lines.append(f"LA_{i % 5:04d} {name} - {attack} {label}")
        (protocols / f"ASVspoof2019.LA.cm.{part}.{suffix}.txt").write_text("\n".join(lines) + "\n")
    return root
