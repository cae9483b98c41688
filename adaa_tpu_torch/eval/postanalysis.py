"""Offline post-analysis of saved attack wav pairs: plots and MCD (port of
``adaa_tpu/eval/postanalysis.py``, host numpy, scipy and pandas).

The reference's AttackPostAnalyser (src/aa/qualitative/
attacks_postanalysis.py:15-128): waveform overlays of original against
attacked segments, and mel-cepstral distance statistics (mean / std /
min / max) written to csv, over the ``*__orig.wav`` / ``*__attacked.wav``
pairs that ``eval/qualitative.py:AttackAnalyser`` writes.

The MCD follows the ``mel_cepstral_distance`` package's pipeline with its
defaults, as the JAX package does:

* audio mono, resampled to 22,050 Hz (librosa.load's default);
* STFT n_fft 1024, hop 256, periodic Hamming window, center=False;
* power mel spectrogram, 20 HTK mels, no filter normalisation;
* log10(mel + float64 eps), then the plain cosine transform
  c_i(m) = sum_k logmel_k(m) cos(pi i / K (k + 0.5)), keeping i = 1..16;
* DTW alignment (Euclidean frame distance, steps (1,1) / (1,0) / (0,1) of
  weight 1); MCD = the mean frame distance along the optimal path,
  penalty = 2 - (frames_1 + frames_2) / aligned_frames.

The DTW table is filled one anti-diagonal at a time, with each cell's
sum as the JAX package's row-by-row loop forms it, so the costs are equal.
pandas and matplotlib are imported when first needed.
"""
from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from adaa_tpu_torch.data.base import resample_wave
from adaa_tpu_torch.ops.filterbanks import melscale_fbanks

LOGGER = logging.getLogger(__name__)

_PKG_SR = 22_050  # librosa.load's default resample rate


def mel_cepstra(
    wave: np.ndarray,
    sr: int = 16_000,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 20,
    n_mfcc: int = 16,
) -> np.ndarray:
    """Mel cepstra c_1..c_{n_mfcc} per frame, (frames, n_mfcc): the
    package's features (c0 left out, as ``get_mfccs_of_mel_spectogram``)."""
    wave = np.asarray(wave)
    if wave.dtype.kind == "i":
        wave = wave.astype(np.float64) / np.iinfo(wave.dtype).max
    wave = np.asarray(wave, np.float64)
    if wave.ndim > 1:
        wave = wave.mean(axis=0)
    if sr != _PKG_SR:
        resampled, _ = resample_wave(wave[None].astype(np.float32), sr, _PKG_SR)
        wave = np.asarray(resampled[0], np.float64)
        sr = _PKG_SR

    n_frames = max(1 + (len(wave) - n_fft) // hop, 0)  # center=False framing
    if n_frames == 0:
        return np.zeros((0, n_mfcc))
    n = np.arange(n_fft)
    window = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / n_fft)  # periodic Hamming
    frames = wave[np.arange(n_frames)[:, None] * hop + n[None, :]] * window
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2  # power, (T, F)
    fb = melscale_fbanks(n_fft // 2 + 1, 0.0, sr / 2, n_mels, sr, mel_scale="htk",
                         norm=None).astype(np.float64)
    logmel = np.log10(spec @ fb + sys.float_info.epsilon)  # (T, n_mels)
    i = np.arange(1, n_mfcc + 1)[None, :]
    k = np.arange(n_mels)[:, None]
    return logmel @ np.cos(np.pi * i / n_mels * (k + 0.5))  # (T, n_mfcc)


def _dtw_path_cost(d: np.ndarray) -> Tuple[float, int]:
    """DTW over a frame-distance matrix: (total cost, path length)."""
    t1, t2 = d.shape
    acc = np.full((t1 + 1, t2 + 1), np.inf)
    acc[0, 0] = 0.0
    # cell (i, j) needs (i-1, j-1), (i-1, j) and (i, j-1): all on earlier
    # anti-diagonals i + j, so each anti-diagonal is one vector step
    for s in range(2, t1 + t2 + 1):
        i = np.arange(max(1, s - t2), min(t1, s - 1) + 1)
        j = s - i
        prev = np.minimum(np.minimum(acc[i - 1, j - 1], acc[i - 1, j]), acc[i, j - 1])
        acc[i, j] = d[i - 1, j - 1] + prev
    # the path's length by backtracking; ties go to the smallest (cost, i, j)
    i, j, steps = t1, t2, 0
    while i > 1 or j > 1:
        _, i, j = min((acc[i - 1, j - 1], i - 1, j - 1), (acc[i - 1, j], i - 1, j),
                      (acc[i, j - 1], i, j - 1))
        steps += 1
    return float(acc[t1, t2]), steps + 1


def mel_cepstral_distance(wave1: np.ndarray, wave2: np.ndarray,
                          sr: int = 16_000) -> Tuple[float, float, int]:
    """(mcd, penalty, frames) between two waves: the mean Euclidean
    distance of their c_1..c_16 log10 mel cepstra along the DTW path, and
    ``penalty = 2 - (n1 + n2) / aligned_frames``."""
    c1 = mel_cepstra(wave1, sr)
    c2 = mel_cepstra(wave2, sr)
    if len(c1) == 0 or len(c2) == 0:
        return float("nan"), float("nan"), 0
    diff = c1[:, None, :] - c2[None, :, :]
    cost, frames = _dtw_path_cost(np.sqrt((diff * diff).sum(-1)))
    return cost / frames, 2.0 - (len(c1) + len(c2)) / frames, frames


class AttackPostAnalyser:
    """Mirror of the reference class (attacks_postanalysis.py:15-128)."""

    def __init__(self, result_dst):
        self.result_dst = Path(result_dst)
        self.result_dst.mkdir(parents=True, exist_ok=True)

    def save_plot(self, file_name, xo, xa, rang=(1100, 1200)):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.rcParams["figure.figsize"] = [12.0, 4.0]
        s, e = rang
        xo = np.asarray(xo, np.float64)
        xa = np.asarray(xa, np.float64)
        plt.plot(xo[s:e], "--", color="steelblue")
        plt.plot(xa[s:e], "-", color="yellow")
        plt.plot(xo[s:e] - xa[s:e], color="lightcoral")
        plt.savefig(self.result_dst / f"{file_name}_plot.png")
        plt.clf()

    def _wav_pairs(self, path: Optional[Path] = None):
        from scipy.io import wavfile

        path = Path(path) if path else self.result_dst
        for orig in sorted(path.glob("**/*__orig.wav")):
            att = orig.parent / orig.name.replace("__orig.wav", "__attacked.wav")
            if not att.exists():
                continue
            _, org_wav = wavfile.read(orig)
            _, att_wav = wavfile.read(att)
            yield orig.stem.replace("__orig", ""), org_wav, att_wav

    def read_waves_and_plot(self, path=None):
        for stem, org, att in self._wav_pairs(path):
            self.save_plot(stem, org, att, (1100, 1300))

    def read_waves_and_calc_metrics(self, path=None):
        """One row per pair in ``metrics.csv`` (a pandas DataFrame, returned)
        and the MCD's mean / std / min / max in ``mcd_metrics.csv``."""
        import pandas as pd

        rows, mcds = [], []
        for stem, org, att in self._wav_pairs(path):
            try:
                distance, penalty, frames = mel_cepstral_distance(org, att)
            except Exception:  # noqa: BLE001 -- the reference's blanket skip of a bad pair
                LOGGER.info("ERROR")
                continue
            mcds.append(distance)
            rows.append({"name": stem, "mcd": distance, "penalty": penalty, "frames": frames})

        results = pd.DataFrame(rows).reset_index(drop=True)
        results.to_csv(self.result_dst / "metrics.csv")
        if mcds:
            arr = np.asarray(mcds)
            stats = pd.DataFrame([[arr.mean(), arr.std(), arr.min(), arr.max()]],
                                 columns=["mean", "std", "min", "max"])
            stats.to_csv(self.result_dst / "mcd_metrics.csv")
            LOGGER.info("MCD: %s, %s, %s, %s", arr.mean(), arr.std(), arr.min(), arr.max())
        return results
