"""Synthetic in-memory dataset for tests, CI, and benchmarks (a copy of
``adaa_tpu/data/synthetic.py``: the same waves for the same index).

The reference has no dataset fixtures (its only checks assume the real
ASVspoof/WaveFake/FakeAVCeleb trees, SURVEY §4); this provides a
drop-in ``DetectionDataset``-shaped source: bonafide = harmonic tones,
spoof = tones with phase/noise artifacts, deterministic per index.
A linear-probe-separable construction so smoke trainings actually
learn.
"""
from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

from adaa_tpu_torch.data.base import WAVE_FAKE_CUT, WAVE_FAKE_SR


class SyntheticDataset:
    def __init__(
        self,
        n: int = 256,
        subset: str = "train",
        wave_length: int = WAVE_FAKE_CUT,
        seed: int = 45,
        return_label: bool = True,
        return_meta: bool = False,
        return_raw: bool = False,
        class_sep: float = 1.0,
    ):
        self.n = n
        self.subset = subset
        self.wave_length = wave_length
        self.seed = seed
        self.return_label = return_label
        self.return_meta = return_meta
        self.return_raw = return_raw
        # class_sep < 1 shrinks the spoof artifact amplitude and
        # equalizes the class noise floors, so trained models keep small
        # decision margins — used by the behavioral acceptance tests,
        # where registry-eps attacks must actually flip predictions.
        # The default (1.0) reproduces the original waveforms exactly.
        self.class_sep = class_sep

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        # process-stable seed: built-in hash() of a str is salted per
        # process (PYTHONHASHSEED), which silently made every subprocess
        # generate different "identical" corpora
        base = zlib.crc32(f"{self.subset}:{self.seed}".encode())
        rng = np.random.default_rng((base % (2**31)) + index)
        label = index % 2  # 1 bonafide, 0 spoof
        t = np.arange(self.wave_length, dtype=np.float32) / WAVE_FAKE_SR
        f0 = rng.uniform(80.0, 300.0)
        wave = 0.3 * np.sin(2 * np.pi * f0 * t)
        wave += 0.15 * np.sin(2 * np.pi * 2 * f0 * t + rng.uniform(0, np.pi))
        sep = self.class_sep
        if label == 0:  # spoof: vocoder-ish buzz + band noise
            wave += 0.2 * sep * np.sign(np.sin(2 * np.pi * 4 * f0 * t))
            wave += 0.05 * rng.standard_normal(self.wave_length)
        else:
            # noise floors converge as class_sep -> 0 (noise-amplitude
            # difference is itself a separating feature otherwise)
            bona_noise = 0.01 * sep + 0.05 * (1.0 - sep)
            wave += bona_noise * rng.standard_normal(self.wave_length)
        wave = wave.astype(np.float32)

        out = [wave, WAVE_FAKE_SR]
        if self.return_label:
            out.append(label)
        if self.return_meta:
            out.append(("synthetic" if label == 0 else "-",
                        f"synthetic://{self.subset}/{index}",
                        self.subset,
                        self.wave_length / WAVE_FAKE_SR))
        return out
