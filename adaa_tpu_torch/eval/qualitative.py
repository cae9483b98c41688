"""Qualitative attack analysis: FP/FN wav dumps + console diffs (a copy
of ``adaa_tpu/eval/qualitative.py``, writing the same files).

Behavioral equivalent of the reference's AttackAnalyser (reference:
src/aa/qualitative/attacks_analysis.py:10-140): for each batch it
selects samples where the attack flipped a previously-correct
prediction (false positives: bonafide->spoof impossible here — in the
reference FP = spoof classified bonafide after attack, FN = bonafide
classified spoof), logs the prediction diffs, and writes the
original/attacked wav pairs at 16 kHz.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np

from adaa_tpu_torch.data.base import WAVE_FAKE_SR

LOGGER = logging.getLogger(__name__)


class AttackAnalyser:
    def __init__(self, output_dir: Path, sample_rate: int = WAVE_FAKE_SR):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.sample_rate = sample_rate
        self.batch_no = 0

    def analyse(
        self,
        batch_x: np.ndarray,
        batch_x_attacked: np.ndarray,
        batch_y: np.ndarray,
        batch_preds_label: np.ndarray,
        batch_preds: np.ndarray,
        batch_preds_noattack_label: np.ndarray,
        batch_preds_noattack: np.ndarray,
        batch_metadata=None,
    ) -> None:
        batch_x = np.asarray(batch_x)
        batch_x_attacked = np.asarray(batch_x_attacked)
        batch_y = np.asarray(batch_y)

        self._log_diffs(batch_y, batch_preds, batch_preds_noattack)

        # previously-correct predictions flipped by the attack
        was_correct = batch_preds_noattack_label == batch_y
        flipped = was_correct & (batch_preds_label != batch_y)

        # FN: bonafide (1) now predicted spoof; FP: spoof (0) now bonafide
        fn_idx = np.flatnonzero(flipped & (batch_y == 1))
        fp_idx = np.flatnonzero(flipped & (batch_y == 0))

        for kind, idx in (("fn", fn_idx), ("fp", fp_idx)):
            for i in idx:
                meta_tag = ""
                if batch_metadata is not None:
                    attack_type = batch_metadata[0][i]
                    meta_tag = f"__{attack_type}"
                stem = f"batch{self.batch_no:04d}_{kind}_{i}{meta_tag}"
                self._save_wav(f"{stem}__orig.wav", batch_x[i])
                self._save_wav(f"{stem}__attacked.wav", batch_x_attacked[i])
        self.batch_no += 1

    def _log_diffs(self, y, preds, preds_noattack):
        preds = np.asarray(preds)
        preds_noattack = np.asarray(preds_noattack)
        for i in range(len(y)):
            LOGGER.info(
                "[qual] y=%d no-attack=%.4f attacked=%.4f delta=%+.4f",
                int(y[i]),
                float(preds_noattack[i]),
                float(preds[i]),
                float(preds[i] - preds_noattack[i]),
            )

    def _save_wav(self, name: str, wave: np.ndarray) -> None:
        from scipy.io import wavfile

        path = self.output_dir / name
        data = np.clip(np.asarray(wave, np.float32), -1.0, 1.0)
        wavfile.write(path, self.sample_rate, (data * 32767).astype(np.int16))
        LOGGER.info("[qual] saved %s", path)
