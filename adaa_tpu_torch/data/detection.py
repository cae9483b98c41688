"""DetectionDataset — union of ASVspoof2021-DF + WaveFake + FakeAVCeleb
(port of ``adaa_tpu/data/detection.py``).

Semantics follow the reference's union dataset (reference:
src/datasets/detection_dataset.py:15-119): concatenate the per-source
manifests, rebalance classes (bonafide oversampled with replacement up
to the spoof count, or spoof undersampled down to bonafide), and
optionally subsample to ``reduced_number`` rows with the fixed seed 42.
"""
from __future__ import annotations

import logging
from typing import Optional

from adaa_tpu_torch.data.datasets import (
    DeepFakeASVSpoofDataset,
    FakeAVCelebDataset,
    SimpleAudioFakeDataset,
    WaveFakeDataset,
    pd,
)

LOGGER = logging.getLogger(__name__)

# source name -> manifest class; order matters (concat order matches the
# reference's asvspoof, wavefake, fakeavceleb sequence)
_SOURCES = (
    ("asvspoof", DeepFakeASVSpoofDataset),
    ("wavefake", WaveFakeDataset),
    ("fakeavceleb", FakeAVCelebDataset),
)


def _label_counts(samples):
    grouped = samples.groupby(by="label")
    return grouped, len(grouped.groups["bonafide"]), len(grouped.groups["spoof"])


def balance_by_oversampling(samples):
    """Draw bonafide rows with replacement until classes match
    (detection_dataset.py:85-97). Raises when bonafide already dominates
    — the real corpora are spoof-heavy and the reference assumes it."""
    grouped, n_bona, n_spoof = _label_counts(samples)
    extra = n_spoof - n_bona
    if extra < 0:
        raise NotImplementedError
    if extra == 0:
        return samples
    resampled = grouped.get_group("bonafide").sample(extra, replace=True)
    return pd.concat([samples, resampled], ignore_index=True)


def balance_by_undersampling(samples):
    """Shrink the spoof side to the bonafide count
    (detection_dataset.py:99-109)."""
    grouped, n_bona, n_spoof = _label_counts(samples)
    if n_spoof < n_bona:
        raise NotImplementedError
    if n_spoof == n_bona:
        return samples
    spoofs = grouped.get_group("spoof").sample(n_bona, replace=True)
    return pd.concat([grouped.get_group("bonafide"), spoofs],
                     ignore_index=True)


class DetectionDataset(SimpleAudioFakeDataset):
    def __init__(
        self,
        asvspoof_path=None,
        wavefake_path=None,
        fakeavceleb_path=None,
        subset: str = "val",
        transform=None,
        oversample: bool = True,
        undersample: bool = False,
        return_label: bool = True,
        reduced_number: Optional[int] = None,
        return_meta: bool = False,
        return_raw: bool = False,
    ):
        super().__init__(
            subset=subset,
            transform=transform,
            return_label=return_label,
            return_meta=return_meta,
            return_raw=return_raw,
        )
        roots = {
            "asvspoof": asvspoof_path,
            "wavefake": wavefake_path,
            "fakeavceleb": fakeavceleb_path,
        }
        manifests = [
            cls(roots[name], subset=subset).samples
            for name, cls in _SOURCES
            if roots[name] is not None
        ]
        self.samples = pd.concat(manifests, ignore_index=True)

        if oversample:
            self.samples = balance_by_oversampling(self.samples)
        elif undersample:
            self.samples = balance_by_undersampling(self.samples)

        if reduced_number:
            LOGGER.info("Using reduced number of samples - %s!", reduced_number)
            self.samples = self.samples.sample(
                min(len(self.samples), reduced_number), random_state=42
            )

    # instance-method aliases kept for reference-API compatibility
    def oversample_dataset(self):
        self.samples = balance_by_oversampling(self.samples)

    def undersample_dataset(self):
        self.samples = balance_by_undersampling(self.samples)

    def get_bonafide_only(self):
        self.samples = self.samples.groupby(by="label").get_group("bonafide")
        return self.samples

    def get_spoof_only(self):
        self.samples = self.samples.groupby(by="label").get_group("spoof")
        return self.samples
