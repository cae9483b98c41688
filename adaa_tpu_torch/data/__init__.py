"""Audio data layer (port of ``adaa_tpu.data``): decode, the host DSP
(resample, the sox silence trim, repeat-pad) in ``base`` and the host
library ``native``, the ASVspoof2021-DF / WaveFake / FakeAVCeleb
manifests, ``DetectionDataset``, the prefetching loader and the synthetic
set. Items and batches are numpy; callers move them to their device."""
from adaa_tpu_torch.data.base import (  # noqa: F401
    SOX_SILENCE,
    WAVE_FAKE_CUT,
    WAVE_FAKE_SR,
    apply_pad,
    wavefake_preprocessing,
    wavefake_preprocessing_on_batch,
)
from adaa_tpu_torch.data.detection import DetectionDataset  # noqa: F401
from adaa_tpu_torch.data.loader import DataLoader  # noqa: F401
from adaa_tpu_torch.data.synthetic import SyntheticDataset  # noqa: F401
