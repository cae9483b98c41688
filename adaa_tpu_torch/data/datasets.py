"""Dataset manifests with the reference's exact seeded splits (port of
``adaa_tpu/data/datasets.py``: the same rows, in the same order).

Reimplements the manifest builders (reference: src/datasets/
{base,deepfake_asvspoof,wavefake,fakeavceleb}_dataset.py) with
identical split semantics — ``sort -> seeded shuffle -> ratio split``
(base_dataset.py:56-69) using the same primitives (python
``random.shuffle`` for path lists, pandas ``sample(frac=1,
random_state=seed)`` for DataFrames) so subset membership matches the
torch pipeline file-for-file (split seed 45, ratio [0.7, 0.15]).
"""
from __future__ import annotations

import logging
import math
import random
from pathlib import Path

from adaa_tpu_torch.data import base as dsp

LOGGER = logging.getLogger(__name__)


class _Pandas:
    """``pandas``, imported at its first use: importing the package loads
    no pandas until a manifest is built."""

    def __getattr__(self, name):
        import pandas

        return getattr(pandas, name)


pd = _Pandas()

DF_ASVSPOOF_SPLIT = {"partition_ratio": [0.7, 0.15], "seed": 45}

WAVEFAKE_ATTACKS = [
    "multi_band_melgan", "melgan_large", "parallel_wavegan", "waveglow",
    "full_band_melgan", "melgan", "hifiGAN",
]
WAVEFAKE_SPLIT = {
    "train": WAVEFAKE_ATTACKS,
    "test": WAVEFAKE_ATTACKS,
    "val": WAVEFAKE_ATTACKS,
    "partition_ratio": [0.7, 0.15],
    "seed": 45,
}

FAKEAVCELEB_ATTACKS = ["faceswap-wav2lip", "fsgan-wav2lip", "wav2lip", "rtvc"]
FAKEAVCELEB_SPLIT = {
    "train": FAKEAVCELEB_ATTACKS,
    "test": FAKEAVCELEB_ATTACKS,
    "val": FAKEAVCELEB_ATTACKS,
    "partition_ratio": [0.7, 0.15],
    "seed": 45,
}


class SimpleAudioFakeDataset:
    """Manifest-backed dataset: item = [wave, sr(, label)(, meta)].

    Semantics mirror the reference base class (base_dataset.py:36-205):
    labels map bonafide -> 1, spoof -> 0; ``return_raw`` skips the
    silence trim so attacks see untrimmed audio (base_dataset.py:168-174).
    """

    def __init__(
        self,
        subset: str,
        transform=None,
        return_label: bool = True,
        return_meta: bool = False,
        return_raw: bool = False,
    ):
        self.transform = transform
        self.samples = pd.DataFrame()
        self.subset = subset
        self.allowed_attacks = None
        self.partition_ratio = None
        self.seed = None
        self.return_label = return_label
        self.return_meta = return_meta
        self.return_raw = return_raw

    def split_samples(self, samples_list):
        """Deterministic subset selection (base_dataset.py:56-69)."""
        if isinstance(samples_list, pd.DataFrame):
            samples_list = samples_list.sort_values(by=list(samples_list.columns))
            samples_list = samples_list.sample(frac=1, random_state=self.seed)
            n = len(samples_list)
        else:
            samples_list = sorted(samples_list)
            random.seed(self.seed)
            random.shuffle(samples_list)
            n = len(samples_list)

        p, s = self.partition_ratio
        i, j = int(p * n), int((p + s) * n)
        bounds = {"train": (0, i), "test": (i, j), "val": (j, n)}[self.subset]
        if isinstance(samples_list, pd.DataFrame):
            return samples_list.iloc[bounds[0] : bounds[1]]
        return samples_list[bounds[0] : bounds[1]]

    def __getitem__(self, index):
        sample = self.samples.iloc[index]
        path = str(sample["path"])
        label = sample["label"]
        attack_type = sample["attack_type"] if "attack_type" in sample else "N/A"
        if not isinstance(attack_type, str) and (
            attack_type is None or (isinstance(attack_type, float) and math.isnan(attack_type))
        ):
            attack_type = "N/A"

        waveform, sample_rate = dsp.load_audio(path)
        real_sec_length = waveform.shape[-1] / sample_rate

        if self.return_raw:
            waveform, sample_rate = dsp.wavefake_preprocessing(
                waveform, sample_rate,
                wave_fake_trim=False, wave_fake_cell_phone=False,
            )
        else:
            waveform, sample_rate = dsp.wavefake_preprocessing(waveform, sample_rate)

        return_data = [waveform, sample_rate]
        if self.return_label:
            return_data.append(1 if label == "bonafide" else 0)
        if self.return_meta:
            return_data.append((attack_type, path, self.subset, real_sec_length))
        return return_data

    def __len__(self):
        return len(self.samples)


class DeepFakeASVSpoofDataset(SimpleAudioFakeDataset):
    """ASVspoof2021-DF manifest (deepfake_asvspoof_dataset.py:15-83)."""

    protocol_file_name = "keys/CM/trial_metadata.txt"
    subset_dir_prefix = "ASVspoof2021_DF_eval"
    subset_parts = ("part00", "part01", "part02", "part03")

    def __init__(self, path, subset="train", transform=None):
        super().__init__(subset, transform)
        self.path = path
        self.partition_ratio = DF_ASVSPOOF_SPLIT["partition_ratio"]
        self.seed = DF_ASVSPOOF_SPLIT["seed"]
        self.flac_paths = self.get_file_references()
        self.samples = self.read_protocol()

    def get_file_references(self):
        flac_paths = {}
        for part in self.subset_parts:
            part_dir = (
                Path(self.path)
                / f"{self.subset_dir_prefix}_{part}"
                / self.subset_dir_prefix
                / "flac"
            )
            for p in part_dir.glob("*.flac"):
                flac_paths[p.stem] = p
        return flac_paths

    def read_protocol(self):
        # NOTE: no attack_type column — like the reference
        # (deepfake_asvspoof_dataset.py:46-51); the DetectionDataset
        # union leaves NaN there, surfaced as "N/A" in metadata.
        samples = {"sample_name": [], "label": [], "path": []}
        real_samples, fake_samples = [], []
        with open(Path(self.path) / self.protocol_file_name, "r") as f:
            for line in f:
                label = line.strip().split(" ")[5]
                if label == "bonafide":
                    real_samples.append(line)
                elif label == "spoof":
                    fake_samples.append(line)

        for line in self.split_samples(fake_samples):
            self._add_line(samples, line)
        for line in self.split_samples(real_samples):
            self._add_line(samples, line)
        return pd.DataFrame(samples)

    def _add_line(self, samples, line):
        parts = line.strip().split(" ")
        sample_name, label = parts[1], parts[5]
        samples["sample_name"].append(sample_name)
        samples["label"].append(label)
        sample_path = self.flac_paths[sample_name]
        assert sample_path.exists()
        samples["path"].append(sample_path)


class WaveFakeDataset(SimpleAudioFakeDataset):
    """WaveFake manifest (wavefake_dataset.py:16-83)."""

    fake_data_path = "generated_audio"
    jsut_real_data_path = "real_audio/jsut_ver1.1/basic5000/wav"
    ljspeech_real_data_path = "real_audio/LJSpeech-1.1/wavs"

    def __init__(self, path, subset="train", transform=None):
        super().__init__(subset, transform)
        self.path = Path(path)
        self.allowed_attacks = WAVEFAKE_SPLIT[subset]
        self.partition_ratio = WAVEFAKE_SPLIT["partition_ratio"]
        self.seed = WAVEFAKE_SPLIT["seed"]
        self.samples = pd.concat(
            [self.get_fake_samples(), self.get_real_samples()], ignore_index=True
        )

    @staticmethod
    def get_attack_from_path(path: Path) -> str:
        folder_name = path.parents[0].relative_to(path.parents[1])
        return str(folder_name).split("_", maxsplit=1)[-1]

    def get_fake_samples(self):
        samples = {k: [] for k in
                   ["user_id", "sample_name", "attack_type", "label", "path"]}
        samples_list = list((self.path / self.fake_data_path).glob("*/*.wav"))
        samples_list = [
            s for s in samples_list
            if self.get_attack_from_path(s) in self.allowed_attacks
        ]
        for sample in self.split_samples(samples_list):
            samples["user_id"].append(None)
            samples["sample_name"].append("_".join(sample.stem.split("_")[:-1]))
            samples["attack_type"].append(self.get_attack_from_path(sample))
            samples["label"].append("spoof")
            samples["path"].append(sample)
        return pd.DataFrame(samples)

    def get_real_samples(self):
        samples = {k: [] for k in
                   ["user_id", "sample_name", "attack_type", "label", "path"]}
        samples_list = list((self.path / self.jsut_real_data_path).glob("*.wav"))
        samples_list += list((self.path / self.ljspeech_real_data_path).glob("*.wav"))
        for sample in self.split_samples(samples_list):
            samples["user_id"].append(None)
            samples["sample_name"].append(sample.stem)
            samples["attack_type"].append("-")
            samples["label"].append("bonafide")
            samples["path"].append(sample)
        return pd.DataFrame(samples)


class FakeAVCelebDataset(SimpleAudioFakeDataset):
    """FakeAVCeleb v1.2 manifest (fakeavceleb_dataset.py:16-93)."""

    audio_folder = "FakeAVCeleb-audio"
    audio_extension = ".mp3"
    metadata_file = Path(audio_folder) / "meta_data.csv"

    def __init__(self, path, subset="train", transform=None):
        super().__init__(subset, transform)
        self.path = path
        self.allowed_attacks = FAKEAVCELEB_SPLIT[subset]
        self.partition_ratio = FAKEAVCELEB_SPLIT["partition_ratio"]
        self.seed = FAKEAVCELEB_SPLIT["seed"]
        self.metadata = self.get_metadata()
        self.samples = pd.concat(
            [self.get_fake_samples(), self.get_real_samples()], ignore_index=True
        )

    def get_metadata(self):
        md = pd.read_csv(Path(self.path) / self.metadata_file)
        md["audio_type"] = md["type"].apply(lambda x: x.split("-")[-1])
        return md

    def get_file_path(self, sample):
        path = "/".join([self.audio_folder, *sample["path"].split("/")[1:]])
        return (
            Path(self.path) / path
            / Path(sample["filename"]).with_suffix(self.audio_extension)
        )

    def get_fake_samples(self):
        samples = {k: [] for k in
                   ["user_id", "sample_name", "attack_type", "label", "path"]}
        for attack_name in self.allowed_attacks:
            fake = self.metadata[
                (self.metadata["method"] == attack_name)
                & (self.metadata["audio_type"] == "FakeAudio")
            ]
            # reference feeds iterrows() tuples into the list branch of
            # split_samples — order by row index, then seeded shuffle
            rows = list(fake.iterrows())
            rows = self._split_rows(rows)
            for _, sample in rows:
                samples["user_id"].append(sample["source"])
                samples["sample_name"].append(Path(sample["filename"]).stem)
                samples["attack_type"].append(sample["method"])
                samples["label"].append("spoof")
                samples["path"].append(self.get_file_path(sample))
        return pd.DataFrame(samples)

    def _split_rows(self, rows):
        """List-branch split on (index, row) tuples: the reference sorts
        the tuples (= by row index) then seeded-shuffles."""
        order = sorted(range(len(rows)), key=lambda i: rows[i][0])
        random.seed(self.seed)
        random.shuffle(order)
        p, s = self.partition_ratio
        n = len(order)
        i, j = int(p * n), int((p + s) * n)
        bounds = {"train": (0, i), "test": (i, j), "val": (j, n)}[self.subset]
        return [rows[k] for k in order[bounds[0] : bounds[1]]]

    def get_real_samples(self):
        samples = {k: [] for k in
                   ["user_id", "sample_name", "attack_type", "label", "path"]}
        real = self.metadata[
            (self.metadata["method"] == "real")
            & (self.metadata["audio_type"] == "RealAudio")
        ]
        real = self.split_samples(real)
        for _, sample in real.iterrows():
            samples["user_id"].append(sample["source"])
            samples["sample_name"].append(Path(sample["filename"]).stem)
            samples["attack_type"].append("-")
            samples["label"].append("bonafide")
            samples["path"].append(self.get_file_path(sample))
        return pd.DataFrame(samples)


ASVSPOOF_2019_ATTACKS = [
    "A01", "A07", "A08", "A02", "A09", "A10", "A03", "A04", "A05", "A06",
    "A11", "A12", "A13", "A14", "A15", "A16", "A17", "A18", "A19",
]
ASVSPOOF_SPLIT = {
    "train": ASVSPOOF_2019_ATTACKS,
    "test": ASVSPOOF_2019_ATTACKS,
    "val": ASVSPOOF_2019_ATTACKS,
    "partition_ratio": [0.7, 0.15],
    "seed": 45,
}


class ASVSpoofDataset(SimpleAudioFakeDataset):
    """ASVspoof2019-LA manifest (asvspoof_dataset.py:16-92) — legacy:
    not used by DetectionDataset in the reference either, kept for
    inventory completeness."""

    protocol_folder_name = "ASVspoof2019_LA_cm_protocols"
    subset_dir_prefix = "ASVspoof2019_LA_"
    subsets = ("train", "dev", "eval")

    def __init__(self, path, subset="train", transform=None):
        super().__init__(subset, transform)
        self.path = path
        self.allowed_attacks = ASVSPOOF_SPLIT[subset]
        self.partition_ratio = ASVSPOOF_SPLIT["partition_ratio"]
        self.seed = ASVSPOOF_SPLIT["seed"]

        self.samples = pd.DataFrame()
        for part in self.subsets:
            subset_dir = Path(self.path) / f"{self.subset_dir_prefix}{part}"
            protocol_path = self._get_protocol_path(part)
            self.samples = pd.concat(
                [self.samples, self._read_protocol(subset_dir, protocol_path)]
            )

    def _get_protocol_path(self, part):
        paths = (Path(self.path) / self.protocol_folder_name).glob("*.txt")
        for p in paths:
            if part in p.stem:
                return p
        raise FileNotFoundError(f"no protocol for subset '{part}'")

    def _read_protocol(self, subset_dir, protocol_path):
        samples = {k: [] for k in
                   ["user_id", "sample_name", "attack_type", "label", "path"]}
        real_lines, fake_lines = [], []
        with open(protocol_path, "r") as f:
            for line in f:
                attack_type = line.strip().split(" ")[3]
                if attack_type == "-":
                    real_lines.append(line)
                elif attack_type in self.allowed_attacks:
                    fake_lines.append(line)

        for line in self.split_samples(fake_lines):
            self._add_line(samples, line, subset_dir)
        for line in self.split_samples(real_lines):
            self._add_line(samples, line, subset_dir)
        return pd.DataFrame(samples)

    @staticmethod
    def _add_line(samples, line, subset_dir):
        user_id, sample_name, _, attack_type, label = line.strip().split(" ")
        samples["user_id"].append(user_id)
        samples["sample_name"].append(sample_name)
        samples["attack_type"].append(attack_type)
        samples["label"].append(label)
        sample_path = subset_dir / "flac" / f"{sample_name}.flac"
        assert sample_path.exists()
        samples["path"].append(sample_path)
