"""Shared CLI plumbing (port of ``scripts/_common.py``).

The reference's dataset-path flags, the logging set-up, and the device
choice: ``--cpu`` selects the CPU, otherwise the CLIs run on ``cuda`` and
refuse to start without a card. ``--asv_path synthetic[:N[:L]]`` selects
the in-memory synthetic dataset (N items of L samples); the real corpora
are not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import logging
import sys
from typing import List, Optional, Union

import torch

ASVSPOOF_DATASET_PATH = "/home/adminuser/storage/datasets/deep_fakes/ASVspoof2021/DF"
WAVEFAKE_DATASET_PATH = "/home/adminuser/storage/datasets/deep_fakes/WaveFake"
FAKEAVCELEB_DATASET_PATH = "/home/adminuser/storage/datasets/deep_fakes/FakeAVCeleb/FakeAVCeleb_v1.2"


def setup_logging() -> logging.Logger:
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    ch = logging.StreamHandler(sys.stdout)
    ch.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
    logger.addHandler(ch)
    return logger


def device_for(cpu: bool) -> str:
    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    return "cuda"


def add_dataset_path_args(parser) -> None:
    parser.add_argument("--asv_path", type=str, default=ASVSPOOF_DATASET_PATH,
                        help="Path to ASVspoof2021 dataset directory (or 'synthetic[:N]')")
    parser.add_argument("--wavefake_path", type=str, default=WAVEFAKE_DATASET_PATH,
                        help="Path to WaveFake dataset directory")
    parser.add_argument("--celeb_path", type=str, default=FAKEAVCELEB_DATASET_PATH,
                        help="Path to FakeAVCeleb dataset directory")


def build_dataset(datasets_paths: List[Union[str, None]], subset: str,
                  reduced_number: Optional[int] = None, return_label: bool = True,
                  return_meta: bool = False, return_raw: bool = False):
    asv = datasets_paths[0]
    if isinstance(asv, str) and asv.startswith("synthetic"):
        from adaa_tpu_torch.data.synthetic import SyntheticDataset

        parts = asv.split(":")
        n = int(parts[1]) if len(parts) > 1 else 256
        if reduced_number:
            n = min(n, reduced_number)
        kwargs = {"wave_length": int(parts[2])} if len(parts) > 2 else {}
        return SyntheticDataset(n=n, subset=subset, return_label=return_label,
                                return_meta=return_meta, return_raw=return_raw, **kwargs)
    raise NotImplementedError(
        f"dataset path {asv!r}: the real corpora (ASVspoof, WaveFake, FakeAVCeleb) are not "
        "ported to adaa_tpu_torch yet (ROADMAP.md, queue 1); use --asv_path synthetic[:N[:L]]")
