"""Shared CLI plumbing (port of ``scripts/_common.py``).

The reference's dataset-path flags, the logging set-up, and the device
choice: ``--cpu`` selects the CPU, otherwise the CLIs run on ``cuda`` and
refuse to start without a card. The three paths name corpus trees laid
out as ASVspoof2021-DF, WaveFake and FakeAVCeleb (``DetectionDataset``);
``""`` or ``none`` leaves a corpus out. ``--asv_path synthetic[:N[:L]]``
selects the in-memory synthetic dataset instead (N items of L samples).
"""
from __future__ import annotations

import json
import logging
import subprocess
import sys
from datetime import date
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

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


REPO = Path(__file__).resolve().parents[2]
RESULTS_DIR = REPO / "chiprun_out"  # git-ignored: the benchmark tools' records


def provenance() -> str:
    """A record's stamp: '<git short rev> <iso date>' ('unknown' outside a
    git checkout)."""
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
                             capture_output=True, text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        rev = ""
    return f"{rev or 'unknown'} {date.today().isoformat()}"


def card(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" on the CPU."""
    if device == "cpu":
        return "cpu"
    from adaa_tpu_torch.utils.profiling import card_line

    return card_line()


def write_rows(out: Union[str, Path], rows: Dict[str, Any], merge: bool = True) -> Dict[str, Any]:
    """Write ``rows`` to the JSON file ``out``, into the rows it holds unless
    ``merge`` is off; return what was written."""
    out = Path(out)
    results = json.loads(out.read_text()) if merge and out.exists() else {}
    results.update(rows)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    return results


def add_dataset_path_args(parser) -> None:
    parser.add_argument("--asv_path", type=str, default=ASVSPOOF_DATASET_PATH,
                        help="Path to ASVspoof2021 dataset directory (or 'synthetic[:N]')")
    parser.add_argument("--wavefake_path", type=str, default=WAVEFAKE_DATASET_PATH,
                        help="Path to WaveFake dataset directory")
    parser.add_argument("--celeb_path", type=str, default=FAKEAVCELEB_DATASET_PATH,
                        help="Path to FakeAVCeleb dataset directory")


def build_dataset(datasets_paths: List[Union[str, None]], subset: str,
                  reduced_number: Optional[int] = None, oversample: bool = True,
                  return_label: bool = True, return_meta: bool = False,
                  return_raw: bool = False):
    # argparse can't pass None; "" or "none" means "skip this corpus" (the
    # reference's None, evaluate_models.py:162)
    datasets_paths = [None if isinstance(p, str) and p.strip().lower() in ("", "none") else p
                      for p in datasets_paths]
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
    from adaa_tpu_torch.data.detection import DetectionDataset

    return DetectionDataset(asvspoof_path=datasets_paths[0], wavefake_path=datasets_paths[1],
                            fakeavceleb_path=datasets_paths[2], subset=subset,
                            reduced_number=reduced_number, oversample=oversample,
                            return_label=return_label, return_meta=return_meta,
                            return_raw=return_raw)
