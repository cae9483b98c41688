"""Demo: attack a detector and inspect robustness (port of
``examples/attack_demo.py``), the counterpart of the reference's
torchattacks demo notebooks, on the audio domain.

Runs on the card, or on the CPU with ``--cpu``; uses the synthetic
dataset (no corpora needed):

    python -m adaa_tpu_torch.examples.attack_demo [--cpu] [--save-path PATH]
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any, Dict

import torch

from adaa_tpu_torch import attacks
from adaa_tpu_torch.attacks.save import save_adversarial_dataset
from adaa_tpu_torch.data.loader import DataLoader
from adaa_tpu_torch.data.synthetic import SyntheticDataset
from adaa_tpu_torch.examples import _common
from adaa_tpu_torch.scripts._common import device_for

WAVE_LEN = 16_000
ATTACKS = ("FGSM_eps001", "PGD_eps001", "PGDL2_eps20", "FAB")
SAVE_PATH = os.path.join(tempfile.gettempdir(), "adv_demo.npz")


def dataset() -> SyntheticDataset:
    return SyntheticDataset(n=32, subset="val", wave_length=WAVE_LEN)


def run(cpu: bool = False, save_path: str = SAVE_PATH) -> Dict[str, Any]:
    device = device_for(cpu)
    logits_fn = attacks.make_logits_fn(_common.detector("lcnn", 0, device))
    ds = dataset()
    x, y = _common.first_batch(ds, 16, device)
    out: Dict[str, Any] = {"clean_accuracy": _common.accuracy(logits_fn, x, y), "attacks": {}}
    for name in ATTACKS:
        adv = _common.attacked(name, logits_fn, x, y, torch.Generator(device).manual_seed(1))
        out["attacks"][name] = {"robust_accuracy": _common.accuracy(logits_fn, adv, y),
                                "max_abs_delta": float((adv - x).abs().max())}

    # Attack.save equivalent: export an adversarial dataset
    atk = attacks.build_attack("FGSM_eps001", logits_fn)
    loader = DataLoader(ds, 16, shuffle=False, num_workers=1)
    rob, l2, ms = save_adversarial_dataset(atk, logits_fn, loader, save_path=save_path,
                                           return_verbose=True, verbose=False, device=device)
    out["saved"] = {"path": save_path, "robust_accuracy_pct": rob, "mean_l2": l2, "ms": ms}
    return out


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--save-path", default=SAVE_PATH)
    args = parser.parse_args(argv)
    out = run(args.cpu, args.save_path)
    print(f"clean accuracy: {out['clean_accuracy']:.2%}")
    for name, row in out["attacks"].items():
        print(f"{name:14s} robust acc: {row['robust_accuracy']:.2%}   "
              f"max|delta|: {row['max_abs_delta']:.5f}")
    saved = out["saved"]
    print(f"saved {saved['path']}  robust acc {saved['robust_accuracy_pct']:.1f}%  "
          f"mean L2 {saved['mean_l2']:.4f}  ({saved['ms']:.0f} ms)")
    return out


if __name__ == "__main__":
    main()
