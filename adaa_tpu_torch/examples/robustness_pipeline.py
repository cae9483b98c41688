"""End-to-end robustness pipeline demo (port of
``examples/robustness_pipeline.py``), the counterpart of the reference's
Adversarial-Training / Transfer-Attack demo notebooks:

  train a detector -> attack it (white-box matrix) -> adversarially
  finetune (RANDOM strategy, self-attack) -> re-attack.

Runs on the card, or on the CPU with ``--cpu``, against the synthetic
dataset (no corpora needed):

    python -m adaa_tpu_torch.examples.robustness_pipeline [--wave-len 16000] [--train-n 256]
        [--epochs 3] [--cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import torch

from adaa_tpu_torch import attacks
from adaa_tpu_torch.data.synthetic import SyntheticDataset
from adaa_tpu_torch.examples import _common
from adaa_tpu_torch.scripts._common import device_for
from adaa_tpu_torch.training.adv_trainer import ADV_TRAINER_REGISTRY
from adaa_tpu_torch.training.gd_trainer import GDTrainer

BATCH = 64  # the trainers' batch
ATTACKS = ("FGSM_eps001", "PGD_eps001", "PGDL2_eps20", "FAB")
TRAINING_ATTACKS = ["FGSM_eps001", "PGDL2_eps20"]
AFTER = ("FGSM_eps001", "PGD_eps001", "PGDL2_eps20")


def run(wave_len: int = 16_000, train_n: int = 256, epochs: int = 3,
        cpu: bool = False) -> Dict[str, Any]:
    """Train the LCNN, attack it, fine-tune it adversarially and attack it
    again: ``{"train": seconds, "clean": accuracy, "attack": robust accuracy
    by attack, "advtrain": seconds, "after": clean and robust accuracy}``."""
    device = device_for(cpu)
    train_ds = SyntheticDataset(n=train_n, subset="train", wave_length=wave_len)
    test_ds = SyntheticDataset(n=train_n // 4, subset="test", wave_length=wave_len)
    val_ds = SyntheticDataset(n=train_n // 4, subset="val", wave_length=wave_len)
    model = _common.detector("lcnn", 0, device)
    logits_fn = attacks.make_logits_fn(model)  # the live weights, trained in place

    out: Dict[str, Any] = {}
    t0 = time.perf_counter()
    GDTrainer(epochs=epochs, batch_size=BATCH, optimizer_kwargs={"lr": 1e-4}).train(
        train_ds, model, test_dataset=test_ds)
    out["train"] = time.perf_counter() - t0

    x, y = _common.first_batch(val_ds, len(val_ds), device, num_workers=2)
    out["clean"] = _common.accuracy(logits_fn, x, y)
    out["attack"] = {}
    for name in ATTACKS:
        adv = _common.attacked(name, logits_fn, x, y, torch.Generator(device).manual_seed(2))
        out["attack"][name] = _common.accuracy(logits_fn, adv, y)

    trainer = ADV_TRAINER_REGISTRY["RANDOM"](
        epochs=max(epochs - 1, 1), batch_size=BATCH, optimizer_kwargs={"lr": 1e-4})
    t0 = time.perf_counter()
    trainer.train(dataset=train_ds, model=model, attack_model=None,  # self-attack
                  adversarial_attacks=TRAINING_ATTACKS, test_dataset=test_ds,
                  generator=torch.Generator(device).manual_seed(3))
    out["advtrain"] = time.perf_counter() - t0

    out["after"] = {"clean": _common.accuracy(logits_fn, x, y)}
    for name in AFTER:  # white-box against the fine-tuned model
        adv = _common.attacked(name, logits_fn, x, y, torch.Generator(device).manual_seed(4))
        out["after"][name] = _common.accuracy(logits_fn, adv, y)
    return out


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--wave-len", type=int, default=16_000)
    parser.add_argument("--train-n", type=int, default=256)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    out = run(args.wave_len, args.train_n, args.epochs, args.cpu)
    print(f"[train] {args.epochs} epochs x {args.train_n} samples in {out['train']:.1f}s")
    print(f"[clean] val accuracy: {out['clean']:.2%}")
    for name, acc in out["attack"].items():
        print(f"[attack] {name:14s} robust acc: {acc:.2%}")
    print(f"[advtrain] {out['advtrain']:.1f}s")
    print(f"[after] clean acc: {out['after']['clean']:.2%}")
    for name in AFTER:
        print(f"[after] {name:14s} robust acc: {out['after'][name]:.2%}")
    return out


if __name__ == "__main__":
    main()
