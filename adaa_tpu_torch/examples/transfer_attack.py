"""Transfer attack demo (port of ``examples/transfer_attack.py``), the
counterpart of the reference's "Transfer Attack (CIFAR10)" demo notebook
(adversarial_attacks/demos/), on the audio domain.

The notebook's recipe: train a SOURCE model, craft adversarial examples
against it, then measure how well they transfer to a different TARGET
architecture (white-box vs transfer robust accuracy). Here the source is
SpecRNet and the target LCNN: the same cross-model pairing the
reference's CLI exercises via ``--attack_model_config``
(evaluate_models_on_adversarial_attacks.py).

Runs on the card, or on the CPU with ``--cpu``, against the synthetic
dataset (no corpora needed):

    python -m adaa_tpu_torch.examples.transfer_attack [--wave-len 16000] [--train-n 256]
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
from adaa_tpu_torch.training.gd_trainer import GDTrainer

BATCH = 64  # the trainers' batch
ATTACKS = ("FGSM_eps001", "PGD_eps001", "PGDL2_eps20")
FLOOR = ("PGD_eps001",)


def run(wave_len: int = 16_000, train_n: int = 256, epochs: int = 3,
        cpu: bool = False) -> Dict[str, Any]:
    """Train the source and the target, then each attack crafted once on the
    source, scored on both: ``{"train": seconds by model, "clean": source and
    target accuracy, "attack": white-box and transfer accuracy by attack,
    "floor": the target's white-box accuracy}``."""
    device = device_for(cpu)
    train_ds = SyntheticDataset(n=train_n, subset="train", wave_length=wave_len, class_sep=0.6)
    test_ds = SyntheticDataset(n=train_n // 4, subset="test", wave_length=wave_len,
                               class_sep=0.6)
    val_ds = SyntheticDataset(n=train_n // 4, subset="val", wave_length=wave_len, class_sep=0.6)
    out: Dict[str, Any] = {"train": {}}

    def fit(name, seed):
        model = _common.detector(name, seed, device)
        t0 = time.perf_counter()
        GDTrainer(epochs=epochs, batch_size=BATCH, optimizer_kwargs={"lr": 1e-4}).train(
            train_ds, model, test_dataset=test_ds)
        out["train"][name] = time.perf_counter() - t0
        return attacks.make_logits_fn(model)

    src = fit("specrnet", 0)   # attacker's surrogate
    tgt = fit("lcnn", 10)      # deployed victim

    x, y = _common.first_batch(val_ds, len(val_ds), device, num_workers=2)
    out["clean"] = {"source": _common.accuracy(src, x, y), "target": _common.accuracy(tgt, x, y)}
    out["attack"] = {}
    for name in ATTACKS:
        # crafted ONCE on the source; the target never sees a gradient
        adv = _common.attacked(name, src, x, y, torch.Generator(device).manual_seed(2))
        out["attack"][name] = {"white_box": _common.accuracy(src, adv, y),
                               "transfer": _common.accuracy(tgt, adv, y)}
    # white-box floor on the target, for scale
    out["floor"] = {}
    for name in FLOOR:
        adv = _common.attacked(name, tgt, x, y, torch.Generator(device).manual_seed(3))
        out["floor"][name] = _common.accuracy(tgt, adv, y)
    return out


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--wave-len", type=int, default=16_000)
    parser.add_argument("--train-n", type=int, default=256)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    out = run(args.wave_len, args.train_n, args.epochs, args.cpu)
    for name, s in out["train"].items():
        print(f"[train] {name}: {args.epochs} epochs in {s:.1f}s")
    print(f"[clean] source acc: {out['clean']['source']:.2%}  "
          f"target acc: {out['clean']['target']:.2%}")
    print(f"{'attack':14s} {'white-box(src)':>15s} {'transfer(tgt)':>14s}")
    for name, r in out["attack"].items():
        print(f"{name:14s} {r['white_box']:>14.2%} {r['transfer']:>13.2%}")
    for name, acc in out["floor"].items():
        print(f"[floor] {name} white-box on target: {acc:.2%}")
    return out


if __name__ == "__main__":
    main()
