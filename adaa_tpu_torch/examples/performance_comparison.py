"""Attack performance comparison (port of
``examples/performance_comparison.py``), the counterpart of the
reference's "Performance Comparison (CIFAR10)" demo notebook
(adversarial_attacks/demos/), on the audio domain.

For a grid of registry attacks it reports, per attack: wall time
(through to the card's last kernel, the first call's builds included),
success rate (prediction flips), and the mean L0/L2/Linf perturbation
norms: the same three axes the reference notebook tabulates (robust
accuracy, perturbation distance, runtime).

Also demonstrates the "model with multiple outputs" pattern from the
reference's "Model with Multiple Outputs" notebook: attacks consume a
``logits_fn``, so a model returning (logits, embedding) is adapted with
a one-line selector instead of a wrapper class.

Runs on the card, or on the CPU with ``--cpu``, against the synthetic
dataset (no corpora needed):

    python -m adaa_tpu_torch.examples.performance_comparison [--batch 16] [--attacks ...] [--cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from adaa_tpu_torch import attacks
from adaa_tpu_torch.data.synthetic import SyntheticDataset
from adaa_tpu_torch.examples import _common
from adaa_tpu_torch.scripts._common import device_for

WAVE_LEN = 16_000
# quick-running grid; add e.g. Square / OnePixel (query-based, slower)
# via --attacks
DEFAULT_ATTACKS = ["FGSM", "PGD", "PGDL2", "BIM", "MIFGSM", "DeepFool", "CW", "FAB"]


def norms(delta: np.ndarray) -> Tuple[float, float, float]:
    flat = delta.reshape(delta.shape[0], -1)
    return (
        (np.abs(flat) > 1e-9).sum(axis=1).mean(),       # L0 (coords changed)
        np.linalg.norm(flat, axis=1).mean(),             # L2
        np.abs(flat).max(axis=1).mean(),                 # Linf
    )


def run(batch: int = 16, attack_names: Sequence[str] = DEFAULT_ATTACKS,
        cpu: bool = False) -> Dict[str, Any]:
    device = device_for(cpu)
    # "Model with Multiple Outputs" pattern: suppose the model returned
    # (logits, embedding); attacks only need a logits_fn, so select:
    base_fn = attacks.make_logits_fn(_common.detector("lcnn", 0, device))
    multi_output_fn = lambda x: (base_fn(x), x.mean())  # noqa: E731  pretend model
    logits_fn = lambda x: multi_output_fn(x)[0]  # noqa: E731  one-line adapter

    x, y = _common.first_batch(SyntheticDataset(n=batch * 2, subset="val",
                                                wave_length=WAVE_LEN), batch, device)
    x01, mn, mx = attacks.to_minmax(x)
    out: Dict[str, Any] = {"clean_accuracy": _common.accuracy(logits_fn, x, y), "attacks": {}}
    for name in attack_names:
        atk = attacks.build_attack(name, logits_fn)
        gen = torch.Generator(device).manual_seed(42)
        t0 = time.perf_counter()
        adv01 = atk(x01, y, gen).detach()
        if device != "cpu":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        adv = attacks.revert_minmax(adv01, mn, mx)
        l0, l2, linf = norms((adv01 - x01).cpu().numpy())
        out["attacks"][name] = {"time_s": dt, "success": 1.0 - _common.accuracy(logits_fn, adv, y),
                                "l0": float(l0), "l2": float(l2), "linf": float(linf)}
    return out


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--attacks", nargs="*", default=DEFAULT_ATTACKS)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    out = run(args.batch, args.attacks, args.cpu)
    print(f"clean accuracy: {out['clean_accuracy']:.2%}\n")
    hdr = f"{'attack':<10} {'time(s)':>8} {'success':>8} {'L0':>8} {'L2':>10} {'Linf':>10}"
    print(hdr)
    print("-" * len(hdr))
    for name, r in out["attacks"].items():
        print(f"{name:<10} {r['time_s']:>8.2f} {r['success']:>8.2%} "
              f"{r['l0']:>8.1f} {r['l2']:>10.5f} {r['linf']:>10.6f}")
    return out


if __name__ == "__main__":
    main()
