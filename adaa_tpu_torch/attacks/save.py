"""Adversarial dataset generation with robust-accuracy logging (port of
``adaa_tpu/attacks/save.py``).

The vendored library's ``Attack.save`` loop (reference adversarial_attacks/
torchattacks/attack.py:149-229): attack every batch of a loader, report
the running robust accuracy and L2 distance, and optionally write the
adversarial waves, labels (and predictions) to an ``.npz`` archive with
the JAX package's keys.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from adaa_tpu_torch.attacks import core

LOGGER = logging.getLogger(__name__)


def save_adversarial_dataset(
    attack_fn: core.AttackFn,
    logits_fn: core.LogitsFn,
    data_loader,
    save_path: Optional[str] = None,
    verbose: bool = True,
    return_verbose: bool = False,
    save_pred: bool = False,
    generator: Optional[torch.Generator] = None,
    wave_space: bool = True,
    device: str = "cuda",
):
    """Attack every batch (waves ``batch[0]``, labels ``batch[2]``) on
    ``device``; returns (robust_acc, l2, elapsed_ms) when
    ``return_verbose``. ``wave_space=True`` applies the min-max round trip
    per batch (the pipeline's convention). The attacks draw from
    ``generator``, batch after batch (by default one seeded 0 on
    ``device``)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    atk = core.attack_in_wave_space(attack_fn) if wave_space else attack_fn

    adv_list, label_list, pred_list = [], [], []
    correct, total, l2_sum = 0, 0, 0.0
    t0 = time.perf_counter()

    for batch in data_loader:
        batch_x = torch.as_tensor(np.asarray(batch[0])).to(device)
        batch_y = torch.as_tensor(np.asarray(batch[2])).to(device).long()
        adv = atk(batch_x, batch_y, generator).detach()

        with torch.no_grad():
            pred = core.predicted_label(logits_fn(adv))
        correct += int((pred == batch_y).sum())
        total += batch_x.shape[0]
        delta = (adv - batch_x).reshape(batch_x.shape[0], -1)
        l2_sum += float((delta * delta).sum(dim=1).sqrt().sum())

        adv_list.append(adv.cpu().numpy())
        label_list.append(np.asarray(batch[2]))
        if save_pred:
            pred_list.append(pred.cpu().numpy().astype(np.int32))

        if verbose:
            LOGGER.info("- Save progress: %.2f %% / Robust accuracy: %.2f %% / L2: %.5f (%.3f ms)",
                        100 * total / max(total, 1), 100 * correct / total, l2_sum / total,
                        (time.perf_counter() - t0) * 1000)

    rob_acc = 100.0 * correct / max(total, 1)
    l2 = l2_sum / max(total, 1)
    elapsed_ms = (time.perf_counter() - t0) * 1000

    if save_path is not None:
        arrays = {"adv_inputs": np.concatenate(adv_list), "labels": np.concatenate(label_list)}
        if save_pred:
            arrays["preds"] = np.concatenate(pred_list)
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        np.savez(save_path, **arrays)
        LOGGER.info("- Save complete! -> %s", save_path)

    if return_verbose:
        return rob_acc, l2, elapsed_ms
