"""Adversarial evaluation: white-box and transfer (port of
``adaa_tpu/eval/adv_evaluation.py``).

The reference's ``generate_attacks``
(evaluate_models_on_adversarial_attacks.py:146-298): per batch,
``to_minmax`` -> the attack on the attack (surrogate) model ->
``revert_minmax`` -> the victim's prediction; with a callback, also the
victim's no-attack prediction, handed to it with both waveforms; and the
``adv_eval/*`` log line. White-box when the attack model is the victim,
transfer when it is another model on the same device.

The attack's randomness draws from one ``torch.Generator`` (by default a
fresh one seeded 0 on the victim's device), batch after batch.
Raw mode (``raw_sample_from_dataset``) re-preprocesses the attacked audio
with the data layer's silence trim, which is not ported yet.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from adaa_tpu_torch import attacks as attacks_lib
from adaa_tpu_torch import metrics
from adaa_tpu_torch.data.loader import DataLoader
from adaa_tpu_torch.eval.evaluation import eval_mode, model_device

LOGGER = logging.getLogger(__name__)


def generate_attacks(
    victim_model: nn.Module,
    dataset,
    attack_name: str = "NO_ATTACK",
    attack_model: Optional[nn.Module] = None,
    batch_size: int = 64,
    generator: Optional[torch.Generator] = None,
    on_attack_end_callback: Optional[Callable] = None,
    raw_sample_from_dataset: bool = False,
) -> Dict[str, float]:
    if raw_sample_from_dataset:
        raise NotImplementedError(
            "raw mode (--raw_from_dataset) needs the data layer's silence trim, "
            "which adaa_tpu_torch does not port yet (ROADMAP.md, queue 1)")
    device = model_device(victim_model)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    if attack_name in attacks_lib.ATTACK_REGISTRY:
        builder, params = attacks_lib.ATTACK_REGISTRY[attack_name]
    else:
        builder, params = attacks_lib.EXTRA_ATTACKS[attack_name], {}
    has_attack = builder is not None and attack_model is not None
    if has_attack:
        attack_batch = attacks_lib.attack_in_wave_space(
            builder(attacks_lib.make_logits_fn(attack_model), **params))
        LOGGER.info("Attack using '%s' method (%s)", attack_name, params)
    else:
        LOGGER.info("No attack applied")

    def victim_predict(x: torch.Tensor) -> torch.Tensor:
        with eval_mode(victim_model), torch.no_grad():
            return torch.sigmoid(victim_model(x).squeeze(1))

    loader = DataLoader(dataset, batch_size, shuffle=True, drop_last=True, num_workers=3)
    y_pred, y = [], []
    for batch in loader:
        batch_x = torch.from_numpy(batch[0]).to(device)
        batch_y = torch.from_numpy(batch[2]).to(device).long()
        batch_meta = batch[3] if len(batch) > 3 else None
        batch_x_attacked = attack_batch(batch_x, batch_y, generator) if has_attack else batch_x
        preds = victim_predict(batch_x_attacked)
        y.append(batch[2])
        if on_attack_end_callback is None:
            y_pred.append(preds)  # stays on the device: one pull at the end
            continue
        preds = preds.cpu().numpy()
        preds_noattack = victim_predict(batch_x).cpu().numpy()
        on_attack_end_callback(
            batch_x=batch_x.cpu().numpy(),
            batch_x_attacked=batch_x_attacked.cpu().numpy(),
            batch_y=np.asarray(batch[2]),
            batch_preds_label=(preds + 0.5).astype(np.int32),
            batch_preds=preds,
            batch_preds_noattack_label=(preds_noattack + 0.5).astype(np.int32),
            batch_preds_noattack=preds_noattack,
            batch_metadata=batch_meta,
        )
        y_pred.append(preds)

    if on_attack_end_callback is None and y_pred:
        y_pred = [torch.cat(y_pred).cpu().numpy()]
    y_pred = np.concatenate(y_pred)
    y_pred_label = (y_pred + 0.5).astype(np.int32)
    y = np.concatenate(y)

    report = metrics.classification_report(y, y_pred, y_pred_label)
    LOGGER.info(metrics.format_metrics("adv_eval", report))
    return report
