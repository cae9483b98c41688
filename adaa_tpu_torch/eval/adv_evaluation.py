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

Under a process group whose size divides the batch (``parallel.mesh``),
each rank attacks and predicts its rows of every batch and the results
are all-gathered, so every rank holds the global batch's; an attack
outside ``ATTACK_REGISTRY`` (its draws are not the global batch's) runs
whole on every rank.

Raw mode (``raw_sample_from_dataset``, the CLI's ``--raw_from_dataset``):
the dataset gives untrimmed items, and the attacked batch goes back
through the canonical preprocessing WITH DEFAULTS (silence trim, then
repeat-pad) before the victim sees it, as the reference does
(evaluate_models_on_adversarial_attacks.py:229-234 -> base_dataset.py:
122-148). The trim is host code (the host library's sox-silence port), so
raw mode pays one device -> host -> device round trip per batch, as the
reference and the JAX package do.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from adaa_tpu_torch import attacks as attacks_lib
from adaa_tpu_torch import metrics
from adaa_tpu_torch.data import base as dsp
from adaa_tpu_torch.data.loader import DataLoader
from adaa_tpu_torch.eval.evaluation import eval_mode, model_device
from adaa_tpu_torch.parallel import mesh

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
    device = model_device(victim_model)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    if attack_name in attacks_lib.ATTACK_REGISTRY:
        builder, params = attacks_lib.ATTACK_REGISTRY[attack_name]
    else:
        builder, params = attacks_lib.EXTRA_ATTACKS[attack_name], {}
    has_attack = builder is not None and attack_model is not None
    if mesh.data_parallel(batch_size):
        for model in (victim_model, attack_model):
            if model is not None:
                mesh.replicate(model)
        LOGGER.info("Data-parallel over %d processes", mesh.world()[0])
    if has_attack:
        attack_batch = attacks_lib.attack_in_wave_space(
            builder(attacks_lib.make_logits_fn(attack_model), **params))
        if attack_name in attacks_lib.ATTACK_REGISTRY:
            attack_batch = mesh.data_parallel_attack_fn(attack_batch)
        LOGGER.info("Attack using '%s' method (%s)", attack_name, params)
    else:
        LOGGER.info("No attack applied")

    def victim_predict(x: torch.Tensor) -> torch.Tensor:
        with eval_mode(victim_model), torch.no_grad():
            return mesh.map_sharded(lambda xs: torch.sigmoid(victim_model(xs).squeeze(1)), x)

    def reprocessed(batch_x: np.ndarray, batch_sr: np.ndarray) -> torch.Tensor:
        """The canonical preprocessing with its defaults (trim, re-pad) on
        the host, back on the victim's device (reference :229-234)."""
        waves, _ = dsp.wavefake_preprocessing_on_batch(batch_x, batch_sr)
        return torch.from_numpy(waves).to(device)

    loader = DataLoader(dataset, batch_size, shuffle=True, drop_last=True, num_workers=3)
    y_pred, y = [], []
    for batch in loader:
        batch_x = torch.from_numpy(batch[0]).to(device)
        batch_y = torch.from_numpy(batch[2]).to(device).long()
        batch_meta = batch[3] if len(batch) > 3 else None
        batch_x_attacked = attack_batch(batch_x, batch_y, generator) if has_attack else batch_x
        # the callback receives the waveforms from before any
        # re-preprocessing (the reference keeps unprocessed clones, :225-226)
        need_callback = on_attack_end_callback is not None
        attacked_noproc = (batch_x_attacked.cpu().numpy()
                           if need_callback or raw_sample_from_dataset else None)
        victim_x = (reprocessed(attacked_noproc, batch[1]) if raw_sample_from_dataset
                    else batch_x_attacked)
        preds = victim_predict(victim_x)
        y.append(batch[2])
        if not need_callback:
            y_pred.append(preds)  # stays on the device: one pull at the end
            continue
        preds = preds.cpu().numpy()
        clean = reprocessed(batch[0], batch[1]) if raw_sample_from_dataset else batch_x
        preds_noattack = victim_predict(clean).cpu().numpy()
        on_attack_end_callback(
            batch_x=batch[0],
            batch_x_attacked=attacked_noproc,
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
