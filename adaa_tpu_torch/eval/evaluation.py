"""Clean evaluation loop (port of ``adaa_tpu/eval/evaluation.py``).

The reference's ``evaluate_nn`` (evaluate_models.py:39-133): batched
eval-mode forward, sigmoid, label ``(p + .5)`` as int, accuracy /
precision / recall / F1 / AUC, EER on flipped labels, and the
``eval/*`` log line. Batches come from the loader as numpy and move to
the model's device; the predictions stay there until one pull at the end.
There is no data parallelism yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import contextlib
import logging
from typing import Dict, Iterator

import numpy as np
import torch
from torch import nn

from adaa_tpu_torch import metrics
from adaa_tpu_torch.data.loader import DataLoader

LOGGER = logging.getLogger(__name__)


@contextlib.contextmanager
def eval_mode(*models: nn.Module) -> Iterator[None]:
    """Run ``models`` in ``eval()``; give each module its ``training`` flag back."""
    modes = [(m, m.training) for model in models for m in model.modules()]
    for model in models:
        model.eval()
    try:
        yield
    finally:
        for m, training in modes:
            m.training = training


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def evaluate_nn(model: nn.Module, dataset, batch_size: int = 128,
                model_name: str = "") -> Dict[str, float]:
    LOGGER.info("Testing '%s' model on %d audio files.", model_name, len(dataset))
    loader = DataLoader(dataset, batch_size, shuffle=True, drop_last=True, num_workers=3)
    device = model_device(model)
    batches_number = len(dataset) // batch_size
    y_pred, y = [], []
    with eval_mode(model), torch.no_grad():
        for i, batch in enumerate(loader):
            if i % 10 == 0:
                LOGGER.info("Batch [%d/%d]", i, batches_number)
            x = torch.from_numpy(batch[0]).to(device)
            y_pred.append(torch.sigmoid(model(x).squeeze(1)))
            y.append(batch[2])
    if not y_pred:
        raise ValueError(
            f"no full batches: {len(dataset)} samples < batch_size "
            f"{batch_size} with drop_last — lower batch_size or raise --amount")
    y_pred = torch.cat(y_pred).cpu().numpy()  # one pull
    y_pred_label = (y_pred + 0.5).astype(np.int32)
    y = np.concatenate(y)

    report = metrics.classification_report(y, y_pred, y_pred_label)
    LOGGER.info(metrics.format_metrics("eval", report))
    return report
