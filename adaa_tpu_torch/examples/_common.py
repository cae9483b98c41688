"""What the examples share: a detector on seeded weights, a loader's first
batch on the device, accuracy, and a registry attack in wave space."""
from __future__ import annotations

from typing import Tuple

import torch

from adaa_tpu_torch import attacks, models
from adaa_tpu_torch.data.loader import DataLoader
from adaa_tpu_torch.utils import set_seed

LFCC = {"input_channels": 1, "frontend_algorithm": ["lfcc"]}


def detector(name: str, seed: int, device: str) -> torch.nn.Module:
    """``name`` with the LFCC frontend, its weights drawn from ``seed``."""
    return models.init_model(models.get_model(name, LFCC), set_seed(seed, device), device)


def first_batch(dataset, batch_size: int, device: str,
                num_workers: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Waves and labels of an unshuffled loader's first batch, on ``device``."""
    batch = next(iter(DataLoader(dataset, batch_size, shuffle=False, num_workers=num_workers)))
    return (torch.from_numpy(batch[0]).to(device),
            torch.from_numpy(batch[2]).long().to(device))


def accuracy(logits_fn: attacks.core.LogitsFn, x: torch.Tensor, y: torch.Tensor) -> float:
    with torch.no_grad():
        return float((attacks.predicted_label(logits_fn(x)) == y).float().mean())


def attacked(name: str, logits_fn: attacks.core.LogitsFn, x: torch.Tensor, y: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
    """The registry attack ``name`` on ``logits_fn``, in wave space."""
    attack = attacks.attack_in_wave_space(attacks.build_attack(name, logits_fn))
    return attack(x, y, generator).detach()
