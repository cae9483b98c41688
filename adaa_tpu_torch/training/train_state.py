"""Optimizer, learning-rate schedule and train state (port of
``adaa_tpu/training/train_state.py``).

The reference trains with ``torch.optim.Adam`` (per-model configs,
``configs/training/*.yaml``) and, for RawNet3 only, a
CosineAnnealingWarmRestarts schedule (T_mult 1, eta_min 5e-6). The JAX
package builds the same from optax: ``add_decayed_weights`` before
``scale_by_adam`` (torch Adam's L2-into-gradient weight decay, not
AdamW) and a closed-form schedule evaluated at the update count. Here
it is ``torch.optim.Adam`` itself, with the schedule's closed form set
as the learning rate before each step.

The optimizer is never the fused Adam: ``fused=True`` updates the
parameters without raising their version counters, and
``ops.layer0.packed_weights`` keys its cache of packed weight images on
the version, so a self-attack after a fused step would run the layer-0
kernel on the weights of before the step. Any cache keyed on
``_version`` has the same hazard.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

Schedule = Callable[[int], float]


def cosine_annealing_warm_restarts(base_lr: float, t_0: int, eta_min: float = 5e-6) -> Schedule:
    """torch's CosineAnnealingWarmRestarts with T_mult=1, as a function of the
    0-based update count t: eta_min + (base - eta_min) (1 + cos(pi (t mod T_0) / T_0)) / 2."""

    def schedule(count: int) -> float:
        cos = math.cos(math.pi * (count % t_0) / t_0)
        return eta_min + (base_lr - eta_min) * (1.0 + cos) / 2.0

    return schedule


def make_optimizer(params, optimizer_kwargs: Dict[str, Any], use_scheduler: bool = False,
                   batches_per_epoch: Optional[int] = None,
                   scheduler_t0_epochs: int = 2) -> "tuple[torch.optim.Adam, Optional[Schedule]]":
    """``torch.optim.Adam`` (betas 0.9 / 0.999, eps 1e-8, L2 weight decay)
    over ``params``, and the warm-restart schedule (T_0 = ``scheduler_t0_epochs``
    epochs of batches) when ``use_scheduler``, else None."""
    lr = optimizer_kwargs.get("lr", 1e-3)
    schedule = None
    if use_scheduler:
        if batches_per_epoch is None:
            raise ValueError("the schedule needs batches_per_epoch")
        schedule = cosine_annealing_warm_restarts(
            lr, t_0=batches_per_epoch * scheduler_t0_epochs,
            eta_min=optimizer_kwargs.get("eta_min", 5e-6))
    optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=optimizer_kwargs.get("weight_decay", 0.0),
                                 fused=False)
    return optimizer, schedule


@dataclass
class TrainState:
    """The model being trained, its optimizer and schedule, and the count
    of updates made (the schedule's argument)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Optional[Schedule] = None
    step: int = 0


def create_train_state(model: nn.Module, optimizer_kwargs: Dict[str, Any],
                       use_scheduler: bool = False, batches_per_epoch: Optional[int] = None,
                       scheduler_t0_epochs: int = 2) -> TrainState:
    params = [p for p in model.parameters() if p.requires_grad]  # not RawNet3's bn6
    optimizer, schedule = make_optimizer(params, optimizer_kwargs, use_scheduler,
                                         batches_per_epoch, scheduler_t0_epochs)
    return TrainState(model, optimizer, schedule)
