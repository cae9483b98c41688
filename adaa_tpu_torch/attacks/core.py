"""Attack protocol core: losses, box transforms, model adapters.

Port of ``adaa_tpu/attacks/core.py``. The single-logit detector is
widened to two classes, logits (-z, z), and attacks run on per-sample
min-max normalised waves in [0, 1]. With integer label y,

    CE(cat[-z, z], y) = softplus(-2 * (2y - 1) * z),

and argmax over (-z, z) is ``z > 0``.

Attacks are functions ``(x01, y, generator) -> adv01`` over a captured
``logits_fn``; ``generator`` is the ``torch.Generator`` of their random
start (None for attacks without one).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LogitsFn = Callable[[torch.Tensor], torch.Tensor]  # (B, L) -> (B, 1)
AttackFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def make_logits_fn(model: nn.Module) -> LogitsFn:
    """Deterministic eval-mode forward with frozen parameters, leaving the
    caller's model as it was.

    Each call runs ``model`` in ``eval()`` (BatchNorm on its running
    stats, Dropout off) with every parameter's ``requires_grad`` off, so
    only the input's gradient is computed and the kernels' dx-only
    Functions see weights that need no gradient; then it restores each
    module's ``training`` flag and each parameter's ``requires_grad``. So
    an adversarial trainer can attack the model it is training between
    optimiser steps, as the JAX package's pure ``make_logits_fn`` allows.
    """

    def logits_fn(x: torch.Tensor) -> torch.Tensor:
        modes = [(m, m.training) for m in model.modules()]
        grads = [(p, p.requires_grad) for p in model.parameters()]
        model.eval()
        model.requires_grad_(False)
        try:
            return model(x)
        finally:
            for m, training in modes:
                m.training = training
            for p, requires_grad in grads:
                p.requires_grad_(requires_grad)

    return logits_fn


def two_class_ce(logit: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean CE over the widened (-z, z) logits. logit: (B, 1), y: (B,)."""
    z = logit.squeeze(-1)
    sign = 2.0 * y.to(z.dtype) - 1.0
    return F.softplus(-2.0 * sign * z).mean()


def two_class_logits(logit: torch.Tensor) -> torch.Tensor:
    """Materialised (B, 2) logits."""
    z = logit.reshape(logit.shape[0], -1)[:, :1]
    return torch.cat([-z, z], dim=1)


def predicted_label(logit: torch.Tensor) -> torch.Tensor:
    """argmax over (-z, z) == (z > 0); ties go to class 0."""
    return (logit.squeeze(-1) > 0).long()


def to_minmax(batch_x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample min-max to [0, 1] (reference src/aa/utils.py:4-9)."""
    mn = batch_x.amin(dim=1, keepdim=True)
    mx = batch_x.amax(dim=1, keepdim=True)
    return (batch_x - mn) / (mx - mn), mn, mx


def revert_minmax(batch_x: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """Inverse transform (reference src/aa/utils.py:12-14)."""
    return batch_x * (mx - mn) + mn


def attack_in_wave_space(attack_fn: AttackFn) -> AttackFn:
    """Wrap an [0, 1]-space attack with the min-max round trip."""

    def wrapped(x_wave, y, generator=None):
        x01, mn, mx = to_minmax(x_wave)
        adv01 = attack_fn(x01, y, generator)
        return revert_minmax(adv01, mn, mx)

    return wrapped


def flat_norms(x: torch.Tensor, ord: str) -> torch.Tensor:
    """Per-sample norm over flattened non-batch dims."""
    flat = x.reshape(x.shape[0], -1)
    if ord == "linf":
        return flat.abs().amax(dim=1)
    if ord == "l2":
        return (flat * flat).sum(dim=1).sqrt()
    if ord == "l1":
        return flat.abs().sum(dim=1)
    raise ValueError(ord)
