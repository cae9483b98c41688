"""Composite attacks: MultiAttack and AutoAttack (port of
``adaa_tpu/attacks/composite.py``).

MultiAttack runs a list of attacks in order and keeps each sample's first
successful adversarial example (the vendored multiattack.py). AutoAttack's
'standard' suite is APGD-CE, APGD-T (DLR), FAB and Square with the
upstream budgets; with two classes targeted FAB is untargeted FAB (there
is one wrong class), as in the JAX package.

Where the JAX package splits its key into one part per member, the
members here draw from the caller's generator in turn: a member's draws
are taken when it starts, after the members before it have run. A member
that is not a ``core.DrawnAttack`` (FAB) is handed the generator itself.
"""
from __future__ import annotations

from typing import List

import torch

from adaa_tpu_torch.attacks import core


def multiattack(logits_fn: core.LogitsFn, attacks: List[core.AttackFn]) -> core.DrawnAttack:
    """Sequential attacks; each sample keeps its first success."""

    def draw(x, generator):
        return (atk.draw(x, generator) if isinstance(atk, core.DrawnAttack) else generator
                for atk in attacks)

    def run(x, y, draws):
        x = x.detach()
        shape1 = (x.shape[0],) + (1,) * (x.dim() - 1)
        adv = x
        with torch.no_grad():
            robust = core.predicted_label(logits_fn(x)) == y  # still correct
        for atk, d in zip(attacks, draws):
            candidate = atk.run(x, y, d) if isinstance(atk, core.DrawnAttack) else atk(x, y, d)
            with torch.no_grad():
                fooled = core.predicted_label(logits_fn(candidate)) != y
            adv = torch.where((robust & fooled).reshape(shape1), candidate, adv)
            robust = robust & ~fooled
        return adv

    return core.DrawnAttack(draw, run)


def autoattack(
    logits_fn: core.LogitsFn,
    norm: str = "Linf",
    eps: float = 8 / 255,
    version: str = "standard",
    n_classes: int = 2,
    seed: int = 0,
) -> core.DrawnAttack:
    del seed, version
    from adaa_tpu_torch.attacks.apgd import apgd, apgdt
    from adaa_tpu_torch.attacks.fab import fab
    from adaa_tpu_torch.attacks.square import square

    suite = [
        apgd(logits_fn, norm=norm, eps=eps, steps=100, n_restarts=1, loss="ce"),
        apgdt(logits_fn, norm=norm, eps=eps, steps=100, n_restarts=1, n_classes=n_classes),
        fab(logits_fn, norm=norm, eps=eps, steps=100, n_restarts=1, n_classes=n_classes),
        square(logits_fn, norm="Linf", eps=eps, n_queries=5000),
    ]
    return multiattack(logits_fn, suite)
