"""First-order gradient attacks: FGSM, PGD (Linf), PGDL2.

Port of ``adaa_tpu/attacks/gradient.py``. Inputs live in [0, 1]
min-max space (see ``attacks.core``); the per-step structure (random
start, signed or L2-normalised step, eps-ball projection, [0, 1] clamp)
is the reference torchattacks loops'. Each step is one
``torch.autograd.grad`` with respect to the input only.
"""
from __future__ import annotations

import torch

from adaa_tpu_torch.attacks import core


def _make_cost_grad(logits_fn: core.LogitsFn, targeted: bool):
    """Gradient of the attack cost: CE(y) untargeted, -CE(1 - y) targeted
    (2-class: the only possible target is the other class)."""

    def grad_fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            z = logits_fn(x)
            cost = -core.two_class_ce(z, 1 - y) if targeted else core.two_class_ce(z, y)
            (g,) = torch.autograd.grad(cost, x)
        return g

    return grad_fn


def fgsm(logits_fn: core.LogitsFn, eps: float = 0.007,
         targeted: bool = False) -> core.AttackFn:
    """One-step Linf: adv = clip(x + eps * sign(grad CE), 0, 1)."""
    grad_fn = _make_cost_grad(logits_fn, targeted)

    def attack(x, y, generator=None):
        g = grad_fn(x, y)
        return (x.detach() + eps * g.sign()).clamp(0.0, 1.0)

    return attack


def pgd(
    logits_fn: core.LogitsFn,
    eps: float = 0.3,
    alpha: float = 2.0 / 255,
    steps: int = 40,
    random_start: bool = True,
    targeted: bool = False,
) -> core.AttackFn:
    """Iterative Linf PGD with random start (reference pgd.py:40-78)."""
    grad_fn = _make_cost_grad(logits_fn, targeted)

    def attack(x, y, generator=None):
        x = x.detach()
        adv = x
        if random_start:
            noise = torch.empty_like(x).uniform_(-eps, eps, generator=core.need_generator(generator))
            adv = (x + noise).clamp(0.0, 1.0)
        for _ in range(steps):
            g = grad_fn(adv, y)
            adv = adv + alpha * g.sign()
            delta = (adv - x).clamp(-eps, eps)
            adv = (x + delta).clamp(0.0, 1.0)
        return adv

    return attack


def pgdl2(
    logits_fn: core.LogitsFn,
    eps: float = 1.0,
    alpha: float = 0.2,
    steps: int = 40,
    random_start: bool = True,
    eps_for_division: float = 1e-10,
    targeted: bool = False,
) -> core.AttackFn:
    """Iterative L2 PGD (reference pgdl2.py:40-90): random start on a scaled
    sphere, per-sample L2-normalised gradient steps, eps-ball renorm."""
    grad_fn = _make_cost_grad(logits_fn, targeted)

    def attack(x, y, generator=None):
        x = x.detach()
        b = x.shape[0]
        per_sample = (b,) + (1,) * (x.dim() - 1)
        adv = x
        if random_start:
            gen = core.need_generator(generator)
            delta = torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)
            n = core.flat_norms(delta, "l2").reshape(per_sample)
            r = torch.rand(per_sample, generator=gen, device=x.device, dtype=x.dtype)
            adv = (x + delta * (r / n * eps)).clamp(0.0, 1.0)
        for _ in range(steps):
            g = grad_fn(adv, y)
            gn = core.flat_norms(g, "l2") + eps_for_division
            adv = adv + alpha * g / gn.reshape(per_sample)
            delta = adv - x
            factor = torch.clamp(eps / core.flat_norms(delta, "l2"), max=1.0)
            adv = (x + delta * factor.reshape(per_sample)).clamp(0.0, 1.0)
        return adv

    return attack
