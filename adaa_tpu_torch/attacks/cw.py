"""Carlini & Wagner L2 attack in tanh space with Adam (port of
``adaa_tpu/attacks/cw.py``; reference adversarial_attacks/torchattacks/
attacks/cw.py:46-134).

w starts at atanh(2x - 1) and Adam (betas 0.9 / 0.999, eps 1e-8, bias
correction, written out as the JAX package does) minimises the summed
per-sample L2 plus ``c`` times the summed f-margin. Each step tracks the
best (misclassified AND lower-L2) adversarial per sample from the logits
of before the update, and at steps that are multiples of ``steps // 10``
(step 0 included) the whole batch stops when the cost rose since the last
such step; that step still updates w and the best (cw.py:93-110). The
cost is read on the host only at those steps.

``atanh`` is 0.5 log((1 + u) / (1 - u)). At the box's endpoints, which
every wave out of ``to_minmax`` has, w is +-inf, tanh gives exactly 0 or
1, the gradient and so the Adam step are 0, and the output stays finite,
as in the JAX package.

Reference quirk kept: the "other class" logit is ``max((1 - onehot) *
logits)``, so the zeroed true-class slot takes part in the max
(cw.py:124-134).
"""
from __future__ import annotations

import torch

from adaa_tpu_torch.attacks import core


def cw(
    logits_fn: core.LogitsFn,
    c: float = 1e-4,
    kappa: float = 0.0,
    steps: int = 1000,
    lr: float = 0.01,
) -> core.AttackFn:
    checkpoint_every = max(steps // 10, 1)
    b1, b2, adam_eps = 0.9, 0.999, 1e-8

    def tanh_space(w):
        return 0.5 * (torch.tanh(w) + 1.0)

    def atanh(u):
        return 0.5 * torch.log((1.0 + u) / (1.0 - u))

    def f_margin(logits2, y):
        oh = torch.nn.functional.one_hot(y, 2).to(logits2.dtype)
        i = ((1.0 - oh) * logits2).amax(dim=1)
        j = (oh * logits2).sum(dim=1)
        return torch.clamp(j - i, min=-kappa)

    def attack(x, y, generator=None):
        x = x.detach()
        b = x.shape[0]
        shape1 = (b,) + (1,) * (x.dim() - 1)
        w = atanh(x * 2.0 - 1.0)
        m = torch.zeros_like(x)
        v = torch.zeros_like(x)
        best_adv = x
        best_l2 = torch.full((b,), 1e10, dtype=x.dtype, device=x.device)
        prev_cost = 1e10
        b1_t = torch.tensor(b1, dtype=x.dtype, device=x.device)
        b2_t = torch.tensor(b2, dtype=x.dtype, device=x.device)
        for step in range(steps):
            wg = w.requires_grad_(True)
            with torch.enable_grad():
                adv = tanh_space(wg)
                flat = (adv - x).reshape(b, -1)
                cur_l2 = (flat * flat).sum(dim=1)  # MSE(sum) per sample
                logits2 = core.two_class_logits(logits_fn(adv))
                cost = cur_l2.sum() + c * f_margin(logits2, y).sum()
                (g,) = torch.autograd.grad(cost, wg)
            adv, cur_l2, logits2, cost = adv.detach(), cur_l2.detach(), logits2.detach(), cost.detach()

            t = step + 1
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * (g * g)
            mhat = m / (1 - b1_t ** t)
            vhat = v / (1 - b2_t ** t)
            w = w.detach() - lr * mhat / (torch.sqrt(vhat) + adam_eps)

            # the best adversarial so far, from the logits of before the update
            correct = (logits2.argmax(dim=1) == y).to(x.dtype)
            mask = (1.0 - correct) * (best_l2 > cur_l2).to(x.dtype)
            best_l2 = mask * cur_l2 + (1.0 - mask) * best_l2
            mask_b = mask.reshape(shape1)
            best_adv = mask_b * adv + (1.0 - mask_b) * best_adv

            if step % checkpoint_every == 0:  # early stop on a cost that rose
                cost_now = float(cost)
                if cost_now > prev_cost:
                    break
                prev_cost = cost_now
        return best_adv

    return attack
