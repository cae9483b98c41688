"""Auto-PGD (APGD) and targeted Auto-PGD (APGDT) (port of
``adaa_tpu/attacks/apgd.py``).

APGDT carries the reference's single-logit adaptation (reference
adversarial_attacks/torchattacks/attacks/apgdt.py:104,112,166,222); APGD
(apgd.py) is stock upstream, audio-adapted here as in the JAX package.

2-class closed forms:
* targeted DLR (apgdt.py:75-78), the target being the other class:
  loss = -(2y - 1) 2z / (|z| + 1e-12). It depends on z only through
  sign(z), so its gradient is zero but for round-off (an ulp of 2 / |z|
  or exactly 0) and APGD-T's sign steps follow that round-off, here as in
  the JAX package and in the reference's widened APGDT;
* untargeted CE: the widened CE. Untargeted DLR needs >= 3 classes
  (apgd.py:75-80 indexes sorted[-3]) and raises ``ValueError``.

The loop is the torch code's: momentum with a = 0.75 (1 at step 0),
per-sample best tracking, and the step size halved where the loss
oscillated, checked only at the steps that ``checkpoints`` lists (the
shrinking counter3 / k schedule of apgdt.py:185-210). The count of loss
increases starts against -inf, not against the initial loss. Each restart
starts from one draw of the caller's generator (uniform for Linf,
normal for L2), drawn when the restart begins.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from adaa_tpu_torch.attacks import core


def ce_indiv(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample widened CE (APGD's loss, maximised)."""
    return F.softplus(-2.0 * (2.0 * y.to(z.dtype) - 1.0) * z)


def dlr_targeted_indiv(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample 2-class targeted DLR (APGD-T's loss, maximised)."""
    sign = 2.0 * y.to(z.dtype) - 1.0
    return -(sign * 2.0 * z) / (z.abs() + 1e-12)


def checkpoints(steps: int) -> Dict[int, int]:
    """{step index: window k} of the oscillation checks."""
    steps_2 = max(int(0.22 * steps), 1)
    steps_min = max(int(0.06 * steps), 1)
    size_decr = max(int(0.03 * steps), 1)
    out, k, counter3 = {}, steps_2, 0
    for i in range(steps):
        counter3 += 1
        if counter3 == k:
            out[i] = k
            counter3 = 0
            k = max(k - size_decr, steps_min)
    return out


def _apgd_engine(logits_fn: core.LogitsFn, loss_indiv_fn, norm: str, eps: float, steps: int,
                 rho: float):
    """``run(x, y, start) -> (x_best, acc, loss_best, x_best_adv)``;
    ``start`` is the restart's draw (U[0, 1) for Linf, N(0, 1) for L2)."""
    check_at = checkpoints(steps)

    def loss_and_grad(x_adv, y):
        xg = x_adv.detach().requires_grad_(True)
        with torch.enable_grad():
            z = logits_fn(xg).squeeze(-1)
            li = loss_indiv_fn(z, y)
            (g,) = torch.autograd.grad(li.sum(), xg)
        return li.detach(), z.detach(), g

    def run(x, y, start):
        b = x.shape[0]
        shape1 = (b,) + (1,) * (x.dim() - 1)

        def project(v):
            if norm == "Linf":
                return torch.minimum(torch.maximum(v, x - eps), x + eps).clamp(0.0, 1.0)
            d = v - x
            dn = core.flat_norms(d, "l2").reshape(shape1)
            factor = torch.clamp(dn, max=eps) / (dn + 1e-12)
            return (x + d * factor).clamp(0.0, 1.0)

        if norm == "Linf":
            t = 2.0 * start - 1.0
            denom = t.reshape(b, -1).abs().amax(dim=1).reshape(shape1)
        else:  # L2
            t = start
            denom = core.flat_norms(t, "l2").reshape(shape1) + 1e-12
        x_adv = (x + eps * t / denom).clamp(0.0, 1.0)

        li, z, grad = loss_and_grad(x_adv, y)
        acc = (z > 0).long() == y
        x_adv_old = x_best = x_best_adv = x_adv
        grad_best = grad
        loss_best = loss_best_last_check = li
        reduced_last_check = torch.ones(b, dtype=torch.bool, device=x.device)
        step_size = torch.full(shape1, 2.0 * eps, dtype=x.dtype, device=x.device)
        prev_li = torch.full((b,), float("-inf"), dtype=x.dtype, device=x.device)
        incr = []  # incr[i]: the loss of step i above that of step i - 1 (-inf before step 0)

        for i in range(steps):
            a = 0.75 if i > 0 else 1.0
            grad2 = x_adv - x_adv_old
            x_adv_old = x_adv
            if norm == "Linf":
                x1 = project(x_adv + step_size * grad.sign())
                x1 = project(x_adv + (x1 - x_adv) * a + grad2 * (1 - a))
            else:
                gn = core.flat_norms(grad, "l2").reshape(shape1)
                x1 = project(x_adv + step_size * grad / (gn + 1e-12))
                x1 = project(x_adv + (x1 - x_adv) * a + grad2 * (1 - a))
            x_adv = x1

            li, z, grad = loss_and_grad(x_adv, y)
            pred_ok = (z > 0).long() == y
            acc = acc & pred_ok
            x_best_adv = torch.where((~pred_ok).reshape(shape1), x_adv, x_best_adv)
            improved = li > loss_best
            imp_b = improved.reshape(shape1)
            x_best = torch.where(imp_b, x_adv, x_best)
            grad_best = torch.where(imp_b, grad, grad_best)
            loss_best = torch.where(improved, li, loss_best)
            incr.append((li > prev_li).to(x.dtype))
            prev_li = li

            if i in check_at:  # check_oscillation (apgdt.py:64-69, k3 = rho)
                k = check_at[i]
                oscillated = torch.stack(incr[-k:]).sum(dim=0) <= k * rho
                no_improvement = ~reduced_last_check & (loss_best_last_check >= loss_best)
                oscillated = oscillated | no_improvement
                reduced_last_check = oscillated
                loss_best_last_check = loss_best
                osc_b = oscillated.reshape(shape1)
                step_size = torch.where(osc_b, step_size / 2.0, step_size)
                x_adv = torch.where(osc_b, x_best, x_adv)
                grad = torch.where(osc_b, grad_best, grad)

        return x_best, acc, loss_best, x_best_adv

    return run


def _restarts(logits_fn, engine, norm: str, n_restarts: int) -> core.DrawnAttack:
    def draw(x, generator):
        def start():
            if norm == "Linf":
                return torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
            return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

        return (start() for _ in range(n_restarts))

    def run(x, y, starts):
        x = x.detach()
        shape1 = (x.shape[0],) + (1,) * (x.dim() - 1)
        adv = x
        with torch.no_grad():
            acc = core.predicted_label(logits_fn(x)) == y
        for start in starts:
            _, acc_curr, _, adv_curr = engine(x, y, start)
            newly = acc & ~acc_curr
            adv = torch.where(newly.reshape(shape1), adv_curr, adv)
            acc = acc & acc_curr
        return adv

    return core.DrawnAttack(draw, run)


def apgd(
    logits_fn: core.LogitsFn,
    norm: str = "Linf",
    eps: float = 8 / 255,
    steps: int = 100,
    n_restarts: int = 1,
    seed: int = 0,
    loss: str = "ce",
    eot_iter: int = 1,
    rho: float = 0.75,
    verbose: bool = False,
) -> core.DrawnAttack:
    """Untargeted Auto-PGD (apgd.py:41-264), CE loss (maximised)."""
    del seed, eot_iter, verbose
    if loss == "dlr":
        raise ValueError("untargeted DLR needs >= 3 classes (apgd.py:75-80 indexes "
                         "sorted[-3]); audio detectors are 2-class")
    engine = _apgd_engine(logits_fn, ce_indiv, norm, eps, steps, rho)
    return _restarts(logits_fn, engine, norm, n_restarts)


def apgdt(
    logits_fn: core.LogitsFn,
    norm: str = "Linf",
    eps: float = 8 / 255,
    steps: int = 100,
    n_restarts: int = 1,
    seed: int = 0,
    eot_iter: int = 1,
    rho: float = 0.75,
    n_classes: int = 2,
    verbose: bool = False,
) -> core.DrawnAttack:
    """Targeted Auto-PGD (apgdt.py:41-260); the only target is the other
    class, and targeted DLR is -(2y - 1) 2z / (|z| + 1e-12)."""
    del seed, eot_iter, verbose
    if n_classes != 2:
        raise ValueError("audio detectors are 2-class (single logit)")
    engine = _apgd_engine(logits_fn, dlr_targeted_indiv, norm, eps, steps, rho)
    return _restarts(logits_fn, engine, norm, n_restarts)
