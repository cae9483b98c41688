"""FAB — Fast Adaptive Boundary attack (minimal norm), 2-class audio case.

Port of ``adaa_tpu/attacks/fab.py`` (reference torchattacks
fab.py:19-559). With widened logits (-z, z) and label y the per-class
gradient loop collapses to

    df = 2 z (1 - 2y),      dg = 2 (dz/dx) (1 - 2y),

so a step is one forward + backward (z and dz/dx), the projection
update, one forward ``predict`` of the update, the best-norm bookkeeping
and the beta pull-back toward the original for adversarial rows. The
reference's row subsetting (only correctly classified rows are attacked;
the best norm so far starts at 1e10) is kept as masks over the full
batch, as in the JAX package.

``ADAA_FAB_MERGED=1`` (read when the attack is built, as the JAX package
reads it) selects the merged step: the bookkeeping moves to the top of
the step and takes ``is_adv`` from the logit the gradient pass just
produced (one forward + backward per step), with one final ``predict``
to resolve the last candidate. Restarts after the first start from a
random point drawn from the caller's ``torch.Generator``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from adaa_tpu_torch.attacks import core
from adaa_tpu_torch.attacks.fab_projections import (projection_l1, projection_l2_bisect_pair,
                                                    projection_linf_bisect_pair)

_DEFAULT_EPS = {"Linf": 0.3, "L2": 1.0, "L1": 5.0}
# Linf / L2 use the paired fan-search forms (both per-step projections
# share the hyperplane); L1's support selection is order based and keeps
# the sorted form
_PROJ_PAIR = {"Linf": projection_linf_bisect_pair, "L2": projection_l2_bisect_pair}
_NORM_ORD = {"Linf": "linf", "L2": "l2", "L1": "l1"}


def fab(
    logits_fn: core.LogitsFn,
    norm: str = "Linf",
    eps: Optional[float] = None,
    steps: int = 100,
    n_restarts: int = 1,
    alpha_max: float = 0.1,
    eta: float = 1.05,
    beta: float = 0.9,
    seed: int = 0,
    targeted: bool = False,
    n_classes: int = 2,
    verbose: bool = False,
) -> core.AttackFn:
    """Untargeted 2-class FAB; ``seed``, ``targeted`` and ``verbose`` are
    accepted for the registry's signature (the random starts draw from
    the caller's generator)."""
    del seed, targeted, verbose
    if n_classes != 2:
        raise ValueError("audio detectors are 2-class (single logit)")
    eps = _DEFAULT_EPS[norm] if eps is None else eps
    proj_pair = _PROJ_PAIR.get(norm)
    ord_name = _NORM_ORD[norm]
    merged = os.environ.get("ADAA_FAB_MERGED") == "1"

    def predict(x):
        with torch.no_grad():
            return (logits_fn(x).squeeze(-1) > 0).long()

    def rand_start(generator, im2, res2):
        b = im2.shape[0]
        shape1 = (b,) + (1,) * (im2.dim() - 1)
        radius = torch.clamp(res2, max=eps).reshape(shape1)
        if norm == "Linf":
            t = 2.0 * torch.rand(im2.shape, generator=generator, device=im2.device,
                                 dtype=im2.dtype) - 1.0
            denom = t.reshape(b, -1).abs().amax(dim=1).reshape(shape1)
        else:
            t = torch.randn(im2.shape, generator=generator, device=im2.device, dtype=im2.dtype)
            denom = core.flat_norms(t, "l2" if norm == "L2" else "l1").reshape(shape1)
        return (im2 + radius * t / denom * 0.5).clamp(0.0, 1.0)

    def single_run(x, y, generator, use_rand_start):
        b = x.shape[0]
        shape1 = (b,) + (1,) * (x.dim() - 1)
        y_sign = 1.0 - 2.0 * y.to(x.dtype)  # (B,)

        act = predict(x) == y  # attack only correctly classified rows
        im2 = x
        adv = x
        res2 = torch.full((b,), 1e10, dtype=x.dtype, device=x.device)
        x0 = x.reshape(b, -1)
        x1 = rand_start(generator, im2, res2) if use_rand_start else x

        def update(x1, z, g):
            """The projection update from the linearisation (z, g) at x1."""
            df = 2.0 * z * y_sign  # f_other - f_label
            w = (2.0 * g * y_sign.reshape(shape1)).reshape(b, -1)
            bb = -df + (w * x1.reshape(b, -1)).sum(dim=1)
            t2 = torch.stack([x1.reshape(b, -1), x0])  # (2, B, D)
            if proj_pair is not None:
                d3 = proj_pair(t2, w, torch.stack([bb, bb])).reshape(2 * b, -1)
            else:  # L1 keeps the sort-based stacked form
                d3 = projection_l1(t2.reshape(2 * b, -1), torch.cat([w, w]), torch.cat([bb, bb]))
            d1 = d3[:b].reshape(x1.shape)
            d2 = d3[b:].reshape(x1.shape)
            a0 = core.flat_norms(d3, ord_name).clamp_min(1e-8)  # (2B,)
            a1 = a0[:b].reshape(shape1)
            a2 = a0[b:].reshape(shape1)
            alpha = (a1 / (a1 + a2)).clamp(0.0, alpha_max)
            return ((x1 + eta * d1) * (1.0 - alpha) + (im2 + eta * d2) * alpha).clamp(0.0, 1.0)

        def bookkeep(x1, is_adv, adv, res2):
            t_norm = core.flat_norms(x1 - im2, ord_name)
            better = is_adv & (t_norm < res2) & act
            adv = torch.where(better.reshape(shape1), x1, adv)
            res2 = torch.where(better, t_norm, res2)
            return adv, res2

        def pull_back(x1, is_adv):
            return torch.where(is_adv.reshape(shape1), im2 + (x1 - im2) * beta, x1)

        for _ in range(steps):
            z, g = core.z_and_grad(logits_fn, x1)
            if merged:  # bookkeeping and pull-back before the update (module doc)
                is_adv = (z > 0).long() != y
                adv, res2 = bookkeep(x1, is_adv, adv, res2)
                x1 = update(pull_back(x1, is_adv), z, g)
            else:  # reference-exact: grad -> update -> predict -> pull-back
                x1 = update(x1, z, g)
                is_adv = predict(x1) != y
                adv, res2 = bookkeep(x1, is_adv, adv, res2)
                x1 = pull_back(x1, is_adv)
        if merged:  # the final candidate: the reference's last in-loop predict
            adv, res2 = bookkeep(x1, predict(x1) != y, adv, res2)
        success = (res2 < 1e10) & act
        return torch.where(success.reshape(shape1), adv, x)

    def attack(x, y, generator=None):
        x = x.detach()
        b = x.shape[0]
        shape1 = (b,) + (1,) * (x.dim() - 1)
        adv = x
        acc = predict(x) == y  # still-robust rows
        for counter in range(n_restarts):
            if counter > 0 and generator is None:
                raise ValueError("FAB's random restarts need the caller's torch.Generator")
            adv_curr = single_run(x, y, generator, use_rand_start=counter > 0)
            still_correct = predict(adv_curr) == y
            res = core.flat_norms(x - adv_curr, ord_name)
            acc_curr = still_correct | (res > eps)
            newly_fooled = acc & ~acc_curr
            adv = torch.where(newly_fooled.reshape(shape1), adv_curr, adv)
            acc = acc & acc_curr
        return adv

    return attack
