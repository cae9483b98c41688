"""Square attack: black-box random search (Linf), 1-D audio variant (port
of ``adaa_tpu/attacks/square.py``).

The reference vendors stock upstream Square (adversarial_attacks/
torchattacks/attacks/square.py); as in the JAX package it is adapted to
the detectors with the widened 2-class margin f_y - f_other = (2y - 1) 2z.
The image's square patches are contiguous segments of the wave: the
start is x plus +-eps per position, and each query re-randomises a
window of length s (from the p-schedule, square.py:158-185, fixed on the
host per query) to x +- eps, accepted where the loss fell and the row is
not yet fooled (square.py:187-280, Linf branch). Forwards only. Rows that
were misclassified at first come back unchanged.

``draw`` takes the start's signs, then each query's window position and
sign when the loop reaches it, from the caller's generator.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from adaa_tpu_torch.attacks import core


def _p_schedule(it: int, n_queries: int, p_init: float) -> float:
    it = int(it / n_queries * 10000)
    for bound, div in ((10, 1), (50, 2), (200, 4), (500, 8), (1000, 16),
                       (2000, 32), (4000, 64), (6000, 128), (8000, 256)):
        if it <= bound:
            return p_init / div
    return p_init / 512


def window_lengths(length: int, n_queries: int, p_init: float) -> list:
    """Each query's window length s."""
    out = []
    for it in range(n_queries):
        s = int(round(math.sqrt(_p_schedule(it, n_queries, p_init) * length)))
        out.append(min(max(s, 1), length - 1))
    return out


def square(
    logits_fn: core.LogitsFn,
    norm: str = "Linf",
    eps: float = 8 / 255,
    n_queries: int = 5000,
    p_init: float = 0.8,
    loss: str = "margin",
    seed: int = 0,
) -> core.DrawnAttack:
    if norm != "Linf":
        raise ValueError("audio Square implements the Linf branch")
    if loss not in ("ce", "margin"):
        raise ValueError(f"loss '{loss}'")
    del seed  # the caller's generator draws

    def margin_and_loss(x, y):
        z = logits_fn(x).squeeze(-1)
        margin = (2.0 * y.to(z.dtype) - 1.0) * 2.0 * z  # f_y - f_other
        if loss == "ce":
            return margin, -F.softplus(-margin)  # -CE, to minimise
        return margin, margin

    def draw(x, generator):
        b, length = x.shape

        def bits(shape):
            return 2.0 * torch.randint(0, 2, shape, generator=generator, device=x.device,
                                       dtype=x.dtype) - 1.0

        signs = bits((b, length))
        queries = ((torch.randint(0, length - s + 1, (b, 1), generator=generator,
                                  device=x.device), bits((b, 1)))
                   for s in window_lengths(length, n_queries, p_init))
        return signs, queries

    def run(x, y, draws):
        signs, queries = draws
        x = x.detach()
        idx = torch.arange(x.shape[1], device=x.device)[None, :]
        lo, hi = x - eps, x + eps
        with torch.no_grad():
            x_best = (x + eps * signs).clamp(0.0, 1.0)
            margin, loss_best = margin_and_loss(x_best, y)
            for s, (pos, new_sign) in zip(window_lengths(x.shape[1], n_queries, p_init), queries):
                in_window = (idx >= pos) & (idx < pos + s)
                candidate = torch.where(in_window, x + eps * new_sign, x_best)
                candidate = torch.minimum(torch.maximum(candidate, lo), hi).clamp(0.0, 1.0)
                m_new, l_new = margin_and_loss(candidate, y)
                accept = (l_new < loss_best) & (margin > 0)
                x_best = torch.where(accept[:, None], candidate, x_best)
                loss_best = torch.where(accept, l_new, loss_best)
                margin = torch.where(accept, m_new, margin)
            # the outer perturb loop only touches the rows classified correctly at first
            originally_correct = core.predicted_label(logits_fn(x)) == y
        return torch.where(originally_correct[:, None], x_best, x)

    return core.DrawnAttack(draw, run)
