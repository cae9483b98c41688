"""OnePixel: L0 black-box attack by batched differential evolution (port of
``adaa_tpu/attacks/onepixel.py``).

The reference's adapted OnePixel (adversarial_attacks/torchattacks/
attacks/onepixel.py:45-144) runs its vendored DE per sample on the wave
seen as a (1, 1, L) image. Here one DE runs for the whole batch: the
population is one more batch axis, the fitness is the true-class
probability of every (sample, member) row, evaluated ``inf_batch`` rows
per forward (the reference's inf_batch, onepixel.py:37), and a sample
whose slot-0 best already fools the detector freezes its population (the
reference's success callback). The loop runs every generation.

A member is (pos_y, pos_x, value) per pixel in the box [0, 1] x [0, L] x
[0, 1]. Its position is ``pos_x`` cast to an integer, which truncates,
and the value is written through a compare mask: where ``u * L`` rounds
up to L, the position is L and nothing is written, as in the JAX package.
Each chunk's perturbed waves are built inside the chunk loop, so no
(B, P, L) tensor is ever formed.

DE semantics are the fork's (``attacks/differential_evolution.py``), with
CR = 1 (onepixel.py:88 ``recombination=1``) and scipy's population size
``max(5, popmul * n_params)``, ``popmul = max(1, popsize // n_params)``
(onepixel.py:62). ``draw`` takes the initial population and, generation
by generation, its numbers from the caller's generator.
"""
from __future__ import annotations

import torch

from adaa_tpu_torch.attacks import core
from adaa_tpu_torch.attacks.differential_evolution import (de_generation_unit, de_select_best0,
                                                           draw_de, swap_best_to_slot0)


def onepixel(
    logits_fn: core.LogitsFn,
    pixels: int = 1,
    steps: int = 75,
    popsize: int = 400,
    inf_batch: int = 128,
) -> core.DrawnAttack:
    n_params = 3 * pixels
    popmul = max(1, popsize // n_params)
    pop_n = max(5, popmul * n_params)  # scipy popsize semantics

    def perturb(x, delta):
        """x: (R, L), delta: (R, n_params) real coordinates -> (R, L)."""
        idx = torch.arange(x.shape[1], device=x.device)
        out = x
        for p in range(pixels):
            pos = delta[:, 3 * p + 1].to(torch.int32)  # truncates, as astype(int32)
            out = torch.where(idx == pos[:, None], delta[:, 3 * p + 2, None], out)
        return out

    def true_prob(x, y):
        """P(the detector predicts the true class): softmax over (-z, z)."""
        z = logits_fn(x).squeeze(-1)
        sign = 2.0 * y.to(z.dtype) - 1.0
        return torch.sigmoid(2.0 * sign * z)

    def fitness(x, y, pop):
        """x: (B, L), pop: (B, P, n_params) real -> (B, P) true-class probability,
        ``inf_batch`` rows per forward."""
        b = x.shape[0]
        flat = pop.reshape(b * pop_n, n_params)
        out = []
        for start in range(0, b * pop_n, inf_batch):
            rows = torch.arange(start, min(start + inf_batch, b * pop_n), device=x.device)
            sample = rows // pop_n
            out.append(true_prob(perturb(x[sample], flat[rows]), y[sample]))
        return torch.cat(out).reshape(b, pop_n)

    def draw(x, generator):
        return draw_de(generator, (x.shape[0], pop_n, n_params), steps, (0.5, 1.0), 1.0, x.device)

    def run(x, y, draws):
        init, generations = draws
        x = x.detach()
        # the reference's bounds [(0, H), (0, W), (0, 1)] on the (B, 1, 1, L) wave
        hi = torch.tensor([1.0, float(x.shape[1]), 1.0] * pixels, device=x.device)
        with torch.no_grad():
            pop, energy = swap_best_to_slot0(init, fitness(x, y, init * hi))
            done = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
            for gen in generations:
                trial = de_generation_unit(pop, gen)
                pop, energy = de_select_best0(pop, energy, trial, fitness(x, y, trial * hi),
                                              accept_mask=~done[:, None])
                done = done | (energy[:, 0] < 0.5)  # the success callback
            return perturb(x, pop[:, 0] * hi)

    return core.DrawnAttack(draw, run)
