"""Batched differential evolution on the device, with the reference fork's
semantics (port of ``adaa_tpu/attacks/differential_evolution.py``).

The reference vendors a scipy DE whose one change is passing the whole
population to the objective (reference
adversarial_attacks/torchattacks/attacks/_differential_evolution.py:1-10).
Its batched loop (``__next__``, :681-756) is kept:

* ``best1bin``: mutants are built from the slot-0 best member (``_best1``,
  :828-834), with one dither F ~ U[m0, m1) per generation and DE run;
* r0 and r1 are drawn without replacement, excluding the candidate
  (``_select_samples``, :887-897);
* the population lives in unit-cube coordinates, scaled to the real box
  only for the fitness (``_scale_parameters``, :771-775);
* out-of-bounds trial coordinates are re-drawn uniformly, not clipped
  (``_ensure_constraint``, :783-788);
* a generation's trials all come from the population of before it, are
  evaluated in one batch, then selected; slot 0 ends the generation
  holding the best member so far (:711-722);
* the initial population is evaluated and its best member SWAPPED into
  slot 0 (``_calculate_population_energies``, :638-674).

``argmin`` ties go to the first index, as in ``jnp.argmin``: energies
that saturate at the same value are common on a confident detector.

Each generation is split into its draws (``draw_generation``, from the
caller's ``torch.Generator``) and a deterministic step
(``de_generation_unit``) that takes them as tensors.
"""
from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional, Sequence, Tuple

import torch


class DEResult(NamedTuple):
    x: torch.Tensor  # best member (slot 0), real coordinates
    fun: torch.Tensor  # best energy
    population: torch.Tensor  # real coordinates
    energies: torch.Tensor
    nit: int


class GenerationDraws(NamedTuple):
    """One generation's random numbers for a (..., P, n) population."""
    f: torch.Tensor  # (...,) dither, one per DE run
    r0: torch.Tensor  # (..., P) first difference member
    r1: torch.Tensor  # (..., P) second difference member
    cross: Optional[torch.Tensor]  # (..., P, n) bool crossover mask (CR < 1)
    fill: Optional[torch.Tensor]  # (..., P) coordinate always taken from the mutant (CR < 1)
    reinit: torch.Tensor  # (..., P, n) U[0, 1) re-draws for out-of-bounds coordinates


def sample_two_excluding(generator: torch.Generator, n: int, shape: Sequence[int],
                         device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ordered pair (r0, r1) drawn uniformly WITHOUT replacement from
    ``range(n)`` excluding the candidate index, which is the position along
    the last axis of ``shape`` (the reference's shuffle-and-take)."""
    shape = tuple(shape)
    cand = torch.arange(shape[-1], device=device).expand(shape)
    a = torch.randint(0, n - 1, shape, generator=generator, device=device)
    r0 = a + (a >= cand).long()  # uniform over the n - 1 indices != candidate
    b = torch.randint(0, n - 2, shape, generator=generator, device=device)
    e1 = torch.minimum(cand, r0)
    e2 = torch.maximum(cand, r0)
    r1 = b + (b >= e1).long()  # uniform over the n - 2 indices != {candidate, r0}
    r1 = r1 + (r1 >= e2).long()
    return r0, r1


def draw_generation(shape: Sequence[int], generator: torch.Generator,
                    mutation: Tuple[float, float], recombination: float,
                    device=None) -> GenerationDraws:
    """Every random number one generation of a ``shape`` population needs."""
    shape = tuple(shape)
    lead, p, n_params = shape[:-2], shape[-2], shape[-1]
    f = torch.empty(lead, device=device).uniform_(mutation[0], mutation[1], generator=generator)
    r0, r1 = sample_two_excluding(generator, p, shape[:-1], device)
    cross = fill = None
    if recombination < 1.0:
        cross = torch.rand(shape, generator=generator, device=device) < recombination
        fill = torch.randint(0, n_params, shape[:-1], generator=generator, device=device)
    reinit = torch.rand(shape, generator=generator, device=device)
    return GenerationDraws(f, r0, r1, cross, fill, reinit)


def de_generation_unit(pop: torch.Tensor, draws: GenerationDraws) -> torch.Tensor:
    """One generation's trial population in unit coordinates.

    pop: (..., P, n_params) with slot 0 the best. Mutation off slot 0,
    binomial crossover where ``draws`` has a crossover mask (CR < 1), and
    out-of-bounds coordinates re-drawn from ``draws.reinit``.
    """
    n_params = pop.shape[-1]

    def member(r):
        return torch.gather(pop, -2, r[..., None].expand(*r.shape, n_params))

    mutant = pop[..., :1, :] + draws.f[..., None, None] * (member(draws.r0) - member(draws.r1))
    if draws.cross is not None:
        forced = draws.fill[..., None] == torch.arange(n_params, device=pop.device)
        trial = torch.where(draws.cross | forced, mutant, pop)
    else:
        trial = mutant
    oob = (trial < 0.0) | (trial > 1.0)
    return torch.where(oob, draws.reinit, trial)


def _best(pop: torch.Tensor, energy: torch.Tensor):
    bi = torch.argmin(energy, dim=-1, keepdim=True)  # ties: the first index
    best_e = torch.gather(energy, -1, bi)
    best_x = torch.gather(pop, -2, bi[..., None].expand(*bi.shape, pop.shape[-1]))
    return bi, best_e, best_x


def de_select_best0(pop, energy, trial, trial_energy, accept_mask=None):
    """Greedy selection and the slot-0 best bookkeeping (fork :711-722).

    Each candidate keeps the better of (member, trial); slot 0 then takes
    the generation's overall best member. Shapes: (..., P, n) / (..., P).
    """
    improved = trial_energy < energy
    if accept_mask is not None:
        improved = improved & accept_mask
    pop = torch.where(improved[..., None], trial, pop)
    energy = torch.where(improved, trial_energy, energy)
    _, best_e, best_x = _best(pop, energy)
    return (torch.cat([best_x, pop[..., 1:, :]], dim=-2),
            torch.cat([best_e, energy[..., 1:]], dim=-1))


def swap_best_to_slot0(pop, energy):
    """Initial-energies bookkeeping: SWAP the best member into slot 0
    (fork :668-674; both members survive)."""
    bi, best_e, best_x = _best(pop, energy)
    at_best = bi == torch.arange(energy.shape[-1], device=energy.device)  # (..., P)
    energy = torch.where(at_best, energy[..., :1], energy)
    pop = torch.where(at_best[..., None], pop[..., :1, :], pop)
    return (torch.cat([best_x, pop[..., 1:, :]], dim=-2),
            torch.cat([best_e, energy[..., 1:]], dim=-1))


def draw_de(generator: torch.Generator, shape: Sequence[int], maxiter: int,
            mutation: Tuple[float, float], recombination: float, device=None):
    """The draws of a DE run over a ``shape`` population: the initial
    unit-cube population, then an iterator that draws each generation's
    numbers when the run reaches it."""
    init = torch.rand(tuple(shape), generator=generator, device=device)
    return init, (draw_generation(shape, generator, mutation, recombination, device)
                  for _ in range(maxiter))


def run_de(func: Callable[[torch.Tensor], torch.Tensor], bounds, init: torch.Tensor,
           generations: Iterable[GenerationDraws],
           stop_fn: Optional[Callable[[torch.Tensor], bool]] = None) -> DEResult:
    """The deterministic DE of ``differential_evolution`` on given draws."""
    lo, hi = (torch.as_tensor(b, dtype=torch.float32, device=init.device) for b in bounds)

    def scale(u):
        return lo + u * (hi - lo)

    pop, energy = swap_best_to_slot0(init, func(scale(init)))
    nit = 0
    for draws in generations:
        nit += 1
        trial = de_generation_unit(pop, draws)
        pop, energy = de_select_best0(pop, energy, trial, func(scale(trial)))
        if stop_fn is not None and stop_fn(energy[0]):
            break  # the remaining generations would leave the population as it is
    return DEResult(x=scale(pop[0]), fun=energy[0], population=scale(pop), energies=energy,
                    nit=nit)


def differential_evolution(
    func: Callable[[torch.Tensor], torch.Tensor],
    bounds: Tuple[torch.Tensor, torch.Tensor],
    generator: torch.Generator,
    maxiter: int = 75,
    popsize: int = 15,
    mutation: Tuple[float, float] = (0.5, 1.0),
    recombination: float = 1.0,
    stop_fn: Optional[Callable[[torch.Tensor], bool]] = None,
) -> DEResult:
    """Minimise ``func`` over a box (one DE run, best1bin).

    ``func`` maps a population (P, n_params) in real coordinates to
    energies (P,); ``bounds`` are (lo, hi) of shape (n_params,);
    ``popsize`` is scipy's multiplier (P = ``max(5, popsize * n_params)``);
    ``stop_fn(best_energy) -> bool`` ends the run once true (the JAX
    package freezes the population instead, which gives the same result).
    Initialisation is uniform, the fork's ``init='random'``, which OnePixel
    uses; its default Latin hypercube is not implemented.
    """
    n_params = torch.as_tensor(bounds[0]).shape[0]
    pop_n = max(5, max(1, popsize) * n_params)
    device = torch.as_tensor(bounds[0]).device
    init, generations = draw_de(generator, (pop_n, n_params), maxiter, mutation,
                                recombination, device)
    return run_de(func, bounds, init, generations, stop_fn)
