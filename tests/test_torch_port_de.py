"""adaa_tpu_torch's differential evolution vs adaa_tpu's (CPU).

The port's DE pieces take their random numbers as tensors; here they get
JAX's own draws (``tests/torch_port_draws.py``, the same splits of the
same key), and the sampler's distribution is held on its own.

Tolerances:
* ``de_generation_unit`` (CR = 1 and CR = 0.7, leading batch axes),
  ``de_select_best0`` (with an accept mask and tied energies) and
  ``swap_best_to_slot0`` (with ties): within 1e-6 of JAX's (measured: 0,
  bit-equal; the same f32 operations in the same order).
* a whole DE run on a 4-parameter quadratic with replayed draws: the
  final population and energies within 1e-6 (measured: 0).
* ``sample_two_excluding`` from a torch generator: r0 != r1, neither the
  candidate, every admissible ordered pair within 0.02 of uniform.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu.attacks import differential_evolution as jde
from adaa_tpu_torch.attacks import differential_evolution as tde
from tests.torch_port_draws import de_generation, de_run

torch.set_num_threads(2)


@pytest.mark.parametrize("recombination", [1.0, 0.7])
@pytest.mark.parametrize("shape", [(9, 3), (4, 11, 6)])
def test_generation_unit_matches_jax(shape, recombination):
    key = jax.random.PRNGKey(sum(shape))
    pop = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    mutation = (0.5, 1.0)
    want = np.asarray(jde.de_generation_unit(jnp.asarray(pop), key, mutation, recombination))
    got = tde.de_generation_unit(torch.from_numpy(pop),
                                 de_generation(key, shape, mutation, recombination)).numpy()
    assert ((want < 0) | (want > 1)).sum() == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_select_best0_and_swap_match_jax():
    rng = np.random.default_rng(2)
    shape = (5, 8, 3)
    pop, trial = (rng.uniform(0, 1, shape).astype(np.float32) for _ in range(2))
    # energies on a coarse grid: ties between members and between slots
    energy, trial_energy = (np.round(rng.uniform(0, 1, shape[:2]) * 4).astype(np.float32) / 4
                            for _ in range(2))
    accept = rng.uniform(0, 1, shape[:2]) < 0.7
    for mask in (None, accept):
        want = jde.de_select_best0(jnp.asarray(pop), jnp.asarray(energy), jnp.asarray(trial),
                                   jnp.asarray(trial_energy),
                                   None if mask is None else jnp.asarray(mask))
        got = tde.de_select_best0(torch.from_numpy(pop), torch.from_numpy(energy),
                                  torch.from_numpy(trial), torch.from_numpy(trial_energy),
                                  None if mask is None else torch.from_numpy(mask))
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    want = jde.swap_best_to_slot0(jnp.asarray(pop), jnp.asarray(energy))
    got = tde.swap_best_to_slot0(torch.from_numpy(pop), torch.from_numpy(energy))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    # the swap keeps every member: the population is a permutation of the old one
    np.testing.assert_array_equal(np.sort(got[1].numpy(), axis=1), np.sort(energy, axis=1))


def test_de_run_matches_jax_with_replayed_draws():
    lo, hi = np.array([-2.0] * 4, np.float32), np.array([3.0] * 4, np.float32)
    target = np.array([0.5, -1.0, 2.0, 0.0], np.float32)
    key = jax.random.PRNGKey(3)
    maxiter, popsize = 30, 5
    want = jde.differential_evolution(lambda p: ((p - jnp.asarray(target)) ** 2).sum(-1),
                                      (lo, hi), key, maxiter=maxiter, popsize=popsize)
    init, generations = de_run(key, (popsize * 4, 4), maxiter)
    tt = torch.from_numpy(target)
    got = tde.run_de(lambda p: ((p - tt) ** 2).sum(-1), (lo, hi), init, generations)
    np.testing.assert_allclose(got.population.numpy(), np.asarray(want.population), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.energies.numpy(), np.asarray(want.energies), rtol=0, atol=1e-6)
    assert float(got.fun) < 0.05 and got.nit == maxiter


def test_differential_evolution_draws_from_the_generator_and_stops():
    lo, hi = torch.zeros(2), torch.ones(2)

    def run(stop_fn=None):
        return tde.differential_evolution(lambda p: ((p - 0.25) ** 2).sum(-1), (lo, hi),
                                          torch.Generator().manual_seed(4), maxiter=20,
                                          stop_fn=stop_fn)

    a, b = run(), run()
    assert torch.equal(a.population, b.population) and a.population.shape == (30, 2)
    stopped = run(lambda e: bool(e < 1.0))
    assert stopped.nit == 1


def test_sample_two_excluding_distribution():
    gen = torch.Generator().manual_seed(0)
    n = 7
    r0, r1 = tde.sample_two_excluding(gen, n, (500, n))
    cand = torch.arange(n).expand(500, n)
    assert bool(((r0 >= 0) & (r0 < n) & (r1 >= 0) & (r1 < n)).all())
    assert bool((r0 != cand).all() and (r1 != cand).all() and (r0 != r1).all())
    n = 5
    r0, r1 = tde.sample_two_excluding(gen, n, (4000, n))
    pairs, counts = np.unique(np.stack([r0[:, 2].numpy(), r1[:, 2].numpy()], 1), axis=0,
                              return_counts=True)
    assert len(pairs) == (n - 1) * (n - 2)
    np.testing.assert_allclose(counts / counts.sum(), 1.0 / len(pairs), atol=0.02)
