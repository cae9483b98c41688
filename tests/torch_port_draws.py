"""The JAX package's random draws, replayed for the port's attack cores.

Each function makes the ``jax.random`` calls that the JAX attack makes, on
the same splits of the same key, and returns them as torch tensors in the
structure that the port's ``DrawnAttack.run`` takes. So a test holds the
port's deterministic core to the JAX function on the same numbers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from adaa_tpu.attacks.differential_evolution import sample_two_excluding
from adaa_tpu_torch.attacks.differential_evolution import GenerationDraws
from adaa_tpu_torch.attacks.square import window_lengths


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def de_generation(key, shape, mutation, recombination) -> GenerationDraws:
    """``de_generation_unit``'s draws: split(key, 5) -> kf, kr, kc, kp, ku."""
    kf, kr, kc, kp, ku = jax.random.split(key, 5)
    f = jax.random.uniform(kf, shape[:-2], minval=mutation[0], maxval=mutation[1])
    r0, r1 = sample_two_excluding(kr, shape[-2], shape[:-1])
    cross = fill = None
    if recombination < 1.0:
        cross = t(jax.random.uniform(kc, shape) < recombination)
        fill = t(jax.random.randint(kp, shape[:-1], 0, shape[-1])).long()
    reinit = jax.random.uniform(ku, shape)
    return GenerationDraws(t(f), t(r0).long(), t(r1).long(), cross, fill, t(reinit))


def de_run(key, shape, maxiter, mutation=(0.5, 1.0), recombination=1.0):
    """(initial population, generations) of a DE run on ``shape``."""
    k_init, k_loop = jax.random.split(key)
    init = t(jax.random.uniform(k_init, shape))
    return init, [de_generation(k, shape, mutation, recombination)
                  for k in jax.random.split(k_loop, maxiter)]


def _uniform(key, shape, lo, hi):
    return t(jax.random.uniform(key, shape, jnp.float32, lo, hi))


def _normal(key, shape):
    return t(jax.random.normal(key, shape, jnp.float32))


def _diversity(key, length, resize_rate):
    lo, hi = sorted((length, int(length * resize_rate)))
    k1, k2, k3 = jax.random.split(key, 3)
    rnd = jax.random.randint(k1, (), lo, max(hi, lo + 1))
    shift = jax.random.randint(k2, (), 0, jnp.maximum(length - rnd, 1))
    return t(rnd).long(), t(shift).long(), t(jax.random.uniform(k3))


def _apgd_starts(key, shape, n_restarts, norm="Linf"):
    draw = jax.random.uniform if norm == "Linf" else jax.random.normal
    return [t(draw(k, shape, jnp.float32)) for k in jax.random.split(key, n_restarts)]


def _square(key, shape, n_queries, p_init):
    b, length = shape
    key, k0 = jax.random.split(key)
    signs = t(jax.random.rademacher(k0, (b, length), jnp.float32))
    queries = []
    for s in window_lengths(length, n_queries, p_init):
        key, kp, ks = jax.random.split(key, 3)
        pos = t(jax.random.randint(kp, (b, 1), 0, length - s + 1)).long()
        sign = 2.0 * t(jax.random.bernoulli(ks, 0.5, (b, 1))).float() - 1.0
        queries.append((pos, sign))
    return signs, queries


def attack_draws(name: str, key, shape, params=None):
    """The draws of the JAX ``EXTRA_ATTACKS[name]`` built with ``params``
    (its defaults otherwise), on a (B, L) input, in the structure of the
    port's ``run``."""
    p = params or {}
    b, length = shape
    eps = p.get("eps", 8 / 255)
    if name in ("GN", "RFGSM", "TPGD"):
        return _normal(key, shape)
    if name == "FFGSM":
        return _uniform(key, shape, -eps, eps)
    if name in ("EOTPGD", "UPGD"):
        default = name == "EOTPGD"
        return _uniform(key, shape, -eps, eps) if p.get("random_start", default) else None
    if name in ("VMIFGSM", "VNIFGSM"):
        n, beta, steps = p.get("N", 20), p.get("beta", 3 / 2), p.get("steps", 5)
        return [[_uniform(k, shape, -eps * beta, eps * beta) for k in jax.random.split(ks, n)]
                for ks in jax.random.split(key, steps)]
    if name in ("DIFGSM", "TIFGSM"):
        key, k0 = jax.random.split(key)
        start = _uniform(k0, shape, -eps, eps) if p.get("random_start", False) else None
        rate = p.get("resize_rate", 0.9)
        steps = p.get("steps", 10)
        return start, [_diversity(jax.random.split(k)[0], length, rate)
                       for k in jax.random.split(key, steps)]
    if name == "Jitter":
        key, k0 = jax.random.split(key)
        start = _uniform(k0, shape, -eps, eps) if p.get("random_start", True) else None
        std = p.get("std", 0.1)
        return start, [_normal(k, (b, 2)) if std != 0 else None
                       for k in jax.random.split(key, p.get("steps", 10))]
    if name == "Pixle":
        lo = max(1, int(p.get("x_dimensions", (2, 10))[0]))
        hi = max(lo + 1, int(p.get("x_dimensions", (2, 10))[1]))
        out = []
        for _ in range(p.get("restarts", 20) * p.get("max_iterations", 100)):
            key, k1, k2, k3 = jax.random.split(key, 4)
            s = int(jax.random.randint(k1, (), lo, hi))
            out.append((torch.tensor(s), t(jax.random.randint(k2, (b, 1), 0, length - s + 1)).long(),
                        t(jax.random.randint(k3, (b, 1), 0, length - s + 1)).long()))
        return out
    if name == "Square":
        return _square(key, shape, p.get("n_queries", 5000), p.get("p_init", 0.8))
    if name == "OnePixel":
        n_params = 3 * p.get("pixels", 1)
        pop_n = max(5, max(1, p.get("popsize", 400) // n_params) * n_params)
        return de_run(key, (b, pop_n, n_params), p.get("steps", 75))
    if name in ("APGD", "APGDT"):
        return _apgd_starts(key, shape, p.get("n_restarts", 1), p.get("norm", "Linf"))
    if name == "AutoAttack":
        k_apgd, k_apgdt, _, k_square = jax.random.split(key, 4)
        return [_apgd_starts(k_apgd, shape, 1), _apgd_starts(k_apgdt, shape, 1), None,
                _square(k_square, shape, 5000, 0.8)]
    raise KeyError(f"{name} draws no random numbers")


def gradient_starts(name: str, key, shape, eps):
    """The random start of the JAX ``pgd`` (uniform in the eps ball) or
    ``pgdl2`` (a normal direction, then a uniform radius per row), in the
    order the port's ``global_draw`` asks for them."""
    if name == "PGD":
        return [_uniform(key, shape, -eps, eps)]
    k1, k2 = jax.random.split(key)
    return [_normal(k1, shape), _uniform(k2, (shape[0], 1), 0.0, 1.0)]


def replay_starts(monkeypatch, draws) -> None:
    """Make the port's gradient attacks draw ``draws``, in order."""
    from adaa_tpu_torch.attacks import gradient

    it = iter(draws)
    monkeypatch.setattr(gradient, "global_draw", lambda sample, shape: next(it).reshape(shape))
