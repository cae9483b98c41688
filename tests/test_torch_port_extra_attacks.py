"""adaa_tpu_torch's 25 extra attacks vs adaa_tpu's on a linear detector (CPU).

The logits are z = x . w + c with w non-zero; the inputs come from
``to_minmax``, so every row holds the box's endpoints 0 and 1. An attack
that draws random numbers gets JAX's own draws through its deterministic
core (``tests/torch_port_draws.py``).

Tolerances:
* every attack but Jitter and APGDT, with its registry defaults (CW 1,000 steps,
  OnePixel 75 generations of 399, Square 5,000 queries, AutoAttack's full
  suite, Pixle 2,000 queries): output within 1e-5 absolute of JAX's
  (measured: SparseFool 1.1e-6, OnePixel 5.7e-7, CW and DeepFool 6e-8, the
  other 19 bit-equal).
* Jitter and APGDT: in their eps ball and the box, and their loss's
  gradient zero but for round-off. The 2-class widening makes both losses
  depend on z only through sign(z) (Jitter's softmax of scale (-z, z) /
  |z|, APGD-T's -(2y - 1) 2z / |z|), so their sign steps follow round-off
  in either package: Jitter's cost gradient is below 1e-6 off the one
  coordinate of its 1/max|delta| quotient, APGD-T's dloss/dz below 1e-6
  of 2 / |z| (JAX's own is 0 or an ulp there).
* APGD's L2 branch (eps 0.5, 12 steps, two restarts): within 1e-5 of
  JAX's; APGD-T's in its L2 ball.
* the resize against ``jax.image.scale_and_translate(method="linear")`` at
  L = 4,096 for several (length, shift) pairs: within 1e-6 (measured 1.2e-7).
* the draws' distributions from a torch generator: the resize's length in
  [0.9 L, L), its shift in [0, L - length), Pixle's segments inside the
  wave, Square's windows inside the wave and its signs +-1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu import attacks as jattacks
from adaa_tpu_torch import attacks as tattacks
from adaa_tpu_torch.attacks import core as tcore
from adaa_tpu_torch.attacks import extra as textra
from adaa_tpu_torch.attacks.apgd import dlr_targeted_indiv
from tests.torch_port_draws import attack_draws

torch.set_num_threads(2)

B, L = 4, 256
ROUND_OFF = {"Jitter", "APGDT"}  # sign steps of a zero gradient (module doc)
DETERMINISTIC = {"CW", "VANILA", "BIM", "MIFGSM", "NIFGSM", "SINIFGSM", "DeepFool", "SparseFool"}


def _linear_problem(seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(L) / np.sqrt(L)).astype(np.float32)
    w[np.abs(w) < 1e-3] = 1e-3  # non-zero
    x, _, _ = tattacks.to_minmax(torch.from_numpy(rng.standard_normal((B, L)).astype(np.float32)))
    x = x.numpy()
    c = np.float32(-(x @ w).mean())
    y = ((x @ w + c) > 0).astype(np.int64)
    y[0] = 1 - y[0]  # one row misclassified at first
    return w, c, x, y


@pytest.mark.parametrize("name", sorted(jattacks.EXTRA_ATTACKS))
def test_extra_attack_on_a_linear_model_matches_jax(name):
    w, c, x, y = _linear_problem()
    assert (x.min(axis=1) == 0).all() and (x.max(axis=1) == 1).all()
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    key = jax.random.PRNGKey(len(name))
    adv_j = np.asarray(jattacks.build_attack(name, lambda a: (a @ wj + c)[:, None])(
        jnp.asarray(x), jnp.asarray(y), key))
    tfn = lambda a: (a @ wt + c)[:, None]  # noqa: E731
    tatk = tattacks.build_attack(name, tfn)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    if name in DETERMINISTIC:
        assert not isinstance(tatk, tcore.DrawnAttack)
        adv_t = tatk(xt, yt, None).numpy()
    else:
        assert isinstance(tatk, tcore.DrawnAttack)
        adv_t = tatk.run(xt, yt, attack_draws(name, key, (B, L))).numpy()
    assert adv_t.shape == x.shape and np.isfinite(adv_t).all()
    assert adv_t.min() >= 0.0 and adv_t.max() <= 1.0
    if name != "VANILA":
        assert not np.array_equal(adv_j, x)
    if name not in ROUND_OFF:
        np.testing.assert_allclose(adv_t, adv_j, rtol=0, atol=1e-5)
        return
    eps = 8 / 255
    assert np.abs(adv_t - x).max() <= eps + 1e-6
    if name == "APGDT":
        z = torch.linspace(-3, 3, 40).requires_grad_(True)  # z = 0 is the loss's jump
        (g,) = torch.autograd.grad(dlr_targeted_indiv(z, torch.arange(40) % 2).sum(), z)
        assert float((g.abs() * z.detach().abs() / 2).max()) < 1e-6
        return
    # the cost's gradient at a generic perturbed point (one largest |delta| per
    # row): zero off the quotient coordinate of the rows already wrong
    a = torch.from_numpy(np.clip(x + 1e-3 * np.linspace(-0.5, 1, L, dtype=np.float32), 0, 1))
    a.requires_grad_(True)
    noise = torch.from_numpy(np.random.default_rng(1).standard_normal((B, 2)).astype(np.float32))
    (g,) = torch.autograd.grad(textra.jitter_cost(tfn, xt, yt, a, noise, 10.0, 0.1), a)
    assert float(g.abs().sort(dim=1, descending=True).values[:, 1:].max()) < 1e-6


@pytest.mark.parametrize("name", ["APGD", "APGDT"])
def test_apgd_l2_branch_on_a_linear_model_matches_jax(name):
    """The L2 branch (normal start, the step's and the momentum's two
    projections) with two restarts; APGD within 1e-5 of JAX's, APGD-T (a
    round-off gradient, module doc) in its L2 ball."""
    w, c, x, y = _linear_problem(1)
    params = {"norm": "L2", "eps": 0.5, "steps": 12, "n_restarts": 2}
    key = jax.random.PRNGKey(11)
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    adv_j = np.asarray(jattacks.build_attack(name, lambda a: (a @ wj + c)[:, None], params)(
        jnp.asarray(x), jnp.asarray(y), key))
    adv_t = tattacks.build_attack(name, lambda a: (a @ wt + c)[:, None], params).run(
        torch.from_numpy(x), torch.from_numpy(y), attack_draws(name, key, (B, L), params)).numpy()
    assert np.sqrt(((adv_t - x) ** 2).sum(axis=1)).max() <= 0.5 + 1e-5
    if name == "APGD":
        assert not np.array_equal(adv_j, x)
        np.testing.assert_allclose(adv_t, adv_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("scale_len,shift", [(4096, 0), (3687, 0), (3700, 396), (3900, 17),
                                             (4000, 95)])
def test_resize_matches_jax_scale_and_translate(scale_len, shift):
    n = 4096
    x = np.random.default_rng(scale_len).uniform(0, 1, (2, n)).astype(np.float32)
    scale = jnp.float32(scale_len) / n
    want = np.asarray(jax.image.scale_and_translate(
        jnp.asarray(x), x.shape, (1,), scale[None], jnp.float32(shift)[None], method="linear"))
    got = textra.resize_linear(torch.from_numpy(x), torch.tensor(scale_len).float() / n,
                               torch.tensor(float(shift)), textra.resize_taps(0.9, n)).numpy()
    if shift:
        assert (want[:, :shift] == 0).all()  # outside the input: zeroed
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_draws_come_from_the_generator_within_their_ranges():
    x = torch.rand(3, 1000, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for _ in range(200):
        rnd, shift, u = textra._draw_diversity(x, gen, 0.9)
        assert 900 <= int(rnd) < 1000 and 0 <= int(shift) < max(1000 - int(rnd), 1)
        assert 0.0 <= float(u) < 1.0
    pixle = tattacks.build_attack("Pixle", None, {"restarts": 2, "max_iterations": 50})
    for s, src, dst in pixle.draw(x, gen):
        assert 2 <= int(s) < 10
        assert int(src.min()) >= 0 and int(dst.min()) >= 0
        assert int(src.max()) + int(s) <= 1000 and int(dst.max()) + int(s) <= 1000
    square = tattacks.build_attack("Square", None, {"n_queries": 100})
    signs, queries = square.draw(x, gen)
    assert set(signs.unique().tolist()) == {-1.0, 1.0}
    from adaa_tpu_torch.attacks.square import window_lengths
    for s, (pos, sign) in zip(window_lengths(1000, 100, 0.8), queries):
        assert int(pos.min()) >= 0 and int(pos.max()) + s <= 1000
        assert set(sign.flatten().tolist()) <= {-1.0, 1.0}
    a1 = tattacks.build_attack("GN", None)(x, None, torch.Generator().manual_seed(2))
    a2 = tattacks.build_attack("GN", None)(x, None, torch.Generator().manual_seed(2))
    assert torch.equal(a1, a2) and not torch.equal(a1, x)
    with pytest.raises(ValueError, match="Generator"):
        tattacks.build_attack("GN", None)(x, None, None)


def test_autoattack_standard_composition(monkeypatch):
    """AutoAttack's 'standard' suite: APGD-CE, APGD-T, FAB and Square in the
    upstream order with the upstream budgets (as
    ``tests/test_attacks.py::test_autoattack_standard_composition``)."""
    import importlib

    calls = []

    def fake(name):
        def builder(logits_fn, **kw):
            calls.append((name, kw))
            return lambda x, y, generator: x

        return builder

    for module, name in (("apgd", "apgd"), ("apgd", "apgdt"), ("fab", "fab"),
                         ("square", "square")):
        monkeypatch.setattr(importlib.import_module(f"adaa_tpu_torch.attacks.{module}"), name,
                            fake(name))
    tattacks.autoattack(lambda x: x, eps=0.03)
    assert [c[0] for c in calls] == ["apgd", "apgdt", "fab", "square"]
    kw = dict(calls)
    assert kw["apgd"] == {"norm": "Linf", "eps": 0.03, "steps": 100, "n_restarts": 1, "loss": "ce"}
    assert kw["apgdt"] == {"norm": "Linf", "eps": 0.03, "steps": 100, "n_restarts": 1,
                           "n_classes": 2}
    assert kw["fab"] == {"norm": "Linf", "eps": 0.03, "steps": 100, "n_restarts": 1,
                         "n_classes": 2}
    assert kw["square"] == {"norm": "Linf", "eps": 0.03, "n_queries": 5000}


def test_multiattack_keeps_each_rows_first_success_and_draws_in_turn():
    """Row 0 is fooled by the first member and keeps its output; row 1 only
    by the second; row 2 by none (unchanged); row 3 was wrong at first
    (unchanged). The members draw from the generator when they start."""
    v = torch.ones(3)
    logits_fn = lambda x: (x @ v - 1.5)[:, None]  # noqa: E731
    x = torch.tensor([[0.6, 0.6, 0.6], [0.6, 0.6, 0.6], [0.9, 0.9, 0.9], [0.1, 0.1, 0.1]])
    y = torch.tensor([1, 1, 1, 1])
    events = []

    def member(tag, rows, value):
        def draw(x, generator):
            events.append(f"draw {tag}")
            return torch.rand((), generator=generator)

        def run(x, y, u):
            events.append(f"run {tag}")
            out = x.clone()
            out[rows] = value + 0 * u
            return out

        return tcore.DrawnAttack(draw, run)

    first = member("a", [0], 0.1)
    second = member("b", [0, 1], 0.2)
    plain = lambda x, y, generator: x  # noqa: E731 -- a member that is not split
    adv = tattacks.multiattack(logits_fn, [first, plain, second])(
        x, y, torch.Generator().manual_seed(0))
    assert events == ["draw a", "run a", "draw b", "run b"]
    torch.testing.assert_close(adv[0], torch.full((3,), 0.1))
    torch.testing.assert_close(adv[1], torch.full((3,), 0.2))
    assert torch.equal(adv[2:], x[2:])


class _LinearDetector(torch.nn.Module):
    def __init__(self, length):
        super().__init__()
        w = torch.randn(length, generator=torch.Generator().manual_seed(0)) / length ** 0.5
        self.w = torch.nn.Parameter(w)

    def forward(self, x):
        return (x @ self.w)[:, None]


@pytest.mark.parametrize("name", sorted(jattacks.EXTRA_ATTACKS))
def test_generate_attacks_runs_every_extra_attack(name):
    """``generate_attacks(attack_name=...)`` takes every extra name (white-box,
    with the attack's defaults) and reports on the attacked batches."""
    from adaa_tpu_torch.data.synthetic import SyntheticDataset
    from adaa_tpu_torch.eval import generate_attacks

    model = _LinearDetector(256)
    report = generate_attacks(model, SyntheticDataset(n=8, subset="val", wave_length=256),
                              attack_name=name, attack_model=model, batch_size=4,
                              generator=torch.Generator().manual_seed(0))
    assert set(report) == {"eer", "accuracy", "precision", "recall", "f1_score", "auc"}
    assert 0.0 <= report["accuracy"] <= 100.0
