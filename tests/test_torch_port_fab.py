"""adaa_tpu_torch FAB vs adaa_tpu FAB (CPU).

Tolerances:
* each projection (the Linf / L2 paired fan searches, the sort-based
  Linf / L2 / L1 forms) on random (t, w, b) with t in the box: within
  1e-5 absolute of JAX's (the same f32 formulas; sums in other orders).
* ``fab`` on a linear logits function, reference-exact and merged step:
  every row within 1e-5 of JAX's.
* FAB with 10 steps on the f32 SpecRNet: the same success mask, and
  every successful row misclassified within the eps ball. The inputs are
  seeded waves whose clean logits are all further than 1e-3 from 0: a
  logit at the boundary flips ``is_adv`` on an ulp, and then the two
  implementations attack different rows.
  The per-row Linf norms are not held to each other: with the registry's
  eta = 10 the trajectories part within a few steps even when no logit
  comes near 0 (measured: |z| >= 4e-4 along the whole run). The Linf
  projection moves every coordinate by -sign(w_i) min(lam, p_i), so a
  coordinate whose gradient is ~0 takes a full step one way or the other,
  and the two f32 gradients differ by ~1e-6 relative (~1e-3 where a
  pool's near-tie picks another winner). Measured final norms: JAX 0.170
  / 0.270 / 0.165, port 0.170 / 0.216 / 0.221; with the port's FAB driven
  by the JAX model's own gradients (a torch Function calling jax.vjp)
  they part the same way (0.183 / 0.216 / 0.229).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu import attacks as jattacks
from adaa_tpu import models as jmodels
from adaa_tpu.attacks import fab_projections as jproj
from adaa_tpu_torch import attacks as tattacks
from adaa_tpu_torch.attacks import fab_projections as tproj
from tests.torch_port_common import CFG_F32, port_specrnet, specrnet_variables, waves

torch.set_num_threads(2)


def _problem(seed, b=4, d=777, s=None):
    rng = np.random.default_rng(seed)
    shape = (b, d) if s is None else (s, b, d)
    t = rng.uniform(0, 1, shape).astype(np.float32)
    w = rng.standard_normal((b, d)).astype(np.float32)
    w[:, ::13] = 0.0  # zero weights take the masked branches
    tt = t if s is None else t[0]
    bb = ((w * tt).sum(-1) + rng.standard_normal(b) * 3.0).astype(np.float32)
    if s is not None:
        bb = np.stack([bb] * s)
    return t, w, bb


@pytest.mark.parametrize("name", ["linf_bisect_pair", "l2_bisect_pair"])
@pytest.mark.parametrize("seed", [0, 1])
def test_paired_projections_match_jax(name, seed):
    t2, w, b2 = _problem(seed, s=2)
    dj = np.asarray(getattr(jproj, f"projection_{name}")(jnp.asarray(t2), jnp.asarray(w),
                                                         jnp.asarray(b2)))
    dt = getattr(tproj, f"projection_{name}")(torch.from_numpy(t2), torch.from_numpy(w),
                                              torch.from_numpy(b2)).numpy()
    assert dt.shape == t2.shape and np.abs(dj).max() > 0
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["linf", "l2", "l1"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sorted_projections_match_jax(name, seed):
    t, w, b = _problem(10 + seed)
    dj = np.asarray(getattr(jproj, f"projection_{name}")(jnp.asarray(t), jnp.asarray(w),
                                                         jnp.asarray(b)))
    dt = getattr(tproj, f"projection_{name}")(torch.from_numpy(t), torch.from_numpy(w),
                                              torch.from_numpy(b)).numpy()
    assert np.abs(dj).max() > 0
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5)


def _linear_problem(seed, b=6, d=300):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(d) / np.sqrt(d)).astype(np.float32)
    x = rng.uniform(0, 1, (b, d)).astype(np.float32)
    c = np.float32(-(x @ v).mean())
    y = ((x @ v + c) > 0).astype(np.int64)
    y[0] = 1 - y[0]  # one row already misclassified: left as it is
    return v, c, x, y


@pytest.mark.parametrize("merged", [False, True], ids=["reference_exact", "merged"])
@pytest.mark.parametrize("norm", ["Linf", "L2", "L1"])
def test_fab_on_a_linear_model_matches_jax(monkeypatch, merged, norm):
    if merged:
        monkeypatch.setenv("ADAA_FAB_MERGED", "1")
    v, c, x, y = _linear_problem(3)
    vj, vt = jnp.asarray(v), torch.from_numpy(v)
    # eta 10 overshoots in L2 / L1 beyond their default eps: widen it
    kw = {"norm": norm, "steps": 10, "eta": 10, "eps": {"Linf": None, "L2": 10.0, "L1": 10.0}[norm]}
    jatk = jattacks.fab(lambda xx: (xx @ vj + c)[:, None], **kw)
    tatk = tattacks.fab(lambda xx: (xx @ vt + c)[:, None], **kw)
    adv_j = np.asarray(jatk(jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0)))
    adv_t = tatk(torch.from_numpy(x), torch.from_numpy(y), None).numpy()
    changed = np.abs(adv_j - x).max(axis=1) > 0
    assert changed.sum() >= 3 and not changed[0]
    np.testing.assert_allclose(adv_t, adv_j, rtol=0, atol=1e-5)


def test_fab_restarts_draw_from_the_generator():
    v, c, x, y = _linear_problem(4)
    vt = torch.from_numpy(v)
    atk = tattacks.fab(lambda xx: (xx @ vt + c)[:, None], steps=5, eta=10, n_restarts=2)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    a1 = atk(xt, yt, torch.Generator().manual_seed(1))
    a2 = atk(xt, yt, torch.Generator().manual_seed(1))
    assert torch.equal(a1, a2)
    with pytest.raises(ValueError, match="Generator"):
        atk(xt, yt, None)


def _boundary_free_waves(variables, n=3, length=16_000):
    """Seeded [0, 1] waves whose f32 SpecRNet logits are all further than
    1e-3 from 0, searched over seeds in order."""
    model = port_specrnet(CFG_F32, variables)
    for seed in range(100):
        x01, _, _ = tattacks.to_minmax(torch.from_numpy(waves(300 + seed, n, length)))
        with torch.no_grad():
            z = model(x01)
        if float(z.abs().min()) > 1e-3:
            return x01.numpy(), (z.squeeze(-1) > 0).long().numpy()
    raise AssertionError("no boundary-free seed")


def test_fab_on_specrnet_matches_jax():
    variables = specrnet_variables(1)
    x01, pred = _boundary_free_waves(variables)
    y = pred.copy()  # every row correctly classified, so every row is attacked
    override = {"steps": 10}
    jmodule = jmodels.get_model("specrnet", CFG_F32)
    jfn = jattacks.make_logits_fn(jmodule, jax.tree_util.tree_map(jnp.asarray, variables))
    adv_j = np.asarray(jattacks.build_attack("FAB", jfn, override)(
        jnp.asarray(x01), jnp.asarray(y), jax.random.PRNGKey(0)))
    tfn = tattacks.make_logits_fn(port_specrnet(CFG_F32, variables))
    adv_t = tattacks.build_attack("FAB", tfn, override)(
        torch.from_numpy(x01), torch.from_numpy(y), None).numpy()
    ok_j = np.abs(adv_j - x01).max(axis=1) > 0
    ok_t = np.abs(adv_t - x01).max(axis=1) > 0
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_j.any()
    for adv, fn in ((adv_j, lambda a: np.asarray(jfn(jnp.asarray(a)))),
                    (adv_t, lambda a: tfn(torch.from_numpy(a)).detach().numpy())):
        assert np.abs(adv - x01).max(axis=1)[ok_j].max() <= 0.3 + 1e-6
        assert ((fn(adv)[:, 0] > 0).astype(np.int64) != y)[ok_j].all()


@pytest.mark.parametrize("name", ["FAB", "FAB_eta20", "FAB_eta30"])
def test_registry_fab_entries_build_and_run(name):
    v, c, x, y = _linear_problem(5)
    vt = torch.from_numpy(v)
    atk = tattacks.build_attack(name, lambda xx: (xx @ vt + c)[:, None], {"steps": 3})
    xt = torch.from_numpy(x)
    adv = atk(xt, torch.from_numpy(y), torch.Generator().manual_seed(0))
    assert adv.shape == xt.shape and bool(torch.isfinite(adv).all())
    assert float(adv.min()) >= 0.0 and float(adv.max()) <= 1.0
    assert bool((adv != xt).any())
