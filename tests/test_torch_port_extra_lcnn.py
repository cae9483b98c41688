"""A few of adaa_tpu_torch's extra attacks vs adaa_tpu's on the f32 LCNN (CPU).

Shared weights (``lcnn_variables(0)``), B = 2 waves of 64,600 samples
through ``to_minmax`` (so each row holds the box's endpoints), labels the
detector's own predictions (every row attacked); random draws are JAX's
own (``tests/torch_port_draws.py``).

Tolerances and what was measured:
* CW, 5 steps, c = 1: >= 99% of coordinates within 1e-6 of JAX's
  (measured 0.998). Adam's first steps are steps of lr x sign(g), so a
  coordinate parts where the two f32 gradients differ in sign. At the
  default c = 1e-4 the gradient is dominated by 2 (tanh(atanh(2x - 1)) / 2
  + 1/2 - x), the round trip's rounding, which differs between the two
  libraries' tanh and log: 0.90 agree there, with the JAX model's own
  gradient too (a torch Function calling jax.vjp); on a linear detector
  at the defaults the port is within 6e-8 of JAX
  (``test_torch_port_extra_attacks.py``).
* APGD-CE, 5 steps, JAX's start: the same rows fooled, every row in its
  eps ball and the box. Coordinates within 1e-6 of JAX's are not held:
  measured 1.0000 / 0.993 / 0.951 / 0.881 after 1 / 2 / 3 / 5 steps.
  APGD steps 2 eps with momentum, so a coordinate whose gradient sign
  differs crosses the whole ball, and the iterates part further at each
  step; driven by the JAX model's own gradient they part the same way
  (0.942 after 5 steps), while on a linear detector (no near-zero
  gradients) the port is bit-equal to JAX over 100 steps.
* DeepFool, 3 steps: perturbation within 1e-2 relative L2 (measured 1.4e-3).
* Square, 10 queries, and OnePixel, 2 generations of 9 members (chunks
  of 9 rows): outputs within 1e-6 (measured: bit-equal), so the same
  proposals were accepted and the same best member won.
* ``save_adversarial_dataset`` with FGSM (eps 5e-4) over a 2-batch
  loader: labels, predictions and robust accuracy equal to JAX's, the L2
  within 1e-5 relative (measured 1.1e-6), the adversarial waves >= 99%
  within 1e-6 x the row's wave range (measured 0.99997: an FGSM sign
  flips where the gradient is ~0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu import attacks as jattacks
from adaa_tpu import models as jmodels
from adaa_tpu.attacks.save import save_adversarial_dataset as jax_save
from adaa_tpu_torch import attacks as tattacks
from adaa_tpu_torch.attacks.save import save_adversarial_dataset
from tests.torch_port_common import CFG_F32, lcnn_variables, port_lcnn, waves
from tests.torch_port_draws import attack_draws

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def problem():
    variables = lcnn_variables(0)
    jfn = jattacks.make_logits_fn(jmodels.get_model("lcnn", CFG_F32),
                                  jax.tree_util.tree_map(jnp.asarray, variables))
    tfn = tattacks.make_logits_fn(port_lcnn(CFG_F32, variables))
    x01 = tattacks.to_minmax(torch.from_numpy(waves(20)))[0].numpy()
    with torch.no_grad():
        y = (tfn(torch.from_numpy(x01)).squeeze(-1) > 0).long().numpy()
    return jfn, tfn, x01, y


def _both(problem, name, params):
    jfn, tfn, x01, y = problem
    key = jax.random.PRNGKey(3)
    adv_j = np.asarray(jattacks.build_attack(name, jfn, params)(
        jnp.asarray(x01), jnp.asarray(y), key))
    atk = tattacks.build_attack(name, tfn, params)
    xt, yt = torch.from_numpy(x01), torch.from_numpy(y)
    if isinstance(atk, tattacks.core.DrawnAttack):
        adv_t = atk.run(xt, yt, attack_draws(name, key, x01.shape, params))
    else:
        adv_t = atk(xt, yt, None)
    adv_t = adv_t.numpy()
    assert adv_t.shape == x01.shape and np.isfinite(adv_t).all()
    assert adv_t.min() >= 0.0 and adv_t.max() <= 1.0
    assert (np.abs(adv_j - x01).max(axis=1) > 0).all()  # every row moved
    return adv_j, adv_t


def test_cw_on_lcnn_matches_jax(problem):
    adv_j, adv_t = _both(problem, "CW", {"steps": 5, "c": 1.0})
    agree = np.mean(np.abs(adv_t - adv_j) <= 1e-6)
    assert agree >= 0.99, agree


def test_apgd_on_lcnn_matches_jax(problem):
    jfn, tfn, x01, y = problem
    adv_j, adv_t = _both(problem, "APGD", {"steps": 5})
    eps = 8 / 255
    assert np.abs(adv_t - x01).max() <= eps + 1e-6
    fooled_j = (np.asarray(jfn(jnp.asarray(adv_j)))[:, 0] > 0).astype(np.int64) != y
    with torch.no_grad():
        fooled_t = (tfn(torch.from_numpy(adv_t))[:, 0] > 0).long().numpy() != y
    np.testing.assert_array_equal(fooled_t, fooled_j)


def test_deepfool_on_lcnn_matches_jax(problem):
    x01 = problem[2]
    adv_j, adv_t = _both(problem, "DeepFool", {"steps": 3})
    rel = np.linalg.norm(adv_t - adv_j) / np.linalg.norm(adv_j - x01)
    assert rel <= 1e-2, rel


@pytest.mark.parametrize("name,params", [
    ("Square", {"n_queries": 10}),
    ("OnePixel", {"steps": 2, "popsize": 10, "inf_batch": 9}),
])
def test_search_attacks_on_lcnn_match_jax(problem, name, params):
    adv_j, adv_t = _both(problem, name, params)
    np.testing.assert_allclose(adv_t, adv_j, rtol=0, atol=1e-6)


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def test_save_adversarial_dataset_matches_jax(problem, tmp_path):
    jfn, tfn, _, _ = problem
    batches = []
    for i in range(2):
        x = waves(30 + i)
        with torch.no_grad():
            y = (tfn(tattacks.to_minmax(torch.from_numpy(x))[0]).squeeze(-1) > 0).numpy()
        y[0] = not y[0]
        batches.append([x, np.full(2, 16000), y.astype(np.int32)])
    params = {"eps": 0.0005}
    kw = {"return_verbose": True, "save_pred": True, "verbose": False}
    rob_j, l2_j, _ = jax_save(jattacks.build_attack("FGSM", jfn, params), jfn, _Loader(batches),
                              save_path=str(tmp_path / "jax.npz"), **kw)
    rob_t, l2_t, ms = save_adversarial_dataset(
        tattacks.build_attack("FGSM", tfn, params), tfn, _Loader(batches),
        save_path=str(tmp_path / "port.npz"), device="cpu", **kw)
    zj, zt = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert set(zt.files) == set(zj.files) == {"adv_inputs", "labels", "preds"}
    np.testing.assert_array_equal(zt["labels"], zj["labels"])
    np.testing.assert_array_equal(zt["preds"], zj["preds"])
    assert rob_t == rob_j and ms > 0
    assert abs(l2_t - l2_j) <= 1e-5 * l2_j
    scale = np.concatenate([b[0].max(1) - b[0].min(1) for b in batches])[:, None]
    agree = np.mean(np.abs(zt["adv_inputs"] - zj["adv_inputs"]) <= 1e-6 * scale)
    assert zt["adv_inputs"].shape == (4, 64_600) and agree >= 0.99, agree
