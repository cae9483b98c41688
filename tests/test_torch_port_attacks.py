"""adaa_tpu_torch.attacks vs adaa_tpu.attacks on shared LCNN weights (CPU).

Tolerances:
* FGSM / PGD-2 without random start, f32 model: >= 99% of coordinates
  equal to JAX's within 1e-6. A signed step flips only where the f32
  gradient of the two implementations differs in sign, i.e. where it
  is ~0.
* PGDL2-2 without random start, f32 model: the perturbation within 1e-2
  relative L2 (measured 1.5e-3). Its steps follow the gradient's
  magnitude, which moves where a near-tie in a max picks another winner
  under another summation order.
* bf16 model: input-gradient cosine >= 0.99 (measured 0.9957; the JAX
  model's own bf16-vs-f32 cosine is 0.937) — both round to bf16 at the
  same places but sum in other orders, so the gradients agree in
  direction, not in bits.
* PGD-2 without random start on the fused configuration (fused LFCC +
  fused trunk, the JAX package's two switches on): >= 85% of coordinates
  equal to JAX's within 1e-6 (measured 0.882; the default bf16
  configuration measures 0.879 the same way). A bf16 gradient agrees in
  direction, so a signed step flips only where the gradient is small.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaa_tpu.ops.pallas_lfcc as jpallas_lfcc
from adaa_tpu import attacks as jattacks
from adaa_tpu import models as jmodels
from adaa_tpu_torch import attacks as tattacks
from adaa_tpu_torch import models as tmodels
from tests.torch_port_common import (CFG_BF16, CFG_F32, CFG_FUSED, lcnn_variables,
                                     port_lcnn, waves)

torch.set_num_threads(2)

EPS = 0.0005
LABELS = np.array([0, 1])


@pytest.fixture(scope="module")
def variables():
    return lcnn_variables(0)


@pytest.fixture(scope="module")
def x01():
    xt, _, _ = tattacks.to_minmax(torch.from_numpy(waves(20)))
    return xt.numpy()


def _jax_logits_fn(cfg, variables):
    module = jmodels.get_model("lcnn", cfg)
    return jattacks.make_logits_fn(module, jax.tree_util.tree_map(jnp.asarray, variables))


@pytest.mark.parametrize("name,override", [
    ("FGSM", None),
    ("PGD", {"steps": 2, "random_start": False}),
    ("PGDL2", {"steps": 2, "random_start": False}),
])
def test_deterministic_attacks_match_jax_f32(variables, x01, name, override):
    jatk = jattacks.build_attack(name, _jax_logits_fn(CFG_F32, variables), override)
    adv_j = np.asarray(jatk(jnp.asarray(x01), jnp.asarray(LABELS), jax.random.PRNGKey(0)))
    tatk = tattacks.build_attack(name, tattacks.make_logits_fn(port_lcnn(CFG_F32, variables)),
                                 override)
    adv_t = tatk(torch.from_numpy(x01), torch.from_numpy(LABELS), None).numpy()
    assert not np.array_equal(adv_j, x01)
    if name == "PGDL2":
        rel = np.linalg.norm(adv_t - adv_j) / np.linalg.norm(adv_j - x01)
        assert rel < 1e-2, rel
    else:
        agree = np.mean(np.abs(adv_t - adv_j) <= 1e-6)
        assert agree >= 0.99, agree


def test_bf16_input_gradient_matches_jax(variables, x01):
    jfn = _jax_logits_fn(CFG_BF16, variables)
    gj = np.asarray(jax.grad(lambda x: jattacks.two_class_ce(jfn(x), jnp.asarray(LABELS)))(
        jnp.asarray(x01)))
    tfn = tattacks.make_logits_fn(port_lcnn(CFG_BF16, variables))
    xt = torch.from_numpy(x01).requires_grad_(True)
    (gt,) = torch.autograd.grad(tattacks.two_class_ce(tfn(xt), torch.from_numpy(LABELS)), xt)
    gt = gt.numpy()
    cos = float((gt * gj).sum() / (np.linalg.norm(gt) * np.linalg.norm(gj)))
    assert cos >= 0.99, cos


def test_fused_configuration_pgd2_matches_jax(variables, x01, monkeypatch):
    monkeypatch.setenv("ADAA_PALLAS_FRONTEND", "1")
    monkeypatch.setenv("ADAA_FUSED_TRUNK", "1")
    orig = jpallas_lfcc.lfcc_pallas
    monkeypatch.setattr(jpallas_lfcc, "lfcc_pallas",
                        lambda x, interpret=False: orig(x, interpret=True))
    override = {"steps": 2, "random_start": False}
    jatk = jattacks.build_attack("PGD", _jax_logits_fn(CFG_BF16, variables), override)
    adv_j = np.asarray(jatk(jnp.asarray(x01), jnp.asarray(LABELS), jax.random.PRNGKey(0)))
    model = port_lcnn(CFG_FUSED, variables)
    tatk = tattacks.build_attack("PGD", tattacks.make_logits_fn(model), override)
    adv_t = tatk(torch.from_numpy(x01), torch.from_numpy(LABELS), None).numpy()
    assert np.mean(adv_j != x01) > 0.99
    agree = np.mean(np.abs(adv_t - adv_j) <= 1e-6)
    assert agree >= 0.85, agree


def test_random_start_within_ball_and_seeded(x01):
    def no_model(_):
        raise AssertionError("no gradient steps expected")

    x = torch.from_numpy(x01)
    atk = tattacks.build_attack("PGD", no_model, {"steps": 0})
    a1 = atk(x, None, torch.Generator().manual_seed(5))
    a2 = atk(x, None, torch.Generator().manual_seed(5))
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    delta = a1 - x
    assert float(delta.abs().max()) <= EPS + 1e-7 and float(delta.abs().max()) > 0.9 * EPS
    assert float(a1.min()) >= 0.0 and float(a1.max()) <= 1.0
    l2 = tattacks.build_attack("PGDL2", no_model, {"steps": 0})(x, None, torch.Generator())
    assert float(tattacks.core.flat_norms(l2 - x, "l2").max()) <= 0.1 + 1e-5
    with pytest.raises(ValueError, match="Generator"):
        atk(x, None, None)


def test_registry_mirrors_jax():
    assert list(tattacks.ATTACK_REGISTRY) == list(jattacks.ATTACK_REGISTRY)
    for name, (jb, jp) in jattacks.ATTACK_REGISTRY.items():
        tb, tp = tattacks.ATTACK_REGISTRY[name]
        assert tp == jp, name
        assert (tb is None) == (jb is None) and (tb is None or tb.__name__ == jb.__name__), name
    assert set(tattacks.EXTRA_ATTACKS) == set(jattacks.EXTRA_ATTACKS)
    for name, jb in jattacks.EXTRA_ATTACKS.items():
        assert tattacks.EXTRA_ATTACKS[name].__name__ == jb.__name__, name
        assert callable(tattacks.build_attack(name, lambda x: x)), name
    assert tattacks.build_attack("NO_ATTACK", None) is None
    with pytest.raises(KeyError):
        tattacks.build_attack("NOPE", lambda x: x)


@pytest.mark.parametrize("training,grad", [(True, True), (False, False)],
                         ids=["train_grad_on", "eval_grad_off"])
def test_attack_leaves_parameters_and_bn_stats_unchanged(variables, training, grad):
    """The attack runs the model frozen in eval mode, and gives it back as
    the caller had it: its ``training`` flags, each parameter's
    ``requires_grad`` and its state_dict, bit for bit."""
    model = port_lcnn(CFG_BF16, variables).train(training).requires_grad_(grad)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    atk = tattacks.attack_in_wave_space(
        tattacks.build_attack("PGD", tattacks.make_logits_fn(model), {"steps": 2}))
    x = torch.from_numpy(waves(21))
    adv = atk(x, torch.from_numpy(LABELS), torch.Generator().manual_seed(0))
    assert adv.shape == x.shape and bool(torch.isfinite(adv).all())
    assert all(m.training == training for m in model.modules())
    assert all(p.requires_grad == grad for p in model.parameters())
    assert all(p.grad is None for p in model.parameters())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)


def test_attack_on_a_training_fused_model_matches_a_frozen_copy(variables):
    """A bf16 LCNN with the fused trunk, held in train() with its parameters
    requiring grad (an adversarial trainer's live model), goes through the
    dx-only fused Functions without a raise, and its adversarial waves are
    bit-equal to those of a frozen eval-mode copy."""
    cfg = {**CFG_BF16, "fused_trunk": True}
    live = port_lcnn(cfg, variables).train().requires_grad_(True)
    frozen = port_lcnn(cfg, variables).eval().requires_grad_(False)
    x = torch.from_numpy(waves(23))
    advs = []
    for model in (live, frozen):
        atk = tattacks.attack_in_wave_space(
            tattacks.build_attack("PGD", tattacks.make_logits_fn(model), {"steps": 2}))
        advs.append(atk(x, torch.from_numpy(LABELS), torch.Generator().manual_seed(3)))
    assert not torch.equal(advs[0], x)
    assert torch.equal(advs[0], advs[1])
    assert live.training and all(p.requires_grad for p in live.parameters())


@pytest.mark.parametrize("name", ["lcnn", "rawnet3", "specrnet"])
def test_get_model_honours_adaa_bf16(monkeypatch, name):
    """ADAA_BF16=1 chooses the bf16 model, as adaa_tpu.models.get_model does."""
    cfg = {} if name == "rawnet3" else CFG_F32
    assert tmodels.get_model(name, cfg).compute_dtype is None
    monkeypatch.setenv("ADAA_BF16", "1")
    assert jmodels.get_model(name, cfg).compute_dtype == jnp.bfloat16
    assert tmodels.get_model(name, cfg).compute_dtype == torch.bfloat16


def test_core_functions_match_jax():
    z = np.array([[-3.0], [0.0], [2.5], [40.0]], np.float32)
    y = np.array([0, 1, 1, 0])
    tz, ty = torch.from_numpy(z), torch.from_numpy(y)
    np.testing.assert_allclose(float(tattacks.two_class_ce(tz, ty)),
                               float(jattacks.two_class_ce(jnp.asarray(z), jnp.asarray(y))),
                               rtol=1e-6)
    np.testing.assert_array_equal(tattacks.two_class_logits(tz).numpy(),
                                  np.asarray(jattacks.two_class_logits(jnp.asarray(z))))
    np.testing.assert_array_equal(tattacks.predicted_label(tz).numpy(),
                                  np.asarray(jattacks.predicted_label(jnp.asarray(z))))
    w = torch.from_numpy(waves(22, 2, 1000))
    x01, mn, mx = tattacks.to_minmax(w)
    assert float(x01.min()) == 0.0 and float(x01.max()) == 1.0
    torch.testing.assert_close(tattacks.revert_minmax(x01, mn, mx), w, rtol=1e-6, atol=1e-6)
    for ord_ in ("linf", "l2", "l1"):
        np.testing.assert_allclose(tattacks.core.flat_norms(w, ord_).numpy(),
                                   np.asarray(jattacks.core.flat_norms(jnp.asarray(w.numpy()), ord_)),
                                   rtol=1e-5)


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import adaa_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(adaa_tpu_torch.__path__, 'adaa_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'adaa_tpu', 'triton', 'sklearn', 'pandas',\n"
        "                   'yaml', 'msgpack', 'matplotlib') if m in sys.modules]\n"
        "need = {'adaa_tpu_torch.models.rawnet3', 'adaa_tpu_torch.ops.sinc_conv',\n"
        "        'adaa_tpu_torch.ops.pool', 'adaa_tpu_torch.ops.b2n',\n"
        "        'adaa_tpu_torch.models.specrnet', 'adaa_tpu_torch.attacks.fab',\n"
        "        'adaa_tpu_torch.metrics', 'adaa_tpu_torch.eval.adv_evaluation',\n"
        "        'adaa_tpu_torch.scripts.evaluate_models_on_adversarial_attacks',\n"
        "        'adaa_tpu_torch.training.train_state', 'adaa_tpu_torch.training.gd_trainer',\n"
        "        'adaa_tpu_torch.training.adv_trainer', 'adaa_tpu_torch.utils.checkpoints',\n"
        "        'adaa_tpu_torch.scripts.train_models',\n"
        "        'adaa_tpu_torch.scripts.train_models_on_adversarial_attacks',\n"
        "        'adaa_tpu_torch.data.native', 'adaa_tpu_torch.data.base', 'adaa_tpu_torch.data.mp3',\n"
        "        'adaa_tpu_torch.data.datasets', 'adaa_tpu_torch.data.detection',\n"
        "        'adaa_tpu_torch.data.misc', 'adaa_tpu_torch.utils.msgpack',\n"
        "        'adaa_tpu_torch.attacks.differential_evolution', 'adaa_tpu_torch.attacks.onepixel',\n"
        "        'adaa_tpu_torch.attacks.cw', 'adaa_tpu_torch.attacks.apgd',\n"
        "        'adaa_tpu_torch.attacks.square', 'adaa_tpu_torch.attacks.extra',\n"
        "        'adaa_tpu_torch.attacks.composite', 'adaa_tpu_torch.attacks.save',\n"
        "        'adaa_tpu_torch.eval.postanalysis', 'adaa_tpu_torch.models.extra',\n"
        "        'adaa_tpu_torch.config', 'adaa_tpu_torch.utils.flops',\n"
        "        'adaa_tpu_torch.parallel', 'adaa_tpu_torch.parallel.mesh',\n"
        "        'adaa_tpu_torch.parallel.dryrun', 'adaa_tpu_torch.scripts.multi_runs',\n"
        "        *('adaa_tpu_torch.scripts.multi_runs.run_multiple_' + m for m in (\n"
        "            'evaluations', 'trainings', 'evaluations_on_adversarial_attacks',\n"
        "            'trainings_on_adversarial_attacks'))}\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'importing the port started a process group'\n"
        "assert len(mods) >= 30 and need <= set(mods) and not bad, (mods, bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
