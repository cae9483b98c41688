"""adaa_tpu_torch's RawNet3 against adaa_tpu's on shared weights (CPU).

Batch 2 of L = 5041 samples, so T = 480 after the encoder and the fused
path's pools (5, then 3) divide it, at full width (C = 1024). Weights,
biases, BN affines and statistics are random, made with numpy from a
seed and handed to both sides through the weight bridge.

Tolerances (measured on this CPU at the seeds below):
* the weight bridge round trip through ``torch_import``: exact;
* the reference checkpoint layout (``tests/oracles/torch_rawnet3.py``)
  loads with ``strict=True``, and the port's f32 logits match the
  oracle's within 1e-5 (measured 5.0e-7 on logits of ~0.07);
* f32 logits against JAX: within 1e-5 (measured 1.3e-6 on logits of
  ~0.2);
* bf16 logits against the JAX model with the matching switch: within
  1e-3 (measured 1.5e-4 default and pool, 2.2e-4 b2n); the input gradient
  of the CE against JAX's: cosine >= 0.99 (measured 0.9992 default,
  0.9991 pool, 0.9973 b2n). Both sides round to bf16 at the same places
  but sum in other orders. The pool configuration is held to the JAX
  default (JAX's pool switch is a no-op on the CPU), so it also differs
  by its tie rule: first-max routing sends a tie's cotangent to one slot
  where the eqmask sends it to all; ties in layer 1's pool are rare
  enough here that its cosine stays in the same band;
* PGD-2 without random start on the f32 model: >= 50% of coordinates
  equal to JAX's within 1e-6 (measured 0.586), and the CE gain of the
  port's adversarial batch, scored by the JAX model, >= 95% of JAX's own
  (measured 101%). The input gradients agree (cosine 0.9995, 99.8% of
  signs equal to JAX's op-by-op gradient), but RawNet3's f32 gradient
  has many coordinates near zero (the log of the sinc outputs amplifies
  summation-order noise): JAX's own jit-compiled PGD step disagrees with
  the sign of its op-by-op gradient on 6.9% of coordinates, and a second
  signed step compounds it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu import attacks as jattacks
from adaa_tpu import models as jmodels
from adaa_tpu.models import torch_import
from adaa_tpu_torch import attacks as tattacks
from adaa_tpu_torch import models as tmodels
from adaa_tpu_torch.models.weights import rawnet3_state_dict_from_flax
from tests.oracles.torch_rawnet3 import TorchRawNet3
from tests.torch_port_common import rawnet3_variables

torch.set_num_threads(2)

L = 5041
LABELS = np.array([0, 1])


@pytest.fixture(scope="module")
def variables():
    return rawnet3_variables(0)


@pytest.fixture(scope="module")
def waves():
    return np.random.default_rng(20).standard_normal((2, L)).astype(np.float32)


def _port(cfg, variables):
    model = tmodels.get_model("rawnet3", cfg)
    model.load_state_dict(rawnet3_state_dict_from_flax(variables), strict=True)
    return model.eval()


def _jax_ce_and_grad(cfg, variables, x, monkeypatch, b2n: bool):
    """JAX logits and the input gradient of the two-class CE."""
    monkeypatch.setenv("ADAA_FUSED_B2N", "1" if b2n else "0")
    fn = jattacks.make_logits_fn(jmodels.get_model("rawnet3", cfg),
                                 jax.tree_util.tree_map(jnp.asarray, variables))
    y = jnp.asarray(LABELS)
    (_, z), g = jax.value_and_grad(
        lambda a: (lambda zz: (jattacks.two_class_ce(zz, y), zz))(fn(a)), has_aux=True)(
        jnp.asarray(x))
    return np.asarray(z), np.asarray(g)


def _port_ce_and_grad(cfg, variables, x):
    fn = tattacks.make_logits_fn(_port(cfg, variables))
    xt = torch.from_numpy(x).requires_grad_(True)
    z = fn(xt)
    (g,) = torch.autograd.grad(tattacks.two_class_ce(z, torch.from_numpy(LABELS)), xt)
    return z.detach().numpy(), g.numpy()


def test_weight_bridge_round_trip(variables):
    sd = rawnet3_state_dict_from_flax(variables)
    back = torch_import.import_state_dict(
        "rawnet3", {k: v.numpy() for k, v in sd.items()}, variables)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a, err_msg=str(path))


def test_reference_checkpoint_layout_loads_strict(waves):
    torch.manual_seed(2)
    oracle = TorchRawNet3().eval()
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for m in oracle.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.from_numpy(rng.standard_normal(m.num_features) * 0.1))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, m.num_features)))
    model = tmodels.get_model("rawnet3", {})
    model.load_state_dict(oracle.state_dict(), strict=True)
    model.eval()
    with torch.no_grad():
        ref = oracle(torch.from_numpy(waves)).numpy()
        out = model(torch.from_numpy(waves)).numpy()
    assert np.abs(out - ref).max() <= 1e-5


def test_f32_logits_match_jax(variables, waves):
    module = jmodels.get_model("rawnet3", {})
    zj = np.asarray(module.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                                 jnp.asarray(waves), train=False))
    with torch.no_grad():
        zt = _port({}, variables)(torch.from_numpy(waves)).numpy()
    assert zt.shape == (2, 1)
    assert np.abs(zt - zj).max() <= 1e-5


@pytest.fixture(scope="module")
def x01(waves):
    return tattacks.to_minmax(torch.from_numpy(waves))[0].numpy()


@pytest.mark.parametrize("config", ["default", "pool", "b2n"])
def test_bf16_configurations_match_jax(variables, x01, monkeypatch, config):
    cfg = {"compute_dtype": "bfloat16", "fused_pool": config == "pool",
           "fused_b2n": config == "b2n"}
    zj, gj = _jax_ce_and_grad({"compute_dtype": "bfloat16"}, variables, x01, monkeypatch,
                              b2n=config == "b2n")
    zt, gt = _port_ce_and_grad(cfg, variables, x01)
    assert np.abs(zt - zj).max() <= 1e-3
    cos = float((gt * gj).sum() / (np.linalg.norm(gt) * np.linalg.norm(gj)))
    assert cos >= 0.99, cos


def test_pgd2_f32_matches_jax(variables, x01):
    override = {"steps": 2, "random_start": False}
    jfn = jattacks.make_logits_fn(jmodels.get_model("rawnet3", {}),
                                  jax.tree_util.tree_map(jnp.asarray, variables))
    adv_j = np.asarray(jattacks.build_attack("PGD", jfn, override)(
        jnp.asarray(x01), jnp.asarray(LABELS), jax.random.PRNGKey(0)))
    tfn = tattacks.make_logits_fn(_port({}, variables))
    adv_t = tattacks.build_attack("PGD", tfn, override)(
        torch.from_numpy(x01), torch.from_numpy(LABELS), None).numpy()
    assert np.mean(adv_j != x01) > 0.99
    assert np.mean(np.abs(adv_t - adv_j) <= 1e-6) >= 0.5
    y = jnp.asarray(LABELS)
    ce = {k: float(jattacks.two_class_ce(jfn(jnp.asarray(a)), y))
          for k, a in (("clean", x01), ("jax", adv_j), ("port", adv_t))}
    assert ce["port"] - ce["clean"] >= 0.95 * (ce["jax"] - ce["clean"]) > 0, ce
