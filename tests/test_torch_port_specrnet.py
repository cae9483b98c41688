"""The port's SpecRNet (and BiGRU) vs the JAX model on shared weights (CPU).

Weights come from ``tests/torch_port_common.py:specrnet_variables``, with
randomised BN statistics and affines. Inputs are (2, 64600) waves.

Tolerances:
* BiGRU, f32: within 1e-5 (the same f32 recurrence; sums in other orders).
* logits, f32: within 1e-4 x max |logit| (measured 1.5e-7 absolute).
* logits, bf16: within 2e-4 absolute (measured 2.8e-5). Both round to
  bf16 at the same places; sums run in other orders, so a value near a
  bf16 rounding boundary can round the other way.
* input gradient, f32: relative L2 <= 1e-4 (measured ~1e-6; a pool's
  near-tie that picks another winner in one implementation moves a row by
  up to ~1e-3, which these inputs do not hit).
* FGSM and PGD-2 without random start, f32: >= 99% of coordinates equal
  to JAX's within 1e-6, as for LCNN (a signed step flips only where the
  gradient is ~0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu import attacks as jattacks
from adaa_tpu import models as jmodels
from adaa_tpu.models import layers as jlayers
from adaa_tpu.models import torch_import
from adaa_tpu_torch import attacks as tattacks
from adaa_tpu_torch.models import layers as tlayers
from adaa_tpu_torch.models import specrnet as tspecrnet
from adaa_tpu_torch.models.weights import specrnet_state_dict_from_flax
from tests.torch_port_common import (CFG_BF16, CFG_F32, port_specrnet, specrnet_variables,
                                     waves)

torch.set_num_threads(2)

LABELS = np.array([0, 1])


@pytest.fixture(scope="module")
def variables():
    return specrnet_variables(0)


def _jax(cfg, variables):
    return jmodels.get_model("specrnet", cfg), jax.tree_util.tree_map(jnp.asarray, variables)


def test_bigru_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 6, 64)).astype(np.float32)
    jgru = jlayers.BiGRU(64, num_layers=2)
    jvars = jgru.init(jax.random.PRNGKey(1), jnp.asarray(x))
    yj = np.asarray(jgru.apply(jvars, jnp.asarray(x)))
    tgru = tlayers.BiGRU(64, 64, 2)
    tree = specrnet_variables(0)
    tree["params"]["gru"] = jvars["params"]
    sd = specrnet_state_dict_from_flax(tree)
    tgru.load_state_dict({k[len("gru."):]: v for k, v in sd.items() if k.startswith("gru.")})
    with torch.no_grad():
        yt = tgru(torch.from_numpy(x)).numpy()
    assert yt.shape == (3, 6, 128)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5)
    # the same function and parameter names as nn.GRU
    ref = torch.nn.GRU(64, 64, num_layers=2, bidirectional=True, batch_first=True)
    ref.load_state_dict(tgru.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(ref(torch.from_numpy(x))[0].numpy(), yt, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cfg,atol", [(CFG_F32, None), (CFG_BF16, 2e-4)], ids=["f32", "bf16"])
def test_logits_match_jax(variables, cfg, atol):
    x = waves(30)
    module, jvars = _jax(cfg, variables)
    zj = np.asarray(module.apply(jvars, jnp.asarray(x)))
    with torch.no_grad():
        zt = port_specrnet(cfg, variables)(torch.from_numpy(x))
    assert zt.shape == (2, 1) and zt.dtype == torch.float32
    np.testing.assert_allclose(zt.numpy(), zj, rtol=0,
                               atol=atol if atol else 1e-4 * np.abs(zj).max())


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if k == "__call__":
            out[prefix] = v[0].dtype
        elif isinstance(v, dict):
            out.update(_flatten(v, path))
    return out


def test_bf16_dtype_flow_matches_jax(variables, monkeypatch):
    """The output dtype of every conv, BN, block, gate dense layer, the GRU
    and the dense head of the bf16 model, against flax's intermediates."""
    x = waves(31, 1, 16_000)
    module, jvars = _jax(CFG_BF16, variables)
    _, state = module.apply(jvars, jnp.asarray(x), capture_intermediates=True,
                            mutable=["intermediates"])
    want = _flatten(state["intermediates"])
    want = {k: str(v) for k, v in want.items() if k and not k.endswith("bn1")}  # dead in eval

    model = port_specrnet(CFG_BF16, variables)
    names = {id(m): n.replace(".0.", "/").removesuffix(".0").replace(".", "/")
             for n, m in model.named_modules()}
    got = {}

    def record(mod, y):
        got[names[id(mod)]] = str(y.dtype).replace("torch.", "")
        return y

    conv, bn = tspecrnet._conv, tspecrnet._bn
    monkeypatch.setattr(tspecrnet, "_conv", lambda h, m, dtype: record(m, conv(h, m, dtype)))
    monkeypatch.setattr(tspecrnet, "_bn", lambda m, h, dtype: record(m, bn(m, h, dtype)))
    for name in ("block0", "block2", "block4", "fc_attention0", "fc_attention2",
                 "fc_attention4", "gru", "fc1_gru", "fc2_gru"):
        mod = model.get_submodule(name)
        mod = mod[0] if isinstance(mod, torch.nn.Sequential) else mod
        mod.register_forward_hook(
            lambda m, i, o, name=name: got.__setitem__(name, str(o.dtype).replace("torch.", "")))
    with torch.no_grad():
        model(torch.from_numpy(x))
    got = {k: v for k, v in got.items() if not k.startswith("gru/")}
    want = {k: v for k, v in want.items() if not k.startswith("gru/")}
    assert got == want
    assert want["block4"] == "float32" and want["block2"] == "bfloat16"


def test_input_gradient_matches_jax(variables):
    x01, _, _ = tattacks.to_minmax(torch.from_numpy(waves(32)))
    module, jvars = _jax(CFG_F32, variables)
    jfn = jattacks.make_logits_fn(module, jvars)
    gj = np.asarray(jax.grad(lambda x: jattacks.two_class_ce(jfn(x), jnp.asarray(LABELS)))(
        jnp.asarray(x01.numpy())))
    tfn = tattacks.make_logits_fn(port_specrnet(CFG_F32, variables))
    xt = x01.clone().requires_grad_(True)
    (gt,) = torch.autograd.grad(tattacks.two_class_ce(tfn(xt), torch.from_numpy(LABELS)), xt)
    rel = np.linalg.norm(gt.numpy() - gj) / np.linalg.norm(gj)
    assert rel <= 1e-4, rel


@pytest.mark.parametrize("name,override", [
    ("FGSM", None),
    ("PGD", {"steps": 2, "random_start": False}),
])
def test_deterministic_attacks_match_jax_f32(variables, name, override):
    x01, _, _ = tattacks.to_minmax(torch.from_numpy(waves(33)))
    x01 = x01.numpy()
    module, jvars = _jax(CFG_F32, variables)
    jatk = jattacks.build_attack(name, jattacks.make_logits_fn(module, jvars), override)
    adv_j = np.asarray(jatk(jnp.asarray(x01), jnp.asarray(LABELS), jax.random.PRNGKey(0)))
    tatk = tattacks.build_attack(name, tattacks.make_logits_fn(port_specrnet(CFG_F32, variables)),
                                 override)
    adv_t = tatk(torch.from_numpy(x01), torch.from_numpy(LABELS), None).numpy()
    assert np.mean(adv_j != x01) > 0.9
    agree = np.mean(np.abs(adv_t - adv_j) <= 1e-6)
    assert agree >= 0.99, agree


def test_weight_bridge_round_trip(variables):
    """The port's state_dict, read back by the JAX package's own torch
    importer, gives the same flax variables."""
    model = port_specrnet(CFG_F32, variables)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    module, jvars = _jax(CFG_F32, variables)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jvars)
    back = torch_import.import_state_dict("specrnet", sd, zeros)
    flat_a = jax.tree_util.tree_leaves_with_path(jvars)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf), err_msg=str(path))


def test_train_mode_updates_the_discarded_bn1_stats(variables):
    """The reference quirk: bn1 of the non-first blocks does not change the
    output, but its running statistics move in train()."""
    model = port_specrnet(CFG_F32, variables)
    before = model.block2[0].bn1.running_mean.clone()
    with torch.no_grad():
        z_eval = model(torch.from_numpy(waves(34)))
        model.block2[0].bn1.running_mean.add_(1.0)  # no effect on the eval output
        torch.testing.assert_close(model(torch.from_numpy(waves(34))), z_eval, rtol=0, atol=0)
        model.train()(torch.from_numpy(waves(34)))
    assert not torch.allclose(model.block2[0].bn1.running_mean, before + 1.0)
