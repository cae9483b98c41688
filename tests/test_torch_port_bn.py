"""Train-mode BatchNorm of the port against flax's (CPU).

flax's ``nn.BatchNorm`` (``adaa_tpu/models/layers.py:torch_batch_norm``)
reduces the batch statistics in f32, normalises with the *biased*
variance ``max(0, E[x^2] - E[x]^2)`` and updates its running variance
with that same biased value (momentum 0.9). torch's ``nn.BatchNorm*d``
would update it with the unbiased one, a factor n / (n - 1) apart.

* one BN layer, f32 and bf16 inputs, with and without affine: the
  running statistics after one train-mode call within 1e-6 x max(1,
  max |value|); the train- and eval-mode outputs within 1e-6 of that in
  f32 and equal in bf16 (both reduce and normalise in f32 and round once);
* LCNN, SpecRNet and RawNet3 (f32, batch 2): every BN's running mean and
  variance after one train-mode forward against the JAX model's
  ``batch_stats``, relative to max(1, max |value|): LCNN and SpecRNet
  within 1e-6 (measured 3.8e-7, 8.6e-7: the same f32 sums in other
  orders), RawNet3 within 5e-5 (measured 1.2e-5: its BN inputs already
  differ by that much, as the log of the sinc outputs amplifies the
  encoder's summation-order noise; its eval logits agree to ~6e-6
  relative, tests/test_torch_port_rawnet3.py). torch's unbiased update
  would be off by 0.1 x var / (n - 1), >= 3e-4 relative in every BN here,
  and the parent's RawNet3 did not update its statistics at all;
* the bf16 models in train mode: the dtype each BN returns, against
  flax's captured intermediates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu import models as jmodels
from adaa_tpu.models import layers as jlayers
from adaa_tpu_torch.models import layers as tlayers
from adaa_tpu_torch.models.weights import (lcnn_state_dict_from_flax,
                                           rawnet3_state_dict_from_flax,
                                           specrnet_state_dict_from_flax)
from tests.torch_port_common import (CFG_BF16, CFG_F32, lcnn_variables, port_lcnn,
                                     port_rawnet3, port_specrnet, rawnet3_variables,
                                     specrnet_variables, waves)

torch.set_num_threads(2)

RAWNET3_L = 1741  # T = 150 after the encoder (pools of 5 and 3 divide it)
MODELS = {
    # name: (variables, port model, state_dict bridge, wave length, f32 config,
    #        running-stat tolerance)
    "lcnn": (lcnn_variables, port_lcnn, lcnn_state_dict_from_flax, 16_000, CFG_F32, 1e-6),
    "specrnet": (specrnet_variables, port_specrnet, specrnet_state_dict_from_flax, 16_000,
                 CFG_F32, 1e-6),
    "rawnet3": (rawnet3_variables, port_rawnet3, rawnet3_state_dict_from_flax, RAWNET3_L, {},
                5e-5),
}


def _close(got, want, tol=1e-6, what=""):
    """max |got - want| within ``tol`` x max(1, max |want|)."""
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, (what, float(err))


@pytest.mark.parametrize("affine", [False, True], ids=["no_affine", "affine"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_flax(affine, dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 5, 3, 8)) * 2.0 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, 8).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    xj = jnp.asarray(x).astype(jdt or jnp.float32)
    module = jlayers.torch_batch_norm(affine=affine, dtype=jdt)
    jvars = module.init(jax.random.PRNGKey(0), xj, use_running_average=True)
    if affine:
        jvars = {**jvars, "params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    yj, mutated = module.apply(jvars, xj, use_running_average=False, mutable=["batch_stats"])
    y_eval_j = module.apply({**jvars, **mutated}, xj, use_running_average=True)

    bn = torch.nn.BatchNorm2d(8, affine=affine)
    if affine:
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(tdt or torch.float32)
    yt = tlayers.batch_norm(bn.train(), xt, tdt)
    y_eval_t = tlayers.batch_norm(bn.eval(), xt, tdt)
    assert str(yt.dtype).removeprefix("torch.") == str(yj.dtype) == (dtype if jdt else "float32")
    stats = mutated["batch_stats"]
    _close(bn.running_mean.numpy(), np.asarray(stats["mean"]), what="mean")
    _close(bn.running_var.numpy(), np.asarray(stats["var"]), what="var")
    assert int(bn.num_batches_tracked) == 0
    for got, want in ((yt, yj), (y_eval_t, y_eval_j)):
        got, want = got.detach().float().numpy(), np.asarray(want.astype(jnp.float32))
        if tdt is None:
            _close(got, want, what="y")
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(MODELS))
def test_running_stats_after_train_forward_match_jax(name):
    make_vars, port, bridge, length, cfg, tol = MODELS[name]
    variables = make_vars(0)
    x = waves(40, 2, length)
    module = jmodels.get_model(name, cfg)
    _, mutated = module.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x),
                              train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(1)})
    want = bridge({"params": variables["params"],
                   "batch_stats": jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])})
    model = port(cfg, variables).train()
    with torch.no_grad():
        model(torch.from_numpy(x))
    got = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))
            and not k.startswith("bn6.")]  # RawNet3's bn6 is unused (no output BN)
    assert len(keys) == {"lcnn": 12, "specrnet": 14, "rawnet3": 58}[name]
    for k in keys:
        _close(got[k].numpy(), want[k].numpy(), tol, what=k)
        assert not torch.equal(got[k], bridge(variables)[k]), k  # the stats moved


def _flax_bn_name(name: str, port_name: str) -> str:
    """The flax module path of the port's BN module ``port_name``."""
    if name == "lcnn":
        return "bn" + port_name.split(".")[-1]
    parts = port_name.split(".")
    if name == "specrnet":
        return "/".join(p for p in parts if p != "0")
    if parts[0] == "attention":
        return "attention_2"
    if len(parts) == 3 and parts[1] == "bns":
        return f"{parts[0]}/bns_{parts[2]}"
    return "/".join(parts)


def _bn_dtypes(tree, prefix=""):
    """flax's captured BN outputs (modules named bn*/first_bn/attention_2)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if k == "__call__":
            leaf = prefix.split("/")[-1]
            if leaf.startswith(("bn", "first_bn")) or leaf == "attention_2":
                out[prefix] = str(v[0].dtype)
        elif isinstance(v, dict):
            out.update(_bn_dtypes(v, path))
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_train_dtype_flow_matches_jax(name, monkeypatch):
    make_vars, port, _, length, _, _ = MODELS[name]
    cfg = CFG_BF16 if name != "rawnet3" else {"compute_dtype": "bfloat16"}
    variables = make_vars(0)
    x = waves(41, 2, length)
    module = jmodels.get_model(name, cfg)
    _, state = module.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x),
                            train=True, capture_intermediates=True,
                            mutable=["intermediates", "batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(1)})
    want = _bn_dtypes(state["intermediates"])

    model = port(cfg, variables).train()
    names = {id(m): n for n, m in model.named_modules()}
    got = {}
    bn = tlayers.batch_norm

    def recorded(m, h, dtype=None):
        y = bn(m, h, dtype)
        got[_flax_bn_name(name, names[id(m)])] = str(y.dtype).removeprefix("torch.")
        return y

    monkeypatch.setattr(tlayers, "batch_norm", recorded)
    with torch.no_grad():
        model(torch.from_numpy(x))
    assert got == want
    assert "bfloat16" in want.values()
