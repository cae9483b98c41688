"""The JAX package's numerics switches in the port (CPU), each set with
``monkeypatch.setenv`` on both sides.

* the four max reductions under each eqmask setting, on inputs full of
  deliberate ties (small integers): forward and VJP bit-equal to JAX's
  in f32 (the eqmask backward gives g to every tied element; the
  switched-off one splits it evenly, as ``jnp.maximum`` / ``jnp.max`` do);
* LCNN (f32 and bf16), RawNet3 (f32 and bf16) and SpecRNet (f32) under
  each switch that reaches them: logits and the input gradient of the
  two-class CE against JAX's with the port's existing model-test bands
  (LCNN: f32 logits within 1e-4 x max |logit|, bf16 within 3e-4; RawNet3:
  f32 within 1e-5, bf16 within 1e-3; SpecRNet f32 within 1e-4 x max;
  gradients: relative L2 <= 1e-4 in f32 for LCNN and SpecRNet, cosine
  >= 0.99 for bf16 and for RawNet3, whose f32 gradient is noisy near the
  log of small sinc outputs). One band is set apart: the bf16 LCNN under
  ``ADAA_FOLD_BN=0`` rounds each of its six BN outputs to bf16, more ties
  form in the maxes, and its gradient is less stable: the port's own
  gradient moves to cosine 0.985-0.992 when the input is scaled by
  (1 + 2^-20), and port against JAX measures 0.981-0.988 (3 seeds), so
  that case is held to cosine >= 0.97. LCNN runs at 16,000 samples (the first
  block unfused on both sides) except under ``ADAA_FUSED_LCNN=0``, which
  is about the 64,600-sample shape; RawNet3 at 5,041 samples;
* the ``compute`` argument that reaches the frontend and the sinc conv
  under ``ADAA_BF16_FRONTEND``: the port's equals JAX's (on the CPU both
  compute in f32 whatever it says; the card checks the numbers);
* which path the bf16 LCNN takes under ``ADAA_FUSED_LCNN=0`` and
  ``ADAA_FOLD_BN=0`` with ``ADAA_FUSED_TRUNK=1``, through ``plain_ops``
  and spies on the plain versions of the kernels;
* the sinc filterbank's conv under ``ADAA_SINC_VJP=0`` and by default, in
  train mode: output, input gradient and filter-parameter gradients
  against JAX's ``ParamSincFB`` within 1e-5 relative (L2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaa_tpu.ops.frontends as jfrontends
import adaa_tpu.ops.sinc_conv as jsinc
from adaa_tpu import attacks as jattacks
from adaa_tpu import models as jmodels
from adaa_tpu.models import layers as jlayers
from adaa_tpu.models import rawnet3 as jrawnet3
from adaa_tpu_torch import attacks as tattacks
from adaa_tpu_torch.models import layers as tlayers
from adaa_tpu_torch.models import rawnet3 as trawnet3
from adaa_tpu_torch.ops import frontends as tfrontends
from adaa_tpu_torch.ops import layer0, trunk
from tests.torch_port_common import (CFG_BF16, CFG_F32, lcnn_variables, port_lcnn,
                                     port_rawnet3, port_specrnet, rawnet3_variables,
                                     specrnet_variables, waves)

torch.set_num_threads(2)

LABELS = np.array([0, 1])
OPS = {  # name -> (JAX op, port op, input shape)
    "max_feature_map": (jlayers.max_feature_map, tlayers.max_feature_map, (2, 3, 4, 8)),
    "max_pool_2d": (jlayers.max_pool_2d, tlayers.max_pool_2d, (2, 5, 7, 4)),
    "mfm_pool_2d": (jlayers.mfm_pool_2d, tlayers.mfm_pool_2d, (2, 5, 7, 8)),
    "max_pool_1d": (lambda x: jlayers.max_pool_1d(x, 3), lambda x: tlayers.max_pool_1d(x, 3),
                    (2, 11, 4)),
}
SWITCH_OF = {"max_feature_map": "ADAA_MFM_EQMASK", "mfm_pool_2d": "ADAA_MFM_EQMASK",
             "max_pool_2d": "ADAA_POOL_EQMASK", "max_pool_1d": "ADAA_POOL_EQMASK"}


@pytest.mark.parametrize("setting", ["1", "0"])
@pytest.mark.parametrize("name", list(OPS))
def test_ops_with_ties_equal_jax(name, setting, monkeypatch):
    monkeypatch.setenv(SWITCH_OF[name], setting)
    jop, top, shape = OPS[name]
    rng = np.random.default_rng(7)
    x = rng.integers(0, 3, shape).astype(np.float32)  # ties in every window
    yj, vjp = jax.vjp(jop, jnp.asarray(x))
    g = rng.standard_normal(yj.shape).astype(np.float32)
    (gj,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = top(xt)
    (gt,) = torch.autograd.grad(yt, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    split = (gt.numpy() != 0) & ~np.isin(gt.numpy(), g)  # a cotangent shared by ties
    assert split.any() == (setting == "0")


def _ce_and_grad_jax(name, cfg, variables, x):
    fn = jattacks.make_logits_fn(jmodels.get_model(name, cfg),
                                 jax.tree_util.tree_map(jnp.asarray, variables))
    y = jnp.asarray(LABELS)
    (_, z), g = jax.value_and_grad(
        lambda a: (lambda zz: (jattacks.two_class_ce(zz, y), zz))(fn(a)), has_aux=True)(
        jnp.asarray(x))
    return np.asarray(z), np.asarray(g)


def _ce_and_grad_port(model, x):
    fn = tattacks.make_logits_fn(model)
    xt = torch.from_numpy(x).requires_grad_(True)
    z = fn(xt)
    (g,) = torch.autograd.grad(tattacks.two_class_ce(z, torch.from_numpy(LABELS)), xt)
    return z.detach().numpy(), g.numpy()


def _check(zt, gt, zj, gj, logit_atol, grad):
    np.testing.assert_allclose(zt, zj, rtol=0, atol=logit_atol)
    kind, tol = grad
    if kind == "rel":
        rel = np.linalg.norm(gt - gj) / np.linalg.norm(gj)
        assert rel <= tol, rel
    else:
        cos = float((gt * gj).sum() / (np.linalg.norm(gt) * np.linalg.norm(gj)))
        assert cos >= tol, cos


@pytest.fixture(scope="module")
def lcnn_vars():
    return lcnn_variables(0)


LCNN_CASES = [  # (dtype, switch, wave length)
    ("f32", "ADAA_MFM_EQMASK", 16_000), ("f32", "ADAA_POOL_EQMASK", 16_000),
    ("bf16", "ADAA_FUSED_LCNN", 64_600), ("bf16", "ADAA_FOLD_BN", 16_000),
    ("bf16", "ADAA_BF16_FRONTEND", 16_000), ("bf16", "ADAA_MFM_EQMASK", 16_000),
    ("bf16", "ADAA_POOL_EQMASK", 16_000),
]


@pytest.mark.parametrize("dtype,switch,length", LCNN_CASES)
def test_lcnn_under_switch_matches_jax(lcnn_vars, dtype, switch, length, monkeypatch):
    monkeypatch.setenv(switch, "0")
    cfg = CFG_F32 if dtype == "f32" else CFG_BF16
    x = tattacks.to_minmax(torch.from_numpy(waves(40, 2, length)))[0].numpy()
    zj, gj = _ce_and_grad_jax("lcnn", cfg, lcnn_vars, x)
    zt, gt = _ce_and_grad_port(port_lcnn(cfg, lcnn_vars), x)
    if dtype == "f32":
        _check(zt, gt, zj, gj, 1e-4 * np.abs(zj).max(), ("rel", 1e-4))
    else:  # the unfolded trunk's own spread (module doc)
        _check(zt, gt, zj, gj, 3e-4, ("cos", 0.97 if switch == "ADAA_FOLD_BN" else 0.99))


@pytest.fixture(scope="module")
def rawnet3_vars():
    return rawnet3_variables(0)


@pytest.mark.parametrize("dtype,switch", [
    ("f32", "ADAA_SINC_VJP"), ("bf16", "ADAA_SINC_VJP"), ("bf16", "ADAA_BF16_FRONTEND"),
    ("bf16", "ADAA_POOL_EQMASK"),
])
def test_rawnet3_under_switch_matches_jax(rawnet3_vars, dtype, switch, monkeypatch):
    monkeypatch.setenv(switch, "0")
    cfg = {} if dtype == "f32" else {"compute_dtype": "bfloat16"}
    x = tattacks.to_minmax(torch.from_numpy(waves(41, 2, 5041)))[0].numpy()
    zj, gj = _ce_and_grad_jax("rawnet3", cfg, rawnet3_vars, x)
    zt, gt = _ce_and_grad_port(port_rawnet3(cfg, rawnet3_vars), x)
    _check(zt, gt, zj, gj, 1e-5 if dtype == "f32" else 1e-3, ("cos", 0.99))


def test_specrnet_under_pool_switch_matches_jax(monkeypatch):
    monkeypatch.setenv("ADAA_POOL_EQMASK", "0")
    variables = specrnet_variables(0)
    x = tattacks.to_minmax(torch.from_numpy(waves(42)))[0].numpy()
    zj, gj = _ce_and_grad_jax("specrnet", CFG_F32, variables, x)
    zt, gt = _ce_and_grad_port(port_specrnet(CFG_F32, variables), x)
    _check(zt, gt, zj, gj, 1e-4 * np.abs(zj).max(), ("rel", 1e-4))


def _spy(monkeypatch, module, name, seen):
    orig = getattr(module, name)

    def spy(*args, **kw):
        seen.append(kw.get("compute"))
        return orig(*args, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("setting", ["1", "0"])
def test_bf16_frontend_switch_sets_compute(lcnn_vars, rawnet3_vars, setting, monkeypatch):
    monkeypatch.setenv("ADAA_BF16_FRONTEND", setting)
    want = "bf16" if setting == "1" else "f32"
    seen_j, seen_t = [], []
    _spy(monkeypatch, jfrontends, "get_frontend", seen_j)
    _spy(monkeypatch, tfrontends, "get_frontend", seen_t)
    x = waves(43, 1, 16_000)
    jmodels.get_model("lcnn", CFG_BF16).apply(
        jax.tree_util.tree_map(jnp.asarray, lcnn_vars), jnp.asarray(x))
    with torch.no_grad():
        port_lcnn(CFG_BF16, lcnn_vars)(torch.from_numpy(x))
    assert seen_j == seen_t == [want]

    seen_j, seen_t = [], []
    _spy(monkeypatch, jsinc, "sinc_conv", seen_j)
    _spy(monkeypatch, trawnet3, "sinc_conv", seen_t)
    cfg = {"compute_dtype": "bfloat16"}
    x = waves(44, 1, 5041)
    jax.eval_shape(lambda v, a: jmodels.get_model("rawnet3", cfg).apply(v, a),
                   jax.tree_util.tree_map(jnp.asarray, rawnet3_vars), jnp.asarray(x))
    with torch.no_grad():
        port_rawnet3(cfg, rawnet3_vars)(torch.from_numpy(x))
    assert seen_j == seen_t == [want]


@pytest.mark.parametrize("env,want", [
    ({}, {"layer0": 1, "trunk": 0}),
    ({"ADAA_FUSED_TRUNK": "1"}, {"layer0": 1, "trunk": 2}),
    ({"ADAA_FUSED_LCNN": "0"}, {"layer0": 0, "trunk": 0}),
    ({"ADAA_FUSED_LCNN": "0", "ADAA_FUSED_TRUNK": "1"}, {"layer0": 0, "trunk": 2}),
    ({"ADAA_FOLD_BN": "0", "ADAA_FUSED_TRUNK": "1"}, {"layer0": 1, "trunk": 0}),
])
def test_kernel_gating_under_switches(lcnn_vars, env, want, monkeypatch):
    """Which plain versions of the kernels the bf16 LCNN runs (plain_ops),
    and under ADAA_FOLD_BN=0 that the unfolded BNs run instead."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = {"layer0": 0, "trunk": 0, "bn": 0}
    for mod, name, key in ((layer0, "fused_conv0_mfm_pool_reference", "layer0"),
                           (trunk, "fused_segment_reference", "trunk"),
                           (tlayers, "batch_norm", "bn")):
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    model = port_lcnn(CFG_BF16, lcnn_vars)
    model.plain_ops = True
    with torch.no_grad():
        z = model(torch.from_numpy(waves(45, 1)))
    assert bool(torch.isfinite(z).all())
    assert calls == {**want, "bn": 6 if env.get("ADAA_FOLD_BN") == "0" else 0}


@pytest.mark.parametrize("setting", ["0", "1"])
def test_sinc_filter_gradient_in_training_matches_jax(setting, monkeypatch):
    monkeypatch.setenv("ADAA_SINC_VJP", setting)
    rng = np.random.default_rng(46)
    x = rng.standard_normal((2, 1001)).astype(np.float32)
    low, band = trawnet3._sinc_init_hz(128, 8000.0, 50.0, 50.0)
    low = low * rng.uniform(0.9, 1.1, low.shape).astype(np.float32)
    params = {"low_hz_": low[:, None], "band_hz_": band[:, None]}
    module = jrawnet3.ParamSincFB(n_filters=256, kernel_size=251, stride=10)
    yj, vjp = jax.vjp(lambda p, a: module.apply({"params": p}, a[:, :, None], train=True),
                      jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    g = rng.standard_normal(yj.shape).astype(np.float32)
    dpj, dxj = vjp(jnp.asarray(g))

    fb = trawnet3.ParamSincFB(256, 251, stride=10)
    with torch.no_grad():
        fb.low_hz_.copy_(torch.from_numpy(params["low_hz_"]))
        fb.band_hz_.copy_(torch.from_numpy(params["band_hz_"]))
    fb.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = fb(xt)
    yt.backward(torch.from_numpy(g))

    def rel(a, b):
        return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))

    assert rel(yt.detach().numpy(), yj) <= 1e-5
    assert rel(xt.grad.numpy(), dxj) <= 1e-5
    assert rel(fb.low_hz_.grad.numpy(), dpj["low_hz_"]) <= 1e-5
    assert rel(fb.band_hz_.grad.numpy(), dpj["band_hz_"]) <= 1e-5
