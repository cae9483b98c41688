"""The port's LCNN vs the JAX LCNN on shared weights, (2, 64600) waves (CPU).

BN running stats are randomised (tests/torch_port_common.py), so the
bf16 path's BN folding is exercised.

Tolerances:
* f32: within 1e-4 x max |logit| (measured: <= 6e-7 relative over 3
  seeds) — same f32 math, other summation orders.
* bf16: within 3e-4 absolute (measured: <= 9.3e-5 over 4 seeds, while
  the JAX model's own bf16-vs-f32 gap reaches 7e-4). Both round to bf16
  at the same places (conv store, then bias add) but sum in other
  orders, and near-ties in the maxes can pick other winners.
* fused configuration (fused LFCC + fused trunk segments, both switches
  on in JAX with the LFCC kernel in interpret mode): the same 3e-4 bf16
  band.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu import models as jmodels
from adaa_tpu_torch.models import lcnn as tlcnn
import adaa_tpu.ops.pallas_lfcc as jpallas_lfcc
from adaa_tpu_torch.ops import layer0, lfcc_fused, trunk
from tests.torch_port_common import (CFG_BF16, CFG_F32, CFG_FUSED, lcnn_variables,
                                     port_lcnn, waves)

torch.set_num_threads(2)

BF16_LOGIT_ATOL = 3e-4


@pytest.fixture(scope="module")
def variables():
    return lcnn_variables(0)


def _jax_logits(cfg, variables, x):
    module = jmodels.get_model("lcnn", cfg)
    return np.asarray(module.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                                   jnp.asarray(x)))


def test_f32_logits_match_jax(variables):
    x = waves(10)
    zj = _jax_logits(CFG_F32, variables, x)
    with torch.no_grad():
        zt = port_lcnn(CFG_F32, variables)(torch.from_numpy(x))
    assert zt.shape == (2, 1) and zt.dtype == torch.float32
    np.testing.assert_allclose(zt.numpy(), zj, rtol=0, atol=1e-4 * np.abs(zj).max())


def test_bf16_logits_match_jax_through_fused_first_block(variables, monkeypatch):
    calls = []
    fused = layer0.fused_conv0_mfm_pool

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return fused(*args, **kw)

    monkeypatch.setattr(layer0, "fused_conv0_mfm_pool", counted)
    x = waves(10)
    zj = _jax_logits(CFG_BF16, variables, x)
    model = port_lcnn(CFG_BF16, variables)
    with torch.no_grad():
        zt = model(torch.from_numpy(x))
        model.plain_ops = True
        z_twin = model(torch.from_numpy(x))
    assert calls == [(2, 404, 80)]  # the fast path went through the fused op
    assert zt.shape == (2, 1) and zt.dtype == torch.float32
    np.testing.assert_allclose(zt.numpy(), zj, rtol=0, atol=BF16_LOGIT_ATOL)
    torch.testing.assert_close(z_twin, zt, rtol=0, atol=0)  # CPU: the wrapper is the twin


@pytest.mark.parametrize("conv_key,bn_key,pooled", [c for c in tlcnn.TRUNK if c[1]])
def test_bn_folding_equals_unfolded_bn(variables, conv_key, bn_key, pooled):
    """Each eval-mode BN folded into its conv gives the BN path's values
    (checked in f32, where bf16 rounding cannot hide a wrong fold)."""
    model = port_lcnn(CFG_F32, variables)
    cin = tlcnn.CONVS[conv_key][0]
    h = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 6, 4, cin)).astype(np.float32))
    conv = model.m_transform[conv_key]
    with torch.no_grad():
        y = tlcnn._conv_nhwc(h, *model._folded(conv_key, bn_key))
        folded = tlcnn.layers.mfm_pool_2d(y) if pooled else tlcnn.layers.max_feature_map(y)
        ref = tlcnn.layers.max_feature_map(tlcnn._conv_nhwc(h, conv.weight, conv.bias))
        if pooled:
            ref = tlcnn.layers.max_pool_2d(ref)
        ref = model._bn(bn_key, ref)
    torch.testing.assert_close(folded, ref, rtol=1e-5, atol=1e-5)


@pytest.fixture
def jax_fused_switches(monkeypatch):
    """The JAX package's two switches on, its LFCC kernel in interpret mode
    (its trunk kernels take interpret mode on the CPU themselves)."""
    monkeypatch.setenv("ADAA_PALLAS_FRONTEND", "1")
    monkeypatch.setenv("ADAA_FUSED_TRUNK", "1")
    orig = jpallas_lfcc.lfcc_pallas
    monkeypatch.setattr(jpallas_lfcc, "lfcc_pallas",
                        lambda x, interpret=False: orig(x, interpret=True))


def test_fused_configuration_logits_match_jax(variables, jax_fused_switches, monkeypatch):
    calls = []
    for mod, name in ((lfcc_fused, "cepstra_fused"), (trunk, "fused_segment")):
        orig = getattr(mod, name)

        def counted(*args, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, name, counted)
    x = waves(11)
    zj = _jax_logits(CFG_BF16, variables, x)
    model = port_lcnn(CFG_FUSED, variables)
    with torch.no_grad():
        zt = model(torch.from_numpy(x))
        model.plain_ops = True
        z_plain = model(torch.from_numpy(x))
    assert calls == ["cepstra_fused", "fused_segment", "fused_segment"]
    np.testing.assert_allclose(zt.numpy(), zj, rtol=0, atol=BF16_LOGIT_ATOL)
    torch.testing.assert_close(z_plain, zt, rtol=0, atol=0)  # CPU: the wrappers are plain


def test_fused_switches_read_the_environment(variables, monkeypatch):
    """None reads ADAA_PALLAS_FRONTEND / ADAA_FUSED_TRUNK per call, as the
    JAX model does; the f32 and highest-precision paths never fuse the trunk."""
    segments = []
    orig = trunk.fused_segment
    monkeypatch.setattr(trunk, "fused_segment",
                        lambda *a, **k: segments.append(a[-1]) or orig(*a, **k))
    x = torch.from_numpy(waves(12, 1))
    model = port_lcnn(CFG_BF16, variables)
    assert model.fused_trunk is None and model.fused_frontend is None
    monkeypatch.setenv("ADAA_FUSED_TRUNK", "1")
    with torch.no_grad():
        model(x)
        assert segments == [trunk.SEGMENT_A, trunk.SEGMENT_B]
        monkeypatch.setenv("ADAA_FUSED_TRUNK", "0")
        model(x)
        port_lcnn({**CFG_F32, "fused_trunk": True}, variables)(x)
    assert len(segments) == 2


def test_highest_precision_convs_keep_tf32_off_in_backward(variables, monkeypatch):
    """precision="highest": each trunk conv enters the TF32-off context in
    its forward and again in its backward, and its gradient is autograd's."""
    entered = []
    orig = layer0.ieee_f32

    def recording():
        entered.append(torch.is_grad_enabled())
        return orig()

    monkeypatch.setattr(layer0, "ieee_f32", recording)
    model = port_lcnn({**CFG_F32, "precision": "highest"}, variables)
    model.requires_grad_(False)
    x = torch.from_numpy(waves(13, 1)).requires_grad_(True)
    (g_exact,) = torch.autograd.grad(model(x).sum(), x)
    n_convs = len(tlcnn.CONVS)
    assert len(entered) == 2 * n_convs  # forward and backward of every conv
    model.precision = None
    (g_plain,) = torch.autograd.grad(model(x).sum(), x)
    assert len(entered) == 2 * n_convs
    torch.testing.assert_close(g_exact, g_plain, rtol=1e-6, atol=0)


def test_set_seed_defaults_to_the_card():
    import inspect

    from adaa_tpu_torch.utils import set_seed

    assert inspect.signature(set_seed).parameters["device"].default == "cuda"
    assert set_seed(3, "cpu").device.type == "cpu"
