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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu import models as jmodels
from adaa_tpu_torch.models import lcnn as tlcnn
from adaa_tpu_torch.ops import layer0
from tests.torch_port_common import CFG_BF16, CFG_F32, lcnn_variables, port_lcnn, waves

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
        model.conv0_reference = True
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
