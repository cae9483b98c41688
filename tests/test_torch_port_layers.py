"""adaa_tpu_torch.models.layers vs adaa_tpu.models.layers (CPU).

* MFM / max pool / MFM+pool: inputs with deliberate ties (small
  integers), forward and equality-mask backward bit-exact in f32 and
  bf16 — the same comparisons and selects, no arithmetic.
* BiLSTM: f32, outputs within 1e-5 absolute and input gradients within
  1e-5 relative L2 — the same recurrence, summed in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from adaa_tpu.models import layers as jl
from adaa_tpu_torch.models import layers as tl

torch.set_num_threads(2)

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _tied(seed, shape):
    return np.random.default_rng(seed).integers(-2, 3, shape).astype(np.float32)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("name,shape", [
    ("max_feature_map", (2, 6, 5, 8)),
    ("max_pool_2d", (2, 7, 5, 6)),
    ("mfm_pool_2d", (2, 7, 5, 8)),
])
def test_eqmask_max_ops_bit_exact_with_ties(name, shape, jdt, tdt):
    x = _tied(0, shape)
    jfn, tfn = getattr(jl, name), getattr(tl, name)
    jy, jvjp = jax.vjp(jfn, jnp.asarray(x).astype(jdt))
    cot = np.random.default_rng(1).standard_normal(jy.shape).astype(np.float32)
    (jdx,) = jvjp(jnp.asarray(cot).astype(jdt))

    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    ty = tfn(xt)
    (tdx,) = torch.autograd.grad(ty, xt, torch.from_numpy(cot).to(tdt))
    assert ty.dtype == tdt and tdx.dtype == tdt
    # ties do occur, and every tied element got the whole cotangent
    assert (np.asarray(jdx.astype(jnp.float32)) != 0).sum() > np.prod(jy.shape)
    np.testing.assert_array_equal(ty.float().detach().numpy(), np.asarray(jy.astype(jnp.float32)))
    np.testing.assert_array_equal(tdx.float().numpy(), np.asarray(jdx.astype(jnp.float32)))


def _lstm_params(rng, d, h):
    b = 1 / np.sqrt(h)
    u = lambda *s: rng.uniform(-b, b, s).astype(np.float32)
    return {dr: {"weight_ih": u(d, 4 * h), "weight_hh": u(h, 4 * h),
                 "bias_ih": u(4 * h), "bias_hh": u(4 * h)} for dr in ("fwd", "bwd")}


def _load_port(module, params):
    with torch.no_grad():
        for sfx, dr in (("l0", "fwd"), ("l0_reverse", "bwd")):
            p = params[dr]
            getattr(module, f"weight_ih_{sfx}").copy_(torch.from_numpy(p["weight_ih"].T.copy()))
            getattr(module, f"weight_hh_{sfx}").copy_(torch.from_numpy(p["weight_hh"].T.copy()))
            getattr(module, f"bias_ih_{sfx}").copy_(torch.from_numpy(p["bias_ih"]))
            getattr(module, f"bias_hh_{sfx}").copy_(torch.from_numpy(p["bias_hh"]))
    return module


def test_bilstm_matches_jax_and_nn_lstm():
    rng = np.random.default_rng(2)
    bsz, t, d, h = 3, 9, 12, 5
    params = _lstm_params(rng, d, h)
    x = rng.standard_normal((bsz, t, d)).astype(np.float32)
    cot = rng.standard_normal((bsz, t, 2 * h)).astype(np.float32)

    jy, jvjp = jax.vjp(lambda xx: jl.BiLSTM(h).apply({"params": params}, xx), jnp.asarray(x))
    (jdx,) = jvjp(jnp.asarray(cot))

    port = _load_port(tl.BiLSTM(d, h), params)
    xt = torch.from_numpy(x).requires_grad_(True)
    ty = port(xt)
    (tdx,) = torch.autograd.grad(ty, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    jdx = np.asarray(jdx)
    assert np.linalg.norm(tdx.numpy() - jdx) / np.linalg.norm(jdx) < 1e-5

    # same parameter names and function as torch's own bidirectional LSTM
    ref = nn.LSTM(d, h, bidirectional=True, batch_first=True)
    assert {k for k, _ in ref.named_parameters()} == {k for k, _ in port.named_parameters()}
    ref.load_state_dict(port.state_dict())
    np.testing.assert_allclose(ref(xt)[0].detach().numpy(), ty.detach().numpy(), rtol=0, atol=1e-5)


def test_initialisers_bounds_and_generator():
    conv = torch.empty(64, 32, 3, 3)
    gen = torch.Generator().manual_seed(0)
    tl.kaiming_uniform_conv(conv, gen)
    bound = np.sqrt(2.0 / 6.0) * np.sqrt(3.0 / (32 * 9))
    assert float(conv.abs().max()) <= bound and float(conv.abs().max()) > 0.95 * bound
    again = tl.kaiming_uniform_conv(torch.empty(64, 32, 3, 3), torch.Generator().manual_seed(0))
    torch.testing.assert_close(conv, again, rtol=0, atol=0)
    lin = tl.kaiming_uniform_linear(torch.empty(1, 160), gen)
    assert float(lin.abs().max()) <= np.sqrt(2.0 / 6.0) * np.sqrt(3.0 / 160)
    b = tl.conv_bias_init(torch.empty(1000), 160, gen)
    assert float(b.abs().max()) <= 1 / np.sqrt(160)
