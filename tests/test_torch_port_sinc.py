"""The sinc-filterbank conv's forward and closed-form dx against the JAX op (CPU).

* f32 (what a CPU tensor computes, whatever ``compute`` asks): forward
  and dx within 1e-5 x their largest magnitude (measured: forward equal,
  dx <= 1.9e-7): the same products summed in f32 in other orders.
* the bf16 rounding points, run on the CPU through the Function itself
  against the JAX op's bf16 variant, ``_sinc_conv_fn`` (which JAX runs on
  the CPU too):
  forward and dx within 1e-5 x max (measured equal): both sum exact bf16
  products in f32 and store the frame buffer in bf16, so only a frame
  value summed in another order could round to the neighbouring bf16
  value.
* the filter gradient raises, in the op and in the backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu.ops import sinc_conv as jsinc
from adaa_tpu_torch.ops import sinc_conv as tsinc

torch.set_num_threads(2)


def _data(seed: int, l: int, k: int, n_filt: int = 6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, l)).astype(np.float32)
    w = (rng.standard_normal((n_filt, k)) * 0.1).astype(np.float32)
    return x, w


def _jax(fn, x, w):
    out, vjp = jax.vjp(lambda a: fn(a, jnp.asarray(w)), jnp.asarray(x))
    g = np.random.default_rng(1).standard_normal(out.shape).astype(np.float32)
    (dx,) = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dx), g


def _port(fn, x, w, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(xt, torch.from_numpy(w))
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    return out.detach().numpy(), dx.numpy()


def _close(a, b, tol):
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= tol, err


@pytest.mark.parametrize("stride,k,l", [(10, 251, 2000), (10, 251, 2007), (7, 33, 500),
                                        (16, 16, 512)])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_f32_matches_jax(stride, k, l, compute):
    x, w = _data(stride + l, l, k)
    jout, jdx, g = _jax(lambda a, b: jsinc.sinc_conv(a, b, stride, need_dw=False,
                                                     compute=compute), x, w)
    out, dx = _port(lambda a, b: tsinc.sinc_conv(a, b, stride, compute=compute), x, w, g)
    assert out.shape == jout.shape == (3, (l - k) // stride + 1, 6)
    _close(out, jout, 1e-5)
    _close(dx, jdx, 1e-5)


def test_bf16_rounding_points_match_jax():
    x, w = _data(3, 1200, 251, 8)
    jout, jdx, g = _jax(jsinc._sinc_conv_fn(10, False, "bf16"), x, w)
    out, dx = _port(lambda a, b: tsinc._SincConv.apply(a, b, 10, True), x, w, g)
    _close(out, jout, 1e-5)
    _close(dx, jdx, 1e-5)
    f32_dx = _port(lambda a, b: tsinc._SincConv.apply(a, b, 10, False), x, w, g)[1]
    assert not np.array_equal(dx, f32_dx)  # the bf16 path does round


def test_filter_gradient_raises():
    x, w = (torch.from_numpy(a) for a in _data(4, 600, 251))
    with pytest.raises(NotImplementedError):
        tsinc.sinc_conv(x, w, 10, need_dw=True)
    out = tsinc.sinc_conv(x.requires_grad_(True), w.requires_grad_(True), 10)
    with pytest.raises(RuntimeError, match="need_dw=False"):
        out.sum().backward()
    with pytest.raises(ValueError):
        tsinc.sinc_conv(x[:, :100], w, 10)
