"""adaa_tpu_torch.ops frontends vs adaa_tpu.ops (CPU, f32).

Tolerances:
* filterbank / DCT matrices: bit-equal (the same float64 numpy code).
* LFCC / MFCC values: rtol 1e-5, atol 1e-3 dB — both sides are f32; the
  windowed DFT is a strided conv in JAX and a frames x matrix product
  here, so only the summation order differs.
* input gradient: relative L2 error < 1e-4 — autograd through unfold +
  matmul against the JAX closed-form STFT VJP, f32 throughout.
* mel_spec: the magnitude within 1e-5 relative (atol 1e-5 x the largest
  magnitude); the phase only where the magnitude exceeds 1e-3 of its
  row's maximum, within 1e-4 rad (atan2 of two near-zero projections
  turns summation-order noise into any angle); the input gradient of a
  random projection of the magnitude within 1e-4 relative L2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu.ops import filterbanks as jfb
from adaa_tpu.ops import frontends as jfe
from adaa_tpu.ops import stft as jstft
from adaa_tpu_torch.ops import filterbanks as tfb
from adaa_tpu_torch.ops import frontends as tfe
from adaa_tpu_torch.ops import stft as tstft
from tests.torch_port_common import waves

torch.set_num_threads(2)


@pytest.mark.parametrize("name,args", [
    ("linear_fbanks", (257, 0.0, 8000.0, 128, 16000)),
    ("melscale_fbanks", (257, 0.0, 8000.0, 128, 16000, None, "htk")),
    ("melscale_fbanks", (257, 0.0, 8000.0, 80, 16000, "slaney", "htk")),
    ("create_dct", (80, 128, "ortho")),
    ("create_dct", (20, 40, None)),
])
def test_constant_matrices_bit_equal(name, args):
    np.testing.assert_array_equal(getattr(tfb, name)(*args), getattr(jfb, name)(*args))


def test_dft_kernel_and_window_bit_equal():
    np.testing.assert_array_equal(tstft.hann_window(400), jstft.hann_window(400))
    for kind in ("hann", "ones"):
        np.testing.assert_array_equal(tstft._dft_kernel(512, 400, kind),
                                      jstft._dft_kernel(512, 400, kind))
    assert tstft.frame_count(64_600, 512, 160) == jstft.frame_count(64_600, 512, 160) == 404


def test_stft_matches_jax():
    x = waves(1, 2, 4_000)
    tr, ti = tstft.stft(torch.from_numpy(x))
    jr, ji = jstft.stft(jnp.asarray(x))
    scale = float(np.abs(np.asarray(jr)).max())
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("name", ["lfcc", "mfcc"])
def test_cepstra_values_and_input_gradient(name):
    x = waves(2)
    cot = np.random.default_rng(3).standard_normal((2, 80, 404)).astype(np.float32)
    jfn = getattr(jfe, name)
    tfn = getattr(tfe, name)

    jout, jvjp = jax.vjp(jfn, jnp.asarray(x))
    (jgrad,) = jvjp(jnp.asarray(cot))

    xt = torch.from_numpy(x).requires_grad_(True)
    tout = tfn(xt)
    (tgrad,) = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(), xt)

    assert tout.shape == (2, 80, 404) and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-3)
    jg = np.asarray(jgrad)
    rel = np.linalg.norm(tgrad.numpy() - jg) / np.linalg.norm(jg)
    assert rel < 1e-4, rel


def test_bf16_compute_falls_back_to_f32_on_cpu():
    x = torch.from_numpy(waves(4, 1, 8_000))
    np.testing.assert_array_equal(tfe.lfcc(x, compute="bf16").numpy(), tfe.lfcc(x).numpy())


def test_get_frontend_dispatch():
    assert tfe.get_frontend(["lfcc"]).func is tfe.lfcc
    assert tfe.get_frontend(["mfcc", "lfcc"]).func is tfe.mfcc
    assert tfe.get_frontend(["mel_spec"]) is tfe.mel_spec
    with pytest.raises(ValueError):
        tfe.get_frontend(["cqt"])


def test_mel_spec_matches_jax():
    x = waves(5, 2, 16_000)
    jout = np.asarray(jfe.mel_spec(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    tout = tfe.mel_spec(xt)
    assert tout.shape == jout.shape == (2, 2, 80, 101) and tout.dtype == torch.float32
    t, j = tout.detach().numpy(), jout
    np.testing.assert_allclose(t[:, 0], j[:, 0], rtol=1e-5, atol=1e-5 * np.abs(j[:, 0]).max())
    live = j[:, 0] > 1e-3 * j[:, 0].max(axis=-1, keepdims=True)
    assert live.mean() > 0.9
    dphase = np.angle(np.exp(1j * (t[:, 1] - j[:, 1])))  # wrapped to (-pi, pi]
    assert np.abs(dphase[live]).max() <= 1e-4

    proj = np.random.default_rng(6).standard_normal(j[:, 0].shape).astype(np.float32)
    gj = np.asarray(jax.grad(lambda a: (jfe.mel_spec(a)[:, 0] * proj).sum())(jnp.asarray(x)))
    (gt,) = torch.autograd.grad((tout[:, 0] * torch.from_numpy(proj)).sum(), xt)
    rel = np.linalg.norm(gt.numpy() - gj) / np.linalg.norm(gj)
    assert rel < 1e-4, rel
