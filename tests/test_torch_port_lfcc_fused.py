"""The fused LFCC / MFCC op: plain-torch version vs the Pallas kernel
(the CUDA kernel vs the plain version is tests/test_torch_port_gpu.py).

On the CPU the port's op runs its plain version; the JAX op runs its
Pallas kernel in interpret mode, as tests/test_pallas_lfcc.py runs it.

Tolerances:
* values: atol 5e-4 + rtol 1e-4 dB, tests/test_pallas_lfcc.py's band
  for its own kernel against the unfused path: every product is f32 on
  both sides, and only the summation order differs;
* input gradient: relative L2 < 1e-4, as tests/test_torch_port_frontend.py
  holds the unfused gradient (both recompute through the unfused f32
  path: autograd through unfold + matmul here, the closed-form STFT VJP
  in JAX);
* the kernel's packed constants: the power spectrum they reassemble
  within 1e-6 x its max (f32 matrix entries, float64 sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaa_tpu.ops.pallas_lfcc as pk
from adaa_tpu.ops import frontends as jfe
from adaa_tpu_torch.ops import frontends as tfe
from adaa_tpu_torch.ops import lfcc_fused, stft
from tests.torch_port_common import lfcc_fft_power, waves

torch.set_num_threads(2)


@pytest.fixture
def interpret_pallas_lfcc(monkeypatch):
    """JAX's fused LFCC switch on, its Pallas forward in interpret mode."""
    monkeypatch.setenv("ADAA_PALLAS_FRONTEND", "1")
    orig = pk.lfcc_pallas
    monkeypatch.setattr(pk, "lfcc_pallas", lambda x, interpret=False: orig(x, interpret=True))


@pytest.mark.parametrize("kind", lfcc_fused.FILTERBANKS)
def test_plain_matches_pallas_kernel(kind):
    x = waves(40 + len(kind))
    jfn = pk.lfcc_pallas if kind == "linear" else pk.mfcc_pallas
    ref = np.asarray(jfn(jnp.asarray(x), interpret=True))
    fn = lfcc_fused.lfcc_fused if kind == "linear" else lfcc_fused.mfcc_fused
    out = fn(torch.from_numpy(x))
    assert out.shape == (2, 80, 404) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4, rtol=1e-4)


def test_wrapper_gradient_matches_jax(interpret_pallas_lfcc):
    """The fused path's value and its input gradient (recomputed through
    the unfused f32 path on both sides) against JAX's under its switch."""
    x = waves(41, 1)
    cot = np.random.default_rng(42).standard_normal((1, 80, 404)).astype(np.float32)
    jval, jvjp = jax.vjp(jfe.lfcc, jnp.asarray(x))
    (jdx,) = jvjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    val = tfe.lfcc(xt, fused=True)
    (dx,) = torch.autograd.grad(val, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval), atol=5e-4, rtol=1e-4)
    jdx = np.asarray(jdx)
    rel = np.linalg.norm(dx.numpy() - jdx) / np.linalg.norm(jdx)
    assert rel < 1e-4, rel


def test_frontend_dispatch(monkeypatch):
    """The switch, as the JAX lfcc has it: the keyword, else the
    environment per call; only the canonical shape and coefficients; the
    fused path ignores ``compute``; mfcc never takes it."""
    calls = []
    orig = lfcc_fused.cepstra_fused

    def counted(x, filterbank="linear"):
        calls.append(filterbank)
        return orig(x, filterbank)

    monkeypatch.setattr(lfcc_fused, "cepstra_fused", counted)
    x = torch.from_numpy(waves(43))
    monkeypatch.delenv("ADAA_PALLAS_FRONTEND", raising=False)
    tfe.lfcc(x)
    assert calls == []
    monkeypatch.setenv("ADAA_PALLAS_FRONTEND", "1")
    fused = tfe.lfcc(x, compute="bf16")
    assert calls == ["linear"]
    tfe.lfcc(x, fused=False)
    tfe.lfcc(x, n_lfcc=40)
    tfe.lfcc(x[:, :32_000])
    tfe.lfcc(x[None])
    tfe.mfcc(x)
    tfe.get_frontend(["mfcc"])(x)
    assert calls == ["linear"]
    monkeypatch.setenv("ADAA_PALLAS_FRONTEND", "0")
    tfe.get_frontend(["lfcc"], fused=True)(x)
    assert calls == ["linear", "linear"]
    torch.testing.assert_close(fused, lfcc_fused.reference_forward(x), rtol=0, atol=0)


def test_kernel_constants_reassemble_the_spectrum():
    """The CUDA kernel's FFT table (window and twiddles rounded to f32),
    combined as the kernel combines them (tests/torch_port_common.py's
    model of its passes, in f32), gives the spectrogram's power, and the
    filter ranges hold every non-zero filter weight."""
    x = torch.from_numpy(waves(44))
    power = lfcc_fft_power(x.numpy(), np.float32).astype(np.float64)
    ref = stft.spectrogram(x).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(power, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    for kind in lfcc_fused.FILTERBANKS:
        filt = lfcc_fused.filterbank_matrix(kind)
        for m, (lo, hi) in enumerate(lfcc_fused._filter_ranges(kind)):
            outside = np.ones(257, bool)
            outside[lo:hi] = False
            assert not filt[outside, m].any(), (kind, m)


def test_cpu_wrapper_runs_plain_without_launches():
    x = torch.from_numpy(waves(45))
    before = dict(lfcc_fused.LAUNCHES)
    out = lfcc_fused.lfcc_fused(x)
    torch.testing.assert_close(out, lfcc_fused.cepstra_fused_reference(x), rtol=0, atol=0)
    assert lfcc_fused.LAUNCHES == before
    with pytest.raises(ValueError):
        lfcc_fused.lfcc_fused(x[:, :64_000])
    with pytest.raises(ValueError):
        lfcc_fused.cepstra_fused(x, "bark")
    with pytest.raises(ValueError, match="CUDA"):
        lfcc_fused.kernel_forward(x)
