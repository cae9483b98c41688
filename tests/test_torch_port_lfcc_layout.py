"""The fused LFCC kernel's FFT plan and layouts (CPU; no card).

``csrc/lfcc.cu`` computes the 257-bin power spectrum of each frame with a
256-point complex FFT of the packed sample pairs (passes of radix 8, 8
and 4 with twiddles from ``ops/lfcc_fused.py:fft_table``) and a real
split, and reflects the frames' edges where it reads the wave. These
tests replay that plan in numpy (``tests/torch_port_common.py:
lfcc_fft_power``) and hold it to the function the kernel must compute:

* in float64, with the float64 table: np.fft.rfft's power of the same
  windowed frames within 1e-9 of its largest value (the plan is exact
  up to float64 rounding, ~1e-15);
* in f32, with the f32 table the kernel reads, followed by the f32
  filterbank, dB and DCT: the port's plain version (``reference_forward``,
  the f32 DFT product) and the JAX package's Pallas kernel (interpret
  mode) within atol 5e-4 + rtol 1e-4, chip_smoke.py phase 5's band (the
  JAX package's band for its own kernel), for both filterbanks.
"""
import ctypes
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import adaa_tpu.ops.pallas_lfcc as pk
from adaa_tpu_torch.ops import _build, lfcc_fused
from adaa_tpu_torch.ops.stft import _padded_window, hann_window
from tests.torch_port_common import lfcc_fft_power, waves

torch.set_num_threads(2)
ATOL, RTOL = 5e-4, 1e-4


def _edged_waves(seed: int, b: int = 2) -> np.ndarray:
    """Waves whose first and last 300 samples are large, so that the
    reflected edges carry the frames' largest values."""
    x = waves(seed, b)
    x[:, :300] *= 20.0
    x[:, -300:] *= 20.0
    return x


def test_fft_plan_matches_rfft_in_float64():
    x = _edged_waves(60).astype(np.float64)
    power = lfcc_fft_power(x, np.float64)
    win = _padded_window(hann_window(400), 512, 400)
    xp = np.pad(x, ((0, 0), (256, 256)), mode="reflect")
    frames = np.stack([xp[:, 160 * t:160 * t + 512] for t in range(404)], axis=1) * win
    ref = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    assert power.shape == ref.shape == (2, 404, 257)
    assert np.abs(power - ref).max() <= 1e-9 * np.abs(ref).max()


def test_fft_table_is_the_float64_table_rounded_once():
    tab64, tab = lfcc_fused.fft_table64(), lfcc_fused.fft_table()
    assert tab.dtype == np.float32 and tab.shape == (lfcc_fused.TAB_LEN,)
    assert np.array_equal(tab, tab64.astype(np.float32))
    # W256^(n2 k1) at 32 k1 + n2, real parts then imaginary parts
    k1, n2 = 3, 17
    w = complex(tab64[lfcc_fused.TAB_W256 + 32 * k1 + n2],
                tab64[lfcc_fused.TAB_W256 + 256 + 32 * k1 + n2])
    assert abs(w - complex(math.cos(2 * math.pi * n2 * k1 / 256),
                           -math.sin(2 * math.pi * n2 * k1 / 256))) < 1e-15


def _cepstra(power: np.ndarray, kind: str) -> np.ndarray:
    """The kernel's stages after the power, in f32: filterbank, dB, DCT."""
    filt = lfcc_fused.filterbank_matrix(kind).astype(np.float32)
    dct = lfcc_fused._dct_matrix().astype(np.float32)
    fbank = power.astype(np.float32) @ filt
    db = np.float32(lfcc_fused.DB_SCALE) * np.log(np.maximum(fbank, np.float32(1e-10)))
    return (db @ dct).transpose(0, 2, 1)  # (B, 80, 404)


@pytest.mark.parametrize("kind", lfcc_fused.FILTERBANKS)
def test_fft_plan_in_f32_within_the_band(kind):
    x = _edged_waves(61 if kind == "linear" else 62)
    got = _cepstra(lfcc_fft_power(x, np.float32), kind)
    ref = lfcc_fused.reference_forward(torch.from_numpy(x), kind).numpy()
    fn = pk.lfcc_pallas if kind == "linear" else pk.mfcc_pallas
    jref = np.asarray(fn(jnp.asarray(x), interpret=True))
    for want in (ref, jref):
        assert got.shape == want.shape == (2, 80, 404)
        excess = np.abs(got - want) - (ATOL + RTOL * np.abs(want))
        assert excess.max() <= 0.0, excess.max()


def test_reflect_index_is_the_reflect_pad():
    x = torch.from_numpy(waves(63, 1))
    padded = F.pad(x[:, None], (256, 256), mode="reflect")[0, 0]
    i = np.arange(-256, lfcc_fused.WAVE_LEN + 256)
    assert torch.equal(x[0, torch.from_numpy(lfcc_fused.reflect_index(i))], padded)
    # every sample the frames read: 160 f - 256 + n, n < 512
    frames = 160 * np.arange(404)[:, None] - 256 + np.arange(512)[None, :]
    got = lfcc_fused.reflect_index(frames)
    assert got.min() >= 0 and got.max() < lfcc_fused.WAVE_LEN


def test_ctypes_signature_and_table_match_the_c_source():
    src = (_build.SRC_DIR / "lfcc.cu").read_text()
    params = re.search(r"int lfcc_fwd\(([^)]*)\)", src).group(1).split(",")
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int}
    assert [kinds[" ".join(p.split()[:-1])] for p in params] == lfcc_fused.ARGTYPES["lfcc_fwd"]
    offs = re.search(r"constexpr int TAB_WIN = (\d+), TAB_W256 = (\d+), TAB_W32 = "
                     r"TAB_W256 \+ 2 \* (\d+),\s*TAB_W512 = TAB_W32 \+ 2 \* (\d+), "
                     r"TAB_LEN = TAB_W512 \+ 2 \* (\d+);", src).groups()
    win, w256, n256, n32, n512 = (int(v) for v in offs)
    assert (win, w256) == (lfcc_fused.TAB_WIN, lfcc_fused.TAB_W256)
    assert w256 + 2 * n256 == lfcc_fused.TAB_W32
    assert lfcc_fused.TAB_W32 + 2 * n32 == lfcc_fused.TAB_W512
    assert lfcc_fused.TAB_W512 + 2 * n512 == lfcc_fused.TAB_LEN
    tiny = int(re.search(r"constexpr float TINY_BIN = 0x1p-(\d+)f;", src).group(1))
    assert 2.0 ** -tiny == lfcc_fused.TINY_BIN
