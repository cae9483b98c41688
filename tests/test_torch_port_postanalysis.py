"""adaa_tpu_torch.eval.postanalysis vs adaa_tpu.eval.postanalysis (CPU).

Tolerances:
* ``mel_cepstra`` within 1e-9 of JAX's (the same float64 numpy and scipy
  calls; measured: bit-equal) on the pairs of ``tests/test_eval.py``'s
  MCD test (int16 at 16 kHz, resampled to 22,050 Hz), on a float wave
  at 22,050 Hz (no resampling) and on a two-channel wave.
* the DTW and ``mel_cepstral_distance``: equal (the port fills the table
  an anti-diagonal at a time with each cell's sum as JAX's loop forms it),
  on random and on integer-valued (tied) distance matrices.
* ``read_waves_and_calc_metrics`` on pairs written by the port's
  ``AttackAnalyser``: the same ``metrics.csv`` and ``mcd_metrics.csv``
  text as JAX's; the plot written where matplotlib imports.
"""
import importlib.util
import shutil

import numpy as np
import pytest
from scipy.io import wavfile

from adaa_tpu.eval import postanalysis as jpa
from adaa_tpu_torch.eval import postanalysis as tpa
from adaa_tpu_torch.eval.qualitative import AttackAnalyser


def _pair(sr=16_000, seconds=1.0):
    rng = np.random.default_rng(0)
    t = np.arange(int(sr * seconds), dtype=np.float32) / sr
    wave = 0.4 * np.sin(2 * np.pi * 220 * t)
    return wave, wave + 0.05 * rng.standard_normal(len(t)).astype(np.float32)


@pytest.mark.parametrize("case", ["int16_16k", "float_22050", "stereo_16k"])
def test_mel_cepstra_matches_jax(case):
    wave, noisy = _pair(22_050 if case == "float_22050" else 16_000)
    if case == "int16_16k":
        inputs, sr = [(w * 32767).astype(np.int16) for w in (wave, noisy)], 16_000
    elif case == "float_22050":
        inputs, sr = [wave.astype(np.float64), noisy.astype(np.float64)], 22_050
    else:
        inputs, sr = [np.stack([wave, noisy])], 16_000
    for w in inputs:
        want, got = jpa.mel_cepstra(w, sr), tpa.mel_cepstra(w, sr)
        assert got.shape == want.shape and got.shape[1] == 16 and got.shape[0] > 80
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("shape,tied", [((7, 7), True), ((12, 9), False), ((5, 16), True),
                                        ((1, 4), False)])
def test_dtw_matches_jax(shape, tied):
    rng = np.random.default_rng(sum(shape))
    d = rng.integers(0, 3, shape).astype(np.float64) if tied else rng.uniform(0, 5, shape)
    assert tpa._dtw_path_cost(d) == jpa._dtw_path_cost(d)


def test_mel_cepstral_distance_matches_jax():
    wave, noisy = _pair()
    for a, b in ((wave, noisy), (wave, wave), (wave[:12_000], noisy)):
        assert tpa.mel_cepstral_distance(a, b) == jpa.mel_cepstral_distance(a, b)


def test_read_waves_and_calc_metrics_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    x = (0.3 * rng.standard_normal((4, 16_000))).astype(np.float32)
    attacked = x + 0.01 * rng.standard_normal(x.shape).astype(np.float32)
    y = np.array([1, 0, 1, 0])
    AttackAnalyser(tmp_path / "port").analyse(
        batch_x=x, batch_x_attacked=attacked, batch_y=y,
        batch_preds_label=1 - y, batch_preds=(1 - y).astype(np.float32),
        batch_preds_noattack_label=y, batch_preds_noattack=y.astype(np.float32))
    assert len(list((tmp_path / "port").glob("*__orig.wav"))) == 4
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    results = tpa.AttackPostAnalyser(tmp_path / "port").read_waves_and_calc_metrics()
    jpa.AttackPostAnalyser(tmp_path / "jax").read_waves_and_calc_metrics()
    assert len(results) == 4 and (results["mcd"] > 0).all()
    for name in ("metrics.csv", "mcd_metrics.csv"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    if importlib.util.find_spec("matplotlib") is not None:
        tpa.AttackPostAnalyser(tmp_path / "port").read_waves_and_plot()
        assert len(list((tmp_path / "port").glob("*_plot.png"))) == 4


def test_postanalysis_reads_int16_pairs_written_by_scipy(tmp_path):
    """``tests/test_eval.py::test_postanalysis_mcd``'s pairs: an identical
    pair has MCD ~0 and a noisy one more."""
    wave, noisy = _pair()
    for stem, att in (("a", noisy), ("b", wave)):
        wavfile.write(tmp_path / f"{stem}__orig.wav", 16_000, (wave * 32767).astype(np.int16))
        wavfile.write(tmp_path / f"{stem}__attacked.wav", 16_000, (att * 32767).astype(np.int16))
    by_name = {r["name"]: r["mcd"] for _, r in
               tpa.AttackPostAnalyser(tmp_path).read_waves_and_calc_metrics().iterrows()}
    assert by_name["b"] < 1e-6 < by_name["a"]
    assert (tmp_path / "mcd_metrics.csv").exists()
