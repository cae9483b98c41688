"""Raw-mode adversarial evaluation and the CLIs on a real-corpus layout:
the port vs the JAX package (CPU).

``generate_attacks(raw_sample_from_dataset=True)`` re-preprocesses the
attacked batch (silence trim, repeat-pad to 64,600) on the host before the
victim sees it. Tolerances: every report key within 1e-4 of JAX's (the
band of ``test_torch_port_eval.py:test_generate_attacks_matches_jax``), on
shared f32 LCNN weights (``tests/torch_port_common.py``).

Where raw mode could break between the packages: their FGSM waves may
differ in the last ulp, and a sample whose 20 ms RMS sat exactly at the
trim's 1% gate could then move a trim boundary and shift the whole
repeat-pad. The WaveFake mini-corpus's silences are noise at ~1e-4 of full
scale (``tests/torch_port_corpus.py``), far below the gate, as recorded
silence is; and each test asserts that every attacked wave's trimmed length
is the same on both sides, so a moved boundary fails by name.
"""
from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu import models as jmodels
from adaa_tpu.data import base as jbase
from adaa_tpu.data.detection import DetectionDataset as JDetection
from adaa_tpu.data.synthetic import SyntheticDataset as JSynthetic
from adaa_tpu.eval.adv_evaluation import generate_attacks as jgenerate_attacks
from adaa_tpu_torch.data import base as tbase
from adaa_tpu_torch.data.detection import DetectionDataset as TDetection
from adaa_tpu_torch.data.synthetic import SyntheticDataset as TSynthetic
from adaa_tpu_torch.eval import generate_attacks as tgenerate_attacks
from tests import torch_port_corpus as corpus
from tests.torch_port_common import (CFG_F32, KEYS, assert_reports_close, cli_dir, jax_native,
                                     lcnn_variables, port_lcnn, port_specrnet,
                                     specrnet_variables)

torch.set_num_threads(2)

WAVEFAKE = dict(n_spoof=440, n_real=100)  # val: 66 spoof rows, 132 after oversampling


@pytest.fixture(scope="module", autouse=True)
def _jax_native(jax_native):
    return jax_native


@pytest.fixture(scope="module")
def wavefake_root(tmp_path_factory):
    return corpus.wavefake(tmp_path_factory.mktemp("WaveFake"), WAVEFAKE["n_spoof"],
                           WAVEFAKE["n_real"], np.random.default_rng(20), [], (0.9, 1.5))


@pytest.fixture(scope="module")
def lcnn():
    lv = lcnn_variables(0)
    return {"jax": (jmodels.get_model("lcnn", CFG_F32), jax.tree_util.tree_map(jnp.asarray, lv)),
            "torch": port_lcnn(CFG_F32, lv)}


def _datasets(source, wavefake_root):
    """The same raw dataset for each package (one ``np.random.seed`` before
    each: oversampling draws from numpy's global generator)."""
    if source == "synthetic":
        kw = dict(n=8, subset="val", wave_length=16_000, return_meta=True, return_raw=True)
        return JSynthetic(**kw), TSynthetic(**kw)
    kw = dict(wavefake_path=wavefake_root, subset="val", reduced_number=8, return_meta=True,
              return_raw=True)
    np.random.seed(21)
    jds = JDetection(**kw)
    np.random.seed(21)
    return jds, TDetection(**kw)


def _trimmed_lengths(sox_silence, waves):
    return [sox_silence(w, 16_000).size for w in waves]


@pytest.mark.parametrize("callback", [True, False], ids=["callback", "no_callback"])
@pytest.mark.parametrize("attack", ["NO_ATTACK", "FGSM"])
@pytest.mark.parametrize("source", ["synthetic", "wavefake"])
def test_raw_mode_matches_jax(lcnn, wavefake_root, source, attack, callback):
    jdata, tdata = _datasets(source, wavefake_root)
    calls = {"jax": [], "torch": []}
    cb = {side: (lambda _calls=calls[side], **kw: _calls.append(kw)) if callback else None
          for side in calls}
    np.random.seed(5)
    want = jgenerate_attacks(*lcnn["jax"], jdata, attack_name=attack,
                             attack_module=lcnn["jax"][0], attack_variables=lcnn["jax"][1],
                             batch_size=4, on_attack_end_callback=cb["jax"],
                             raw_sample_from_dataset=True)
    np.random.seed(5)
    got = tgenerate_attacks(lcnn["torch"], tdata, attack_name=attack, attack_model=lcnn["torch"],
                            batch_size=4, generator=torch.Generator().manual_seed(0),
                            on_attack_end_callback=cb["torch"], raw_sample_from_dataset=True)
    assert_reports_close(got, want, 1e-4)
    if not callback:
        return
    assert len(calls["jax"]) == len(calls["torch"]) == 2
    length = 16_000 if source == "synthetic" else tbase.WAVE_FAKE_CUT
    trimmed = 0
    for kj, kt in zip(calls["jax"], calls["torch"]):
        assert set(kj) == set(kt)
        # the callback gets the waves from before the re-preprocessing
        assert kt["batch_x"].shape == kt["batch_x_attacked"].shape == (4, length)
        np.testing.assert_array_equal(kt["batch_x"], kj["batch_x"])
        np.testing.assert_array_equal(kt["batch_y"], kj["batch_y"])
        assert kt["batch_metadata"] == kj["batch_metadata"]
        assert (_trimmed_lengths(tbase.sox_silence, kt["batch_x_attacked"])
                == _trimmed_lengths(jbase.sox_silence, kj["batch_x_attacked"]))
        np.testing.assert_allclose(kt["batch_preds_noattack"], kj["batch_preds_noattack"],
                                   rtol=0, atol=1e-5)
        # the victim saw the re-preprocessed attacked batch
        srs = np.full(4, 16_000, np.int32)
        repro, _ = tbase.wavefake_preprocessing_on_batch(kt["batch_x_attacked"], srs)
        trimmed += int((repro[:, :length] != kt["batch_x_attacked"]).any(axis=1).sum())
        with torch.no_grad():
            preds = torch.sigmoid(lcnn["torch"].eval()(torch.from_numpy(repro)).squeeze(1))
        np.testing.assert_array_equal(preds.numpy(), kt["batch_preds"])
        if attack == "NO_ATTACK":
            np.testing.assert_array_equal(kt["batch_x_attacked"], kt["batch_x"])
    if source == "wavefake":
        assert trimmed > 0  # the trim cut silences: raw mode is not plain mode here


# --------------------------------------------------------------------------
# The CLIs on a WaveFake layout, on the CPU
# --------------------------------------------------------------------------

def _corpus_args(wavefake_root, *extra):
    return ["--asv_path", "none", "--wavefake_path", str(wavefake_root), "--celeb_path", "none",
            "--cpu", *extra]


def test_evaluate_models_cli_on_a_corpus(cli_dir, wavefake_root, caplog):
    from adaa_tpu_torch.scripts import evaluate_models

    caplog.set_level(logging.INFO)
    config = {"data": {"seed": 3}, "model": {"name": "specrnet", "parameters": CFG_F32}}
    report = evaluate_models.run(evaluate_models.parse_args(
        _corpus_args(wavefake_root, "--amount", "128")), config)
    assert set(report) == set(KEYS) and 0.0 <= report["accuracy"] <= 100.0
    assert "eval/eer" in caplog.text and "Testing 'specrnet' model on 128 audio files" in caplog.text


def test_adversarial_cli_raw_mode_on_a_corpus(cli_dir, wavefake_root, caplog):
    from adaa_tpu_torch.scripts import evaluate_models_on_adversarial_attacks as adv_cli

    caplog.set_level(logging.INFO)
    config = {"data": {"seed": 3}, "model": {"name": "specrnet", "parameters": CFG_F32}}
    args = adv_cli.parse_args(_corpus_args(wavefake_root, "--raw_from_dataset", "--attack", "FGSM",
                                           "--amount", "64"))
    report = adv_cli.run(args, config, config)
    assert set(report) == set(KEYS) and np.isfinite(report["accuracy"])
    assert "adv_eval/accuracy" in caplog.text


def test_train_models_cli_on_a_corpus(cli_dir, wavefake_root):
    """train_models on the WaveFake layout (DetectionDataset with oversampling),
    then its checkpoint through the chained config."""
    import yaml

    from adaa_tpu_torch import models as tmodels
    from adaa_tpu_torch.scripts import train_models

    repo = __import__("pathlib").Path(__file__).resolve().parents[1]
    ckpt, cfg_path = train_models.main(train_models.parse_args(
        ["--config", str(repo / "configs/training/specrnet.yaml"),
         *_corpus_args(wavefake_root, "-a", "8", "-ta", "8", "-b", "4", "-e", "1")]))
    config = yaml.safe_load(cfg_path.read_text())
    model = tmodels.load_model(config, torch.Generator().manual_seed(0), "cpu")
    for k, v in torch.load(ckpt, weights_only=True).items():
        assert torch.equal(model.state_dict()[k], v), k


def test_oversample_flag_reaches_the_dataset(wavefake_root):
    from adaa_tpu_torch.scripts._common import build_dataset

    paths = ["", str(wavefake_root), "None"]
    balanced = build_dataset(paths, "train", oversample=True).samples["label"].value_counts()
    plain = build_dataset(paths, "train", oversample=False).samples["label"].value_counts()
    assert balanced["bonafide"] == balanced["spoof"] == plain["spoof"] > plain["bonafide"]
    assert build_dataset(["synthetic:8:400", "", ""], "val").n == 8


def test_port_spec_victim_of_the_corpus_is_finite(wavefake_root):
    """A SpecRNet forward on decoded, trimmed and padded corpus audio."""
    ds = TDetection(wavefake_path=wavefake_root, subset="test", reduced_number=4)
    x = torch.from_numpy(np.stack([ds[i][0] for i in range(4)]))
    with torch.no_grad():
        z = port_specrnet(CFG_F32, specrnet_variables(1))(x)
    assert z.shape == (4, 1) and bool(torch.isfinite(z).all())
