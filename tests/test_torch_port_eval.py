"""The port's metrics, data, evaluation loops and CLIs vs the JAX package (CPU).

Tolerances:
* metrics (numpy + scipy) against ``adaa_tpu.metrics`` (sklearn): every
  key within 1e-12, or both nan; the ROC's points equal.
* loader and synthetic copies: the same arrays, in the same order, under
  one ``np.random.seed``.
* ``evaluate_nn`` and ``generate_attacks`` on shared f32 weights at short
  waves (16,000 samples, batches of 4): every key of the report within
  1e-4 (or both nan). The victims' sigmoid scores agree to ~1e-7, so the
  ROC's points and the labels are the same.
"""
import argparse
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu import attacks as jattacks
from adaa_tpu import metrics as jmetrics
from adaa_tpu import models as jmodels
from adaa_tpu.data.loader import DataLoader as JDataLoader
from adaa_tpu.data.synthetic import SyntheticDataset as JSynthetic
from adaa_tpu.eval.adv_evaluation import generate_attacks as jgenerate_attacks
from adaa_tpu.eval.evaluation import evaluate_nn as jevaluate_nn
from adaa_tpu.eval.qualitative import AttackAnalyser as JAnalyser
from adaa_tpu_torch import attacks as tattacks
from adaa_tpu_torch import metrics as tmetrics
from adaa_tpu_torch.data.loader import DataLoader as TDataLoader
from adaa_tpu_torch.data.synthetic import SyntheticDataset as TSynthetic
from adaa_tpu_torch.eval import generate_attacks as tgenerate_attacks
from adaa_tpu_torch.eval import evaluate_nn as tevaluate_nn
from adaa_tpu_torch.eval.qualitative import AttackAnalyser as TAnalyser
from adaa_tpu_torch.scripts import evaluate_models as tcli_eval
from adaa_tpu_torch.scripts import evaluate_models_on_adversarial_attacks as tcli_adv
from tests.torch_port_common import (CFG_F32, lcnn_variables, port_lcnn, port_specrnet,
                                     specrnet_variables)

torch.set_num_threads(2)

LENGTH = 16_000
KEYS = ("eer", "accuracy", "precision", "recall", "f1_score", "auc")


def _assert_reports_close(a, b, atol):
    assert set(a) == set(b) == set(KEYS)
    for k in KEYS:
        if np.isnan(a[k]) or np.isnan(b[k]):
            assert np.isnan(a[k]) and np.isnan(b[k]), (k, a[k], b[k])
        else:
            assert abs(a[k] - b[k]) <= atol, (k, a[k], b[k])


def _metric_cases():
    rng = np.random.default_rng(0)
    return {
        "random": (rng.integers(0, 2, 200), rng.uniform(0, 1, 200)),
        "tied": (rng.integers(0, 2, 200), np.round(rng.uniform(0, 1, 200), 1)),
        "perfect": (np.r_[np.zeros(50), np.ones(50)],
                    np.r_[rng.uniform(0, 0.4, 50), rng.uniform(0.6, 1, 50)]),
        "one_class_1": (np.ones(64), rng.uniform(0, 1, 64)),
        "one_class_0": (np.zeros(64), rng.uniform(0, 1, 64)),
    }


@pytest.mark.parametrize("case", list(_metric_cases()))
def test_metrics_match_sklearn_path(case):
    from sklearn.metrics import roc_curve

    y, p = _metric_cases()[case]
    labels = (p + 0.5).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jmetrics.classification_report(y, p, labels)
        ref_roc = roc_curve(y, -p)
    got = tmetrics.classification_report(y, p, labels)
    _assert_reports_close(got, want, 1e-12)
    for a, b in zip(tmetrics.roc_curve(y, -p), ref_roc):
        np.testing.assert_array_equal(a, b)
    assert tmetrics.format_metrics("eval", got) == jmetrics.format_metrics("eval", want)
    if case.startswith("one_class"):
        assert np.isnan(got["auc"]) and np.isnan(got["eer"])


def test_loader_and_synthetic_match_jax():
    kw = {"n": 10, "subset": "val", "wave_length": 2000, "return_meta": True}
    jd, td = JSynthetic(**kw), TSynthetic(**kw)
    for i in range(len(jd)):
        for a, b in zip(jd[i], td[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    batches = []
    for loader_cls, ds in ((JDataLoader, jd), (TDataLoader, td)):
        np.random.seed(7)
        batches.append(list(loader_cls(ds, 3, shuffle=True, drop_last=True, num_workers=2)))
    assert len(batches[0]) == len(batches[1]) == 3
    for bj, bt in zip(*batches):
        for a, b in zip(bj[:3], bt[:3]):
            np.testing.assert_array_equal(a, b)
        assert bj[3] == bt[3]


@pytest.fixture(scope="module")
def shared():
    """JAX and port models on shared f32 weights, and a short synthetic set."""
    lv, sv = lcnn_variables(0), specrnet_variables(0)
    jlcnn = (jmodels.get_model("lcnn", CFG_F32), jax.tree_util.tree_map(jnp.asarray, lv))
    jspec = (jmodels.get_model("specrnet", CFG_F32), jax.tree_util.tree_map(jnp.asarray, sv))
    return {"jlcnn": jlcnn, "jspec": jspec, "tlcnn": port_lcnn(CFG_F32, lv),
            "tspec": port_specrnet(CFG_F32, sv),
            "data": dict(n=8, subset="val", wave_length=LENGTH, return_meta=True)}


def test_evaluate_nn_matches_jax(shared):
    np.random.seed(3)
    want = jevaluate_nn(*shared["jspec"], JSynthetic(**shared["data"]), batch_size=4)
    model = shared["tspec"].train()
    np.random.seed(3)
    got = tevaluate_nn(model, TSynthetic(**shared["data"]), batch_size=4)
    _assert_reports_close(got, want, 1e-4)
    assert all(m.training for m in model.modules())  # the caller's mode comes back
    model.eval()
    with pytest.raises(ValueError, match="no full batches"):
        tevaluate_nn(model, TSynthetic(**shared["data"]), batch_size=16)


def _fab_steps(monkeypatch, steps):
    """The registry's FAB with ``steps`` steps, in both packages."""
    for lib in (jattacks, tattacks):
        builder, params = lib.ATTACK_REGISTRY["FAB"]
        monkeypatch.setitem(lib.ATTACK_REGISTRY, "FAB", (builder, {**params, "steps": steps}))


@pytest.mark.parametrize("attack,surrogate,victim", [
    ("FGSM", "lcnn", "lcnn"),  # white-box
    ("FAB", "lcnn", "spec"),  # transfer, 10 steps
    ("NO_ATTACK", "lcnn", "spec"),
])
def test_generate_attacks_matches_jax(shared, monkeypatch, attack, surrogate, victim):
    _fab_steps(monkeypatch, 10)
    calls = {"jax": [], "torch": []}
    np.random.seed(5)
    want = jgenerate_attacks(
        *shared[f"j{victim}"], JSynthetic(**shared["data"]), attack_name=attack,
        attack_module=shared[f"j{surrogate}"][0], attack_variables=shared[f"j{surrogate}"][1],
        batch_size=4, on_attack_end_callback=lambda **kw: calls["jax"].append(kw))
    np.random.seed(5)
    got = tgenerate_attacks(
        shared[f"t{victim}"], TSynthetic(**shared["data"]), attack_name=attack,
        attack_model=shared[f"t{surrogate}"], batch_size=4,
        generator=torch.Generator().manual_seed(0),
        on_attack_end_callback=lambda **kw: calls["torch"].append(kw))
    _assert_reports_close(got, want, 1e-4)
    assert len(calls["jax"]) == len(calls["torch"]) == 2
    for kj, kt in zip(calls["jax"], calls["torch"]):
        assert set(kj) == set(kt)
        np.testing.assert_array_equal(kt["batch_x"], kj["batch_x"])
        np.testing.assert_array_equal(kt["batch_y"], kj["batch_y"])
        assert kt["batch_metadata"] == kj["batch_metadata"]
        for k in ("batch_preds", "batch_preds_noattack", "batch_x_attacked"):
            assert kt[k].shape == kj[k].shape and kt[k].dtype == kj[k].dtype, k
        np.testing.assert_allclose(kt["batch_preds_noattack"], kj["batch_preds_noattack"],
                                   rtol=0, atol=1e-5)
        if attack == "NO_ATTACK":
            np.testing.assert_array_equal(kt["batch_x_attacked"], kt["batch_x"])
    if attack != "NO_ATTACK":
        for side in calls.values():
            assert any(not np.array_equal(kw["batch_x_attacked"], kw["batch_x"]) for kw in side)


def test_attack_analyser_writes_the_same_files(tmp_path):
    rng = np.random.default_rng(2)
    kw = dict(batch_x=rng.uniform(-1, 1, (4, 800)).astype(np.float32),
              batch_x_attacked=rng.uniform(-1, 1, (4, 800)).astype(np.float32),
              batch_y=np.array([1, 0, 1, 0], np.int32),
              batch_preds=np.array([0.2, 0.9, 0.7, 0.1], np.float32),
              batch_preds_label=np.array([0, 1, 1, 0], np.int32),
              batch_preds_noattack=np.array([0.8, 0.1, 0.6, 0.9], np.float32),
              batch_preds_noattack_label=np.array([1, 0, 1, 1], np.int32),
              batch_metadata=(("a", "b", "c", "d"), ("p0", "p1", "p2", "p3")))
    for cls, sub in ((JAnalyser, "jax"), (TAnalyser, "torch")):
        cls(tmp_path / sub).analyse(**kw)
    files = {p.name: p.read_bytes() for p in (tmp_path / "jax").iterdir()}
    assert files.keys() == {p.name for p in (tmp_path / "torch").iterdir()}
    assert len(files) == 4  # the flipped rows 0 (fn) and 1 (fp): original + attacked
    for name, data in files.items():
        assert (tmp_path / "torch" / name).read_bytes() == data


def _flags(parser):
    return [(a.option_strings, a.dest, a.default, a.type, a.choices, a.nargs, type(a).__name__)
            for a in parser._actions]


@pytest.mark.parametrize("name", ["evaluate_models", "evaluate_models_on_adversarial_attacks"])
def test_cli_flags_match_jax_scripts(monkeypatch, name):
    import importlib

    jscript = importlib.import_module(f"scripts.{name}")
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", lambda self, *a, **k: self)
    jparser = jscript.parse_args()
    tscript = {"evaluate_models": tcli_eval,
               "evaluate_models_on_adversarial_attacks": tcli_adv}[name]
    assert _flags(tscript.build_parser()) == _flags(jparser)


def test_raw_mode_and_real_datasets_raise():
    args = tcli_adv.parse_args(["--asv_path", "synthetic:8:2000", "--cpu", "--raw_from_dataset",
                                "--attack", "FGSM"])
    cfg = {"data": {"seed": 1}, "model": {"name": "lcnn", "parameters": CFG_F32}}
    with pytest.raises(NotImplementedError, match="raw mode"):
        tcli_adv.run(args, cfg, cfg)
    for script in (tcli_eval, tcli_adv):
        args = script.parse_args(["--cpu"])  # the default ASVspoof path
        with pytest.raises(NotImplementedError, match="synthetic"):
            script.run(args, cfg, *([None] if script is tcli_adv else []))
    ckpt = {**cfg, "checkpoint": {"path": "model.msgpack"}}
    with pytest.raises(NotImplementedError, match="msgpack"):
        tcli_eval.run(tcli_eval.parse_args(["--cpu", "--asv_path", "synthetic:8"]), ckpt)


def test_cli_config_entry_runs_a_transfer_evaluation(tmp_path, monkeypatch):
    """The adversarial CLI's config-dict entry, end to end on the CPU:
    NO_ATTACK with an LCNN surrogate config against a SpecRNet victim, and
    the victim's weights from a reference-keyed .pth checkpoint."""
    monkeypatch.chdir(tmp_path)
    sd = port_specrnet(CFG_F32, specrnet_variables(2)).state_dict()
    torch.save({f"module.{k}": v for k, v in sd.items()}, tmp_path / "spec.pth")
    victim = {"data": {"seed": 3}, "model": {"name": "specrnet", "parameters": CFG_F32},
              "checkpoint": {"path": str(tmp_path / "spec.pth")}}
    surrogate = {"data": {"seed": 3}, "model": {"name": "lcnn", "parameters": CFG_F32}}
    args = tcli_adv.parse_args(["--asv_path", f"synthetic:64:{LENGTH}", "--cpu"])
    report = tcli_adv.run(args, victim, surrogate)
    assert set(report) == set(KEYS) and 0.0 <= report["accuracy"] <= 100.0
