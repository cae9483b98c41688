"""The port's batch scripts (``adaa_tpu_torch/scripts/multi_runs/``), the
twins of ``scripts/multi_runs/`` (``tests/test_multi_runs.py`` drives
those).

* Each of the four shipped batch configs (``scripts/multi_runs/configs``)
  and ``batch_config.yaml`` turns into the same argv lists as in the JAX
  script, with ``--cpu`` appended: the port's CLI ``main`` is replaced by
  a recorder, and so is the JAX CLI's.
* Each twin end to end in a subprocess with ``--cpu`` on ``synthetic:``
  data at the smallest sizes that still produce the CLI's report lines
  (16,000-sample waves; the adversarial evaluation's raw mode pads them
  back to 64,600).
"""
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from adaa_tpu_torch.scripts.multi_runs import run_multiple_evaluations as t_eval
from adaa_tpu_torch.scripts.multi_runs import (
    run_multiple_evaluations_on_adversarial_attacks as t_adv_eval)
from adaa_tpu_torch.scripts.multi_runs import run_multiple_trainings as t_train
from adaa_tpu_torch.scripts.multi_runs import (
    run_multiple_trainings_on_adversarial_attacks as t_adv_train)

REPO = Path(__file__).resolve().parents[1]
CLI = {t_eval: "evaluate_models", t_train: "train_models",
       t_adv_eval: "evaluate_models_on_adversarial_attacks",
       t_adv_train: "train_models_on_adversarial_attacks"}
CASES = [  # (twin, JAX script, batch config, extra flags)
    (t_eval, "run_multiple_evaluations.py", "batch_config.yaml",
     ["--asv_path", "synthetic:192", "--amount", "192"]),
    (t_train, "run_multiple_trainings.py", "batch_config.yaml",
     ["--asv_path", "synthetic:16", "--batch_size", "4", "--epochs", "1"]),
    *[(t_adv_eval, "run_multiple_evaluations_on_adversarial_attacks.py",
       f"scripts/multi_runs/configs/{name}.yaml", ["--asv_path", "synthetic:128", "-a", "128"])
      for name in ("adv_eval_whitebox", "adv_eval_trans_lcnn", "adv_eval_trans_rawnet3",
                   "adv_eval_trans_specrnet")],
    (t_adv_train, "run_multiple_trainings_on_adversarial_attacks.py",
     "scripts/multi_runs/configs/adv_train.yaml",
     ["--asv_path", "synthetic:16", "--finetune", "-b", "4", "-a", "8", "-ta", "8"]),
]


def _recorder(calls):
    def parse_args(argv=None):
        return list(argv if argv is not None else sys.argv[1:])

    return parse_args, calls.append


@pytest.mark.parametrize("twin,script,batch,flags", CASES,
                         ids=[f"{c[1][:-3]}:{Path(c[2]).stem}" for c in CASES])
def test_twin_builds_the_jax_scripts_argv(twin, script, batch, flags, monkeypatch):
    import importlib

    monkeypatch.chdir(REPO)
    cli = CLI[twin]
    port_cli = importlib.import_module(f"adaa_tpu_torch.scripts.{cli}")
    got = []
    parse, record = _recorder(got)
    monkeypatch.setattr(port_cli, "parse_args", parse)
    monkeypatch.setattr(port_cli, "main", record)
    twin.main(twin.parse_args(["--config", batch, *flags, "--cpu"]))

    jax_cli = importlib.import_module(f"scripts.{cli}")
    want = []
    parse, record = _recorder(want)
    monkeypatch.setattr(jax_cli, "parse_args", parse)
    monkeypatch.setattr(jax_cli, "main", record)
    monkeypatch.setattr(sys, "argv", [script, "--config", batch, *flags])
    runpy.run_path(str(REPO / "scripts" / "multi_runs" / script), run_name="__main__")
    entries = yaml.safe_load(open(batch))
    assert len(got) == len(want) == len(entries["paths"] if "paths" in entries else entries)
    assert got == [argv + ["--cpu"] for argv in want]


def _run(module, argv, cwd, timeout=600):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, "-m", f"adaa_tpu_torch.scripts.multi_runs.{module}",
                           *argv, "--cpu"], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_run_multiple_evaluations(tmp_path):
    batch = tmp_path / "batch.yaml"
    batch.write_text(yaml.dump({"paths": [str(REPO / "configs/training/lcnn.yaml")]}))
    out = _run("run_multiple_evaluations",
               ["--config", str(batch), "--asv_path", "synthetic:128:16000"], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "eval/eer" in out.stdout + out.stderr


def test_run_multiple_trainings(tmp_path):
    batch = tmp_path / "batch.yaml"
    batch.write_text(yaml.dump({"paths": [str(REPO / "configs/training/lcnn.yaml")]}))
    out = _run("run_multiple_trainings", ["--config", str(batch), "--asv_path",
                                          "synthetic:8:16000", "--batch_size", "4",
                                          "--epochs", "1"], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    text = out.stdout + out.stderr
    assert "Training done" in text and "Test config saved" in text
    assert list((tmp_path / "trained_models").glob("*/ckpt.pth"))


def test_run_multiple_adv_trainings(tmp_path):
    cfg = {"data": {"seed": 42, "adversarial_attacks": ["FGSM_eps001"]},
           "checkpoint": {"path": ""},
           "model": {"name": "lcnn", "parameters": {"frontend_algorithm": ["lfcc"],
                                                     "input_channels": 1},
                     "optimizer": {"lr": 0.0001, "weight_decay": 0.0001}}}
    (tmp_path / "lcnn_adv.yaml").write_text(yaml.dump(cfg))
    batch = tmp_path / "batch.yaml"
    batch.write_text(yaml.dump([{"config": str(tmp_path / "lcnn_adv.yaml")}]))
    out = _run("run_multiple_trainings_on_adversarial_attacks",
               ["--config", str(batch), "--asv_path", "synthetic:8:16000",
                "--adv_training_strategy", "ONLY_ADV", "--epochs", "1", "--batch_size", "4",
                "--train_amount", "8", "--test_amount", "8"], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    text = out.stdout + out.stderr
    assert "adv_test/FGSM_eps001__accuracy" in text and "multi_f1_score" in text


def test_run_multiple_adv_evaluations(tmp_path):
    batch = tmp_path / "batch.yaml"
    cfg = str(REPO / "configs/training/lcnn.yaml")
    batch.write_text(yaml.dump([{"attack": "FGSM_eps001", "config": cfg,
                                 "attack_model_config": cfg}]))
    out = _run("run_multiple_evaluations_on_adversarial_attacks",
               ["--config", str(batch), "--asv_path", "synthetic:64:16000", "--amount", "64"],
               tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "adv_eval/" in out.stdout + out.stderr
    assert (tmp_path / "qualitative_results").is_dir()
