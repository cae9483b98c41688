"""The port's benchmark tools (``adaa_tpu_torch/scripts/bench_*.py``) against
the JAX package's ``scripts/bench_*.py`` on the CPU.

* ``bench_effectiveness.run_family``: the JAX script, imported by path with
  its ``WAVE_LEN`` cut (LCNN 4,000 samples; SpecRNet 16,000, the shortest
  that leaves its GRU a frame), batch 4, the same seed-0 weights carried
  through ``weights.state_dict_from_flax``, the JAX PGD's random start
  replayed (``tests/torch_port_draws.py``). Per row: the mean |logit shift|
  on the f32 victim within 1e-2 relative in the f32 row and 5e-2 in the bf16
  rows, and the flip rate equal. A signed step follows the sign of each
  coordinate's gradient, so where that gradient is near zero another
  summation order steps the other way (0.1% of SpecRNet's coordinates after
  ten steps), and the shift moves with it: the JAX function against itself,
  jitted and op by op, measured 2.5e-3 (LCNN) and 3.2e-3 (SpecRNet) in f32,
  5.3e-2 and 2.1e-3 in bf16. The f32 band is ~3x the larger f32 gap; the
  bf16 band stays at 5e-2 (the port measured 9.0e-3 for LCNN).
* ``bench_attacks``: every name of the JAX ``_resolve`` table resolves to a
  builder of the same name with equal parameters; a run of both tools on the
  CPU (FGSM and PGD on the bf16 LCNN at 4,000 samples, batch 2) gives the
  same row keys apart from ``compile_s`` -> ``first_call_s`` and the added
  ``card``, and FLOPs an example within 1% (the bound of
  ``tests/test_torch_port_config_flops.py``), PGD-10 ten times FGSM's.
* ``bench_train``: the JAX row's keys, with the same rename.
"""
import importlib.util
import json
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from adaa_tpu import models as jmodels
from adaa_tpu_torch import bench
from adaa_tpu_torch.attacks import ATTACK_REGISTRY
from adaa_tpu_torch.models.weights import state_dict_from_flax
from adaa_tpu_torch.scripts import bench_attacks as tba
from adaa_tpu_torch.scripts import bench_effectiveness as tbe
from adaa_tpu_torch.scripts import bench_train as tbt
from tests.torch_port_draws import gradient_starts, replay_starts

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
LFCC = {"input_channels": 1, "frontend_algorithm": ["lfcc"]}
BF16 = {"compute_dtype": "bfloat16"}
# the JAX tool's rows for the two LFCC families (scripts/bench_effectiveness.py:126-160)
JAX_TABLES = {
    "lcnn": {
        "f32_surrogate": dict(env={"ADAA_FUSED_LCNN": "0"}),
        "bf16_trunk_f32_frontend": dict(env={"ADAA_BF16_FRONTEND": "0"}, extra_cfg=BF16),
        "bf16_trunk_bf16_frontend": dict(env={"ADAA_BF16_FRONTEND": "1"}, extra_cfg=BF16),
    },
    "specrnet": {
        "f32_surrogate": dict(),
        "bf16_trunk_f32_frontend": dict(env={"ADAA_BF16_FRONTEND": "0"}, extra_cfg=BF16),
        "bf16_trunk_bf16_frontend": dict(env={"ADAA_BF16_FRONTEND": "1"}, extra_cfg=BF16),
    },
}
WAVE = {"lcnn": 4_000, "specrnet": 16_000}
SHIFT_RTOL = {"f32_surrogate": 1e-2, "bf16_trunk_f32_frontend": 5e-2,
              "bf16_trunk_bf16_frontend": 5e-2}
EFF_BATCH = 4


def jax_script(name: str):
    """``scripts/<name>.py`` of the JAX package, imported by path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("family", ["lcnn", "specrnet"])
def test_run_family_matches_jax(family, monkeypatch):
    jbe = jax_script("bench_effectiveness")
    length = WAVE[family]
    monkeypatch.setattr(jbe, "WAVE_LEN", length)
    monkeypatch.setattr(tbe, "WAVE_LEN", length)
    variables = jmodels.init_model(jmodels.get_model(family, LFCC), jax.random.PRNGKey(0),
                                   wave_length=length)
    want = jbe.run_family(family, LFCC, JAX_TABLES[family], batch=EFF_BATCH)

    table = JAX_TABLES[family]
    start = gradient_starts("PGD", jax.random.PRNGKey(1), (EFF_BATCH, length), 0.0005)
    replay_starts(monkeypatch, start * len(table))
    surrogates = {k: tbe.FAMILIES[family].surrogates[k] for k in table}
    got = tbe.run_family(family, surrogates, batch=EFF_BATCH, device="cpu",
                         state_dict=state_dict_from_flax(family, variables))
    for name in table:
        g, w = got[name], want[name]
        rel = abs(g["mean_abs_logit_shift"] - w["mean_abs_logit_shift"]) / w["mean_abs_logit_shift"]
        print(f"{family} {name}: shift port {g['mean_abs_logit_shift']:.6e} JAX "
              f"{w['mean_abs_logit_shift']:.6e} rel {rel:.2e}")
        assert rel <= SHIFT_RTOL[name], (name, g, w)
        assert g["flip_rate"] == w["flip_rate"], (name, g, w)
        assert g["examples_per_sec"] is None and g["first_call_s"] is None
        assert g["launches"] == {} and g["card"] == "cpu"


def test_effectiveness_table_covers_jax_rows():
    """The JAX table's rows, by family, plus the port's kernel rows."""
    src = (ROOT / "scripts" / "bench_effectiveness.py").read_text()
    jax_rows = set(re.findall(r'"((?:f32|bf16)_[a-z0-9_]+)": dict\(', src))
    port_rows = {k for fam in tbe.FAMILIES.values() for k in fam.surrogates}
    assert jax_rows <= port_rows
    assert port_rows - jax_rows == {"bf16_fused", "bf16_pool"}
    assert set(tbe.FAMILIES["rawnet3"].surrogates) == {
        "f32_surrogate", "bf16_trunk_f32_encoder", "bf16_trunk_bf16_encoder", "bf16_fused_b2n",
        "bf16_pool"}


def _jax_stock_names():
    src = (ROOT / "scripts" / "bench_attacks.py").read_text()
    block = src[src.index("    stock = {"):src.index("    return stock[name]")]
    return re.findall(r'^        "(\w+)": \(', block, re.M)


@pytest.mark.parametrize("name", list(ATTACK_REGISTRY) + list(tba.STOCK))
def test_resolve_matches_jax(name):
    want_fn, want_params = jax_script("bench_attacks")._resolve(name)
    got_fn, got_params = tba.resolve(name)
    assert (got_fn is None) == (want_fn is None)
    if got_fn is not None:
        assert got_fn.__name__ == want_fn.__name__
    assert got_params == want_params


def test_resolve_table_has_jax_names():
    assert _jax_stock_names() == list(tba.STOCK)


@pytest.fixture(scope="module")
def attack_rows(tmp_path_factory):
    """Both tools' rows for FGSM and PGD on the bf16 LCNN at 4,000 samples,
    batch 2, on the CPU (the JAX tool's output file and compilation cache in
    a temporary directory, its cache setting restored after)."""
    tmp = tmp_path_factory.mktemp("bench_attacks")
    jba = jax_script("bench_attacks")
    cache = jax.config.jax_compilation_cache_dir
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jba, "WAVE_LEN", 4_000)
        mp.setattr(jba, "OUT", tmp / "jax.json")
        mp.setattr(tba, "WAVE_LEN", 4_000)
        mp.setattr(sys, "argv", ["bench_attacks", "--attacks", "FGSM", "PGD", "--batch", "2",
                                 "--iters", "1", "--no-merge"])
        try:
            jba.main()
        finally:
            jax.config.update("jax_compilation_cache_dir", cache)
        got = tba.main(["--attacks", "FGSM", "PGD", "--batch", "2", "--no-merge", "--cpu",
                        "--out", str(tmp / "port.json")])
    assert json.loads((tmp / "port.json").read_text()) == got
    return got, json.loads((tmp / "jax.json").read_text())


def test_attack_rows_keys_match_jax(attack_rows):
    got, want = attack_rows
    assert set(got) == set(want) == {"FGSM@b2", "PGD@b2"}
    for key in got:
        expected = (set(want[key]) - {"compile_s"}) | {"first_call_s", "card"}
        assert set(got[key]) == expected, (key, got[key], want[key])
        assert got[key]["card"] == "cpu" and got[key]["mfu_pct"] is None


@pytest.mark.parametrize("key", ["FGSM@b2", "PGD@b2"])
def test_flops_per_example_matches_jax(attack_rows, key):
    got, want = attack_rows
    g, w = got[key]["flops_per_example"], want[key]["flops_per_example"]
    print(f"{key} FLOPs an example: port {g:.6e}, JAX {w:.6e}")
    assert abs(g - w) <= 0.01 * w
    assert 9.5 <= got["PGD@b2"]["flops_per_example"] / got["FGSM@b2"]["flops_per_example"] <= 10.5


def test_bench_train_rows(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "WAVE_LEN", 4_000)
    rows = tbt.main(["--batch", "2", "--iters", "1", "--cpu", "--out", str(tmp_path / "t.json")])
    # the JAX tool's row (scripts/bench_train.py:111-117), compile_s renamed
    jax_keys = {"examples_per_sec", "ms_per_step", "batch", "compile_s", "measured_at"}
    assert set(rows) == {"adv_train_fgsm_bce_bf16", "adv_train_fgsm_bce_f32"}
    for row in rows.values():
        assert jax_keys - {"compile_s"} | {"first_call_s", "card"} <= set(row)
        assert np.isfinite(row["loss"]) and row["examples_per_sec"] is None
    assert json.loads((tmp_path / "t.json").read_text()) == rows


@pytest.mark.parametrize("tool", [tba, tbe, tbt])
def test_tools_refuse_to_start_without_card_or_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the tool would run on it")
    with pytest.raises(SystemExit, match="--cpu"):
        tool.main([])
