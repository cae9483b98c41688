"""The port's ``config.py`` and ``utils/flops.py`` against the JAX
package's (CPU).

* ``ExperimentConfig`` / ``load_yaml``: the same fields as
  ``adaa_tpu.config`` on the reference schema, both checkpoint schemas,
  a yaml round trip, and every shipped config parsed alike.
* ``count_flops``: equal to JAX's for a dense layer, a conv and a grouped
  conv; for the f32 LCNN's PGD-2 at 16,000 samples (JAX with
  ``ADAA_FUSED_LCNN=0``, the port on its plain ops) and for the f32
  SpecRNet forward, within 1% of JAX's. The gap has one cause: JAX's
  BiLSTM runs both directions as one (2H, 8H) block-diagonal product per
  step, whose zero blocks it counts, where the port's batched (2, H, 4H)
  product counts half of that; the test prints both counts. A data-
  dependent loop's trips (``loop_trip``) count as ``while_trip`` first
  trips, and ``has_kernel`` is set when a kernel wrapper's launch
  counter moves.
"""
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from adaa_tpu import attacks as jattacks
from adaa_tpu import config as jconfig
from adaa_tpu import models as jmodels
from adaa_tpu.utils import flops as jflops
from adaa_tpu_torch import attacks as tattacks
from adaa_tpu_torch import config as tconfig
from adaa_tpu_torch.ops import layer0
from adaa_tpu_torch.utils import flops as tflops
from tests.torch_port_common import (CFG_F32, lcnn_variables, port_lcnn, port_specrnet,
                                     specrnet_variables, waves)

torch.set_num_threads(2)


def _same(a, b):
    assert dataclass_dict(a) == dataclass_dict(b)


def dataclass_dict(ec):
    return {"model": vars(ec.model), "seed": ec.seed, "checkpoint_path": ec.checkpoint_path,
            "adversarial_attacks": ec.adversarial_attacks, "raw": ec.raw}


@pytest.mark.parametrize("cfg", [
    {"data": {"seed": 7, "adversarial_attacks": ["FGSM"]},
     "checkpoint": {"path": "/x/ckpt.msgpack"},
     "model": {"name": "lcnn", "parameters": {"input_channels": 1}, "optimizer": {"lr": 1e-4}}},
    {"data": {}, "checkpoint": {"paths": ["/a", "/b"]}, "model": {"name": "rawnet3"}},
    {"model": {"name": "specrnet", "parameters": None}},
])
def test_experiment_config_matches_jax(cfg, tmp_path):
    ec = tconfig.ExperimentConfig.from_dict(cfg)
    _same(ec, jconfig.ExperimentConfig.from_dict(cfg))
    assert ec.to_dict() == jconfig.ExperimentConfig.from_dict(cfg).to_dict()
    ec.dump_yaml(tmp_path / "out.yaml")
    again = tconfig.ExperimentConfig.from_yaml(tmp_path / "out.yaml")
    _same(again, jconfig.ExperimentConfig.from_yaml(tmp_path / "out.yaml"))
    assert tconfig.load_yaml(tmp_path / "out.yaml") == jconfig.load_yaml(tmp_path / "out.yaml")


def test_shipped_configs_parse_as_in_jax():
    files = glob.glob("configs/**/*.yaml", recursive=True) + ["config.yaml", "batch_config.yaml"]
    assert len(files) > 10
    for f in files:
        loaded = tconfig.load_yaml(f)
        assert loaded == yaml.safe_load(open(f)), f
        if "model" in loaded:
            ec = tconfig.ExperimentConfig.from_dict(loaded)
            assert ec.model.name in ("lcnn", "specrnet", "rawnet3"), f
            _same(ec, jconfig.ExperimentConfig.from_dict(loaded))


def test_dense_conv_and_grouped_conv_equal_jax():
    jx = jnp.ones((4, 8))
    assert (tflops.count_flops(lambda x: x @ torch.ones(8, 16), torch.ones(4, 8))["flops"]
            == jflops.count_flops(lambda x: x @ jnp.ones((8, 16)), jx)["flops"] == 2 * 4 * 16 * 8)

    def jconv(x):
        return jax.lax.conv_general_dilated(x, jnp.ones((3, 3, 4, 16)), (1, 1), [(1, 1), (1, 1)],
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    got = tflops.count_flops(lambda x: F.conv2d(x, torch.ones(16, 4, 3, 3), padding=1),
                             torch.ones(2, 4, 10, 10))["flops"]
    assert got == jflops.count_flops(jconv, jnp.ones((2, 10, 10, 4)))["flops"]

    def jgrouped(x):
        return jax.lax.conv_general_dilated(x, jnp.ones((3, 2, 8)), (1,), [(1, 1)],
                                            dimension_numbers=("NWC", "WIO", "NWC"),
                                            feature_group_count=2)

    got = tflops.count_flops(lambda x: F.conv1d(x, torch.ones(8, 2, 3), padding=1, groups=2),
                             torch.ones(2, 4, 10))["flops"]
    assert got == jflops.count_flops(jgrouped, jnp.ones((2, 10, 4)))["flops"] == 2 * 160 * 6


def test_lcnn_pgd2_within_one_percent_of_jax(monkeypatch):
    monkeypatch.setenv("ADAA_FUSED_LCNN", "0")
    variables = lcnn_variables(0)
    x = tattacks.to_minmax(torch.from_numpy(waves(60, 2, 16_000)))[0]
    y = np.array([0, 1])
    override = {"steps": 2, "random_start": False}
    jfn = jattacks.make_logits_fn(jmodels.get_model("lcnn", CFG_F32),
                                  jax.tree_util.tree_map(jnp.asarray, variables))
    jatk = jattacks.build_attack("PGD", jfn, override)
    want = jflops.count_flops(jatk, jnp.asarray(x.numpy()), jnp.asarray(y),
                              jax.random.PRNGKey(0))
    model = port_lcnn(CFG_F32, variables)
    model.plain_ops = True
    tatk = tattacks.build_attack("PGD", tattacks.make_logits_fn(model), override)
    got = tflops.count_flops(tatk, x, torch.from_numpy(y), None)
    print(f"LCNN PGD-2 FLOPs: port {got['flops']:.6e}, JAX {want['flops']:.6e}")
    assert "has_kernel" not in got and "has_pallas" not in want
    assert abs(got["flops"] - want["flops"]) <= 0.01 * want["flops"]


def test_specrnet_forward_within_one_percent_of_jax():
    variables = specrnet_variables(0)
    x = waves(61, 2, 16_000)
    module = jmodels.get_model("specrnet", CFG_F32)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    want = jflops.count_flops(lambda a: module.apply(jvars, a), jnp.asarray(x))
    model = port_specrnet(CFG_F32, variables)
    with torch.no_grad():
        got = tflops.count_flops(model, torch.from_numpy(x))
    print(f"SpecRNet forward FLOPs: port {got['flops']:.6e}, JAX {want['flops']:.6e}")
    assert abs(got["flops"] - want["flops"]) <= 0.01 * want["flops"]


def test_data_dependent_loop_and_kernel_flags(monkeypatch):
    def loop(x, trips):
        for _ in range(trips):
            with tflops.loop_trip():
                x = x @ x
        return x

    one = tflops.count_flops(loop, torch.ones(8, 8), 1)
    three = tflops.count_flops(loop, torch.ones(8, 8), 3, while_trip=7)
    assert one == {"has_while": True, "flops": 2 * 8 * 8 * 8}
    assert three == {"has_while": True, "flops": 7 * 2 * 8 * 8 * 8}
    monkeypatch.setitem(layer0.LAUNCHES, "fwd", layer0.LAUNCHES["fwd"])

    def launches(x):
        layer0.LAUNCHES["fwd"] += 1  # what a kernel wrapper does when it launches
        return x @ x

    assert tflops.count_flops(launches, torch.ones(8, 8))["has_kernel"]
    assert "has_kernel" not in tflops.count_flops(lambda x: x @ x, torch.ones(8, 8))
