"""The port's examples (``adaa_tpu_torch/examples``) against the JAX
package's ``examples/`` on the CPU.

* ``performance_comparison.norms`` equals the JAX function on the same
  deltas (exactly: the same numpy code).
* ``attack_demo``: its FGSM_eps001 and PGDL2_eps20 batches on the JAX
  example's seed-0 LCNN weights (through ``weights.state_dict_from_flax``)
  against JAX's ``attack_in_wave_space`` on the same synthetic batch (16 x
  16,000), PGDL2's random start replayed from the JAX key
  (``tests/torch_port_draws.py``). FGSM: >= 99.9% of the coordinates within
  1e-5 (measured 0.999984; a coordinate whose f32 gradient is near zero can
  take the other sign, 2 eps away). PGDL2-10 is chaotic on this detector:
  the gap doubles each step (relative L2 1.3e-3 after one, 0.28 after five),
  and JAX's own op-by-op run lies 0.45 from its jitted run. So each row's
  radius in [0, 1] space equals JAX's within 1e-4 (both end on the eps
  sphere, or inside it where the box clamp trims the last step: 1.4e-5
  measured), and the port's relative L2 gap to the jitted JAX run is at
  most twice the op-by-op JAX run's (+ 1e-3). The ``.npz`` has the JAX keys.
* ``transfer_attack`` and ``robustness_pipeline`` run ``run()`` at a tiny
  size (``--train-n 16 --epochs 1 --cpu``; robustness at 4,000 samples,
  transfer at 16,000, the shortest that leaves SpecRNet's GRU a frame), with
  the trainers' batch cut from 64 to 4 so that 16 samples make batches at
  all (at 64, ``drop_last`` leaves no test batch and the adversarial
  trainer's multi-F1 divides by zero, in both packages). The returned keys
  are the tags of the lines the JAX example prints; every accuracy is finite
  and in [0, 1]. The training-driven numbers are not held to JAX's: the JAX
  examples shuffle with JAX's PRNG, and
  ``tests/test_torch_port_training.py`` already holds the trainers.
"""
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu import attacks as jattacks
from adaa_tpu import models as jmodels
from adaa_tpu.attacks import core as jcore
from adaa_tpu.attacks.save import save_adversarial_dataset as jsave
from adaa_tpu.data.loader import DataLoader as JDataLoader
from adaa_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from adaa_tpu_torch import attacks as tattacks
from adaa_tpu_torch.attacks.save import save_adversarial_dataset as tsave
from adaa_tpu_torch.examples import (_common, attack_demo, performance_comparison,
                                     robustness_pipeline, transfer_attack)
from adaa_tpu_torch.models.weights import state_dict_from_flax
from tests.torch_port_common import port_lcnn
from tests.torch_port_draws import gradient_starts, replay_starts

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
LFCC = {"input_channels": 1, "frontend_algorithm": ["lfcc"]}
DEMO_ATOL = 1e-5
FGSM_SHARE = 0.999
# a row whose last step hits the [0, 1] box ends inside the eps sphere (the
# clamp took 2.5e-5 off one row's radius, 1.4e-5 more than JAX's)
RADIUS_ATOL = 1e-4


def jax_example(name: str):
    """``examples/<name>.py`` of the JAX package, imported by path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def printed_tags(name: str):
    """The ``[tag]`` of each line the JAX example prints."""
    return set(re.findall(r'print\(f?"\[(\w+)\]', (ROOT / "examples" / f"{name}.py").read_text()))


def accuracies(tree):
    """Every accuracy in a ``run()`` result (the seconds left out)."""
    if isinstance(tree, dict):
        return [a for k, v in tree.items() if k not in ("train", "advtrain")
                for a in accuracies(v)]
    return [tree]


def test_norms_match_jax():
    rng = np.random.default_rng(3)
    delta = rng.standard_normal((5, 7, 3)).astype(np.float32) * 1e-3
    delta[1] = 0.0
    delta[2, :4] = 1e-10  # below the L0 threshold
    want = jax_example("performance_comparison").norms(delta)
    assert performance_comparison.norms(delta) == want


@pytest.fixture(scope="module")
def demo():
    """The JAX example's seed-0 LCNN and its first synthetic batch, both sides."""
    module = jmodels.get_model("lcnn", LFCC)
    variables = jmodels.init_model(module, jax.random.PRNGKey(0),
                                   wave_length=attack_demo.WAVE_LEN)
    ds = JSyntheticDataset(n=32, subset="val", wave_length=attack_demo.WAVE_LEN)
    batch = next(iter(JDataLoader(ds, 16, shuffle=False, num_workers=1)))
    x, y = _common.first_batch(attack_demo.dataset(), 16, "cpu")
    np.testing.assert_array_equal(x.numpy(), batch[0])
    np.testing.assert_array_equal(y.numpy(), batch[2])
    return (jcore.make_logits_fn(module, variables), (jnp.asarray(batch[0]), jnp.asarray(batch[2])),
            port_lcnn(LFCC, variables), (x, y))


def test_attack_demo_fgsm_matches_jax(demo):
    jfn, (jx, jy), model, (x, y) = demo
    want = np.asarray(jax.jit(jcore.attack_in_wave_space(
        jattacks.build_attack("FGSM_eps001", jfn)))(jx, jy, jax.random.PRNGKey(1)))
    got = _common.attacked("FGSM_eps001", tattacks.make_logits_fn(model), x, y,
                           torch.Generator().manual_seed(1)).numpy()
    share = np.mean(np.abs(got - want) <= DEMO_ATOL)
    print(f"FGSM_eps001: share within {DEMO_ATOL}: {share:.6f}")
    assert not np.array_equal(want, np.asarray(jx))
    assert share >= FGSM_SHARE


def test_attack_demo_pgdl2_matches_jax(demo, monkeypatch):
    jfn, (jx, jy), model, (x, y) = demo
    atk = jcore.attack_in_wave_space(jattacks.build_attack("PGDL2_eps20", jfn))
    want = np.asarray(jax.jit(atk)(jx, jy, jax.random.PRNGKey(1)))
    jax_again = np.asarray(atk(jx, jy, jax.random.PRNGKey(1)))  # op by op
    eps = tattacks.ATTACK_REGISTRY["PGDL2_eps20"][1]["eps"]
    replay_starts(monkeypatch, gradient_starts("PGDL2", jax.random.PRNGKey(1), x.shape, eps))
    got = _common.attacked("PGDL2_eps20", tattacks.make_logits_fn(model), x, y,
                           torch.Generator().manual_seed(1)).numpy()
    jx = np.asarray(jx)
    scale = jx.max(axis=1, keepdims=True) - jx.min(axis=1, keepdims=True)

    def radius(adv):
        return np.linalg.norm((adv - jx) / scale, axis=1)

    gap = np.linalg.norm(got - want) / np.linalg.norm(want - jx)
    jax_gap = np.linalg.norm(jax_again - want) / np.linalg.norm(want - jx)
    print(f"PGDL2_eps20: port vs JAX {gap:.3e}, JAX op by op vs jitted {jax_gap:.3e}")
    np.testing.assert_allclose(radius(got), radius(want), atol=RADIUS_ATOL)
    assert gap <= 2 * jax_gap + 1e-3


def test_npz_keys_match_jax(tmp_path):
    ds = JSyntheticDataset(n=4, subset="val", wave_length=800)
    jlin = lambda x: x.mean(axis=-1, keepdims=True) - 0.5  # noqa: E731
    tlin = lambda x: x.mean(dim=-1, keepdim=True) - 0.5  # noqa: E731
    jsave(jattacks.build_attack("FGSM_eps001", jlin), jlin, JDataLoader(ds, 2, shuffle=False),
          save_path=str(tmp_path / "jax.npz"), verbose=False)
    tsave(tattacks.build_attack("FGSM_eps001", tlin), tlin, JDataLoader(ds, 2, shuffle=False),
          save_path=str(tmp_path / "port.npz"), verbose=False, device="cpu")
    with np.load(tmp_path / "jax.npz") as j, np.load(tmp_path / "port.npz") as t:
        assert sorted(j.files) == sorted(t.files)


def test_attack_demo_runs(tmp_path, monkeypatch):
    monkeypatch.setattr(attack_demo, "WAVE_LEN", 4_000)
    out = attack_demo.run(cpu=True, save_path=str(tmp_path / "adv.npz"))
    assert set(out["attacks"]) == {"FGSM_eps001", "PGD_eps001", "PGDL2_eps20", "FAB"}
    for row in out["attacks"].values():
        assert 0 <= row["robust_accuracy"] <= 1 and np.isfinite(row["max_abs_delta"])
    assert 0 <= out["clean_accuracy"] <= 1 and 0 <= out["saved"]["robust_accuracy_pct"] <= 100
    with np.load(tmp_path / "adv.npz") as saved:
        assert saved["adv_inputs"].shape == (32, 4_000) and saved["labels"].shape == (32,)


def test_performance_comparison_runs(monkeypatch):
    monkeypatch.setattr(performance_comparison, "WAVE_LEN", 4_000)
    out = performance_comparison.run(batch=4, cpu=True)
    assert list(out["attacks"]) == performance_comparison.DEFAULT_ATTACKS
    for name, row in out["attacks"].items():
        assert 0 <= row["success"] <= 1, name
        assert all(np.isfinite(row[k]) and row[k] >= 0 for k in ("time_s", "l0", "l2", "linf"))


@pytest.mark.parametrize("example,wave_len", [(transfer_attack, 16_000),
                                              (robustness_pipeline, 4_000)])
def test_trained_detector_example_runs(example, wave_len, monkeypatch):
    monkeypatch.setattr(example, "BATCH", 4)
    out = example.run(wave_len=wave_len, train_n=16, epochs=1, cpu=True)
    tags = printed_tags(example.__name__.rsplit(".", 1)[1])
    if example is transfer_attack:
        tags.add("attack")  # the white-box / transfer table, under its "attack" header
    assert set(out) == tags, (set(out), tags)
    accs = accuracies(out)
    assert accs and all(np.isfinite(a) and 0 <= a <= 1 for a in accs), out


@pytest.mark.parametrize("example", [attack_demo, performance_comparison, transfer_attack,
                                     robustness_pipeline])
def test_examples_refuse_to_start_without_card_or_cpu(example):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the example would run on it")
    with pytest.raises(SystemExit, match="--cpu"):
        example.main([])
