"""The JAX package's ``.msgpack`` checkpoints in the port (CPU).

``adaa_tpu_torch/utils/msgpack.py`` decodes what
``flax.serialization.to_bytes`` writes without the ``msgpack`` module; the
port's ``load_model`` maps the decoded variable tree through the weight
bridge. Tolerances:
* the decoder against ``msgpack.unpackb`` (and flax's ``msgpack_restore``
  for its extension types and chunked arrays): equal;
* a checkpoint written by ``adaa_tpu.utils.checkpoints.save_checkpoint``
  and loaded by the port's ``load_model``: f32 logits within the bands of
  the model tests (LCNN and SpecRNet 1e-4 x max |logit|, RawNet3 1e-5).
* the encoder against ``msgpack.packb(use_bin_type=True)`` and flax's
  ``msgpack_serialize`` (chunks included): byte-equal;
* a checkpoint the port writes (``save_checkpoint_msgpack``), read by the
  JAX package's ``load_checkpoint`` into its model's variables: every
  leaf bit-equal to ``torch_import.import_state_dict`` of the same
  ``state_dict``; read back by the port: a ``state_dict`` bit-equal to the
  model's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from adaa_tpu import models as jmodels
from adaa_tpu.models import torch_import
from adaa_tpu.utils.checkpoints import load_checkpoint as jload_checkpoint
from adaa_tpu.utils.checkpoints import save_checkpoint as jsave_checkpoint
from adaa_tpu_torch import models as tmodels
from adaa_tpu_torch.utils import checkpoints as tckpt
from adaa_tpu_torch.utils import msgpack as tmsgpack
from tests.torch_port_common import (CFG_F32, lcnn_variables, port_lcnn, port_rawnet3,
                                     port_specrnet, rawnet3_variables, specrnet_variables,
                                     waves)

torch.set_num_threads(2)

leaves = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
          | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=40))
trees = st.recursive(leaves, lambda kids: st.lists(kids, max_size=20)
                     | st.dictionaries(st.text(max_size=8), kids, max_size=20), max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(tree=trees, single=st.booleans())
def test_decoder_matches_msgpack_on_random_trees(tree, single):
    data = msgpack.packb(tree, use_bin_type=True, use_single_float=single)
    assert tmsgpack.unpackb(data) == msgpack.unpackb(data, raw=False, strict_map_key=False)


@pytest.mark.parametrize("n", [15, 16, 255, 256, 65_535, 65_536])
def test_decoder_matches_msgpack_at_every_length_form(n):
    """fix / 8 / 16 / 32-bit lengths of strings, bin, arrays and maps, and
    the integers at each width's edges."""
    tree = {"s": "x" * n, "b": b"\x01" * n, "a": list(range(min(n, 70_000))),
            "m": {str(i): -i for i in range(n)},
            "i": [-(2**k) for k in (5, 7, 15, 31, 63)] + [2**k - 1 for k in (7, 8, 16, 32, 64)]}
    data = msgpack.packb(tree, use_bin_type=True)
    assert tmsgpack.unpackb(data) == msgpack.unpackb(data, raw=False)


def _tree_equal(a, b):
    assert type(a) is type(b) or isinstance(a, np.ndarray), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and a.shape == np.shape(b)
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_flax_extension_types_and_chunks(monkeypatch):
    rng = np.random.default_rng(0)
    tree = {"f32": rng.standard_normal((3, 4)).astype(np.float32),
            "i8": rng.integers(-5, 5, (7,)).astype(np.int8), "u64": np.arange(4, dtype=np.uint64),
            "f64": rng.standard_normal(()), "scalar": np.float32(2.5), "complex": 1.5 - 2j,
            "empty": np.zeros((0, 3), np.float32), "nested": {"bool": np.array([True, False])}}
    data = serialization.to_bytes(tree)
    _tree_equal(tmsgpack.restore(data), serialization.msgpack_restore(data))
    bf16 = jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16)
    got = tmsgpack.restore(serialization.to_bytes({"w": bf16}))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(bf16.astype(jnp.float32)))
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)  # 4 f32 per chunk
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    _tree_equal(tmsgpack.restore(data), serialization.msgpack_restore(data))


def test_malformed_data_raises():
    data = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError, match="truncated"):
        tmsgpack.unpackb(data[:-1])
    with pytest.raises(ValueError, match="extra data"):
        tmsgpack.unpackb(data + b"\x00")
    with pytest.raises(ValueError, match="invalid msgpack byte"):
        tmsgpack.unpackb(b"\xc1")
    with pytest.raises(ValueError, match="extension type 9"):
        tmsgpack.unpackb(msgpack.packb(msgpack.ExtType(9, b"x")))


MODELS = {
    "lcnn": (lambda: lcnn_variables(3), CFG_F32, 16_000, lambda zj: 1e-4 * np.abs(zj).max()),
    "specrnet": (lambda: specrnet_variables(3), CFG_F32, 16_000,
                 lambda zj: 1e-4 * np.abs(zj).max()),
    "rawnet3": (lambda: rawnet3_variables(3), {}, 5_041, lambda zj: 1e-5),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_jax_checkpoint_loads_in_the_port(tmp_path, name):
    make_variables, cfg, length, band = MODELS[name]
    variables = jax.tree_util.tree_map(jnp.asarray, make_variables())
    path = jsave_checkpoint(variables, tmp_path, f"aad__{name}__0", epoch=1)
    assert path.suffix == ".msgpack"
    config = {"data": {"seed": 1}, "model": {"name": name, "parameters": cfg},
              "checkpoint": {"path": str(path)}}
    module, jvars = jmodels.load_model(config)
    x = waves(70, 2, length)
    zj = np.asarray(module.apply(jvars, jnp.asarray(x), train=False))
    model = tmodels.load_model(config, torch.Generator().manual_seed(9), "cpu").eval()
    with torch.no_grad():
        zt = model(torch.from_numpy(x)).numpy()
    assert zt.shape == zj.shape == (2, 1)
    assert np.abs(zt - zj).max() <= band(zj)
    sd = tckpt.load_checkpoint(path, name)
    assert set(sd) == set(model.state_dict())


def test_load_checkpoint_needs_a_known_suffix_and_the_model_name(tmp_path):
    path = jsave_checkpoint(jax.tree_util.tree_map(jnp.asarray, lcnn_variables(0)), tmp_path, "x")
    with pytest.raises(ValueError, match="model's name"):
        tckpt.load_checkpoint(path)
    with pytest.raises(ValueError, match=r"\.pth, \.pt or \.msgpack"):
        tckpt.load_checkpoint(tmp_path / "model.ckpt", "lcnn")


def test_evaluate_cli_loads_a_msgpack_checkpoint(tmp_path, monkeypatch):
    from adaa_tpu_torch.eval import evaluation
    from adaa_tpu_torch.scripts import evaluate_models

    monkeypatch.chdir(tmp_path)
    path = jsave_checkpoint(jax.tree_util.tree_map(jnp.asarray, specrnet_variables(4)), tmp_path,
                            "aad__specrnet__0")
    config = {"data": {"seed": 2}, "model": {"name": "specrnet", "parameters": CFG_F32},
              "checkpoint": {"path": str(path)}}
    args = evaluate_models.parse_args(["--asv_path", "synthetic:8:16000", "--cpu"])
    monkeypatch.setattr(evaluation, "evaluate_nn", lambda model, dataset, **kw: model)
    model = evaluate_models.run(args, config)
    want = tckpt.load_checkpoint(path, "specrnet")
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


@settings(max_examples=150, deadline=None)
@given(tree=trees)
def test_encoder_matches_msgpack_on_random_trees(tree):
    assert tmsgpack.packb(tree) == msgpack.packb(tree, use_bin_type=True)


def test_encoder_matches_flax_with_extension_types_and_chunks(monkeypatch):
    rng = np.random.default_rng(1)
    tree = {"f32": rng.standard_normal((3, 4)).astype(np.float32), "z": {"b": np.int8(3)},
            "i8": rng.integers(-5, 5, (7,)).astype(np.int8), "u64": np.arange(4, dtype=np.uint64),
            "empty": np.zeros((0, 3), np.float32), "complex": 1.5 - 2j, "nested": {}}
    assert tmsgpack.serialize(tree) == serialization.msgpack_serialize(tree)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    monkeypatch.setattr(tmsgpack, "MAX_CHUNK_SIZE", 16)
    data = tmsgpack.serialize(tree)
    assert b"__msgpack_chunked_array__" in data and data == serialization.msgpack_serialize(tree)


PORTS = {"lcnn": port_lcnn, "specrnet": port_specrnet, "rawnet3": port_rawnet3}


@pytest.mark.parametrize("name", list(MODELS))
def test_port_writes_what_jax_reads(tmp_path, name):
    make_variables, cfg, _, _ = MODELS[name]
    variables = make_variables()
    model = PORTS[name](cfg, variables)
    path = tckpt.save_checkpoint_msgpack(model, tmp_path, f"aad__{name}__0", epoch=2)
    assert path == tmp_path / f"aad__{name}__0" / "ckpt_02.msgpack"
    target = jmodels.init_model(jmodels.get_model(name, cfg), jax.random.PRNGKey(0),
                                wave_length=16_000 if name != "rawnet3" else 5_041)
    got = jload_checkpoint(path, target)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    want = torch_import.import_state_dict(name, sd, target)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_got) == len(flat_want)
    for key, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[key]), np.asarray(leaf), err_msg=str(key))
    back = tckpt.load_checkpoint(path, name)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
