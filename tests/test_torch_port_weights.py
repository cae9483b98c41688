"""Weight bridge: JAX variables <-> the port's reference-named state_dict.

All checks are bit-exact (transposes only), except the logit check
against the independent torch oracle: f32, within 1e-4 of max |logit|
(the oracle runs torch.stft, nn.LSTM and NCHW convs, so only the
summation order differs).
"""
import jax
import numpy as np
import torch

from adaa_tpu.models import torch_import
from adaa_tpu_torch import models as tmodels
from adaa_tpu_torch.models.weights import lcnn_state_dict_from_flax, load_state_dict
from tests.oracles.torch_models import TorchLCNN
from tests.torch_port_common import CFG_F32, lcnn_variables, port_lcnn, waves

torch.set_num_threads(2)


def test_round_trip_through_torch_import_bit_exact():
    v = lcnn_variables(0)
    sd = {k: t.numpy() for k, t in lcnn_state_dict_from_flax(v).items()}
    back = torch_import.lcnn_from_state_dict(sd, v)
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))


def test_key_set_is_the_reference_state_dict():
    oracle_keys = set(TorchLCNN(with_frontend=False).state_dict().keys())
    port = tmodels.get_model("lcnn", CFG_F32)
    assert set(port.state_dict().keys()) == oracle_keys
    assert set(lcnn_state_dict_from_flax(lcnn_variables(0)).keys()) == oracle_keys
    for k in ("m_transform.0.weight", "m_transform.5.running_var",
              "m_before_pooling.1.l_blstm.weight_hh_l0_reverse", "m_output_act.bias"):
        assert k in oracle_keys


def test_reference_checkpoint_loads_and_matches_oracle(tmp_path):
    sd = lcnn_state_dict_from_flax(lcnn_variables(1))
    path = tmp_path / "ckpt.pth"
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)  # DataParallel prefixes
    loaded = load_state_dict(str(path))
    assert set(loaded) == set(sd)

    oracle = TorchLCNN()
    oracle.load_state_dict(loaded, strict=False)  # the oracle also holds frontend buffers
    oracle.eval()
    port = tmodels.get_model("lcnn", CFG_F32)
    port.load_state_dict(loaded)
    port.eval()
    x = torch.from_numpy(waves(5, 2, 16_000))
    with torch.no_grad():
        z_oracle, z_port = oracle(x), port(x)
    tol = 1e-4 * float(z_oracle.abs().max())
    torch.testing.assert_close(z_port, z_oracle, rtol=0, atol=tol)


def test_port_lcnn_helper_carries_weights():
    v = lcnn_variables(2)
    model = port_lcnn(CFG_F32, v)
    np.testing.assert_array_equal(
        model.m_transform["6"].weight.detach().numpy(),
        v["params"]["conv6"]["kernel"].transpose(3, 2, 0, 1))
    assert not model.training
