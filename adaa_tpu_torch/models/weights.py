"""Weights in and out of the port's models.

``lcnn_state_dict_from_flax``, ``rawnet3_state_dict_from_flax`` and
``specrnet_state_dict_from_flax`` (``state_dict_from_flax`` by model name,
which reads the JAX package's ``.msgpack`` checkpoints) are the inverses of
``adaa_tpu/models/torch_import.py``'s ``lcnn_from_state_dict``,
``rawnet3_from_state_dict`` and ``specrnet_from_state_dict``: they turn the
JAX model's ``{"params", "batch_stats"}`` tree (as numpy arrays) into a
``state_dict`` with the reference's key names, which the port's model
loads with ``load_state_dict``.

* 2-D conv kernels HWIO (kh, kw, I, O) -> OIHW (O, I, kh, kw)
* 1-D conv kernels (K, I, O) -> (O, I, K)
* linear kernels (I, O) -> (O, I)
* LSTM / GRU weights (D, G*H) -> (G*H, D), gate order (i, f, g, o) /
  (r, z, n) unchanged
* RawNet3's ``afms.alpha`` (C,) -> (C, 1); the sinc filterbank's
  constant ``window_`` / ``n_`` buffers and the unused ``bn6``, which
  the JAX model does not hold, come from a fresh port model.

``lcnn_flax_from_state_dict``, ``rawnet3_flax_from_state_dict`` and
``specrnet_flax_from_state_dict`` (``flax_from_state_dict`` by name) go
the other way: the port's copies of ``torch_import``'s converters, which
build the JAX model's variable tree (numpy f32) from a ``state_dict``;
``utils/checkpoints.save_checkpoint_msgpack`` writes it.

``extra_state_dict_from_flax`` maps the variable tree of one of the JAX
package's unwired detectors (``adaa_tpu/models/extra.py``) onto the
port's ``models/extra.py``. No reference ``.pth`` layout exists for them
and the JAX package has no converter, so the port's modules carry the
JAX module names and the keys are those names with torch's parameter
names and layouts: ``kernel`` -> ``weight`` (transposed as above),
``scale`` -> ``weight``, ``mean`` / ``var`` -> ``running_mean`` /
``running_var``, GRU weights transposed.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from adaa_tpu_torch.models.lcnn import BNS, CONVS
from adaa_tpu_torch.models.rawnet3 import RawNet3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv2d(sd, key: str, params) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(params["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{key}.bias"] = _t(params["bias"])


def _linear(sd, key: str, params) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(params["kernel"]).T)
    sd[f"{key}.bias"] = _t(params["bias"])


def _rnn_dir(sd, prefix: str, sfx: str, params) -> None:
    """One direction of one LSTM / GRU layer (``sfx``: ``l0``, ``l1_reverse``, ...)."""
    for name in ("weight_ih", "weight_hh"):
        sd[f"{prefix}.{name}_{sfx}"] = _t(np.asarray(params[name]).T)
    for name in ("bias_ih", "bias_hh"):
        sd[f"{prefix}.{name}_{sfx}"] = _t(params[name])


def lcnn_state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for i in CONVS:
        _conv2d(sd, f"m_transform.{i}", params[f"conv{i}"])
    for i in BNS:
        s = stats[f"bn{i}"]
        sd[f"m_transform.{i}.running_mean"] = _t(s["mean"])
        sd[f"m_transform.{i}.running_var"] = _t(s["var"])
        sd[f"m_transform.{i}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    for j in (0, 1):
        for sfx, direction in (("l0", "fwd"), ("l0_reverse", "bwd")):
            _rnn_dir(sd, f"m_before_pooling.{j}.l_blstm", sfx, params[f"blstm{j}"][direction])
    _linear(sd, "m_output_act", params["output"])
    return sd


def _bn(sd, key: str, params, stats) -> None:
    sd[f"{key}.weight"] = _t(params["scale"])
    sd[f"{key}.bias"] = _t(params["bias"])
    sd[f"{key}.running_mean"] = _t(stats["mean"])
    sd[f"{key}.running_var"] = _t(stats["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _conv1d(sd, key: str, params) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(params["kernel"]).transpose(2, 1, 0))
    if "bias" in params:
        sd[f"{key}.bias"] = _t(params["bias"])


def rawnet3_state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    params, stats = variables["params"], variables["batch_stats"]
    sd = {k: v.clone() for k, v in RawNet3().state_dict().items()
          if k.startswith("bn6.") or k.endswith((".window_", ".n_"))}
    sd["preprocess.1.weight"] = _t(params["instancenorm_weight"])
    sd["preprocess.1.bias"] = _t(params["instancenorm_bias"])
    sd["conv1.filterbank.low_hz_"] = _t(params["conv1"]["low_hz_"])
    sd["conv1.filterbank.band_hz_"] = _t(params["conv1"]["band_hz_"])
    for name in ("layer1", "layer2", "layer3"):
        p, s = params[name], stats[name]
        _conv1d(sd, f"{name}.conv1", p["conv1"])
        _bn(sd, f"{name}.bn1", p["bn1"], s["bn1"])
        for i in range(7):
            _conv1d(sd, f"{name}.convs.{i}", p[f"convs_{i}"])
            _bn(sd, f"{name}.bns.{i}", p[f"bns_{i}"], s[f"bns_{i}"])
        _conv1d(sd, f"{name}.conv3", p["conv3"])
        _bn(sd, f"{name}.bn3", p["bn3"], s["bn3"])
        if "residual" in p:
            _conv1d(sd, f"{name}.residual.0", p["residual"])
        sd[f"{name}.afms.alpha"] = _t(np.asarray(p["afms"]["alpha"]).reshape(-1, 1))
        _linear(sd, f"{name}.afms.fc", p["afms"]["fc"])
    _conv1d(sd, "layer4", params["layer4"])
    _conv1d(sd, "attention.0", params["attention_0"])
    _bn(sd, "attention.2", params["attention_2"], stats["attention_2"])
    _conv1d(sd, "attention.3", params["attention_3"])
    _bn(sd, "bn5", params["bn5"], stats["bn5"])
    _linear(sd, "fc6", params["fc6"])
    return sd


def specrnet_state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _bn(sd, "first_bn", params["first_bn"], stats["first_bn"])
    for blk in ("block0", "block2", "block4"):
        p, s = params[blk], stats[blk]
        if "bn1" in p:
            _bn(sd, f"{blk}.0.bn1", p["bn1"], s["bn1"])
        for conv in ("conv1", "conv2", "conv_downsample"):
            if conv in p:
                _conv2d(sd, f"{blk}.0.{conv}", p[conv])
        _bn(sd, f"{blk}.0.bn2", p["bn2"], s["bn2"])
    for i in (0, 2, 4):
        _linear(sd, f"fc_attention{i}.0", params[f"fc_attention{i}"])
    _bn(sd, "bn_before_gru", params["bn_before_gru"], stats["bn_before_gru"])
    for layer in (0, 1):
        for sfx, direction in ((f"l{layer}", "fwd"), (f"l{layer}_reverse", "bwd")):
            _rnn_dir(sd, "gru", sfx, params["gru"][f"l{layer}_{direction}"])
    _linear(sd, "fc1_gru", params["fc1_gru"])
    _linear(sd, "fc2_gru", params["fc2_gru"])
    return sd


FROM_FLAX = {"lcnn": lcnn_state_dict_from_flax, "rawnet3": rawnet3_state_dict_from_flax,
             "specrnet": specrnet_state_dict_from_flax}


def state_dict_from_flax(model_name: str, variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the JAX model ``model_name``'s variable tree."""
    if model_name not in FROM_FLAX:
        raise ValueError(f"no flax weight bridge for model '{model_name}'")
    return FROM_FLAX[model_name](variables)


def _kernel_to_torch(a: np.ndarray) -> np.ndarray:
    """A flax kernel in torch's layout: (K..., I, O) -> (O, I, K...); (I, O) -> (O, I)."""
    return a.T if a.ndim == 2 else a.transpose(a.ndim - 1, a.ndim - 2, *range(a.ndim - 2))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def extra_state_dict_from_flax(model_name: str,
                               variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of an unwired detector's JAX variable tree
    (``model_name`` as ``extra.get_extra_model`` takes it; module doc)."""
    if model_name not in ("rawnet2", "mesonet", "meso4", "meso_inception4", "xception"):
        raise ValueError(f"Extra model '{model_name}' not supported")
    params = {"kernel": ("weight", _kernel_to_torch), "scale": ("weight", None),
              "bias": ("bias", None), "weight_ih": ("weight_ih", np.transpose),
              "weight_hh": ("weight_hh", np.transpose), "bias_ih": ("bias_ih", None),
              "bias_hh": ("bias_hh", None)}
    sd: Dict[str, torch.Tensor] = {}
    for path, a in _flat(variables["params"]):
        name, fn = params[path[-1]]
        sd[".".join(path[:-1] + (name,))] = _t(fn(a) if fn else a)
    for path, a in _flat(variables.get("batch_stats", {})):
        key = ".".join(path[:-1])
        sd[f"{key}.running_{path[-1]}"] = _t(a)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


# ---------------------------------------------------------------------------
# state_dict -> the JAX model's variable tree
# ---------------------------------------------------------------------------

def _n(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _f_conv(sd, key: str) -> Dict[str, np.ndarray]:
    p = {"kernel": _n(sd[f"{key}.weight"]).transpose(*range(2, sd[f"{key}.weight"].dim()), 1, 0)}
    if f"{key}.bias" in sd:
        p["bias"] = _n(sd[f"{key}.bias"])
    return p


def _f_linear(sd, key: str) -> Dict[str, np.ndarray]:
    return {"kernel": _n(sd[f"{key}.weight"]).T, "bias": _n(sd[f"{key}.bias"])}


def _f_bn(sd, key: str, affine: bool = True):
    """(params, batch_stats) of one BatchNorm."""
    params = {"scale": _n(sd[f"{key}.weight"]), "bias": _n(sd[f"{key}.bias"])} if affine else {}
    return params, {"mean": _n(sd[f"{key}.running_mean"]), "var": _n(sd[f"{key}.running_var"])}


def _f_rnn(sd, prefix: str, sfx: str) -> Dict[str, np.ndarray]:
    return {"weight_ih": _n(sd[f"{prefix}.weight_ih_{sfx}"]).T,
            "weight_hh": _n(sd[f"{prefix}.weight_hh_{sfx}"]).T,
            "bias_ih": _n(sd[f"{prefix}.bias_ih_{sfx}"]),
            "bias_hh": _n(sd[f"{prefix}.bias_hh_{sfx}"])}


def lcnn_flax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    params = {f"conv{i}": _f_conv(sd, f"m_transform.{i}") for i in CONVS}
    stats = {f"bn{i}": _f_bn(sd, f"m_transform.{i}", affine=False)[1] for i in BNS}
    for j in (0, 1):
        prefix = f"m_before_pooling.{j}.l_blstm"
        params[f"blstm{j}"] = {"fwd": _f_rnn(sd, prefix, "l0"),
                               "bwd": _f_rnn(sd, prefix, "l0_reverse")}
    params["output"] = _f_linear(sd, "m_output_act")
    return {"params": params, "batch_stats": stats}


def specrnet_flax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    params, stats = {}, {}
    params["first_bn"], stats["first_bn"] = _f_bn(sd, "first_bn")
    for blk, first in (("block0", True), ("block2", False), ("block4", False)):
        key, bp, bs = f"{blk}.0", {}, {}
        if not first:
            bp["bn1"], bs["bn1"] = _f_bn(sd, f"{key}.bn1")
        bp["conv1"] = _f_conv(sd, f"{key}.conv1")
        bp["bn2"], bs["bn2"] = _f_bn(sd, f"{key}.bn2")
        bp["conv2"] = _f_conv(sd, f"{key}.conv2")
        if f"{key}.conv_downsample.weight" in sd:
            bp["conv_downsample"] = _f_conv(sd, f"{key}.conv_downsample")
        params[blk], stats[blk] = bp, bs
    for i in (0, 2, 4):
        params[f"fc_attention{i}"] = _f_linear(sd, f"fc_attention{i}.0")
    params["bn_before_gru"], stats["bn_before_gru"] = _f_bn(sd, "bn_before_gru")
    params["gru"] = {f"l{layer}_{d}": _f_rnn(sd, "gru", f"l{layer}{sfx}")
                     for layer in (0, 1) for d, sfx in (("fwd", ""), ("bwd", "_reverse"))}
    params["fc1_gru"] = _f_linear(sd, "fc1_gru")
    params["fc2_gru"] = _f_linear(sd, "fc2_gru")
    return {"params": params, "batch_stats": stats}


def rawnet3_flax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    params = {"instancenorm_weight": _n(sd["preprocess.1.weight"]),
              "instancenorm_bias": _n(sd["preprocess.1.bias"]),
              "conv1": {"low_hz_": _n(sd["conv1.filterbank.low_hz_"]),
                        "band_hz_": _n(sd["conv1.filterbank.band_hz_"])}}
    stats = {}
    for name in ("layer1", "layer2", "layer3"):
        lp, ls = {"conv1": _f_conv(sd, f"{name}.conv1")}, {}
        lp["bn1"], ls["bn1"] = _f_bn(sd, f"{name}.bn1")
        for i in range(7):
            lp[f"convs_{i}"] = _f_conv(sd, f"{name}.convs.{i}")
            lp[f"bns_{i}"], ls[f"bns_{i}"] = _f_bn(sd, f"{name}.bns.{i}")
        lp["conv3"] = _f_conv(sd, f"{name}.conv3")
        lp["bn3"], ls["bn3"] = _f_bn(sd, f"{name}.bn3")
        if f"{name}.residual.0.weight" in sd:
            lp["residual"] = _f_conv(sd, f"{name}.residual.0")
        lp["afms"] = {"alpha": _n(sd[f"{name}.afms.alpha"]).reshape(-1),
                      "fc": _f_linear(sd, f"{name}.afms.fc")}
        params[name], stats[name] = lp, ls
    params["layer4"] = _f_conv(sd, "layer4")
    params["attention_0"] = _f_conv(sd, "attention.0")
    params["attention_2"], stats["attention_2"] = _f_bn(sd, "attention.2")
    params["attention_3"] = _f_conv(sd, "attention.3")
    params["bn5"], stats["bn5"] = _f_bn(sd, "bn5")
    params["fc6"] = _f_linear(sd, "fc6")  # bn6: not in the JAX model
    return {"params": params, "batch_stats": stats}


TO_FLAX = {"lcnn": lcnn_flax_from_state_dict, "rawnet3": rawnet3_flax_from_state_dict,
           "specrnet": specrnet_flax_from_state_dict}


def flax_from_state_dict(model_name: str, sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The JAX model ``model_name``'s variable tree of a port ``state_dict``."""
    if model_name not in TO_FLAX:
        raise ValueError(f"no flax weight bridge for model '{model_name}'")
    return TO_FLAX[model_name](sd)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference ``.pth`` state_dict, stripping DataParallel ``module.`` prefixes."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k.removeprefix("module."): v for k, v in sd.items()}
