"""Weights in and out of the port's models.

``lcnn_state_dict_from_flax`` and ``rawnet3_state_dict_from_flax`` are
the inverses of ``adaa_tpu/models/torch_import.py``'s
``lcnn_from_state_dict`` and ``rawnet3_from_state_dict``: they turn the
JAX model's ``{"params", "batch_stats"}`` tree (as numpy arrays) into a
``state_dict`` with the reference's key names, which the port's model
loads with ``load_state_dict``.

* 2-D conv kernels HWIO (kh, kw, I, O) -> OIHW (O, I, kh, kw)
* 1-D conv kernels (K, I, O) -> (O, I, K)
* linear kernels (I, O) -> (O, I)
* LSTM weights (D, 4H) -> (4H, D), gate order (i, f, g, o) unchanged
* RawNet3's ``afms.alpha`` (C,) -> (C, 1); the sinc filterbank's
  constant ``window_`` / ``n_`` buffers and the unused ``bn6``, which
  the JAX model does not hold, come from a fresh port model.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from adaa_tpu_torch.models.lcnn import BNS, CONVS
from adaa_tpu_torch.models.rawnet3 import RawNet3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def lcnn_state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for i in CONVS:
        p = params[f"conv{i}"]
        sd[f"m_transform.{i}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        sd[f"m_transform.{i}.bias"] = _t(p["bias"])
    for i in BNS:
        s = stats[f"bn{i}"]
        sd[f"m_transform.{i}.running_mean"] = _t(s["mean"])
        sd[f"m_transform.{i}.running_var"] = _t(s["var"])
        sd[f"m_transform.{i}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    for j in (0, 1):
        for sfx, direction in (("l0", "fwd"), ("l0_reverse", "bwd")):
            p = params[f"blstm{j}"][direction]
            prefix = f"m_before_pooling.{j}.l_blstm"
            sd[f"{prefix}.weight_ih_{sfx}"] = _t(np.asarray(p["weight_ih"]).T)
            sd[f"{prefix}.weight_hh_{sfx}"] = _t(np.asarray(p["weight_hh"]).T)
            sd[f"{prefix}.bias_ih_{sfx}"] = _t(p["bias_ih"])
            sd[f"{prefix}.bias_hh_{sfx}"] = _t(p["bias_hh"])
    sd["m_output_act.weight"] = _t(np.asarray(params["output"]["kernel"]).T)
    sd["m_output_act.bias"] = _t(params["output"]["bias"])
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
        sd[f"{name}.afms.fc.weight"] = _t(np.asarray(p["afms"]["fc"]["kernel"]).T)
        sd[f"{name}.afms.fc.bias"] = _t(p["afms"]["fc"]["bias"])
    _conv1d(sd, "layer4", params["layer4"])
    _conv1d(sd, "attention.0", params["attention_0"])
    _bn(sd, "attention.2", params["attention_2"], stats["attention_2"])
    _conv1d(sd, "attention.3", params["attention_3"])
    _bn(sd, "bn5", params["bn5"], stats["bn5"])
    sd["fc6.weight"] = _t(np.asarray(params["fc6"]["kernel"]).T)
    sd["fc6.bias"] = _t(params["fc6"]["bias"])
    return sd


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference ``.pth`` state_dict, stripping DataParallel ``module.`` prefixes."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k.removeprefix("module."): v for k, v in sd.items()}
