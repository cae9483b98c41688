"""Weights in and out of the port's models.

``lcnn_state_dict_from_flax`` is the inverse of
``adaa_tpu/models/torch_import.py:lcnn_from_state_dict``: it turns the
JAX LCNN's ``{"params", "batch_stats"}`` tree (as numpy arrays) into a
``state_dict`` with the reference's key names, which the port's LCNN
loads with ``load_state_dict``.

* conv kernels HWIO (kh, kw, I, O) -> OIHW (O, I, kh, kw)
* linear kernels (I, O) -> (O, I)
* LSTM weights (D, 4H) -> (4H, D), gate order (i, f, g, o) unchanged
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from adaa_tpu_torch.models.lcnn import BNS, CONVS


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


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference ``.pth`` state_dict, stripping DataParallel ``module.`` prefixes."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k.removeprefix("module."): v for k, v in sd.items()}
