"""Detector factory (port of ``adaa_tpu/models/__init__.py``): LCNN,
RawNet3 and SpecRNet, and ``load_model`` from an experiment config."""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from adaa_tpu_torch import config as config_lib
from adaa_tpu_torch.models.lcnn import LCNN
from adaa_tpu_torch.models.rawnet3 import RawNet3
from adaa_tpu_torch.models.specrnet import SpecRNet

LOGGER = logging.getLogger(__name__)

WAVE_LENGTH = 64_600  # canonical input length (reference base_dataset.py:27)


def get_model(model_name: str, config: Dict[str, Any]) -> nn.Module:
    """Build a detector (uninitialised; see ``init_model``). bf16 when
    ``config["compute_dtype"] == "bfloat16"`` or ``ADAA_BF16=1``, as the
    JAX package's ``get_model`` chooses."""
    bf16 = config.get("compute_dtype") == "bfloat16" or os.environ.get("ADAA_BF16") == "1"
    compute_dtype = torch.bfloat16 if bf16 else None
    if model_name == "rawnet3":
        return RawNet3(compute_dtype=compute_dtype, fused_pool=config.get("fused_pool"),
                       fused_b2n=config.get("fused_b2n"))
    if model_name == "lcnn":
        return LCNN(
            input_channels=config.get("input_channels", 1),
            num_coefficients=config.get("num_coefficients", 80),
            frontend_algorithm=tuple(config.get("frontend_algorithm", [])),
            compute_dtype=compute_dtype,
            precision=config.get("precision"),
            fused_frontend=config.get("fused_frontend"),
            fused_trunk=config.get("fused_trunk"),
        )
    if model_name == "specrnet":
        return SpecRNet(
            input_channels=config.get("input_channels", 1),
            frontend_algorithm=tuple(config.get("frontend_algorithm", [])),
            compute_dtype=compute_dtype,
            fused_frontend=config.get("fused_frontend"),
        )
    raise ValueError(f"Model '{model_name}' not supported")


def init_model(module: nn.Module, generator: torch.Generator,
               device: Union[str, torch.device]) -> nn.Module:
    """Move ``module`` to ``device`` and draw its initial weights from
    ``generator`` (which must live on that device)."""
    module = module.to(device)
    module.reset_parameters(generator)
    return module


def load_model(model_config: Dict[str, Any], generator: torch.Generator,
               device: Union[str, torch.device]) -> nn.Module:
    """Build the detector of a full experiment config, its initial weights
    drawn from ``generator`` (on ``device``), then load the config's
    checkpoint if it names one (port of ``adaa_tpu.models.load_model``).

    Reference ``.pth`` / ``.pt`` state_dicts load directly (``module.``
    prefixes stripped); the JAX package's ``.msgpack`` checkpoints do not.
    """
    from adaa_tpu_torch.models.weights import load_state_dict

    model_name = model_config["model"]["name"]
    model_parameters = model_config["model"].get("parameters", {}) or {}
    model_path: Optional[str] = config_lib.resolve_checkpoint_path(
        model_config.get("checkpoint", {}) or {})
    model = init_model(get_model(model_name, model_parameters), generator, device)
    if model_path:
        if not model_path.endswith((".pth", ".pt")):
            raise NotImplementedError(
                f"checkpoint '{model_path}': only .pth/.pt state_dicts load in adaa_tpu_torch; "
                ".msgpack interop is a later slice (ROADMAP.md, queue 1)")
        model.load_state_dict(load_state_dict(model_path))
        LOGGER.info("Loaded weights on '%s' model, path: %s", model_name, model_path)
    return model
