"""Detector factory (port of ``adaa_tpu/models/__init__.py``).

LCNN and RawNet3 are ported; SpecRNet is in ROADMAP.md.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Union

import torch
from torch import nn

from adaa_tpu_torch.models.lcnn import LCNN
from adaa_tpu_torch.models.rawnet3 import RawNet3

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
        raise NotImplementedError(
            f"'{model_name}' is not ported to adaa_tpu_torch yet (ROADMAP.md, queue 1)"
        )
    raise ValueError(f"Model '{model_name}' not supported")


def init_model(module: nn.Module, generator: torch.Generator,
               device: Union[str, torch.device]) -> nn.Module:
    """Move ``module`` to ``device`` and draw its initial weights from
    ``generator`` (which must live on that device)."""
    module = module.to(device)
    module.reset_parameters(generator)
    return module
