"""Checkpoint save / load (port of ``adaa_tpu/utils/checkpoints.py``).

The reference persists ``torch.save(model.state_dict())`` under
``trained_models/aad__{model}__{ts}/ckpt[_{epoch:02d}].pth``
(src/trainer.py:20-33, train_models.py:25-32). So does the port: a CPU
``state_dict`` with the reference's key names, in the JAX package's
directory layout with ``.pth`` in place of ``.msgpack``. The port's
``models.load_model`` reads it, and so does the JAX package's
``adaa_tpu.models.load_model`` (through its ``torch_import``).
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional, Union

import torch
from torch import nn

LOGGER = logging.getLogger(__name__)


def save_checkpoint(model: nn.Module, model_dir: Union[Path, str], name: str,
                    epoch: Optional[int] = None) -> Path:
    """Save ``model``'s weights as ``{model_dir}/{name}/ckpt[_{epoch:02d}].pth``."""
    full_model_dir = Path(model_dir) / name
    full_model_dir.mkdir(parents=True, exist_ok=True)
    epoch_str = f"_{epoch:02d}" if epoch is not None else ""
    path = full_model_dir / f"ckpt{epoch_str}.pth"
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    LOGGER.info("Training model saved under: %s", path)
    return path


def load_checkpoint(path: Union[Path, str]) -> Dict[str, torch.Tensor]:
    """A saved (or reference) ``.pth`` state_dict on the CPU, DataParallel
    ``module.`` prefixes stripped; ``model.load_state_dict`` takes it."""
    from adaa_tpu_torch.models.weights import load_state_dict

    return load_state_dict(str(path))
