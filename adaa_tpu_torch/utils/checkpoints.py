"""Checkpoint save / load (port of ``adaa_tpu/utils/checkpoints.py``).

The reference persists ``torch.save(model.state_dict())`` under
``trained_models/aad__{model}__{ts}/ckpt[_{epoch:02d}].pth``
(src/trainer.py:20-33, train_models.py:25-32). So does the port: a CPU
``state_dict`` with the reference's key names, in the JAX package's
directory layout with ``.pth`` in place of ``.msgpack``. The port's
``models.load_model`` reads it, and so does the JAX package's
``adaa_tpu.models.load_model`` (through its ``torch_import``). The port
also reads the JAX package's ``.msgpack`` checkpoints (flax variable
trees, decoded by ``utils/msgpack.py`` and mapped through the weight
bridge), and ``save_checkpoint_msgpack`` writes one the JAX package's
``load_checkpoint`` reads, under its path scheme
``{dir}/{name}/ckpt[_{epoch:02d}].msgpack``. The trainers write ``.pth``.
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
    path = _ckpt_path(model_dir, name, epoch, ".pth")
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    LOGGER.info("Training model saved under: %s", path)
    return path


def _ckpt_path(model_dir: Union[Path, str], name: str, epoch: Optional[int],
               suffix: str) -> Path:
    full_model_dir = Path(model_dir) / name
    full_model_dir.mkdir(parents=True, exist_ok=True)
    epoch_str = f"_{epoch:02d}" if epoch is not None else ""
    return full_model_dir / f"ckpt{epoch_str}{suffix}"


def save_checkpoint_msgpack(model: nn.Module, model_dir: Union[Path, str], name: str,
                            epoch: Optional[int] = None) -> Path:
    """Save ``model``'s weights (an LCNN, RawNet3 or SpecRNet) as the JAX
    model's variable tree in ``{model_dir}/{name}/ckpt[_{epoch:02d}].msgpack``."""
    from adaa_tpu_torch.models import LCNN, RawNet3, SpecRNet, weights
    from adaa_tpu_torch.utils import msgpack

    kinds = {LCNN: "lcnn", RawNet3: "rawnet3", SpecRNet: "specrnet"}
    if type(model) not in kinds:
        raise ValueError(f"no .msgpack layout for {type(model).__name__}")
    path = _ckpt_path(model_dir, name, epoch, ".msgpack")
    msgpack.save(path, weights.flax_from_state_dict(kinds[type(model)], model.state_dict()))
    LOGGER.info("Training model saved under: %s", path)
    return path


def load_checkpoint(path: Union[Path, str],
                    model_name: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """A checkpoint as a ``state_dict`` on the CPU that
    ``model.load_state_dict`` takes: a saved (or reference) ``.pth`` /
    ``.pt`` with DataParallel ``module.`` prefixes stripped, or a JAX
    ``.msgpack`` of the model ``model_name`` (lcnn, rawnet3, specrnet)."""
    from adaa_tpu_torch.models import weights

    path = str(path)
    if path.endswith((".pth", ".pt")):
        return weights.load_state_dict(path)
    if path.endswith(".msgpack"):
        if model_name is None:
            raise ValueError(f"checkpoint '{path}': a .msgpack needs the model's name")
        from adaa_tpu_torch.utils import msgpack

        return weights.state_dict_from_flax(model_name, msgpack.load(path))
    raise ValueError(f"checkpoint '{path}': expected .pth, .pt or .msgpack")
