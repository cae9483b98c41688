"""Deterministic seeding (port of ``adaa_tpu/utils/seeding.py``).

Fixes the host RNGs (python ``random``, numpy, torch's global
generator) and returns an explicit ``torch.Generator`` on ``device``
for the run's device-side randomness, in the role the root PRNG key
plays in the JAX package.
"""
from __future__ import annotations

import os
import random
from typing import Union

import numpy as np
import torch


def set_seed(seed: int, device: Union[str, torch.device] = "cuda") -> torch.Generator:
    """Seed the host RNGs; return a generator on ``device`` (the card by
    default: pass ``"cpu"`` for a run on the CPU)."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return generator
