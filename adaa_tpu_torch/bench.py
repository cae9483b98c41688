"""Throughput of the main path: PGD-10 on the bf16 LCNN+LFCC, on a CUDA card.

The counterpart of the root ``bench.py``'s ``measure_jax``: the same
configuration (registry "PGD": eps 5e-4, 10 steps, alpha 2/255;
batch 256 of 64,600-sample waves; random weights from a seed), driven
through the port's user entry points (``models.get_model``,
``attacks.make_logits_fn``, ``attacks.build_attack``,
``attacks.attack_in_wave_space``) and timed with CUDA events. There is
no CPU path: a number from the CPU is not this metric.

``fused=True`` builds the fused configuration of the same model: the
fused LFCC kernel and the two fused trunk segments switched on through
the model's own arguments (the JAX package's ``ADAA_PALLAS_FRONTEND=1``
and ``ADAA_FUSED_TRUNK=1``), not through the environment.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from adaa_tpu_torch import attacks, models
from adaa_tpu_torch.utils import set_seed

BATCH = 256
WAVE_LEN = 64_600
CONFIG = {"input_channels": 1, "frontend_algorithm": ["lfcc"], "compute_dtype": "bfloat16",
          "fused_frontend": False, "fused_trunk": False}
FUSED_CONFIG = {**CONFIG, "fused_frontend": True, "fused_trunk": True}


class MainPath(NamedTuple):
    model: torch.nn.Module
    attack: Callable  # (waves, labels, generator) -> adversarial waves
    x: torch.Tensor  # (B, WAVE_LEN) seeded waves
    y: torch.Tensor  # (B,) labels
    generator: torch.Generator


def setup(batch: int = BATCH, seed: int = 0, device: str = "cuda",
          fused: bool = False) -> MainPath:
    """The main path's model (the fused configuration with ``fused``) and
    attack, and a batch of seeded waves."""
    gen = set_seed(seed, device)
    config = FUSED_CONFIG if fused else CONFIG
    model = models.init_model(models.get_model("lcnn", config), gen, device)
    logits_fn = attacks.make_logits_fn(model)
    attack = attacks.attack_in_wave_space(attacks.build_attack("PGD", logits_fn))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, WAVE_LEN)).astype(np.float32))
    y = torch.from_numpy((np.arange(batch) % 2).astype(np.int64))
    return MainPath(model, attack, x.to(device), y.to(device), gen)


def measure_torch(batch: int = BATCH, iters: int = 10, warmup: int = 2,
                  seed: int = 0, fused: bool = False) -> float:
    """Adversarial examples per second of PGD-10 at ``batch`` on cuda:0."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_torch needs a CUDA device")
    model, attack, x, y, gen = setup(batch, seed, "cuda", fused)
    for _ in range(warmup):
        attack(x, y, gen)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        attack(x, y, gen)
    end.record()
    end.synchronize()
    return batch * iters / (start.elapsed_time(end) / 1e3)
