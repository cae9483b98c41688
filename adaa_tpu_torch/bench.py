"""Throughput of PGD-10 on the port's detectors, on a CUDA card.

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

``model="rawnet3"`` runs the same attack on the bf16 RawNet3 at batch 64
(the batch of the JAX package's ``rawnet3:PGD`` record), in one of three
configurations: ``RAWNET3_CONFIG`` (no kernel), ``RAWNET3_POOL_CONFIG``
(the pool kernel on layer 1's pool, as ``ADAA_PALLAS_POOL=1``) and
``RAWNET3_B2N_CONFIG`` (the fused Bottle2neck kernel in all three blocks,
as ``ADAA_FUSED_B2N=1``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from adaa_tpu_torch import attacks, models
from adaa_tpu_torch.utils import set_seed

BATCH = 256
WAVE_LEN = 64_600
CONFIG = {"input_channels": 1, "frontend_algorithm": ["lfcc"], "compute_dtype": "bfloat16",
          "fused_frontend": False, "fused_trunk": False}
FUSED_CONFIG = {**CONFIG, "fused_frontend": True, "fused_trunk": True}
RAWNET3_BATCH = 64
RAWNET3_CONFIG = {"compute_dtype": "bfloat16", "fused_pool": False, "fused_b2n": False}
RAWNET3_POOL_CONFIG = {**RAWNET3_CONFIG, "fused_pool": True}
RAWNET3_B2N_CONFIG = {**RAWNET3_CONFIG, "fused_b2n": True}
DEFAULTS = {"lcnn": (BATCH, CONFIG), "rawnet3": (RAWNET3_BATCH, RAWNET3_CONFIG)}


class MainPath(NamedTuple):
    model: torch.nn.Module
    attack: Callable  # (waves, labels, generator) -> adversarial waves
    x: torch.Tensor  # (B, WAVE_LEN) seeded waves
    y: torch.Tensor  # (B,) labels
    generator: torch.Generator


def setup(batch: Optional[int] = None, seed: int = 0, device: str = "cuda",
          fused: bool = False, model: str = "lcnn",
          config: Optional[Dict[str, Any]] = None) -> MainPath:
    """A model (LCNN's fused configuration with ``fused``; else ``config``,
    by default the model's bf16 configuration) and its PGD-10 attack, and
    a batch of seeded waves (by default the model's batch)."""
    default_batch, default_config = DEFAULTS[model]
    batch = batch or default_batch
    config = config or (FUSED_CONFIG if fused else default_config)
    gen = set_seed(seed, device)
    # the attacked detector is frozen: its direct calls (clean logits, checks)
    # run in eval mode, as every call of make_logits_fn's does
    net = models.init_model(models.get_model(model, config), gen, device)
    net.eval().requires_grad_(False)
    logits_fn = attacks.make_logits_fn(net)
    attack = attacks.attack_in_wave_space(attacks.build_attack("PGD", logits_fn))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, WAVE_LEN)).astype(np.float32))
    y = torch.from_numpy((np.arange(batch) % 2).astype(np.int64))
    return MainPath(net, attack, x.to(device), y.to(device), gen)


def measure_torch(batch: Optional[int] = None, iters: int = 10, warmup: int = 2,
                  seed: int = 0, fused: bool = False, model: str = "lcnn",
                  config: Optional[Dict[str, Any]] = None) -> float:
    """Adversarial examples per second of PGD-10 at ``batch`` on cuda:0."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_torch needs a CUDA device")
    _, attack, x, y, gen = setup(batch, seed, "cuda", fused, model, config)
    batch = x.shape[0]
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
