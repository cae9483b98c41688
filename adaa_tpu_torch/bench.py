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

``model="specrnet"`` runs it on the bf16 SpecRNet at batch 64 (the batch
of the JAX package's ``specrnet:PGD`` record): ``SPECRNET_CONFIG`` (no
kernel) or ``SPECRNET_FUSED_CONFIG`` (the fused LFCC kernel). ``attack``
names another registry attack for the same entry points (``"FAB"``: the
registry's FAB, Linf, 100 steps, eta 10).

``measure_torch_train`` is the counterpart of ``scripts/bench_train.py``:
one ONLY_ADV adversarial-training step, FGSM (the registry's, eps 5e-4)
self-attack on the live weights and then the BCE/Adam update (lr 1e-4),
on the LCNN+LFCC at batch 256 of 64,600-sample waves, bf16
(``TRAIN_CONFIGS["bf16"]``: the attack runs the layer-0 kernel) or f32,
through the trainer's own pieces (``training.adv_trainer.make_adv_fn``,
``training.gd_trainer.train_step``). It too is timed with CUDA events
after warm-up and has no CPU path.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

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
SPECRNET_BATCH = 64
SPECRNET_CONFIG = {"input_channels": 1, "frontend_algorithm": ["lfcc"],
                   "compute_dtype": "bfloat16", "fused_frontend": False}
SPECRNET_FUSED_CONFIG = {**SPECRNET_CONFIG, "fused_frontend": True}
DEFAULTS = {"lcnn": (BATCH, CONFIG), "rawnet3": (RAWNET3_BATCH, RAWNET3_CONFIG),
            "specrnet": (SPECRNET_BATCH, SPECRNET_CONFIG)}
TRAIN_CONFIGS = {"bf16": CONFIG, "f32": {**CONFIG, "compute_dtype": None}}
TRAIN_LR = 1e-4  # scripts/bench_train.py's


class MainPath(NamedTuple):
    model: torch.nn.Module
    attack: Callable  # (waves, labels, generator) -> adversarial waves
    x: torch.Tensor  # (B, WAVE_LEN) seeded waves
    y: torch.Tensor  # (B,) labels
    generator: torch.Generator


def setup(batch: Optional[int] = None, seed: int = 0, device: str = "cuda",
          fused: bool = False, model: str = "lcnn",
          config: Optional[Dict[str, Any]] = None, attack: str = "PGD") -> MainPath:
    """A model (LCNN's fused configuration with ``fused``; else ``config``,
    by default the model's bf16 configuration) and the registry attack
    ``attack`` on it, and a batch of seeded waves (by default the model's
    batch)."""
    default_batch, default_config = DEFAULTS[model]
    batch = batch or default_batch
    config = config or (FUSED_CONFIG if fused else default_config)
    gen = set_seed(seed, device)
    # the attacked detector is frozen: its direct calls (clean logits, checks)
    # run in eval mode, as every call of make_logits_fn's does
    net = models.init_model(models.get_model(model, config), gen, device)
    net.eval().requires_grad_(False)
    logits_fn = attacks.make_logits_fn(net)
    attack_fn = attacks.attack_in_wave_space(attacks.build_attack(attack, logits_fn))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, WAVE_LEN)).astype(np.float32))
    y = torch.from_numpy((np.arange(batch) % 2).astype(np.int64))
    return MainPath(net, attack_fn, x.to(device), y.to(device), gen)


def cuda_ms(fn: Callable[[], Any], iters: int, warmup: int) -> float:
    """Milliseconds per call of ``fn`` on cuda:0: ``warmup`` calls, then
    CUDA events around ``iters`` calls enqueued back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def first_call_s(fn: Callable[[], Any]) -> Tuple[Any, float]:
    """``fn()``'s result and the seconds of its call through to the card's
    last kernel (on a first call: kernel builds, cuDNN's autotuning)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def measure_torch(batch: Optional[int] = None, iters: int = 10, warmup: int = 2,
                  seed: int = 0, fused: bool = False, model: str = "lcnn",
                  config: Optional[Dict[str, Any]] = None, attack: str = "PGD") -> float:
    """Adversarial examples per second of ``attack`` (PGD-10 by default) at
    ``batch`` on cuda:0."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_torch needs a CUDA device")
    _, attack_fn, x, y, gen = setup(batch, seed, "cuda", fused, model, config, attack)
    ms = cuda_ms(lambda: attack_fn(x, y, gen), iters, warmup)
    return x.shape[0] / (ms / 1e3)


class TrainPath(NamedTuple):
    state: Any  # training.train_state.TrainState of the model being trained
    adv_fn: Callable  # (waves, labels) -> adversarial waves, on the live model
    x: torch.Tensor  # (B, WAVE_LEN) seeded waves
    y: torch.Tensor  # (B,) int32 labels, as the loader gives them
    acc: torch.Tensor  # the trainer's (2,) [loss_sum, correct] accumulator


def setup_train(batch: int = BATCH, seed: int = 0, device: str = "cuda",
                model: str = "lcnn", config: Optional[Dict[str, Any]] = None,
                optimizer_kwargs: Optional[Dict[str, Any]] = None,
                use_scheduler: bool = False, batches_per_epoch: Optional[int] = None,
                scheduler_t0_epochs: int = 1) -> TrainPath:
    """A model to train (LCNN bf16 by default) with Adam (and the warm-restart
    schedule with ``use_scheduler``), the registry's FGSM on its live
    weights, and a batch of seeded waves."""
    from adaa_tpu_torch.training import adv_trainer, train_state

    gen = set_seed(seed, device)
    net = models.init_model(models.get_model(model, config or TRAIN_CONFIGS["bf16"]), gen, device)
    state = train_state.create_train_state(net, optimizer_kwargs or {"lr": TRAIN_LR},
                                           use_scheduler, batches_per_epoch,
                                           scheduler_t0_epochs)
    adv_fn = adv_trainer.make_adv_fn("FGSM", net, gen)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, WAVE_LEN)).astype(np.float32))
    y = torch.from_numpy((np.arange(batch) % 2).astype(np.int32))
    return TrainPath(state, adv_fn, x.to(device), y.to(device), torch.zeros(2, device=device))


def adv_train_step(path: TrainPath) -> torch.Tensor:
    """One ONLY_ADV step: the attack on the live weights, then BCE/Adam."""
    from adaa_tpu_torch.training.gd_trainer import train_step

    return train_step(path.state, path.adv_fn(path.x, path.y), path.y, path.acc)


def measure_torch_train(batch: int = BATCH, iters: int = 10, warmup: int = 2, seed: int = 0,
                        dtype: str = "bf16") -> Dict[str, float]:
    """``adv_train_fgsm_bce_{dtype}`` on cuda:0: ms per step, examples/s,
    the seconds of the first step, peak device memory of the timed steps
    and their last loss."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_torch_train needs a CUDA device")
    path = setup_train(batch, seed, "cuda", config=TRAIN_CONFIGS[dtype])
    _, first_s = first_call_s(lambda: adv_train_step(path))
    for _ in range(warmup):
        adv_train_step(path)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    ms = cuda_ms(lambda: losses.append(adv_train_step(path)), iters, 0)
    return {"ms_per_step": ms, "examples_per_sec": batch / (ms / 1e3), "batch": batch,
            "first_call_s": first_s, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "loss": float(losses[-1])}
