"""Where the time of the main path goes on a CUDA card (torch.profiler).

Run on the card from the repository root:

    python -m adaa_tpu_torch.utils.profiling --out profile_pgd10.json [--fused]
    python -m adaa_tpu_torch.utils.profiling --model rawnet3 [--config pool|b2n] --out ...
    python -m adaa_tpu_torch.utils.profiling --model specrnet [--fused] --out ...
    python -m adaa_tpu_torch.utils.profiling --attack FAB [--batch 64] --out ...
    python -m adaa_tpu_torch.utils.profiling --train bf16|f32 [--fused] --out ...

It warms up, then profiles one attacked batch of PGD-10 (or ``--attack``,
a registry name; ``adaa_tpu_torch.bench.setup``): on the bf16 LCNN+LFCC
at batch 256 (its fused configuration with ``--fused``), on the bf16
RawNet3 at batch 64 (with the pool or the b2n kernel with ``--config``),
or on the bf16 SpecRNet at batch 64 (the fused LFCC with ``--fused``);
or, with ``--train``, one adversarial-training step of the LCNN at batch
256 (``bench.adv_train_step``: FGSM on the live weights, then BCE/Adam),
and writes a
JSON summary: without the profiler, the host time to enqueue one batch
and its wall time; under the profiler, the batch's wall time (inflated
by the profiler's own host cost), device busy time (the union of
kernel intervals) and idle share against that wall, the ops ranked by
their kernels' device time, and the kernels ranked by name.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import DeviceType


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _busy_us(intervals: List[tuple]) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def device_busy_ms(prof) -> float:
    """Device busy time (ms, the union of kernel intervals) of a finished
    ``torch.profiler.profile``, read from its raw events: ``prof.events()``
    builds a Python object per event, ~70 us each, which over the ~10^5
    kernels of an attack costs more than the attack."""
    events = prof.profiler.kineto_results.events()
    return _busy_us([(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
                     for e in events if e.device_type() == DeviceType.CUDA]) / 1e3


def profile_attack(batch: Optional[int] = None, seed: int = 0, top: int = 30,
                   fused: bool = False, model: str = "lcnn",
                   config: Optional[Dict[str, Any]] = None,
                   attack_name: str = "PGD") -> Dict[str, Any]:
    from adaa_tpu_torch import bench

    _, attack, x, y, gen = bench.setup(batch, seed, "cuda", fused, model, config, attack_name)
    return {"model": model, "attack": attack_name, "train": None, "batch": x.shape[0],
            "fused": fused, "config": config, **profile_step(lambda: attack(x, y, gen), top)}


def profile_train(batch: Optional[int] = None, seed: int = 0, top: int = 30,
                  fused: bool = False, dtype: str = "bf16") -> Dict[str, Any]:
    """One adversarial-training step (``bench.adv_train_step``: FGSM on the
    live LCNN, then BCE/Adam), in ``dtype`` or the fused configuration."""
    from adaa_tpu_torch import bench

    config = bench.FUSED_CONFIG if fused else bench.TRAIN_CONFIGS[dtype]
    path = bench.setup_train(batch or bench.BATCH, seed, "cuda", config=config)
    return {"model": "lcnn", "attack": "FGSM", "train": dtype, "batch": path.x.shape[0],
            "fused": fused, "config": config,
            **profile_step(lambda: bench.adv_train_step(path), top)}


def profile_step(step, top: int = 30) -> Dict[str, Any]:
    """Warm ``step`` up, time one call without the profiler, profile one."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    # without the profiler: host time to enqueue one step vs its wall time
    # (enqueue close to wall means the host, not the card, sets the pace)
    t0 = time.perf_counter()
    step()
    host_us = (time.perf_counter() - t0) * 1e6
    torch.cuda.synchronize()
    plain_wall_us = (time.perf_counter() - t0) * 1e6
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_kernel: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_kernel[e.name][0] += e.time_range.elapsed_us()
        by_kernel[e.name][1] += 1
    ops = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0:
            ops.append({"op": e.key, "self_device_ms": dev / 1e3, "count": e.count})
    ops.sort(key=lambda r: -r["self_device_ms"])
    kern = sorted(({"kernel": k[:160], "ms": v[0] / 1e3, "count": v[1]}
                   for k, v in by_kernel.items()), key=lambda r: -r["ms"])
    return {
        "unprofiled_enqueue_ms": host_us / 1e3,
        "unprofiled_wall_ms": plain_wall_us / 1e3,
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us if wall_us else None,
        "kernel_launches": len(kernels),
        "kernel_ms_total": sum(v[0] for v in by_kernel.values()) / 1e3,
        "ops": ops[:top],
        "kernels": kern[:top],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=None,
                        help="default: the model's batch (256 LCNN, 64 RawNet3 and SpecRNet)")
    parser.add_argument("--out", default="profile_pgd10.json")
    parser.add_argument("--model", choices=("lcnn", "rawnet3", "specrnet"), default="lcnn")
    parser.add_argument("--attack", default="PGD", help="a registry attack (default: PGD)")
    parser.add_argument("--fused", action="store_true",
                        help="LCNN's fused configuration (fused LFCC + fused trunk segments); "
                             "SpecRNet's fused LFCC")
    parser.add_argument("--config", choices=("default", "pool", "b2n"), default="default",
                        help="RawNet3's configuration: no kernel, the pool kernel or the b2n kernel")
    parser.add_argument("--train", choices=("bf16", "f32"), default=None,
                        help="profile one adversarial-training step of the LCNN in this dtype "
                             "(with --fused: its fused configuration) instead of an attack")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    from adaa_tpu_torch import bench

    config = None
    if args.model == "rawnet3":
        config = {"default": bench.RAWNET3_CONFIG, "pool": bench.RAWNET3_POOL_CONFIG,
                  "b2n": bench.RAWNET3_B2N_CONFIG}[args.config]
    elif args.model == "specrnet":
        config = bench.SPECRNET_FUSED_CONFIG if args.fused else bench.SPECRNET_CONFIG
    if args.train:
        result = {"card": card_line(), **profile_train(args.batch, fused=args.fused,
                                                       dtype=args.train)}
    else:
        result = {"card": card_line(),
                  **profile_attack(args.batch, fused=args.fused, model=args.model,
                                   config=config, attack_name=args.attack)}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    brief = {k: result[k] for k in ("card", "model", "attack", "train", "batch", "fused", "config",
                                    "unprofiled_enqueue_ms",
                                    "unprofiled_wall_ms", "wall_ms", "device_busy_ms",
                                    "device_idle_share", "kernel_launches")}
    print(json.dumps(brief))
    for row in result["ops"][:15]:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
