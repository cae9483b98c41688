"""Frontends, STFT and the hand-written Hopper kernels (torch port of adaa_tpu.ops)."""

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter, ``{"layer0.fwd": n, ...}``."""
    from adaa_tpu_torch.ops import b2n, layer0, lfcc_fused, pool, trunk

    return {f"{op.__name__.rsplit('.', 1)[1]}.{k}": v
            for op in (layer0, lfcc_fused, trunk, pool, b2n) for k, v in op.LAUNCHES.items()}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches each kernel made since ``before = launch_counts()``
    (kernels that made none left out)."""
    return {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
