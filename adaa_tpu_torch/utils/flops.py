"""FLOP counting of a PyTorch function (port of ``adaa_tpu/utils/flops.py``).

The JAX package walks a traced jaxpr and counts the MXU classes,
``dot_general`` and ``conv_general_dilated``, multiplying scan bodies by
their length. Here the function runs eagerly under
``torch.utils.flop_counter.FlopCounterMode`` and only the same classes
count: the matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``) and
the convolutions with their backward; elementwise work does not, as
in an MFU quoted against a tensor-core peak. An eager run executes every
step of a Python loop, so PGD-10 counts ten steps without a multiplier.

Caveats, flagged in the report rather than guessed:

* a loop whose trip count depends on the data (CW's early stop) marks
  each trip with ``loop_trip()``; its first trip is counted
  ``while_trip`` times and the others not, as the JAX package counts a
  ``while_loop`` body, and ``has_while`` is set. The caller passes the
  loop's bound;
* a hand-written kernel is opaque to the counter, as ``pallas_call`` is
  to the jaxpr walker: count on the models' plain versions
  (``model.plain_ops = True``, the JAX package's ``ADAA_FUSED_LCNN=0``).
  ``has_kernel`` is set when a kernel wrapper's launch counter moved
  during the count.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional

__all__ = ["count_flops", "loop_trip"]

COUNTED = frozenset({
    "aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm", "aten._scaled_mm",
    "aten.convolution", "aten._convolution", "aten.cudnn_convolution",
    "aten.convolution_overrideable", "aten._slow_conv2d_forward",
    "aten.convolution_backward",
})

_ACTIVE: Optional[Dict[str, Any]] = None  # the count in progress


class _GlobalOnly:
    """``FlopCounterMode``'s module tracker reduced to the global count: the
    tracker hooks module inputs for the backward, which breaks
    ``torch.autograd.grad`` (the attacks' every step)."""

    parents = frozenset({"Global"})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def _counted(mode) -> int:
    return sum(v for k, v in mode.get_flop_counts().get("Global", {}).items()
               if str(k) in COUNTED)


def _launches() -> Dict[str, int]:
    from adaa_tpu_torch.ops import b2n, layer0, lfcc_fused, pool, trunk

    return {f"{op.__name__}.{k}": v for op in (b2n, layer0, lfcc_fused, pool, trunk)
            for k, v in op.LAUNCHES.items()}


@contextlib.contextmanager
def loop_trip() -> Iterator[None]:
    """Marks one trip of a loop whose trip count depends on the data."""
    count = _ACTIVE
    if count is None:
        yield
        return
    before = _counted(count["mode"])
    yield
    count["trips"].append(_counted(count["mode"]) - before)


def count_flops(fn, *example_args, while_trip: int = 1) -> Dict[str, Any]:
    """Run ``fn(*example_args)`` and count its matmul and conv FLOPs.

    Returns ``{"flops": float, ...caveat flags}`` (module doc)."""
    from torch.utils.flop_counter import FlopCounterMode

    global _ACTIVE
    report: Dict[str, Any] = {}
    before = _launches()
    mode = FlopCounterMode(display=False)
    mode.mod_tracker = _GlobalOnly()
    count = {"mode": mode, "trips": []}
    _ACTIVE, outer = count, _ACTIVE
    try:
        with mode:
            fn(*example_args)
    finally:
        _ACTIVE = outer
    total = float(_counted(mode))
    if count["trips"]:
        report["has_while"] = True
        total += while_trip * count["trips"][0] - sum(count["trips"])
    if _launches() != before:
        report["has_kernel"] = True
    report["flops"] = total
    return report
