"""Data parallelism over processes (port of ``adaa_tpu/parallel/mesh.py``).

The JAX package shards the batch axis over a 1-D device mesh and lets
GSPMD run one program over the global batch. Here each process of a
``torch.distributed`` group holds one card (or the CPU, with gloo) and
the whole model, and runs on its rank's rows of the global batch:

* ``shard_batch`` takes this rank's rows; ``gather_batch`` all-gathers
  every rank's rows back into the global batch; ``replicate`` broadcasts
  parameters and buffers from rank 0;
* ``map_sharded(fn, *batches)`` runs ``fn`` on this rank's rows inside
  ``sharded()`` and gathers its output, when the world size is > 1 and
  divides the batch (the JAX package's condition); otherwise ``fn`` runs
  on the whole batch in every process;
* ``data_parallel_attack_fn`` is that for an attack ``(x, y, generator)``.

Inside ``sharded()`` the code that would see the global batch in the
JAX program reads it across ranks, so the sharded run equals the
single-process one over the global batch:

* ``global_draw`` draws the global batch's random numbers (a random
  start, a dropout keep-mask) from the generator every rank holds in the
  same state, and keeps this rank's rows;
* ``all_reduce_sum`` sums a tensor over ranks with its gradient (train
  mode BatchNorm's per-channel sums, ``models/layers.batch_norm``);
* ``average_gradients`` averages ``.grad`` over ranks after a backward:
  the shards are equal, so the average of the shards' mean losses is the
  global mean loss.

``initialize_multihost`` forms the group from ``ADAA_COORDINATOR``
(``host:port``), ``ADAA_NUM_PROCESSES`` and ``ADAA_PROCESS_ID``, with
NCCL on the card and gloo on the CPU. Importing this module starts no
process group.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

# (world size, rank) while ``sharded()`` runs; None outside it
_SHARD: Optional[Tuple[int, int]] = None


def world() -> Tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def data_parallel(batch_size: int) -> bool:
    """Whether a batch of ``batch_size`` rows shards over the group."""
    n, _ = world()
    return n > 1 and batch_size % n == 0


def shard_info() -> Optional[Tuple[int, int]]:
    """(world size, rank) inside ``sharded()``, else None."""
    return _SHARD


@contextlib.contextmanager
def sharded() -> Iterator[None]:
    """Marks the code inside as running on this rank's rows of a global batch."""
    global _SHARD
    before, _SHARD = _SHARD, world()
    try:
        yield
    finally:
        _SHARD = before


def shard_batch(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the global batch ``x``."""
    n, rank = world()
    rows = x.shape[0] // n
    return x[rank * rows:(rank + 1) * rows]


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows, in rank order: the global batch."""
    n, _ = world()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def replicate(module: nn.Module) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, in place."""
    if world()[0] > 1:
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t.data, src=0)
    return module


def map_sharded(fn: Callable[..., torch.Tensor], *batches: torch.Tensor) -> torch.Tensor:
    """``fn(*batches)`` with its rows computed where they live (module doc)."""
    if not data_parallel(batches[0].shape[0]):
        return fn(*batches)
    with sharded():
        out = fn(*[shard_batch(b) for b in batches])
    return gather_batch(out)


def data_parallel_attack_fn(attack_fn: Callable) -> Callable:
    """An attack ``(x, y, generator) -> adv`` over the global batch, each
    rank attacking its rows (the JAX package's sharded jit of the attack).
    Its random numbers must come from ``global_draw`` for the result to
    equal the single-process attack's."""

    def wrapped(x, y, generator=None):
        return map_sharded(lambda xs, ys: attack_fn(xs, ys, generator), x, y)

    return wrapped


def global_draw(sample: Callable[[Tuple[int, ...]], torch.Tensor],
                shape: Tuple[int, ...]) -> torch.Tensor:
    """``sample(shape)``; inside ``sharded()``, this rank's rows of
    ``sample`` over the global batch's shape."""
    if _SHARD is None:
        return sample(tuple(shape))
    n, rank = _SHARD
    full = sample((shape[0] * n, *shape[1:]))
    return full[rank * shape[0]:(rank + 1) * shape[0]]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over ranks, differentiable; ``t`` outside ``sharded()``."""
    if _SHARD is None:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, op=dist.ReduceOp.SUM)


def average_gradients(params) -> None:
    """Average every ``.grad`` over ranks, in one collective."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or world()[0] == 1:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world()[0]
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> int:
    """Join the process group named by the arguments or by ``ADAA_COORDINATOR``
    / ``ADAA_NUM_PROCESSES`` / ``ADAA_PROCESS_ID``; return its size. A no-op
    returning 1 when no coordinator is configured. Each process then uses
    the card of its rank's index on its host (NCCL), or the CPU (gloo);
    ``backend`` None picks NCCL when a card is visible."""
    coordinator_address = coordinator_address or os.environ.get("ADAA_COORDINATOR")
    if not coordinator_address:
        return 1
    size = num_processes or int(os.environ["ADAA_NUM_PROCESSES"])
    rank = process_id if process_id is not None else int(os.environ["ADAA_PROCESS_ID"])
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=size, rank=rank)
    return dist.get_world_size()
