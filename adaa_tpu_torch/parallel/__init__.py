"""Data parallelism over a ``torch.distributed`` process group."""
from adaa_tpu_torch.parallel.mesh import (  # noqa: F401
    data_parallel_attack_fn,
    initialize_multihost,
    replicate,
    shard_batch,
)
