"""Utilities (port of ``adaa_tpu.utils``, as the slices need them)."""
from adaa_tpu_torch.utils.checkpoints import load_checkpoint, save_checkpoint  # noqa: F401
from adaa_tpu_torch.utils.seeding import set_seed  # noqa: F401
