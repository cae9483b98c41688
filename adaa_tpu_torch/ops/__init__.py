"""Frontends, STFT and the hand-written Hopper kernels (torch port of adaa_tpu.ops)."""
