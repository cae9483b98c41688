"""The port's command-line entry points, run as
``python -m adaa_tpu_torch.scripts.<name>``."""
