"""The port's examples (counterparts of the repo's ``examples/``), run as
``python -m adaa_tpu_torch.examples.<name>`` on the card, or on the CPU
with ``--cpu``: ``attack_demo``, ``performance_comparison``,
``transfer_attack`` and ``robustness_pipeline``. Each has ``run(...)``,
which returns the numbers it prints, and ``main(argv)``."""
