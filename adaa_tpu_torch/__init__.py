"""adaa_tpu_torch — the PyTorch/CUDA port of adaa_tpu.

Module paths mirror ``adaa_tpu`` (``ops``, ``models``, ``attacks``,
``eval``, ``data``, ``training``, ``parallel``, ``scripts``, ``utils``) so
each module's JAX counterpart is easy to find. The JAX package is the
reference this port is tested against; this package imports ``torch``, numpy and scipy
(``yaml`` only inside the CLIs' functions), never ``jax``, ``flax``,
``optax``, ``sklearn`` or ``adaa_tpu``.

The main path is untargeted PGD-10 on the bf16 LCNN with the LFCC
frontend (``adaa_tpu_torch.bench.measure_torch``). Its hand-written
kernel is LCNN's fused first block (``ops/layer0.py`` +
``csrc/layer0.cu``). The fused configuration of the same model
(``bench.setup(fused=True)``) adds the fused LFCC forward
(``ops/lfcc_fused.py`` + ``csrc/lfcc.cu``) and the fused trunk segments
(``ops/trunk.py`` + ``csrc/trunk.cu``). RawNet3
(``models/rawnet3.py``, PGD-10 at batch 64 through
``bench.setup(model="rawnet3")``) adds the 1-D pool kernel
(``ops/pool.py`` + ``csrc/pool.cu``) and the fused Bottle2neck kernels
(``ops/b2n.py`` + ``csrc/b2n.cu``). All are built for ``sm_90a`` at
first use.

The adversarial-evaluation path runs on top: SpecRNet
(``models/specrnet.py``; its fused frontend is the LFCC kernel), FAB
(``attacks/fab.py``), the metrics (``metrics.py``, numpy + scipy), the
loader and synthetic set (``data/``), ``eval.evaluate_nn`` and
``eval.generate_attacks`` (white-box and transfer), and the evaluation
CLIs (``python -m adaa_tpu_torch.scripts.<name>``).

Training runs on the same models: ``training`` (Adam with the
warm-restart schedule, ``GDTrainer``, the adversarial trainers and their
five strategies, whose self-attack runs the eval-mode kernels on the
live weights), ``utils.checkpoints`` and the two training CLIs.
``bench.measure_torch_train`` times one adversarial-training step.

The rest of the JAX package is here too: its numerics switches
(``ADAA_FUSED_LCNN``, ``ADAA_FOLD_BN``, ... read where it reads them),
``mel_spec``, the unwired detectors (``models/extra.py``), ``config``
(``ExperimentConfig``), FLOP counting (``utils/flops.py``), ``.msgpack``
writing, the batch scripts (``scripts/multi_runs``) and data parallelism
over a ``torch.distributed`` group (``parallel``).
"""
