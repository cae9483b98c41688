"""adaa_tpu_torch — the PyTorch/CUDA port of adaa_tpu.

Module paths mirror ``adaa_tpu`` (``ops``, ``models``, ``attacks``,
``utils``) so each module's JAX counterpart is easy to find. The JAX
package is the reference this port is tested against; this package
imports ``torch`` and numpy only, never ``jax``, ``flax`` or
``adaa_tpu``.

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
"""
