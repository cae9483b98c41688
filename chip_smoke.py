#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (adaa_tpu_torch) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it never imports jax or adaa_tpu.
Each phase prints one JSON line, and any failed check raises, so the
exit code is not 0:

0. the card: ``nvidia-smi`` name and power limit; the host toolchain and
   codecs (``g++``'s version, whether the system libmpg123 and libmp3lame
   load); which of yaml, sklearn, pandas, scipy and matplotlib import;
1. build the five kernels from ``adaa_tpu_torch/csrc`` (one nvcc per
   source) and the host DSP library ``csrc/dsp.cpp`` (g++), all at once
   (timed, each build's seconds), with each kernel's ptxas registers and
   spills and, where ``cuobjdump`` exists, the count of wgmma (HGMMA),
   TMA load (UTMALDG) and setmaxnreg instructions in the layer-0, trunk
   and b2n libraries;
2. the layer-0 kernels against their plain-torch twin at B=256 (bf16):
   forward outputs bit-equal at >= 99.9% and all within 1 bf16 ulp,
   winner index equal at >= 99.9%, dx relative L2 error < 1e-3; the
   median time of each (CUDA events) beside the twin's, each kernel's
   device ms (torch.profiler) and ``library_ms``: cuDNN's bf16 conv
   1 -> 64 5x5 and its input gradient at the same shape, a yardstick of
   the conv stage alone (the port never calls it);
3. the bf16 LCNN at B=256 x 64,600 with the kernel and with the twin:
   finite logits that agree within LOGIT_ATOL;
4. PGD-10 through ``build_attack("PGD")`` + ``attack_in_wave_space`` at
   B=256 x 64,600: within the eps ball, finite, CE not lower than on the
   clean input, and 10 forward and 10 backward layer-0 kernel launches;
   then ``adaa_tpu_torch.bench.measure_torch`` (examples/s);
5. the fused LFCC kernel against its plain version at B=256, linear
   (LFCC) and mel (MFCC) filterbanks: within atol 5e-4 + rtol 1e-4 (the
   JAX package's band for its own kernel), medians of both, the kernel's
   device ms, its bound (the FFT's operations, the filterbank's non-zero
   weights and the DCT, against x and the cepstra's bytes) and
   ``dft_bound_ms``, the bound with the TPU kernel's DFT product instead;
6. the fused trunk kernels against their plain version at B=256,
   segments A and B: forward >= 99.9% bit-equal after the cast to bf16
   and max abs error <= 1e-4 x max |ref| in f32, tie mask >= 99.9% equal
   to the plain mask, dx (from the kernel's mask) relative L2 < 3e-3
   (TRUNK_DX_RTOL) against the plain dx; medians of both, each kernel's
   device ms (torch.profiler) and ``conv_library_ms``: cuDNN's bf16
   channels-last conv3x3 and its input gradient at the same shapes, a
   yardstick of the conv stage alone (the port never calls it);
7. the fused configuration of the LCNN (fused LFCC + fused trunk) at
   B=256, kernels against plain versions: logits within LOGIT_ATOL;
8. PGD-10 on the fused configuration, checked as in phase 4, with >= 10
   LFCC, >= 20 trunk-forward and 20 trunk-backward launches (and the
   layer-0 counts of phase 4); examples/s of the fused and the default
   configuration, timed in this call;
9. the f32 ``precision="highest"`` LCNN's input gradient at B=4 against
   the same gradient with TF32 off globally, cuDNN deterministic in both:
   relative L2 <= 1e-6;
10. the pool kernels against their plain version at RawNet3's pool shapes
    (64, 6435, 1024) w=5 and (64, 1287, 1024) w=3: forward and dx
    bit-equal; medians of the kernels, the plain version and
    ``F.max_pool1d`` on the (B, C, T) view;
11. the b2n kernels against their plain version at RawNet3's three block
    shapes, B=64: y bit-equal >= 97%, y mean relative error <= 1e-4, dx
    relative L2 <= 5e-3 (B2N_*); medians of both; then, on a line of its
    own, each b2n kernel's device time per layer from torch.profiler
    around one forward and one backward, and ``gemm_library_ms``:
    ``torch.matmul`` of the same bf16 products at the same shapes, summed,
    a yardstick of the GEMM stage alone (the port never calls it);
12. the bf16 RawNet3 at B=64 x 64,600 in its pool and b2n configurations,
    kernels against plain versions: logits within RAWNET3_LOGIT_ATOL;
13. PGD-10 on RawNet3 at B=64 in the default, pool and b2n
    configurations, checked as in phase 4, with the launch counts: no
    kernel in the default; pool forward >= 10 and backward == 10 (no b2n)
    in the pool configuration; b2n forward >= 30 and backward == 30 (no
    pool) in the b2n configuration; then examples/s of all three.
14. PGD-10 on the bf16 SpecRNet at B=64 x 64,600 (``bench.setup(model=
    "specrnet")``) in its default configuration (no kernel launched) and
    its fused-frontend one (>= 10 LFCC launches, no other kernel), checked
    as in phase 4; the fused configuration's logits against the plain
    frontend within SPECRNET_LOGIT_ATOL; examples/s of both;
15. the registry's FAB (Linf, 100 steps, eta 10, eps 0.3) on the bf16
    LCNN at B=64 x 64,600 through ``build_attack`` + ``attack_in_wave_space``,
    with the reference-exact step and with ``ADAA_FAB_MERGED=1``: in [0, 1]
    space every output finite and in the box, each row equal to its input
    or misclassified within Linf 0.3; layer-0 launches 100 backward and
    >= 200 (merged: >= 100) forward; success rate, median Linf of the
    successful rows and examples/s of both steps;
16. ``evaluate_nn`` and ``generate_attacks`` on the synthetic set (n=128,
    64,600 samples, batch 64): the bf16 SpecRNet's clean report; FGSM
    white-box on the bf16 LCNN (adversarial accuracy not above the clean
    accuracy of the same batches by more than one sample's share); PGD
    transfer from an LCNN surrogate to a SpecRNet victim, once with a
    callback (its first batch's victim predictions equal to a direct
    recomputation with a generator of the same seed) and once through the
    adversarial CLI's config-dict entry; every report with its six keys
    and finite accuracy/precision/recall/F1, and the layer-0 kernel
    launched in the LCNN-surrogate runs;
17. adversarial training on the LCNN at B=256 x 64,600
    (``bench.setup_train`` / ``adv_train_step``: ONLY_ADV, the registry's
    FGSM self-attack on the live weights, then BCE/Adam) in bf16, f32 and
    the fused configuration: the launches of one step (bf16: layer 0 one
    forward and one dx; f32: no kernel; fused: layer 0 1 + 1, LFCC >= 1,
    trunk 2 + 2), three more steps with a finite loss that move every
    weight and every BN running statistic, then the stale-weight guard:
    layer 0's packed weights equal the live ones and, on a fresh batch,
    the FGSM batch through the kernels equals the plain ops' on >=
    TRAIN_FGSM_EQUAL (0.99 default, 0.9 fused) of its coordinates, both in
    the eps ball (beside it
    the share a copy of the weights of before the steps gives, which a
    stale cache would show); then ``measure_torch_train``
    (ms per step, examples/s, peak memory) in bf16 and f32;
18. clean f32 train steps of RawNet3 at B=16 (C=1024, T=6435) and
    SpecRNet at B=64: finite losses, RawNet3's sinc band parameters with
    a finite non-zero gradient and its lr equal to the warm-restart
    schedule (T_0 = 4) over 5 steps; ms per step and peak memory;
19. the two training CLIs end to end on the card (``python -m``, in a
    temporary working directory): ``train_models`` on synthetic:64 with
    ``-b 16 -e 1 -ta 32``, then ``train_models_on_adversarial_attacks
    --finetune`` from its checkpoint with ADAPTIVE (FGSM, PGDL2) and
    ONLY_ADV (FGSM): their ``train/``, ``test/``, ``adv_test/{atk}__*``
    and ``multi_f1_score`` lines, and each saved ``.pth`` loaded back
    through ``models.load_model``;
20. the real-corpus path: a mini-corpus written to a temporary directory in
    the published layouts (``tests/torch_port_corpus.py``: ASVspoof2021-DF
    16 kHz FLAC, WaveFake WAV at 22,050 / 24,000 / 48,000 Hz, FakeAVCeleb
    MP3 at 44.1 kHz through libmp3lame, which the line names as left out
    when the codecs are absent; 1-6 s utterances with 0.1-0.6 s silences),
    its generation seconds; every FLAC and WAV decoded to the exact PCM
    written, every MP3 to the written length within the codec's padding at
    the written rate, and the decode ms per file of each format; one epoch
    of ``train_models`` on it (-b 64, configs/training/lcnn.yaml: the
    DetectionDataset with oversampling), then, with that checkpoint in the
    bf16 default and fused LCNN configurations, raw-mode PGD-10
    (``--raw_from_dataset``) on the val subset at B=64: a callback run
    whose first batch's victim predictions equal, bit for bit under cuDNN's
    deterministic algorithms, the victim's on
    ``wavefake_preprocessing_on_batch`` of the callback's attacked batch;
    the trim changed at least one attacked wave; the CLI's raw and plain
    runs with their ``adv_eval/*`` lines, the reports' keys finite, layer
    0's launches 10 backward and >= 10 forward per batch (fused: LFCC >=
    10, trunk >= 20 forward and 20 backward per batch) in the raw run; the
    examples/s of ``generate_attacks`` alone, raw and plain, two runs each
    in ABBA order over the train subset (about ten batches) with models
    and manifests built beforehand, their spread, raw mode's extra wall
    within each adjacent (plain, raw) pair, and the device's idle
    share in one profiled run of each mode against that run's own wall;
    and the host ms per batch of the re-preprocessing round trip (device ->
    host, trim + pad, -> device) with its share of a raw-mode batch;
21. every name in ``EXTRA_ATTACKS`` through ``build_attack`` +
    ``attack_in_wave_space`` on the bf16 LCNN default configuration
    (64,600-sample waves, random weights from seed 0): the gradient
    attacks at B=64, Square, OnePixel, Pixle and AutoAttack at B=8, with
    the depth cuts the line lists under ``reduced`` (CW 100 steps, APGD
    and APGDT 20, Square 200 queries, OnePixel 5 generations of 399,
    Pixle 2 x 20, AutoAttack as ``multiattack`` over its four members at
    those cuts with FAB at 20 steps). Each is checked in [0, 1] space:
    finite and in the box, in its Linf ball (OnePixel: at most one
    coordinate changed; Pixle: only values its row held; VANILA: its
    input), and its layer-0 launches equal to its own count (CW: forwards
    = dx = the steps it ran); each with its success rate over the rows
    correct at first, then the seconds and examples/s of a second run and
    the device's idle share in a third, profiled run. Then APGD-CE (20
    steps) on the fused configuration at B=64 with its LFCC and trunk
    launches against its count, and the qualitative pipeline on synthetic
    n=128:
    ``save_adversarial_dataset`` with APGD over 2 batches (the ``.npz``
    keys and shapes, its robust accuracy that of the saved predictions),
    a white-box ``generate_attacks(attack_name="APGD")`` with the
    ``AttackAnalyser`` callback, ``AttackPostAnalyser.
    read_waves_and_calc_metrics`` on the pairs it wrote (one row per pair,
    finite MCD >= 0, ``mcd_metrics.csv``) and the plots where matplotlib
    imports;
22. the rest of the JAX package, one JSON line per part: PGD-10 on the
    bf16 LCNN at B=256 under each numerics switch (``ADAA_FUSED_LCNN=0``:
    no layer-0 launch; ``ADAA_FOLD_BN=0`` with the fused trunk asked for:
    no trunk launch; ``ADAA_BF16_FRONTEND=0``, ``ADAA_MFM_EQMASK=0``,
    ``ADAA_POOL_EQMASK=0``: the default's launches), on RawNet3's b2n
    configuration at B=64 (``ADAA_SINC_VJP=0``, ``ADAA_BF16_FRONTEND=0``:
    its b2n launches) and on SpecRNet (``ADAA_POOL_EQMASK=0``: no kernel),
    each in its ball and the box, its clean logits within
    SWITCH_LOGIT_RTOL of the default's (relative to the largest; exact for
    the eqmask switches) and within SWITCH_F32_RTOL of the same weights in
    f32, the ``ADAA_BF16_FRONTEND=0`` features (LCNN) and encoder output
    (RawNet3) bit-equal to the f32 model's, examples/s of a warm batch and
    the idle share of a profiled one;
    ``mel_spec`` at (64, 64600) against the CPU; RawNet2 (the ASVspoof2021
    baseline's hyperparameters, 64,600-sample waves), Meso4,
    MesoInception4 and Xception ((64, 4, 80, 404) maps) with finite logits
    and a PGD-10 batch in its ball, examples/s; ``count_flops`` of LCNN
    PGD-10 per example on the plain ops beside phase 4's examples/s and
    the tensor-core share it implies (printed, not a metric); a
    ``.msgpack`` written after three training steps and read back with
    bit-equal logits; the adversarial-evaluation batch script on three
    white-box entries (FGSM, PGDL2, FAB; ``--amount 64``, listed under
    ``reduced``) with each report checked; ``dryrun_multichip(1)`` on an
    NCCL group of one on the card;
23. the port's last entry points, one JSON line per part:
    ``scripts/bench_effectiveness.run_family`` over the three families at
    full width (LCNN and SpecRNet B=128, RawNet3 B=64, 64,600 samples):
    PGD-10 from each surrogate scored on the f32 victim (TF32 off), every
    row finite with a mean |logit shift| above 0, a flip rate in [0, 1],
    its exact kernel launches (EFF_LAUNCHES) and its shift within
    EFF_BAND of its family's f32 row; ``bench_attacks`` (FGSM, PGD, PGDL2,
    CW, FAB on the bf16 LCNN at B=64, ``--iters 1``): ``mfu_pct`` in
    (0, 100] and PGD-10's FLOPs an example 9.5-10.5x FGSM's;
    ``bench_train`` (bf16 and f32 at B=256, ``--iters 3``); the
    ``robustness_pipeline`` and ``transfer_attack`` examples on the bf16
    detectors (``ADAA_BF16=1``) at 64,600 samples and their default
    ``--train-n`` and ``--epochs``, every accuracy finite and in [0, 1]
    (not gated on its value) and each attack's layer-0 launches on the LCNN
    (none from the SpecRNet source), then ``attack_demo`` and
    ``performance_comparison`` at their defaults. The depth cuts are under
    each line's ``reduced``.

The last lines are the kernels' JSON summary (all nine kernel entries),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import importlib.util
import json
import logging
import os
import shutil
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

B = 256
EPS = 0.0005  # the registry's "PGD" eps
# |logit(kernel) - logit(twin)| bound: the bound within which the bf16
# port agrees with the JAX model on the CPU (tests/test_torch_port_lcnn.py)
LOGIT_ATOL = 3e-4
LFCC_ATOL, LFCC_RTOL = 5e-4, 1e-4  # tests/test_pallas_lfcc.py's band
HIGHEST_GRAD_RTOL = 1e-6
# dx of the trunk kernels vs plain: both sum in f32 in other orders, so
# candidates within an ulp of each other can route a whole cotangent to
# another conv output; at B=256 (~33 M routed cotangents) a few dozen
# such flips give ~1e-3 (measured 4.5e-4 to 1.05e-3 on an H100)
TRUNK_DX_RTOL = 3e-3
RB = 64  # RawNet3's batch: the JAX package's rawnet3:PGD record
# b2n kernel vs plain: both sum the same exact bf16 products in f32 in other
# orders, so an output near a bf16 rounding boundary can round the other way
# (o and y), and a relu or routing decision near zero can flip; measured on an
# H100 at B=2: y bit-equal 0.984-0.990, mean relative 2.3e-5 to 3.1e-5, dx
# relative L2 1.3e-3 to 1.5e-3 (tests/test_torch_port_gpu.py). The JAX
# package's own bands for its kernel against flax are 0.02 and 0.05.
B2N_Y_BIT_EQUAL, B2N_Y_MEAN_REL, B2N_DX_REL_L2 = 0.97, 1e-4, 5e-3
# kernel vs plain logits of the b2n configuration at B=64 (measured 1.5e-4)
RAWNET3_LOGIT_ATOL = 5e-4
# fused vs plain LFCC under the bf16 SpecRNet at B=64: first_bn rounds cepstra
# of magnitude ~100 to bf16 (ulp 0.5), so LFCC differences inside its band flip
# whole ulps. The JAX package's own kernel-vs-XLA gap on its bf16 SpecRNet is
# 3.4e-4 at B=64 (CPU, interpret mode); this port measured 4.1e-4 on an H100
SPECRNET_LOGIT_ATOL = 1e-3
# published H100 SXM peaks (NVIDIA data sheet, dense) for bound_ms
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(n_bytes: float, flops: float, kind: str) -> dict:
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate of their type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def randn(rng, shape, scale=1.0, dtype=torch.float32):
    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return t.to("cuda").to(dtype)


def layer0_library_ms(x, w) -> dict:
    """cuDNN's bf16 conv 1 -> 64 5x5 (pad 2) at layer 0's shape, and its input
    gradient from a dense conv-output cotangent: a yardstick of the conv
    stage alone (no MFM, pool, winner or routing; the port never calls it)."""
    xb = x.to(torch.bfloat16)[:, None]
    wb = w.to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(21)
    dy = torch.randn(x.shape[0], 64, 404, 80, device="cuda", generator=gen).to(torch.bfloat16)
    return {"fwd": median_ms(lambda: F.conv2d(xb, wb, padding=2)),
            "bwd": median_ms(lambda: torch.nn.grad.conv2d_input(xb.shape, wb, dy, padding=2))}


def layer0_stage(name: str):
    return "fwd" if "layer0_fwd_kernel" in name else "bwd" if "layer0_dx_kernel" in name else None


def phase2_layer0(layer0):
    rng = np.random.default_rng(0)
    x = randn(rng, (B, 404, 80), dtype=torch.bfloat16)
    w = randn(rng, (64, 1, 5, 5), 0.2)
    bias = randn(rng, (64,), 0.1)
    g = randn(rng, (B, 202, 40, 32), dtype=torch.bfloat16)

    out_k, idx_k = layer0.kernel_fwd(x, w, bias, True)
    out_r, idx_r = layer0.reference_fwd(x, w, bias, True)
    dx_k = layer0.kernel_bwd(idx_k, g, w, torch.bfloat16)
    dx_r = layer0.reference_bwd(idx_r, g, w, torch.bfloat16)
    torch.cuda.synchronize()

    ulp = layer0.bf16_ulp_distance(out_k, out_r)
    bit_equal = float((ulp == 0).float().mean())
    idx_equal = float((idx_k == idx_r).float().mean())
    dx_rel = float((dx_k.float() - dx_r.float()).norm() / dx_r.float().norm())
    fwd_err = float((out_k.float() - out_r.float()).abs().max())
    bwd_err = float((dx_k.float() - dx_r.float()).abs().max())
    times = {
        "fwd_ms": median_ms(lambda: layer0.kernel_fwd(x, w, bias, True)),
        "fwd_plain_ms": median_ms(lambda: layer0.reference_fwd(x, w, bias, True)),
        "bwd_ms": median_ms(lambda: layer0.kernel_bwd(idx_k, g, w, torch.bfloat16)),
        "bwd_plain_ms": median_ms(lambda: layer0.reference_bwd(idx_r, g, w, torch.bfloat16)),
    }
    device = device_ms(lambda: (layer0.kernel_fwd(x, w, bias, True),
                                layer0.kernel_bwd(idx_k, g, w, torch.bfloat16)), layer0_stage)
    library = layer0_library_ms(x, w)
    emit({"phase": 2, "batch": B, "fwd_bit_equal": bit_equal,
          "fwd_max_ulp": int(ulp.max()), "idx_equal": idx_equal,
          "dx_rel_l2": dx_rel, "fwd_max_abs_err": fwd_err,
          "bwd_max_abs_err": bwd_err, **times, "kernel_ms": device,
          "library_ms": library,
          "library_note": "cuDNN bf16 conv 1 -> 64 5x5 and its input gradient at the same "
                          "shape: a yardstick of the conv stage alone, never called by the port"})
    check(bit_equal >= 0.999, f"forward bit-equal share {bit_equal} < 0.999")
    check(int(ulp.max()) <= 1, f"forward differs by {int(ulp.max())} bf16 ulp")
    check(idx_equal >= 0.999, f"winner index agreement {idx_equal} < 0.999")
    check(dx_rel < 1e-3, f"dx relative L2 error {dx_rel} >= 1e-3")
    # bytes: x, w, bias, out, idx (uint8, unpacked) / idx, g, w, dx;
    # operations: 25 bf16 products per conv output and channel forward, 25
    # per routed cotangent backward
    n_in, n_out = B * 404 * 80, B * 202 * 40 * 32
    w_bytes = 64 * 25 * 4 + 64 * 4
    bounds = {"fwd": bound(2 * n_in + w_bytes + 2 * n_out + n_out,
                           2 * 25 * n_in * 64, "bf16"),
              "bwd": bound(n_out + 2 * n_out + w_bytes + 2 * n_in,
                           2 * 25 * n_out, "bf16")}
    return fwd_err, bwd_err, times, bounds, library


def lfcc_stage(name: str):
    return "fwd" if "lfcc_kernel" in name else None


def phase5_lfcc(lfcc_fused):
    rng = np.random.default_rng(5)
    x = randn(rng, (B, lfcc_fused.WAVE_LEN))
    result = {"phase": 5, "batch": B, "atol": LFCC_ATOL, "rtol": LFCC_RTOL}
    worst = 0.0
    for kind in lfcc_fused.FILTERBANKS:
        out_k = lfcc_fused.kernel_forward(x, kind)
        out_r = lfcc_fused.reference_forward(x, kind)
        torch.cuda.synchronize()
        err = (out_k - out_r).abs()
        excess = float((err - (LFCC_ATOL + LFCC_RTOL * out_r.abs())).max())
        result[kind] = {
            "max_abs_err": float(err.max()),
            "max_rel_err": float(err.max() / out_r.abs().max()),
            "max_band_excess": excess,
            "ms": median_ms(lambda: lfcc_fused.kernel_forward(x, kind)),
            "plain_ms": median_ms(lambda: lfcc_fused.reference_forward(x, kind)),
            "kernel_ms": device_ms(lambda: lfcc_fused.kernel_forward(x, kind),
                                   lfcc_stage).get("fwd"),
        }
        check(tuple(out_k.shape) == (B, lfcc_fused.N_CEP, lfcc_fused.N_FRAMES),
              f"lfcc shape {tuple(out_k.shape)}")
        check(bool(torch.isfinite(out_k).all()), f"non-finite {kind} cepstra")
        check(excess <= 0.0, f"{kind} cepstra outside atol {LFCC_ATOL} + rtol {LFCC_RTOL}")
        worst = max(worst, result[kind]["max_abs_err"])
    # the linear filterbank is the main path's. Bytes: x, the constant
    # tables, out. f32 operations per frame of the function the kernel
    # computes: the window (400), the 256-point complex FFT (5 N log2 N),
    # the real split and power (21 per bin), the filterbank's non-zero
    # weights and the DCT. dft_bound_ms: the same with the TPU kernel's
    # DFT product on the window's 400 taps in place of the FFT
    nnz = int((lfcc_fused.filterbank_matrix("linear") != 0).sum())
    n_const = lfcc_fused.TAB_LEN + 2 * 512 * 2 + 257 * 128 + 128 * 2 + 128 * 80
    io_bytes = 4 * (B * lfcc_fused.WAVE_LEN + n_const + B * 80 * 404)
    fft = 400 + 5 * 256 * 8 + 21 * lfcc_fused.N_BINS
    rest = 2 * nnz + 2 * 128 * 80
    b = bound(io_bytes, B * 404 * (fft + rest), "f32")
    dft = bound(4 * (B * lfcc_fused.WAVE_LEN + 400 * 512 + 400 + 257 * 128 + 128 * 80
                     + B * 80 * 404),
                2 * B * 404 * (400 * 2 * lfcc_fused.N_BINS + nnz + 128 * 80), "f32")
    result["bound_ms"], result["bound_by"] = b["bound_ms"], b["bound_by"]
    result["dft_bound_ms"] = dft["bound_ms"]
    emit(result)
    return worst, result["linear"]["ms"], result["linear"]["plain_ms"], b


def trunk_conv_library_ms(am, wb, spec) -> dict:
    """cuDNN bf16 channels-last conv3x3 of the same shapes: the forward and
    its input gradient, a yardstick of the conv stage alone (no MFM, pool or
    routing; the port never calls it)."""
    x = am.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    w = wb.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    gen = torch.Generator(device="cuda").manual_seed(61)
    dy = torch.randn(x.shape[0], spec.c_out, spec.t, spec.f, device="cuda", generator=gen)
    dy = dy.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return {"fwd": median_ms(lambda: F.conv2d(x, w, padding=1)),
            "bwd": median_ms(lambda: torch.nn.grad.conv2d_input(x.shape, w, dy, padding=1))}


def phase6_trunk(trunk):
    rng = np.random.default_rng(6)
    out = {"phase": 6, "batch": B, "mask_equal_min": 0.999}
    totals = {"fwd_ms": 0.0, "fwd_plain_ms": 0.0, "bwd_ms": 0.0, "bwd_plain_ms": 0.0,
              "fwd_err": 0.0, "bwd_err": 0.0, "fwd_bytes": 0.0, "fwd_flops": 0.0,
              "bwd_bytes": 0.0, "bwd_flops": 0.0}
    for name, spec in (("A", trunk.SEGMENT_A), ("B", trunk.SEGMENT_B)):
        am = randn(rng, (B, spec.t, spec.f, spec.c2))
        wb = randn(rng, (spec.c_out, spec.c2, 3, 3), 1.0 / np.sqrt(9 * spec.c2))
        bb = randn(rng, (spec.c_out,), 0.1)
        g = randn(rng, (B, spec.t_out, spec.f_out, spec.half)).to(torch.bfloat16).float()
        # packed as the forward keeps it for the backward
        wpk = trunk.pack_weights(wb, spec, backward=True)
        y_k, m_k = trunk.kernel_fwd(am, wb, bb, spec, True)
        y_r, m_r = trunk.reference_fwd(am, wb, bb, spec), trunk.reference_mask(am, wb, bb, spec)
        dx_k = trunk.kernel_bwd(m_k, g, wb, spec, wpk)
        dx_r = trunk.reference_bwd(am, wb, bb, g, spec)
        torch.cuda.synchronize()
        routed = int(sum(int(((m_r >> k) & 1).sum()) for k in range(8)))
        bit_equal = float((y_k.to(torch.bfloat16) == y_r.to(torch.bfloat16)).float().mean())
        mask_equal = float((m_k == m_r).float().mean())
        fwd_err = float((y_k - y_r).abs().max())
        scale = float(y_r.abs().max())
        dx_rel = float((dx_k - dx_r).norm() / dx_r.norm())
        seg = {"fwd_bit_equal_bf16": bit_equal, "mask_equal": mask_equal,
               "fwd_max_abs_err": fwd_err, "fwd_max_abs_ref": scale, "dx_rel_l2": dx_rel,
               "bwd_max_abs_err": float((dx_k - dx_r).abs().max()),
               "routed_cotangents": routed,
               "fwd_ms": median_ms(lambda: trunk.kernel_fwd(am, wb, bb, spec, True)),
               "fwd_plain_ms": median_ms(lambda: trunk._pool_and_mask(am, wb, bb, spec, with_mask=True)),
               "bwd_ms": median_ms(lambda: trunk.kernel_bwd(m_k, g, wb, spec, wpk)),
               "bwd_plain_ms": median_ms(lambda: trunk.reference_dx(m_r, g, wb, spec)),
               "kernel_ms": device_ms(lambda: (trunk.kernel_fwd(am, wb, bb, spec, True),
                                               trunk.kernel_bwd(m_k, g, wb, spec, wpk)),
                                      trunk_stage),
               "conv_library_ms": trunk_conv_library_ms(am, wb, spec)}
        out[name] = seg
        check(bit_equal >= 0.999, f"segment {name}: bf16 bit-equal share {bit_equal} < 0.999")
        check(mask_equal >= 0.999, f"segment {name}: tie-mask equal share {mask_equal} < 0.999")
        check(fwd_err <= 1e-4 * scale, f"segment {name}: forward error {fwd_err} > 1e-4 x {scale}")
        check(dx_rel < TRUNK_DX_RTOL, f"segment {name}: dx relative L2 {dx_rel} >= {TRUNK_DX_RTOL}")
        for k in ("fwd_ms", "fwd_plain_ms", "bwd_ms", "bwd_plain_ms"):
            totals[k] += seg[k]
        totals["fwd_err"] = max(totals["fwd_err"], fwd_err)
        totals["bwd_err"] = max(totals["bwd_err"], seg["bwd_max_abs_err"])
        # the work of the function each kernel computes. Forward: am, the
        # weights and bias (f32) in, out (f32) and the mask out; bf16
        # products, 9 c2 per conv output that reaches the pool. dx: g (f32),
        # the mask and the packed bf16 weights in, dx (f32) out; dy is sparse,
        # so its products are 9 c2 per routed cotangent of this run's data
        n_am = B * spec.t * spec.f * spec.c2
        n_y = B * spec.t_out * spec.f_out * spec.half
        n_w = spec.c_out * spec.c2 * 9 + spec.c_out
        totals["fwd_bytes"] += 4 * (n_am + n_w + n_y) + n_y
        totals["fwd_flops"] += 2 * 9 * spec.c2 * B * 4 * spec.t_out * spec.f_out * spec.c_out
        totals["bwd_bytes"] += 4 * n_y + n_y + 2 * (n_w - spec.c_out) + 4 * n_am
        totals["bwd_flops"] += 2 * 9 * spec.c2 * routed
        del am, g, y_k, y_r, m_k, m_r, dx_k, dx_r
        torch.cuda.empty_cache()
    emit(out)
    bounds = {"fwd": bound(totals["fwd_bytes"], totals["fwd_flops"], "bf16"),
              "bwd": bound(totals["bwd_bytes"], totals["bwd_flops"], "bf16")}
    return totals, bounds


def logits_vs_plain(phase: int, model, x, tol: float = LOGIT_ATOL) -> None:
    """Logits with the kernels against the plain versions of the fused ops."""
    with torch.no_grad():
        z_kernel = model(x)
        model.plain_ops = True
        z_plain = model(x)
        model.plain_ops = False
    torch.cuda.synchronize()
    err = float((z_kernel - z_plain).abs().max())
    emit({"phase": phase, "shape": list(z_kernel.shape),
          "max_abs_logit": float(z_plain.abs().max()), "logit_max_abs_err": err,
          "tol": tol})
    check(tuple(z_kernel.shape) == (x.shape[0], 1), f"logit shape {tuple(z_kernel.shape)}")
    check(bool(torch.isfinite(z_kernel).all()), "non-finite logits")
    check(err <= tol, f"kernel/plain logits differ by {err}")


def attack_checked(phase: int, attacks, main, counters) -> dict:
    """One PGD-10 batch; the launch counts of ``counters`` read around it."""
    model, attack, x, y, gen = main
    with torch.no_grad():
        ce_clean = float(attacks.two_class_ce(model(x), y))
    for counts in counters.values():
        for k in counts:
            counts[k] = 0
    adv = attack(x, y, gen)
    torch.cuda.synchronize()
    launches = {name: dict(counts) for name, counts in counters.items()}
    x01, mn, mx = attacks.to_minmax(x)
    linf = float(((adv - mn) / (mx - mn) - x01).abs().max())
    with torch.no_grad():
        ce_adv = float(attacks.two_class_ce(model(adv), y))
    emit({"phase": phase, "linf01": linf, "eps": EPS, "ce_clean": ce_clean,
          "ce_adv": ce_adv, "launches": launches})
    check(tuple(adv.shape) == tuple(x.shape), f"adversarial shape {tuple(adv.shape)}")
    check(bool(torch.isfinite(adv).all()), "non-finite adversarial waves")
    check(linf <= EPS + 1e-6, f"outside the eps ball: {linf}")
    check(ce_adv >= ce_clean, f"CE fell: {ce_adv} < {ce_clean}")
    return launches


def check_layer0(launches: dict) -> None:
    check(launches["layer0"]["fwd"] >= 10 and launches["layer0"]["bwd"] == 10,
          f"layer-0 launches {launches}")


def phase10_pool(pool):
    """The pool kernels against their plain version at RawNet3's two pool
    shapes: forward and dx bit-equal (first-max routing is deterministic)."""
    rng = np.random.default_rng(10)
    out = {"phase": 10}
    main_shape = None
    for name, (shape, w) in (("layer1_w5", ((RB, 6435, 1024), 5)),
                             ("w3", ((RB, 1287, 1024), 3))):
        x = randn(rng, shape, dtype=torch.bfloat16)
        g = randn(rng, (shape[0], shape[1] // w, shape[2]), dtype=torch.bfloat16)
        y_k, y_r = pool.kernel_fwd(x, w), pool.reference_fwd(x, w)
        dx_k, dx_r = pool.kernel_bwd(x, g, w), pool.reference_bwd(x, g, w)
        torch.cuda.synchronize()
        xv = x.transpose(1, 2)  # the (B, C, T) view
        res = {"fwd_equal": bool(torch.equal(y_k, y_r)), "dx_equal": bool(torch.equal(dx_k, dx_r)),
               "fwd_max_abs_err": float((y_k.float() - y_r.float()).abs().max()),
               "bwd_max_abs_err": float((dx_k.float() - dx_r.float()).abs().max()),
               "fwd_ms": median_ms(lambda: pool.kernel_fwd(x, w)),
               "fwd_plain_ms": median_ms(lambda: pool.reference_fwd(x, w)),
               "fwd_library_ms": median_ms(lambda: F.max_pool1d(xv, w)),
               "bwd_ms": median_ms(lambda: pool.kernel_bwd(x, g, w)),
               "bwd_plain_ms": median_ms(lambda: pool.reference_bwd(x, g, w))}
        n_x, n_y = x.numel(), g.numel()
        # bytes: x, out / x, g, dx (bf16); operations: one f32 compare per
        # input element (forward) and two (recomputed max, routing) backward
        res["fwd_bound"] = bound(2 * (n_x + n_y), n_x, "f32")
        res["bwd_bound"] = bound(2 * (2 * n_x + n_y), 2 * n_x, "f32")
        out[name] = res
        check(res["fwd_equal"] and res["dx_equal"], f"pool {name}: kernel != plain")
        if main_shape is None:
            main_shape = res
        del x, g, y_k, y_r, dx_k, dx_r
    emit(out)
    return main_shape


# b2n kernels by stage, from their (mangled or demangled) names
B2N_STAGES = (("conv1_gemm", "EpiH"), ("conv3_res_gemm", "EpiO"), ("dq_w3t_gemm", "EpiDcat"),
              ("chain_fwd", "chain_kernelILb0E"), ("descent", "chain_kernelILb1E"),
              ("dx_gemm", "gemm_kernel"))


def b2n_stage(name: str) -> str:
    name = name.replace("chain_kernel<false>", "chain_kernelILb0E")
    name = name.replace("chain_kernel<true>", "chain_kernelILb1E")
    return next((stage for stage, key in B2N_STAGES if key in name), "other")


def sass_counts(lib) -> dict:
    """wgmma, TMA-load and setmaxnreg instructions in a library's SASS, or
    None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout.splitlines()
    return {op: sum(op in ln for ln in sass) for op in ("HGMMA", "UTMALDG", "USETMAXREG")}


def device_ms(fn, stage_of) -> dict:
    """Device ms of the kernels one call of ``fn`` launches (torch.profiler),
    summed by ``stage_of(kernel name)``; a kernel it maps to None is left out.
    One warm-up call runs under the profiler first: without it, the kernels
    at the start of a session were sometimes not recorded."""
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1)
    with torch.profiler.profile(activities=acts, schedule=schedule, acc_events=True) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    ms = {}
    for e in prof.events():
        stage = stage_of(e.name) if e.device_type == DeviceType.CUDA else None
        if stage is not None:
            ms[stage] = ms.get(stage, 0.0) + e.time_range.elapsed_us() / 1e3
    return ms


def trunk_stage(name: str):
    return "fwd" if "trunk_fwd_kernel" in name else "dx" if "trunk_dx_kernel" in name else None


def b2n_gemm_library_ms(rows: int, cin: int) -> dict:
    """torch.matmul of the b2n GEMM stage's bf16 products at their shapes:
    forward x W1, cat W3 (and x Wr), backward dq W3^T, dz1 W1^T (and dy
    Wr^T); a yardstick of the products alone, not of the kernels' work."""
    gen = torch.Generator(device="cuda").manual_seed(11)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)

    x, a, w1, w3 = rand(rows, cin), rand(rows, 1024), rand(cin, 1024), rand(1024, 1024)
    proj = cin != 1024
    wr = rand(cin, 1024) if proj else None

    def fwd():
        torch.matmul(x, w1)
        torch.matmul(a, w3)
        if proj:
            torch.matmul(x, wr)

    def bwd():
        torch.matmul(a, w3.t())
        torch.matmul(a, w1.t())
        if proj:
            torch.matmul(a, wr.t())

    return {"fwd": median_ms(fwd, reps=5, warmup=1), "bwd": median_ms(bwd, reps=5, warmup=1)}


def b2n_block(rawnet3, cin: int, dilation: int, pool_size: int, seed: int):
    """A RawNet3 block with random weights, biases and BN statistics."""
    blk = rawnet3.Bottle2neck(cin, 1024, dilation, pool_size)
    blk.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for bn in (blk.bn1, blk.bn3, *blk.bns):
            n = bn.num_features
            bn.running_mean.copy_(torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)))
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32)))
        for conv in (blk.conv1, blk.conv3, *blk.convs):
            conv.bias.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, conv.bias.shape).astype(np.float32)))
    return blk.to("cuda").eval()


def phase11_b2n(b2n, rawnet3):
    """The b2n kernels against their plain version at RawNet3's three block
    shapes, B=64; times and bounds summed over the blocks (one forward or
    one backward of the model's trunk)."""
    out = {"phase": 11, "batch": RB, "bands": {"y_bit_equal": B2N_Y_BIT_EQUAL,
                                               "y_mean_rel": B2N_Y_MEAN_REL,
                                               "dx_rel_l2": B2N_DX_REL_L2}}
    tot = {k: 0.0 for k in ("fwd_ms", "fwd_plain_ms", "bwd_ms", "bwd_plain_ms", "fwd_err",
                            "bwd_err", "fwd_bytes", "fwd_flops", "bwd_bytes", "bwd_flops")}
    stages = {"phase": 11, "batch": RB,
              "what": "b2n device ms by kernel, one forward and one backward (torch.profiler)",
              "profile_ms": {}, "gemm_library_ms": {"fwd": 0.0, "bwd": 0.0},
              "gemm_library_note": "torch.matmul of the same bf16 products at the same shapes, "
                                   "summed over the layers: a yardstick of the GEMM stage alone, "
                                   "never called by the port"}
    rng = np.random.default_rng(11)
    for name, (cin, d, pool_size, t) in (("layer1", (256, 2, 5, 6435)),
                                         ("layer2", (1024, 3, 3, 1287)),
                                         ("layer3", (1024, 4, 0, 429))):
        p = b2n_block(rawnet3, cin, d, pool_size, 60 + d).folded()
        x = randn(rng, (RB, t, cin), 0.3, torch.bfloat16)
        dy = randn(rng, (RB, t, 1024), dtype=torch.bfloat16)
        y_k, o_k, masks = b2n.kernel_fwd(x, p, d)
        dx_k = b2n.kernel_bwd(dy, o_k, masks, p, d, cin)
        y_r, o_r = b2n.reference_fwd(x, p, d)
        dx_r = b2n.reference_bwd(x, dy, o_r, p, d)
        torch.cuda.synchronize()
        yk, yr, dk, dr = y_k.float(), y_r.float(), dx_k.float(), dx_r.float()
        res = {"y_bit_equal": float((y_k == y_r).float().mean()),
               "o_bit_equal": float((o_k == o_r).float().mean()),
               "y_mean_rel": float((yk - yr).abs().mean() / yr.abs().mean()),
               "y_max_abs_err": float((yk - yr).abs().max()), "y_max_abs_ref": float(yr.abs().max()),
               "dx_rel_l2": float((dk - dr).norm() / dr.norm()),
               "dx_max_abs_err": float((dk - dr).abs().max())}
        del yk, yr, dk, dr, y_r, o_r, dx_r, dx_k
        res.update({
            "fwd_ms": median_ms(lambda: b2n.kernel_fwd(x, p, d), reps=5, warmup=1),
            "fwd_plain_ms": median_ms(lambda: b2n.reference_fwd(x, p, d), reps=3, warmup=1),
            "bwd_ms": median_ms(lambda: b2n.kernel_bwd(dy, o_k, masks, p, d, cin), reps=5,
                                warmup=1),
            "bwd_plain_ms": median_ms(lambda: b2n.reference_bwd(x, dy, o_k, p, d), reps=3,
                                      warmup=1)})
        out[name] = res
        check(res["y_bit_equal"] >= B2N_Y_BIT_EQUAL, f"b2n {name}: y bit-equal {res['y_bit_equal']}")
        check(res["y_mean_rel"] <= B2N_Y_MEAN_REL, f"b2n {name}: y mean rel {res['y_mean_rel']}")
        check(res["dx_rel_l2"] <= B2N_DX_REL_L2, f"b2n {name}: dx rel L2 {res['dx_rel_l2']}")
        for k in ("fwd_ms", "fwd_plain_ms", "bwd_ms", "bwd_plain_ms"):
            tot[k] += res[k]
        tot["fwd_err"] = max(tot["fwd_err"], res["y_max_abs_err"])
        tot["bwd_err"] = max(tot["bwd_err"], res["dx_max_abs_err"])
        # products: conv1, the chain's 21 taps of 128 x 128, conv3 and the
        # residual projection per row; the backward needs the same products
        # transposed (the forward's masks are kept, nothing is recomputed)
        rows = RB * t
        per_row = cin * 1024 + 21 * 128 * 128 + 1024 * 1024 + (cin * 1024 if cin != 1024 else 0)
        # bytes: x, the weights, y and o / dy, o, the masks, the weights, dx
        w_bytes = 2 * per_row
        tot["fwd_bytes"] += 2 * rows * cin + w_bytes + 2 * 2 * rows * 1024
        tot["fwd_flops"] += 2 * rows * per_row
        tot["bwd_bytes"] += 2 * 2 * rows * 1024 + 4 * rows * (32 + 28) + w_bytes + 2 * rows * cin
        tot["bwd_flops"] += 2 * rows * per_row
        stages["profile_ms"][name] = device_ms(
            lambda: (b2n.kernel_fwd(x, p, d), b2n.kernel_bwd(dy, o_k, masks, p, d, cin)), b2n_stage)
        del x, dy, y_k, o_k, masks
        torch.cuda.empty_cache()
        for k, v in b2n_gemm_library_ms(rows, cin).items():
            stages["gemm_library_ms"][k] += v
        torch.cuda.empty_cache()
    emit(out)
    emit(stages)
    bounds = {"fwd": bound(tot["fwd_bytes"], tot["fwd_flops"], "bf16"),
              "bwd": bound(tot["bwd_bytes"], tot["bwd_flops"], "bf16")}
    return tot, bounds


def rawnet3_phases(attacks, bench, pool, b2n, card) -> dict:
    """Phases 12-13: RawNet3 logits with the kernels against the plain
    versions (pool and b2n configurations), then PGD-10 at B=64 in all
    three configurations with their launch counts, and examples/s."""
    counters = {"pool": pool.LAUNCHES, "b2n": b2n.LAUNCHES}
    configs = {"default": bench.RAWNET3_CONFIG, "pool": bench.RAWNET3_POOL_CONFIG,
               "b2n": bench.RAWNET3_B2N_CONFIG}
    launches = {}
    for name, config in configs.items():
        path = bench.setup(RB, seed=0, device="cuda", model="rawnet3", config=config)
        if name != "default":
            logits_vs_plain(12, path.model, path.x, RAWNET3_LOGIT_ATOL)
        got = attack_checked(13, attacks, path, counters)
        launches[name] = got
        want = {"default": got["pool"]["fwd"] == 0 and got["b2n"]["fwd"] == 0,
                "pool": (got["pool"]["fwd"] >= 10 and got["pool"]["bwd"] == 10
                         and got["b2n"]["fwd"] == 0),
                "b2n": (got["b2n"]["fwd"] >= 30 and got["b2n"]["bwd"] == 30
                        and got["pool"]["fwd"] == 0)}[name]
        check(want, f"RawNet3 {name} configuration launches {got}")
        del path
        torch.cuda.empty_cache()
    eps = {name: bench.measure_torch(batch=RB, iters=3, warmup=1, model="rawnet3", config=config)
           for name, config in configs.items()}
    emit({"phase": 13, "metric": "adv_examples_per_sec_pgd10_rawnet3", **eps, "batch": RB,
          "card": card})
    return launches


ALL_KERNELS = ("layer0", "lfcc", "trunk", "pool", "b2n")
FAB_EPS = 0.3  # the registry's FAB: Linf, default eps


def zero(counters) -> None:
    for counts in counters.values():
        for k in counts:
            counts[k] = 0


def snapshot(counters) -> dict:
    return {name: dict(counts) for name, counts in counters.items()}


def launched(launches: dict, names) -> bool:
    """Whether any kernel of ``names`` was launched."""
    return any(v for name in names for v in launches[name].values())


def phase14_specrnet(attacks, bench, counters, card) -> dict:
    """PGD-10 on the bf16 SpecRNet at B=64, default and fused frontend."""
    configs = {"default": bench.SPECRNET_CONFIG, "fused": bench.SPECRNET_FUSED_CONFIG}
    launches = {}
    for name, config in configs.items():
        path = bench.setup(RB, seed=0, device="cuda", model="specrnet", config=config)
        if name == "fused":
            logits_vs_plain(14, path.model, path.x, SPECRNET_LOGIT_ATOL)
        got = attack_checked(14, attacks, path, counters)
        launches[name] = got
        others = [k for k in ALL_KERNELS if k != "lfcc"]
        want = {"default": not launched(got, ALL_KERNELS),
                "fused": got["lfcc"]["fwd"] >= 10 and not launched(got, others)}[name]
        check(want, f"SpecRNet {name} configuration launches {got}")
        del path
        torch.cuda.empty_cache()
    eps = {name: bench.measure_torch(batch=RB, iters=5, warmup=1, model="specrnet", config=config)
           for name, config in configs.items()}
    emit({"phase": 14, "metric": "adv_examples_per_sec_pgd10_specrnet", **eps, "batch": RB,
          "card": card})
    return launches


def phase15_fab(attacks, bench, counters, card) -> dict:
    """The registry's FAB on the bf16 LCNN at B=64, both steps, checked in
    [0, 1] space on what the attack returned inside ``attack_in_wave_space``."""
    path = bench.setup(RB, seed=0, device="cuda", model="lcnn", config=bench.CONFIG)
    logits_fn = attacks.make_logits_fn(path.model)
    out = {"phase": 15, "batch": RB, "eps": FAB_EPS, "card": card}
    before = os.environ.get("ADAA_FAB_MERGED")
    try:
        for step in ("reference_exact", "merged"):
            if step == "merged":
                os.environ["ADAA_FAB_MERGED"] = "1"
            else:
                os.environ.pop("ADAA_FAB_MERGED", None)
            fab01 = attacks.build_attack("FAB", logits_fn)  # reads ADAA_FAB_MERGED
            seen = {}

            def recorded(x01, y, generator):
                seen["x01"], seen["adv01"] = x01, fab01(x01, y, generator)
                return seen["adv01"]

            zero(counters)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            adv = attacks.attack_in_wave_space(recorded)(path.x, path.y, path.generator)
            end.record()
            end.synchronize()
            got = snapshot(counters)
            x01, adv01 = seen["x01"], seen["adv01"]
            with torch.no_grad():
                fooled = attacks.predicted_label(logits_fn(adv01)) != path.y
            linf = (adv01 - x01).abs().amax(dim=1)
            same = (adv01 == x01).all(dim=1)
            ok = same | (fooled & (linf <= FAB_EPS + 1e-6))
            success = ~same
            fwd_min = 200 if step == "reference_exact" else 100
            res = {"success_rate": float(success.float().mean()),
                   "median_linf_successful": (float(linf[success].median())
                                              if bool(success.any()) else None),
                   "examples_per_sec": RB / (start.elapsed_time(end) / 1e3),
                   "launches": got}
            out[step] = res
            check(tuple(adv.shape) == tuple(path.x.shape), f"FAB {step}: shape {tuple(adv.shape)}")
            check(bool(torch.isfinite(adv01).all()), f"FAB {step}: non-finite outputs")
            check(float(adv01.min()) >= 0.0 and float(adv01.max()) <= 1.0,
                  f"FAB {step}: outside [0, 1]")
            check(bool(ok.all()), f"FAB {step}: rows neither unchanged nor misclassified within "
                                  f"eps: {torch.nonzero(~ok).flatten().tolist()}")
            check(got["layer0"]["bwd"] == 100 and got["layer0"]["fwd"] >= fwd_min
                  and not launched(got, [k for k in ALL_KERNELS if k != "layer0"]),
                  f"FAB {step}: launches {got}")
    finally:
        if before is None:
            os.environ.pop("ADAA_FAB_MERGED", None)
        else:
            os.environ["ADAA_FAB_MERGED"] = before
    emit(out)
    return out


def report_ok(what: str, report: dict) -> None:
    keys = ("eer", "accuracy", "precision", "recall", "f1_score", "auc")
    check(set(report) == set(keys), f"{what}: report keys {sorted(report)}")
    check(all(np.isfinite(report[k]) for k in ("accuracy", "precision", "recall", "f1_score")),
          f"{what}: non-finite report {report}")


def phase16_eval(attacks, bench, models, counters, set_seed) -> None:
    """evaluate_nn and generate_attacks (white-box, transfer, the CLI's
    config-dict entry) on the synthetic set, n=128, batch 64."""
    from adaa_tpu_torch import metrics
    from adaa_tpu_torch.data.synthetic import SyntheticDataset
    from adaa_tpu_torch.eval import evaluate_nn, generate_attacks
    from adaa_tpu_torch.scripts import evaluate_models_on_adversarial_attacks as adv_cli

    seed = 16
    ds = SyntheticDataset(n=128, subset="val", return_meta=True)
    gen = set_seed(seed, "cuda")
    spec = models.init_model(models.get_model("specrnet", bench.SPECRNET_CONFIG), gen, "cuda")
    lcnn = models.init_model(models.get_model("lcnn", bench.CONFIG), gen, "cuda")
    out = {"phase": 16, "n": len(ds), "batch": RB}

    np.random.seed(seed)
    clean_spec = evaluate_nn(spec, ds, batch_size=RB, model_name="specrnet")
    np.random.seed(seed)
    clean_lcnn = generate_attacks(lcnn, ds, "NO_ATTACK", lcnn, RB)
    zero(counters)
    np.random.seed(seed)
    white = generate_attacks(lcnn, ds, "FGSM", lcnn, RB)
    white_launches = snapshot(counters)

    first = {}

    def on_attack_end(**kw):
        first.setdefault("kw", kw)

    # the recomputation must repeat generate_attacks' first batch bit for bit:
    # cuDNN's deterministic algorithms in both (some dgrad ones use atomics)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        zero(counters)
        np.random.seed(seed)
        transfer = generate_attacks(spec, ds, "PGD", lcnn, RB,
                                    generator=torch.Generator("cuda").manual_seed(seed),
                                    on_attack_end_callback=on_attack_end)
        transfer_launches = snapshot(counters)
        kw = first["kw"]
        x = torch.from_numpy(kw["batch_x"]).cuda()
        y = torch.from_numpy(kw["batch_y"]).cuda().long()
        attack = attacks.attack_in_wave_space(
            attacks.build_attack("PGD", attacks.make_logits_fn(lcnn)))
        adv = attack(x, y, torch.Generator("cuda").manual_seed(seed))
        spec.eval()
        with torch.no_grad():
            preds = torch.sigmoid(spec(adv).squeeze(1)).cpu().numpy()
        spec.train()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    recompute_err = float(np.abs(preds - kw["batch_preds"]).max())

    zero(counters)
    args = adv_cli.parse_args(["--asv_path", f"synthetic:{len(ds)}", "--attack", "PGD"])
    victim_cfg = {"data": {"seed": seed},
                  "model": {"name": "specrnet", "parameters": bench.SPECRNET_CONFIG}}
    surrogate_cfg = {"data": {"seed": seed}, "model": {"name": "lcnn", "parameters": bench.CONFIG}}
    cli_report = adv_cli.run(args, victim_cfg, surrogate_cfg)
    cli_launches = snapshot(counters)

    reports = {"eval_specrnet": clean_spec, "clean_lcnn": clean_lcnn, "whitebox_fgsm_lcnn": white,
               "transfer_pgd_lcnn_to_specrnet": transfer, "cli_transfer_pgd": cli_report}
    out.update({"reports": reports, "recompute_max_abs_err": recompute_err,
                "launches": {"whitebox": white_launches, "transfer": transfer_launches,
                             "cli": cli_launches}})
    emit(out)
    for line in (metrics.format_metrics("eval", clean_spec),
                 metrics.format_metrics("adv_eval", white),
                 metrics.format_metrics("adv_eval", cli_report)):
        print(line, flush=True)
    for what, report in reports.items():
        report_ok(what, report)
    share = 100.0 / len(ds)
    check(white["accuracy"] <= clean_lcnn["accuracy"] + share + 1e-9,
          f"white-box FGSM accuracy {white['accuracy']} above clean {clean_lcnn['accuracy']}")
    check(np.array_equal(preds, kw["batch_preds"]),
          f"callback predictions differ from the recomputation by {recompute_err}")
    check(white_launches["layer0"]["bwd"] == 2 and white_launches["layer0"]["fwd"] >= 2,
          f"white-box layer-0 launches {white_launches}")
    for what, got in (("transfer", transfer_launches), ("cli", cli_launches)):
        check(got["layer0"]["bwd"] == 20 and got["layer0"]["fwd"] >= 20,
              f"{what} layer-0 launches {got}")


# share of a fresh batch's FGSM coordinates equal, kernels vs plain ops, after
# the training steps, per configuration: the bf16 trunk's MFM and pool maxes
# have near-ties that a one-ulp difference in a kernel's output flips, and
# each flip reroutes a cotangent; the fused configuration adds the LFCC and
# trunk kernels' own (measured on an H100: 0.995 default, 0.959 fused). The
# weights of before the steps give ~0.52 in both, which is what a stale
# layer-0 weight cache would show
TRAIN_FGSM_EQUAL = {"bf16": 0.99, "fused": 0.9}


def fgsm_vs_plain(path, attacks, stale_model, band: float) -> dict:
    """The self-attack's FGSM on a fresh batch, on the live weights through
    the kernels and through ``plain_ops``: both in the eps ball, most
    coordinates equal. (On the batch it just trained on, the model's
    gradient shrinks step by step and its signs get fragile.) Beside it,
    the share that ``stale_model``, the weights of before the steps, would
    give through the kernels: what a stale weight cache would show."""
    from adaa_tpu_torch.training.adv_trainer import make_adv_fn

    model = path.state.model
    x = randn(np.random.default_rng(170), tuple(path.x.shape))
    adv_kernel = path.adv_fn(x, path.y)
    model.plain_ops = True
    try:
        adv_plain = path.adv_fn(x, path.y)
    finally:
        model.plain_ops = False
    adv_stale = make_adv_fn("FGSM", stale_model)(x, path.y)
    x01, mn, mx = attacks.to_minmax(x)
    linf = max(float(((a - mn) / (mx - mn) - x01).abs().max()) for a in (adv_kernel, adv_plain))
    equal = float((adv_kernel == adv_plain).float().mean())
    check(linf <= EPS + 1e-6, f"self-attack outside the eps ball: {linf}")
    check(equal >= band, f"FGSM kernels vs plain: {equal} of coordinates equal")
    return {"fgsm_equal_share": equal, "linf01": linf,
            "stale_weights_equal_share": float((adv_stale == adv_plain).float().mean())}


def train_steps_checked(bench, path, n: int) -> dict:
    """``n`` adversarial-training steps: a finite loss, every parameter and
    every BN running statistic moved."""
    model = path.state.model
    params = {k: p.detach().clone() for k, p in model.named_parameters() if p.requires_grad}
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    losses = [float(bench.adv_train_step(path)) for _ in range(n)]
    check(all(np.isfinite(losses)), f"non-finite training loss {losses}")
    now = dict(model.named_parameters())
    still = [k for k, v in params.items() if torch.equal(now[k].detach(), v)]
    check(not still, f"parameters that did not move: {still}")
    sd = model.state_dict()
    still = [k for k, v in stats.items() if torch.equal(sd[k], v)]
    check(not still, f"BN running statistics that did not move: {still}")
    return {"losses": losses}


def phase17_train(attacks, bench, layer0, counters, card) -> dict:
    """One ONLY_ADV step (FGSM self-attack on the live weights + BCE/Adam) on
    the LCNN at B=256, bf16 and f32: launches per step, 3 steps that move
    every weight and BN statistic, the stale-weight guard, then
    ``measure_torch_train``; and a short fused-configuration step."""
    out = {"phase": 17, "batch": B, "card": card}
    for name, config in (("bf16", bench.TRAIN_CONFIGS["bf16"]),
                         ("f32", bench.TRAIN_CONFIGS["f32"]), ("fused", bench.FUSED_CONFIG)):
        path = bench.setup_train(B, seed=17, device="cuda", config=config)
        bench.adv_train_step(path)  # warm-up
        torch.cuda.synchronize()
        zero(counters)
        bench.adv_train_step(path)
        torch.cuda.synchronize()
        launches = snapshot(counters)
        stale = copy.deepcopy(path.state.model)
        res = {"launches_per_step": launches, **train_steps_checked(bench, path, 3)}
        want = {"bf16": launches["layer0"] == {"fwd": 1, "bwd": 1}
                and not launched(launches, ("lfcc", "trunk")),
                "f32": not launched(launches, ALL_KERNELS[:3]),
                "fused": (launches["layer0"] == {"fwd": 1, "bwd": 1}
                          and launches["lfcc"]["fwd"] >= 1
                          and launches["trunk"] == {"fwd": 2, "bwd": 2})}[name]
        check(want, f"{name} adversarial training step launches {launches}")
        if name != "f32":
            # the stale-weight guard: after the steps the kernel reads the live
            # weights (layer 0's packed images are keyed on the version)
            w = path.state.model.m_transform["0"].weight.detach()
            check(torch.equal(layer0.packed_weights(w)[2], w.float()),
                  "layer 0's packed weights are stale after the optimizer steps")
            res.update(fgsm_vs_plain(path, attacks, stale, TRAIN_FGSM_EQUAL[name]))
        out[name] = res
        del path, stale
        torch.cuda.empty_cache()
    for name in ("bf16", "f32"):
        out[name].update(bench.measure_torch_train(B, iters=5, warmup=2, dtype=name))
        check(np.isfinite(out[name]["loss"]), f"{name} training loss {out[name]['loss']}")
        torch.cuda.empty_cache()
    emit(out)
    return out


def phase18_train_models(bench, card) -> dict:
    """Train steps (clean, f32) of RawNet3 at B=16 and SpecRNet at B=64, full
    width: ms per step, peak memory; RawNet3's sinc band parameters get a
    finite, non-zero gradient and its lr follows the warm-restart schedule."""
    from adaa_tpu_torch.training import train_state
    from adaa_tpu_torch.training.gd_trainer import train_step

    out = {"phase": 18, "card": card}
    for model, batch in (("rawnet3", 16), ("specrnet", 64)):
        config = {} if model == "rawnet3" else {**bench.SPECRNET_CONFIG, "compute_dtype": None}
        torch.cuda.reset_peak_memory_stats()
        path = bench.setup_train(batch, seed=18, device="cuda", model=model, config=config,
                                 optimizer_kwargs={"lr": 1e-3, "weight_decay": 5e-5},
                                 use_scheduler=model == "rawnet3", batches_per_epoch=2,
                                 scheduler_t0_epochs=2)
        state = path.state
        lrs, losses = [], []
        for _ in range(5):
            losses.append(float(train_step(state, path.x, path.y, path.acc)))
            lrs.append(state.optimizer.param_groups[0]["lr"])
        res = {"batch": batch, "losses": losses}
        check(all(np.isfinite(losses)), f"{model}: non-finite loss {losses}")
        if model == "rawnet3":
            fb = state.model.conv1.filterbank
            grads = {k: getattr(fb, k).grad for k in ("low_hz_", "band_hz_")}
            for k, g in grads.items():
                check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
                      f"sinc {k} gradient {g}")
            want = [train_state.cosine_annealing_warm_restarts(1e-3, 4)(c) for c in range(5)]
            res.update({"lrs": lrs, "schedule": want,
                        "sinc_grad_abs_max": {k: float(g.abs().max()) for k, g in grads.items()}})
            check(lrs == want, f"lr {lrs} is not the warm-restart schedule {want}")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            train_step(state, path.x, path.y, path.acc)
        end.record()
        end.synchronize()
        res.update({"ms_per_step": start.elapsed_time(end) / 3,
                    "peak_mem_bytes": torch.cuda.max_memory_allocated()})
        out[model] = res
        del path, state
        torch.cuda.empty_cache()
    emit(out)
    return out


def phase19_clis(models, set_seed) -> dict:
    """The two training CLIs end to end on the card, in a temporary working
    directory: train_models on synthetic:64, then two adversarial finetunes
    (ADAPTIVE with FGSM + PGDL2, ONLY_ADV with FGSM) from its checkpoint."""
    import sys
    import tempfile

    import yaml

    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo}
    common = ["--asv_path", "synthetic:64", "-b", "16", "-e", "1", "-ta", "32"]
    out = {"phase": 19}

    def cli(name, *args):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"adaa_tpu_torch.scripts.{name}", *args,
                               *common], cwd=tmp, env=env, capture_output=True, text=True,
                              timeout=600)
        check(proc.returncode == 0, f"{name} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        return proc.stdout, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        log, wall = cli("train_models", "--config", os.path.join(repo, "configs/training/lcnn.yaml"))
        for needle in ("train/loss", "test/accuracy", "test/eer"):
            check(needle in log, f"train_models: no {needle} line")
        (chained,) = [f for f in os.listdir(os.path.join(tmp, "configs"))]
        config = yaml.safe_load(open(os.path.join(tmp, "configs", chained)))
        out["train_models"] = {"wall_s": wall, "config": chained}
        for strategy, attacks_ in (("ADAPTIVE", ["FGSM", "PGDL2"]), ("ONLY_ADV", ["FGSM"])):
            config["data"]["adversarial_attacks"] = attacks_
            cfg_path = os.path.join(tmp, f"adv_{strategy}.yaml")
            with open(cfg_path, "w") as f:
                yaml.dump(config, f)
            before = set(os.listdir(os.path.join(tmp, "configs")))
            log, wall = cli("train_models_on_adversarial_attacks", "--config", cfg_path,
                            "--finetune", "--adv_training_strategy", strategy)
            needles = ["train/loss", "test/accuracy", "multi_f1_score",
                       *[f"adv_test/{a}__{m}" for a in attacks_ for m in ("loss", "accuracy")]]
            missing = [n for n in needles if n not in log]
            check(not missing, f"{strategy}: no {missing} lines")
            (written,) = set(os.listdir(os.path.join(tmp, "configs"))) - before
            test_cfg = yaml.safe_load(open(os.path.join(tmp, "configs", written)))
            ckpt = os.path.join(tmp, test_cfg["checkpoint"]["paths"][0])
            test_cfg["checkpoint"] = {"path": ckpt}
            model = models.load_model(test_cfg, set_seed(19, "cuda"), "cuda")
            saved = torch.load(ckpt, map_location="cuda", weights_only=True)
            check(all(torch.equal(model.state_dict()[k], v) for k, v in saved.items()),
                  f"{strategy}: the saved checkpoint does not load through models.load_model")
            out[strategy] = {"wall_s": wall, "attacks": attacks_,
                             "multi_f1_line": [ln[ln.index("multi_f1_score"):]
                                               for ln in log.splitlines()
                                               if "multi_f1_score" in ln]}
    emit(out)
    return out


# phase 20's mini-corpus: enough files that the val subset holds >= 128
# rows after oversampling (two batches of 64); without the mp3 codecs the
# FakeAVCeleb part is left out and WaveFake grows to make up its rows
CORPUS = {"wavefake_spoof": 330, "wavefake_real": 60, "asvspoof_spoof": 32,
          "asvspoof_bonafide": 8, "fakeavceleb_per_attack": 25, "fakeavceleb_real": 30}
CORPUS_NO_MP3_WAVEFAKE_SPOOF = 450
MP3_FRAME = 1152


def write_corpus(root: str) -> dict:
    """The mini-corpus of phase 20 in the published layouts (ASVspoof2021-DF
    FLAC, WaveFake WAV at 22,050 / 24,000 / 48,000 Hz, FakeAVCeleb MP3 at
    44.1 kHz), 1-6 s utterances with 0.1-0.6 s silences, from a seed."""
    from pathlib import Path

    from adaa_tpu_torch.data import mp3

    # by its path: tests/ is not a package, and an installed package named
    # "tests" would shadow it
    spec = importlib.util.spec_from_file_location(
        "torch_port_corpus", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                          "torch_port_corpus.py"))
    corpus = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(corpus)
    root, rng, written = Path(root), np.random.default_rng(20), []
    have_mp3 = mp3.available() and mp3.encoder_available()
    n_wavefake = CORPUS["wavefake_spoof"] if have_mp3 else CORPUS_NO_MP3_WAVEFAKE_SPOOF
    t0 = time.perf_counter()
    paths = {"asvspoof": corpus.asvspoof2021_df(root / "ASVspoof2021_DF", CORPUS["asvspoof_spoof"],
                                                CORPUS["asvspoof_bonafide"], rng, written),
             "wavefake": corpus.wavefake(root / "WaveFake", n_wavefake, CORPUS["wavefake_real"],
                                         rng, written),
             "fakeavceleb": None}
    if have_mp3:
        paths["fakeavceleb"] = corpus.fakeavceleb(
            root / "FakeAVCeleb_v1.2", CORPUS["fakeavceleb_per_attack"],
            CORPUS["fakeavceleb_real"], rng, written)
    files = {fmt: sum(w.fmt == fmt for w in written) for fmt in ("flac", "wav", "mp3")}
    return {"paths": paths, "written": written, "gen_s": time.perf_counter() - t0,
            "files": files,
            "fakeavceleb": ("written" if have_mp3 else
                            "left out: the system libmpg123 / libmp3lame is absent "
                            f"(libmpg123 {mp3.available()}, libmp3lame {mp3.encoder_available()})")}


def decode_checked(written) -> dict:
    """Every FLAC and WAV decodes to the exact PCM written, every MP3 to the
    written length within the codec's delay and frame padding at the written
    rate; the decode ms per file of each format."""
    from adaa_tpu_torch.data import base as dsp

    ms = {}
    for w in written:
        t0 = time.perf_counter()
        audio, sr = dsp.load_audio(w.path)
        ms.setdefault(w.fmt, []).append((time.perf_counter() - t0) * 1e3)
        check(sr == w.sample_rate and audio.shape[0] == 1, f"{w.path}: rate {sr}, {audio.shape}")
        if w.fmt == "mp3":
            check(abs(audio.shape[1] - w.pcm.size) < 4 * MP3_FRAME,
                  f"{w.path}: {audio.shape[1]} samples decoded of {w.pcm.size} written")
        else:
            check(np.array_equal(audio[0], w.pcm.astype(np.float32) / np.float32(32768)),
                  f"{w.path}: the decoded PCM differs from the written")
    return {fmt: float(np.mean(v)) for fmt, v in ms.items()}


class captured_log:
    """The root logger's INFO records as text, for the CLIs' log lines."""

    def __enter__(self):
        import io
        import logging

        self.root, self.text = logging.getLogger(), io.StringIO()
        self.handler, self.level = logging.StreamHandler(self.text), self.root.level
        self.root.addHandler(self.handler)
        self.root.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.root.removeHandler(self.handler)
        self.root.setLevel(self.level)

    def value(self) -> str:
        return self.text.getvalue()


def raw_mode_checked(name, cfg, corpus_args, models, counters, card) -> dict:
    """Raw-mode PGD-10 (``--raw_from_dataset``) at B=64: on the val subset, a
    callback run whose first batch is recomputed bit for bit through the
    trim, then the CLI's raw and plain runs (launches, reports); on the
    larger train subset, ``generate_attacks`` alone in both modes with the
    models and manifests built before the clock starts (examples/s of each
    run, modes in ABBA order, raw mode's extra wall within each adjacent
    pair), the device's idle share in one profiled run of
    each mode, taken against that run's own wall; and the host round trip of
    the re-preprocessing."""
    from adaa_tpu_torch import metrics
    from adaa_tpu_torch.data import base as dsp
    from adaa_tpu_torch.eval import generate_attacks
    from adaa_tpu_torch.scripts import evaluate_models_on_adversarial_attacks as adv_cli
    from adaa_tpu_torch.scripts._common import build_dataset
    from adaa_tpu_torch.utils import profiling

    seed, srs = 20, np.full(RB, 16_000, np.int32)
    victim = models.load_model(cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
    attack_model = models.load_model(cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
    dataset = build_dataset(corpus_args["paths"], "val", return_meta=True, return_raw=True)
    n_batches = len(dataset) // RB
    check(n_batches >= 2, f"val subset of {len(dataset)} rows: fewer than two batches of {RB}")
    seen = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        np.random.seed(seed)
        generate_attacks(victim, dataset, "PGD", attack_model, RB,
                         generator=torch.Generator("cuda").manual_seed(seed),
                         on_attack_end_callback=lambda **kw: seen.append(kw),
                         raw_sample_from_dataset=True)
        kw = seen[0]
        repro, _ = dsp.wavefake_preprocessing_on_batch(kw["batch_x_attacked"], srs)
        with torch.no_grad():
            preds = torch.sigmoid(victim.eval()(torch.from_numpy(repro).cuda()).squeeze(1))
        preds = preds.cpu().numpy()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    changed = int((repro != kw["batch_x_attacked"]).any(axis=1).sum())

    attacked = torch.from_numpy(kw["batch_x_attacked"]).cuda()
    round_trip = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        waves, _ = dsp.wavefake_preprocessing_on_batch(attacked.cpu().numpy(), srs)
        torch.from_numpy(waves).to("cuda")
        torch.cuda.synchronize()
        round_trip.append((time.perf_counter() - t0) * 1e3)

    out = {"val_rows": len(dataset), "batches": n_batches, "card": card,
           "recompute_max_abs_err": float(np.abs(preds - kw["batch_preds"]).max()),
           "reprocessed_waves_changed": changed,
           "reprocess_round_trip_host_ms_per_batch": statistics.median(round_trip)}

    for mode in ("plain", "raw"):  # the CLI end to end: launches, report, metric line
        extra = ["--raw_from_dataset"] if mode == "raw" else []
        args = adv_cli.parse_args([*corpus_args["flags"], "--attack", "PGD", *extra])
        zero(counters)
        np.random.seed(seed)
        report = adv_cli.run(args, cfg, cfg)
        torch.cuda.synchronize()
        out[mode] = {"cli_launches": snapshot(counters), "report": report}
        report_ok(f"{name} {mode}-mode PGD", report)
        print(metrics.format_metrics("adv_eval", report), flush=True)

    timed = {}
    for mode in ("plain", "raw"):  # the same oversampled rows in both modes
        np.random.seed(seed)
        timed[mode] = build_dataset(corpus_args["paths"], "train", return_raw=mode == "raw")
    n_timed = len(timed["raw"]) // RB

    def attack_run(mode: str) -> float:
        """The wall of one ``generate_attacks`` over the train subset."""
        np.random.seed(seed)  # the loader's shuffle: the same batches in each run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_attacks(victim, timed[mode], "PGD", attack_model, RB,
                         generator=torch.Generator("cuda").manual_seed(seed),
                         raw_sample_from_dataset=mode == "raw")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # two adjacent (plain, raw) pairs in ABBA order: the host's speed drifts
    # between runs by more than raw mode's cost, less within a pair
    order = ("plain", "raw", "raw", "plain")
    all_walls = [attack_run(mode) for mode in order]
    walls = {mode: [w for m, w in zip(order, all_walls) if m == mode] for mode in ("plain", "raw")}
    pairs = [dict(zip(order[i:i + 2], all_walls[i:i + 2])) for i in range(0, len(order), 2)]
    raw_cost = [p["raw"] / p["plain"] - 1 for p in pairs]
    for mode, w in walls.items():
        mid = statistics.median(w)
        out[mode].update({"timed_rows": len(timed[mode]), "timed_batches": n_timed,
                          "wall_s": w, "examples_per_sec": [n_timed * RB / x for x in w],
                          "median_examples_per_sec": n_timed * RB / mid,
                          "spread": (max(w) - min(w)) / mid,
                          "ms_per_batch": 1e3 * mid / n_timed})
        # the device's busy time over the wall of the same profiled run: how
        # far the host holds the card back (the profiler's own cost included)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            wall = attack_run(mode)
        busy_ms = profiling.device_busy_ms(prof)
        out[mode].update({"profiled_wall_s": wall, "device_busy_ms": busy_ms,
                          "device_idle_share": 1 - busy_ms / (1e3 * wall)})
    out["round_trip_share_of_raw_batch"] = (out["reprocess_round_trip_host_ms_per_batch"]
                                            / out["raw"]["ms_per_batch"])
    out["raw_over_plain_wall_paired"] = {"each": raw_cost, "median": statistics.median(raw_cost)}
    check(np.array_equal(preds, kw["batch_preds"]),
          f"{name}: the victim's predictions on the re-preprocessed attacked batch differ "
          f"from the callback's by {out['recompute_max_abs_err']}")
    check(changed >= 1, f"{name}: the trim changed no attacked wave of the first batch")
    got = out["raw"]["cli_launches"]
    want = got["layer0"]["bwd"] == 10 * n_batches and got["layer0"]["fwd"] >= 10 * n_batches
    if name == "fused":
        want = (want and got["lfcc"]["fwd"] >= 10 * n_batches
                and got["trunk"]["fwd"] >= 20 * n_batches and got["trunk"]["bwd"] == 20 * n_batches)
    else:
        want = want and not launched(got, ("lfcc", "trunk"))
    check(want and not launched(got, ("pool", "b2n")), f"{name} raw-mode launches {got}")
    return out


def phase20_corpus(bench, models, counters, card) -> dict:
    """The real-corpus path: a mini-corpus on disk in the three published
    layouts, decoded exactly, one epoch of clean training on it
    (``train_models``, -b 64, configs/training/lcnn.yaml), then raw-mode
    PGD-10 white-box evaluations of that checkpoint on the bf16 LCNN in the
    default and the fused configuration."""
    import tempfile

    import yaml

    from adaa_tpu_torch.scripts import train_models

    repo = os.path.dirname(os.path.abspath(__file__))
    out = {"phase": 20, "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        data = write_corpus(os.path.join(tmp, "corpora"))
        out["corpus"] = {"gen_s": data["gen_s"], "files": data["files"],
                         "fakeavceleb": data["fakeavceleb"]}
        out["decode_ms_per_file"] = decode_checked(data["written"])
        paths = [str(p) if p is not None else "none" for p in data["paths"].values()]
        corpus_args = {"paths": paths, "flags": ["--asv_path", paths[0], "--wavefake_path",
                                                 paths[1], "--celeb_path", paths[2]]}
        cwd = os.getcwd()
        os.chdir(tmp)  # train_models writes configs/ in the working directory
        try:
            with open(os.path.join(repo, "configs/training/lcnn.yaml")) as f:
                config = yaml.safe_load(f)
            args = train_models.parse_args([*corpus_args["flags"], "-b", "64", "-e", "1",
                                            "--ckpt", os.path.join(tmp, "trained_models")])
            t0 = time.perf_counter()
            with captured_log() as log:
                ckpt, cfg_path = train_models.run(args, config)
            out["train"] = {"wall_s": time.perf_counter() - t0, "batch": 64}
            with open(cfg_path) as f:
                chained = yaml.safe_load(f)
        finally:
            os.chdir(cwd)
        missing = [n for n in ("train/loss", "test/accuracy", "test/eer") if n not in log.value()]
        check(not missing and os.path.exists(ckpt), f"train_models on the corpus: no {missing}")
        for name, params in (("default", bench.CONFIG), ("fused", bench.FUSED_CONFIG)):
            cfg = {**chained, "model": {**chained["model"], "parameters": params}}
            out[name] = raw_mode_checked(name, cfg, corpus_args, models, counters, card)
            torch.cuda.empty_cache()
    emit(out)
    return out


# phase 21: every extra attack on the bf16 LCNN default configuration at full
# width. Gradient attacks at B=64; the searches and the composite at B=8.
# Depth cuts (the registry's defaults in brackets), listed in the line:
EXTRA_SEARCH_BATCH = 8
EXTRA_SEARCH = ("Square", "OnePixel", "Pixle", "AutoAttack")
EXTRA_CUTS = {"CW": {"steps": 100}, "APGD": {"steps": 20}, "APGDT": {"steps": 20},
              "Square": {"n_queries": 200}, "OnePixel": {"steps": 5},
              "Pixle": {"restarts": 2, "max_iterations": 20}}
EXTRA_REDUCED = {"CW": "steps 100 (1000)", "APGD": "steps 20 (100)", "APGDT": "steps 20 (100)",
                 "Square": "n_queries 200 (5000)", "OnePixel": "steps 5 (75), popsize 400",
                 "Pixle": "restarts 2 x max_iterations 20 (20 x 100)",
                 "AutoAttack": "multiattack of APGD-CE 20, APGD-T 20, FAB 20, Square 200 "
                               "(100, 100, 100, 5000)"}
EXTRA_EPS = 8 / 255  # the stock attacks' default Linf eps (BIM: 4/255)
EXTRA_LINF = {"BIM": 4 / 255, **{name: EXTRA_EPS for name in (
    "RFGSM", "FFGSM", "TPGD", "EOTPGD", "MIFGSM", "NIFGSM", "SINIFGSM", "VMIFGSM", "VNIFGSM",
    "DIFGSM", "UPGD", "Jitter", "TIFGSM", "APGD", "APGDT", "Square", "AutoAttack")}}


def expected_layer0(name: str, batch: int):
    """(forwards, dx) of the layer-0 kernel in one batch of ``name`` at the
    phase's cuts: one forward per detector call, one dx per gradient (CW:
    None, it stops early at a checkpoint)."""
    bim = int(min(4 / 255 * 255 + 4, 1.25 * (4 / 255) * 255))
    n_apgd = EXTRA_CUTS["APGD"]["steps"]
    n_square = EXTRA_CUTS["Square"]["n_queries"]
    fab = (2 * 20 + 3, 20)  # predict, act, 2 x steps (fwd+bwd, predict), final predict
    onepixel_rows = batch * (400 // 3 * 3)
    table = {
        "VANILA": (0, 0), "GN": (0, 0), "BIM": (bim, bim), "RFGSM": (1, 1), "FFGSM": (1, 1),
        "TPGD": (8, 7), "EOTPGD": (20, 20), "MIFGSM": (5, 5), "NIFGSM": (5, 5),
        "SINIFGSM": (25, 25), "VMIFGSM": (105, 105), "VNIFGSM": (105, 105),
        "DIFGSM": (10, 10), "UPGD": (40, 40), "Jitter": (10, 10), "DeepFool": (50, 50),
        "TIFGSM": (10, 10), "SparseFool": (30, 20),
        "APGD": (n_apgd + 2, n_apgd + 1), "APGDT": (n_apgd + 2, n_apgd + 1),
        "Square": (n_square + 2, 0),
        "OnePixel": ((EXTRA_CUTS["OnePixel"]["steps"] + 1) * -(-onepixel_rows // 128), 0),
        "Pixle": (2 + 2 * 20, 0),
        # multiattack: the clean check and one check per member, then the members
        "AutoAttack": (5 + 2 * (n_apgd + 2) + fab[0] + n_square + 2, 2 * (n_apgd + 1) + fab[1]),
    }
    return table.get(name)


def extra_attack(attacks, name, logits_fn):
    """The [0, 1]-space attack of phase 21: the registry's at the cuts;
    AutoAttack as ``multiattack`` over its four members at the cuts."""
    if name != "AutoAttack":
        return attacks.build_attack(name, logits_fn, EXTRA_CUTS.get(name))
    from adaa_tpu_torch.attacks.apgd import apgd, apgdt
    from adaa_tpu_torch.attacks.fab import fab
    from adaa_tpu_torch.attacks.square import square

    return attacks.multiattack(logits_fn, [
        apgd(logits_fn, eps=EXTRA_EPS, steps=EXTRA_CUTS["APGD"]["steps"], loss="ce"),
        apgdt(logits_fn, eps=EXTRA_EPS, steps=EXTRA_CUTS["APGDT"]["steps"]),
        fab(logits_fn, norm="Linf", eps=EXTRA_EPS, steps=20, n_restarts=1, n_classes=2),
        square(logits_fn, eps=EXTRA_EPS, n_queries=EXTRA_CUTS["Square"]["n_queries"])])


def busy_ms_of(fn) -> tuple:
    """(wall s, device busy ms) of one call of ``fn`` under a CUDA-activity
    profile."""
    from adaa_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, profiling.device_busy_ms(prof)


def extra_checked(attacks, name, path, counters) -> dict:
    """One batch of ``name`` through ``attack_in_wave_space``, checked in
    [0, 1] space, with its launches; then a second run's wall and
    examples/s, and the device's idle share in a third, profiled run."""
    model, _, x, y, gen = path
    if name in EXTRA_SEARCH:
        x, y = x[:EXTRA_SEARCH_BATCH], y[:EXTRA_SEARCH_BATCH]
    logits_fn = attacks.make_logits_fn(model)
    atk01 = extra_attack(attacks, name, logits_fn)
    seen = {}

    def recorded(x01, yy, generator):
        seen["x01"], seen["adv01"] = x01, atk01(x01, yy, generator)
        return seen["adv01"]

    attack = attacks.attack_in_wave_space(recorded)
    torch.cuda.synchronize()
    zero(counters)
    adv = attack(x, y, gen)  # counted and checked; it also warms the attack's ops up
    torch.cuda.synchronize()
    got = snapshot(counters)
    x01, adv01 = seen["x01"], seen["adv01"]
    with torch.no_grad():
        correct = attacks.predicted_label(logits_fn(x01)) == y
        fooled = attacks.predicted_label(logits_fn(adv01)) != y
    t0 = time.perf_counter()
    attack(x, y, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof_wall, busy = busy_ms_of(lambda: attack(x, y, gen))
    want = expected_layer0(name, x.shape[0])
    res = {"batch": x.shape[0], "params": EXTRA_CUTS.get(name, {}),
           "success_rate": float((correct & fooled).sum()) / max(int(correct.sum()), 1),
           "correct_at_first": int(correct.sum()), "seconds": wall,
           "examples_per_sec": x.shape[0] / wall, "profiled_wall_s": prof_wall,
           "device_busy_ms": busy, "device_idle_share": 1 - busy / (1e3 * prof_wall),
           "launches": got["layer0"], "expected_layer0": want,
           "linf01": float((adv01 - x01).abs().max())}
    check(tuple(adv.shape) == tuple(x.shape) and bool(torch.isfinite(adv01).all())
          and float(adv01.min()) >= 0.0 and float(adv01.max()) <= 1.0,
          f"{name}: output not finite in the [0, 1] box")
    if name in EXTRA_LINF:
        check(res["linf01"] <= EXTRA_LINF[name] + 1e-6, f"{name}: outside its eps ball {res}")
    elif name == "VANILA":
        check(torch.equal(adv01, x01), "VANILA changed its input")
    elif name == "OnePixel":
        check(int((adv01 != x01).sum(dim=1).max()) <= 1, "OnePixel changed more than a pixel")
    elif name == "Pixle":
        check(all(bool(torch.isin(a, b).all()) for a, b in zip(adv01, x01)),
              "Pixle wrote a value its row did not hold")
    lay = got["layer0"]
    if name == "CW":  # stops right after a checkpoint step, or runs every step
        steps, every = EXTRA_CUTS["CW"]["steps"], EXTRA_CUTS["CW"]["steps"] // 10
        ok = lay["fwd"] == lay["bwd"] and (lay["fwd"] == steps or (lay["fwd"] - 1) % every == 0)
        res["expected_layer0"] = "forwards = dx = the steps run"
    else:
        ok = (lay["fwd"], lay["bwd"]) == want
    check(ok and not launched(got, [k for k in ALL_KERNELS if k != "layer0"]),
          f"{name}: layer-0 launches {got}, expected {res['expected_layer0']}")
    return res


def phase21_fused_apgd(attacks, bench, counters) -> dict:
    """APGD-CE at the cut on the fused configuration at B=64: the LFCC and
    trunk kernels once per forward (trunk: both segments) and per dx."""
    path = bench.setup(RB, seed=0, device="cuda", fused=True)
    attack = attacks.attack_in_wave_space(
        attacks.build_attack("APGD", attacks.make_logits_fn(path.model), EXTRA_CUTS["APGD"]))
    zero(counters)
    t0 = time.perf_counter()
    adv = attack(path.x, path.y, path.generator)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = snapshot(counters)
    fwd, dx = expected_layer0("APGD", RB)
    want = {"layer0": {"fwd": fwd, "bwd": dx}, "lfcc": {"fwd": fwd},
            "trunk": {"fwd": 2 * fwd, "bwd": 2 * dx}}
    res = {"batch": RB, "params": EXTRA_CUTS["APGD"], "seconds": wall,
           "examples_per_sec": RB / wall, "launches": got, "expected": want}
    check(bool(torch.isfinite(adv).all()), "fused APGD: non-finite waves")
    check(all(got[k] == v for k, v in want.items()) and not launched(got, ("pool", "b2n")),
          f"fused APGD launches {got}, expected {want}")
    return res


def phase21_qualitative(attacks, bench, models, set_seed) -> dict:
    """The qualitative pipeline on the card, synthetic n=128 at batch 64:
    ``save_adversarial_dataset`` with APGD (at the cut) over 2 batches; a
    white-box ``generate_attacks(attack_name="APGD")`` with the
    ``AttackAnalyser`` callback; the MCD of the pairs it wrote; the plot
    where matplotlib imports."""
    import tempfile

    from adaa_tpu_torch.attacks.save import save_adversarial_dataset
    from adaa_tpu_torch.data.loader import DataLoader
    from adaa_tpu_torch.data.synthetic import SyntheticDataset
    from adaa_tpu_torch.eval import generate_attacks
    from adaa_tpu_torch.eval.postanalysis import AttackPostAnalyser
    from adaa_tpu_torch.eval.qualitative import AttackAnalyser

    ds = SyntheticDataset(n=128, subset="val", return_meta=True)
    gen = set_seed(21, "cuda")
    lcnn = models.init_model(models.get_model("lcnn", bench.CONFIG), gen, "cuda")
    logits_fn = attacks.make_logits_fn(lcnn)
    out = {"n": len(ds), "batch": RB}
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "adv.npz")
        rob, l2, ms = save_adversarial_dataset(
            attacks.build_attack("APGD", logits_fn, EXTRA_CUTS["APGD"]), logits_fn,
            DataLoader(ds, RB, shuffle=False, num_workers=3), save_path=npz, verbose=False,
            return_verbose=True, save_pred=True, generator=gen)
        saved = np.load(npz)
        shapes = {k: list(saved[k].shape) for k in saved.files}
        out["save"] = {"robust_accuracy": rob, "l2": l2, "elapsed_ms": ms, "npz": shapes}
        check(shapes == {"adv_inputs": [128, 64_600], "labels": [128], "preds": [128]},
              f"save_adversarial_dataset wrote {shapes}")
        check(0.0 <= rob <= 100.0 and np.isfinite(l2) and l2 > 0,
              f"save_adversarial_dataset: robust accuracy {rob}, L2 {l2}")
        check(abs(rob - 100.0 * float((saved["preds"] == saved["labels"]).mean())) < 1e-6,
              "the robust accuracy is not that of the saved predictions")

        pairs = os.path.join(tmp, "qualitative")
        analyser = AttackAnalyser(pairs)
        np.random.seed(21)
        t0 = time.perf_counter()
        report = generate_attacks(lcnn, ds, "APGD", lcnn, RB, generator=gen,
                                  on_attack_end_callback=analyser.analyse)
        out["generate_attacks"] = {"report": report, "wall_s": time.perf_counter() - t0}
        report_ok("phase 21 generate_attacks APGD", report)
        n_pairs = len([f for f in os.listdir(pairs) if f.endswith("__orig.wav")])

        post = AttackPostAnalyser(pairs)
        t0 = time.perf_counter()
        results = post.read_waves_and_calc_metrics()
        out["mcd"] = {"pairs": n_pairs, "rows": len(results), "wall_s": time.perf_counter() - t0,
                      "mcd_mean": float(results["mcd"].mean()) if len(results) else None,
                      "mcd_metrics_csv": os.path.exists(os.path.join(pairs, "mcd_metrics.csv"))}
        check(n_pairs >= 1 and len(results) == n_pairs, f"MCD rows {len(results)} for "
                                                        f"{n_pairs} pairs")
        check(bool(np.isfinite(results["mcd"]).all()) and float(results["mcd"].min()) >= 0.0,
              "non-finite or negative MCD")
        check(out["mcd"]["mcd_metrics_csv"], "no mcd_metrics.csv")
        if importlib.util.find_spec("matplotlib") is not None:
            post.read_waves_and_plot()
            plots = len([f for f in os.listdir(pairs) if f.endswith("_plot.png")])
            out["plots"] = plots
            check(plots == n_pairs, f"{plots} plots for {n_pairs} pairs")
        else:
            out["plots"] = "not run: matplotlib is not installed on this machine"
    return out


def phase21_extra_attacks(attacks, bench, models, counters, set_seed, card) -> dict:
    """Every name in EXTRA_ATTACKS on the bf16 LCNN, the fused APGD-CE and
    the qualitative pipeline."""
    out = {"phase": 21, "card": card, "reduced": EXTRA_REDUCED, "attacks": {}}
    path = bench.setup(RB, seed=0, device="cuda", model="lcnn", config=bench.CONFIG)
    for name in attacks.EXTRA_ATTACKS:
        out["attacks"][name] = extra_checked(attacks, name, path, counters)
    del path
    torch.cuda.empty_cache()
    out["fused_apgd"] = phase21_fused_apgd(attacks, bench, counters)
    torch.cuda.empty_cache()
    out["qualitative"] = phase21_qualitative(attacks, bench, models, set_seed)
    emit(out)
    return out


# max |logits under a switch - default logits| over max |default logits|,
# on the same clean batch, bf16 models: each switch moves the forward's
# rounding points (the eqmask switches change only the backward, so their
# forward is exact). Measured on an H100 (random weights: LCNN logits up
# to 0.0139, RawNet3 b2n up to 0.211): LCNN 0.0082 unfused layer 0, 0.025
# unfolded BNs, 0.030 f32 frontend; RawNet3 0.0059 f32 sinc conv, 0.0052
# f32 encoder. Each band is ~3x its measured gap.
SWITCH_LOGIT_RTOL = {"ADAA_FUSED_LCNN": 0.025, "ADAA_FOLD_BN": 0.075,
                     "ADAA_BF16_FRONTEND": 0.09, "ADAA_MFM_EQMASK": 0.0,
                     "ADAA_POOL_EQMASK": 0.0, "ADAA_SINC_VJP": 0.018,
                     "rawnet3 ADAA_BF16_FRONTEND": 0.016}
# max |logits - the f32 model's| over max |f32 logits|, the same weights in
# f32 on the card with TF32 off (LCNN at precision "highest"): each
# configuration against its own f32 result. Measured on an H100: LCNN
# 0.0553-0.0604 over its six configurations, RawNet3 b2n 0.0030-0.0050,
# SpecRNet 0.0427; each band is ~3x the largest.
SWITCH_F32_RTOL = {"lcnn": 0.18, "rawnet3": 0.015, "specrnet": 0.13}
PHASE22_REDUCED = {"multi_run": "3 of adv_eval_whitebox.yaml's 30 entries (FGSM, PGDL2, FAB), "
                                "synthetic --amount 64: one batch of 64 each"}


def environ(env: dict):
    """``os.environ`` updated with ``env`` inside, restored after."""
    from adaa_tpu_torch.models.layers import switches

    return switches(env)


def switch_checked(attacks, path, counters, env: dict, z_ref, z_f32) -> dict:
    """Under ``env``: the clean logits against the default's ``z_ref`` and
    the f32 model's ``z_f32``, then one warm PGD-10 batch, a counted one
    (launches, ball and box), a timed one and a profiled one (the device's
    idle share)."""
    with environ(env):
        with torch.no_grad():
            z = path.model(path.x)
        path.attack(path.x, path.y, path.generator)
        torch.cuda.synchronize()
        zero(counters)
        adv = path.attack(path.x, path.y, path.generator)
        torch.cuda.synchronize()
        launches = snapshot(counters)
        t0 = time.perf_counter()
        path.attack(path.x, path.y, path.generator)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pwall, busy = busy_ms_of(lambda: path.attack(path.x, path.y, path.generator))
    x01, mn, mx = attacks.to_minmax(path.x)
    adv01 = (adv - mn) / (mx - mn)
    linf = float((adv01 - x01).abs().max())
    out = {"env": env,
           "logit_rel_err": float((z - z_ref).abs().max() / z_ref.abs().max()),
           "logit_rel_err_vs_f32": float((z - z_f32).abs().max() / z_f32.abs().max()),
           "max_abs_logit": float(z_ref.abs().max()), "linf01": linf, "launches": launches,
           "examples_per_s": path.x.shape[0] / wall, "idle_share": 1.0 - busy / (pwall * 1e3)}
    check(bool(torch.isfinite(adv).all()), f"{env}: non-finite adversarial waves")
    check(linf <= EPS + 1e-6, f"{env}: outside the eps ball: {linf}")
    check(float(adv01.min()) >= -1e-6 and float(adv01.max()) <= 1 + 1e-6,
          f"{env}: outside the [0, 1] box")
    return out


def f32_logits(model, x, **attrs):
    """Logits of an f32 copy of ``model`` (``attrs`` set on it) with TF32 off."""
    from adaa_tpu_torch.ops import layer0

    f32 = copy.deepcopy(model)
    for k, v in attrs.items():
        setattr(f32, k, v)
    with torch.no_grad(), layer0.ieee_f32():
        z = f32(x)
    del f32
    return z


def switch_bands(name: str, got: dict, band: float, model: str) -> None:
    check(got["logit_rel_err"] <= band,
          f"{name} logits differ from the default's by {got['logit_rel_err']} (band {band})")
    check(got["logit_rel_err_vs_f32"] <= SWITCH_F32_RTOL[model],
          f"{name} logits differ from the f32 model's by {got['logit_rel_err_vs_f32']}")


def frontend_check(name: str, switched, default, f32) -> dict:
    """Under ``ADAA_BF16_FRONTEND=0`` the features equal the f32 frontend's
    bit for bit; the default's bf16 features do not."""
    out = {"switched_equals_f32": bool(torch.equal(switched, f32)),
           "default_max_abs_diff_vs_f32": float((default.float() - f32.float()).abs().max())}
    check(out["switched_equals_f32"], f"{name}: ADAA_BF16_FRONTEND=0 features are not f32's")
    check(out["default_max_abs_diff_vs_f32"] > 0, f"{name}: the default features are f32's")
    return out


def phase22_switches(attacks, bench, counters) -> dict:
    """Part 1: the bf16 LCNN at B=256 under each numerics switch; part 2:
    RawNet3 (b2n configuration) and SpecRNet at B=64."""
    from adaa_tpu_torch.ops import frontends

    out = {}
    lcnn = bench.setup(B, seed=0, device="cuda")
    with torch.no_grad():
        z_ref = lcnn.model(lcnn.x)
        feats = {"default": lcnn.model._frontend(lcnn.x),
                 "f32": frontends.get_frontend(["lfcc"], compute="f32",
                                               fused=False)(lcnn.x)[:, None]}
        with environ({"ADAA_BF16_FRONTEND": "0"}):
            feats["switched"] = lcnn.model._frontend(lcnn.x)
    out["lcnn_frontend"] = frontend_check("LCNN", feats["switched"], feats["default"],
                                          feats["f32"])
    del feats
    z_f32 = f32_logits(lcnn.model, lcnn.x, compute_dtype=None, precision="highest")
    ref = switch_checked(attacks, lcnn, counters, {}, z_ref, z_f32)
    out["lcnn_default"] = ref
    check_layer0(ref["launches"])
    switch_bands("LCNN default", ref, 0.0, "lcnn")
    for switch in ("ADAA_FUSED_LCNN", "ADAA_BF16_FRONTEND", "ADAA_MFM_EQMASK",
                   "ADAA_POOL_EQMASK"):
        got = switch_checked(attacks, lcnn, counters, {switch: "0"}, z_ref, z_f32)
        out[f"lcnn_{switch}=0"] = got
        want_l0 = ({"fwd": 0, "bwd": 0} if switch == "ADAA_FUSED_LCNN"
                   else ref["launches"]["layer0"])
        check(got["launches"] == {**ref["launches"], "layer0": want_l0},
              f"LCNN {switch}=0 launches {got['launches']}")
        switch_bands(f"LCNN {switch}=0", got, SWITCH_LOGIT_RTOL[switch], "lcnn")
    del lcnn
    fused_trunk = bench.setup(B, seed=0, device="cuda",
                              config={**bench.CONFIG, "fused_trunk": True})
    got = switch_checked(attacks, fused_trunk, counters,
                         {"ADAA_FOLD_BN": "0", "ADAA_FUSED_TRUNK": "1"}, z_ref, z_f32)
    out["lcnn_ADAA_FOLD_BN=0_FUSED_TRUNK=1"] = got
    check(got["launches"] == {**ref["launches"], "trunk": {"fwd": 0, "bwd": 0}},
          f"LCNN ADAA_FOLD_BN=0 launches {got['launches']}")
    switch_bands("LCNN ADAA_FOLD_BN=0", got, SWITCH_LOGIT_RTOL["ADAA_FOLD_BN"], "lcnn")
    del fused_trunk
    torch.cuda.empty_cache()

    rawnet3 = bench.setup(RB, seed=0, device="cuda", model="rawnet3",
                          config=bench.RAWNET3_B2N_CONFIG)
    f32_model = copy.deepcopy(rawnet3.model)
    f32_model.compute_dtype = None
    with torch.no_grad():
        z_ref = rawnet3.model(rawnet3.x)
        encs = {"default": rawnet3.model._encoder(rawnet3.x)}
        with environ({"ADAA_BF16_FRONTEND": "0"}):
            encs["switched"] = rawnet3.model._encoder(rawnet3.x)
        encs["f32"] = f32_model._encoder(rawnet3.x).to(torch.bfloat16)
    del f32_model
    out["rawnet3_encoder"] = frontend_check("RawNet3", encs["switched"], encs["default"],
                                            encs["f32"])
    del encs
    z_f32 = f32_logits(rawnet3.model, rawnet3.x, compute_dtype=None)
    ref = switch_checked(attacks, rawnet3, counters, {}, z_ref, z_f32)
    out["rawnet3_b2n_default"] = ref
    check(ref["launches"]["b2n"]["fwd"] >= 30 and ref["launches"]["b2n"]["bwd"] == 30,
          f"RawNet3 b2n launches {ref['launches']}")
    switch_bands("RawNet3 default", ref, 0.0, "rawnet3")
    for switch in ("ADAA_SINC_VJP", "ADAA_BF16_FRONTEND"):
        got = switch_checked(attacks, rawnet3, counters, {switch: "0"}, z_ref, z_f32)
        out[f"rawnet3_b2n_{switch}=0"] = got
        check(got["launches"] == ref["launches"], f"RawNet3 {switch}=0 launches {got['launches']}")
        band = SWITCH_LOGIT_RTOL.get(f"rawnet3 {switch}", SWITCH_LOGIT_RTOL[switch])
        switch_bands(f"RawNet3 {switch}=0", got, band, "rawnet3")
    del rawnet3
    torch.cuda.empty_cache()

    spec = bench.setup(RB, seed=0, device="cuda", model="specrnet", config=bench.SPECRNET_CONFIG)
    with torch.no_grad():
        z_ref = spec.model(spec.x)
    z_f32 = f32_logits(spec.model, spec.x, compute_dtype=None)
    got = switch_checked(attacks, spec, counters, {"ADAA_POOL_EQMASK": "0"}, z_ref, z_f32)
    out["specrnet_ADAA_POOL_EQMASK=0"] = got
    check(not launched(got["launches"], ALL_KERNELS), f"SpecRNet launches {got['launches']}")
    switch_bands("SpecRNet ADAA_POOL_EQMASK=0", got, 0.0, "specrnet")
    del spec
    torch.cuda.empty_cache()
    return out


def phase22_mel_spec(frontends) -> dict:
    """Part 3: mel_spec at (64, 64600) on the card against the CPU: the
    magnitude within 1e-5 relative (atol 1e-5 x its maximum); the phase
    where the magnitude exceeds 1e-3 of its row's maximum, its error times
    the magnitude (the error's arc in the complex plane) within the same
    1e-5 x the maximum magnitude (cuBLAS and the CPU sum the projections
    in other orders: a flat 1e-4 rad measured 7.2e-4 near the threshold)."""
    x = torch.from_numpy(np.random.default_rng(22).standard_normal((RB, 64_600))
                         .astype(np.float32))
    card = frontends.mel_spec(x.cuda()).cpu().numpy()
    cpu = frontends.mel_spec(x).numpy()
    mag, peak = cpu[:, 0], np.abs(cpu[:, 0]).max()
    mag_err = float(np.abs(card[:, 0] - mag).max() / peak)
    live = mag > 1e-3 * mag.max(axis=-1, keepdims=True)
    dphase = np.abs(np.angle(np.exp(1j * (card[:, 1] - cpu[:, 1]))))
    arc_err = float((dphase * mag)[live].max() / peak)
    out = {"shape": list(card.shape), "magnitude_max_rel_err": mag_err,
           "phase_max_abs_err": float(dphase[live].max()), "phase_arc_max_rel_err": arc_err,
           "phase_checked_share": float(live.mean())}
    check(card.shape == (RB, 2, 80, 404) and np.isfinite(card).all(), "mel_spec shape or values")
    check(np.allclose(card[:, 0], mag, rtol=1e-5, atol=1e-5 * peak),
          f"mel_spec magnitude differs by {mag_err}")
    check(arc_err <= 1e-5, f"mel_spec phase differs by {arc_err} of the peak magnitude")
    return out


EXTRA_DETECTORS = {  # name -> (config, input): published widths
    "rawnet2": ({}, "waves"),
    "meso4": ({"input_channels": 4, "fc1_dim": 16 * 2 * 12}, "maps"),
    "meso_inception4": ({"input_channels": 4, "fc1_dim": 16 * 2 * 12}, "maps"),
    "xception": ({"input_channels": 4}, "maps"),
}


def phase22_extra_models(attacks, models, set_seed) -> dict:
    """Part 4: each unwired detector at B=64: finite logits, one PGD-10
    batch in its eps ball (waves through the wave-space min-max, feature
    maps in [0, 1]), and the examples/s of a second batch."""
    from adaa_tpu_torch.models.extra import get_extra_model

    out = {}
    rng = np.random.default_rng(23)
    y = torch.from_numpy((np.arange(RB) % 2).astype(np.int64)).cuda()
    for name, (cfg, kind) in EXTRA_DETECTORS.items():
        gen = set_seed(0, "cuda")
        model = models.init_model(get_extra_model(name, cfg), gen, "cuda").eval()
        model.requires_grad_(False)
        attack = attacks.build_attack("PGD", attacks.make_logits_fn(model))
        if kind == "waves":
            x = torch.from_numpy(rng.standard_normal((RB, 64_600)).astype(np.float32)).cuda()
            attack = attacks.attack_in_wave_space(attack)
        else:
            x = torch.from_numpy(rng.uniform(0, 1, (RB, 4, 80, 404)).astype(np.float32)).cuda()
        with torch.no_grad():
            z = model(x)
        adv = attack(x, y, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        attack(x, y, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if kind == "waves":
            x01, mn, mx = attacks.to_minmax(x)
            delta = (adv - mn) / (mx - mn) - x01
        else:
            delta = adv - x
        linf = float(delta.abs().max())
        out[name] = {"input": list(x.shape), "max_abs_logit": float(z.abs().max()),
                     "linf01": linf, "examples_per_s": RB / wall}
        check(tuple(z.shape) == (RB, 1) and bool(torch.isfinite(z).all()), f"{name} logits")
        check(bool(torch.isfinite(adv).all()) and linf <= EPS + 1e-6,
              f"{name}: PGD outside the eps ball: {linf}")
        del model, x, adv
        torch.cuda.empty_cache()
    return out


def phase22_flops(bench, eps_per_s: float) -> dict:
    """Part 5: count_flops of one LCNN PGD-10 batch at B=256 on the plain
    versions, per example, beside phase 4's examples/s."""
    from adaa_tpu_torch.utils.flops import count_flops

    path = bench.setup(B, seed=0, device="cuda")
    path.model.plain_ops = True
    rep = count_flops(path.attack, path.x, path.y, path.generator)
    per_example = rep["flops"] / B
    check("has_kernel" not in rep, f"a kernel launched during the count: {rep}")
    return {"flops_per_example": per_example, "phase4_examples_per_s": eps_per_s,
            "tensor_core_share_vs_989_tflops": per_example * eps_per_s / PEAK_FLOPS["bf16"]}


def phase22_msgpack(bench, models) -> dict:
    """Part 6: the weights after three adversarial-training steps written as
    a .msgpack, read back into a fresh model: logits bit-equal."""
    import tempfile

    from adaa_tpu_torch.utils.checkpoints import load_checkpoint, save_checkpoint_msgpack

    path = bench.setup_train(RB, seed=0, device="cuda")
    for _ in range(3):
        bench.adv_train_step(path)
    model = path.state.model.eval()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint_msgpack(model, tmp, "aad__lcnn__smoke", epoch=0)
        size = ckpt.stat().st_size
        fresh = models.get_model("lcnn", bench.TRAIN_CONFIGS["bf16"]).cuda().eval()
        fresh.load_state_dict(load_checkpoint(ckpt, "lcnn"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            z, z_back = model(path.x), fresh(path.x)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check(torch.equal(z, z_back), f"msgpack round trip logits differ by "
                                  f"{float((z - z_back).abs().max())}")
    return {"bytes": size, "logits_equal": True}


def phase22_multi_run() -> dict:
    """Part 7: the port's adversarial-evaluation batch script on three
    white-box entries (FGSM, PGDL2, FAB on the LCNN config) on the card."""
    import tempfile

    import yaml

    from adaa_tpu_torch.scripts.multi_runs import (
        run_multiple_evaluations_on_adversarial_attacks as batch_runs)

    cfg = os.path.abspath("configs/aa_evaluation/lcnn.yaml")
    entries = [{"attack": a, "config": cfg, "attack_model_config": cfg}
               for a in ("FGSM", "PGDL2", "FAB")]
    here = os.getcwd()
    root = logging.getLogger()
    handlers = list(root.handlers)  # each CLI run adds its own
    with tempfile.TemporaryDirectory() as tmp:
        batch = os.path.join(tmp, "batch.yaml")
        with open(batch, "w") as f:
            yaml.dump(entries, f)
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            reports = batch_runs.main(batch_runs.parse_args(["--config", batch, "--asv_path",
                                                     "synthetic:64", "--amount", "64"]))
            wall = time.perf_counter() - t0
        finally:
            os.chdir(here)
            root.handlers[:] = handlers
    check(len(reports) == len(entries), f"{len(reports)} reports for {len(entries)} entries")
    for entry, report in zip(entries, reports):
        report_ok(f"multi-run {entry['attack']}", report)
    return {"reports": dict(zip([e["attack"] for e in entries], reports)), "wall_s": wall}


def phase22_rest(attacks, bench, models, counters, set_seed, card, eps_per_s) -> None:
    """Phase 22: the numerics switches, mel_spec, the unwired detectors,
    FLOP counting, .msgpack writing, a batch script and the data-parallel
    dry run on one card, one JSON line per part."""
    from adaa_tpu_torch.ops import frontends
    from adaa_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    emit({"phase": 22, "part": "switches", **phase22_switches(attacks, bench, counters),
          "card": card})
    emit({"phase": 22, "part": "mel_spec", **phase22_mel_spec(frontends)})
    emit({"phase": 22, "part": "extra_models", "batch": RB,
          **phase22_extra_models(attacks, models, set_seed), "card": card})
    emit({"phase": 22, "part": "flops", **phase22_flops(bench, eps_per_s), "card": card})
    emit({"phase": 22, "part": "msgpack", **phase22_msgpack(bench, models)})
    emit({"phase": 22, "part": "multi_run", **phase22_multi_run(),
          "reduced": PHASE22_REDUCED["multi_run"]})
    dry = dryrun_multichip(1)
    check(dry["backend"] == "nccl" and dry["device"] == torch.cuda.get_device_name(0),
          f"dryrun_multichip(1) ran on {dry}")
    emit({"phase": 22, "part": "dryrun_multichip", "world_size": 1, **dry,
          "phase_s": time.perf_counter() - t0})


# PGD-10's exact launches a batch on each surrogate of bench_effectiveness
# (kernel.direction -> count; a surrogate not named launches none)
EFF_LAUNCHES = {
    "bf16_trunk_f32_frontend": {"layer0.fwd": 10, "layer0.bwd": 10},
    "bf16_trunk_bf16_frontend": {"layer0.fwd": 10, "layer0.bwd": 10},
    "bf16_fused": {"layer0.fwd": 10, "layer0.bwd": 10, "lfcc_fused.fwd": 10,
                   "trunk.fwd": 20, "trunk.bwd": 20},
    "specrnet:bf16_fused": {"lfcc_fused.fwd": 10},
    "rawnet3:bf16_fused_b2n": {"b2n.fwd": 30, "b2n.bwd": 30},
    "rawnet3:bf16_pool": {"pool.fwd": 10, "pool.bwd": 10},
}
# each bf16 row's mean |logit shift| on the f32 victim over its family's f32
# row must lie within 1 +- its band: ~3x the gap measured on an H100 (NVIDIA
# H100 80GB HBM3, 700.00 W), at least 0.03. Measured: LCNN 1.0052 (f32
# frontend), 1.0144 (bf16 frontend), 1.0047 (fused); SpecRNet 0.9878, 0.9878,
# 1.0013 (fused); RawNet3 1.0005 (f32 encoder), 0.7938 (bf16 encoder), 0.7836
# (b2n), 0.7888 (pool): the bf16 encoder tail rounds the sinc outputs, whose
# change under a 5e-4 step is below a bf16 ulp. The JAX record has 0.91-1.01
# against an f32 surrogate at the TPU's default precision.
EFF_BAND = {"bf16_trunk_f32_frontend": 0.03, "bf16_trunk_bf16_frontend": 0.045,
            "bf16_fused": 0.03, "specrnet:bf16_trunk_f32_frontend": 0.04,
            "specrnet:bf16_trunk_bf16_frontend": 0.04, "specrnet:bf16_fused": 0.03,
            "rawnet3:bf16_trunk_f32_encoder": 0.03, "rawnet3:bf16_trunk_bf16_encoder": 0.65,
            "rawnet3:bf16_fused_b2n": 0.65, "rawnet3:bf16_pool": 0.65}
# layer 0's launches for one attack on the bf16 LCNN (forward, dx), as
# attack_checked / phase 15 count them: FAB 100 steps, >= 200 forwards
EXAMPLE_LAYER0 = {"FGSM_eps001": (1, 1), "PGD_eps001": (10, 10), "PGDL2_eps20": (10, 10),
                  "FAB": (200, 100)}
PHASE23_REDUCED = {
    "bench_effectiveness": "--iters 1 (3): one timed batch a surrogate after the first",
    "bench_attacks": "FGSM, PGD, PGDL2, CW, FAB of the ten default attacks; --iters 1 (3)",
    "bench_train": "--iters 3 (10)",
}


def phase23_effectiveness() -> dict:
    """Part (a): bench_effectiveness over the three families at full width."""
    from adaa_tpu_torch.scripts import bench_effectiveness as be

    rows = {}
    for family in be.FAMILIES:
        prefix = "" if family == "lcnn" else f"{family}:"
        got = be.run_family(family, iters=1, device="cuda")
        f32 = got["f32_surrogate"]["mean_abs_logit_shift"]
        for name, row in got.items():
            key = prefix + name
            row["ratio_to_f32"] = row["mean_abs_logit_shift"] / f32
            rows[key] = row
            check(np.isfinite(row["mean_abs_logit_shift"]) and row["mean_abs_logit_shift"] > 0,
                  f"{key}: mean logit shift {row['mean_abs_logit_shift']}")
            check(0 <= row["flip_rate"] <= 1, f"{key}: flip rate {row['flip_rate']}")
            check(np.isfinite(row["examples_per_sec"]) and row["examples_per_sec"] > 0,
                  f"{key}: examples/s {row['examples_per_sec']}")
            check(row["launches"] == EFF_LAUNCHES.get(key, {}),
                  f"{key}: launches {row['launches']}, want {EFF_LAUNCHES.get(key, {})}")
            band = EFF_BAND.get(key, 0.0)  # the f32 rows: 1 by definition
            check(abs(row["ratio_to_f32"] - 1) <= band,
                  f"{key}: shift {row['ratio_to_f32']} x the f32 surrogate's (band {band})")
        torch.cuda.empty_cache()
    return rows


def phase23_attacks(tmp: str) -> dict:
    """Part (b): bench_attacks on the bf16 LCNN at B=64."""
    from adaa_tpu_torch.scripts import bench_attacks as ba

    rows = ba.main(["--attacks", "FGSM", "PGD", "PGDL2", "CW", "FAB", "--batch", "64",
                    "--iters", "1", "--out", os.path.join(tmp, "bench_attacks.json")])
    for key, row in rows.items():
        check(np.isfinite(row["examples_per_sec"]) and row["examples_per_sec"] > 0,
              f"{key}: examples/s {row['examples_per_sec']}")
        check(0 < row["mfu_pct"] <= 100, f"{key}: mfu_pct {row['mfu_pct']}")
    ratio = rows["PGD"]["flops_per_example"] / rows["FGSM"]["flops_per_example"]
    check(9.5 <= ratio <= 10.5, f"PGD-10 counts {ratio} x FGSM's FLOPs")
    return {"rows": rows, "pgd_over_fgsm_flops": ratio}


def phase23_train(tmp: str) -> dict:
    """Part (c): bench_train, bf16 and f32, at B=256."""
    from adaa_tpu_torch.scripts import bench_train as bt

    rows = bt.main(["--iters", "3", "--out", os.path.join(tmp, "bench_train.json")])
    for key, row in rows.items():
        check(np.isfinite(row["loss"]) and row["examples_per_sec"] > 0, f"{key}: {row}")
    return rows


@contextlib.contextmanager
def attack_launches(calls: list):
    """Each ``examples._common.attacked`` call inside appends (attack, its
    launches) to ``calls``."""
    from adaa_tpu_torch.examples import _common
    from adaa_tpu_torch.ops import launch_counts, launches_since

    attacked = _common.attacked

    def counted(name, *args):
        before = launch_counts()
        adv = attacked(name, *args)
        torch.cuda.synchronize()
        calls.append((name, launches_since(before)))
        return adv

    _common.attacked = counted
    try:
        yield
    finally:
        _common.attacked = attacked


def timed(fn):
    """``fn()`` and its wall seconds."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def accuracies_ok(what: str, tree) -> None:
    """Every accuracy of an example's ``run()`` (the seconds left out) finite
    and in [0, 1]."""
    for k, v in tree.items():
        if k in ("train", "advtrain"):
            continue
        if isinstance(v, dict):
            accuracies_ok(f"{what}.{k}", v)
        else:
            check(np.isfinite(v) and 0 <= v <= 1, f"{what}.{k}: accuracy {v}")


def layer0_calls_ok(what: str, calls) -> None:
    for name, got in calls:
        fwd, bwd = EXAMPLE_LAYER0[name]
        check(got.get("layer0.bwd") == bwd and got.get("layer0.fwd", 0) >= fwd
              and set(got) == {"layer0.fwd", "layer0.bwd"},
              f"{what} {name}: launches {got}, want layer 0 >= {fwd} + {bwd}")


def phase23_examples(tmp: str) -> dict:
    """Part (d): the two trained-detector examples on the bf16 detectors
    (``ADAA_BF16=1``, as the JAX package's switch) at 64,600 samples, and
    the other two examples at their defaults."""
    from adaa_tpu_torch.examples import (attack_demo, performance_comparison,
                                         robustness_pipeline, transfer_attack)

    out = {}
    with environ({"ADAA_BF16": "1"}):
        calls = {}
        for name, example in (("robustness_pipeline", robustness_pipeline),
                              ("transfer_attack", transfer_attack)):
            calls[name] = []
            with attack_launches(calls[name]):
                out[name], wall = timed(lambda: example.run(wave_len=64_600))
            accuracies_ok(name, out[name])
            out[name].update(wall_s=wall, launches=calls[name])
    check([c[0] for c in calls["robustness_pipeline"]]
          == [*robustness_pipeline.ATTACKS, *robustness_pipeline.AFTER],
          f"robustness_pipeline attacks {calls['robustness_pipeline']}")
    layer0_calls_ok("robustness_pipeline", calls["robustness_pipeline"])
    n = len(transfer_attack.ATTACKS)  # crafted on SpecRNet: no kernel
    check([c[1] for c in calls["transfer_attack"][:n]] == [{}] * n,
          f"SpecRNet-source attacks launched {calls['transfer_attack']}")
    layer0_calls_ok("transfer_attack floor", calls["transfer_attack"][n:])
    out["attack_demo"], wall = timed(
        lambda: attack_demo.run(save_path=os.path.join(tmp, "adv_demo.npz")))
    out["attack_demo"]["wall_s"] = wall
    out["performance_comparison"], wall = timed(performance_comparison.run)
    out["performance_comparison"]["wall_s"] = wall
    for name, row in out["attack_demo"]["attacks"].items():
        check(0 <= row["robust_accuracy"] <= 1 and np.isfinite(row["max_abs_delta"]),
              f"attack_demo {name}: {row}")
    for name, row in out["performance_comparison"]["attacks"].items():
        check(0 <= row["success"] <= 1 and all(np.isfinite(row[k]) for k in ("l0", "l2", "linf")),
              f"performance_comparison {name}: {row}")
    return out


def phase23_entry_points(card) -> None:
    """Phase 23: the port's benchmark tools and examples on the card, one
    JSON line per part."""
    import tempfile

    t0 = time.perf_counter()
    emit({"phase": 23, "part": "bench_effectiveness", "rows": phase23_effectiveness(),
          "band": EFF_BAND, "card": card, "reduced": PHASE23_REDUCED["bench_effectiveness"]})
    with tempfile.TemporaryDirectory() as tmp:
        emit({"phase": 23, "part": "bench_attacks", **phase23_attacks(tmp), "card": card,
              "reduced": PHASE23_REDUCED["bench_attacks"]})
        torch.cuda.empty_cache()
        emit({"phase": 23, "part": "bench_train", "rows": phase23_train(tmp), "card": card,
              "reduced": PHASE23_REDUCED["bench_train"]})
        torch.cuda.empty_cache()
        emit({"phase": 23, "part": "examples", **phase23_examples(tmp), "card": card,
              "phase_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()


def phase9_highest_gradient(attacks, models, set_seed) -> None:
    """The f32-highest input gradient with torch's default TF32 flags vs the
    same gradient with TF32 off globally; cuDNN deterministic in both, so
    only TF32 could tell them apart."""
    cfg = {"input_channels": 1, "frontend_algorithm": ["lfcc"], "precision": "highest"}
    model = models.init_model(models.get_model("lcnn", cfg), set_seed(9, "cuda"), "cuda")
    logits_fn = attacks.make_logits_fn(model)
    rng = np.random.default_rng(9)
    x01, _, _ = attacks.to_minmax(randn(rng, (4, 64_600)))
    y = torch.tensor([0, 1, 0, 1], device="cuda")

    def grad():
        xx = x01.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(attacks.two_class_ce(logits_fn(xx), y), xx)
        return g

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        g_default = grad()
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        g_ieee = grad()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        torch.backends.cudnn.deterministic = deterministic
    rel = float((g_default - g_ieee).norm() / g_ieee.norm())
    emit({"phase": 9, "batch": 4, "default_tf32_flags": list(flags),
          "grad_rel_l2_vs_tf32_off": rel, "tol": HIGHEST_GRAD_RTOL})
    check(bool(torch.isfinite(g_default).all()), "non-finite highest-precision gradient")
    check(rel <= HIGHEST_GRAD_RTOL, f"highest-precision gradient differs by {rel}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    from adaa_tpu_torch import attacks, bench, models
    from adaa_tpu_torch.data import mp3, native
    from adaa_tpu_torch.models import rawnet3
    from adaa_tpu_torch.ops import _build, b2n, layer0, lfcc_fused, pool, trunk
    from adaa_tpu_torch.utils import set_seed
    from adaa_tpu_torch.utils.profiling import card_line

    card = card_line()
    print(card, flush=True)
    gxx = subprocess.run([_build.cxx_path(), "--version"], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    emit({"phase": 0, "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "installed": {m: importlib.util.find_spec(m) is not None
                        for m in ("yaml", "sklearn", "pandas", "scipy", "matplotlib")},
          "host": {"g++": gxx[0] if gxx else None, "libmpg123": mp3.available(),
                   "libmp3lame": mp3.encoder_available()}})

    sources = ("layer0", "lfcc", "trunk", "pool", "b2n")
    t0 = time.perf_counter()
    each_s = _build.build_all((*sources, "dsp"))
    for op in (layer0, lfcc_fused, trunk, pool, b2n):
        op._library()
    native.library()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln] for name in sources}
    emit({"phase": 1, "build_s": build_s, "dsp_build_s": each_s["dsp"], "build_s_each": each_s,
          "ptxas": ptxas,
          "sass_counts": {name: sass_counts(_build.BUILD_DIR / f"lib{name}.so")
                          for name in ("layer0", "trunk", "b2n")}})

    l0_fwd_err, l0_bwd_err, l0_times, l0_bounds, l0_library = phase2_layer0(layer0)

    main_path = bench.setup(B, seed=0, device="cuda")
    logits_vs_plain(3, main_path.model, main_path.x)
    counters = {"layer0": layer0.LAUNCHES, "lfcc": lfcc_fused.LAUNCHES, "trunk": trunk.LAUNCHES}
    default_launches = attack_checked(4, attacks, main_path, counters)
    check_layer0(default_launches)
    check(default_launches["lfcc"]["fwd"] == 0 and default_launches["trunk"]["fwd"] == 0,
          f"the default path launched fused kernels: {default_launches}")
    eps_per_s = bench.measure_torch(batch=B, iters=5, warmup=2)
    emit({"phase": 4, "metric": "adv_examples_per_sec_pgd10_lcnn_lfcc",
          "value": eps_per_s, "batch": B, "card": card})
    del main_path

    lfcc_err, lfcc_ms, lfcc_plain_ms, lfcc_bound = phase5_lfcc(lfcc_fused)
    trunk_tot, trunk_bounds = phase6_trunk(trunk)

    fused_path = bench.setup(B, seed=0, device="cuda", fused=True)
    logits_vs_plain(7, fused_path.model, fused_path.x)
    fused_launches = attack_checked(8, attacks, fused_path, counters)
    check_layer0(fused_launches)
    check(fused_launches["lfcc"]["fwd"] >= 10, f"lfcc launches {fused_launches}")
    check(fused_launches["trunk"]["fwd"] >= 20 and fused_launches["trunk"]["bwd"] == 20,
          f"trunk launches {fused_launches}")
    del fused_path
    eps_fused = bench.measure_torch(batch=B, iters=5, warmup=2, fused=True)
    eps_default = bench.measure_torch(batch=B, iters=5, warmup=2)
    emit({"phase": 8, "metric": "adv_examples_per_sec_pgd10_lcnn_lfcc",
          "fused": eps_fused, "default": eps_default, "batch": B, "card": card})

    phase9_highest_gradient(attacks, models, set_seed)
    torch.cuda.empty_cache()

    pool_main = phase10_pool(pool)
    b2n_tot, b2n_bounds = phase11_b2n(b2n, rawnet3)
    r3_launches = rawnet3_phases(attacks, bench, pool, b2n, card)
    all_counters = {**counters, "pool": pool.LAUNCHES, "b2n": b2n.LAUNCHES}
    phase14_specrnet(attacks, bench, all_counters, card)
    phase15_fab(attacks, bench, all_counters, card)
    phase16_eval(attacks, bench, models, all_counters, set_seed)
    torch.cuda.empty_cache()
    phase17_train(attacks, bench, layer0, all_counters, card)
    phase18_train_models(bench, card)
    phase19_clis(models, set_seed)
    phase20_corpus(bench, models, all_counters, card)
    torch.cuda.empty_cache()
    phase21_extra_attacks(attacks, bench, models, all_counters, set_seed, card)
    torch.cuda.empty_cache()
    phase22_rest(attacks, bench, models, all_counters, set_seed, card, eps_per_s)
    torch.cuda.empty_cache()
    phase23_entry_points(card)

    def entry(name, source, replaces, launches, err, ms, plain_ms, b, library_ms=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": library_ms}

    l0_src, trunk_src = "adaa_tpu_torch/csrc/layer0.cu", "adaa_tpu_torch/csrc/trunk.cu"
    pool_src, b2n_src = "adaa_tpu_torch/csrc/pool.cu", "adaa_tpu_torch/csrc/b2n.cu"
    emit({"kernels": [
        entry("layer0_fwd", l0_src, "adaa_tpu/ops/pallas_layer0.py:160",
              default_launches["layer0"]["fwd"], l0_fwd_err, l0_times["fwd_ms"],
              l0_times["fwd_plain_ms"], l0_bounds["fwd"], l0_library["fwd"]),
        entry("layer0_bwd", l0_src, "adaa_tpu/ops/pallas_layer0.py:180",
              default_launches["layer0"]["bwd"], l0_bwd_err, l0_times["bwd_ms"],
              l0_times["bwd_plain_ms"], l0_bounds["bwd"], l0_library["bwd"]),
        entry("lfcc_fwd", "adaa_tpu_torch/csrc/lfcc.cu", "adaa_tpu/ops/pallas_lfcc.py:79",
              fused_launches["lfcc"]["fwd"], lfcc_err, lfcc_ms, lfcc_plain_ms, lfcc_bound),
        # trunk times and bounds: segments A + B, one forward of the model
        entry("trunk_fwd", trunk_src, "adaa_tpu/ops/pallas_trunk.py:148",
              fused_launches["trunk"]["fwd"], trunk_tot["fwd_err"], trunk_tot["fwd_ms"],
              trunk_tot["fwd_plain_ms"], trunk_bounds["fwd"]),
        entry("trunk_bwd", trunk_src, "adaa_tpu/ops/pallas_trunk.py:172",
              fused_launches["trunk"]["bwd"], trunk_tot["bwd_err"], trunk_tot["bwd_ms"],
              trunk_tot["bwd_plain_ms"], trunk_bounds["bwd"]),
        # pool: layer 1's (64, 6435, 1024) w=5 pool, the one on the path
        entry("pool_fwd", pool_src, "adaa_tpu/ops/pallas_pool.py:66",
              r3_launches["pool"]["pool"]["fwd"], pool_main["fwd_max_abs_err"],
              pool_main["fwd_ms"], pool_main["fwd_plain_ms"], pool_main["fwd_bound"],
              pool_main["fwd_library_ms"]),
        entry("pool_bwd", pool_src, "adaa_tpu/ops/pallas_pool.py:73",
              r3_launches["pool"]["pool"]["bwd"], pool_main["bwd_max_abs_err"],
              pool_main["bwd_ms"], pool_main["bwd_plain_ms"], pool_main["bwd_bound"]),
        # b2n times and bounds: layers 1 + 2 + 3, one forward of the model
        entry("b2n_fwd", b2n_src, "adaa_tpu/ops/pallas_b2n.py:179",
              r3_launches["b2n"]["b2n"]["fwd"], b2n_tot["fwd_err"], b2n_tot["fwd_ms"],
              b2n_tot["fwd_plain_ms"], b2n_bounds["fwd"]),
        entry("b2n_bwd", b2n_src, "adaa_tpu/ops/pallas_b2n.py:211",
              r3_launches["b2n"]["b2n"]["bwd"], b2n_tot["bwd_err"], b2n_tot["bwd_ms"],
              b2n_tot["bwd_plain_ms"], b2n_bounds["bwd"]),
    ]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
