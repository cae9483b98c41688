#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (adaa_tpu_torch) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it never imports jax or adaa_tpu.
Each phase prints one JSON line, and any failed check raises, so the
exit code is not 0:

0. the card: ``nvidia-smi`` name and power limit;
1. build the five kernels from ``adaa_tpu_torch/csrc`` (one nvcc per
   source, all at once; timed), with each kernel's ptxas registers and
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

The last lines are the kernels' JSON summary (all nine kernel entries),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
    from adaa_tpu_torch.models import rawnet3
    from adaa_tpu_torch.ops import _build, b2n, layer0, lfcc_fused, pool, trunk
    from adaa_tpu_torch.utils import set_seed
    from adaa_tpu_torch.utils.profiling import card_line

    card = card_line()
    print(card, flush=True)
    emit({"phase": 0, "card": card, "torch": torch.__version__, "cuda": torch.version.cuda})

    sources = ("layer0", "lfcc", "trunk", "pool", "b2n")
    t0 = time.perf_counter()
    _build.build_all(sources)
    for op in (layer0, lfcc_fused, trunk, pool, b2n):
        op._library()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln] for name in sources}
    emit({"phase": 1, "build_s": build_s, "ptxas": ptxas,
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
