#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (adaa_tpu_torch) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it never imports jax or adaa_tpu.
Each phase prints one JSON line, and any failed check raises, so the
exit code is not 0:

0. the card: ``nvidia-smi`` name and power limit;
1. build the kernels from ``adaa_tpu_torch/csrc`` (one nvcc per source,
   all at once; timed);
2. the layer-0 kernel against its plain-torch twin at B=256 (bf16):
   forward outputs bit-equal at >= 99.9% and all within 1 bf16 ulp,
   winner index equal at >= 99.9%, dx relative L2 error < 1e-3; the
   median time of each (CUDA events) beside the twin's;
3. the bf16 LCNN at B=256 x 64,600 with the kernel and with the twin:
   finite logits that agree within LOGIT_ATOL;
4. PGD-10 through ``build_attack("PGD")`` + ``attack_in_wave_space`` at
   B=256 x 64,600: within the eps ball, finite, CE not lower than on the
   clean input, and 10 forward and 10 backward layer-0 kernel launches;
   then ``adaa_tpu_torch.bench.measure_torch`` (examples/s);
5. the fused LFCC kernel against its plain version at B=256, linear
   (LFCC) and mel (MFCC) filterbanks: within atol 5e-4 + rtol 1e-4 (the
   JAX package's band for its own kernel), medians of both;
6. the fused trunk kernels against their plain version at B=256,
   segments A and B: forward >= 99.9% bit-equal after the cast to bf16
   and max abs error <= 1e-4 x max |ref| in f32, dx relative L2 < 3e-3
   (TRUNK_DX_RTOL), medians of both;
7. the fused configuration of the LCNN (fused LFCC + fused trunk) at
   B=256, kernels against plain versions: logits within LOGIT_ATOL;
8. PGD-10 on the fused configuration, checked as in phase 4, with >= 10
   LFCC, >= 20 trunk-forward and 20 trunk-backward launches (and the
   layer-0 counts of phase 4); examples/s of the fused and the default
   configuration, timed in this call;
9. the f32 ``precision="highest"`` LCNN's input gradient at B=4 against
   the same gradient with TF32 off globally, cuDNN deterministic in both:
   relative L2 <= 1e-6.

The last lines are the kernels' JSON summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch

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
    emit({"phase": 2, "batch": B, "fwd_bit_equal": bit_equal,
          "fwd_max_ulp": int(ulp.max()), "idx_equal": idx_equal,
          "dx_rel_l2": dx_rel, "fwd_max_abs_err": fwd_err,
          "bwd_max_abs_err": bwd_err, **times})
    check(bit_equal >= 0.999, f"forward bit-equal share {bit_equal} < 0.999")
    check(int(ulp.max()) <= 1, f"forward differs by {int(ulp.max())} bf16 ulp")
    check(idx_equal >= 0.999, f"winner index agreement {idx_equal} < 0.999")
    check(dx_rel < 1e-3, f"dx relative L2 error {dx_rel} >= 1e-3")
    # bytes: x, w, bias, out, idx / idx, g, w, dx; operations: 25 bf16
    # products per conv output forward, 25 per routed cotangent backward
    n_in, n_out = B * 404 * 80, B * 202 * 40 * 32
    w_bytes = 64 * 25 * 4 + 64 * 4
    bounds = {"fwd": bound(2 * n_in + w_bytes + 2 * n_out + n_out,
                           2 * 25 * n_in * 64, "bf16"),
              "bwd": bound(n_out + 2 * n_out + w_bytes + 2 * n_in,
                           2 * 25 * n_out, "bf16")}
    return fwd_err, bwd_err, times, bounds


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
        }
        check(tuple(out_k.shape) == (B, lfcc_fused.N_CEP, lfcc_fused.N_FRAMES),
              f"lfcc shape {tuple(out_k.shape)}")
        check(bool(torch.isfinite(out_k).all()), f"non-finite {kind} cepstra")
        check(excess <= 0.0, f"{kind} cepstra outside atol {LFCC_ATOL} + rtol {LFCC_RTOL}")
        worst = max(worst, result[kind]["max_abs_err"])
    emit(result)
    # the linear filterbank is the main path's; bytes: x, the constant
    # matrices, out; f32 operations: the DFT on the window's 400 taps, the
    # filterbank's non-zero weights and the DCT, per frame
    nnz = int((lfcc_fused.filterbank_matrix("linear") != 0).sum())
    n_const = 400 * 512 + 400 + 257 * 128 + 128 * 80
    per_frame = 400 * 2 * lfcc_fused.N_BINS + nnz + 128 * 80
    b = bound(4 * (B * lfcc_fused.WAVE_LEN + n_const + B * 80 * 404),
              2 * B * 404 * per_frame, "f32")
    return worst, result["linear"]["ms"], result["linear"]["plain_ms"], b


def phase6_trunk(trunk):
    rng = np.random.default_rng(6)
    out = {"phase": 6, "batch": B}
    totals = {"fwd_ms": 0.0, "fwd_plain_ms": 0.0, "bwd_ms": 0.0, "bwd_plain_ms": 0.0,
              "fwd_err": 0.0, "bwd_err": 0.0, "fwd_bytes": 0.0, "fwd_flops": 0.0,
              "bwd_bytes": 0.0, "bwd_flops": 0.0}
    for name, spec in (("A", trunk.SEGMENT_A), ("B", trunk.SEGMENT_B)):
        am = randn(rng, (B, spec.t, spec.f, spec.c2))
        wb = randn(rng, (spec.c_out, spec.c2, 3, 3), 1.0 / np.sqrt(9 * spec.c2))
        bb = randn(rng, (spec.c_out,), 0.1)
        g = randn(rng, (B, spec.t_out, spec.f_out, spec.half)).to(torch.bfloat16).float()
        y_k = trunk.kernel_fwd(am, wb, bb, spec)
        y_r = trunk.reference_fwd(am, wb, bb, spec)
        dx_k = trunk.kernel_bwd(am, wb, bb, g, spec)
        dx_r = trunk.reference_bwd(am, wb, bb, g, spec)
        torch.cuda.synchronize()
        cand = trunk._candidates(am, wb, bb, spec)
        routed = int((cand == cand.amax(dim=(1, 4, 6), keepdim=True)).sum())
        del cand
        bit_equal = float((y_k.to(torch.bfloat16) == y_r.to(torch.bfloat16)).float().mean())
        fwd_err = float((y_k - y_r).abs().max())
        scale = float(y_r.abs().max())
        dx_rel = float((dx_k - dx_r).norm() / dx_r.norm())
        seg = {"fwd_bit_equal_bf16": bit_equal, "fwd_max_abs_err": fwd_err,
               "fwd_max_abs_ref": scale, "dx_rel_l2": dx_rel,
               "bwd_max_abs_err": float((dx_k - dx_r).abs().max()),
               "routed_cotangents": routed,
               "fwd_ms": median_ms(lambda: trunk.kernel_fwd(am, wb, bb, spec)),
               "fwd_plain_ms": median_ms(lambda: trunk.reference_fwd(am, wb, bb, spec)),
               "bwd_ms": median_ms(lambda: trunk.kernel_bwd(am, wb, bb, g, spec)),
               "bwd_plain_ms": median_ms(lambda: trunk.reference_bwd(am, wb, bb, g, spec))}
        out[name] = seg
        check(bit_equal >= 0.999, f"segment {name}: bf16 bit-equal share {bit_equal} < 0.999")
        check(fwd_err <= 1e-4 * scale, f"segment {name}: forward error {fwd_err} > 1e-4 x {scale}")
        check(dx_rel < TRUNK_DX_RTOL, f"segment {name}: dx relative L2 {dx_rel} >= {TRUNK_DX_RTOL}")
        for k in ("fwd_ms", "fwd_plain_ms", "bwd_ms", "bwd_plain_ms"):
            totals[k] += seg[k]
        totals["fwd_err"] = max(totals["fwd_err"], fwd_err)
        totals["bwd_err"] = max(totals["bwd_err"], seg["bwd_max_abs_err"])
        # bytes: am, weights, bias, out / am, g, weights, bias, dx (f32);
        # bf16 products: 9 c2 per conv output that reaches the pool, and
        # the backward's recompute plus 9 c2 per routed cotangent
        n_am = B * spec.t * spec.f * spec.c2
        n_y = B * spec.t_out * spec.f_out * spec.half
        n_w = spec.c_out * spec.c2 * 9 + spec.c_out
        conv_flops = 2 * 9 * spec.c2 * B * 4 * spec.t_out * spec.f_out * spec.c_out
        totals["fwd_bytes"] += 4 * (n_am + n_w + n_y)
        totals["fwd_flops"] += conv_flops
        totals["bwd_bytes"] += 4 * (n_am + n_y + n_w + n_am)
        totals["bwd_flops"] += conv_flops + 2 * 9 * spec.c2 * routed
    emit(out)
    bounds = {"fwd": bound(totals["fwd_bytes"], totals["fwd_flops"], "bf16"),
              "bwd": bound(totals["bwd_bytes"], totals["bwd_flops"], "bf16")}
    return totals, bounds


def logits_vs_plain(phase: int, model, x) -> None:
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
          "tol": LOGIT_ATOL})
    check(tuple(z_kernel.shape) == (B, 1), f"logit shape {tuple(z_kernel.shape)}")
    check(bool(torch.isfinite(z_kernel).all()), "non-finite logits")
    check(err <= LOGIT_ATOL, f"kernel/plain logits differ by {err}")


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
    check(launches["layer0"]["fwd"] >= 10 and launches["layer0"]["bwd"] == 10,
          f"layer-0 launches {launches}")
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
    from adaa_tpu_torch.ops import _build, layer0, lfcc_fused, trunk
    from adaa_tpu_torch.utils import set_seed
    from adaa_tpu_torch.utils.profiling import card_line

    card = card_line()
    print(card, flush=True)
    emit({"phase": 0, "card": card, "torch": torch.__version__, "cuda": torch.version.cuda})

    sources = ("layer0", "lfcc", "trunk")
    t0 = time.perf_counter()
    _build.build_all(sources)
    layer0._library(), lfcc_fused._library(), trunk._library()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln] for name in sources}
    emit({"phase": 1, "build_s": build_s, "ptxas": ptxas})

    l0_fwd_err, l0_bwd_err, l0_times, l0_bounds = phase2_layer0(layer0)

    main_path = bench.setup(B, seed=0, device="cuda")
    logits_vs_plain(3, main_path.model, main_path.x)
    counters = {"layer0": layer0.LAUNCHES, "lfcc": lfcc_fused.LAUNCHES, "trunk": trunk.LAUNCHES}
    default_launches = attack_checked(4, attacks, main_path, counters)
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
    check(fused_launches["lfcc"]["fwd"] >= 10, f"lfcc launches {fused_launches}")
    check(fused_launches["trunk"]["fwd"] >= 20 and fused_launches["trunk"]["bwd"] == 20,
          f"trunk launches {fused_launches}")
    del fused_path
    eps_fused = bench.measure_torch(batch=B, iters=5, warmup=2, fused=True)
    eps_default = bench.measure_torch(batch=B, iters=5, warmup=2)
    emit({"phase": 8, "metric": "adv_examples_per_sec_pgd10_lcnn_lfcc",
          "fused": eps_fused, "default": eps_default, "batch": B, "card": card})

    phase9_highest_gradient(attacks, models, set_seed)

    def entry(name, source, replaces, launches, err, ms, plain_ms, b):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None}

    l0_src, trunk_src = "adaa_tpu_torch/csrc/layer0.cu", "adaa_tpu_torch/csrc/trunk.cu"
    emit({"kernels": [
        entry("layer0_fwd", l0_src, "adaa_tpu/ops/pallas_layer0.py:160",
              default_launches["layer0"]["fwd"], l0_fwd_err, l0_times["fwd_ms"],
              l0_times["fwd_plain_ms"], l0_bounds["fwd"]),
        entry("layer0_bwd", l0_src, "adaa_tpu/ops/pallas_layer0.py:180",
              default_launches["layer0"]["bwd"], l0_bwd_err, l0_times["bwd_ms"],
              l0_times["bwd_plain_ms"], l0_bounds["bwd"]),
        entry("lfcc_fwd", "adaa_tpu_torch/csrc/lfcc.cu", "adaa_tpu/ops/pallas_lfcc.py:79",
              fused_launches["lfcc"]["fwd"], lfcc_err, lfcc_ms, lfcc_plain_ms, lfcc_bound),
        # trunk times and bounds: segments A + B, one forward of the model
        entry("trunk_fwd", trunk_src, "adaa_tpu/ops/pallas_trunk.py:148",
              fused_launches["trunk"]["fwd"], trunk_tot["fwd_err"], trunk_tot["fwd_ms"],
              trunk_tot["fwd_plain_ms"], trunk_bounds["fwd"]),
        entry("trunk_bwd", trunk_src, "adaa_tpu/ops/pallas_trunk.py:172",
              fused_launches["trunk"]["bwd"], trunk_tot["bwd_err"], trunk_tot["bwd_ms"],
              trunk_tot["bwd_plain_ms"], trunk_bounds["bwd"]),
    ]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
