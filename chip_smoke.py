#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (adaa_tpu_torch) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; it never imports jax or adaa_tpu.
Each phase prints one JSON line, and any failed check raises, so the
exit code is not 0:

0. the card: ``nvidia-smi`` name and power limit;
1. build the kernels from ``adaa_tpu_torch/csrc`` (timed);
2. the layer-0 kernel against its plain-torch twin at B=256 (bf16):
   forward outputs bit-equal at >= 99.9% and all within 1 bf16 ulp,
   winner index equal at >= 99.9%, dx relative L2 error < 1e-3; the
   median time of each (CUDA events) beside the twin's;
3. the bf16 LCNN at B=256 x 64,600 with the kernel and with the twin:
   finite logits that agree within LOGIT_ATOL;
4. PGD-10 through ``build_attack("PGD")`` + ``attack_in_wave_space`` at
   B=256 x 64,600: within the eps ball, finite, CE not lower than on the
   clean input, and 10 forward and 10 backward layer-0 kernel launches;
   then ``adaa_tpu_torch.bench.measure_torch`` (examples/s).

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


def phase2_layer0(layer0):
    rng = np.random.default_rng(0)
    dev = "cuda"
    x = torch.from_numpy(rng.standard_normal((B, 404, 80)).astype(np.float32)).to(dev)
    x = x.to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((64, 1, 5, 5)) * 0.2).astype(np.float32)).to(dev)
    bias = torch.from_numpy((rng.standard_normal(64) * 0.1).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((B, 202, 40, 32)).astype(np.float32)).to(dev)
    g = g.to(torch.bfloat16)

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
    return fwd_err, bwd_err, times


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    from adaa_tpu_torch import attacks, bench
    from adaa_tpu_torch.ops import _build, layer0
    from adaa_tpu_torch.utils.profiling import card_line

    card = card_line()
    print(card, flush=True)
    emit({"phase": 0, "card": card, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    layer0._library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log("layer0").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": 1, "build_s": build_s, "ptxas": ptxas})

    fwd_err, bwd_err, times = phase2_layer0(layer0)

    model, attack, x, y, gen = bench.setup(B, seed=0, device="cuda")
    with torch.no_grad():
        z_kernel = model(x)
        model.conv0_reference = True
        z_twin = model(x)
        model.conv0_reference = False
    torch.cuda.synchronize()
    scale = float(z_twin.abs().max())
    logit_err = float((z_kernel - z_twin).abs().max())
    emit({"phase": 3, "shape": list(z_kernel.shape), "max_abs_logit": scale,
          "logit_max_abs_err": logit_err, "tol": LOGIT_ATOL})
    check(tuple(z_kernel.shape) == (B, 1), f"logit shape {tuple(z_kernel.shape)}")
    check(bool(torch.isfinite(z_kernel).all()), "non-finite logits")
    check(logit_err <= LOGIT_ATOL, f"kernel/twin logits differ by {logit_err}")

    with torch.no_grad():
        ce_clean = float(attacks.two_class_ce(model(x), y))
    layer0.LAUNCHES.update(fwd=0, bwd=0)
    adv = attack(x, y, gen)
    torch.cuda.synchronize()
    launches = dict(layer0.LAUNCHES)
    x01, mn, mx = attacks.to_minmax(x)
    linf = float(((adv - mn) / (mx - mn) - x01).abs().max())
    with torch.no_grad():
        ce_adv = float(attacks.two_class_ce(model(adv), y))
    emit({"phase": 4, "linf01": linf, "eps": EPS, "ce_clean": ce_clean,
          "ce_adv": ce_adv, "launches": launches})
    check(tuple(adv.shape) == tuple(x.shape), f"adversarial shape {tuple(adv.shape)}")
    check(bool(torch.isfinite(adv).all()), "non-finite adversarial waves")
    check(linf <= EPS + 1e-6, f"outside the eps ball: {linf}")
    check(ce_adv >= ce_clean, f"CE fell: {ce_adv} < {ce_clean}")
    check(launches["fwd"] >= 10 and launches["bwd"] == 10, f"layer-0 launches {launches}")

    eps_per_s = bench.measure_torch(batch=B, iters=5, warmup=2)
    emit({"phase": 4, "metric": "adv_examples_per_sec_pgd10_lcnn_lfcc",
          "value": eps_per_s, "batch": B, "card": card})

    source = "adaa_tpu_torch/csrc/layer0.cu"
    emit({"kernels": [
        {"name": "layer0_fwd", "route": "cuda", "source": source,
         "replaces": "adaa_tpu/ops/pallas_layer0.py:160", "launches": launches["fwd"],
         "max_abs_err": fwd_err, "ms": times["fwd_ms"], "plain_ms": times["fwd_plain_ms"]},
        {"name": "layer0_bwd", "route": "cuda", "source": source,
         "replaces": "adaa_tpu/ops/pallas_layer0.py:180", "launches": launches["bwd"],
         "max_abs_err": bwd_err, "ms": times["bwd_ms"], "plain_ms": times["bwd_plain_ms"]},
    ]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
