"""Adversarial-training throughput on the card (port of ``scripts/bench_train.py``).

One adversarial train step is an FGSM self-attack on the live weights,
then the BCE/Adam update (the reference's
train_models_on_adversarial_attacks.py ONLY_ADV semantics), on the
LCNN+LFCC at 64,600 samples (``bench.measure_torch_train``). It reports
examples/s, ms a step (CUDA events over ``--iters`` steps after warm-up),
the first step's seconds, peak memory and the last loss, for the f32 and
bf16 configurations, with the card's name and power limit; with
``--cpu`` it runs the steps and reports their loss, the times None.
Merges into ``--out``.

    python -m adaa_tpu_torch.scripts.bench_train [--batch 256] [--iters 10]
        [--out chiprun_out/bench_train.json] [--cpu]
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

from adaa_tpu_torch import bench
from adaa_tpu_torch.scripts import _common

OUT = _common.RESULTS_DIR / "bench_train.json"


def train_row(mode: str, batch: int, iters: int, device: str) -> Dict[str, Any]:
    if device == "cpu":
        path = bench.setup_train(batch, device="cpu", config=bench.TRAIN_CONFIGS[mode])
        for _ in range(iters):
            loss = bench.adv_train_step(path)
        row = {"ms_per_step": None, "examples_per_sec": None, "batch": batch,
               "first_call_s": None, "loss": float(loss)}
    else:
        row = bench.measure_torch_train(batch, iters=iters, dtype=mode)
    return {**row, "measured_at": _common.provenance(), "card": _common.card(device)}


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--out", default=str(OUT))
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    device = _common.device_for(args.cpu)
    rows = {}
    for mode in ("bf16", "f32"):
        rows[f"adv_train_fgsm_bce_{mode}"] = train_row(mode, args.batch, args.iters, device)
        print(f"{mode}: {rows[f'adv_train_fgsm_bce_{mode}']}", flush=True)
    _common.write_rows(args.out, rows)
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
