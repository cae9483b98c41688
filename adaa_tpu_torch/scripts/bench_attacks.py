"""Attack-matrix throughput on the card (port of ``scripts/bench_attacks.py``).

For each attack: the first call's seconds (``first_call_s``: the
kernels' builds, cuDNN's autotuning), ms a batch and examples/s (CUDA
events over ``--iters`` whole batches after one warm-up,
``bench.cuda_ms``), the FLOPs an example and their share of the card's
bf16 peak (``mfu_pct``), and the card's name and power limit. The attacks
run on the bf16 detector (seed-0 weights) inside the min-max round trip,
on seeded 64,600-sample waves. With ``--cpu`` the times and the share are
None: a CPU time is not this metric.

The FLOPs are ``utils.flops.count_flops`` of one more call on the model's
plain versions (``plain_ops``): a hand-written kernel is opaque to the
counter, as a ``pallas_call`` is to the JAX package's jaxpr walk. CW's
early-stopping loop counts as its ``steps`` bound. A row whose count saw
a kernel launch ships without the FLOP fields, and says why on stderr.

    python -m adaa_tpu_torch.scripts.bench_attacks [--attacks FAB PGD ...] [--batch 64]
        [--iters 3] [--model lcnn|specrnet|rawnet3] [--no-merge] [--key-suffix S]
        [--out chiprun_out/bench_attacks.json] [--cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from adaa_tpu_torch import attacks, bench, models
from adaa_tpu_torch.attacks import ATTACK_REGISTRY, EXTRA_ATTACKS
from adaa_tpu_torch.scripts import _common
from adaa_tpu_torch.utils import set_seed
from adaa_tpu_torch.utils.flops import count_flops

WAVE_LEN = 64_600
OUT = _common.RESULTS_DIR / "bench_attacks.json"
# H100 SXM dense bf16 tensor-core peak (NVIDIA's data sheet, at 700 W): the
# share of it is FLOPs an example x examples/s / this peak
PEAK_FLOPS_BF16 = 989e12

DEFAULT_ATTACKS = [
    "FGSM", "PGD", "PGDL2", "BIM", "MIFGSM", "DeepFool", "APGDT",
    "CW", "Square", "FAB",
]


def _multiattack(logits_fn):
    """Registry-eps PGD + PGDL2 + FGSM in sequence (the reference's
    multiattack.py first-success-wins semantics)."""
    return attacks.multiattack(logits_fn, [
        attacks.pgd(logits_fn, eps=0.0005, steps=10),
        attacks.pgdl2(logits_fn, eps=0.1, steps=10),
        attacks.fgsm(logits_fn, eps=0.0005),
    ])


# the JAX tool's stock attacks and parameters (scripts/bench_attacks.py:82-101)
STOCK: Dict[str, Tuple[Callable, Dict[str, Any]]] = {
    "BIM": (EXTRA_ATTACKS["BIM"], {"steps": 10}),
    "MIFGSM": (EXTRA_ATTACKS["MIFGSM"], {"steps": 10}),
    "DeepFool": (EXTRA_ATTACKS["DeepFool"], {"steps": 20}),
    "APGDT": (EXTRA_ATTACKS["APGDT"], {"steps": 20}),
    "CW": (EXTRA_ATTACKS["CW"], {"steps": 50}),
    "Square": (EXTRA_ATTACKS["Square"], {"n_queries": 200}),
    # the reference's OnePixel defaults (torchattacks/attacks/onepixel.py)
    "OnePixel": (EXTRA_ATTACKS["OnePixel"],
                 {"pixels": 1, "steps": 75, "popsize": 10, "inf_batch": 128}),
    "MultiAttack": (_multiattack, {}),
    # upstream 'standard' suite budgets (autoattack.py): APGD-CE + APGD-T +
    # FAB at 100 steps, Square at 5000 queries
    "AutoAttack": (EXTRA_ATTACKS["AutoAttack"], {"eps": 0.001}),
}


def resolve(name: str) -> Tuple[Callable, Dict[str, Any]]:
    """Registry attacks by exact key; stock attacks by builder name."""
    if name in ATTACK_REGISTRY:
        return ATTACK_REGISTRY[name]
    return STOCK[name]


def flops_per_example(model: torch.nn.Module, fn: Callable, batch: int, *args,
                      while_trip: int = 1) -> Optional[float]:
    """FLOPs an example of ``fn(*args)`` counted on ``model``'s plain
    versions; None (and why, on stderr) where a kernel launched."""
    plain, model.plain_ops = model.plain_ops, True
    try:
        rep = count_flops(fn, *args, while_trip=while_trip)
    finally:
        model.plain_ops = plain
    if rep.get("has_kernel"):
        print(f"[flops] a kernel launched during the count, skipping field: {rep}",
              file=sys.stderr)
        return None
    return rep["flops"] / batch if rep["flops"] > 0 else None


def measure(name: str, model: torch.nn.Module, x: torch.Tensor, y: torch.Tensor,
            iters: int, device: str) -> Dict[str, Any]:
    """One attack's row (module doc)."""
    fn, params = resolve(name)
    attack = attacks.attack_in_wave_space(fn(attacks.make_logits_fn(model), **params))
    gen = torch.Generator(device).manual_seed(1)
    batch = x.shape[0]
    row: Dict[str, Any] = {f"ms_per_batch{batch}": None, "examples_per_sec": None,
                           "first_call_s": None}
    if device != "cpu":
        _, row["first_call_s"] = bench.first_call_s(lambda: attack(x, y, gen))
        ms = bench.cuda_ms(lambda: attack(x, y, gen), iters, 1)
        row[f"ms_per_batch{batch}"], row["examples_per_sec"] = ms, batch / (ms / 1e3)
    row["measured_at"] = _common.provenance()
    row["card"] = _common.card(device)
    fpe = flops_per_example(model, attack, batch, x, y, gen,
                            while_trip=params.get("steps", 1))
    if fpe is not None:
        row["flops_per_example"] = fpe
        eps = row["examples_per_sec"]
        row["mfu_pct"] = None if eps is None else fpe * eps / PEAK_FLOPS_BF16 * 100
    return row


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--attacks", nargs="*", default=DEFAULT_ATTACKS)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--model", default="lcnn",
                        help="detector to attack (lcnn/specrnet/rawnet3); "
                        "non-lcnn results get a '<model>:' key prefix")
    parser.add_argument("--no-merge", action="store_true",
                        help="overwrite --out instead of merging into it")
    parser.add_argument("--key-suffix", default="",
                        help="append to the result row key (A/B runs of "
                        "env-gated fast paths, e.g. '+b2n')")
    parser.add_argument("--out", default=str(OUT))
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    device = _common.device_for(args.cpu)

    if args.model == "rawnet3":  # raw-waveform model: no frontend key
        cfg = {"compute_dtype": "bfloat16"}
    else:
        cfg = {"input_channels": 1, "frontend_algorithm": ["lfcc"], "compute_dtype": "bfloat16"}
    model = models.init_model(models.get_model(args.model, cfg), set_seed(0, device), device)
    model.eval().requires_grad_(False)
    prefix = "" if args.model == "lcnn" else f"{args.model}:"
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((args.batch, WAVE_LEN)).astype(np.float32))
    y = torch.from_numpy((np.arange(args.batch) % 2).astype(np.int64))
    x, y = x.to(device), y.to(device)

    rows = {}
    for name in args.attacks:
        key = prefix + name + (f"@b{args.batch}" if args.batch != 64 else "") + args.key_suffix
        rows[key] = measure(name, model, x, y, args.iters, device)
        print(f"{key}: {rows[key]}", flush=True)
    _common.write_rows(args.out, rows, merge=not args.no_merge)
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
