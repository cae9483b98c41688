"""Attack-effectiveness parity of the fast surrogates (port of
``scripts/bench_effectiveness.py``).

The victim is each family's f32 model with TF32 off, on seed-0 weights.
The fast configurations (bf16 trunk, bf16 or f32 frontend, the fused
kernels) only generate adversarial examples. PGD-10 (the registry's
"PGD": eps 5e-4, 10 steps, random start) runs from each surrogate on the
same weights, inside the min-max round trip, and the adversarial audio
is scored on the victim: the mean |logit shift| and the share of
predictions it flips. Each row also counts the kernel launches of that
first batch. On the card it has the examples/s of whole batches (CUDA events,
``bench.cuda_ms``; the first call is the warm-up) and ``first_call_s``,
the first batch's seconds with the kernels' builds and cuDNN's
autotuning; with ``--cpu`` both are None (a CPU time is not this
metric).

    python -m adaa_tpu_torch.scripts.bench_effectiveness [--families lcnn specrnet rawnet3]
        [--out chiprun_out/bench_effectiveness.json] [--cpu]

A surrogate that fails raises: no row records an error.
"""
from __future__ import annotations

import argparse
import contextlib
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from adaa_tpu_torch import attacks, bench, models
from adaa_tpu_torch.models.layers import switches
from adaa_tpu_torch.ops import launch_counts, launches_since
from adaa_tpu_torch.ops.layer0 import ieee_f32
from adaa_tpu_torch.scripts import _common

WAVE_LEN = 64_600
BATCH = 128
ITERS = 3
OUT = _common.RESULTS_DIR / "bench_effectiveness.json"
LFCC_F32 = {"input_channels": 1, "frontend_algorithm": ["lfcc"]}
F32_FRONTEND = {"ADAA_BF16_FRONTEND": "0"}


class Surrogate(NamedTuple):
    config: Dict[str, Any]  # get_model's config
    env: Dict[str, str] = {}  # numerics switches set around its calls


class Family(NamedTuple):
    victim: Dict[str, Any]  # the f32 config
    batch: int
    surrogates: Dict[str, Surrogate]


# the JAX table's rows (scripts/bench_effectiveness.py:126-180), plus one row
# for each configuration in which a port kernel runs and the table has none
FAMILIES = {
    "lcnn": Family(LFCC_F32, BATCH, {
        "f32_surrogate": Surrogate(LFCC_F32),
        "bf16_trunk_f32_frontend": Surrogate(bench.CONFIG, F32_FRONTEND),
        "bf16_trunk_bf16_frontend": Surrogate(bench.CONFIG),
        "bf16_fused": Surrogate(bench.FUSED_CONFIG),
    }),
    # SpecRNet never takes the bf16 frontend, so its two bf16 rows are one
    # configuration, as in the JAX table
    "specrnet": Family(LFCC_F32, BATCH, {
        "f32_surrogate": Surrogate(LFCC_F32),
        "bf16_trunk_f32_frontend": Surrogate(bench.SPECRNET_CONFIG, F32_FRONTEND),
        "bf16_trunk_bf16_frontend": Surrogate(bench.SPECRNET_CONFIG),
        "bf16_fused": Surrogate(bench.SPECRNET_FUSED_CONFIG),
    }),
    # raw-waveform family: the "frontend" is the sinc encoder
    "rawnet3": Family({}, bench.RAWNET3_BATCH, {
        "f32_surrogate": Surrogate({}),
        "bf16_trunk_f32_encoder": Surrogate(bench.RAWNET3_CONFIG, F32_FRONTEND),
        "bf16_trunk_bf16_encoder": Surrogate(bench.RAWNET3_CONFIG),
        "bf16_fused_b2n": Surrogate(bench.RAWNET3_B2N_CONFIG),
        "bf16_pool": Surrogate(bench.RAWNET3_POOL_CONFIG),
    }),
}


def _model(name: str, config: Dict[str, Any], weights, device: str) -> torch.nn.Module:
    model = models.init_model(models.get_model(name, config),
                              torch.Generator(device).manual_seed(0), device)
    if weights is not None:
        model.load_state_dict(weights)
    return model.eval().requires_grad_(False)


def _precision(config: Dict[str, Any]):
    """TF32 off for an f32 model: its products are IEEE f32, as the victim's."""
    return contextlib.nullcontext() if config.get("compute_dtype") == "bfloat16" else ieee_f32()


def run_family(model_name: str, surrogates: Optional[Dict[str, Surrogate]] = None,
               batch: Optional[int] = None, iters: int = ITERS, device: str = "cuda",
               state_dict: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, dict]:
    """PGD-10 from each surrogate of ``model_name`` (its family's by
    default), scored on the f32 victim. The weights are seed 0's, or
    ``state_dict``."""
    family = FAMILIES[model_name]
    surrogates = surrogates or family.surrogates
    batch = batch or family.batch
    victim = _model(model_name, family.victim, state_dict, device)
    weights = victim.state_dict()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((batch, WAVE_LEN)).astype(np.float32)).to(device)
    y = torch.from_numpy((np.arange(batch) % 2).astype(np.int64)).to(device)

    def victim_logits(wave):
        with torch.no_grad(), ieee_f32():
            return victim(wave).squeeze(-1)

    z_clean = victim_logits(x)
    card = _common.card(device)
    out = {}
    for name, (config, env) in surrogates.items():
        model = _model(model_name, config, weights, device)
        attack = attacks.attack_in_wave_space(
            attacks.build_attack("PGD", attacks.make_logits_fn(model)))
        gen = torch.Generator(device).manual_seed(1)
        with switches(env), _precision(config):
            before = launch_counts()
            if device == "cpu":
                adv, first_s = attack(x, y, gen), None
            else:
                adv, first_s = bench.first_call_s(lambda: attack(x, y, gen))
            launched = launches_since(before)
            eps = None if device == "cpu" else batch / (
                bench.cuda_ms(lambda: attack(x, y, gen), iters, 0) / 1e3)
        z_adv = victim_logits(adv)
        out[name] = {
            "mean_abs_logit_shift": float((z_adv - z_clean).abs().mean()),
            "flip_rate": float(((z_adv > 0) != (z_clean > 0)).float().mean()),
            "examples_per_sec": eps,
            "first_call_s": first_s,
            "launches": launched,
            "batch": batch,
            "card": card,
            "measured_at": _common.provenance(),
        }
        print(f"{name}: {out[name]}", flush=True)
        del model, attack, adv
    return out


def main(argv=None) -> Dict[str, dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--families", nargs="*", default=list(FAMILIES))
    parser.add_argument("--out", default=str(OUT), help="JSON file the rows merge into")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    device = _common.device_for(args.cpu)
    rows = {}
    for family in args.families:
        prefix = "" if family == "lcnn" else f"{family}:"
        rows.update({prefix + k: v for k, v in
                     run_family(family, device=device).items()})
        _common.write_rows(args.out, rows)
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
