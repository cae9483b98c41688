#!/usr/bin/env python
"""Batch adversarial evaluation: the port's twin of
``scripts/multi_runs/run_multiple_evaluations_on_adversarial_attacks.py``
(the reference's multi_runs_scripts/run_multiple_evaluations_on_adversarial_attacks.py:31-50):
each (attack, config, attack_model_config) entry of the batch config runs
the port's ``evaluate_models_on_adversarial_attacks`` with ``--qual
--raw_from_dataset``, in this process. The argv is a list, so the
reference's merged ``"--raw_from_dataset" f"--asv_path..."`` flags (no
separator, :41-42) stay apart, as the JAX script keeps them:

    python -m adaa_tpu_torch.scripts.multi_runs.run_multiple_evaluations_on_adversarial_attacks \\
        --config scripts/multi_runs/configs/adv_eval_whitebox.yaml --asv_path synthetic:128 [--cpu]
"""
import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", help="Path to batch config.", default="adv_batch_config.yaml")
    parser.add_argument("--data_path", help="Dataset path", type=str,
                        default="/home/adminuser/storage/datasets/deep_fakes")
    parser.add_argument("--asv_path", default=None)
    parser.add_argument("--amount", "-a", type=int, default=None)
    parser.add_argument("--cpu", "-c", help="Run each evaluation on the CPU", action="store_true")
    return parser.parse_args(argv)


def main(args: argparse.Namespace) -> list:
    """Run the CLI on each entry; return what each run returned, in order."""
    from adaa_tpu_torch.config import load_yaml
    from adaa_tpu_torch.scripts import evaluate_models_on_adversarial_attacks as adv_eval
    from adaa_tpu_torch.scripts.multi_runs import corpus_argv, passthrough, run_all

    configs_to_run = load_yaml(args.config)
    print("Running following configs: ", configs_to_run)
    return run_all(adv_eval, configs_to_run, lambda c: [
        "--attack", c["attack"], "--config", c["config"],
        "--attack_model_config", c["attack_model_config"], "--qual", "--raw_from_dataset",
        *corpus_argv(args.asv_path, args.data_path),
        *passthrough(("--amount", args.amount or None))],
        args.cpu)

if __name__ == "__main__":
    main(parse_args())
