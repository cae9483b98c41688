#!/usr/bin/env python
"""Batch training: the port's twin of
``scripts/multi_runs/run_multiple_trainings.py`` (the reference's
multi_runs_scripts/run_multiple_trainings.py:24-33): each experiment
config of the batch config's ``paths:`` trained with batch 128 for 10
epochs by default, through the port's ``train_models``, in this process:

    python -m adaa_tpu_torch.scripts.multi_runs.run_multiple_trainings \\
        --config batch_config.yaml --asv_path synthetic:16 -b 4 -e 1 [--cpu]
"""
import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", help="Path to batch config.", default="batch_config.yaml")
    parser.add_argument("--asv_path", default=None)
    parser.add_argument("--wavefake_path", default=None)
    parser.add_argument("--celeb_path", default=None)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--cpu", "-c", help="Run each training on the CPU", action="store_true")
    return parser.parse_args(argv)


def main(args: argparse.Namespace) -> list:
    """Run the CLI on each entry; return what each run returned, in order."""
    from adaa_tpu_torch.config import load_yaml
    from adaa_tpu_torch.scripts import train_models
    from adaa_tpu_torch.scripts.multi_runs import passthrough, run_all

    configs_to_run = load_yaml(args.config)["paths"]
    print("Running following configs: ", configs_to_run)
    return run_all(train_models, configs_to_run, lambda config: [
        "--config", config, "--batch_size", str(args.batch_size), "--epochs", str(args.epochs),
        *passthrough(("--asv_path", args.asv_path), ("--wavefake_path", args.wavefake_path),
                     ("--celeb_path", args.celeb_path))],
        args.cpu)

if __name__ == "__main__":
    main(parse_args())
