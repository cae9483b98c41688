#!/usr/bin/env python
"""Batch adversarial training: the port's twin of
``scripts/multi_runs/run_multiple_trainings_on_adversarial_attacks.py``
(the reference's multi_runs_scripts/run_multiple_trainings_on_adversarial_attacks.py:36-67):
each entry of the batch config (``config``, optional
``attack_model_config``) trained by the port's
``train_models_on_adversarial_attacks``, in this process:

    python -m adaa_tpu_torch.scripts.multi_runs.run_multiple_trainings_on_adversarial_attacks \\
        --config scripts/multi_runs/configs/adv_train.yaml --asv_path synthetic:16 \\
        --epochs 1 -b 4 -a 8 -ta 8 [--cpu]
"""
import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", help="Path to batch config.",
                        default="adv_train_batch_config.yaml")
    parser.add_argument("--data_path", help="Dataset path", type=str,
                        default="/home/adminuser/storage/datasets/deep_fakes")
    parser.add_argument("--asv_path", default=None)
    parser.add_argument("--adv_training_strategy", default="RANDOM")
    parser.add_argument("--finetune", "-v", help="Use finetuning", action="store_true")
    parser.add_argument("--epochs", type=int, default=10)
    # passthroughs beyond the reference script's flags (None: the CLI's defaults)
    parser.add_argument("--batch_size", "-b", type=int, default=None)
    parser.add_argument("--train_amount", "-a", type=int, default=None)
    parser.add_argument("--test_amount", "-ta", type=int, default=None)
    parser.add_argument("--cpu", "-c", help="Run each training on the CPU", action="store_true")
    return parser.parse_args(argv)


def main(args: argparse.Namespace) -> list:
    """Run the CLI on each entry; return what each run returned, in order."""
    from adaa_tpu_torch.config import load_yaml
    from adaa_tpu_torch.scripts import train_models_on_adversarial_attacks as adv_train
    from adaa_tpu_torch.scripts.multi_runs import corpus_argv, passthrough, run_all

    configs_to_run = load_yaml(args.config)
    print("Running following configs: ", configs_to_run)
    return run_all(adv_train, configs_to_run, lambda c: [
        "--config", c["config"], "--epochs", str(args.epochs),
        "--adv_training_strategy", args.adv_training_strategy,
        *corpus_argv(args.asv_path, args.data_path),
        *passthrough(("--attack_model_config", c.get("attack_model_config") or None)),
        *(["--finetune"] if args.finetune else []),
        *passthrough(("--batch_size", args.batch_size), ("--train_amount", args.train_amount),
                     ("--test_amount", args.test_amount))],
        args.cpu)

if __name__ == "__main__":
    main(parse_args())
