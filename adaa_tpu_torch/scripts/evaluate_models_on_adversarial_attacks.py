"""Adversarial evaluation CLI, white-box and transfer (port of
``scripts/evaluate_models_on_adversarial_attacks.py``; the reference's
:38-101 flags). Logs to ``logs/<datetime>.log`` as the reference does.

    python -m adaa_tpu_torch.scripts.evaluate_models_on_adversarial_attacks \\
        --asv_path synthetic:128 --config configs/aa_evaluation/specrnet.yaml \\
        --attack_model_config configs/aa_evaluation/lcnn.yaml --attack PGD [--qual] [--cpu]

``main`` reads the yaml configs; ``run`` takes the config dicts.
"""
import argparse
import logging
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

from adaa_tpu_torch.scripts._common import (add_dataset_path_args, build_dataset, device_for,
                                            setup_logging)


def run(args: argparse.Namespace, config: Dict[str, Any],
        attack_model_config: Optional[Dict[str, Any]]) -> Dict[str, float]:
    from adaa_tpu_torch import models
    from adaa_tpu_torch.eval.adv_evaluation import generate_attacks
    from adaa_tpu_torch.utils import set_seed

    device = device_for(args.cpu)
    generator = set_seed(config["data"].get("seed", 42), device)
    model = models.load_model(config, generator, device)
    attack_model = (models.load_model(attack_model_config, generator, device)
                    if attack_model_config is not None else None)

    on_attack_end_callback = None
    if args.qual:
        from adaa_tpu_torch.eval.qualitative import AttackAnalyser

        results_folder = (f"attack_{args.attack}_"
                          f"{Path(args.attack_model_config).stem}_on_{Path(args.config).stem}")
        on_attack_end_callback = AttackAnalyser(Path("qualitative_results") / results_folder).analyse

    dataset = build_dataset([args.asv_path, args.wavefake_path, args.celeb_path], subset="val",
                            reduced_number=args.amount, return_label=True, return_meta=True,
                            return_raw=args.raw_from_dataset)
    return generate_attacks(victim_model=model, dataset=dataset, attack_name=args.attack,
                            attack_model=attack_model, generator=generator,
                            on_attack_end_callback=on_attack_end_callback,
                            raw_sample_from_dataset=args.raw_from_dataset)


def main(args: argparse.Namespace) -> Dict[str, float]:
    logger = setup_logging()
    Path("logs").mkdir(exist_ok=True)
    fh = logging.FileHandler(f"logs/{datetime.now()}.log")
    fh.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
    logger.addHandler(fh)
    print(args)
    import yaml

    attack_model_config = None
    if args.attack_model_config is not None:
        with open(args.attack_model_config, "r") as f:
            attack_model_config = yaml.safe_load(f)
    with open(args.config, "r") as f:
        config = yaml.safe_load(f)
    return run(args, config, attack_model_config)


def build_parser() -> argparse.ArgumentParser:
    from adaa_tpu_torch.attacks import attack_names

    parser = argparse.ArgumentParser()
    add_dataset_path_args(parser)
    parser.add_argument("--attack", help="Attack to apply", type=str, default="NO_ATTACK",
                        choices=attack_names())
    parser.add_argument("--attack_model_config", type=str, default=None,
                        help="Attack (surrogate) model config file path")
    parser.add_argument("--config", help="Model config file path", type=str,
                        default="configs/lcnn.yaml")
    parser.add_argument("--amount", "-a", type=int, default=None,
                        help="Amount of files to load from each directory (default: None - use all).")
    parser.add_argument("--qual", help="Generate qualitative results", default=False,
                        action="store_true")
    parser.add_argument("--raw_from_dataset", help="Return raw sample from the dataset",
                        default=False, action="store_true")
    parser.add_argument("--cpu", "-c", help="Force using cpu", action="store_true")
    return parser


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
