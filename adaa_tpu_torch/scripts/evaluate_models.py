"""Clean evaluation CLI (port of ``scripts/evaluate_models.py``; the
reference's evaluate_models.py:159-190 flags).

    python -m adaa_tpu_torch.scripts.evaluate_models --asv_path synthetic:256 \\
        --config configs/aa_evaluation/lcnn.yaml [--cpu]

``main`` reads the yaml config; ``run`` takes the config dict.
"""
import argparse
from typing import Any, Dict, List, Optional

from adaa_tpu_torch.scripts._common import (add_dataset_path_args, build_dataset, device_for,
                                            setup_logging)


def run(args: argparse.Namespace, config: Dict[str, Any]) -> Dict[str, float]:
    from adaa_tpu_torch import models
    from adaa_tpu_torch.eval.evaluation import evaluate_nn
    from adaa_tpu_torch.utils import set_seed

    device = device_for(args.cpu)
    generator = set_seed(config["data"].get("seed", 42), device)
    model = models.load_model(config, generator, device)
    dataset = build_dataset([args.asv_path, args.wavefake_path, args.celeb_path],
                            subset="val", reduced_number=args.amount)
    return evaluate_nn(model, dataset, model_name=config["model"]["name"])


def main(args: argparse.Namespace) -> Dict[str, float]:
    setup_logging()
    import yaml

    with open(args.config, "r") as f:
        config = yaml.safe_load(f)
    return run(args, config)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_dataset_path_args(parser)
    parser.add_argument("--config", help="Model config file path (default: config.yaml)",
                        type=str, default="config.yaml")
    parser.add_argument("--amount", "-a", type=int, default=None,
                        help="Amount of files to load from each directory (default: None - use all).")
    parser.add_argument("--cpu", "-c", help="Force using cpu", action="store_true")
    return parser


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
