"""Clean training CLI (port of ``scripts/train_models.py``; the reference's
train_models.py:155-235 flags and defaults: batch 128, epochs 5, test
amount 10k).

    python -m adaa_tpu_torch.scripts.train_models --asv_path synthetic:64 \\
        --config configs/training/lcnn.yaml -b 16 -e 1 -ta 32 [--compute_eer] [--cpu]

Trains on the card (``--cpu``: on the CPU), saves the best weights as
``{--ckpt}/aad__{model}__{ts}/ckpt.pth`` and writes the chained test
config ``configs/aad__{model}__{ts}.yaml`` (relative to the working
directory) with that checkpoint (train_models.py:116-123). The cosine
warm-restart schedule is on for RawNet3 only. ``main`` reads the yaml
config; ``run`` takes the config dict.
"""
import argparse
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from adaa_tpu_torch.scripts._common import (add_dataset_path_args, build_dataset, device_for,
                                            setup_logging)

LOGGER = logging.getLogger(__name__)


def write_config(config: Dict[str, Any], model_name: str, timestamp: float) -> Path:
    """``configs/aad__{model}__{ts}.yaml`` in the working directory."""
    import yaml

    path = Path("configs") / f"aad__{model_name}__{timestamp}.yaml"
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.dump(config, f)
    LOGGER.info("Test config saved at location '%s'!", path)
    return path


def run(args: argparse.Namespace, config: Dict[str, Any]) -> Tuple[Path, Path]:
    """Train; return the checkpoint's path and the chained config's."""
    from adaa_tpu_torch import models
    from adaa_tpu_torch.training.gd_trainer import GDTrainer
    from adaa_tpu_torch.utils import save_checkpoint, set_seed

    device = device_for(args.cpu)
    generator = set_seed(config["data"].get("seed", 42), device)
    model_dir = Path(args.ckpt)
    model_dir.mkdir(parents=True, exist_ok=True)
    model_config = config["model"]
    model_name = model_config["name"]
    optimizer_config = model_config.get("optimizer", {"lr": 1e-3})
    timestamp = time.time()

    paths = [args.asv_path, args.wavefake_path, args.celeb_path]
    data_train = build_dataset(paths, "train", args.train_amount, oversample=True)
    data_test = build_dataset(paths, "test", args.test_amount, oversample=True)
    model = models.init_model(
        models.get_model(model_name, model_config.get("parameters", {}) or {}), generator, device)
    use_scheduler = "rawnet3" in model_name.lower()
    LOGGER.info("Training '%s' model on %d audio files.", model_name, len(data_train))

    model = GDTrainer(batch_size=args.batch_size, epochs=args.epochs,
                      optimizer_kwargs=optimizer_config, use_scheduler=use_scheduler,
                      compute_eer=args.compute_eer).train(
        dataset=data_train, model=model, test_dataset=data_test)
    ckpt_path = save_checkpoint(model, model_dir, f"aad__{model_name}__{timestamp}")
    LOGGER.info("Training done!")
    config["checkpoint"] = {"path": str(ckpt_path)}
    return ckpt_path, write_config(config, model_name, timestamp)


def main(args: argparse.Namespace) -> Tuple[Path, Path]:
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
    parser.add_argument("--train_amount", "-a", help="Amount of files to load for training.",
                        type=int, default=None)
    parser.add_argument("--test_amount", "-ta", help="Amount of files to load for testing.",
                        type=int, default=10_000)
    parser.add_argument("--batch_size", "-b", help="Batch size (default: 128).", type=int,
                        default=128)
    parser.add_argument("--epochs", "-e", help="Epochs (default: 5).", type=int, default=5)
    parser.add_argument("--ckpt", help="Checkpoint directory (default: trained_models).",
                        type=str, default="trained_models")
    parser.add_argument("--cpu", "-c", help="Force using cpu?", action="store_true")
    parser.add_argument("--compute_eer", action="store_true",
                        help="Compute the real per-epoch validation EER instead of the "
                             "reference's placeholder 0 (src/trainer.py:171).")
    return parser


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
