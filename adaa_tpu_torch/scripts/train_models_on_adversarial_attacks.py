"""Adversarial training / fine-tuning CLI (port of
``scripts/train_models_on_adversarial_attacks.py``; the reference's
:191-290 flags and defaults: train amount 100k, test 10k, batch 64).

    python -m adaa_tpu_torch.scripts.train_models_on_adversarial_attacks \\
        --asv_path synthetic:64 --config <config with data.adversarial_attacks> \\
        --adv_training_strategy ADAPTIVE --finetune -b 16 -e 1 -ta 32 [--cpu]

Without ``--attack_model_config`` the live model attacks itself
(:106-109). A checkpoint per epoch and the best weights go under
``{--ckpt}/aad__{model}_{ts}/``; the test config with the legacy
``checkpoint.paths`` schema goes to ``configs/aad__{model}__{ts}.yaml``
(:143-149). ``main`` reads the yaml configs; ``run`` takes the dicts.
"""
import argparse
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from adaa_tpu_torch.scripts._common import (add_dataset_path_args, build_dataset, device_for,
                                            setup_logging)
from adaa_tpu_torch.scripts.train_models import write_config

LOGGER = logging.getLogger(__name__)


def run(args: argparse.Namespace, config: Dict[str, Any],
        attack_model_config: Optional[Dict[str, Any]]) -> Tuple[Path, Path]:
    """Train; return the best checkpoint's path and the test config's."""
    from adaa_tpu_torch import models
    from adaa_tpu_torch.training.adv_trainer import ADV_TRAINER_REGISTRY
    from adaa_tpu_torch.utils import save_checkpoint, set_seed

    device = device_for(args.cpu)
    generator = set_seed(config["data"].get("seed", 42), device)
    model_dir = Path(args.ckpt)
    model_dir.mkdir(parents=True, exist_ok=True)
    model_config = config["model"]
    model_name = model_config["name"]
    optimizer_config = model_config.get("optimizer", {"lr": 1e-4})
    timestamp = time.time()

    paths = [args.asv_path, args.wavefake_path, args.celeb_path]
    data_train = build_dataset(paths, "train", args.train_amount)
    data_test = build_dataset(paths, "test", args.test_amount)

    if args.finetune:
        if not (config.get("checkpoint") or {}).get("path"):
            raise ValueError("Finetune requires to provide checkpoint")
        LOGGER.info("Adversarial finetuning! Architecture: '%s', lr: %s, weights: '%s'!",
                    model_name, optimizer_config.get("lr"), config["checkpoint"]["path"])
        model = models.load_model(config, generator, device)
    else:
        model = models.init_model(
            models.get_model(model_name, model_config.get("parameters", {}) or {}),
            generator, device)

    if attack_model_config is not None:
        LOGGER.info("Load attack model based on attack config")
        attack_model = models.load_model(attack_model_config, generator, device)
        attack_info = f"{attack_model_config['model']['name']} (pretrained)"
    else:
        LOGGER.info("Use target model as attack model")
        attack_model, attack_info = None, model_name  # the self-attack

    adversarial_attacks = config["data"].get("adversarial_attacks", [])
    LOGGER.info("Training '%s', attacking using: '%s' model on %d audio files.", model_name,
                attack_info, len(data_train))
    LOGGER.info("Adversarial training strategy: %s", args.adv_training_strategy)

    save_name = f"aad__{model_name}_{timestamp}"
    model = ADV_TRAINER_REGISTRY[args.adv_training_strategy](
        batch_size=args.batch_size, epochs=args.epochs, optimizer_kwargs=optimizer_config,
        use_scheduler="rawnet3" in model_name.lower(), compute_eer=args.compute_eer,
    ).train(dataset=data_train, model=model, attack_model=attack_model,
            adversarial_attacks=adversarial_attacks, test_dataset=data_test,
            model_dir=str(model_dir), save_model_name=save_name, generator=generator)
    ckpt_path = save_checkpoint(model, model_dir, save_name)
    LOGGER.info("Training model done!")
    config["checkpoint"] = {"paths": [str(ckpt_path)]}  # the legacy schema, as the reference
    return ckpt_path, write_config(config, model_name, timestamp)


def main(args: argparse.Namespace) -> Tuple[Path, Path]:
    setup_logging()
    import yaml

    with open(args.config, "r") as f:
        config = yaml.safe_load(f)
    attack_model_config = None
    if args.attack_model_config is not None:
        with open(args.attack_model_config, "r") as f:
            attack_model_config = yaml.safe_load(f)
    return run(args, config, attack_model_config)


def build_parser() -> argparse.ArgumentParser:
    from adaa_tpu_torch.training.adv_trainer import ADV_TRAINER_REGISTRY

    parser = argparse.ArgumentParser()
    add_dataset_path_args(parser)
    parser.add_argument("--config", help="Model config file path (default: config.yaml)",
                        type=str, default="config.yaml")
    parser.add_argument("--attack_model_config", type=str, default=None,
                        help="Model config file path - if not provided, training will proceed "
                             "using weights of the trained model")
    parser.add_argument("--train_amount", "-a", help="Amount of files to load for training.",
                        type=int, default=100_000)
    parser.add_argument("--test_amount", "-ta", help="Amount of files to load for testing.",
                        type=int, default=10_000)
    parser.add_argument("--batch_size", "-b", help="Batch size (default: 64).", type=int,
                        default=64)
    parser.add_argument("--epochs", "-e", help="Epochs (default: 5).", type=int, default=5)
    parser.add_argument("--ckpt", help="Checkpoint directory (default: trained_models).",
                        type=str, default="trained_models")
    parser.add_argument("--adv_training_strategy", help="Adversarial training strategy",
                        type=str, default="RANDOM", choices=list(ADV_TRAINER_REGISTRY))
    parser.add_argument("--cpu", "-c", help="Force using cpu?", action="store_true")
    parser.add_argument("--finetune", help="Finetune using checkpoint provided in a config",
                        action="store_true")
    parser.add_argument("--compute_eer", action="store_true",
                        help="Compute the real per-epoch validation EER (and each attack's "
                             "adversarial EER) instead of the reference's placeholder 0 "
                             "(src/trainer.py:417).")
    return parser


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
