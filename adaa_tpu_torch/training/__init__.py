"""Training (port of ``adaa_tpu/training``): clean and adversarial trainers
and the five attack-scheduling strategies."""
from adaa_tpu_torch.training.adv_trainer import (  # noqa: F401
    ADV_TRAINER_REGISTRY,
    AdversarialGDTrainer,
)
from adaa_tpu_torch.training.gd_trainer import GDTrainer  # noqa: F401
