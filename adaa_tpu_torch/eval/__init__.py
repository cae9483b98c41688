"""Evaluation loops: clean + adversarial (white-box / transfer)."""
from adaa_tpu_torch.eval.adv_evaluation import generate_attacks  # noqa: F401
from adaa_tpu_torch.eval.evaluation import evaluate_nn  # noqa: F401
