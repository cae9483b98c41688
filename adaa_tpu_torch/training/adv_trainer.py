"""Adversarial trainers and the five attack-scheduling strategies (port of
``adaa_tpu/training/adv_trainer.py``; the reference's AdversarialGDTrainer
family, src/trainer.py:213-581):

* RANDOM: attack with probability n / (n + 1), uniform choice (464-473)
* EQUAL: always attacks[0], on a random half of the batch (479-497)
* ONLY_ADV: always attack; exactly one attack allowed (500-514)
* ADAPTIVE: loss-EMA weighted choice over the attacks and a no-attack
  arm, smoothed halfway to uniform (517-557)
* ADAPTIVE_V2: 1/3 to no attack, 2/3 split over the attacks (560-581)

Model selection by ``multi_f1_score`` = len * prod / sum over [clean
accuracy, adversarial accuracy per attack] (220-224, 386-392), a
checkpoint per epoch (394-400), and one adversarial validation per
attack on a freshly shuffled loader (356-380).

Each attack is ``make_adv_fn``: min-max to [0, 1], the registry attack
through ``attacks.make_logits_fn`` on the surrogate, and back. Without
an attack model the surrogate is the live model itself
(train_models_on_adversarial_attacks.py:106-109): ``make_logits_fn``
runs it in ``eval()`` with frozen parameters and gives back its modes
and flags, so the attack sees the weights of the latest step. On the
bf16 LCNN that attack runs the layer-0 kernel (and, in the fused
configuration, the LFCC and trunk kernels) on weights that change
between launches. The strategies draw from python's ``random`` as the
JAX package does, so one seed gives both the same choices.
"""
from __future__ import annotations

import functools
import logging
import os
import random
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from adaa_tpu_torch import attacks
from adaa_tpu_torch.data.loader import DataLoader
from adaa_tpu_torch.eval.evaluation import model_device
from adaa_tpu_torch.training import train_state as ts
from adaa_tpu_torch.training.gd_trainer import (GDTrainer, cpu_state_dict, make_eval_step,
                                                to_device, train_step)
from adaa_tpu_torch.utils.checkpoints import save_checkpoint

LOGGER = logging.getLogger(__name__)

AdvFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (waves, labels) -> waves


def multi_f1_score(results: List[float]) -> float:
    """len * prod / sum (trainer.py:220-224)."""
    return len(results) * functools.reduce(lambda a, b: a * b, results) / sum(results)


def make_adv_fn(attack_name: str, attack_model: nn.Module,
                generator: Optional[torch.Generator] = None) -> Optional[AdvFn]:
    """The registry attack ``attack_name`` on ``attack_model``, in wave space;
    None for NO_ATTACK (no attack function). ``generator`` draws the
    random starts."""
    attack01 = attacks.build_attack(attack_name, attacks.make_logits_fn(attack_model))
    if attack01 is None:
        return None
    in_waves = attacks.attack_in_wave_space(attack01)

    def adv_fn(batch_x: torch.Tensor, batch_y: torch.Tensor) -> torch.Tensor:
        return in_waves(batch_x, batch_y, generator).detach()

    return adv_fn


class AdversarialGDTrainer(GDTrainer):
    """RANDOM strategy base (trainer.py:213-476)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.attacks: List[Tuple[str, Optional[AdvFn]]] = []

    @property
    def needs_batch_loss(self) -> bool:
        """True iff the strategy overrides ``update_adv_attack`` (the base
        hook does nothing): only then is the per-batch loss pulled."""
        return type(self).update_adv_attack is not AdversarialGDTrainer.update_adv_attack

    # -- strategy hooks ----------------------------------------------------
    def init_adv_attacks(self, attack_model: nn.Module, adversarial_attacks: Sequence[str],
                         generator: Optional[torch.Generator] = None):
        self.attacks = [(name, make_adv_fn(name, attack_model, generator))
                        for name in adversarial_attacks]
        LOGGER.info("Adversarial attacks: %s", list(adversarial_attacks))
        return self.attacks

    def apply_adv_attack(self, batch_x: torch.Tensor, batch_y: torch.Tensor) -> torch.Tensor:
        """Attack with probability n / (n + 1), uniform choice (trainer.py:464-473)."""
        if random.random() > 1 / (len(self.attacks) + 1):
            _, adv_fn = self.attacks[random.randint(0, len(self.attacks) - 1)]
            if adv_fn is not None:
                batch_x = adv_fn(batch_x, batch_y)
        return batch_x

    def update_adv_attack(self, batch_loss, batch_pred=None, iter=None, epoch=None,
                          attack_idx=None):
        ...

    # -- main loop ----------------------------------------------------------
    def train(self, dataset, model: nn.Module, attack_model: Optional[nn.Module],
              adversarial_attacks: Sequence[str], test_dataset=None,
              model_dir: Optional[str] = None, save_model_name: Optional[str] = None,
              generator: Optional[torch.Generator] = None) -> nn.Module:
        """Train ``model`` in place on batches attacked by the strategy; return
        it with the best (by ``multi_f1_score``) weights loaded.
        ``attack_model=None`` selects the self-attack on the live model."""
        if test_dataset is None:
            raise ValueError("pass an explicit test split")
        device = model_device(model)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        train_loader, test_loader = self._loaders(dataset, test_dataset)
        state = ts.create_train_state(model, self.optimizer_kwargs, self.use_scheduler,
                                      batches_per_epoch=len(train_loader),
                                      scheduler_t0_epochs=1)  # trainer.py:274 (adv: 1 epoch)
        eval_step = make_eval_step(model)
        self.init_adv_attacks(model if attack_model is None else attack_model,
                              adversarial_attacks, generator)
        # ADAA_EAGER_LOSS_PULL=1: pull each batch's loss before the next
        # batch's attack choice, instead of one batch late
        lag = 0 if os.environ.get("ADAA_EAGER_LOSS_PULL") == "1" else 1

        best, best_score = None, 0.0
        LOGGER.info("Starting adversarial training for %d epochs!", self.epochs)
        for epoch in range(self.epochs):
            LOGGER.info("Epoch num: %d", epoch)
            num_total = 0
            acc = torch.zeros(2, device=device)
            # the adaptive strategies' (device loss, attack index, iter) queue:
            # the loss is pulled one batch late, so the pull waits for a
            # step the card has long finished instead of the one just
            # queued; the EMA update is the reference's, loss for loss
            # (trainer.py:544-557); only batch i+1's choice sees weights
            # through batch i-1
            pending: List[Tuple[torch.Tensor, Optional[int], int]] = []
            for i, batch in enumerate(train_loader):
                batch_x, batch_y = to_device(batch, device)
                batch_x = self.apply_adv_attack(batch_x, batch_y)
                loss = train_step(state, batch_x, batch_y, acc)
                num_total += batch_x.shape[0]
                if i % 100 == 0:
                    ls, nc = acc.tolist()  # a pull at log points only
                    LOGGER.info("[%04d][%05d]: %s %s", epoch, i, ls / num_total,
                                nc / num_total * 100)
                if self.needs_batch_loss:
                    pending.append((loss, getattr(self, "last_adv_attack", None), i))
                    if len(pending) > lag:
                        dloss, idx, pi = pending.pop(0)
                        self.update_adv_attack(float(dloss), iter=pi, epoch=epoch,
                                               attack_idx=idx)
            for dloss, idx, pi in pending:  # the lagged tail
                self.update_adv_attack(float(dloss), iter=pi, epoch=epoch, attack_idx=idx)
            self._log_train_epoch(epoch, acc, num_total)

            test_loss, test_acc, eer_val = self.validation_epoch(eval_step, test_loader, device)
            results = [test_acc / 100]
            LOGGER.info("Epoch [%d/%d]: test/loss: %s, test/accuracy: %s, test/eer: %s",
                        epoch + 1, self.epochs, test_loss, test_acc, eer_val)
            # one adversarial validation per attack, on a freshly shuffled loader
            for attack_name, adv_fn in self.attacks:
                fresh = DataLoader(test_dataset, self.batch_size, shuffle=True, drop_last=True,
                                   num_workers=6)
                adv_loss, adv_acc, adv_eer = self.validation_epoch(eval_step, fresh, device,
                                                                   adv_fn)
                results.append(adv_acc / 100)
                LOGGER.info("Epoch [%d/%d]: adv_test/%s__loss: %s, adv_test/%s__accuracy: %s,"
                            " adv_test/%s__eer: %s.", epoch + 1, self.epochs, attack_name,
                            adv_loss, attack_name, adv_acc, attack_name, adv_eer)

            score = multi_f1_score(results)
            LOGGER.info("[%04d]: multi_f1_score: %s", epoch, score)
            if best is None or score > best_score:
                best_score = score
                best = cpu_state_dict(model)
                LOGGER.info("[%04d]: update best model", epoch)
            if model_dir is not None:
                save_checkpoint(model, model_dir, save_model_name, epoch=epoch)
        model.load_state_dict(best)
        return model


class EqualAdversarialGDTrainer(AdversarialGDTrainer):
    """attacks[0] on a random half of the batch (trainer.py:479-497)."""

    def apply_adv_attack(self, batch_x, batch_y):
        _, adv_fn = self.attacks[0]
        if adv_fn is None:
            return batch_x
        n = batch_x.shape[0]
        idx = torch.as_tensor(random.sample(range(n), n // 2), device=batch_x.device)
        batch_x = batch_x.clone()
        batch_x[idx] = adv_fn(batch_x[idx], batch_y[idx])
        return batch_x


class OnlyOneAdversarialGDTrainer(AdversarialGDTrainer):
    """Always the single configured attack (trainer.py:500-514)."""

    def init_adv_attacks(self, attack_model, adversarial_attacks, generator=None):
        assert len(adversarial_attacks) == 1, "Method allows to apply only one attack"
        return super().init_adv_attacks(attack_model, adversarial_attacks, generator)

    def apply_adv_attack(self, batch_x, batch_y):
        _, adv_fn = self.attacks[0]
        return batch_x if adv_fn is None else adv_fn(batch_x, batch_y)


class AdaptiveAdversarialGDTrainer(AdversarialGDTrainer):
    """Loss-EMA weighted choice over n attacks and a no-attack arm
    (trainer.py:517-557)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.adv_attacks_weights: List[float] = []
        self.last_adv_attack: Optional[int] = None

    def init_adv_attacks(self, attack_model, adversarial_attacks, generator=None):
        out = super().init_adv_attacks(attack_model, adversarial_attacks, generator)
        n = len(self.attacks) + 1
        self.adv_attacks_weights = [1.0 / n] * n
        return out

    def apply_adv_attack(self, batch_x, batch_y):
        (attack_idx,) = random.choices(range(len(self.attacks) + 1),
                                       weights=self.adv_attacks_weights, k=1)
        self.last_adv_attack = attack_idx
        if attack_idx < len(self.attacks):
            _, adv_fn = self.attacks[attack_idx]
            if adv_fn is not None:
                batch_x = adv_fn(batch_x, batch_y)
        return batch_x

    def _ema(self, batch_loss, max_val, proportion_val, attack_idx) -> List[float]:
        """The chosen arm's weight moved toward the (clipped) loss, all normalised."""
        idx = attack_idx if attack_idx is not None else self.last_adv_attack
        w = self.adv_attacks_weights
        w[idx] = proportion_val * min(batch_loss, max_val) + (1 - proportion_val) * w[idx]
        total = float(np.sum(w))
        return [wi / total for wi in w]

    def _log_weights(self, iter, epoch) -> None:
        if iter is not None and iter % 100 == 0:
            LOGGER.info("[%04d][%05d]: Adversarial attack weights: %s", epoch, iter,
                        self.adv_attacks_weights)

    def update_adv_attack(self, batch_loss, batch_pred=None, max_val=1, proportion_val=0.2,
                          iter=None, epoch=None, attack_idx=None):
        w = self._ema(batch_loss, max_val, proportion_val, attack_idx)
        self.adv_attacks_weights = [0.5 * wi + 0.5 * (1.0 / len(w)) for wi in w]
        self._log_weights(iter, epoch)


class AdaptiveV2AdversarialGDTrainer(AdaptiveAdversarialGDTrainer):
    """1/3 no-attack, 2/3 attack-split redistribution (trainer.py:560-581)."""

    def update_adv_attack(self, batch_loss, batch_pred=None, max_val=1, proportion_val=0.2,
                          iter=None, epoch=None, attack_idx=None):
        w = [0.5 * wi for wi in self._ema(batch_loss, max_val, proportion_val, attack_idx)]
        attack_ratio = (2 / 3) / len(self.attacks)
        self.adv_attacks_weights = [wi + 0.5 * (attack_ratio if i < len(w) - 1 else 1 / 3)
                                    for i, wi in enumerate(w)]
        self._log_weights(iter, epoch)


# mirrors AdversarialGDTrainerEnum (src/aa/aa_trainer_types.py:12-17)
ADV_TRAINER_REGISTRY = {
    "ONLY_ADV": OnlyOneAdversarialGDTrainer,
    "RANDOM": AdversarialGDTrainer,
    "ADAPTIVE": AdaptiveAdversarialGDTrainer,
    "ADAPTIVE_V2": AdaptiveV2AdversarialGDTrainer,
    "EQUAL": EqualAdversarialGDTrainer,
}
