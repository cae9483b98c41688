"""Clean gradient-descent trainer (port of ``adaa_tpu/training/gd_trainer.py``).

The reference's GDTrainer (src/trainer.py:36-210): BCE-with-logits
loss, Adam, the cosine warm-restart schedule for RawNet3 only (T_0 = 2
epochs), a test pass per epoch, the best model by test accuracy, and
the reference's log lines (``train/loss``, ``test/accuracy``, ...).

A train step is eager PyTorch: forward in ``train()`` (batch-statistics
BatchNorm, dropout, the sinc filters' gradient; every fused kernel is
eval-only, as in JAX), BCE, backward, Adam. The epoch loops keep their
losses and counts on the device and pull them at log points only: one
pull per log line, one per test epoch.

With a process group whose size divides the batch (``parallel.mesh``),
the model is broadcast from rank 0, each rank steps on its rows of every
batch (``train_step``), the gradients are averaged over ranks and the
logged sums are the global batch's, as the JAX trainer's one program
over a sharded batch computes them; the test passes run whole on every
rank.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adaa_tpu_torch.data.loader import DataLoader
from adaa_tpu_torch.eval.evaluation import eval_mode, model_device
from adaa_tpu_torch.parallel import mesh
from adaa_tpu_torch.training import train_state as ts

LOGGER = logging.getLogger(__name__)

EvalStep = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def bce_with_logits(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """torch.nn.BCEWithLogitsLoss (mean) on (B, 1) logits, (B,) labels."""
    z = logits.squeeze(-1)
    return F.binary_cross_entropy_with_logits(z, y.to(z.dtype))


def predict_label(logits: torch.Tensor) -> torch.Tensor:
    """(sigmoid(z) + .5).int(): the reference's rounding (trainer.py:147)."""
    return (torch.sigmoid(logits.squeeze(-1)) + 0.5).int()


def to_device(batch, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A loader batch's (wave, label) as tensors on ``device``."""
    return torch.from_numpy(batch[0]).to(device), torch.from_numpy(batch[2]).to(device)


def train_step(state: ts.TrainState, batch_x: torch.Tensor, batch_y: torch.Tensor,
               acc: torch.Tensor) -> torch.Tensor:
    """One BCE/Adam step on the global batch (``_step``): on this rank's
    rows, sharded, when a process group's size divides the batch (module
    doc), else on all of it."""
    if not mesh.data_parallel(batch_x.shape[0]):
        return _step(state, batch_x, batch_y, acc)
    with mesh.sharded():
        return _step(state, mesh.shard_batch(batch_x), mesh.shard_batch(batch_y), acc)


def _step(state: ts.TrainState, batch_x: torch.Tensor, batch_y: torch.Tensor,
          acc: torch.Tensor) -> torch.Tensor:
    """One BCE/Adam step of ``state.model`` in ``train()``; the learning rate
    is the schedule's at the 0-based update count, when there is one.
    ``acc`` is a device ``(2,)`` f32 running ``[loss_sum, correct]``,
    updated in place (a per-batch ``float(loss)`` would wait for the card).
    Returns the loss, on the device. The gradients stay in ``.grad``; a
    parameter the forward did not use (SpecRNet's discarded ``bn1``) gets
    a zero gradient, so Adam moves it by its weight decay as optax does.
    Inside ``mesh.sharded()`` the batch is this rank's rows: the gradients
    are averaged over ranks before the step, and ``acc`` and the returned
    loss are the global batch's."""
    model = state.model
    model.train()
    out = model(batch_x)
    loss = bce_with_logits(out, batch_y)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None and p.requires_grad:  # unused in the forward: optax updates it
                p.grad = torch.zeros_like(p)
    shard = mesh.shard_info()
    if shard is not None:
        mesh.average_gradients(p for g in state.optimizer.param_groups for p in g["params"])
    if state.schedule is not None:
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        correct = (predict_label(out) == batch_y).sum()
        sums = torch.stack([loss * batch_y.shape[0], correct.float()])
        if shard is None:
            acc += sums
            return loss.detach()
        sums = mesh.all_reduce_sum(sums)
        acc += sums
        return sums[0] / (batch_y.shape[0] * shard[0])



def make_eval_step(model: nn.Module) -> EvalStep:
    """``(x, y) -> (loss, correct, logits)`` of ``model`` in ``eval()``,
    without gradients; the model's modes are given back."""

    def step(batch_x, batch_y):
        with eval_mode(model), torch.no_grad():
            out = model(batch_x)
        return bce_with_logits(out, batch_y), (predict_label(out) == batch_y).sum(), out

    return step


def reduce_epoch_stats(bszs: Sequence[int], losses: List[torch.Tensor],
                       corrects: List[torch.Tensor], outs: List[torch.Tensor]):
    """The epoch's ``(loss_sum, correct_sum, scores)`` from per-batch device
    values, in one pull (and one more for the scores when ``outs``)."""
    if not losses:
        return 0.0, 0.0, []
    weights = torch.tensor(list(bszs), dtype=torch.float32, device=losses[0].device)
    loss_sum, num_correct = torch.stack(
        [torch.stack(losses) @ weights, torch.stack(corrects).sum().float()]).tolist()
    scores = ([torch.sigmoid(torch.cat(outs).squeeze(-1)).cpu().numpy()] if outs else [])
    return loss_sum, num_correct, scores


def epoch_eer(labels: List[np.ndarray], scores: List[np.ndarray]) -> float:
    """EER on flipped labels (the evaluation's convention); NaN where the
    batches hold one class only."""
    from adaa_tpu_torch.metrics import calculate_eer

    try:
        return calculate_eer(1 - np.concatenate(labels), np.concatenate(scores))[1]
    except (ValueError, ZeroDivisionError):
        return float("nan")


def cpu_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


class GDTrainer:
    """API mirror of the reference's Trainer / GDTrainer (trainer.py:36-65, 74-210)."""

    def __init__(self, epochs: int = 20, batch_size: int = 32,
                 optimizer_kwargs: Optional[Dict[str, Any]] = None,
                 use_scheduler: bool = False, compute_eer: bool = False):
        self.epochs = epochs
        self.batch_size = batch_size
        self.optimizer_kwargs = optimizer_kwargs or {"lr": 1e-3}
        self.use_scheduler = use_scheduler
        # the reference logs a hardcoded test/eer of 0 ("TODO: revert EER
        # support", trainer.py:171, 417); compute_eer=True computes it
        self.compute_eer = compute_eer

    def _loaders(self, dataset, test_dataset) -> Tuple[DataLoader, DataLoader]:
        # the same draws from numpy's global generator as the JAX trainer's
        return (DataLoader(dataset, self.batch_size, shuffle=True, drop_last=True, num_workers=6),
                DataLoader(test_dataset, self.batch_size, shuffle=True, drop_last=True,
                           num_workers=6))

    def _log_train_epoch(self, epoch: int, acc: torch.Tensor, num_total: int) -> None:
        loss_sum, num_correct = acc.tolist()
        LOGGER.info("Epoch [%d/%d]: train/loss: %s, train/accuracy: %s", epoch + 1, self.epochs,
                    loss_sum / max(num_total, 1), num_correct / max(num_total, 1) * 100)

    def train(self, dataset, model: nn.Module, test_dataset=None) -> nn.Module:
        """Train ``model`` in place; return it with the best (by test
        accuracy) weights loaded."""
        if test_dataset is None:
            raise ValueError("pass an explicit test split")
        device = model_device(model)
        mesh.replicate(model)
        train_loader, test_loader = self._loaders(dataset, test_dataset)
        state = ts.create_train_state(model, self.optimizer_kwargs, self.use_scheduler,
                                      batches_per_epoch=len(train_loader),
                                      scheduler_t0_epochs=2)  # trainer.py:118 "every 2nd epoch"
        eval_step = make_eval_step(model)
        best, best_acc = None, 0.0
        LOGGER.info("Starting training for %d epochs!", self.epochs)
        for epoch in range(self.epochs):
            LOGGER.info("Epoch num: %d", epoch)
            num_total = 0
            acc = torch.zeros(2, device=device)
            for i, batch in enumerate(train_loader):
                batch_x, batch_y = to_device(batch, device)
                train_step(state, batch_x, batch_y, acc)
                num_total += batch_x.shape[0]
                if i % 100 == 0:
                    ls, nc = acc.tolist()  # a pull at log points only
                    LOGGER.info("[%04d][%05d]: %s %s", epoch, i, ls / num_total,
                                nc / num_total * 100)
            self._log_train_epoch(epoch, acc, num_total)
            test_loss, test_acc, eer_val = self.validation_epoch(eval_step, test_loader, device)
            LOGGER.info("Epoch [%d/%d]: test/loss: %s, test/accuracy: %s, test/eer: %s",
                        epoch + 1, self.epochs, test_loss, test_acc, eer_val)
            if best is None or test_acc > best_acc:
                best_acc = test_acc
                best = cpu_state_dict(model)
        model.load_state_dict(best)
        return model

    def validation_epoch(self, eval_step: EvalStep, test_loader: DataLoader,
                         device: torch.device,
                         adv_fn: Optional[Callable] = None) -> Tuple[float, float, float]:
        """A clean (``adv_fn`` None) or adversarial test pass: ``(loss,
        accuracy %, eer)``; eer is the reference's placeholder 0 unless
        ``compute_eer``."""
        num_total = 0
        bszs, losses, corrects, outs, labels = [], [], [], [], []
        for batch in test_loader:
            batch_x, batch_y = to_device(batch, device)
            if adv_fn is not None:
                batch_x = adv_fn(batch_x, batch_y)
            loss, correct, out = eval_step(batch_x, batch_y)
            num_total += batch_x.shape[0]
            bszs.append(batch_x.shape[0])
            losses.append(loss)
            corrects.append(correct)
            if self.compute_eer:
                outs.append(out)
                labels.append(batch[2])
        loss_sum, num_correct, scores = reduce_epoch_stats(bszs, losses, corrects, outs)
        num_total = max(num_total, 1)
        eer_val = epoch_eer(labels, scores) if self.compute_eer and scores else 0
        return loss_sum / num_total, 100.0 * num_correct / num_total, eer_val
