"""The cases of ``tests/test_torch_port_parallel.py``, run alone (the
single-process reference) or, as ``__main__``, in each process of a gloo
group: ``python tests/torch_port_parallel_worker.py RANK SIZE HOST:PORT OUT``
writes this rank's results to ``OUT/rank{RANK}.npz``.

Every case starts from ``set_seed``, so the reference and each rank hold
the same weights, batches and generator states.
"""
import sys
from pathlib import Path

import numpy as np
import torch

CFG = {"input_channels": 1, "frontend_algorithm": ["lfcc"]}  # the f32 LCNN
BATCH, LENGTH = 4, 16_000


def _model(seed: int = 0):
    from adaa_tpu_torch import models
    from adaa_tpu_torch.utils import set_seed

    gen = set_seed(seed, "cpu")
    return models.init_model(models.get_model("lcnn", CFG), gen, "cpu"), gen


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((BATCH, LENGTH)).astype(np.float32))
    return x, torch.from_numpy((np.arange(BATCH) % 2).astype(np.int64))


def pgd_case(sharded: bool) -> np.ndarray:
    """The registry's PGD-10 (random start) on the f32 LCNN."""
    from adaa_tpu_torch import attacks
    from adaa_tpu_torch.parallel import mesh

    model, _ = _model()
    model.eval().requires_grad_(False)
    attack = attacks.attack_in_wave_space(attacks.build_attack("PGD",
                                                               attacks.make_logits_fn(model)))
    if sharded:
        attack = mesh.data_parallel_attack_fn(attack)
    x, y = _batch(1)
    return attack(x, y, torch.Generator().manual_seed(5)).numpy()


def train_case() -> dict:
    """One train step of the f32 LCNN (BN batch statistics, dropout 0.7)
    over the global batch (sharded when a group is live): loss, gradients
    and running statistics."""
    from adaa_tpu_torch.training import gd_trainer, train_state

    model, _ = _model()
    state = train_state.create_train_state(model, {"lr": 1e-4})
    x, y = _batch(2)
    torch.manual_seed(11)  # the dropout draws
    acc = torch.zeros(2)
    loss = gd_trainer.train_step(state, x, y.int(), acc)
    out = {"loss": np.float32(loss), "acc": acc.numpy()}
    out.update({f"grad/{k}": p.grad.numpy() for k, p in model.named_parameters()})
    out.update({f"stat/{k}": v.numpy() for k, v in model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))})
    return out


def eval_case() -> dict:
    """``evaluate_nn`` of the f32 LCNN on a synthetic set, batch 4."""
    from adaa_tpu_torch.data.synthetic import SyntheticDataset
    from adaa_tpu_torch.eval.evaluation import evaluate_nn

    model, _ = _model(3)
    return evaluate_nn(model, SyntheticDataset(n=8, subset="val", wave_length=LENGTH),
                       batch_size=BATCH)


def main(rank: int, size: int, addr: str, out: Path) -> None:
    from adaa_tpu_torch.parallel import mesh
    from adaa_tpu_torch.parallel.dryrun import dryrun_multichip

    torch.set_num_threads(2)
    assert mesh.initialize_multihost(addr, size, rank) == size
    results = {"pgd": pgd_case(True)}
    results.update({f"train/{k}": v for k, v in train_case().items()})
    results.update({f"eval/{k}": np.float64(v) for k, v in eval_case().items()})
    dryrun_multichip(size, cpu=True)
    np.savez(out / f"rank{rank}.npz", **results)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
