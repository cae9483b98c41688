"""A dry run of the data-parallel paths on tiny shapes (the twin of
``__graft_entry__.py:dryrun_multichip``).

``dryrun_multichip(n)`` runs in each of the ``n`` processes of a group
(``mesh.initialize_multihost``), or alone with ``n == 1``, when it forms
a one-process group on a free localhost port (NCCL on the card, gloo on
the CPU) and closes it at the end:

1. one adversarial-training step of the bf16 LCNN+LFCC on 8,000-sample
   waves, batch 2n: the registry's PGD (eps 5e-4, 10 steps) self-attack
   on the live weights, each rank attacking its rows, then the BCE/Adam
   update on its rows with averaged gradients and global BN statistics;
2. ``generate_attacks("FGSM_eps001")`` white-box on a synthetic set of
   4n items, sharded per batch.

It checks a finite loss and a finite accuracy and prints one line for
each, naming the group's backend and the rank's device.

    python -m adaa_tpu_torch.parallel.dryrun [N] [--cpu]

starts N processes (by default one per visible card), one card each, on
an NCCL group over a free localhost port, and runs the dry run in each;
it refuses to start without a card unless ``--cpu`` is given, which runs
the N processes on the CPU over gloo.
``python -m adaa_tpu_torch.parallel.dryrun 1 2N`` runs the same global
batch in one process, whose loss and report the N ranks should
reproduce.
"""
from __future__ import annotations

import argparse
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

FLAGSHIP = {"input_channels": 1, "frontend_algorithm": ["lfcc"], "compute_dtype": "bfloat16"}
WAVE_LENGTH = 8_000  # tiny shapes for the dry run


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _say(line: str) -> None:
    """One line in one write, so the ranks' lines on a shared pipe do not
    run into each other (``print`` writes the newline apart)."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def dryrun_multichip(n_devices: int, batch: int = 0, cpu: bool = False) -> dict:
    """The dry run in this process (module doc); ``batch`` (default 2n)
    lets one process run the global batch of an n-process run, to compare.
    It runs on this rank's card, or on the CPU with ``cpu``, and refuses a
    group whose backend does not fit that device. Returns the backend, the
    device's name, the loss and the report."""
    from adaa_tpu_torch import attacks, models
    from adaa_tpu_torch.data.synthetic import SyntheticDataset
    from adaa_tpu_torch.eval.adv_evaluation import generate_attacks
    from adaa_tpu_torch.parallel import mesh
    from adaa_tpu_torch.scripts._common import device_for
    from adaa_tpu_torch.training import train_state
    from adaa_tpu_torch.training.gd_trainer import train_step
    from adaa_tpu_torch.utils import set_seed

    device_for(cpu)  # no card and no --cpu: refuse
    backend = "gloo" if cpu else "nccl"
    own_group = not dist.is_initialized()
    if own_group:
        if n_devices != 1:
            raise ValueError(f"dryrun_multichip({n_devices}) runs in each process of a group "
                             "of that size (mesh.initialize_multihost)")
        mesh.initialize_multihost(f"localhost:{_free_port()}", 1, 0, backend=backend)
    try:
        size, rank = mesh.world()
        if size != n_devices:
            raise ValueError(f"the process group has {size} processes, not {n_devices}")
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, "
                             f"not {backend} for {'the CPU' if cpu else 'the card'}")
        device = "cpu" if cpu else f"cuda:{torch.cuda.current_device()}"
        name = "cpu" if cpu else torch.cuda.get_device_name(torch.cuda.current_device())
        where = f"backend {backend}, device {name}"
        batch = batch or 2 * n_devices
        gen = set_seed(0, device)
        model = models.init_model(models.get_model("lcnn", FLAGSHIP), gen, device)
        mesh.replicate(model)
        state = train_state.create_train_state(model, {"lr": 1e-4})
        attack = mesh.data_parallel_attack_fn(attacks.attack_in_wave_space(
            attacks.build_attack("PGD", attacks.make_logits_fn(model))))
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((batch, WAVE_LENGTH)).astype(np.float32))
        y = torch.from_numpy((np.arange(batch) % 2).astype(np.int32))
        x, y = x.to(device), y.to(device)
        adv = attack(x, y.long(), gen).detach()
        loss = float(train_step(state, adv, y, torch.zeros(2, device=device)))
        if not np.isfinite(loss):
            raise AssertionError("dryrun produced a non-finite loss")
        _say(f"dryrun_multichip({n_devices}) ok: rank {rank}, loss={loss:.6f} ({where})")

        dataset = SyntheticDataset(n=2 * batch, subset="test", wave_length=WAVE_LENGTH)
        report = generate_attacks(model, dataset, attack_name="FGSM_eps001", attack_model=model,
                                  batch_size=batch,
                                  generator=torch.Generator(device=device).manual_seed(1))
        if not np.isfinite(report["accuracy"]):
            raise AssertionError("sharded eval produced NaN")
        _say(f"dryrun_multichip({n_devices}) eval ok: rank {rank}, "
             f"acc={report['accuracy']:.3f} eer={report['eer']:.6f} ({where})")
        return {"backend": backend, "device": name, "loss": loss,
                "accuracy": float(report["accuracy"]), "eer": float(report["eer"])}
    finally:
        if own_group:
            dist.destroy_process_group()


def _rank(rank: int, n_devices: int, addr: str, cpu: bool) -> None:
    from adaa_tpu_torch.parallel import mesh

    mesh.initialize_multihost(addr, n_devices, rank, backend="gloo" if cpu else "nccl")
    try:
        dryrun_multichip(n_devices, cpu=cpu)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    from adaa_tpu_torch.scripts._common import device_for

    parser = argparse.ArgumentParser(description="Data-parallel dry run on N processes")
    parser.add_argument("n", type=int, nargs="?", default=None,
                        help="processes (default: one per visible card)")
    parser.add_argument("batch", type=int, nargs="?", default=0,
                        help="global batch (default 2N)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU over gloo")
    args = parser.parse_args(argv)
    device_for(args.cpu)  # no card and no --cpu: refuse
    n = args.n if args.n is not None else 1 if args.cpu else torch.cuda.device_count()
    if n == 1:
        dryrun_multichip(1, args.batch, cpu=args.cpu)
        return
    torch.multiprocessing.spawn(_rank, args=(n, f"localhost:{_free_port()}", args.cpu), nprocs=n)


if __name__ == "__main__":
    main()
