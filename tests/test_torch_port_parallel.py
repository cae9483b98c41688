"""Data parallelism in the port (``adaa_tpu_torch/parallel``) on the CPU:
a two-process gloo group over a localhost address, started as
``tests/test_multihost.py`` starts its cluster, against the same cases
run in one process (``tests/torch_port_parallel_worker.py``).

The JAX package runs one program over the sharded global batch; the port
runs each rank on its rows, with the global batch's random draws, BN
statistics and averaged gradients, so the two-process run is held to the
single-process one:
* PGD-10 (random start) on the f32 LCNN: the adversarial batch equal;
* one train step of the f32 LCNN with train-mode BN and dropout 0.7:
  loss and logged sums within 1e-6 relative, every gradient within 1e-5
  of its largest magnitude, every running statistic within 1e-6 (the
  ranks sum their halves in another order than one process sums the
  whole);
* ``evaluate_nn``: the same report;
* ``dryrun_multichip(2, cpu=True)`` prints both of its lines on each
  rank, naming gloo and the CPU; its entry point (``python -m
  adaa_tpu_torch.parallel.dryrun 2 --cpu``) spawns two ranks whose loss
  is one process's on the same global batch within 1e-5 relative, with
  the same evaluation report; without a card and without ``--cpu`` it
  refuses to start;
* ``initialize_multihost`` without a coordinator returns 1 and starts no
  group.
"""
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from adaa_tpu_torch.parallel import mesh
from tests import torch_port_parallel_worker as worker

REPO = Path(__file__).resolve().parents[1]
SIZE = 2


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    addr = f"localhost:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests/torch_port_parallel_worker.py"),
                               str(rank), str(SIZE), addr, str(out)], cwd=REPO,
                              env={**os.environ, "PYTHONPATH": str(REPO)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(SIZE)]
    logs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=300)
            logs.append(stdout + stderr)
            assert p.returncode == 0, stderr[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(SIZE)], logs


def test_sharded_pgd10_equals_single_process(cluster):
    results, _ = cluster
    want = worker.pgd_case(False)
    for r in results:
        np.testing.assert_array_equal(r["pgd"], want)


def test_sharded_train_step_equals_single_process(cluster):
    results, _ = cluster
    want = worker.train_case()
    for r in results:
        got = {k[len("train/"):]: v for k, v in r.items() if k.startswith("train/")}
        assert set(got) == set(want)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["acc"], want["acc"], rtol=1e-6)
        grads = [k for k in want if k.startswith("grad/")]
        scale = max(np.abs(want[k]).max() for k in grads)
        for k in grads:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * scale, err_msg=k)
        for k in want:
            if k.startswith("stat/"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_sharded_evaluate_nn_equals_unsharded(cluster):
    results, _ = cluster
    want = worker.eval_case()
    for r in results:
        got = {k[len("eval/"):]: float(v) for k, v in r.items() if k.startswith("eval/")}
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, nan_ok=True, abs=1e-12), k


def test_dryrun_multichip_runs_on_two_processes(cluster):
    _, logs = cluster
    for rank, log in enumerate(logs):
        for line in (f"dryrun_multichip(2) ok: rank {rank}",
                     f"dryrun_multichip(2) eval ok: rank {rank}"):
            assert re.search(re.escape(line) + r".*\(backend gloo, device cpu\)", log), line


def test_initialize_multihost_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("ADAA_COORDINATOR", raising=False)
    assert mesh.initialize_multihost() == 1
    assert not torch.distributed.is_initialized()
    assert mesh.world() == (1, 0) and not mesh.data_parallel(4)


def _dryrun(*argv):
    out = subprocess.run([sys.executable, "-m", "adaa_tpu_torch.parallel.dryrun", *argv],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    losses = [float(v) for v in re.findall(r"ok: rank \d+, loss=(\S+)", out.stdout)]
    reports = re.findall(r"eval ok: rank \d+, (acc=\S+ eer=\S+)", out.stdout)
    return losses, reports


def test_dryrun_entry_point_matches_one_process():
    losses, reports = _dryrun("2", "--cpu")
    want_loss, want_report = _dryrun("1", "4", "--cpu")
    assert len(losses) == len(reports) == SIZE and len(want_loss) == 1
    assert all(loss == pytest.approx(want_loss[0], rel=1e-5) for loss in losses)
    assert set(reports) == set(want_report)


def test_dryrun_entry_point_refuses_without_card_or_cpu(monkeypatch):
    from adaa_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        dryrun.main(["1"])
    with pytest.raises(SystemExit, match="--cpu"):
        dryrun.dryrun_multichip(1)
    assert not torch.distributed.is_initialized()
