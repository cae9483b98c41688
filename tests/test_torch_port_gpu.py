"""The layer-0 CUDA kernel vs its plain-torch twin, on a CUDA card.

Repeats chip_smoke.py phase 2 (B=256) and a small batch, and checks
that the wrapper launches the kernel for CUDA tensors. It imports
neither jax nor adaa_tpu, so it runs on the card with

    python -m pytest --noconftest tests/test_torch_port_gpu.py -q

(tests/conftest.py imports jax). Without a card every test skips.
Tolerances as chip_smoke.py: forward >= 99.9% bit-equal and all within
1 bf16 ulp, winner index >= 99.9% equal, dx relative L2 < 1e-3 (both
sum exact bf16 products in f32, in other orders).
"""
import numpy as np
import pytest
import torch

from adaa_tpu_torch.ops import layer0

torch.set_num_threads(2)


def _data(seed: int, b: int):
    """x (B, 404, 80), HWIO weights, bias and a cotangent for the layer-0 op."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 404, 80)).astype(np.float32)
    w_hwio = (rng.standard_normal((5, 5, 1, 64)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(64) * 0.1).astype(np.float32)
    cot = rng.standard_normal((b, 202, 40, 32)).astype(np.float32)
    return x, w_hwio, bias, cot


def _torch_args(x, w_hwio, bias):
    """The port's arguments: bf16 x, OIHW weights, bias."""
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy())  # HWIO -> OIHW
    return xt, wt, torch.from_numpy(bias)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc): the layer-0 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [3, 256])
def test_kernel_matches_twin(cuda, b):
    """chip_smoke.py phase 2: the CUDA kernel vs its twin, TF32 off for the twin."""
    x, w, bias, cot = _data(b, b)
    xt, wt, bt = (t.to(cuda) for t in _torch_args(x, w, bias))
    g = torch.from_numpy(cot).to(cuda, torch.bfloat16)
    out_k, idx_k = layer0.kernel_fwd(xt, wt, bt, True)
    out_r, idx_r = layer0.reference_fwd(xt, wt, bt, True)
    dx_k = layer0.kernel_bwd(idx_k, g, wt, torch.bfloat16)
    dx_r = layer0.reference_bwd(idx_r, g, wt, torch.bfloat16)
    torch.cuda.synchronize()
    ulp = layer0.bf16_ulp_distance(out_k, out_r)
    assert float((ulp == 0).float().mean()) >= 0.999 and int(ulp.max()) <= 1
    assert float((idx_k == idx_r).float().mean()) >= 0.999
    rel = float((dx_k.float() - dx_r.float()).norm() / dx_r.float().norm())
    assert rel < 1e-3, rel


@pytest.mark.gpu
def test_kernel_autograd_and_f32_input(cuda):
    """The wrapper launches the kernel for CUDA tensors (counted), f32 x too."""
    x, w, bias, cot = _data(5, 2)
    xt, wt, bt = (t.to(cuda) for t in _torch_args(x, w, bias))
    before = dict(layer0.LAUNCHES)
    for dtype in (torch.bfloat16, torch.float32):
        xd = xt.to(dtype).requires_grad_(True)
        out = layer0.fused_conv0_mfm_pool(xd, wt, bt)
        (dx,) = torch.autograd.grad(out, xd, torch.from_numpy(cot).to(cuda, dtype))
        ref = layer0.fused_conv0_mfm_pool_reference(xd.detach(), wt, bt)
        assert out.dtype == dtype and dx.dtype == dtype
        err = float((out.detach().float() - ref.float()).abs().max())
        assert err <= 1e-2 * float(ref.abs().max())
    torch.cuda.synchronize()
    assert layer0.LAUNCHES["fwd"] == before["fwd"] + 2
    assert layer0.LAUNCHES["bwd"] == before["bwd"] + 2
