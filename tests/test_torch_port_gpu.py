"""The CUDA kernels vs their plain-torch versions, on a CUDA card.

Repeats chip_smoke.py phases 2, 5, 6 and 9 (B=256) and small batches,
and checks that the wrappers launch the kernels for CUDA tensors. It
imports neither jax nor adaa_tpu, so it runs on the card with

    python -m pytest --noconftest tests/test_torch_port_gpu.py -q

(tests/conftest.py imports jax). Without a card every test skips.
Tolerances as chip_smoke.py, each because both sides sum the same
products in f32 in other orders:
* layer 0: forward >= 99.9% bit-equal and all within 1 bf16 ulp,
  winner index >= 99.9% equal, dx relative L2 < 1e-3;
* fused LFCC: atol 5e-4 + rtol 1e-4 (tests/test_pallas_lfcc.py's band);
* trunk segments: forward >= 99.9% bit-equal after the cast to bf16 and
  max abs error <= 1e-4 x max |ref| in f32, dx relative L2 < 3e-3: in
  other summation orders, candidates within an ulp of each other can
  route a whole cotangent to another conv output, a few dozen times at
  B=256 (measured 4.5e-4 to 1.05e-3);
* the f32-highest LCNN's input gradient with default TF32 flags vs TF32
  off globally, cuDNN deterministic in both: relative L2 <= 1e-6 (its
  convs turn TF32 off themselves, forward and backward).
"""
import numpy as np
import pytest
import torch

from adaa_tpu_torch import attacks, models
from adaa_tpu_torch.ops import layer0, lfcc_fused, trunk
from adaa_tpu_torch.utils import set_seed

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


def _randn(seed: int, shape, scale: float = 1.0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [3, 256])
@pytest.mark.parametrize("kind", lfcc_fused.FILTERBANKS)
def test_lfcc_kernel_matches_plain(cuda, b, kind):
    """chip_smoke.py phase 5."""
    x = _randn(b, (b, lfcc_fused.WAVE_LEN)).to(cuda)
    out = lfcc_fused.kernel_forward(x, kind)
    ref = lfcc_fused.reference_forward(x, kind)
    torch.cuda.synchronize()
    assert out.shape == (b, 80, 404) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, atol=5e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [3, 256])
@pytest.mark.parametrize("spec", trunk.SEGMENTS, ids=["A", "B"])
def test_trunk_kernels_match_plain(cuda, b, spec):
    """chip_smoke.py phase 6."""
    am = _randn(b, (b, spec.t, spec.f, spec.c2)).to(cuda)
    wb = _randn(b + 1, (spec.c_out, spec.c2, 3, 3), 1.0 / np.sqrt(9 * spec.c2)).to(cuda)
    bb = _randn(b + 2, (spec.c_out,), 0.1).to(cuda)
    g = _randn(b + 3, (b, spec.t_out, spec.f_out, spec.half)).to(cuda, torch.bfloat16).float()
    y_k, y_r = trunk.kernel_fwd(am, wb, bb, spec), trunk.reference_fwd(am, wb, bb, spec)
    dx_k, dx_r = trunk.kernel_bwd(am, wb, bb, g, spec), trunk.reference_bwd(am, wb, bb, g, spec)
    torch.cuda.synchronize()
    assert float((y_k.to(torch.bfloat16) == y_r.to(torch.bfloat16)).float().mean()) >= 0.999
    assert float((y_k - y_r).abs().max()) <= 1e-4 * float(y_r.abs().max())
    rel = float((dx_k - dx_r).norm() / dx_r.norm())
    assert rel < 3e-3, rel


@pytest.mark.gpu
def test_trunk_kernel_splits_exact_ties_evenly(cuda):
    """All-zero input and bias: every candidate ties, each gets g / 8."""
    spec = trunk.SEGMENT_B
    am = torch.zeros(1, spec.t, spec.f, spec.c2, device=cuda)
    wb = _randn(40, (spec.c_out, spec.c2, 3, 3), 0.06).to(cuda)
    bb = torch.zeros(spec.c_out, device=cuda)
    g = torch.ones(1, spec.t_out, spec.f_out, spec.half, device=cuda)
    dx_k, dx_r = trunk.kernel_bwd(am, wb, bb, g, spec), trunk.reference_bwd(am, wb, bb, g, spec)
    torch.cuda.synchronize()
    assert float(dx_r.abs().max()) > 0
    torch.testing.assert_close(dx_k, dx_r, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_fused_wrappers_launch_kernels(cuda):
    """lfcc_fused and fused_segment launch their kernels (counted) for CUDA
    tensors, forward and backward, and agree with their plain versions."""
    before = (dict(lfcc_fused.LAUNCHES), dict(trunk.LAUNCHES))
    x = _randn(30, (2, lfcc_fused.WAVE_LEN)).to(cuda).requires_grad_(True)
    out = lfcc_fused.lfcc_fused(x)
    (dx,) = torch.autograd.grad(out.sum(), x)
    ref = lfcc_fused.cepstra_fused_reference(x.detach(), "linear")
    torch.testing.assert_close(out.detach(), ref, atol=5e-4, rtol=1e-4)
    assert bool(torch.isfinite(dx).all())
    spec = trunk.SEGMENT_A
    h = _randn(31, (2, spec.t, spec.f, spec.c_in)).to(cuda, torch.bfloat16).requires_grad_(True)
    wa = _randn(32, (spec.c_mid, spec.c_in, 1, 1), 0.2).to(cuda)
    ba = _randn(33, (spec.c_mid,), 0.1).to(cuda)
    wb = _randn(34, (spec.c_out, spec.c2, 3, 3), 0.06).to(cuda)
    bb = _randn(35, (spec.c_out,), 0.1).to(cuda)
    y = trunk.fused_segment(h, wa, ba, wb, bb, spec)
    (dh,) = torch.autograd.grad(y.float().sum(), h)
    assert y.dtype == torch.bfloat16 and dh.dtype == torch.bfloat16
    ref = trunk.fused_segment_reference(h.detach(), wa, ba, wb, bb, spec)
    assert float((y.detach() == ref).float().mean()) >= 0.999
    torch.cuda.synchronize()
    assert lfcc_fused.LAUNCHES["fwd"] == before[0]["fwd"] + 1
    assert trunk.LAUNCHES == {"fwd": before[1]["fwd"] + 1, "bwd": before[1]["bwd"] + 1}


@pytest.mark.gpu
def test_highest_precision_gradient_ignores_tf32(cuda):
    """chip_smoke.py phase 9."""
    cfg = {"input_channels": 1, "frontend_algorithm": ["lfcc"], "precision": "highest"}
    model = models.init_model(models.get_model("lcnn", cfg), set_seed(9), cuda)
    logits_fn = attacks.make_logits_fn(model)
    x01, _, _ = attacks.to_minmax(_randn(9, (4, 64_600)).to(cuda))
    y = torch.tensor([0, 1, 0, 1], device=cuda)

    def grad():
        xx = x01.clone().requires_grad_(True)
        return torch.autograd.grad(attacks.two_class_ce(logits_fn(xx), y), xx)[0]

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        g_default = grad()
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        g_ieee = grad()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        torch.backends.cudnn.deterministic = deterministic
    rel = float((g_default - g_ieee).norm() / g_ieee.norm())
    assert rel <= 1e-6, rel
