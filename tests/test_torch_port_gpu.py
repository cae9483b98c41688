"""The CUDA kernels vs their plain-torch versions, on a CUDA card.

Repeats chip_smoke.py phases 2, 5, 6 and 9 (B=256) and small batches,
phases 10-11 (the pool and b2n kernels) at small batches and phase 17's
stale-weight guard at B=4, and checks that the wrappers launch the
kernels for CUDA tensors. It
imports neither jax nor adaa_tpu, so it runs on the card with

    python -m pytest --noconftest tests/test_torch_port_gpu.py -q

(tests/conftest.py imports jax). Without a card every test skips.
Tolerances as chip_smoke.py, each because both sides sum the same
products in f32 in other orders:
* layer 0: forward >= 99.9% bit-equal and all within 1 bf16 ulp,
  winner index >= 99.9% equal, dx relative L2 < 1e-3 (x in bf16 or f32);
* fused LFCC: atol 5e-4 + rtol 1e-4 (tests/test_pallas_lfcc.py's band);
* trunk segments: forward >= 99.9% bit-equal after the cast to bf16 and
  max abs error <= 1e-4 x max |ref| in f32, tie mask >= 99.9% equal, dx
  relative L2 < 1e-5 against the plain dx of the kernel's own mask (f32
  order only) and, at B=256, < 3e-3 against the plain dx of the plain
  mask: in other summation orders, candidates within an ulp of each other
  can route a whole cotangent to another conv output, a few dozen times
  at B=256 (measured 5.7e-4 to 6.2e-4), which at B=3 alone can reach
  2.6e-3;
* the f32-highest LCNN's input gradient with default TF32 flags vs TF32
  off globally, cuDNN deterministic in both: relative L2 <= 1e-6 (its
  convs turn TF32 off themselves, forward and backward);
* pool: forward and dx bit-equal (first-max routing is deterministic);
* the bf16 self-attack after Adam steps (layer 0 on live weights): its
  packed f32 weights equal the live ones exactly, and the FGSM batch of a
  fresh batch through the kernel equals the plain path's on >= 99% of
  coordinates (a signed step flips only where the gradient is ~0;
  measured 99.9% at B=4 and 99.6% at B=256 on an H100, where the weights
  of before the steps give 50%);
* b2n: y >= 97% bit-equal, y mean relative error <= 1e-4, dx relative
  L2 <= 5e-3 (measured on an H100: 98.4-99.2%, <= 3.4e-5 and <= 1.6e-3
  at B=2 and B=64): an output near a bf16 rounding boundary, or a relu
  decision near zero, can go the other way in another summation order.
"""
import numpy as np
import pytest
import torch

from adaa_tpu_torch import attacks, models
from adaa_tpu_torch.models.rawnet3 import Bottle2neck
from adaa_tpu_torch.ops import b2n, layer0, lfcc_fused, pool, trunk
from adaa_tpu_torch.utils import set_seed

torch.set_num_threads(2)

# b2n kernel vs plain (see the module docstring)
B2N_Y_BIT_EQUAL, B2N_Y_MEAN_REL, B2N_DX_REL_L2 = 0.97, 1e-4, 5e-3


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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b", [1, 2, 3, 256])
def test_kernel_matches_twin(cuda, b, dtype):
    """chip_smoke.py phase 2: the CUDA kernels vs their twin at phase 2's
    bands, TF32 off for the twin; x in bf16 (the model's) and in f32."""
    x, w, bias, cot = _data(b, b)
    xt, wt, bt = (t.to(cuda) for t in _torch_args(x, w, bias))
    xt = xt.to(dtype)
    g = torch.from_numpy(cot).to(cuda, dtype)
    out_k, idx_k = layer0.kernel_fwd(xt, wt, bt, True)
    out_r, idx_r = layer0.reference_fwd(xt, wt, bt, True)
    dx_k = layer0.kernel_bwd(idx_k, g, wt, dtype)
    dx_r = layer0.reference_bwd(idx_r, g, wt, dtype)
    torch.cuda.synchronize()
    assert out_k.dtype == dtype and dx_k.dtype == dtype
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
@pytest.mark.parametrize("b", [1, 3, 256])
@pytest.mark.parametrize("kind", lfcc_fused.FILTERBANKS)
def test_lfcc_kernel_matches_plain(cuda, b, kind):
    """chip_smoke.py phase 5, on waves whose first and last 300 samples are
    20x larger, so that the frames the kernel reflects carry the largest
    values."""
    x = _randn(b, (b, lfcc_fused.WAVE_LEN))
    x[:, :300] *= 20.0
    x[:, -300:] *= 20.0
    x = x.to(cuda)
    out = lfcc_fused.kernel_forward(x, kind)
    ref = lfcc_fused.reference_forward(x, kind)
    torch.cuda.synchronize()
    assert out.shape == (b, 80, 404) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, atol=5e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2, 3, 256])
@pytest.mark.parametrize("spec", trunk.SEGMENTS, ids=["A", "B"])
def test_trunk_kernels_match_plain(cuda, b, spec):
    """chip_smoke.py phase 6, and batches of one to three tiles' worth of
    samples: the forward and its tie mask against the plain ones, the dx
    kernel against the plain dx of the same mask (f32 order only) and
    against the plain dx of the plain mask (chip_smoke.py's band)."""
    am = _randn(b, (b, spec.t, spec.f, spec.c2)).to(cuda)
    wb = _randn(b + 1, (spec.c_out, spec.c2, 3, 3), 1.0 / np.sqrt(9 * spec.c2)).to(cuda)
    bb = _randn(b + 2, (spec.c_out,), 0.1).to(cuda)
    g = _randn(b + 3, (b, spec.t_out, spec.f_out, spec.half)).to(cuda, torch.bfloat16).float()
    y_k, m_k = trunk.kernel_fwd(am, wb, bb, spec, True)
    y_r = trunk.reference_fwd(am, wb, bb, spec)
    m_r = trunk.reference_mask(am, wb, bb, spec)
    dx_k = trunk.kernel_bwd(m_k, g, wb, spec)
    torch.cuda.synchronize()
    assert float((y_k.to(torch.bfloat16) == y_r.to(torch.bfloat16)).float().mean()) >= 0.999
    assert float((y_k - y_r).abs().max()) <= 1e-4 * float(y_r.abs().max())
    assert float((m_k == m_r).float().mean()) >= 0.999
    dx_same = trunk.reference_dx(m_k, g, wb, spec)
    assert float((dx_k - dx_same).norm() / dx_same.norm()) < 1e-5
    dx_r = trunk.reference_bwd(am, wb, bb, g, spec)
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
    _, mask = trunk.kernel_fwd(am, wb, bb, spec, True)
    dx_k, dx_r = trunk.kernel_bwd(mask, g, wb, spec), trunk.reference_bwd(am, wb, bb, g, spec)
    torch.cuda.synchronize()
    assert bool((mask == 255).all())
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


# --------------------------------------------------------------------------
# RawNet3: the pool and b2n kernels
# --------------------------------------------------------------------------

def _bf16_ties(seed: int, shape) -> torch.Tensor:
    """bf16 data on a coarse grid, so windows hold exact ties."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-4, 5, shape).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,window", [((3, 37, 1024), 5), ((2, 31, 1024), 3),
                                          ((2, 13, 20), 4), ((1, 5, 8), 5)])
def test_pool_kernels_match_plain(cuda, shape, window):
    """chip_smoke.py's pool phase at small shapes, with ties, tails and a
    channel count off the 16-byte path: forward and dx bit-equal."""
    for x in (_randn(shape[1], shape).to(torch.bfloat16), _bf16_ties(shape[1], shape)):
        x = x.to(cuda)
        g = _randn(7, (shape[0], shape[1] // window, shape[2])).to(cuda, torch.bfloat16)
        torch.testing.assert_close(pool.kernel_fwd(x, window), pool.reference_fwd(x, window),
                                   rtol=0, atol=0)
        torch.testing.assert_close(pool.kernel_bwd(x, g, window),
                                   pool.reference_bwd(x, g, window), rtol=0, atol=0)


@pytest.mark.gpu
def test_pool_wrapper_launches_kernels(cuda):
    x = _randn(3, (2, 40, 1024)).to(cuda, torch.bfloat16).requires_grad_(True)
    before = dict(pool.LAUNCHES)
    y = pool.max_pool_1d(x, 5)
    (dx,) = torch.autograd.grad(y.float().sum(), x)
    torch.cuda.synchronize()
    assert pool.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    assert int((dx != 0).sum()) == y.numel()  # one slot per window


def b2n_block(cin: int, dilation: int, pool_size: int, seed: int, device) -> torch.nn.Module:
    """A RawNet3 block with random weights, biases and BN statistics."""
    blk = Bottle2neck(cin, 1024, dilation, pool_size)
    blk.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for bn in (blk.bn1, blk.bn3, *blk.bns):
            n = bn.num_features
            bn.running_mean.copy_(torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)))
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32)))
        for conv in (blk.conv1, blk.conv3, *blk.convs):
            conv.bias.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, conv.bias.shape).astype(np.float32)))
    return blk.to(device).eval()


B2N_CASES = [(256, 2, 5), (1024, 3, 3), (1024, 4, 0)]  # RawNet3's layers 1, 2, 3


def b2n_compare(x, dy, p, dilation):
    """Kernel vs plain on one input: (y bit-equal share, y mean relative
    error, dx relative L2)."""
    y_k, o_k, masks = b2n.kernel_fwd(x, p, dilation)
    y_r, o_r = b2n.reference_fwd(x, p, dilation)
    dx_k = b2n.kernel_bwd(dy, o_k, masks, p, dilation, x.shape[2])
    dx_r = b2n.reference_bwd(x, dy, o_r, p, dilation)
    torch.cuda.synchronize()
    yk, yr = y_k.float(), y_r.float()
    return (float((y_k == y_r).float().mean()),
            float((yk - yr).abs().mean() / yr.abs().mean()),
            float((dx_k.float() - dx_r.float()).norm() / dx_r.float().norm()))


@pytest.mark.gpu
@pytest.mark.parametrize("cin,dilation,pool_size", B2N_CASES)
@pytest.mark.parametrize("t", [480, 1287])
def test_b2n_kernels_match_plain(cuda, cin, dilation, pool_size, t):
    """chip_smoke.py's b2n phase at B=2, several time tiles and both edges."""
    blk = b2n_block(cin, dilation, pool_size, 40 + dilation, cuda)
    x = (_randn(t, (2, t, cin)) * 0.3).to(cuda, torch.bfloat16)
    dy = _randn(t + 1, (2, t, 1024)).to(cuda, torch.bfloat16)
    y_eq, y_rel, dx_rel = b2n_compare(x, dy, blk.folded(), dilation)
    assert y_eq >= B2N_Y_BIT_EQUAL and y_rel <= B2N_Y_MEAN_REL and dx_rel <= B2N_DX_REL_L2


def b2n_edge_length(dilation: int, edge: str) -> int:
    """A sequence length at an edge of the chain kernel's regions: shorter
    than one region's central rows, one row past a region, or one partial
    region after a whole one."""
    c = b2n.chain_plan(dilation, 1).central
    return {"short": c // 2, "one_past": c + 1, "partial": 2 * c - 5}[edge]


@pytest.mark.gpu
@pytest.mark.parametrize("cin,dilation,pool_size", B2N_CASES)
@pytest.mark.parametrize("edge", ["short", "one_past", "partial"])
@pytest.mark.parametrize("b", [1, 2])
def test_b2n_kernels_edge_lengths(cuda, cin, dilation, pool_size, edge, b):
    """The kernels at sequence lengths on the chain regions' edges (and M
    not a multiple of the GEMM's 128-row tile), B=1 and B=2."""
    t = b2n_edge_length(dilation, edge)
    blk = b2n_block(cin, dilation, pool_size, 70 + dilation, cuda)
    x = (_randn(t + b, (b, t, cin)) * 0.3).to(cuda, torch.bfloat16)
    dy = _randn(t + b + 1, (b, t, 1024)).to(cuda, torch.bfloat16)
    y_eq, y_rel, dx_rel = b2n_compare(x, dy, blk.folded(), dilation)
    assert y_eq >= B2N_Y_BIT_EQUAL and y_rel <= B2N_Y_MEAN_REL and dx_rel <= B2N_DX_REL_L2


@pytest.mark.gpu
def test_b2n_wrapper_launches_kernels(cuda):
    blk = b2n_block(256, 2, 5, 50, cuda)
    p = blk.folded()
    x = (_randn(51, (2, 480, 256)) * 0.3).to(cuda, torch.bfloat16).requires_grad_(True)
    before = dict(b2n.LAUNCHES)
    out = b2n.fused_bottle2neck(x, p, 2, 5)
    (dx,) = torch.autograd.grad(out.float().sum(), x)
    ref = b2n.fused_bottle2neck_reference(x.detach(), p, 2, 5)
    torch.cuda.synchronize()
    assert out.shape == (2, 96, 1024) and dx.shape == x.shape and bool(torch.isfinite(dx).all())
    assert float((out == ref).float().mean()) >= B2N_Y_BIT_EQUAL
    assert b2n.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}


@pytest.mark.gpu
def test_self_attack_after_optimizer_steps_matches_plain(cuda):
    """chip_smoke.py phase 17's stale-weight guard at B=4: after three
    adversarial-training steps the layer-0 kernel runs on the live weights."""
    from adaa_tpu_torch import bench

    path = bench.setup_train(4, seed=3, device="cuda")
    model = path.state.model
    w = model.m_transform["0"].weight
    first = w.detach().clone()
    for _ in range(3):
        bench.adv_train_step(path)
    assert not torch.equal(w.detach(), first)
    assert torch.equal(layer0.packed_weights(w.detach())[2], w.detach().float())
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 64_600)).astype(
        np.float32)).to(cuda)  # a fresh batch, as the next step's attack sees
    layer0.LAUNCHES.update(fwd=0, bwd=0)
    adv_kernel = path.adv_fn(x, path.y)
    assert layer0.LAUNCHES == {"fwd": 1, "bwd": 1}
    model.plain_ops = True
    adv_plain = path.adv_fn(x, path.y)
    model.plain_ops = False
    assert float((adv_kernel == adv_plain).float().mean()) >= 0.99
