"""The fused LCNN first block: plain-torch twin vs the Pallas kernel
(the CUDA kernel vs the twin is tests/test_torch_port_gpu.py).

On the CPU the port's op runs its twin; the JAX op runs its Pallas
kernel in interpret mode, as tests/test_pallas_layer0.py runs it.

Tolerances (bf16 x, as on the model's path):
* forward: >= 99.9% of outputs bit-equal and all within 1 bf16 ulp —
  both sum the same 25 exact bf16 products in f32, in other orders, and
  round once to bf16;
* dx: relative L2 error < 1e-3 — both route the bf16 cotangent to the
  lowest-index winner; they differ only in the f32 summation order and
  where a near-tie picks another winner.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adaa_tpu.ops import pallas_layer0 as pk
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




@pytest.mark.parametrize("b", [2, 3])
def test_twin_matches_pallas_kernel(b):
    x, w, bias, cot = _data(b, b)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    jout, jvjp = jax.vjp(
        lambda xx: pk.fused_conv0_mfm_pool(xx, jnp.asarray(w), jnp.asarray(bias), True, False),
        xj,
    )
    (jdx,) = jvjp(jnp.asarray(cot).astype(jnp.bfloat16))

    xt, wt, bt = _torch_args(x, w, bias)
    xt.requires_grad_(True)
    out = layer0.fused_conv0_mfm_pool(xt, wt, bt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(cot).to(torch.bfloat16))

    assert out.shape == (b, 202, 40, 32) and out.dtype == torch.bfloat16
    assert dx.shape == (b, 404, 80) and dx.dtype == torch.bfloat16
    jout_t = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    ulp = layer0.bf16_ulp_distance(out, jout_t)
    assert float((ulp == 0).float().mean()) >= 0.999
    assert int(ulp.max()) <= 1
    jdx_np = np.asarray(jdx.astype(jnp.float32))
    rel = np.linalg.norm(dx.float().numpy() - jdx_np) / np.linalg.norm(jdx_np)
    assert rel < 1e-3, rel


def test_twin_equals_unfused_block_and_lowest_winner():
    """Twin forward == conv -> MFM -> pool exactly (maxima do not depend on
    order), and the index names the lowest candidate equal to the max."""
    x, w, bias, _ = _data(7, 2)
    xt, wt, bt = _torch_args(x, w, bias)
    out, idx = layer0.reference_fwd(xt.float(), wt, bt, True)
    y = F.conv2d(xt.float()[:, None], wt.to(torch.bfloat16).float(), bt, padding=2)
    y = torch.maximum(y[:, :32], y[:, 32:])
    plain = F.max_pool2d(y, 2).permute(0, 2, 3, 1)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    # tie-breaking on exact ties: all-zero input and weights -> every candidate equal
    z = torch.zeros(1, 404, 80)
    _, idx0 = layer0.reference_fwd(z, torch.zeros(64, 1, 5, 5), torch.zeros(64), True)
    assert int(idx0.max()) == 0
    assert idx.dtype == torch.uint8 and int(idx.max()) <= 7


def test_cpu_wrapper_runs_twin_without_launches():
    x, w, bias, _ = _data(9, 2)
    xt, wt, bt = _torch_args(x, w, bias)
    before = dict(layer0.LAUNCHES)
    out = layer0.fused_conv0_mfm_pool(xt, wt, bt)
    ref = layer0.fused_conv0_mfm_pool_reference(xt, wt, bt)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert layer0.LAUNCHES == before


def test_weight_gradient_raises():
    x, w, bias, _ = _data(11, 2)
    xt, wt, bt = _torch_args(x, w, bias)
    out = layer0.fused_conv0_mfm_pool(xt.requires_grad_(True), wt.requires_grad_(True), bt)
    with pytest.raises(RuntimeError, match="need_dw=False"):
        out.float().sum().backward()
    with pytest.raises(NotImplementedError):
        layer0.fused_conv0_mfm_pool(xt, wt.detach(), bt, need_dw=True)
    with pytest.raises(ValueError):
        layer0.fused_conv0_mfm_pool(xt[:, :400], wt.detach(), bt)


def test_bf16_ulp_distance():
    a = torch.tensor([1.0, -1.0, 0.0, 2.0, -0.0], dtype=torch.bfloat16)
    up = a.view(torch.int16) + torch.tensor([1, -1, 1, 1, 0], dtype=torch.int16)
    assert layer0.bf16_ulp_distance(a, a).tolist() == [0, 0, 0, 0, 0]
    assert layer0.bf16_ulp_distance(a, up.view(torch.bfloat16)).tolist() == [1, 1, 1, 1, 0]
    assert int(layer0.bf16_ulp_distance(torch.tensor([-0.0]), torch.tensor([0.0]))) == 0
