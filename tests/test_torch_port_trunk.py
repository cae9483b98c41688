"""The fused LCNN trunk segments: plain-torch version vs the Pallas kernel
(the CUDA kernels vs the plain version is tests/test_torch_port_gpu.py).

On the CPU the port's op runs its plain version; the JAX op runs its
Pallas kernels in interpret mode, as tests/test_pallas_trunk.py runs
them, at B=2 and the segments' full spatial size.

Tolerances (bf16 x, as on the model's path):
* forward: >= 99.9% of outputs bit-equal and max abs error <= 4e-3 x
  max |out| (measured <= 2.5e-3 over 4 inputs): both sum the same exact
  bf16 products in f32 in other orders, but the conv1x1's f32 output is
  rounded to bf16 again where the conv3x3 loads it, so an order
  difference can flip that rounding and move an output by about one
  bf16 ulp of the largest outputs (up to 4 ulp of a small one);
* dx: relative L2 error < 1e-3; both split the cotangent evenly over
  tied candidates in bf16 and differ only in f32 summation order and
  where a near-tie changes the winners;
* the crafted exact-tie input: forward equal, dx relative L2 < 1e-4
  (measured 3.5e-5): every tie is exact on both sides, so only the
  summation order remains, which flips the last bit of a few bf16 dx
  values; sending the whole cotangent to every tie would be off by 7x;
* the kernels' packed weights, combined as the CUDA kernels combine
  them: equal to the plain version within 1e-5 (f32 order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adaa_tpu.ops import pallas_trunk as pk
from adaa_tpu_torch.ops import layer0, trunk

torch.set_num_threads(2)


def _data(seed: int, spec, b: int = 2):
    """x, HWIO weights and biases, and a cotangent for one segment."""
    rng = np.random.default_rng(seed)

    def uni(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    x = rng.standard_normal((b, spec.t, spec.f, spec.c_in)).astype(np.float32)
    wa = uni((1, 1, spec.c_in, spec.c_mid), 1 / np.sqrt(spec.c_in))
    ba = uni((spec.c_mid,), 0.1)
    wb = uni((3, 3, spec.c2, spec.c_out), 1 / np.sqrt(9 * spec.c2))
    bb = uni((spec.c_out,), 0.1)
    cot = rng.standard_normal((b, spec.t_out, spec.f_out, spec.half)).astype(np.float32)
    return x, wa, ba, wb, bb, cot


def _oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy())


def _jax_segment(spec, x, wa, ba, wb, bb, cot):
    """JAX fused_segment in interpret mode on bf16 x: (out, dx) as f32 numpy."""
    jspec = pk.SegmentSpec(*spec)
    args = [jnp.asarray(a) for a in (wa, ba, wb, bb)]
    out, vjp = jax.vjp(lambda xx: pk.fused_segment(xx, *args, jspec, True, False),
                       jnp.asarray(x).astype(jnp.bfloat16))
    (dx,) = vjp(jnp.asarray(cot).astype(jnp.bfloat16))
    return np.asarray(out.astype(jnp.float32)), np.asarray(dx.astype(jnp.float32))


def _port_segment(spec, x, wa, ba, wb, bb, cot):
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out = trunk.fused_segment(xt, _oihw(wa), torch.from_numpy(ba), _oihw(wb),
                              torch.from_numpy(bb), spec)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(cot).to(torch.bfloat16))
    assert out.dtype == dx.dtype == torch.bfloat16
    return out.detach(), dx.float().numpy()


def test_segment_specs_match_jax():
    for spec, jspec in ((trunk.SEGMENT_A, pk.SEGMENT_A), (trunk.SEGMENT_B, pk.SEGMENT_B)):
        assert tuple(spec) == tuple(jspec)
        assert (spec.c2, spec.t_out, spec.f_out) == (jspec.c2, jspec.t_out, jspec.f_out)


@pytest.mark.parametrize("spec", trunk.SEGMENTS, ids=["A", "B"])
def test_plain_matches_pallas_segment(spec):
    data = _data(50 + spec.c_in, spec)
    jout, jdx = _jax_segment(spec, *data)
    out, dx = _port_segment(spec, *data)
    assert out.shape == (2, spec.t_out, spec.f_out, spec.half)
    ulp = layer0.bf16_ulp_distance(out, torch.from_numpy(jout.copy()))
    assert float((ulp == 0).float().mean()) >= 0.999
    err = float((out.float() - torch.from_numpy(jout.copy())).abs().max())
    assert err <= 4e-3 * np.abs(jout).max(), err
    rel = np.linalg.norm(dx - jdx) / np.linalg.norm(jdx)
    assert rel < 1e-3, rel


def test_exact_ties_split_evenly_as_jax():
    """x = 0 makes am constant per channel, and equal conv3x3 halves make
    both MFM halves equal: interior pooled outputs tie 8 ways, border
    ones fewer, and equal conv1x1 bias halves tie the first MFM too
    (split 1/2-1/2 by both maxima). The even split must match JAX's."""
    spec = trunk.SEGMENT_B
    x, wa, ba, wb, bb, cot = _data(60, spec, b=1)
    x[:] = 0.0
    ba[spec.c2:] = ba[: spec.c2]
    wb[..., spec.half:] = wb[..., : spec.half]
    bb[spec.half:] = bb[: spec.half]
    jout, jdx = _jax_segment(spec, x, wa, ba, wb, bb, cot)
    out, dx = _port_segment(spec, x, wa, ba, wb, bb, cot)
    np.testing.assert_array_equal(out.float().numpy(), jout)
    assert np.abs(jdx).max() > 0
    rel = np.linalg.norm(dx - jdx) / np.linalg.norm(jdx)
    assert rel < 1e-4, rel
    # the rule matters: sending the whole cotangent to every tie is far off
    am = torch.maximum(*torch.from_numpy(ba).chunk(2)).expand(1, spec.t, spec.f, spec.c2)
    y = trunk._candidates(am, _oihw(wb), torch.from_numpy(bb), spec)
    cnt = (y == y.amax(dim=(1, 4, 6), keepdim=True)).sum(dim=(1, 4, 6))
    assert int(cnt.max()) == 8 and int(cnt.min()) < 8


def test_kernel_weight_packing_reassembles_the_conv():
    """The CUDA kernels' weight layouts and index arithmetic, mirrored in
    torch: forward candidates from the (c2, 9, 8, 2 CH) pack over each
    pooled pixel's 4x4 patch, and dx gathered from the (c_out, 3, 3, c2)
    pack as dy[t + 1 - dt][f + 1 - df]."""
    spec = trunk.SEGMENT_B
    rng = np.random.default_rng(70)
    am = torch.from_numpy(rng.standard_normal((2, spec.t, spec.f, spec.c2)).astype(np.float32))
    wb = torch.from_numpy((rng.standard_normal((spec.c_out, spec.c2, 3, 3)) * 0.1).astype(np.float32))
    bb = torch.from_numpy((rng.standard_normal(spec.c_out) * 0.1).astype(np.float32))
    ch = spec.half // trunk.GROUPS
    wpk = trunk.pack_forward_weights(wb, spec)
    assert wpk.shape == (spec.c2, 9, trunk.GROUPS, 2 * ch)
    xpad = F.pad(am.to(torch.bfloat16).float(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(2, spec.t_out, spec.f_out, 4, trunk.GROUPS, 2 * ch)
    for pt in range(2):
        for pf in range(2):
            for tap in range(9):
                dt, df = divmod(tap, 3)
                r, c = pt + dt, pf + df
                patch = xpad[:, r: r + 2 * spec.t_out: 2, c: c + 2 * spec.f_out: 2]
                acc[..., 2 * pt + pf, :, :] += torch.einsum("btfc,cgk->btfgk", patch, wpk[:, tap])
    acc = acc.reshape(2, spec.t_out, spec.f_out, 4, trunk.GROUPS, 2, ch)
    bias = bb.reshape(2, trunk.GROUPS, ch).permute(1, 0, 2)  # (g, h, c)
    out = (acc + bias).amax(dim=(3, 5)).reshape(2, spec.t_out, spec.f_out, spec.half)
    torch.testing.assert_close(out, trunk.reference_fwd(am, wb, bb, spec), rtol=1e-5, atol=1e-5)

    wtk = trunk.pack_backward_weights(wb)  # (c_out, 3, 3, c2)
    dy = torch.from_numpy(rng.standard_normal((2, spec.c_out, spec.t, spec.f)).astype(np.float32))
    dy[:, :, 2 * spec.t_out:] = 0.0  # the floor pool's dropped row gets no cotangent
    dypad = F.pad(dy, (1, 1, 1, 1))
    dx = torch.zeros(2, spec.t, spec.f, spec.c2)
    for dt in range(3):
        for df in range(3):
            d = dypad[:, :, 2 - dt: 2 - dt + spec.t, 2 - df: 2 - df + spec.f]
            dx += torch.einsum("bohw,oc->bhwc", d, wtk[:, dt, df])
    ref = F.conv_transpose2d(dy, wb.to(torch.bfloat16).float(), padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(dx, ref, rtol=1e-5, atol=1e-5)


def test_weight_gradient_raises_and_inputs_checked():
    spec = trunk.SEGMENT_B
    x, wa, ba, wb, bb, _ = _data(80, spec, b=1)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    args = (_oihw(wa), torch.from_numpy(ba), _oihw(wb).requires_grad_(True), torch.from_numpy(bb))
    out = trunk.fused_segment(xt, *args, spec)
    with pytest.raises(RuntimeError, match="need_dw=False"):
        out.float().sum().backward()
    with pytest.raises(NotImplementedError):
        trunk.fused_segment(xt, *args, spec, need_dw=True)
    with pytest.raises(ValueError):
        trunk.fused_segment(xt[:, :100], *args, spec)
    with pytest.raises(ValueError):
        trunk.fused_segment(xt, *args, trunk.SegmentSpec(101, 20, 48, 96, 64))
    with pytest.raises(ValueError, match="CUDA"):
        trunk.kernel_fwd(torch.zeros(1, spec.t, spec.f, spec.c2), args[2], args[3], spec)


def test_cpu_wrapper_runs_plain_without_launches():
    spec = trunk.SEGMENT_B
    x, wa, ba, wb, bb, _ = _data(90, spec, b=1)
    args = (torch.from_numpy(x).to(torch.bfloat16), _oihw(wa), torch.from_numpy(ba),
            _oihw(wb), torch.from_numpy(bb), spec)
    before = dict(trunk.LAUNCHES)
    torch.testing.assert_close(trunk.fused_segment(*args), trunk.fused_segment_reference(*args),
                               rtol=0, atol=0)
    assert trunk.LAUNCHES == before
