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
* the tie mask against the JAX op's tie set (its candidates equal to
  their pooled max): >= 99.9% equal on random data (another summation
  order can break a near-tie), all equal on the crafted exact ties;
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
from adaa_tpu_torch.ops import layer0, trunk, wgmma_layout

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


def _jax_tie_mask(spec, am, wb, bb) -> torch.Tensor:
    """The JAX op's tie set as the port's mask bits 4 pt + 2 pf + h: the
    candidates of its kernel (bf16 products, f32 sums, f32 bias) equal to
    their pooled max. am (B, T, F, c2) f32, wb HWIO."""
    y = jax.lax.conv_general_dilated(
        jnp.asarray(am).astype(jnp.bfloat16), jnp.asarray(wb).astype(jnp.bfloat16), (1, 1),
        [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32) + jnp.asarray(bb)
    y = np.asarray(y)[:, : 2 * spec.t_out, : 2 * spec.f_out]
    y = y.reshape(am.shape[0], spec.t_out, 2, spec.f_out, 2, 2, spec.half)  # (.., pt, .., pf, h, c)
    eq = y == y.max(axis=(2, 4, 5), keepdims=True)
    w = (2 ** (4 * np.arange(2)[:, None, None] + 2 * np.arange(2)[None, :, None]
               + np.arange(2)[None, None, :]))  # (pt, pf, h)
    bits = (eq * w[None, None, :, None, :, :, None]).sum(axis=(2, 4, 5))
    return torch.from_numpy(bits.astype(np.uint8))


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
    # the mask holds exactly the JAX tie set, whose popcounts are those counts
    mask = trunk.reference_mask(am, _oihw(wb), torch.from_numpy(bb), spec)
    torch.testing.assert_close(mask, _jax_tie_mask(spec, am.numpy(), wb, bb), rtol=0, atol=0)
    bits = torch.stack([(mask.int() >> k) & 1 for k in range(8)], -1).sum(-1)
    assert torch.equal(bits, cnt.permute(0, 2, 3, 1).int())


@pytest.mark.parametrize("spec", trunk.SEGMENTS, ids=["A", "B"])
def test_mask_is_the_jax_tie_set(spec):
    """On random data (ties broken almost surely, near-ties aside) the mask
    has one bit per pooled output, the JAX kernel's winner."""
    rng = np.random.default_rng(65 + spec.c2)
    am = rng.standard_normal((2, spec.t, spec.f, spec.c2)).astype(np.float32)
    _, _, _, wb, bb, _ = _data(66, spec, b=1)
    mask = trunk.reference_mask(torch.from_numpy(am), _oihw(wb), torch.from_numpy(bb), spec)
    assert mask.shape == (2, spec.t_out, spec.f_out, spec.half) and mask.dtype == torch.uint8
    agree = float((mask == _jax_tie_mask(spec, am, wb, bb)).float().mean())
    assert agree >= 0.999, agree
    assert float((mask != 0).float().mean()) == 1.0


def test_dy_splits_the_cotangent_over_the_set_bits():
    """reference_dy: bf16(g / popcount) on each set candidate, 0 elsewhere and
    on the rows and columns the floor pool drops (segment B's odd T)."""
    spec = trunk.SEGMENT_B
    mask = torch.zeros(1, spec.t_out, spec.f_out, spec.half, dtype=torch.uint8)
    g = torch.zeros(1, spec.t_out, spec.f_out, spec.half)
    mask[0, 3, 4, 5] = 0b10010001  # bits 0, 4, 7: (pt, pf, h) = (0,0,0), (1,0,0), (1,1,1)
    g[0, 3, 4, 5] = 1.0
    mask[0, 49, 9, 0] = 0b00000010  # bit 1: (0, 0, 1), the last pooled row and column
    g[0, 49, 9, 0] = -2.5
    dy = trunk.reference_dy(mask, g, spec)
    assert dy.shape == (1, spec.c_out, spec.t, spec.f)
    third = float(torch.tensor(1.0 / 3.0).to(torch.bfloat16))
    want = {(5, 6, 8): third, (5, 7, 8): third, (spec.half + 5, 7, 9): third,
            (spec.half + 0, 98, 18): -2.5}
    for (c, t, f), v in want.items():
        assert float(dy[0, c, t, f]) == v
    assert int((dy != 0).sum()) == len(want)
    assert float(dy[0, :, spec.t - 1].abs().max()) == 0.0


@pytest.mark.parametrize("spec", trunk.SEGMENTS, ids=["A", "B"])
def test_kernel_weight_packing_reassembles_the_conv(spec):
    """The CUDA kernels' weight images, unswizzled: the forward operand is
    OIHW reordered so that column 8 j + 2 q + h holds conv channel
    h half + q (c_out / 8) + j at k = (3 dt + df) c2 + ci, and the dx
    operand holds channel ci at k = (3 dt + df) c_out + co; taken back to
    OIHW they are the bf16 weights, and the dx operand's products are the
    transposed conv (tests/test_torch_port_trunk_layout.py replays the
    kernels' GEMMs in full)."""
    rng = np.random.default_rng(70)
    wb = torch.from_numpy((rng.standard_normal((spec.c_out, spec.c2, 3, 3)) * 0.1)
                          .astype(np.float32))
    wbf = wb.to(torch.bfloat16).float()
    wf = wgmma_layout.unswizzle_operand(trunk.pack_weights(wb, spec, backward=False), spec.c_out,
                                 9 * spec.c2)
    wd = wgmma_layout.unswizzle_operand(trunk.pack_weights(wb, spec, backward=True), spec.c2,
                                 9 * spec.c_out)
    nj = spec.c_out // 8
    for n in range(spec.c_out):
        j, q, h = n // 8, (n % 8) // 2, n % 2
        co = h * spec.half + q * nj + j
        for tap in range(9):
            dt, df = divmod(tap, 3)
            assert torch.equal(wf[n, tap * spec.c2: (tap + 1) * spec.c2].float(),
                               wbf[co, :, dt, df])
    back = wd.float().reshape(spec.c2, 3, 3, spec.c_out).permute(3, 0, 1, 2)
    assert torch.equal(back, wbf)
    dy = torch.from_numpy(rng.standard_normal((1, spec.c_out, spec.t, spec.f)).astype(np.float32))
    dypad = F.pad(dy, (1, 1, 1, 1))
    dx = torch.zeros(1, spec.t, spec.f, spec.c2)
    for tap in range(9):
        dt, df = divmod(tap, 3)
        d = dypad[:, :, 2 - dt: 2 - dt + spec.t, 2 - df: 2 - df + spec.f]
        w_tap = wd[:, tap * spec.c_out: (tap + 1) * spec.c_out].float()
        dx += torch.einsum("bohw,co->bhwc", d, w_tap)
    ref = F.conv_transpose2d(dy, wbf, padding=1).permute(0, 2, 3, 1)
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
        trunk.kernel_fwd(torch.zeros(1, spec.t, spec.f, spec.c2), args[2], args[3], spec, False)


def test_cpu_wrapper_runs_plain_without_launches():
    spec = trunk.SEGMENT_B
    x, wa, ba, wb, bb, _ = _data(90, spec, b=1)
    args = (torch.from_numpy(x).to(torch.bfloat16), _oihw(wa), torch.from_numpy(ba),
            _oihw(wb), torch.from_numpy(bb), spec)
    before = dict(trunk.LAUNCHES)
    torch.testing.assert_close(trunk.fused_segment(*args), trunk.fused_segment_reference(*args),
                               rtol=0, atol=0)
    assert trunk.LAUNCHES == before
