"""The fused trunk segment's host-side layouts and plans (CPU; no card).

``ops/trunk.py`` decides, for ``csrc/trunk.cu``, how the conv3x3 weights
are packed as the kernels' wgmma B operands (swizzled shared-memory
images), how a sample is cut into forward and dx tiles, which input rows
(forward) or pooled rows of g and the mask (dx) a tile stages, and how
much shared memory each kernel takes; the kernels check what they are
given and refuse a plan that breaks their own constants. These tests hold
the plans to what the kernels rely on, for both segments, by replaying
the kernels' index arithmetic in torch: the packed operands reassemble the
conv and its transpose, every tile's band holds exactly what its
ldmatrix rows read (the SAME zero ring, segment B's ragged last dx row),
and every pooled pixel and dx pixel is written once.
"""
import ctypes
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adaa_tpu_torch.ops import _build, trunk, wgmma_layout
from adaa_tpu_torch.ops.layer0 import ieee_f32

SMS = 132  # an H100's SMs
SEG_IDS = ["A", "B"]


def _data(spec, seed: int, b: int = 1):
    rng = np.random.default_rng(seed)
    am = torch.from_numpy(rng.standard_normal((b, spec.t, spec.f, spec.c2)).astype(np.float32))
    wb = torch.from_numpy((rng.standard_normal((spec.c_out, spec.c2, 3, 3)) * 0.1)
                          .astype(np.float32))
    bb = torch.from_numpy((rng.standard_normal(spec.c_out) * 0.1).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, spec.t_out, spec.f_out, spec.half))
                         .astype(np.float32)).to(torch.bfloat16).float()
    return am, wb, bb, g


@pytest.mark.parametrize("spec", trunk.SEGMENTS, ids=SEG_IDS)
def test_operands_round_trip_through_the_swizzle(spec):
    """The packed images are the operands, 128-byte swizzled, k padded to 64."""
    wb = _data(spec, 1)[1]
    wbf = wb.to(torch.bfloat16)
    for backward, operand, n, k in ((False, trunk.forward_layout(wbf, spec), spec.c_out,
                                     9 * spec.c2),
                                    (True, trunk.backward_layout(wbf, spec), spec.c2,
                                     9 * spec.c_out)):
        img = trunk.pack_weights(wb, spec, backward)
        assert img.dtype == torch.bfloat16 and img.numel() * 2 == trunk.operand_bytes(n, k)
        assert torch.equal(wgmma_layout.unswizzle_operand(img, n, k), operand)
        # row r's 16-byte chunk c lies at chunk c ^ (r % 8) of its 128-byte row
        rows = img.reshape(-1, n, 8, 8)
        first = operand[:, :64].reshape(n, 8, 8)
        for r in (0, 3, 7, n - 1):
            for c in range(8):
                assert torch.equal(rows[0, r, c ^ (r % 8)], first[r, c])


@pytest.mark.parametrize("spec", trunk.SEGMENTS, ids=SEG_IDS)
def test_forward_packing_reassembles_the_conv(spec):
    """im2col (k = (3 dt + df) c2 + ci) times the unpacked forward operand,
    read through the kernel's column map (column 8 j + 2 q + h: the pooled
    channel q NJ + j of MFM half h) and pooled in the kernel's order of
    maxima, is the plain forward and its tie mask."""
    am, wb, bb, _ = _data(spec, 2, b=2)
    wf = wgmma_layout.unswizzle_operand(trunk.pack_weights(wb, spec, backward=False), spec.c_out,
                                 9 * spec.c2).double()
    xpad = F.pad(am.to(torch.bfloat16).double(), (0, 0, 1, 1, 1, 1))
    t2, f2 = 2 * spec.t_out, 2 * spec.f_out
    cols = torch.cat([xpad[:, dt: dt + t2, df: df + f2] for dt in range(3) for df in range(3)],
                     dim=-1)  # (B, t2, f2, 9 c2)
    acc = cols @ wf.T  # (B, t2, f2, c_out): column n
    nj = spec.c_out // 8
    j, q = torch.arange(spec.c_out // 2) % nj, torch.arange(spec.c_out // 2) // nj
    lo = acc[..., 8 * j + 2 * q] + bb[:spec.half].double()  # channel q nj + j
    hi = acc[..., 8 * j + 2 * q + 1] + bb[spec.half:].double()
    cand = torch.stack([lo, hi], -1).reshape(2, spec.t_out, 2, spec.f_out, 2, spec.half, 2)
    best, bits = None, torch.zeros(2, spec.t_out, spec.f_out, spec.half, dtype=torch.int32)
    for pt in range(2):
        for pf in range(2):
            pair = torch.maximum(cand[:, :, pt, :, pf, :, 0], cand[:, :, pt, :, pf, :, 1])
            best = pair if best is None else torch.maximum(best, pair)
    for pt in range(2):
        for pf in range(2):
            for h in range(2):
                bits += (cand[:, :, pt, :, pf, :, h] == best).int() << (4 * pt + 2 * pf + h)
    torch.testing.assert_close(best.float(), trunk.reference_fwd(am, wb, bb, spec),
                               rtol=1e-5, atol=1e-5)
    agree = (bits.to(torch.uint8) == trunk.reference_mask(am, wb, bb, spec)).float().mean()
    assert float(agree) >= 0.999


@pytest.mark.parametrize("spec", trunk.SEGMENTS, ids=SEG_IDS)
def test_backward_packing_reassembles_the_transposed_conv(spec):
    """dx[t][f] = sum over taps and channels of dy[t + 1 - dt][f + 1 - df][co]
    times the unpacked backward operand at k = (3 dt + df) c_out + co."""
    am, wb, bb, g = _data(spec, 3)
    wd = wgmma_layout.unswizzle_operand(trunk.pack_weights(wb, spec, backward=True), spec.c2,
                                 9 * spec.c_out).double()
    dy = trunk.reference_dy(trunk.reference_mask(am, wb, bb, spec), g, spec)
    dypad = F.pad(dy.double().permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))  # (B, T+2, F+2, c_out)
    cols = torch.cat([dypad[:, 2 - dt: 2 - dt + spec.t, 2 - df: 2 - df + spec.f]
                      for dt in range(3) for df in range(3)], dim=-1)
    dx = (cols @ wd.T).float()
    with ieee_f32():
        ref = F.conv_transpose2d(dy, wb.to(torch.bfloat16).float(), padding=1)
    torch.testing.assert_close(dx, ref.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# Tiles and bands, replayed from the kernels' arithmetic
# --------------------------------------------------------------------------

def _fwd_band(spec, plan, xs: torch.Tensor, tile) -> torch.Tensor:
    """csrc/trunk.cu:fwd_band on one sample's bf16 am: (rows, parity, W/2, c2),
    band row br = input row r0 + br, staged column s in plane s % 2."""
    wh = (spec.f + 2) // 2
    band = torch.full((plan.band_rows, 2, wh, spec.c2), float("nan"))
    for br in range(plan.band_rows):
        for s in range(spec.f + 2):
            r, f = tile.r0 + br, s - 1
            inside = tile.s_lo <= r < tile.s_hi and 0 <= f < spec.f
            band[br, s % 2, s // 2] = xs[r, f] if inside else 0.0
    return band


@pytest.mark.parametrize("spec", trunk.SEGMENTS, ids=SEG_IDS)
def test_forward_tiles_and_bands_hold_what_the_products_read(spec):
    plan = trunk.fwd_plan(spec, 1, SMS)
    tiles = trunk.fwd_tiles(spec)
    assert len(tiles) == plan.tiles and sum(t.np for t in tiles) == spec.t_out * spec.f_out
    assert [t.p0 for t in tiles] == [i * plan.tile for i in range(plan.tiles)]
    assert plan.tile % trunk.FWD_SUBTILE == 0
    am = _data(spec, 4)[0][0].to(torch.bfloat16).float()
    xpad = F.pad(am, (0, 0, 1, 1, 1, 1))
    for tile in tiles:
        # the staging holds the tile's rows, within the image and the plan
        assert 0 <= tile.s_lo < tile.s_hi <= spec.t
        assert (tile.s_hi - tile.s_lo) * spec.f * spec.c2 * 4 <= plan.stage_bytes
        band = _fwd_band(spec, plan, am, tile)
        tp_lo = tile.p0 // spec.f_out
        for p in range(tile.p0, tile.p0 + tile.np):
            tp, fp = divmod(p, spec.f_out)
            for pt in range(2):
                for cp in range(2):  # ldmatrix rows m < 8 and m >= 8: conv columns 2 fp, 2 fp + 1
                    for dt in range(3):
                        for df in range(3):
                            br = 2 * (tp - tp_lo) + pt + dt
                            s = 2 * fp + cp + df
                            got = band[br, s % 2, s // 2]
                            want = xpad[2 * tp + pt + dt, 2 * fp + cp + df]
                            assert torch.equal(got, want), (p, pt, cp, dt, df)
    if spec.t % 2:  # segment B: conv row t - 1 reaches no pool, so no tile stages past it
        assert max(t.s_hi for t in tiles) == spec.t


def _dy_band(spec, plan, band: torch.Tensor, gm: torch.Tensor, mask: torch.Tensor, tile):
    """csrc/trunk.cu:dy_band: zero the band rows no staged pooled row covers,
    then write each staged pooled pixel's 4 conv outputs x 2 halves."""
    c_lo = max(2 * tile.g_lo - tile.d_lo, 0)
    c_hi = min(2 * (tile.g_lo + tile.g_rows) - 1 - tile.d_lo, plan.dy_rows - 1)
    for br in list(range(c_lo)) + list(range(c_hi + 1, plan.dy_rows)):
        band[br, 1: spec.f + 1] = 0.0
    m = mask.to(torch.int32)
    bits = torch.stack([(m >> k) & 1 for k in range(8)], -1)
    cnt = bits.sum(-1)
    gq = torch.where(cnt > 1, gm / cnt.clamp(min=1), gm).to(torch.bfloat16).float()
    for lr in range(tile.g_rows):
        tp = tile.g_lo + lr
        for pt in range(2):
            br = 2 * tp + pt - tile.d_lo
            if not 0 <= br < plan.dy_rows:
                continue
            for pf in range(2):
                for h in range(2):
                    sel = bits[tp, :, :, 4 * pt + 2 * pf + h].bool()
                    vals = torch.where(sel, gq[tp], torch.zeros(()))  # (f_out, half)
                    cols = 2 * torch.arange(spec.f_out) + pf + 1
                    band[br, cols, h * spec.half: (h + 1) * spec.half] = vals


@pytest.mark.parametrize("spec", trunk.SEGMENTS, ids=SEG_IDS)
def test_dx_tiles_and_dy_bands_hold_what_the_products_read(spec):
    """One block walks every dx tile of a sample with one band (rows a tile
    does not write keep the last tile's values, as in shared memory): every
    value a product reads is the plain dy, with the halo and the rows past
    the pool zero, segment B's last dx row included."""
    plan = trunk.bwd_plan(spec, 1, SMS)
    tiles = trunk.dx_tiles(spec)
    assert len(tiles) == plan.tiles and sum(t.np for t in tiles) == spec.t * spec.f
    am, wb, bb, g = _data(spec, 5)
    mask = trunk.reference_mask(am, wb, bb, spec)
    dy = trunk.reference_dy(mask, g, spec)[0].permute(1, 2, 0)  # (T, F, c_out)
    dypad = F.pad(dy, (0, 0, 1, 1, 1, 1))
    band = torch.full((plan.dy_rows, spec.f + 2, spec.c_out), float("nan"))
    band[:, 0] = band[:, spec.f + 1] = 0.0  # the halo columns, zeroed once
    last_rows = set()
    for tile in tiles:
        assert tile.g_rows <= plan.g_rows and 0 <= tile.g_lo
        assert tile.g_lo + tile.g_rows <= spec.t_out
        _dy_band(spec, plan, band, g[0], mask[0], tile)
        t_lo = tile.p0 // spec.f
        for p in range(tile.p0, tile.p0 + tile.np):
            t, f = divmod(p, spec.f)
            if t == spec.t - 1:
                last_rows.add(t)
            for dt in range(3):
                for df in range(3):
                    got = band[t - t_lo + 2 - dt, f + 2 - df]
                    assert torch.equal(got, dypad[t + 2 - dt, f + 2 - df]), (p, dt, df)
    assert last_rows == {spec.t - 1}
    if spec.t % 2:  # dy row t - 1 is past the pool: the last dx row gets only dy row t - 2
        assert float(dy[spec.t - 1].abs().max()) == 0.0 and float(dy[spec.t - 2].abs().max()) > 0


@pytest.mark.parametrize("batch", [1, 2, 3, 256])
@pytest.mark.parametrize("spec", trunk.SEGMENTS, ids=SEG_IDS)
def test_plans_grid_and_shared_memory(spec, batch):
    fwd, bwd = trunk.fwd_plan(spec, batch, SMS), trunk.bwd_plan(spec, batch, SMS)
    assert fwd.grid == min(SMS, batch * fwd.tiles) and bwd.grid == min(SMS, batch * bwd.tiles)
    # the layouts the C side builds: weights, staging, band, one mbarrier, alignment slack
    band = fwd.band_rows * (spec.f + 2) * (2 * spec.c2 + trunk.PIXEL_PAD)
    assert fwd.smem_bytes == (trunk.operand_bytes(spec.c_out, 9 * spec.c2) + fwd.stage_bytes
                              + band + trunk.BARRIER_BYTES + trunk.SMEM_ALIGN)
    dy_band = bwd.dy_rows * (spec.f + 2) * (2 * spec.c_out + trunk.PIXEL_PAD)
    staged = bwd.g_rows * spec.f_out * spec.half * 5
    assert bwd.smem_bytes == (trunk.operand_bytes(spec.c2, 9 * spec.c_out) + staged + dy_band
                              + trunk.BARRIER_BYTES + trunk.SMEM_ALIGN)
    for plan in (fwd, bwd):
        assert plan.smem_bytes <= trunk.SMEM_LIMIT == 232_448
    # ldmatrix without bank conflicts: an odd number of 16-byte units per pixel
    assert ((2 * spec.c2 + trunk.PIXEL_PAD) // 16) % 2 == 1
    assert ((2 * spec.c_out + trunk.PIXEL_PAD) // 16) % 2 == 1


@pytest.mark.parametrize("name", sorted(trunk.ARGTYPES))
def test_ctypes_signatures_match_the_c_source(name):
    """The wrapper's ctypes argument list is the C function's, parameter by
    parameter (a mismatch passes pointers in the wrong places)."""
    src = (_build.SRC_DIR / "trunk.cu").read_text()
    params = re.search(rf"int {name}\(([^)]*)\)", src).group(1).split(",")
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
             "const int*": ctypes.POINTER(ctypes.c_int)}
    assert [kinds[" ".join(p.split()[:-1])] for p in params] == trunk.ARGTYPES[name]


def test_c_constants_match_the_plans():
    """The tile sizes and pads the C side checks plans against are the ones
    the plans are made with."""
    src = (_build.SRC_DIR / "trunk.cu").read_text()
    for name in ("FWD_SUBTILE", "DX_SUBTILE", "PIXEL_PAD", "BARRIER_BYTES", "SMEM_LIMIT",
                 "SMEM_ALIGN"):
        got = int(re.search(rf"\b{name} = (\d+)", src).group(1))
        assert got == getattr(trunk, name), name
    for seg, spec in zip(("SegA", "SegB"), trunk.SEGMENTS):
        args = re.search(rf"using {seg} = Segment<([^>]*)>", src).group(1)
        t, f, c2, c_out, fs, ds = (int(a) for a in args.split(","))
        assert (t, f, c2, c_out) == (spec.t, spec.f, spec.c2, spec.c_out)
        assert (fs, ds) == trunk.SUBTILES[trunk.SEGMENTS.index(spec)]
