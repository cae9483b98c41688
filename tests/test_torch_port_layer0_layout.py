"""The layer-0 kernels' host-side layouts and plans (CPU; no card).

``ops/layer0.py`` decides, for ``csrc/layer0.cu``, how the 5x5 weights
are packed as the kernels' wgmma B operands (swizzled shared-memory
images), how a sample is cut into forward and dx tiles, which input rows
a forward tile stages, and how much shared memory each kernel takes; the
kernels check what they are given. These tests hold the plans to what the
kernels rely on by replaying the kernels' index arithmetic in torch: each
thread's A fragment gathered from the band is ``F.unfold`` of the input,
a pooled pixel's 8 candidates land in one thread, the dx product into each
pooled pixel's 6x6 dx block and the col2im over the 9 blocks that cover a
dx pixel are the transposed conv, and every pooled pixel and dx pixel is
written once.
The replayed forward is also held against the JAX package's Pallas kernel
(interpret mode) on the same inputs.

Tolerances: the replays sum exact bf16 products in float64, the plain
twin in f32 and the Pallas kernel in f32, each in its own order: bf16
outputs >= 99.9% bit-equal and all within 1 ulp (an f32 sum near a bf16
rounding boundary can round the other way), winner index equal at >=
99.9% (a near-tie can pick another winner), dx within 1e-5 relative to
the largest |dx|.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adaa_tpu.ops import pallas_layer0 as pk
from adaa_tpu_torch.ops import _build, layer0, wgmma_layout

torch.set_num_threads(2)
SMS = 132  # an H100's SMs


def _data(seed: int, b: int = 1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, 404, 80)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((64, 1, 5, 5)) * 0.2).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(64) * 0.1).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, 202, 40, 32)).astype(np.float32))
    return x.to(torch.bfloat16), w, bias, g.to(torch.bfloat16)


def test_operands_round_trip_through_the_swizzle():
    """The packed images unpack to the bf16 weights in the kernels' orders,
    K (forward) and N (dx) padded with zeros."""
    w = _data(1)[1]
    wq = w.to(torch.bfloat16).reshape(64, 25)
    img = layer0.pack_weights(w, False)
    assert img.numel() * 2 == layer0.W_FWD_BYTES
    wf = wgmma_layout.unswizzle_operand(img, 64, 32)
    assert torch.equal(wf[:, :25], wq[layer0.forward_columns()])
    assert not wf[:, 25:].float().abs().any()
    wd = wgmma_layout.unswizzle_operand(layer0.pack_weights(w, True), 48, 256)
    assert layer0.pack_weights(w, True).numel() * 2 == layer0.W_DX_BYTES
    pp, ch = layer0.backward_k()
    for k in range(256):  # channel ch's 5x5 kernel at its conv output's offset
        pt, pf = int(pp[k]) // 2, int(pp[k]) % 2
        block = wd[:36, k].reshape(6, 6)
        assert torch.equal(block[pt:pt + 5, pf:pf + 5], wq[ch[k]].reshape(5, 5))
        assert float(block.float().abs().sum()) == float(wq[ch[k]].float().abs().sum())
    assert not wd[36:].float().abs().any()
    # each column / k is one conv channel (of one conv output), MFM halves adjacent
    assert sorted(layer0.forward_columns().tolist()) == list(range(64))
    assert sorted((pp * 64 + ch).tolist()) == list(range(256))
    n = torch.arange(0, 64, 2)
    assert torch.equal(layer0.forward_columns()[n + 1], layer0.forward_columns()[n] + 32)
    n = torch.arange(0, 256, 2)
    assert torch.equal(ch[n + 1], ch[n] + 32) and torch.equal(pp[n + 1], pp[n])


def test_packed_weights_are_made_once_per_version():
    w = _data(2)[1].clone()
    first = layer0.packed_weights(w)
    assert layer0.packed_weights(w.detach())[0] is first[0]
    w.mul_(2.0)  # an in-place update bumps the version: packed anew
    again = layer0.packed_weights(w)
    assert again[0] is not first[0]
    assert torch.equal(again[0], layer0.pack_weights(w, False))


# --------------------------------------------------------------------------
# Forward: band, A fragments, accumulator rows, epilogue
# --------------------------------------------------------------------------

def _band(xs: torch.Tensor, tile) -> torch.Tensor:
    """csrc/layer0.cu:fwd_band on one sample's bf16 x: quads (rows, pitch, 4)
    of band rows br, br + 1 x band columns c, c + 1 (input row r0 + br,
    input column c - BAND_PAD), in the order (br, c), (br, c + 1),
    (br + 1, c), (br + 1, c + 1)."""
    plan = layer0.fwd_plan(1, SMS)
    plain = torch.zeros(plan.band_rows + 1, layer0.BAND_PITCH + 1, dtype=torch.float64)
    for br in range(plan.band_rows):
        r = tile.r0 + br
        if tile.s_lo <= r < tile.s_hi:
            plain[br, layer0.BAND_PAD:layer0.BAND_PAD + 80] = xs[r]
    rows, cols = plan.band_rows, layer0.BAND_PITCH
    return torch.stack([plain[:rows, :cols], plain[:rows, 1:cols + 1],
                        plain[1:rows + 1, :cols], plain[1:rows + 1, 1:cols + 1]], dim=-1)


def _fragments(band: torch.Tensor, tile, sub0: int) -> torch.Tensor:
    """Each thread's A registers of the sub-tile at pooled pixel sub0, as
    the kernel gathers them (one quad per tap), laid out as the two
    products' (64, 32) A."""
    pitch = layer0.BAND_PITCH
    quads = band.reshape(-1, 4)
    a = torch.full((2, 64, 32), float("nan"), dtype=torch.float64)
    for warp in range(4):
        for lane in range(32):
            q = lane % 4
            off = [(k // 5) * pitch + k % 5 if k < 25 else 0 for k in layer0.fragment_taps(q)]
            p = min(sub0 + 8 * warp + lane // 4, tile.p0 + tile.np - 1)
            tp, fp = p // 40 - tile.tp_lo, p % 40
            base = 2 * tp * pitch + 2 * fp + layer0.BAND_PAD - 2
            for i in range(8):
                kk, hh, e = i // 4, (i // 2) % 2, i % 2
                quad = quads[base + off[i]]
                for pt in range(2):
                    for pf in range(2):
                        v = quad[2 * pt + pf]
                        if kk == 1 and hh == 1 and not (q == 0 and e == 0):
                            v = 0.0  # the pad mask: taps 25..31
                        a[pt, 16 * warp + lane // 4 + 8 * pf, 16 * kk + 8 * hh + 2 * q + e] = v
    return a


def _sub_tiles(tile):
    return range(tile.p0, tile.p0 + tile.np, layer0.FWD_SUBTILE)


TILE_IDS = [0, 13, 31]  # the first, a middle one and the ragged last


@pytest.mark.parametrize("ti", TILE_IDS)
def test_fragment_taps_reproduce_unfold(ti):
    """A fragment row (pooled pixel, column parity pf) of conv row pt holds
    the 25 taps of that conv output, as F.unfold gives them, and zeros in
    K's padding; the staged rows fit the plan."""
    plan = layer0.fwd_plan(1, SMS)
    tile = layer0.fwd_tiles()[ti]
    assert 0 <= tile.s_lo < tile.s_hi <= 404
    assert tile.s_hi - tile.r0 <= plan.band_rows
    assert (tile.s_hi - tile.s_lo) * 80 * 4 <= plan.stage_bytes
    xs = _data(3)[0][0].double()
    cols = F.unfold(xs[None, None], 5, padding=2)[0].T.reshape(404, 80, 25)
    band = _band(xs, tile)
    for sub0 in _sub_tiles(tile):
        a = _fragments(band, tile, sub0)
        assert not torch.isnan(a).any()
        for row in range(64):
            p = min(sub0 + 8 * (row // 16) + row % 8, tile.p0 + tile.np - 1)
            pf = (row % 16) // 8
            for pt in range(2):
                want = cols[2 * (p // 40) + pt, 2 * (p % 40) + pf]
                assert torch.equal(a[pt, row, :25], want), (sub0, row, pt)
                assert not a[pt, row, 25:].abs().any()


def _replay_forward(x, w, bias, ti):
    """The kernel's forward of one tile, products in float64: pooled pixels
    -> (out, idx), each from the candidates of one thread."""
    tile = layer0.fwd_tiles()[ti]
    wf = wgmma_layout.unswizzle_operand(layer0.pack_weights(w, False), 64, 32).double()
    cols = layer0.forward_columns()
    band = _band(x[0].double(), tile)
    out, idx = {}, {}
    for sub0 in _sub_tiles(tile):
        acc = _fragments(band, tile, sub0) @ wf.T  # (pt, row, column)
        for warp in range(4):
            for lane in range(32):
                p, q = sub0 + 8 * warp + lane // 4, lane % 4
                if p >= tile.p0 + tile.np:
                    continue
                for j in range(8):
                    cands = []
                    for c in range(8):  # c = 4 pt + 2 pf + e
                        pt, pf, e = c >> 2, (c >> 1) & 1, c & 1
                        col = 8 * j + 2 * q + e
                        assert int(cols[col]) == 32 * e + 8 * q + j  # one thread, one channel
                        cands.append(float(acc[pt, 16 * warp + lane // 4 + 8 * pf, col])
                                     + float(bias[32 * e + 8 * q + j]))
                    best = max(cands)
                    out[(p, 8 * q + j)] = best
                    idx[(p, 8 * q + j)] = cands.index(best)  # the first: strict >
    return out, idx


@pytest.mark.parametrize("ti", TILE_IDS)
def test_forward_epilogue_matches_twin_and_pallas(ti):
    """Rows r and r + 8 of a warp are one pooled pixel's two columns, the
    two accumulators its two conv rows, and columns 8 j + 2 q + e its MFM
    pair: the in-thread max and winner are the twin's and the JAX kernel's."""
    x, w, bias, _ = _data(4)
    out, idx = _replay_forward(x, w, bias, ti)
    keys = sorted(out)
    tile = layer0.fwd_tiles()[ti]
    assert len(keys) == tile.np * 32  # every (pooled pixel, channel) of the tile once
    ref_out, ref_idx = layer0.reference_fwd(x, w, bias, True)
    jout = np.asarray(pk.fused_conv0_mfm_pool(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(w.numpy().transpose(2, 3, 1, 0)), jnp.asarray(bias.numpy()), True,
        False)).astype(np.float32)
    got = torch.tensor([out[k] for k in keys], dtype=torch.float64)
    pix = torch.tensor([k[0] for k in keys])
    ch = torch.tensor([k[1] for k in keys])
    ref = ref_out[0].reshape(-1, 32)[pix, ch]
    jref = torch.from_numpy(jout[0].reshape(-1, 32))[pix, ch]
    # rounded to bf16 as the kernel stores it: bit-equal but for near-ties of
    # the rounding, within 1 ulp
    for want in (ref, jref):
        ulp = layer0.bf16_ulp_distance(got.float(), want)
        assert float((ulp == 0).float().mean()) >= 0.999 and int(ulp.max()) <= 1
    win = torch.tensor([idx[k] for k in keys])
    assert float((win == ref_idx[0].reshape(-1, 32)[pix, ch].long()).float().mean()) >= 0.999


# --------------------------------------------------------------------------
# Backward: D = dy W into each pooled pixel's 6x6 dx block, then col2im
# --------------------------------------------------------------------------

def _dy_rows(idx, g, pix):
    """The dx product's A rows for pooled pixels ``pix`` ((pr, pc) or None
    outside the image), in ``backward_k``'s order: the bf16 cotangent where
    the winner is candidate 2 pp + e, else 0."""
    pp, ch = layer0.backward_k()
    c, e = ch % 32, ch // 32
    rows = torch.zeros(len(pix), layer0.DX_K, dtype=torch.float64)
    for i, rc in enumerate(pix):
        if rc is not None:
            hit = idx[rc[0], rc[1], c].long() == 2 * pp + e
            zero = torch.zeros((), dtype=torch.float64)
            rows[i] = torch.where(hit, g[rc[0], rc[1], c].double(), zero)
    return rows


def _thread_rows(idx, g, pix):
    """The same rows as csrc/layer0.cu:layer0_dx_kernel forms them: thread
    (warp, lane) of a warpgroup holds rows 16 warp + lane / 4 (+ 8); its
    register 2 hh + h of k-step 4 pp + kc packs channel 8 q + 2 kc + hh's dy
    of MFM halves 0 (low) and 1 (high) from the pixel's (g, winner) words."""
    rows = torch.zeros(len(pix), layer0.DX_K, dtype=torch.float64)
    for warp in range(4):
        for lane in range(32):
            q = lane % 4
            for h in range(2):
                r = 16 * warp + lane // 4 + 8 * h
                if r >= len(pix) or pix[r] is None:
                    continue
                gw = g[pix[r][0], pix[r][1], 8 * q: 8 * q + 8]
                wn = idx[pix[r][0], pix[r][1], 8 * q: 8 * q + 8].long()
                for pp in range(4):
                    for kc in range(4):
                        for hh in range(2):
                            cl = 2 * kc + hh
                            for e in range(2):
                                if int(wn[cl]) == 2 * pp + e:
                                    rows[r, 16 * (4 * pp + kc) + 8 * hh + 2 * q + e] = float(gw[cl])
    return rows


def _tile_pixels(tile, wg=None):
    """The tile's pooled pixels in product row order (None outside the image)."""
    pix = []
    for p in range(layer0.DP_ROWS * layer0.DP_COLS):
        pr, pc = tile.pr0 + p // layer0.DP_COLS, tile.pcb + p % layer0.DP_COLS
        assert 0 <= pc < 40
        pix.append((pr, pc) if 0 <= pr < 202 else None)
    return pix


def test_dx_fragments_follow_the_k_order():
    """Each thread's registers, formed from (g, winner) words, are the A rows
    of ``backward_k``'s order, for both warpgroups of a tile."""
    x, w, bias, g = _data(6)
    _, idx = layer0.reference_fwd(x, w, bias, True)
    for tile in (layer0.dx_tiles()[0], layer0.dx_tiles()[37], layer0.dx_tiles()[-1]):
        pix = _tile_pixels(tile)
        for wg in range(2):
            part = pix[64 * wg: 64 * wg + 64]
            assert torch.equal(_thread_rows(idx[0], g[0], part), _dy_rows(idx[0], g[0], part))


def _replay_dx(idx, g, w) -> torch.Tensor:
    """csrc/layer0.cu:layer0_dx_kernel on one sample, tile by tile: the D
    tile (6x6 dx block of each pooled pixel) = A Wd^T, then each dx pixel
    summed from the 9 blocks that cover it, as the kernel indexes them."""
    wd = wgmma_layout.unswizzle_operand(layer0.pack_weights(w, True), layer0.D_N,
                                        layer0.DX_K).double()
    dx = torch.full((404, 80), float("nan"), dtype=torch.float64)
    written = torch.zeros(404, 80, dtype=torch.int32)
    for tile in layer0.dx_tiles():
        d = _dy_rows(idx[0], g[0], _tile_pixels(tile)) @ wd.T  # (126, 48)
        assert not d[:, 36:].abs().any()
        d = d[:, :36]
        for r in range(layer0.DX_ROWS):
            t = tile.t0 + r
            if t >= 404:
                continue
            for c in range(layer0.DX_COLS):
                f = tile.f0 + c
                s = 0.0
                for u in range(3):
                    row, oa = r // 2 + u, r % 2 + 4 - 2 * u
                    for v in range(3):
                        pc = f // 2 - 1 + v
                        if 0 <= pc < 40:
                            s += float(d[row * layer0.DP_COLS + pc - tile.pcb,
                                         6 * oa + f % 2 + 4 - 2 * v])
                dx[t, f] = s
                written[t, f] += 1
    assert bool((written == 1).all())
    return dx


def test_d_col2im_plan_reproduces_conv_transpose():
    """The packed dx operand holds each channel's 5x5 kernel at its conv
    output's offset in the 6x6 block, and every dx pixel summed from the 9
    blocks that cover it is the plain dx (the bf16 cotangent routed to the
    winner, transposed conv)."""
    x, w, bias, g = _data(5)
    _, idx = layer0.reference_fwd(x, w, bias, True)
    dx = _replay_dx(idx, g, w)
    ref = layer0.reference_bwd(idx, g, w, torch.float32)[0].double()
    scale = float(ref.abs().max())
    assert float((dx - ref).abs().max()) <= 1e-5 * scale


# --------------------------------------------------------------------------
# Plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 2, 3, 256])
def test_tile_plans_cover_every_output_once(batch):
    """The persistent blocks' walk over batch x tiles writes every pooled
    pixel (so every conv output that reaches the pool is computed once) and
    every dx pixel exactly once."""
    fwd, bwd = layer0.fwd_plan(batch, SMS), layer0.bwd_plan(batch, SMS)
    assert fwd.grid == min(layer0.BLOCKS_PER_SM * SMS, batch * fwd.tiles)
    assert bwd.grid == min(layer0.BLOCKS_PER_SM * SMS, batch * bwd.tiles)
    for plan in (fwd, bwd):
        walked = np.zeros(batch * plan.tiles, np.int32)
        for block in range(plan.grid):
            walked[block::plan.grid] += 1
        assert (walked == 1).all()
    per_tile = np.zeros(202 * 40, np.int32)
    tiles = layer0.fwd_tiles()
    assert len(tiles) == fwd.tiles
    for t in tiles:
        per_tile[t.p0:t.p0 + t.np] += 1
        assert t.np <= fwd.tile and (t.np == fwd.tile or t is tiles[-1])
    assert (per_tile == 1).all()
    dx_cover = np.zeros((404, 80), np.int32)
    dtiles = layer0.dx_tiles()
    assert len(dtiles) == bwd.tiles
    for t in dtiles:
        dx_cover[t.t0:t.t0 + bwd.rows, t.f0:t.f0 + layer0.DX_COLS] += 1
        # the tile's D covers the pooled pixels whose 6x6 blocks reach its dx
        assert 2 * t.pr0 == t.t0 - 2 and 2 * t.pcb <= max(t.f0 - 2, 0)
        assert 2 * (t.pcb + layer0.DP_COLS) >= min(t.f0 + layer0.DX_COLS + 2, 80)
    assert (dx_cover == 1).all()


def test_shared_memory_budget():
    fwd, bwd = layer0.fwd_plan(256, SMS), layer0.bwd_plan(256, SMS)
    assert fwd.smem_bytes == (layer0.W_FWD_BYTES + layer0.STAGES * fwd.stage_bytes
                              + fwd.band_rows * layer0.BAND_PITCH * 8 + layer0.W_TAB_BYTES
                              + layer0.SCALE_BYTES + layer0.STAGES * layer0.BARRIER_BYTES
                              + layer0.SMEM_ALIGN)
    assert bwd.smem_bytes == (layer0.W_DX_BYTES + bwd.d_rows * bwd.d_cols * layer0.D_PITCH * 4
                              + layer0.SMEM_ALIGN)
    assert bwd.d_rows * bwd.d_cols <= 2 * 64  # one 64-row product per warpgroup
    for plan in (fwd, bwd):
        assert plan.smem_bytes <= layer0.SMEM_LIMIT == 232_448  # 227 KB
        # the blocks per SM the kernels' launch bounds ask for fit
        assert layer0.BLOCKS_PER_SM * plan.smem_bytes <= 228 * 1024


@pytest.mark.parametrize("name", sorted(layer0.ARGTYPES))
def test_ctypes_signatures_match_the_c_source(name):
    src = (_build.SRC_DIR / "layer0.cu").read_text()
    params = re.search(rf"int {name}\(([^)]*)\)", src).group(1).split(",")
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
             "const int*": ctypes.POINTER(ctypes.c_int)}
    assert [kinds[" ".join(p.split()[:-1])] for p in params] == layer0.ARGTYPES[name]


def test_c_constants_match_the_plans():
    src = (_build.SRC_DIR / "layer0.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    for name in ("THREADS", "FWD_TILE", "FWD_SUBTILE", "BAND_PAD", "DX_ROWS", "D_N", "D_PITCH",
                 "STAGES",
                 "BARRIER_BYTES", "SMEM_ALIGN", "SMEM_LIMIT", "TAPS"):
        assert const(name) == getattr(layer0, name), name
    bounds = re.findall(r"__launch_bounds__\(THREADS, (\d+)\)\s+(layer0_\w+_kernel)", src)
    assert sorted(bounds) == [(str(layer0.BLOCKS_PER_SM), "layer0_dx_kernel"),
                              (str(layer0.BLOCKS_PER_SM), "layer0_fwd_kernel")]
