"""The fused Bottle2neck's host-side layouts and plans (CPU; no card).

``ops/b2n.py`` decides, for ``csrc/b2n.cu``, how the weights are packed for
the kernels' TMA/wgmma operands, how the chain kernel cuts a sequence into
regions, in which order the persistent GEMM walks its tiles, and how much
shared memory each kernel takes; the kernels check what they are given and
refuse a plan that breaks their own constants. These tests hold the plans
to what the kernels rely on, at RawNet3's three block shapes (B=64: T =
6435, 1287, 429 with dilations 2, 3, 4), in both directions, and at the
edges of the chain's regions (a sequence shorter than one region's central
rows, one row past a region, one partial region after a whole one). The
build helper's rebuild rule is checked on a temporary source tree with a
stand-in compiler.
"""
import ctypes
import os
import re
from pathlib import Path

import pytest
import torch

from adaa_tpu_torch.ops import _build, b2n

BATCH = 64
SMS = 132  # an H100's SMs
BLOCKS = [(256, 2, 6435), (1024, 3, 1287), (1024, 4, 429)]  # (Cin, dilation, T)
BLOCK_IDS = ["layer1", "layer2", "layer3"]


def _params(cin: int, projection: bool, seed: int = 0) -> b2n.B2NParams:
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(*shape, generator=g).to(torch.bfloat16)

    def v(n):
        return torch.randn(n, generator=g)

    return b2n.B2NParams(w(cin, 1024), v(1024), v(1024), v(1024), w(21 * 128, 128), v(896),
                         v(896), v(896), w(1024, 1024), v(1024), v(1024), v(1024),
                         w(cin, 1024) if projection else None)


def _edge_lengths(dilation: int):
    central = b2n.chain_plan(dilation, 1).central
    return {"short": central // 2, "exact": central, "one_past": central + 1,
            "partial": 2 * central - 5}


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("cin,dilation,t", BLOCKS, ids=BLOCK_IDS)
def test_packed_weights_unpack_to_the_plain_ones(cin, dilation, t, backward):
    """Each packed weight is B^T of its product, (N, K) with K contiguous:
    transposed back (the chain taps block by block) it is the plain weight."""
    p = _params(cin, projection=cin != 1024)
    packed = b2n.packed_weights(p, backward)
    plain = {"w1": p.w1, "w3": p.w3, "wr": p.wr, "wc": p.wc}
    if backward:
        # the backward's products dq W3^T, dz1 W1^T, dy Wr^T and the
        # transposed taps take the weights as they are stored
        assert set(packed) == {"w3", "wc", "w1", "wr"}
        for name, weight in packed.items():
            if plain[name] is None:
                assert weight is None
            else:
                assert torch.equal(weight, plain[name]) and weight.is_contiguous()
        return
    assert set(packed) == {"w1t", "wct", "w3t", "wrt"}
    for name in ("w1", "w3", "wr"):
        got = packed[name + "t"]
        if plain[name] is None:
            assert got is None
            continue
        assert got.is_contiguous() and got.dtype == torch.bfloat16
        assert torch.equal(got.t(), plain[name])
    wct = packed["wct"]
    assert wct.is_contiguous() and torch.equal(b2n.transposed_chain_weights(wct), p.wc)
    for tap in (0, 10, 20):
        rows = slice(tap * 128, (tap + 1) * 128)
        assert torch.equal(wct[rows].t(), p.wc[rows])


def _check_regions(dilation: int, t: int) -> None:
    plan = b2n.chain_plan(dilation, t)
    assert plan.halo >= b2n.NUMS * dilation  # the 7 levels' reach from a central row
    assert plan.region == plan.central + 2 * plan.halo == b2n.CHAIN_REGION
    covered = torch.zeros(t, dtype=torch.int32)
    regions = b2n.chain_regions(plan, t)
    assert len(regions) == plan.regions
    for start, c0, c1 in regions:
        assert start == c0 - plan.halo and c1 - c0 <= plan.central
        # every central row sees 7 d rows of its own region on both sides
        assert start <= c0 - b2n.NUMS * dilation
        assert c1 + b2n.NUMS * dilation <= start + plan.region
        covered[c0:c1] += 1
    assert bool((covered == 1).all()), "every central row exactly once"
    assert (plan.regions - 1) * plan.central < t <= plan.regions * plan.central


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("cin,dilation,t", BLOCKS, ids=BLOCK_IDS)
def test_chain_regions_cover_every_row_once(cin, dilation, t, backward):
    plan_ints = (b2n.bwd_plan if backward else b2n.fwd_plan)(BATCH, t, cin, dilation, SMS)
    plan = b2n.chain_plan(dilation, t)
    assert plan_ints[5:9] == (plan.regions, plan.halo, plan.central, plan.smem_bytes)
    _check_regions(dilation, t)


@pytest.mark.parametrize("edge", ["short", "exact", "one_past", "partial"])
@pytest.mark.parametrize("dilation", [2, 3, 4])
def test_chain_regions_at_the_edges(dilation, edge):
    t = _edge_lengths(dilation)[edge]
    _check_regions(dilation, t)
    assert b2n.chain_plan(dilation, t).regions == {"short": 1, "exact": 1, "one_past": 2,
                                                   "partial": 2}[edge]


def _gemm_plans(batch: int, t: int, cin: int, dilation: int, backward: bool):
    ints = (b2n.bwd_plan if backward else b2n.fwd_plan)(batch, t, cin, dilation, SMS)
    return b2n.GemmPlan(*ints[:5]), b2n.GemmPlan(*ints[9:])


def _check_tiles(plan: b2n.GemmPlan, m: int, n: int) -> None:
    assert plan.m_tiles == -(-m // b2n.GEMM_BM) and plan.n_tiles * b2n.GEMM_BN == n
    assert plan.grid == min(SMS, plan.m_tiles * plan.n_tiles)
    walks = b2n.gemm_tiles(plan)
    assert len(walks) == plan.grid and all(walks)
    seen = torch.zeros(plan.m_tiles, plan.n_tiles, dtype=torch.int32)
    for walk in walks:
        order = [mt * plan.n_tiles + nt for mt, nt in walk]
        assert order == sorted(order)  # each block goes forward, N fastest
        for mt, nt in walk:
            seen[mt, nt] += 1
    assert bool((seen == 1).all()), "every output tile exactly once"


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("cin,dilation,t", BLOCKS, ids=BLOCK_IDS)
def test_gemm_tile_order_covers_each_tile_once(cin, dilation, t, backward):
    first, last = _gemm_plans(BATCH, t, cin, dilation, backward)
    m = BATCH * t
    _check_tiles(first, m, 1024)  # conv1 / dq W3^T
    _check_tiles(last, m, cin if backward else 1024)  # dx / conv3


@pytest.mark.parametrize("batch,t", [(1, 100), (1, 229), (2, 213), (1, 1)])
def test_gemm_tile_order_at_small_and_ragged_m(batch, t):
    for backward in (False, True):
        for plan in _gemm_plans(batch, t, 256, 2, backward):
            _check_tiles(plan, batch * t, plan.n_tiles * b2n.GEMM_BN)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("cin,dilation,t", BLOCKS, ids=BLOCK_IDS)
def test_shared_memory_budgets(cin, dilation, t, backward):
    """Every kernel's shared memory fits one Hopper block, with its ring and
    staging as the C side lays them out."""
    first, last = _gemm_plans(BATCH, t, cin, dilation, backward)
    for plan, dq in ((first, backward), (last, False)):
        stage = (3 if dq else 2) * b2n.BOX_BYTES
        staging = b2n.DQ_STAGING if dq else b2n.GEMM_STAGING
        assert plan.stages >= 4
        assert plan.smem_bytes == (plan.stages * (stage + b2n.BARRIER_BYTES) + staging
                                   + b2n.SMEM_ALIGN)
        assert plan.smem_bytes <= b2n.SMEM_LIMIT == 232_448
    chain = b2n.chain_plan(dilation, t)
    act = (b2n.CHAIN_REGION + 2 * b2n.CHAIN_PAD) * b2n.CHAIN_LDS * 2
    assert chain.smem_bytes == (b2n.CHAIN_TAP_SLOTS * b2n.TAP_BYTES + act + b2n.BARRIER_BYTES
                                + b2n.SMEM_ALIGN)
    assert chain.smem_bytes <= b2n.SMEM_LIMIT
    assert b2n.CHAIN_PAD >= max(b2n.DILATIONS)  # a tap never reads past the pad rows


def test_plans_refuse_what_the_kernels_cannot_take():
    with pytest.raises(ValueError, match="multiple"):
        b2n.gemm_plan(100, 200, False, SMS)
    with pytest.raises(ValueError, match="dilations"):
        b2n.chain_plan(5, 100)


@pytest.mark.parametrize("name", sorted(b2n.ARGTYPES))
def test_ctypes_signatures_match_the_c_source(name):
    """The wrapper's ctypes argument list is the C function's, parameter by
    parameter (a mismatch passes pointers in the wrong places)."""
    src = (_build.SRC_DIR / "b2n.cu").read_text()
    params = re.search(rf"int {name}\(([^)]*)\)", src).group(1).split(",")
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
             "const int*": ctypes.POINTER(ctypes.c_int)}
    assert [kinds[" ".join(p.split()[:-1])] for p in params] == b2n.ARGTYPES[name]


# --------------------------------------------------------------------------
# ops/_build.py: a library is rebuilt when its source or a header changes
# --------------------------------------------------------------------------

def _tree(tmp_path: Path):
    src, out = tmp_path / "csrc", tmp_path / "build"
    src.mkdir()
    (src / "k.cu").write_text('#include "common.cuh"\n')
    (src / "common.cuh").write_text("// shared\n")
    return src, out


def _touch(path: Path, t: float) -> None:
    os.utime(path, (t, t))


@pytest.mark.parametrize("newer,stale", [(None, False), ("k.cu", True), ("common.cuh", True),
                                         ("missing", True)])
def test_stale_follows_the_source_and_its_headers(tmp_path, newer, stale):
    src, out = _tree(tmp_path)
    out.mkdir()
    lib = out / "libk.so"
    lib.write_bytes(b"")
    for p in (src / "k.cu", src / "common.cuh"):
        _touch(p, 1000.0)
    _touch(lib, 2000.0)
    if newer == "missing":
        lib.unlink()
    elif newer is not None:
        _touch(src / newer, 3000.0)
    assert _build.stale(lib, src / "k.cu") is stale


def test_build_recompiles_after_a_header_edit(tmp_path, monkeypatch):
    """build() with a stand-in nvcc that records its calls and writes -o."""
    src, out = _tree(tmp_path)
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho "$@" >> "%s"\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    ': > "$2"\n' % calls)
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))

    def n_calls():
        return len(calls.read_text().splitlines()) if calls.exists() else 0

    lib = _build.build("k", src, out)
    assert lib.exists() and n_calls() == 1
    assert "-gencode" in calls.read_text() and "arch=compute_90a,code=sm_90a" in calls.read_text()
    _touch(lib, 2000.0)
    for p in (src / "k.cu", src / "common.cuh"):
        _touch(p, 1000.0)
    _build.build("k", src, out)
    assert n_calls() == 1  # up to date
    _touch(src / "common.cuh", 3000.0)
    _build.build("k", src, out)
    assert n_calls() == 2  # the header changed
    assert (out / "libk.log").exists()
