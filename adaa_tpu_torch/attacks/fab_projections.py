"""Closed-form box-constrained hyperplane projections for FAB.

Port of ``adaa_tpu/attacks/fab_projections.py`` (Croce & Hein 2019;
reference torchattacks fab.py:562-717): given points t in the [0, 1]^D
box and hyperplanes (w, b), the minimal-(Linf | L2 | L1)-norm d such that
t + d stays in the box and crosses the hyperplane.

The JAX form is kept: full-batch compute with ``torch.where`` masks in
place of the reference's row subsetting, and a static number of search
passes. FAB's per-step projections are the paired fan-search forms
(``projection_linf_bisect_pair``, ``projection_l2_bisect_pair``): after
sign-normalising w so the constraint reads w.d <= c, the reach
g(lam) = sum_i |w_i| min(lam, p_i) is monotone in the radius, so the
radius is found by a search of ``fan`` candidates per pass over the
(S, B, D) operands. The sort-based closed forms (``projection_linf``,
``projection_l2``, ``projection_l1``) are exact; L1 keeps its sorted form
in FAB.
"""
from __future__ import annotations

import math

import torch


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-wise gather: a[i, idx[i, j]]."""
    return torch.gather(a, 1, idx)


def _fan_search(g_of, lo: torch.Tensor, hi: torch.Tensor, bits: int, fan: int) -> torch.Tensor:
    """Monotone scalar search, ``fan`` candidates per pass.

    ``g_of(mids)`` maps candidates (..., fan) to nondecreasing booleans
    (..., fan). Each pass narrows the bracket by ``fan + 1``; returns the
    upper bracket (the first value known to satisfy the constraint)."""
    passes = -(-bits // max(1, (fan + 1).bit_length() - 1))
    frac = torch.arange(1, fan + 1, dtype=lo.dtype, device=lo.device) / (fan + 1)
    for _ in range(passes):
        span = (hi - lo)[..., None]
        mids = lo[..., None] + span * frac
        ok = g_of(mids)  # (..., fan) monotone: 0...0 1...1
        m = (~ok).sum(-1).to(lo.dtype)  # fails in [0, fan]
        step = (hi - lo) / (fan + 1)
        new_lo = lo + step * m
        hi = torch.minimum(new_lo + step, hi)
        lo = new_lo
    return hi


def projection_linf_bisect_pair(t2: torch.Tensor, w: torch.Tensor, b2: torch.Tensor,
                                iters: int = 30, fan: int = 7) -> torch.Tensor:
    """Linf projection of S points per hyperplane: t2 (S, B, D), w (B, D),
    b2 (S, B) -> d (S, B, D)."""
    sign = 2.0 * ((w * t2).sum(-1) - b2 >= 0).to(t2.dtype) - 1.0  # (S, B)
    s3 = sign[..., None]
    need = ((w * t2).sum(-1) - b2) * sign  # >= 0

    nz = (w != 0).to(t2.dtype)  # (B, D)
    aw = w.abs()
    p = torch.where(w * s3 > 0, t2, 1.0 - t2)  # (S, B, D)
    awp = aw * p * nz
    reachable = awp.sum(-1) >= need

    def g_of(mids):  # (S, B, fan) -> (S, B, fan)
        return torch.minimum(aw[None, :, :, None] * mids[:, :, None, :],
                             awp[..., None]).sum(-2) >= need[..., None]

    lam = _fan_search(g_of, torch.zeros_like(need), torch.ones_like(need), iters, fan)[..., None]
    d = -torch.sign(w) * s3 * torch.where(reachable[..., None], torch.minimum(lam, p), p)
    return d * nz


def projection_l2_bisect_pair(t2: torch.Tensor, w: torch.Tensor, b2: torch.Tensor,
                              iters: int = 40, fan: int = 7) -> torch.Tensor:
    """L2 projection of S points per hyperplane (see the Linf pair form).

    g(alpha) = sum_i min(alpha w_i^2, |w_i| p_i); alpha* can span many
    orders of magnitude, so the search runs in log space between the
    unclipped lower bound and the largest breakpoint."""
    sign = 2.0 * ((w * t2).sum(-1) - b2 >= 0).to(t2.dtype) - 1.0  # (S, B)
    s3 = sign[..., None]
    need = ((w * t2).sum(-1) - b2) * sign

    nz = (w.abs() > 1e-8).to(t2.dtype)  # (B, D)
    aw = w.abs()
    p = torch.where(w * s3 > 0, t2, 1.0 - t2)  # (S, B, D)
    w2 = w * w * nz  # (B, D), sign-independent
    wp = aw * p * nz  # (S, B, D)
    reachable = wp.sum(-1) >= need

    w2sum = w2.sum(-1).clamp_min(1e-30)  # (B,)
    lo = torch.log(need.clamp_min(1e-30) / w2sum)
    breakpoints = torch.where(nz > 0, p / aw.clamp_min(1e-30), 0.0)
    hi = torch.log(breakpoints.amax(dim=-1).clamp_min(1e-30))
    hi = torch.maximum(hi, lo + 1e-6)

    def g_of(mids):  # log-space candidates (S, B, fan)
        alpha = torch.exp(mids)
        return torch.minimum(w2[None, :, :, None] * alpha[:, :, None, :],
                             wp[..., None]).sum(-2) >= need[..., None]

    alpha = torch.exp(_fan_search(g_of, lo, hi, iters, fan))[..., None]
    d = -torch.sign(w) * s3 * torch.where(reachable[..., None], torch.minimum(alpha * aw, p), p)
    return d * nz


def projection_linf(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dim = w.shape[1]
    sign = 2.0 * ((w * t).sum(1) - b >= 0).to(t.dtype) - 1.0
    w = w * sign[:, None]
    b = b * sign

    a = (w < 0).to(t.dtype)
    d = (a - t) * (w != 0).to(t.dtype)
    p = a - t * (2.0 * a - 1.0)
    b = b - (w * t).sum(1)
    b0 = (w * d).sum(1)

    # one sort carries w and d along with the p keys; everything after is
    # positional in sorted order
    ps_asc, order = torch.sort(p, dim=1, stable=True)
    ws = _take(w, order).flip(1)  # descending-p order
    bs2 = -ws * _take(d, order).flip(1)

    s = torch.cumsum(ws.abs(), dim=1)
    sb = torch.cumsum(bs2, dim=1) + b0[:, None]

    b2 = sb[:, -1] - s[:, -1] * ps_asc[:, 0]
    c_l = (b - b2) > 0
    c2 = ((b - b0) > 0) & ~c_l

    lb = torch.zeros_like(b)
    ub = torch.full_like(b, dim - 1)
    for _ in range(math.ceil(math.log2(dim))):
        counter4 = torch.floor((lb + ub) / 2)
        counter2 = counter4.long()[:, None]
        # the (D-1-counter)-th smallest p is ps_asc's column D-1-counter
        p_piv = _take(ps_asc, dim - 1 - counter2)
        b2i = (_take(sb, counter2) - _take(s, counter2) * p_piv)[:, 0]
        c = (b - b2i) > 0
        lb = torch.where(c, counter4, lb)
        ub = torch.where(c, ub, counter4)
    lb_i = lb.long()[:, None]

    lmbd_l = ((b - sb[:, -1]) / (-s[:, -1])).clamp_min(0.0)[:, None]
    d_cl = (2.0 * a - 1.0) * lmbd_l
    lmbd_2 = ((b[:, None] - _take(sb, lb_i)) / (-_take(s, lb_i))).clamp_min(0.0)
    d_c2 = torch.minimum(lmbd_2, d) * a + torch.maximum(-lmbd_2, d) * (1.0 - a)

    d = torch.where(c_l[:, None], d_cl, torch.where(c2[:, None], d_c2, d))
    return d * (w != 0).to(t.dtype)


def projection_l2(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dim = w.shape[1]
    c = (w * t).sum(1) - b
    ind2 = 2.0 * (c >= 0).to(t.dtype) - 1.0
    w = w * ind2[:, None]
    c = c * ind2

    nonzero = w.abs() > 1e-8
    w_safe = torch.where(nonzero, w, 1.0)
    r_raw = torch.maximum(t / w_safe, (t - 1.0) / w_safe).clamp(-1e12, 1e12)
    r = torch.where(nonzero, r_raw, 1e12)
    r = torch.where(r == -1e12, 1e12, r)
    rs, order = torch.sort(r, dim=1, stable=True)  # w^2 carried along
    w3s = _take(w * w, order)
    rs2 = torch.cat([rs[:, 1:], torch.zeros_like(rs[:, :1])], dim=1)
    rs = torch.where(rs == 1e12, 0.0, rs)
    rs2 = torch.where(rs2 == 1e12, 0.0, rs2)
    w5 = w3s.sum(dim=1, keepdim=True)
    ws = w5 - torch.cumsum(w3s, dim=1)
    d = -(r * w) * nonzero.to(t.dtype)
    s = torch.cat([-w5 * rs[:, 0:1], torch.cumsum((-rs2 + rs) * ws, dim=1) - w5 * rs[:, 0:1]],
                  dim=1)  # (B, D+1)

    c4 = (s[:, 0] + c) < 0
    c3 = ((d * w).sum(1) + c) > 0
    c2 = ~(c4 | c3)

    lb = torch.zeros_like(c)
    ub = torch.full_like(c, dim - 1)
    for _ in range(math.ceil(math.log2(dim))):
        counter4 = torch.floor((lb + ub) / 2)
        counter2 = counter4.long()[:, None]
        c3i = (_take(s, counter2)[:, 0] + c) > 0
        lb = torch.where(c3i, counter4, lb)
        ub = torch.where(c3i, ub, counter4)
    lb_i = lb.long()[:, None]

    alpha4 = c / w5[:, 0]
    d_c4 = -alpha4[:, None] * w
    ws_lb = _take(ws, lb_i)[:, 0]
    alpha2 = (_take(s, lb_i)[:, 0] + c) / torch.where(ws_lb == 0, 1.0, ws_lb) \
        + _take(rs, lb_i)[:, 0]
    alpha2 = torch.where(ws_lb == 0, 0.0, alpha2)
    c5 = (alpha2[:, None] > r).to(t.dtype)
    d_c2 = d * c5 - alpha2[:, None] * w * (1.0 - c5)

    d = torch.where(c4[:, None], d_c4, torch.where(c2[:, None], d_c2, d))
    return d * nonzero.to(t.dtype)


def projection_l1(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dim = w.shape[1]
    c = (w * t).sum(1) - b
    ind2 = 2.0 * (c >= 0).to(t.dtype) - 1.0
    w = w * ind2[:, None]
    c = c * ind2

    nonzero = w.abs() > 1e-8
    w_safe = torch.where(nonzero, w, 1.0)
    r = torch.where(nonzero, (1.0 / w_safe).abs().clamp_max(1e12), 1e12)
    indr = torch.argsort(r, dim=1, stable=True)
    indr_rev = torch.argsort(indr, dim=1, stable=True)

    c6 = (w < 0).to(t.dtype)
    d = (-t + c6) * nonzero.to(t.dtype)
    ds = _take(torch.minimum(-w * t, w * (1.0 - t)), indr)
    s = torch.cumsum(torch.cat([c[:, None], ds], dim=1), dim=1)  # (B, D+1)

    c2 = s[:, -1] < 0

    lb = torch.zeros_like(c)
    ub = torch.full_like(c, float(s.shape[1]))
    for _ in range(math.ceil(math.log2(dim))):
        counter4 = torch.floor((lb + ub) / 2)
        counter2 = counter4.long()[:, None]
        c3i = _take(s, counter2)[:, 0] > 0
        lb = torch.where(c3i, counter4, lb)
        ub = torch.where(c3i, ub, counter4)
    lb2 = lb.long()

    # c2 rows: zero the |w|-sorted tail beyond lb, alpha at the pivot
    # lb2 reaches D only in rows that are not c2, whose d_c2 is unused
    indr_piv = _take(indr, lb2.clamp_max(dim - 1)[:, None])  # (B, 1)
    w_piv = _take(w, indr_piv)[:, 0]
    alpha = -_take(s, lb2[:, None])[:, 0] / torch.where(w_piv == 0, 1.0, w_piv)
    u2 = torch.arange(dim, dtype=t.dtype, device=t.device)[None, :]
    u3 = _take(u2 < lb[:, None], indr_rev)  # positions (in sorted order) kept
    d_c2 = d * u3.to(t.dtype)
    cols = torch.arange(dim, device=t.device)[None, :]
    d_c2 = torch.where(cols == indr_piv, alpha[:, None], d_c2)

    d = torch.where(c2[:, None], d_c2, d)
    return d * nonzero.to(t.dtype)
