"""The fused Bottle2neck: the port's plain version against the Pallas kernel
(CPU; the CUDA kernels against the plain version are in
tests/test_torch_port_gpu.py).

On the CPU ``ops/b2n.fused_bottle2neck`` runs its plain version; the JAX
op runs its Pallas kernels in interpret mode, as
tests/test_pallas_b2n.py runs them, on the three cases of that file at
batch 2: a projection residual with pool 5 across two uneven 480-row
tiles, the identity with no pool in one partial tile, and the identity
with pool 3 across two whole tiles. Weights are bf16 values and the
folded BN affines random, shared through numpy.

Tolerances: both sides take the same bf16 products and sum them in f32
in other orders (one matmul here, a VMEM tile dot there), so an output
near a bf16 rounding boundary can round the other way:
* forward: >= 99% of outputs bit-equal and a mean relative error
  <= 1e-4 (measured >= 99.6% and <= 1.0e-5), also over the first and last
  8 output rows alone, where the convs see the sequence edge's zeros;
* dx: relative L2 <= 2e-3 without a pool (measured 6.6e-4) and <= 1.5e-2
  with one (measured 4.0e-3 and 5.3e-3): a rounding flip in dq or in a
  chain input, or a relu decision near zero, moves whole terms, and
  where a flipped y element ties or unties its window's max, the pool's
  equality route sends a whole cotangent to another slot.
The JAX package's own bands for its kernel against flax are 0.02 and 0.05.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu.ops import pallas_b2n as jb2n
from adaa_tpu_torch.ops import b2n

torch.set_num_threads(2)

TT = jb2n.TT
CASES = [(256, 2, 5, TT + 200), (1024, 4, 0, 360), (1024, 3, 3, 2 * TT)]
EDGE = 8


def _params(seed: int, cin: int, projection: bool) -> dict:
    """Folded parameters as f32 numpy (the weight matrices bf16 values)."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731

    def uni(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def affine(n):
        return (uni((n,), 0.1), rng.uniform(0.5, 1.5, n).astype(np.float32),
                (rng.standard_normal(n) * 0.1).astype(np.float32))

    p = {"w1": bf(uni((cin, 1024), 1 / np.sqrt(cin))),
         "wc": bf(uni((21 * 128, 128), 1 / np.sqrt(3 * 128))),
         "w3": bf(uni((1024, 1024), 1 / np.sqrt(1024))),
         "wr": bf(uni((cin, 1024), 1 / np.sqrt(cin))) if projection else None}
    p["b1"], p["s1"], p["t1"] = affine(1024)
    p["bc"], p["sc"], p["tc"] = affine(896)
    p["b3"], p["s3"], p["t3"] = affine(1024)
    return p


def _jax_params(p: dict) -> jb2n.B2NParams:
    def conv(name, a):
        if a is None:
            return None
        a = jnp.asarray(a)
        return a.astype(jnp.bfloat16) if name[0] == "w" else a.reshape(1, -1)
    return jb2n.B2NParams(**{k: conv(k, p[k]) for k in jb2n.B2NParams._fields})


def _port_params(p: dict) -> b2n.B2NParams:
    def conv(name, a):
        if a is None:
            return None
        t = torch.from_numpy(a)
        return t.to(torch.bfloat16) if name[0] == "w" else t
    return b2n.B2NParams(**{k: conv(k, p[k]) for k in b2n.B2NParams._fields})


def _inputs(seed: int, cin: int, pool: int, t: int):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, t, cin)) * 0.3).astype(np.float32)
    g = rng.standard_normal((2, t // pool if pool else t, 1024)).astype(np.float32)
    return x, g


def _jax(x, g, p, dilation, pool):
    out, vjp = jax.vjp(lambda a: jb2n.fused_bottle2neck(a, _jax_params(p), dilation, pool, True),
                       jnp.asarray(x).astype(jnp.bfloat16))
    (dx,) = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    return np.asarray(out.astype(jnp.float32)), np.asarray(dx.astype(jnp.float32))


def _port(x, g, p, dilation, pool):
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out = b2n.fused_bottle2neck(xt, _port_params(p), dilation, pool)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g).to(torch.bfloat16))
    assert out.dtype == dx.dtype == torch.bfloat16
    return out.detach().float().numpy(), dx.float().numpy()


def _mean_rel(a, b):
    return float(np.abs(a - b).mean() / np.abs(b).mean())


@pytest.mark.parametrize("cin,dilation,pool,t", CASES)
def test_plain_matches_pallas(cin, dilation, pool, t):
    p = _params(cin + dilation, cin, projection=cin != 1024)
    x, g = _inputs(t + pool, cin, pool, t)
    jout, jdx = _jax(x, g, p, dilation, pool)
    out, dx = _port(x, g, p, dilation, pool)
    assert out.shape == jout.shape == (2, t // pool if pool else t, 1024)
    assert float((out == jout).mean()) >= 0.99
    assert _mean_rel(out, jout) <= 1e-4
    for rows in (slice(0, EDGE), slice(-EDGE, None)):
        assert _mean_rel(out[:, rows], jout[:, rows]) <= 1e-4, rows
    rel = np.linalg.norm(dx - jdx) / np.linalg.norm(jdx)
    assert rel <= (1.5e-2 if pool else 2e-3), rel


def test_weight_gradient_raises_and_inputs_checked():
    p = _port_params(_params(1, 256, projection=True))
    x = torch.from_numpy(_inputs(2, 256, 5, 40)[0]).to(torch.bfloat16).requires_grad_(True)
    w3 = p.w3.clone().requires_grad_(True)
    out = b2n.fused_bottle2neck(x, p._replace(w3=w3), 2, 5)
    with pytest.raises(RuntimeError, match="need_dw=False"):
        out.float().sum().backward()
    with pytest.raises(NotImplementedError):
        b2n.fused_bottle2neck(x, p, 2, 5, need_dw=True)
    with pytest.raises(ValueError, match="divisible"):
        b2n.fused_bottle2neck(x[:, :38], p, 2, 5)
    with pytest.raises(ValueError, match="identity"):
        b2n.fused_bottle2neck(x, p._replace(wr=None), 2, 5)
    with pytest.raises(ValueError, match="CUDA"):
        b2n.kernel_fwd(x.detach(), p, 2)


def test_cpu_wrapper_runs_plain_without_launches():
    p = _port_params(_params(3, 1024, projection=False))
    x = torch.from_numpy(_inputs(4, 1024, 3, 48)[0]).to(torch.bfloat16)
    before = dict(b2n.LAUNCHES)
    torch.testing.assert_close(b2n.fused_bottle2neck(x, p, 3, 3),
                               b2n.fused_bottle2neck_reference(x, p, 3, 3), rtol=0, atol=0)
    assert b2n.LAUNCHES == before


def test_transposed_chain_weights():
    wc = torch.arange(21 * 128 * 128, dtype=torch.float32).reshape(21 * 128, 128)
    wct = b2n.transposed_chain_weights(wc)
    for blk in (0, 7, 20):
        rows = slice(blk * 128, (blk + 1) * 128)
        torch.testing.assert_close(wct[rows], wc[rows].T, rtol=0, atol=0)
