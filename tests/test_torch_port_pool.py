"""The 1-D max pools of the port against the JAX package (CPU).

* ``ops/pool.py`` (the first-max pool kernel's plain version, which a
  CPU tensor runs) against ``adaa_tpu/ops/pallas_pool.max_pool_1d`` in
  interpret mode: forward and input gradient bit-equal, on random data
  and on data with exact ties in every window (both route a tie's
  cotangent to the first maximal slot), with and without a dropped tail.
* ``models/layers.max_pool_1d`` (the port's default pool) against the
  JAX package's default eqmask pool (``layers.max_pool_1d``): forward and
  input gradient bit-equal in f32 and bf16, ties included (every tied
  slot gets the whole cotangent), tail gradient zero.
(The CUDA kernels against the plain version: tests/test_torch_port_gpu.py.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaa_tpu.models import layers as jlayers
from adaa_tpu.ops import pallas_pool
from adaa_tpu_torch.models import layers
from adaa_tpu_torch.ops import pool

torch.set_num_threads(2)


def _data(seed: int, shape, ties: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if ties:  # a coarse grid: most windows hold several equal maxima
        return rng.integers(-3, 4, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _jax_pool(fn, x: np.ndarray, g: np.ndarray, dtype):
    out, vjp = jax.vjp(fn, jnp.asarray(x).astype(dtype))
    (dx,) = vjp(jnp.asarray(g).astype(dtype))
    return np.asarray(out.astype(jnp.float32)), np.asarray(dx.astype(jnp.float32))


def _port_pool(fn, x: np.ndarray, g: np.ndarray, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out = fn(xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g).to(dtype))
    assert out.dtype == dx.dtype == dtype
    return out.detach().float().numpy(), dx.float().numpy()


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("window,shape", [(5, (2, 40, 128)), (3, (4, 36, 256)),
                                          (5, (2, 42, 128))])
def test_first_max_pool_matches_pallas(window, shape, ties):
    x = _data(window + shape[1], shape, ties)
    g = _data(7, (shape[0], shape[1] // window, shape[2]), False)
    jout, jdx = _jax_pool(lambda a: pallas_pool.max_pool_1d(a, window, interpret=True),
                          x, g, jnp.bfloat16)
    out, dx = _port_pool(lambda a: pool.max_pool_1d(a, window), x, g, torch.bfloat16)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(dx, jdx)
    if ties:  # exactly one slot per window gets the cotangent
        hit = (dx[:, : (shape[1] // window) * window] != 0).reshape(
            shape[0], -1, window, shape[2]).sum(axis=2)
        assert hit.max() == 1 and (dx[:, (shape[1] // window) * window:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_eqmask_pool_matches_jax(dtype, ties):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = _data(11, (3, 17, 8), ties)
    g = _data(12, (3, 5, 8), False)
    jout, jdx = _jax_pool(lambda a: jlayers.max_pool_1d(a, 3), x, g, jdtype)
    out, dx = _port_pool(lambda a: layers.max_pool_1d(a, 3), x, g, dtype)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(dx, jdx)
    assert (dx[:, 15:] == 0).all()
    if ties:  # every tied slot gets the whole cotangent: more slots than windows
        assert int((dx[:, :15] != 0).sum()) > 3 * 5 * 8


def test_cpu_wrapper_runs_plain_and_checks_inputs():
    x = torch.from_numpy(_data(20, (2, 11, 24), True)).to(torch.bfloat16)
    before = dict(pool.LAUNCHES)
    torch.testing.assert_close(pool.max_pool_1d(x, 5), pool.max_pool_1d_reference(x, 5),
                               rtol=0, atol=0)
    assert pool.LAUNCHES == before
    with pytest.raises(TypeError):
        pool.max_pool_1d(x.float(), 5)
    with pytest.raises(ValueError):
        pool.max_pool_1d(x[:, :4], 5)
    with pytest.raises(ValueError, match="CUDA"):
        pool.kernel_fwd(x, 5)
