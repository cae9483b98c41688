"""Shared pieces of the adaa_tpu_torch tests: sets of LCNN, SpecRNet and
RawNet3 weights, made with numpy from a seed, for the JAX models and their
torch ports."""
import numpy as np
import torch

from adaa_tpu_torch import models as tmodels
from adaa_tpu_torch.models.lcnn import BNS, CONVS
from adaa_tpu_torch.models.rawnet3 import _sinc_init_hz
from adaa_tpu_torch.models.weights import (lcnn_state_dict_from_flax,
                                           rawnet3_state_dict_from_flax,
                                           specrnet_state_dict_from_flax)

CFG_F32 = {"input_channels": 1, "frontend_algorithm": ["lfcc"]}
CFG_BF16 = {**CFG_F32, "compute_dtype": "bfloat16"}
# the fused configuration: fused LFCC kernel + fused trunk segments
CFG_FUSED = {**CFG_BF16, "fused_frontend": True, "fused_trunk": True}


def lcnn_variables(seed: int = 0):
    """The JAX LCNN's {"params", "batch_stats"} tree as numpy arrays.

    Weights are uniform within torch's default bounds, biases are
    non-zero, and the BN running stats are randomised (mean ~ N(0, 0.1),
    var ~ U(0.5, 2)) so that BN folding is exercised.
    """
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def uni(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(f32)

    params = {}
    for i, (cin, cout, k) in CONVS.items():
        fan_in = cin * k * k
        params[f"conv{i}"] = {"kernel": uni((k, k, cin, cout), 1 / np.sqrt(fan_in)),
                              "bias": uni((cout,), 0.1)}
    dim, hidden = 160, 80
    for j in (0, 1):
        params[f"blstm{j}"] = {
            d: {"weight_ih": uni((dim, 4 * hidden), 1 / np.sqrt(hidden)),
                "weight_hh": uni((hidden, 4 * hidden), 1 / np.sqrt(hidden)),
                "bias_ih": uni((4 * hidden,), 1 / np.sqrt(hidden)),
                "bias_hh": uni((4 * hidden,), 1 / np.sqrt(hidden))}
            for d in ("fwd", "bwd")
        }
    params["output"] = {"kernel": uni((dim, 1), 1 / np.sqrt(dim)), "bias": uni((1,), 0.1)}
    stats = {f"bn{i}": {"mean": (rng.standard_normal(c) * 0.1).astype(f32),
                        "var": rng.uniform(0.5, 2.0, c).astype(f32)}
             for i, c in BNS.items()}
    return {"params": params, "batch_stats": stats}


def port_lcnn(cfg, variables) -> torch.nn.Module:
    """The port's LCNN in eval() carrying the JAX variables."""
    model = tmodels.get_model("lcnn", cfg)
    model.load_state_dict(lcnn_state_dict_from_flax(variables))
    return model.eval()


def specrnet_variables(seed: int = 0):
    """The JAX SpecRNet's {"params", "batch_stats"} tree as numpy arrays:
    weights uniform within torch's default bounds, non-zero biases, BN
    affines near 1 / 0 and randomised running stats (as ``lcnn_variables``)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def uni(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(f32)

    def conv(k, cin, cout):
        return {"kernel": uni((k, k, cin, cout), 1 / np.sqrt(k * k * cin)), "bias": uni((cout,), 0.1)}

    def bn(c):
        return ({"scale": rng.uniform(0.5, 1.5, c).astype(f32), "bias": uni((c,), 0.1)},
                {"mean": (rng.standard_normal(c) * 0.1).astype(f32),
                 "var": rng.uniform(0.5, 2.0, c).astype(f32)})

    def dense(cin, cout):
        return {"kernel": uni((cin, cout), 1 / np.sqrt(cin)), "bias": uni((cout,), 1 / np.sqrt(cin))}

    params, stats = {}, {}
    params["first_bn"], stats["first_bn"] = bn(1)
    for name, cin, cout in (("block0", 1, 20), ("block2", 20, 64), ("block4", 64, 64)):
        p, s = {"conv1": conv(3, cin, cout), "conv2": conv(3, cout, cout)}, {}
        p["bn2"], s["bn2"] = bn(cout)
        if name != "block0":
            p["bn1"], s["bn1"] = bn(cin)
        if cin != cout:
            p["conv_downsample"] = conv(1, cin, cout)
        params[name], stats[name] = p, s
    for i, c in ((0, 20), (2, 64), (4, 64)):
        params[f"fc_attention{i}"] = dense(c, c)
    params["bn_before_gru"], stats["bn_before_gru"] = bn(64)
    hidden = 64
    params["gru"] = {
        f"l{layer}_{d}": {"weight_ih": uni((64 if layer == 0 else 128, 3 * hidden), 1 / 8),
                          "weight_hh": uni((hidden, 3 * hidden), 1 / 8),
                          "bias_ih": uni((3 * hidden,), 1 / 8),
                          "bias_hh": uni((3 * hidden,), 1 / 8)}
        for layer in (0, 1) for d in ("fwd", "bwd")
    }
    params["fc1_gru"] = dense(128, 128)
    params["fc2_gru"] = dense(128, 1)
    return {"params": params, "batch_stats": stats}


def port_specrnet(cfg, variables) -> torch.nn.Module:
    """The port's SpecRNet in eval() carrying the JAX variables."""
    model = tmodels.get_model("specrnet", cfg)
    model.load_state_dict(specrnet_state_dict_from_flax(variables))
    return model.eval()


def rawnet3_variables(seed: int = 0):
    """The JAX RawNet3's {"params", "batch_stats"} tree as numpy arrays,
    random within torch's default bounds; BN statistics randomised. (The
    shapes do not depend on the wave length.)"""
    import jax
    import jax.numpy as jnp

    from adaa_tpu import models as jmodels

    module = jmodels.get_model("rawnet3", {})
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)},
                                                jnp.zeros((1, 5041)), train=False))
    rng = np.random.default_rng(seed)
    low, band = _sinc_init_hz(128, 8000.0, 50.0, 50.0)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            bound = 1 / np.sqrt(np.prod(shape[:-1]))
            return rng.uniform(-bound, bound, shape)
        if name in ("scale", "alpha", "instancenorm_weight"):
            return rng.uniform(0.5, 1.5, shape)
        if name in ("bias", "instancenorm_bias", "mean"):
            return rng.standard_normal(shape) * 0.1
        if name == "var":
            return rng.uniform(0.5, 2.0, shape)
        return {"low_hz_": low, "band_hz_": band}[name].reshape(shape)

    tree = jax.tree_util.tree_map_with_path(leaf, dict(shapes))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def port_rawnet3(cfg, variables) -> torch.nn.Module:
    """The port's RawNet3 in eval() carrying the JAX variables."""
    model = tmodels.get_model("rawnet3", cfg)
    model.load_state_dict(rawnet3_state_dict_from_flax(variables), strict=True)
    return model.eval()


def waves(seed: int, batch: int = 2, length: int = 64_600) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, length)).astype(np.float32)



# --------------------------------------------------------------------------
# A numpy model of csrc/lfcc.cu's FFT plan (ops/lfcc_fused.py's tables)
# --------------------------------------------------------------------------

def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _dft4(v, axis):
    """The kernel's dft4 along ``axis`` (length 4) of (re, im) arrays."""
    a0, a1, a2, a3 = ([np.take(c, i, axis=axis) for c in v] for i in range(4))
    t0 = (a0[0] + a2[0], a0[1] + a2[1])
    t1 = (a0[0] - a2[0], a0[1] - a2[1])
    t2 = (a1[0] + a3[0], a1[1] + a3[1])
    d = (a1[0] - a3[0], a1[1] - a3[1])
    t3 = (d[1], -d[0])  # -i (a1 - a3)
    out = [(t0[0] + t2[0], t0[1] + t2[1]), (t1[0] + t3[0], t1[1] + t3[1]),
           (t0[0] - t2[0], t0[1] - t2[1]), (t1[0] - t3[0], t1[1] - t3[1])]
    return tuple(np.stack([o[c] for o in out], axis=axis) for c in range(2))


def _dft8(v, axis):
    """The kernel's dft8 along ``axis`` (length 8): dft4 of the even and odd
    points, combined with W8^k."""
    dtype = v[0].dtype
    s = dtype.type(0.70710678118654752)
    ev = tuple(np.take(c, [0, 2, 4, 6], axis=axis) for c in v)
    od = tuple(np.take(c, [1, 3, 5, 7], axis=axis) for c in v)
    e, o = _dft4(ev, axis), _dft4(od, axis)
    o_k = [tuple(np.take(c, i, axis=axis) for c in o) for i in range(4)]
    o1, o2, o3 = o_k[1], o_k[2], o_k[3]
    o_k[1] = (s * (o1[0] + o1[1]), s * (o1[1] - o1[0]))
    o_k[2] = (o2[1], -o2[0])
    o_k[3] = (s * (o3[1] - o3[0]), -s * (o3[0] + o3[1]))
    e_k = [tuple(np.take(c, i, axis=axis) for c in e) for i in range(4)]
    out = [(e_k[i][0] + o_k[i][0], e_k[i][1] + o_k[i][1]) for i in range(4)]
    out += [(e_k[i][0] - o_k[i][0], e_k[i][1] - o_k[i][1]) for i in range(4)]
    return tuple(np.stack([q[c] for q in out], axis=axis) for c in range(2))


def lfcc_fft_power(x: np.ndarray, dtype=np.float64) -> np.ndarray:
    """csrc/lfcc.cu's power spectrum in numpy, in ``dtype``: the reflected,
    windowed frames packed as z[m] = u[2m] + i u[2m+1], passes 1-3 of the
    256-point FFT with the kernel's twiddle table, the real split. x (B,
    64600) -> (B, 404, 257)."""
    from adaa_tpu_torch.ops import lfcc_fused as lf

    tab = (lf.fft_table64() if dtype == np.float64 else lf.fft_table()).astype(dtype)
    win = tab[lf.TAB_WIN:lf.TAB_WIN + 512]
    n = np.arange(512)
    i = 160 * np.arange(404)[:, None] - 256 + n[None, :]
    u = (x[:, lf.reflect_index(i)].astype(dtype) * win).astype(dtype)  # (B, 404, 512)
    z = (u[..., 0::2], u[..., 1::2])  # (B, 404, 256)

    def tw(off, count, idx):
        return tab[off + idx], tab[off + count + idx]

    # pass 1: (n1, n2) -> A (k1, n2) = W256^(n2 k1) DFT8_n1
    v = tuple(c.reshape(c.shape[:-1] + (8, 32)) for c in z)
    a = _dft8(v, axis=-2)
    w1 = tw(lf.TAB_W256, 256, np.arange(256).reshape(8, 32))
    a = tuple(np.where(np.arange(8)[:, None] == 0, a[c], _cmul(a, w1)[c]) for c in range(2))
    # pass 2: A[k1][4 m1 + m2] -> B (k1, k2a, m2) = W32^(m2 k2a) DFT8_m1
    v = tuple(c.reshape(c.shape[:-1] + (8, 4)) for c in a)  # (k1, m1, m2)
    bq = _dft8(v, axis=-2)  # (k1, k2a, m2)
    w2 = tw(lf.TAB_W32, 32, np.arange(32).reshape(8, 4))
    bq = tuple(np.where(np.arange(8)[:, None] == 0, bq[c], _cmul(bq, w2)[c]) for c in range(2))
    # pass 3: DFT4 over m2 -> Z[k1 + 8 k2a + 64 k2b]
    zz = _dft4(bq, axis=-1)  # (k1, k2a, k2b)
    zz = tuple(np.moveaxis(c, (-3, -2, -1), (-1, -2, -3)).reshape(c.shape[:-3] + (256,))
               for c in zz)
    # the real split
    k = np.arange(256)
    km = (256 - k) % 256
    zk, zm = (zz[0][..., k], zz[1][..., k]), (zz[0][..., km], zz[1][..., km])
    half = dtype(0.5)
    e = (half * (zk[0] + zm[0]), half * (zk[1] - zm[1]))
    o = (half * (zk[1] + zm[1]), -half * (zk[0] - zm[0]))
    wo = _cmul(o, tw(lf.TAB_W512, 256, k))
    xr, xi = e[0] + wo[0], e[1] + wo[1]
    power = np.concatenate([xr * xr + xi * xi, ((zz[0][..., :1] - zz[1][..., :1]) ** 2)], -1)
    if dtype != np.float64:
        # bins below TINY_BIN x the frame's energy: the float64 direct DFT
        tiny = lf.TINY_BIN * (u.astype(dtype) ** 2).sum(-1, keepdims=True)
        exact = np.abs(np.fft.rfft(u.astype(np.float64), axis=-1)) ** 2
        power = np.where(power < tiny, exact.astype(dtype), power)
    return power.astype(dtype)
