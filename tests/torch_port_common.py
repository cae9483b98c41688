"""Shared pieces of the adaa_tpu_torch tests: one set of LCNN weights,
made with numpy from a seed, for the JAX model and its torch port."""
import numpy as np
import torch

from adaa_tpu_torch import models as tmodels
from adaa_tpu_torch.models.lcnn import BNS, CONVS
from adaa_tpu_torch.models.weights import lcnn_state_dict_from_flax

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


def waves(seed: int, batch: int = 2, length: int = 64_600) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, length)).astype(np.float32)

