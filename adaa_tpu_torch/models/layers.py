"""Shared building blocks with the JAX package's numerics.

Port of the parts of ``adaa_tpu/models/layers.py`` that LCNN,
RawNet3 and SpecRNet use:

* the torch-default initialisers, drawing from an explicit
  ``torch.Generator``;
* ``max_feature_map``, ``max_pool_1d``, ``max_pool_2d`` and
  ``mfm_pool_2d`` on channels-last tensors, as
  ``torch.autograd.Function``s with the
  equality-mask backward (the JAX default): every element equal to the
  max receives the whole cotangent. This is not torch's own max-pool
  backward, which routes to a single argmax. ``ADAA_MFM_EQMASK=0``
  (``max_feature_map``, ``mfm_pool_2d``) and ``ADAA_POOL_EQMASK=0``
  (``max_pool_1d``, ``max_pool_2d``), read per call as the JAX package
  reads them, restore the tie-splitting backward of ``torch.maximum`` /
  ``amax``: a tied cotangent is split evenly, as ``jnp.maximum`` /
  ``jnp.max`` split it;
* ``BiLSTM``: a bidirectional LSTM as an explicit f32 recurrence in
  plain torch ops, gate order (i, f, g, o), parameters named as
  ``nn.LSTM`` names them. cuDNN's ``nn.LSTM`` refuses its backward in
  ``eval()``, and the attacks need the input gradient of a model in
  ``eval()``; the explicit recurrence also follows the JAX math step
  for step;
* ``BiGRU``: ``nn.GRU(num_layers, bidirectional=True)`` as the same kind
  of explicit f32 recurrence, gate order (r, z, n);
* ``batch_norm``: flax's ``nn.BatchNorm`` on a channels-last tensor, in
  train and in eval, its running statistics held in an ``nn.BatchNorm*d``
  (whose keys the reference's ``state_dict`` has); in train over a batch
  sharded across processes (``parallel.mesh.sharded``), its statistics
  are the global batch's, as flax's under GSPMD;
* ``dropout``: ``F.dropout``, whose keep-mask over a sharded batch is
  the global batch's draw, sliced.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from adaa_tpu_torch.parallel import mesh

# ---------------------------------------------------------------------------
# Initializers (torch defaults), in place, from an explicit generator
# ---------------------------------------------------------------------------

_KAIMING_GAIN = math.sqrt(2.0 / (1 + 5.0))  # kaiming_uniform(a=sqrt(5))


def uniform_init(t: torch.Tensor, bound: float, generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def kaiming_uniform_conv(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """torch Conv default on an OIHW weight: fan_in = in * kh * kw."""
    fan_in = math.prod(t.shape[1:])
    return uniform_init(t, _KAIMING_GAIN * math.sqrt(3.0 / fan_in), generator)


def kaiming_uniform_linear(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """torch Linear default on an (out, in) weight."""
    return uniform_init(t, _KAIMING_GAIN * math.sqrt(3.0 / t.shape[1]), generator)


def conv_bias_init(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    return uniform_init(t, 1.0 / math.sqrt(fan_in), generator)


# ---------------------------------------------------------------------------
# Max reductions with the equality-mask backward (channels last)
# ---------------------------------------------------------------------------

class _MaxFeatureMap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        a, b = x.chunk(2, dim=-1)
        y = torch.maximum(a, b)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        a, b = x.chunk(2, dim=-1)
        da = torch.where(a == y, g, 0.0)
        db = torch.where(b == y, g, 0.0)
        return torch.cat([da, db], dim=-1).to(x.dtype)


def switch_on(env: str) -> bool:
    """One of the JAX package's numerics switches (``ADAA_MFM_EQMASK``,
    ``ADAA_FOLD_BN``, ...): on unless the variable is ``"0"``, read per call."""
    return os.environ.get(env) != "0"


def max_feature_map(x: torch.Tensor) -> torch.Tensor:
    """MFM maxout over channel halves of the last axis: max(x[..., :C/2], x[..., C/2:])."""
    if x.shape[-1] % 2:
        raise ValueError("MFM needs an even channel count")
    if switch_on("ADAA_MFM_EQMASK"):
        return _MaxFeatureMap.apply(x)
    a, b = x.chunk(2, dim=-1)
    return torch.maximum(a, b)


def _windows(x: torch.Tensor, window: int, split_channels: bool) -> torch.Tensor:
    """(B, H, W, C) -> (B, H2, win, W2, win, [2,] C') with the remainder dropped."""
    b, h, w, c = x.shape
    h2, w2 = h // window, w // window
    x = x[:, : h2 * window, : w2 * window, :]
    if split_channels:
        return x.reshape(b, h2, window, w2, window, 2, c // 2)
    return x.reshape(b, h2, window, w2, window, c)


def _eqmask_grad(x, y, g, window, split_channels):
    """dx of a window max: g to every element equal to its window's max."""
    b, h, w, c = x.shape
    xw = _windows(x, window, split_channels)
    if split_channels:
        y_b, g_b = y[:, :, None, :, None, None, :], g[:, :, None, :, None, None, :]
    else:
        y_b, g_b = y[:, :, None, :, None, :], g[:, :, None, :, None, :]
    h2, w2 = h // window, w // window
    dx = torch.where(xw == y_b, g_b, 0.0).reshape(b, h2 * window, w2 * window, c)
    if h2 * window < h or w2 * window < w:
        dx = nn.functional.pad(dx, (0, 0, 0, w - w2 * window, 0, h - h2 * window))
    return dx.to(x.dtype)


class _MaxPool2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window):
        y = _windows(x, window, False).amax(dim=(2, 4))
        ctx.save_for_backward(x, y)
        ctx.window = window
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return _eqmask_grad(x, y, g, ctx.window, False), None


class _MfmPool2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _windows(x, 2, True).amax(dim=(2, 4, 5))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return _eqmask_grad(x, y, g, 2, True)


class _MaxPool1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window):
        b, t, c = x.shape
        t2 = t // window
        y = x[:, : t2 * window].reshape(b, t2, window, c).amax(dim=2)
        ctx.save_for_backward(x, y)
        ctx.window = window
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        b, t, c = x.shape
        t2 = t // ctx.window
        xw = x[:, : t2 * ctx.window].reshape(b, t2, ctx.window, c)
        dx = torch.where(xw == y[:, :, None], g[:, :, None], 0.0).reshape(b, t2 * ctx.window, c)
        if t2 * ctx.window < t:
            dx = nn.functional.pad(dx, (0, 0, 0, t - t2 * ctx.window))
        return dx.to(x.dtype), None


def max_pool_1d(x: torch.Tensor, window: int) -> torch.Tensor:
    """torch MaxPool1d(window) in floor mode on (B, T, C), with the
    equality-mask backward; the dropped tail T mod window gets zeros."""
    if switch_on("ADAA_POOL_EQMASK"):
        return _MaxPool1d.apply(x, window)
    b, t, c = x.shape
    t2 = t // window
    return x[:, : t2 * window].reshape(b, t2, window, c).amax(dim=2)


def max_pool_2d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """torch MaxPool2d(window, window) in floor mode on NHWC input."""
    if switch_on("ADAA_POOL_EQMASK"):
        return _MaxPool2d.apply(x, window)
    return _windows(x, window, False).amax(dim=(2, 4))


def mfm_pool_2d(x: torch.Tensor) -> torch.Tensor:
    """max_pool_2d(max_feature_map(x)) as one max over the 8 candidates."""
    if x.shape[-1] % 2:
        raise ValueError("MFM needs an even channel count")
    if switch_on("ADAA_MFM_EQMASK"):
        return _MfmPool2d.apply(x)
    return _windows(x, 2, True).amax(dim=(2, 4, 5))


# ---------------------------------------------------------------------------
# BatchNorm with flax's statistics
# ---------------------------------------------------------------------------

BN_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch (torch's momentum 0.1)


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=bn.eps, dtype=dtype)`` over
    the last axis of ``x``, with ``bn``'s affine and running statistics.

    In ``bn.training`` it normalises with the batch's statistics, reduced
    in f32 as flax's ``_compute_stats`` does (mean and mean of squares,
    the *biased* variance ``max(0, E[x^2] - E[x]^2)``, gradients through
    both), and updates ``running_mean`` / ``running_var`` with them;
    ``num_batches_tracked`` stays as it is. In eval it uses the running
    statistics. Either way ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` runs in f32 and the result is cast to ``dtype`` (f32 when None:
    flax promotes x with the f32 statistics).

    torch's own ``BatchNorm`` in train mode updates the running variance
    with the unbiased batch variance, which is not what the JAX models
    compute.

    Inside ``mesh.sharded()`` the batch's statistics are the global
    batch's: the per-channel sums of x and x^2 and the count are summed
    over ranks (with their gradients), as flax reduces over the whole
    sharded batch.
    """
    xf = x.float()
    if bn.training:
        axes = tuple(range(x.dim() - 1))
        if mesh.shard_info() is None:
            mean = xf.mean(axes)
            var = torch.clamp_min((xf * xf).mean(axes) - mean * mean, 0.0)
        else:
            count = mesh.shard_info()[0] * math.prod(x.shape[:-1])
            sums = mesh.all_reduce_sum(torch.stack([xf.sum(axes), (xf * xf).sum(axes)]))
            mean = sums[0] / count
            var = torch.clamp_min(sums[1] / count - mean * mean, 0.0)
        with torch.no_grad():
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps)
    if bn.weight is not None:
        mul = mul * bn.weight
    y = (xf - mean) * mul
    if bn.bias is not None:
        y = y + bn.bias
    return y.to(dtype or torch.float32)


def dropout(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    """``F.dropout``; inside ``mesh.sharded()`` the keep-mask is the global
    batch's draw (``F.dropout`` of ones of the global shape), sliced to
    this rank's rows, as JAX draws one mask over the sharded batch."""
    if not training or mesh.shard_info() is None:
        return F.dropout(x, p=p, training=training)
    scale = mesh.global_draw(lambda shape: F.dropout(x.new_ones(shape), p=p, training=True),
                             tuple(x.shape))
    return x * scale


# ---------------------------------------------------------------------------
# Recurrent layers
# ---------------------------------------------------------------------------

class BiLSTM(nn.Module):
    """Bidirectional single-layer LSTM, outputs concatenated: (B, T, D) -> (B, T, 2H).

    The same function as ``nn.LSTM(D, H, bidirectional=True,
    batch_first=True)`` and the same parameter names, computed as an
    explicit recurrence. Both directions run in one loop over T, each
    step one batched (2, B, H) x (2, H, 4H) product.
    """

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = 4 * hidden_size
        for sfx in ("l0", "l0_reverse"):
            self.register_parameter(f"weight_ih_{sfx}", nn.Parameter(torch.empty(g, input_size)))
            self.register_parameter(f"weight_hh_{sfx}", nn.Parameter(torch.empty(g, hidden_size)))
            self.register_parameter(f"bias_ih_{sfx}", nn.Parameter(torch.empty(g)))
            self.register_parameter(f"bias_hh_{sfx}", nn.Parameter(torch.empty(g)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.hidden_size)
        for p in self.parameters():
            uniform_init(p, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        h = self.hidden_size
        # input projections of both directions in one product
        w_ih = torch.cat([self.weight_ih_l0, self.weight_ih_l0_reverse], dim=0)
        bias = torch.cat([self.bias_ih_l0 + self.bias_hh_l0,
                          self.bias_ih_l0_reverse + self.bias_hh_l0_reverse])
        gx = (torch.matmul(x, w_ih.T) + bias).reshape(b, t, 2, 4 * h)
        gx = gx.permute(2, 1, 0, 3)  # (2, T, B, 4H)
        gates = torch.stack([gx[0], gx[1].flip(0)])  # backward direction reversed in time
        w_hh = torch.stack([self.weight_hh_l0.T, self.weight_hh_l0_reverse.T])  # (2, H, 4H)

        hs = x.new_zeros(2, b, h)
        cs = x.new_zeros(2, b, h)
        outs = []
        for s in range(t):
            g = gates[:, s] + torch.bmm(hs, w_hh)  # (2, B, 4H)
            i, f, gg, o = g.chunk(4, dim=-1)
            cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(gg)
            hs = torch.sigmoid(o) * torch.tanh(cs)
            outs.append(hs)
        ys = torch.stack(outs)  # (T, 2, B, H)
        out = torch.cat([ys[:, 0], ys[:, 1].flip(0)], dim=-1)  # (T, B, 2H)
        return out.transpose(0, 1)


def gru_recurrence(gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """The GRU recurrence of ``n`` directions at once from zero state:
    gates (n, T, B, 3H) = x W_ih + b_ih in processing order, w_hh (n, H,
    3H), b_hh (n, 1, 3H) -> hidden states (T, n, B, H), with n = tanh(x_n
    + r * (W_hn h + b_hn)) as torch has it; each step one batched product."""
    n, t, b, _ = gates.shape
    hs = gates.new_zeros(n, b, w_hh.shape[1])
    outs = []
    for s in range(t):
        gh = torch.bmm(hs, w_hh) + b_hh
        xr, xz, xn = gates[:, s].chunk(3, dim=-1)
        hr, hz, hn = gh.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        hs = (1.0 - z) * torch.tanh(xn + r * hn) + z * hs
        outs.append(hs)
    return torch.stack(outs)


class BiGRU(nn.Module):
    """Multi-layer bidirectional GRU, outputs concatenated: (B, T, D) -> (B, T, 2H).

    The same function as ``nn.GRU(D, H, num_layers, bidirectional=True,
    batch_first=True)`` and the same parameter names, computed as an
    explicit recurrence (see ``BiLSTM``), with n = tanh(x_n + r * (W_hn h
    + b_hn)) as torch has it. Both directions of a layer run in one loop
    over T, each step one batched (2, B, H) x (2, H, 3H) product.
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        g = 3 * hidden_size
        for layer in range(num_layers):
            d = input_size if layer == 0 else 2 * hidden_size
            for sfx in (f"l{layer}", f"l{layer}_reverse"):
                self.register_parameter(f"weight_ih_{sfx}", nn.Parameter(torch.empty(g, d)))
                self.register_parameter(f"weight_hh_{sfx}",
                                        nn.Parameter(torch.empty(g, hidden_size)))
                self.register_parameter(f"bias_ih_{sfx}", nn.Parameter(torch.empty(g)))
                self.register_parameter(f"bias_hh_{sfx}", nn.Parameter(torch.empty(g)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.hidden_size)
        for p in self.parameters():
            uniform_init(p, bound, generator)

    def _layer(self, x: torch.Tensor, layer: int) -> torch.Tensor:
        b, t, _ = x.shape
        h = self.hidden_size

        def both(name):  # the layer's (forward, reverse) parameters
            return [getattr(self, f"{name}_l{layer}{sfx}") for sfx in ("", "_reverse")]

        w_ih, b_ih = torch.cat(both("weight_ih")), torch.cat(both("bias_ih"))
        gx = (torch.matmul(x, w_ih.T) + b_ih).reshape(b, t, 2, 3 * h).permute(2, 1, 0, 3)
        gates = torch.stack([gx[0], gx[1].flip(0)])  # (2, T, B, 3H), backward reversed
        w_hh = torch.stack([w.T for w in both("weight_hh")])  # (2, H, 3H)
        b_hh = torch.stack(both("bias_hh"))[:, None]  # (2, 1, 3H)
        ys = gru_recurrence(gates, w_hh, b_hh)  # (T, 2, B, H)
        return torch.cat([ys[:, 0], ys[:, 1].flip(0)], dim=-1).transpose(0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in range(self.num_layers):
            x = self._layer(x, layer)
        return x
