"""Shared building blocks with the JAX package's numerics.

Port of the parts of ``adaa_tpu/models/layers.py`` that LCNN and
RawNet3 use:

* the torch-default initialisers, drawing from an explicit
  ``torch.Generator``;
* ``max_feature_map``, ``max_pool_1d``, ``max_pool_2d`` and
  ``mfm_pool_2d`` on channels-last tensors, as
  ``torch.autograd.Function``s with the
  equality-mask backward (the JAX default): every element equal to the
  max receives the whole cotangent. This is not torch's own max-pool
  backward, which routes to a single argmax;
* ``BiLSTM``: a bidirectional LSTM as an explicit f32 recurrence in
  plain torch ops, gate order (i, f, g, o), parameters named as
  ``nn.LSTM`` names them. cuDNN's ``nn.LSTM`` refuses its backward in
  ``eval()``, and the attacks need the input gradient of a model in
  ``eval()``; the explicit recurrence also follows the JAX math step
  for step.
"""
from __future__ import annotations

import math

import torch
from torch import nn

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


def max_feature_map(x: torch.Tensor) -> torch.Tensor:
    """MFM maxout over channel halves of the last axis: max(x[..., :C/2], x[..., C/2:])."""
    if x.shape[-1] % 2:
        raise ValueError("MFM needs an even channel count")
    return _MaxFeatureMap.apply(x)


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
    return _MaxPool1d.apply(x, window)


def max_pool_2d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """torch MaxPool2d(window, window) in floor mode on NHWC input."""
    return _MaxPool2d.apply(x, window)


def mfm_pool_2d(x: torch.Tensor) -> torch.Tensor:
    """max_pool_2d(max_feature_map(x)) as one max over the 8 candidates."""
    if x.shape[-1] % 2:
        raise ValueError("MFM needs an even channel count")
    return _MfmPool2d.apply(x)


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
