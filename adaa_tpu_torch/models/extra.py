"""The reference's unwired detectors in PyTorch (port of
``adaa_tpu/models/extra.py``): RawNet2, Meso4, MesoInception4 and
Xception, reachable through ``get_extra_model`` (the reference's model
factory does not dispatch them).

Quirks kept from the JAX package (and its reference):

* RawNet2's first layer is a fixed mel-spaced sinc bank (a buffer, not a
  parameter), |.| and a w=3 max pool; each residual block but the first
  runs a ``bn1`` whose output is discarded, though its running
  statistics still update in ``train()``; the recurrent tail is a
  unidirectional multi-layer GRU read at its last step;
* Meso4 uses ``bn1`` (8 channels) after conv1 and conv2 and ``bn2`` (16)
  after conv3 and conv4, so in ``train()`` each updates its statistics
  twice per forward;
* Xception's MaxPool2d(3, 2, padding=1) is a chain of maximums over nine
  shifted strided slices of a -max-padded input, as JAX computes it, so a
  tied cotangent splits as ``torch.maximum`` splits it; its skip branch
  takes the block's input before any ReLU.

The max pools are the port's ``layers.max_pool_1d`` / ``max_pool_2d``
with their equality-mask backward: Meso's pools follow ReLU -> BN, where
ties are everywhere, so ``F.max_pool2d`` (one argmax) would give another
input gradient. BatchNorm is ``layers.batch_norm`` (flax's statistics),
dropout ``layers.dropout``. Layouts are channels-last inside; Meso and
Xception take NCHW feature maps, RawNet2 raw waves (B, L).

Module names are the JAX modules' (``block0.conv1``, ``i1_bn``,
``block3.sep1.pointwise``, ``gru.l0``, ...) with torch's parameter names
and layouts (``weight`` OIHW / OIK / (out, in), ``running_mean``, GRU
``weight_ih`` (3H, D)): no reference checkpoint exists for them, so
``models/weights.py:extra_state_dict_from_flax`` maps a JAX variable
tree onto these names.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adaa_tpu_torch.models import layers


def _rawnet2_sinc_filters(out_channels: int, kernel_size: int,
                          sample_rate: int = 16000) -> np.ndarray:
    """Fixed mel-spaced band-pass sinc bank (raw_net2.py:54-78), (C, K)."""
    if kernel_size % 2 == 0:
        kernel_size += 1
    nfft = 512
    f = int(sample_rate / 2) * np.linspace(0, 1, int(nfft / 2) + 1)
    fmel = 2595 * np.log10(1 + f / 700)
    filbandwidthsmel = np.linspace(fmel.min(), fmel.max(), out_channels + 1)
    mel = 700 * (10 ** (filbandwidthsmel / 2595) - 1)
    hsupp = np.arange(-(kernel_size - 1) / 2, (kernel_size - 1) / 2 + 1)
    ham = np.hamming(kernel_size)
    bank = np.zeros((out_channels, kernel_size))
    for i in range(out_channels):
        fmin, fmax = mel[i], mel[i + 1]
        h_high = (2 * fmax / sample_rate) * np.sinc(2 * fmax * hsupp / sample_rate)
        h_low = (2 * fmin / sample_rate) * np.sinc(2 * fmin * hsupp / sample_rate)
        bank[i] = ham * (h_high - h_low)
    return bank.astype(np.float32)


def _conv1d(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """A 'SAME' stride-1 conv of a channels-last (B, T, C) tensor."""
    return F.conv1d(x.transpose(1, 2), conv.weight, conv.bias,
                    padding=conv.padding).transpose(1, 2)


def _conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` (its stride, padding, dilation and groups) on NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, conv.stride, conv.padding,
                 conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1)


def _bn(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    return layers.batch_norm(bn, x)


def _reset(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX modules' initialisers: convs and linears kaiming-uniform
    with zero bias, BNs at (1, 0) with fresh statistics."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d)):
                layers.kaiming_uniform_conv(m.weight, generator)
            elif isinstance(m, nn.Linear):
                layers.kaiming_uniform_linear(m.weight, generator)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
                continue
            else:
                continue
            if m.bias is not None:
                m.bias.zero_()


# ---------------------------------------------------------------------------
# RawNet2
# ---------------------------------------------------------------------------

class ResidualBlock1D(nn.Module):
    """Residual_block (raw_net2.py:85-143) on (B, T, C)."""

    def __init__(self, in_channels: int, out_channels: int, first: bool = False):
        super().__init__()
        self.first = first
        if not first:
            self.bn1 = nn.BatchNorm1d(in_channels)
        self.conv1 = nn.Conv1d(in_channels, out_channels, 3, padding=1)
        self.bn2 = nn.BatchNorm1d(out_channels)
        self.conv2 = nn.Conv1d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_downsample = nn.Conv1d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        if not self.first:
            _bn(self.bn1, x)  # computed and discarded, as the reference does
        out = F.leaky_relu(_bn(self.bn2, _conv1d(x, self.conv1)), 0.3)
        out = _conv1d(out, self.conv2)
        if hasattr(self, "conv_downsample"):
            identity = _conv1d(identity, self.conv_downsample)
        return layers.max_pool_1d(out + identity, 3)


class GRULayer(nn.Module):
    """One direction of one GRU layer: ``nn.GRU``'s layouts, gate order (r, z, n)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
        self.bias_ih = nn.Parameter(torch.empty(3 * hidden_size))
        self.bias_hh = nn.Parameter(torch.empty(3 * hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gates = (torch.matmul(x, self.weight_ih.T) + self.bias_ih).transpose(0, 1)  # (T, B, 3H)
        ys = layers.gru_recurrence(gates[None], self.weight_hh.T[None], self.bias_hh[None, None])
        return ys[:, 0].transpose(0, 1)


class UniGRU(nn.Module):
    """``nn.GRU(batch_first=True, bidirectional=False, num_layers)`` as the
    explicit f32 recurrence of ``layers.BiGRU``, one direction."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1):
        super().__init__()
        for layer in range(num_layers):
            self.add_module(f"l{layer}", GRULayer(input_size if layer == 0 else hidden_size,
                                                  hidden_size))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.children():
            for p in layer.parameters():
                layers.uniform_init(p, 1.0 / math.sqrt(layer.hidden_size), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


class RawNet2(nn.Module):
    """RawNet2 with the ASVspoof2021 baseline hyperparameters (the defaults)."""

    def __init__(self, filts: Sequence = (20, (20, 20), (20, 128), (128, 128)),
                 first_conv: int = 1024, gru_node: int = 1024, nb_gru_layer: int = 3,
                 nb_fc_node: int = 1024, nb_classes: int = 1):
        super().__init__()
        self.register_buffer("sinc_bank", torch.from_numpy(
            _rawnet2_sinc_filters(filts[0], first_conv))[:, None], persistent=False)
        self.first_bn = nn.BatchNorm1d(filts[0])
        (f1_in, f1_out), (f2_in, f2_out) = filts[1], filts[2]
        specs = [(f1_in, f1_out, True), (f1_out, f1_out, False), (f2_in, f2_out, False),
                 (f2_out, f2_out, False), (f2_out, f2_out, False), (f2_out, f2_out, False)]
        for i, (cin, cout, first) in enumerate(specs):
            self.add_module(f"block{i}", ResidualBlock1D(cin, cout, first))
            self.add_module(f"fc_attention{i}", nn.Linear(cout, cout))
        self.bn_before_gru = nn.BatchNorm1d(f2_out)
        self.gru = UniGRU(f2_out, gru_node, nb_gru_layer)
        self.fc1_gru = nn.Linear(gru_node, nb_fc_node)
        self.fc2_gru = nn.Linear(nb_fc_node, nb_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset(self, generator)
        with torch.no_grad():
            for i in range(6):
                fc = getattr(self, f"fc_attention{i}")
                layers.conv_bias_init(fc.bias, fc.out_features, generator)
            layers.conv_bias_init(self.fc1_gru.bias, self.fc1_gru.in_features, generator)
            layers.conv_bias_init(self.fc2_gru.bias, self.fc2_gru.in_features, generator)
        self.gru.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2:
            raise ValueError(f"RawNet2 takes raw waves (B, L), got {tuple(x.shape)}")
        h = F.conv1d(x[:, None], self.sinc_bank).transpose(1, 2)  # (B, T, C)
        h = layers.max_pool_1d(h.abs(), 3)
        h = F.selu(_bn(self.first_bn, h))
        for i in range(6):
            h = getattr(self, f"block{i}")(h)
            y = torch.sigmoid(getattr(self, f"fc_attention{i}")(h.mean(dim=1)))[:, None]
            h = h * y + y
        h = F.selu(_bn(self.bn_before_gru, h))
        h = self.gru(h)[:, -1]
        return self.fc2_gru(self.fc1_gru(h))


# ---------------------------------------------------------------------------
# MesoNet
# ---------------------------------------------------------------------------

def _conv(cin: int, cout: int, k: int, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=(k // 2) * dilation, dilation=dilation, bias=False)


def _flatten_nchw(h: torch.Tensor) -> torch.Tensor:
    """NHWC -> the reference's NCHW flatten (channel-major)."""
    return h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)


class Meso4(nn.Module):
    """Meso4 (mesonet.py:9-61) on NCHW feature maps."""

    def __init__(self, num_classes: int = 1, input_channels: int = 3,
                 fc1_dim: int = 16 * 7 * 7):
        super().__init__()
        self.conv1 = _conv(input_channels, 8, 3)
        self.conv2 = _conv(8, 8, 5)
        self.conv3 = _conv(8, 16, 5)
        self.conv4 = _conv(16, 16, 5)
        self.bn1 = nn.BatchNorm2d(8)
        self.bn2 = nn.BatchNorm2d(16)
        self.fc1 = nn.Linear(fc1_dim, 16)
        self.fc2 = nn.Linear(16, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 2, 3, 1)
        for conv, bn, window in ((self.conv1, self.bn1, 2), (self.conv2, self.bn1, 2),
                                 (self.conv3, self.bn2, 2), (self.conv4, self.bn2, 4)):
            h = layers.max_pool_2d(_bn(bn, torch.relu(_conv2d(h, conv))), window)
        h = F.leaky_relu(self.fc1(_flatten_nchw(h)), 0.1)
        return self.fc2(layers.dropout(h, 0.5, self.training))


class MesoInception4(nn.Module):
    """MesoInception4 (mesonet.py:63-171) on NCHW feature maps. ``fc1_dim``
    is fc1's input width, 16 x (H / 32) x (W / 32) (the JAX model infers
    it; the reference fixes 16 x 8 x 8, its 256 x 256 input)."""

    def __init__(self, num_classes: int = 1, input_channels: int = 3,
                 fc1_dim: int = 16 * 8 * 8):
        super().__init__()
        cin = input_channels
        for idx, c1 in ((1, 1), (2, 2)):
            names = ("conv1", "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv4_1", "conv4_2")
            specs = ((cin, c1, 1, 1), (cin, 4, 1, 1), (4, 4, 3, 1), (cin, 4, 1, 1),
                     (4, 4, 3, 2), (cin, 2, 1, 1), (2, 2, 3, 3))
            for name, (ci, co, k, d) in zip(names, specs):
                self.add_module(f"i{idx}_{name}", _conv(ci, co, k, d))
            cin = c1 + 4 + 4 + 2
            self.add_module(f"i{idx}_bn", nn.BatchNorm2d(cin))
        self.conv1 = _conv(cin, 16, 5)
        self.conv2 = _conv(16, 16, 5)
        self.bn1 = nn.BatchNorm2d(16)
        self.fc1 = nn.Linear(fc1_dim, 16)
        self.fc2 = nn.Linear(16, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset(self, generator)

    def _inception(self, h: torch.Tensor, idx: int) -> torch.Tensor:
        def conv(name, t):
            return _conv2d(t, getattr(self, f"i{idx}_{name}"))

        y = torch.cat([conv("conv1", h), conv("conv2_2", conv("conv2_1", h)),
                       conv("conv3_2", conv("conv3_1", h)), conv("conv4_2", conv("conv4_1", h))],
                      dim=-1)
        return layers.max_pool_2d(_bn(getattr(self, f"i{idx}_bn"), y), 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._inception(self._inception(x.permute(0, 2, 3, 1), 1), 2)
        h = layers.max_pool_2d(_bn(self.bn1, torch.relu(_conv2d(h, self.conv1))), 2)
        h = layers.max_pool_2d(_bn(self.bn1, torch.relu(_conv2d(h, self.conv2))), 4)
        h = layers.dropout(_flatten_nchw(h), 0.5, self.training)
        h = F.leaky_relu(self.fc1(h), 0.1)
        return self.fc2(layers.dropout(h, 0.5, self.training))


# ---------------------------------------------------------------------------
# Xception
# ---------------------------------------------------------------------------

def overlap_max_pool_2d(x: torch.Tensor, window: int = 3, stride: int = 2,
                        pad: int = 1) -> torch.Tensor:
    """MaxPool2d(window, stride, padding=pad) on NHWC as JAX's chain of
    maximums over shifted strided slices of the -max-padded input."""
    neg = torch.finfo(x.dtype).min
    xp = F.pad(x, (0, 0, pad, pad, pad, pad), value=neg)
    h = (x.shape[1] + 2 * pad - window) // stride + 1
    w = (x.shape[2] + 2 * pad - window) // stride + 1
    out = None
    for di in range(window):
        for dj in range(window):
            sl = xp[:, di: di + (h - 1) * stride + 1: stride,
                    dj: dj + (w - 1) * stride + 1: stride]
            out = sl if out is None else torch.maximum(out, sl)
    return out


class SeparableConv(nn.Module):
    """Depthwise 3x3 (``conv1``) then pointwise 1x1 (``pointwise``), no biases."""

    def __init__(self, cin: int, features: int, kernel: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cin, kernel, padding=kernel // 2, groups=cin, bias=False)
        self.pointwise = nn.Conv2d(cin, features, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv2d(_conv2d(x, self.conv1), self.pointwise)


class XceptionBlock(nn.Module):
    """Xception's Block (xception.py:79-141): [ReLU, SeparableConv, BN] x reps,
    a strided overlapping pool, and the 1x1 strided skip conv + BN."""

    def __init__(self, in_filters: int, out_filters: int, reps: int, strides: int = 1,
                 start_with_relu: bool = True, grow_first: bool = True):
        super().__init__()
        self.strides = strides
        seps = []
        filters = in_filters
        if grow_first:
            seps.append((in_filters, out_filters))
            filters = out_filters
        seps += [(filters, filters)] * (reps - 1)
        if not grow_first:
            seps.append((in_filters, out_filters))
        for i, (ci, co) in enumerate(seps):
            self.add_module(f"sep{i}", SeparableConv(ci, co))
            self.add_module(f"bn{i}", nn.BatchNorm2d(co))
        self.reps = len(seps)
        self.start_with_relu = start_with_relu
        if out_filters != in_filters or strides != 1:
            self.skip = nn.Conv2d(in_filters, out_filters, 1, stride=strides, bias=False)
            self.skipbn = nn.BatchNorm2d(out_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.reps):
            if i > 0 or self.start_with_relu:
                h = torch.relu(h)
            h = _bn(getattr(self, f"bn{i}"), getattr(self, f"sep{i}")(h))
        if self.strides != 1:
            h = overlap_max_pool_2d(h, 3, self.strides, 1)
        skip = _bn(self.skipbn, _conv2d(x, self.skip)) if hasattr(self, "skip") else x
        return h + skip


XCEPTION_BLOCKS = ([(64, 128, 2, 2, False, True), (128, 256, 2, 2, True, True),
                    (256, 728, 2, 2, True, True)] + [(728, 728, 3, 1, True, True)] * 8
                   + [(728, 1024, 2, 2, True, False)])


class Xception(nn.Module):
    """Xception (xception.py:144-306) on NCHW maps, global-average-pool logits."""

    def __init__(self, num_classes: int = 1, input_channels: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(input_channels, 32, 3, stride=2, bias=False)
        self.bn1 = nn.BatchNorm2d(32)
        self.conv2 = nn.Conv2d(32, 64, 3, bias=False)
        self.bn2 = nn.BatchNorm2d(64)
        for i, spec in enumerate(XCEPTION_BLOCKS):
            self.add_module(f"block{i + 1}", XceptionBlock(*spec))
        self.conv3 = SeparableConv(1024, 1536)
        self.bn3 = nn.BatchNorm2d(1536)
        self.conv4 = SeparableConv(1536, 2048)
        self.bn4 = nn.BatchNorm2d(2048)
        self.last_linear = nn.Linear(2048, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(_bn(self.bn1, _conv2d(x.permute(0, 2, 3, 1), self.conv1)))
        h = torch.relu(_bn(self.bn2, _conv2d(h, self.conv2)))
        for i in range(len(XCEPTION_BLOCKS)):
            h = getattr(self, f"block{i + 1}")(h)
        h = torch.relu(_bn(self.bn3, self.conv3(h)))
        h = torch.relu(_bn(self.bn4, self.conv4(h)))
        return self.last_linear(h.mean(dim=(1, 2)))


def get_extra_model(model_name: str, config: dict) -> nn.Module:
    """Factory for the reference's unwired architectures (uninitialised:
    ``models.init_model`` draws their weights)."""
    if model_name == "rawnet2":
        keys = ("filts", "first_conv", "gru_node", "nb_gru_layer", "nb_fc_node", "nb_classes")
        return RawNet2(**{k: v for k, v in config.items() if k in keys})
    if model_name in ("mesonet", "meso4"):
        return Meso4(num_classes=config.get("num_classes", 1),
                     input_channels=config.get("input_channels", 3),
                     fc1_dim=config.get("fc1_dim", 16 * 7 * 7))
    if model_name == "meso_inception4":
        return MesoInception4(num_classes=config.get("num_classes", 1),
                              input_channels=config.get("input_channels", 3),
                              fc1_dim=config.get("fc1_dim", 16 * 8 * 8))
    if model_name == "xception":
        return Xception(num_classes=config.get("num_classes", 1),
                        input_channels=config.get("input_channels", 3))
    raise ValueError(f"Extra model '{model_name}' not supported")
