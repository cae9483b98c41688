"""SpecRNet detector in PyTorch.

Port of ``adaa_tpu/models/specrnet.py`` (reference lineage:
piotrkawa/specrnet): three residual 2-D blocks, each followed by an FC
attention gate (``x * y + y``) and a 2x2 max pool, BN + SELU, a 2-layer
bidirectional GRU over time and two dense layers to one logit. Forward
maps a raw waveform (B, 64600) -> logit (B, 1); features (B, C, n_coeff,
T) skip the frontend.

As in the JAX model, the input is not transposed: the convs see
(coeff, time) as (H, W), and the activations run channels-last,
(B, coeff, T, C); each conv views them as NCHW in channels-last memory.
At 64,600 samples the six floor-mode pools take (80, 404) to (1, 6), so
the GRU runs over T = 6.

``compute_dtype=torch.bfloat16`` follows the JAX model's dtype flow,
which is not uniform: convs and BNs round their outputs to bf16 (BN
arithmetic in f32 on the f32 statistics); the attention gate's dense
layer has no dtype, so the gate's ``x * y + y`` and the pool after it are
f32; in ``block4`` (no downsample) ``out (bf16) + identity (f32)`` is
f32; ``bn_before_gru`` is bf16 and the GRU and dense layers f32. SELU,
leaky ReLU and the bias add run in the activation's dtype with their
constants rounded to it, as JAX's weakly typed Python constants are.

Reference quirk kept: in the non-first blocks ``bn1`` is computed and
its result discarded (conv1 sees the block input). In ``eval()`` that has
no effect and is skipped; in ``train()`` it runs, so its running
statistics update as in the reference.

The frontend is LFCC in f32 (SpecRNet never takes the bf16 frontend);
``fused_frontend`` sends it through the fused LFCC kernel, as the JAX
package's ``ADAA_PALLAS_FRONTEND=1`` does (None reads that variable per
call), and ``plain_ops`` runs that kernel's plain-torch version.

Module names give the reference's ``state_dict`` keys (``first_bn``,
``block{0,2,4}.0.*``, ``fc_attention{0,2,4}.0``, ``bn_before_gru``,
``gru.*``, ``fc1_gru``, ``fc2_gru``).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from adaa_tpu_torch.models import layers
from adaa_tpu_torch.ops import frontends

SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946
LRELU_SLOPE = 0.3


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: a product with it rounds once, as a
    JAX op with a weakly typed Python constant does."""
    return float(torch.tensor(value, dtype=dtype))


def selu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.selu, each op in x's dtype."""
    neg = torch.expm1(torch.where(x > 0, 0.0, x)) * _const(SELU_ALPHA, x.dtype)
    return torch.where(x > 0, x, neg) * _const(SELU_SCALE, x.dtype)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.leaky_relu(x, 0.3) in x's dtype."""
    return torch.where(x >= 0, x, x * _const(LRELU_SLOPE, x.dtype))


def _conv(h: torch.Tensor, conv: nn.Conv2d, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """'SAME' conv of channels-last h; with ``dtype`` the input and kernel are
    cast to it and the bias is added after the conv's store, as flax does."""
    x = h.permute(0, 3, 1, 2)
    pad = conv.kernel_size[0] // 2
    if dtype is None:
        y = F.conv2d(x, conv.weight, conv.bias, padding=pad)
    else:
        y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, padding=pad)
        y = y + conv.bias.to(dtype)[:, None, None]
    return y.permute(0, 2, 3, 1)


def _bn(bn: nn.BatchNorm2d, h: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax's BatchNorm of channels-last h (``layers.batch_norm``): f32
    math; the result in ``dtype`` if given, else f32."""
    return layers.batch_norm(bn, h, dtype)


class ResidualBlock2D(nn.Module):
    """Residual_block2D (reference src/models/specrnet.py:32-91)."""

    def __init__(self, in_channels: int, out_channels: int, first: bool = False):
        super().__init__()
        self.first = first
        if not first:
            self.bn1 = nn.BatchNorm2d(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.downsample = in_channels != out_channels
        if self.downsample:
            self.conv_downsample = nn.Conv2d(in_channels, out_channels, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    layers.kaiming_uniform_conv(m.weight, generator)
                    m.bias.zero_()
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
        identity = x
        if not self.first and self.training:
            _bn(self.bn1, x, dtype)  # the reference's discarded bn1: stats only
        out = _conv(x, self.conv1, dtype)
        out = leaky_relu(_bn(self.bn2, out, dtype))
        out = _conv(out, self.conv2, dtype)
        if self.downsample:
            identity = _conv(identity, self.conv_downsample, dtype)
        return layers.max_pool_2d(out + identity)


class SpecRNet(nn.Module):
    """SpecRNet with an optional frontend.

    Args:
      input_channels: frontend channels (1 for lfcc/mfcc).
      frontend_algorithm: e.g. ["lfcc"]; empty -> feature input expected.
      compute_dtype: ``torch.bfloat16`` for the bf16 trunk; parameters,
        the frontend, the GRU and the dense layers stay float32.
      fused_frontend: LFCC through the fused kernel; None reads
        ``ADAA_PALLAS_FRONTEND == "1"`` per call.
    """

    def __init__(self, input_channels: int = 1, frontend_algorithm: Sequence[str] = (),
                 filts: Sequence = (1, (1, 20), (20, 64), (64, 64)), gru_node: int = 64,
                 nb_gru_layer: int = 2, nb_fc_node: int = 64, nb_classes: int = 1,
                 compute_dtype: Optional[torch.dtype] = None,
                 fused_frontend: Optional[bool] = None):
        super().__init__()
        self.input_channels = input_channels
        self.frontend_algorithm = tuple(frontend_algorithm)
        self.compute_dtype = compute_dtype
        self.fused_frontend = fused_frontend
        self.plain_ops = False  # the fused LFCC's plain-torch version on any device
        (_, f1_out), (f2_in, f2_out) = filts[1], filts[2]
        self.first_bn = nn.BatchNorm2d(input_channels)
        # flax infers block0's input width from its input: the frontend's channels
        self.block0 = nn.Sequential(ResidualBlock2D(input_channels, f1_out, first=True))
        self.block2 = nn.Sequential(ResidualBlock2D(f2_in, f2_out))
        self.block4 = nn.Sequential(ResidualBlock2D(f2_out, f2_out))
        self.fc_attention0 = nn.Sequential(nn.Linear(f1_out, f1_out))
        self.fc_attention2 = nn.Sequential(nn.Linear(f2_out, f2_out))
        self.fc_attention4 = nn.Sequential(nn.Linear(f2_out, f2_out))
        self.bn_before_gru = nn.BatchNorm2d(f2_out)
        self.gru = layers.BiGRU(f2_out, gru_node, nb_gru_layer)
        self.fc1_gru = nn.Linear(gru_node * 2, nb_fc_node * 2)
        self.fc2_gru = nn.Linear(nb_fc_node * 2, nb_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX model's initialisers, drawn from ``generator``."""
        with torch.no_grad():
            self.first_bn.reset_parameters()
            self.bn_before_gru.reset_parameters()
            for blk in (self.block0, self.block2, self.block4):
                blk[0].reset_parameters(generator)
            for fc in (self.fc_attention0, self.fc_attention2, self.fc_attention4):
                layers.kaiming_uniform_linear(fc[0].weight, generator)
                layers.conv_bias_init(fc[0].bias, fc[0].in_features, generator)
            self.gru.reset_parameters(generator)
            for fc in (self.fc1_gru, self.fc2_gru):
                layers.kaiming_uniform_linear(fc.weight, generator)
                layers.conv_bias_init(fc.bias, fc.in_features, generator)

    def _gate(self, h: torch.Tensor, fc: nn.Sequential) -> torch.Tensor:
        """x * y + y with y = sigmoid(dense(mean over H, W)); the dense layer
        promotes to f32, so the result is f32."""
        y = h.float().mean(dim=(1, 2)).to(h.dtype)
        y = torch.sigmoid(fc[0](y.float()))[:, None, None, :]
        return h * y + y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            feat = frontends.get_frontend(list(self.frontend_algorithm), fused=self.fused_frontend,
                                          reference=self.plain_ops)(x)
            if feat.dim() < 4:
                feat = feat[:, None]
        else:
            feat = x
        # (B, C, coeff, T) -> (B, coeff, T, C): no H/W swap (reference :141)
        h = feat.permute(0, 2, 3, 1)
        dtype = self.compute_dtype
        if dtype is not None:
            h = h.to(dtype)
        h = selu(_bn(self.first_bn, h, dtype))
        for blk, fc in ((self.block0, self.fc_attention0), (self.block2, self.fc_attention2),
                        (self.block4, self.fc_attention4)):
            h = layers.max_pool_2d(self._gate(blk[0](h, dtype), fc))
        h = selu(_bn(self.bn_before_gru, h, dtype))
        h = h.squeeze(1).float()  # (B, T', C): the coeff axis is pooled to 1; the GRU runs f32
        h = self.gru(h)[:, -1]
        return self.fc2_gru(self.fc1_gru(h)).float()
