"""LCNN detector (LFCC-LCNN lineage) in PyTorch.

Port of ``adaa_tpu/models/lcnn.py``: a 9-conv Max-Feature-Map stack
with affine-free BatchNorms, two residual BLSTMs over time, mean-pool
and one output logit. Forward maps a raw waveform (B, 64600) -> logit
(B, 1); precomputed features (B, C, n_coeff, T) are also accepted.

The trunk runs channels-last, (B, T, coeff, C), as the JAX model does;
each convolution views it as NCHW in channels-last memory, which is
cuDNN's native layout. Two paths:

* f32 (``compute_dtype=None``, or training): conv -> MFM -> BN with
  running stats -> pools.
* bf16 in ``eval()``: the first block runs as the fused kernel
  (``ops/layer0.py``) at the canonical (404, 80, 1) input; every
  eval-mode BN folds into the preceding conv's output channels (a
  positive per-channel affine commutes with the MFM and pool maxes);
  the convs run in bf16 with ``mfm`` / ``mfm_pool_2d``.
* the fused configuration, two switches on top of the bf16 path (as
  the JAX package's ``ADAA_PALLAS_FRONTEND=1`` and ``ADAA_FUSED_TRUNK=1``):
  ``fused_frontend`` sends LFCC through the fused kernel
  (``ops/lfcc_fused.py``, f32), and ``fused_trunk`` runs conv3/conv6 +
  pool and conv10/conv13 + pool as the two fused segments
  (``ops/trunk.py``). ``None`` reads the environment variable per call.

``precision="highest"`` runs every trunk conv in full f32, forward and
backward (TF32 off in both), as the JAX package's
``Precision.HIGHEST`` does.

Module names give the reference's ``state_dict`` keys
(``m_transform.<i>``, ``m_before_pooling.<j>.l_blstm``,
``m_output_act``), so a reference ``.pth`` loads with
``load_state_dict``.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from adaa_tpu_torch.models import layers
from adaa_tpu_torch.ops import frontends, layer0, trunk

# Sequential index -> (in, out, kernel) of each conv (conv "0" takes the
# frontend's input_channels, 1 for LFCC), and the channels of each BN
CONVS = {
    "0": (1, 64, 5), "3": (32, 64, 1), "6": (32, 96, 3), "10": (48, 96, 1),
    "13": (48, 128, 3), "16": (64, 128, 1), "19": (64, 64, 3), "22": (32, 64, 1),
    "25": (32, 64, 3),
}
BNS = {"5": 32, "9": 48, "12": 48, "18": 64, "21": 32, "24": 32}
# after the first block: (conv, BN that follows its MFM [and pool], pooled)
TRUNK = (
    ("3", "5", False), ("6", "9", True), ("10", "12", False), ("13", None, True),
    ("16", "18", False), ("19", "21", False), ("22", "24", False), ("25", None, True),
)
LAYER0_SHAPE = (layer0.T_IN, layer0.F_IN, 1)
SEGMENT_A_SHAPE = (trunk.SEGMENT_A.t, trunk.SEGMENT_A.f, trunk.SEGMENT_A.c_in)


class _IeeeConv2d(torch.autograd.Function):
    """A 'SAME' stride-1 conv whose forward and backward both run with
    TF32 off (cuDNN would otherwise round the backward's products)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        with layer0.ieee_f32():
            return F.conv2d(x, weight, bias, padding=weight.shape[-1] // 2)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        pad = weight.shape[-1] // 2
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.has_bias and ctx.needs_input_grad[2]]
        with layer0.ieee_f32():
            dx, dw, db = torch.ops.aten.convolution_backward(
                g, x, weight, [weight.shape[0]] if ctx.has_bias else None,
                [1, 1], [pad, pad], [1, 1], False, [0, 0], 1, mask)
        return dx, dw, db


def _conv_nhwc(h: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               exact: bool = False) -> torch.Tensor:
    """'SAME' conv of a channels-last (B, H, W, C) tensor; ``exact`` keeps
    TF32 off in the forward and the backward."""
    x = h.permute(0, 3, 1, 2)
    if exact:
        y = _IeeeConv2d.apply(x, weight, bias)
    else:
        y = F.conv2d(x, weight, bias, padding=weight.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


class BLSTMLayer(nn.Module):
    """Holder that gives the reference's key names (``<j>.l_blstm.*``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.l_blstm = layers.BiLSTM(dim, dim // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.l_blstm(x)


class LCNN(nn.Module):
    """LCNN with an optional frontend.

    Args:
      input_channels: frontend channels (1 for lfcc/mfcc).
      num_coefficients: frontend coefficient count (80).
      frontend_algorithm: e.g. ["lfcc"]; empty -> feature input expected.
      compute_dtype: ``torch.bfloat16`` for the fast trunk; parameters
        and the LSTM tail stay float32.
      precision: "highest" keeps f32 convs without TF32, forward and
        backward, and the f32 frontend.
      fused_frontend: LFCC through the fused kernel; None reads
        ``ADAA_PALLAS_FRONTEND == "1"`` per call.
      fused_trunk: the two fused trunk segments on the bf16 eval path;
        None reads ``ADAA_FUSED_TRUNK == "1"`` per call.
    """

    def __init__(self, input_channels: int = 1, num_coefficients: int = 80,
                 frontend_algorithm: Sequence[str] = (),
                 compute_dtype: Optional[torch.dtype] = None,
                 precision: Optional[str] = None,
                 fused_frontend: Optional[bool] = None,
                 fused_trunk: Optional[bool] = None):
        super().__init__()
        self.input_channels = input_channels
        self.num_coefficients = num_coefficients
        self.frontend_algorithm = tuple(frontend_algorithm)
        self.compute_dtype = compute_dtype
        self.precision = precision
        self.fused_frontend = fused_frontend
        self.fused_trunk = fused_trunk
        # checks the kernels: the fused ops (layer 0, LFCC, trunk segments)
        # run their plain-torch versions on any device
        self.plain_ops = False

        convs = {k: nn.Conv2d(input_channels if k == "0" else cin, cout, ks, padding=ks // 2)
                 for k, (cin, cout, ks) in CONVS.items()}
        bns = {k: nn.BatchNorm2d(c, affine=False) for k, c in BNS.items()}
        self.m_transform = nn.ModuleDict(
            sorted({**convs, **bns}.items(), key=lambda kv: int(kv[0]))
        )
        self.dim = (num_coefficients // 16) * 32
        self.m_before_pooling = nn.ModuleList([BLSTMLayer(self.dim), BLSTMLayer(self.dim)])
        self.m_output_act = nn.Linear(self.dim, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX model's initialisers, drawn from ``generator``."""
        with torch.no_grad():
            for k in CONVS:
                conv = self.m_transform[k]
                layers.kaiming_uniform_conv(conv.weight, generator)
                conv.bias.zero_()
            for k in BNS:
                self.m_transform[k].reset_running_stats()
            for blstm in self.m_before_pooling:
                blstm.l_blstm.reset_parameters(generator)
            layers.kaiming_uniform_linear(self.m_output_act.weight, generator)
            layers.conv_bias_init(self.m_output_act.bias, self.dim, generator)

    def _frontend(self, x: torch.Tensor) -> torch.Tensor:
        # bf16 frontend products only with the bf16 trunk (and only on the
        # accelerator, decided inside the frontend per call)
        fe_compute = ("bf16" if self.compute_dtype == torch.bfloat16
                      and self.precision != "highest" else "f32")
        feat = frontends.get_frontend(list(self.frontend_algorithm), compute=fe_compute,
                                      fused=self.fused_frontend, reference=self.plain_ops)(x)
        return feat[:, None] if feat.dim() < 4 else feat  # (B, C, n_coeff, T)

    def _folded(self, conv_key: str, bn_key: Optional[str]):
        """Conv weight and bias with the following eval-mode BN folded in."""
        conv = self.m_transform[conv_key]
        kernel, bias = conv.weight, conv.bias
        if bn_key is not None:
            bn = self.m_transform[bn_key]
            s = 1.0 / torch.sqrt(bn.running_var + bn.eps)
            t = -bn.running_mean * s
            s2 = torch.cat([s, s])
            kernel = kernel * s2[:, None, None, None]
            bias = bias * s2 + torch.cat([t, t])
        return kernel, bias

    def _fused_trunk_on(self) -> bool:
        if self.fused_trunk is None:
            return os.environ.get("ADAA_FUSED_TRUNK") == "1"
        return self.fused_trunk

    def _bn(self, key: str, h: torch.Tensor) -> torch.Tensor:
        bn = self.m_transform[key]
        return bn(h.permute(0, 3, 1, 2).float()).permute(0, 2, 3, 1).to(h.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self._frontend(x) if x.dim() == 2 else x
        # torch's reference permutes to (B, C, T, n_coeff) for NCHW convs;
        # the trunk here is channels-last: (B, T, coeff, C)
        h = feat.permute(0, 3, 2, 1)
        dtype = self.compute_dtype
        if dtype is not None:
            h = h.to(dtype)
        fast = dtype == torch.bfloat16 and self.precision is None and not self.training
        exact = self.precision == "highest"

        conv0 = self.m_transform["0"]
        if fast and tuple(h.shape[1:]) == LAYER0_SHAPE:
            fn = (layer0.fused_conv0_mfm_pool_reference if self.plain_ops
                  else layer0.fused_conv0_mfm_pool)
            h = fn(h[..., 0], conv0.weight.detach(), conv0.bias.detach())
        else:
            w0 = conv0.weight.to(h.dtype)
            h = layers.max_pool_2d(
                layers.max_feature_map(_conv_nhwc(h, w0, conv0.bias.to(h.dtype), exact)))

        blocks = TRUNK
        if fast and tuple(h.shape[1:]) == SEGMENT_A_SHAPE and self._fused_trunk_on():
            segment = trunk.fused_segment_reference if self.plain_ops else trunk.fused_segment
            # conv3 (+bn5) / conv6 (+bn9) + pool, conv10 (+bn12) / conv13 + pool
            for (k1, bn1, _), (k3, bn3, _), spec in ((TRUNK[0], TRUNK[1], trunk.SEGMENT_A),
                                                     (TRUNK[2], TRUNK[3], trunk.SEGMENT_B)):
                wa, ba = (t.detach() for t in self._folded(k1, bn1))
                wb, bb = (t.detach() for t in self._folded(k3, bn3))
                h = segment(h, wa, ba, wb, bb, spec)
            blocks = TRUNK[4:]
        for conv_key, bn_key, pooled in blocks:
            if fast:
                kernel, bias = self._folded(conv_key, bn_key)
                # bias added after the conv's bf16 store, as the JAX trunk does
                y = _conv_nhwc(h, kernel.to(dtype), None) + bias.to(dtype)
                h = layers.mfm_pool_2d(y) if pooled else layers.max_feature_map(y)
                continue
            conv = self.m_transform[conv_key]
            h = layers.max_feature_map(
                _conv_nhwc(h, conv.weight.to(h.dtype), conv.bias.to(h.dtype), exact))
            if pooled:
                h = layers.max_pool_2d(h)
            if bn_key is not None:
                h = self._bn(bn_key, h)
        h = F.dropout(h, p=0.7, training=self.training)

        # (B, T', W', C) -> (B, T', C, W') -> (B, T', C * W'), which is the
        # reference's permute(0, 2, 1, 3) + view from NCHW
        b, t = h.shape[0], h.shape[1]
        h = h.transpose(2, 3).reshape(b, t, -1).float()  # the LSTM tail runs f32
        lstm_out = self.m_before_pooling[1](self.m_before_pooling[0](h))
        pooled = (lstm_out + h).mean(dim=1)
        return self.m_output_act(pooled).float()
