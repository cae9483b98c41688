"""RawNet3 raw-waveform detector in PyTorch.

Port of ``adaa_tpu/models/rawnet3.py``: pre-emphasis and instance norm,
the learnable parametric sinc filterbank (``ops/sinc_conv.py``, sample
rate 8000, half-Hamming window, cos+sin banks), three Res2Net
``Bottle2neck`` blocks with AFMS, a 1x1 conv to 1536 channels,
attentive statistics pooling and one output logit. Forward maps a raw
wave (B, L) -> logit (B, 1); 64,600 samples give T = 6435 after the
encoder.

Layouts are channels-last, (B, T, C), as in the JAX model. Dtypes follow
the JAX model's: with ``compute_dtype=torch.bfloat16`` the sinc products
take bf16 operands and the encoder tail (abs, log) runs in bf16 on the
card (a CPU tensor keeps both in f32, as JAX does on the CPU); each
block's convs and BNs produce bf16, but ``AFMS`` adds an f32 ``alpha``
and multiplies by an f32 gate, so every block's output is f32, and so are
layer 2's residual sum and pools and ``mp3_x1``; the pooling head runs in
f32. Every 1x1 conv is a matmul and every dilated k=3 conv one matmul of
the three taps side by side, so f32 products never go through cuDNN's
TF32.

Two switches on the bf16 eval path, as the JAX package's
``ADAA_PALLAS_POOL=1`` and ``ADAA_FUSED_B2N=1`` (``None`` reads the
environment variable per call):

* ``fused_pool``: bf16 pools go through the first-max pool kernel
  (``ops/pool.py``). Only layer 1's w=5 pool is bf16.
* ``fused_b2n``: each block body runs as the fused kernel
  (``ops/b2n.py``), with its BNs folded to affines and x rounded to
  bf16; AFMS stays outside.

``plain_ops = True`` sends both ops to their plain versions on any
device. The JAX model's ``ADAA_RAWNET_SCAN`` variant is not ported.
Training is not ported either: the sinc filterbank's weight gradient
raises.

Module names give the reference's ``state_dict`` keys
(``preprocess.1``, ``conv1.filterbank.*``, ``layer{1,2,3}.*``,
``layer4``, ``attention.{0,2,3}``, ``bn5``, ``fc6`` and the unused
``bn6``), so a reference checkpoint loads with ``load_state_dict``.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from adaa_tpu_torch.models import layers
from adaa_tpu_torch.ops import b2n, pool
from adaa_tpu_torch.ops.sinc_conv import sinc_conv

C = 1024
SCALE = 8
BN_EPS = 1e-5


def _sinc_init_hz(cutoff: int, sample_rate: float, min_low_hz: float, min_band_hz: float):
    """Mel-spaced initial (low_hz, band_hz): asteroid's ParamSincFB init."""
    low_hz = 30.0
    high_hz = sample_rate / 2 - (min_low_hz + min_band_hz)
    to_mel = lambda hz: 2595.0 * np.log10(1.0 + hz / 700.0)  # noqa: E731
    to_hz = lambda mel: 700.0 * (10.0 ** (mel / 2595.0) - 1.0)  # noqa: E731
    mel = np.linspace(to_mel(low_hz), to_mel(high_hz), cutoff + 1)
    hz = to_hz(mel)
    return hz[:-1].astype(np.float32), np.diff(hz).astype(np.float32)


class ParamSincFB(nn.Module):
    """Learnable parametric sinc filterbank (asteroid-compatible keys):
    the first half cosine-phase band-pass filters, the second half
    sine-phase."""

    def __init__(self, n_filters: int = 256, kernel_size: int = 251, stride: int = 10,
                 sample_rate: float = 8000.0, min_low_hz: float = 50.0,
                 min_band_hz: float = 50.0):
        super().__init__()
        self.n_filters, self.kernel_size, self.stride = n_filters, kernel_size, stride
        self.sample_rate, self.min_low_hz, self.min_band_hz = sample_rate, min_low_hz, min_band_hz
        cutoff, half = n_filters // 2, kernel_size // 2
        self.low_hz_ = nn.Parameter(torch.empty(cutoff, 1))
        self.band_hz_ = nn.Parameter(torch.empty(cutoff, 1))
        self.register_buffer(
            "window_", torch.from_numpy(np.hamming(kernel_size)[:half].astype(np.float32)))
        self.register_buffer("n_", torch.from_numpy(
            (2.0 * math.pi * np.arange(-half, 0.0) / sample_rate).astype(np.float32))[None, :])

    def reset_parameters(self) -> None:
        low, band = _sinc_init_hz(self.n_filters // 2, self.sample_rate, self.min_low_hz,
                                  self.min_band_hz)
        with torch.no_grad():
            self.low_hz_.copy_(torch.from_numpy(low)[:, None])
            self.band_hz_.copy_(torch.from_numpy(band)[:, None])

    def filters(self) -> torch.Tensor:
        """(n_filters, kernel_size) f32."""
        low = self.min_low_hz + self.low_hz_.abs()  # (cutoff, 1)
        high = torch.clamp(low + self.min_band_hz + self.band_hz_.abs(), self.min_low_hz,
                           self.sample_rate / 2)
        band = (high - low)[:, 0]
        ftl, fth = low @ self.n_, high @ self.n_  # (cutoff, half)
        cos_left = ((torch.sin(fth) - torch.sin(ftl)) / (self.n_ / 2.0)) * self.window_
        cos_filt = torch.cat([cos_left, 2.0 * band[:, None], cos_left.flip(1)], dim=1)
        sin_left = ((torch.cos(ftl) - torch.cos(fth)) / (self.n_ / 2.0)) * self.window_
        sin_filt = torch.cat([sin_left, torch.zeros_like(band)[:, None], -sin_left.flip(1)], dim=1)
        return torch.cat([cos_filt / (2.0 * band[:, None]), sin_filt / (2.0 * band[:, None])], 0)


class Encoder(nn.Module):
    """Holder that gives the reference's key names (``conv1.filterbank.*``)."""

    def __init__(self, filterbank: ParamSincFB):
        super().__init__()
        self.filterbank = filterbank


class PreEmphasis(nn.Module):
    """y[t] = x[t] - 0.97 x[t - 1] with a left reflect: y[0] = x[0] - 0.97 x[1]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x - 0.97 * torch.cat([x[:, 1:2], x[:, :-1]], dim=1)


def _conv1x1(x: torch.Tensor, conv: nn.Conv1d, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A flax 1x1 ``nn.Conv`` with ``dtype`` on (B, T, I): the product in
    ``dtype`` (f32 when None), then the bias added in ``dtype``."""
    dt = dtype or torch.float32
    y = torch.matmul(x.to(dt), conv.weight[:, :, 0].to(dt).T)
    return y if conv.bias is None else y + conv.bias.to(dt)


def _conv_k3(x: torch.Tensor, conv: nn.Conv1d, dilation: int,
             dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A 'SAME' dilated k=3 conv on (B, T, I) as one product of the three
    taps side by side (one rounding in bf16, as the conv)."""
    dt = dtype or torch.float32
    x = x.to(dt)
    taps = torch.cat([b2n.shift_time(x, (s - 1) * dilation) for s in range(3)], dim=-1)
    w = conv.weight.to(dt).permute(2, 1, 0).reshape(-1, conv.weight.shape[0])  # (3 I, O)
    return torch.matmul(taps, w) + conv.bias.to(dt)


def _bn(bn: nn.BatchNorm1d, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Eval-mode flax ``BatchNorm`` with ``dtype``: f32 math, cast to ``dtype``."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = (x.float() - bn.running_mean) * mul + bn.bias
    return y.to(dtype or torch.float32)


class AFMS(nn.Module):
    """Alpha feature-map scaling: (x + alpha) * sigmoid(fc(mean_t x)); f32 out."""

    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(dim, 1))
        self.fc = nn.Linear(dim, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.alpha.fill_(1.0)
            layers.kaiming_uniform_linear(self.fc.weight, generator)
            layers.conv_bias_init(self.fc.bias, self.fc.in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.fc(x.mean(dim=1).float()))[:, None, :]
        return (x + self.alpha[:, 0]) * gate


class Bottle2neck(nn.Module):
    """Res2Net bottleneck with dilated convs, relu before each BN."""

    def __init__(self, inplanes: int, planes: int, dilation: int, pool_size: int = 0,
                 kernel_size: int = 3, scale: int = SCALE):
        super().__init__()
        self.inplanes, self.planes, self.dilation, self.pool = inplanes, planes, dilation, pool_size
        self.width = planes // scale
        self.nums = scale - 1
        self.conv1 = nn.Conv1d(inplanes, self.width * scale, 1)
        self.bn1 = nn.BatchNorm1d(self.width * scale, eps=BN_EPS)
        pad = (kernel_size // 2) * dilation
        self.convs = nn.ModuleList([nn.Conv1d(self.width, self.width, kernel_size,
                                              dilation=dilation, padding=pad)
                                    for _ in range(self.nums)])
        self.bns = nn.ModuleList([nn.BatchNorm1d(self.width, eps=BN_EPS)
                                  for _ in range(self.nums)])
        self.conv3 = nn.Conv1d(self.width * scale, planes, 1)
        self.bn3 = nn.BatchNorm1d(planes, eps=BN_EPS)
        self.residual = (nn.Sequential(nn.Conv1d(inplanes, planes, 1, bias=False))
                         if inplanes != planes else nn.Identity())
        self.afms = AFMS(planes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            convs = [self.conv1, self.conv3, *self.convs]
            if isinstance(self.residual, nn.Sequential):
                convs.append(self.residual[0])
            for conv in convs:
                layers.kaiming_uniform_conv(conv.weight, generator)
                if conv.bias is not None:
                    conv.bias.zero_()
            for bn in (self.bn1, self.bn3, *self.bns):
                bn.reset_parameters()
        self.afms.reset_parameters(generator)

    def _affine(self, bn: nn.BatchNorm1d):
        s = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
        return s, bn.bias - bn.running_mean * s

    def folded(self) -> b2n.B2NParams:
        """The fused kernel's parameters: BNs folded to affines, weights as
        (in, out) bf16 matrices (the JAX model's ``_fused_pallas``)."""
        bf = torch.bfloat16
        s1, t1 = self._affine(self.bn1)
        s3, t3 = self._affine(self.bn3)
        chain = [self._affine(bn) for bn in self.bns]
        wc = torch.cat([conv.weight[:, :, s].T for conv in self.convs for s in range(3)])
        wr = (None if isinstance(self.residual, nn.Identity)
              else self.residual[0].weight[:, :, 0].T.to(bf))
        p = b2n.B2NParams(
            w1=self.conv1.weight[:, :, 0].T.to(bf), b1=self.conv1.bias, s1=s1, t1=t1,
            wc=wc.to(bf), bc=torch.cat([conv.bias for conv in self.convs]),
            sc=torch.cat([s for s, _ in chain]), tc=torch.cat([t for _, t in chain]),
            w3=self.conv3.weight[:, :, 0].T.to(bf), b3=self.conv3.bias, s3=s3, t3=t3, wr=wr)
        return b2n.B2NParams(*(None if a is None else a.detach().contiguous() for a in p))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype], fused_pool: bool,
                fused_b2n: bool, plain: bool) -> torch.Tensor:
        if fused_b2n and dtype == torch.bfloat16 and not self.training:
            fn = b2n.fused_bottle2neck_reference if plain else b2n.fused_bottle2neck
            return self.afms(fn(x.to(torch.bfloat16), self.folded(), self.dilation, self.pool))
        residual = x if isinstance(self.residual, nn.Identity) else _conv1x1(
            x, self.residual[0], dtype)
        out = _bn(self.bn1, torch.relu(_conv1x1(x, self.conv1, dtype)), dtype)
        spx = out.split(self.width, dim=-1)
        outs, sp = [], None
        for i in range(self.nums):
            sp = spx[i] if i == 0 else sp + spx[i]
            sp = _bn(self.bns[i], torch.relu(_conv_k3(sp, self.convs[i], self.dilation, dtype)),
                     dtype)
            outs.append(sp)
        outs.append(spx[self.nums])
        out = _bn(self.bn3, torch.relu(_conv1x1(torch.cat(outs, dim=-1), self.conv3, dtype)),
                  dtype)
        out = out + residual
        if self.pool:
            if fused_pool and out.dtype == torch.bfloat16:
                fn = pool.max_pool_1d_reference if plain else pool.max_pool_1d
                out = fn(out, self.pool)
            else:
                out = layers.max_pool_1d(out, self.pool)
        return self.afms(out)


def _switch(value: Optional[bool], env: str) -> bool:
    return os.environ.get(env) == "1" if value is None else value


class RawNet3(nn.Module):
    """RawNet3 with the reference's fixed hyperparameters (C=1024, scale 8,
    context, summed, log sinc, mean norm, sinc stride 10, one output, no
    output BN).

    Args:
      compute_dtype: ``torch.bfloat16`` for the bf16 trunk and encoder
        products; the pooling head stays f32.
      fused_pool: bf16 pools through the pool kernel; None reads
        ``ADAA_PALLAS_POOL == "1"`` per call.
      fused_b2n: the block bodies through the fused kernel on the bf16
        eval path; None reads ``ADAA_FUSED_B2N == "1"`` per call.
    """

    def __init__(self, compute_dtype: Optional[torch.dtype] = None,
                 fused_pool: Optional[bool] = None, fused_b2n: Optional[bool] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fused_pool = fused_pool
        self.fused_b2n = fused_b2n
        # checks the kernels: the pool and b2n ops run their plain versions
        self.plain_ops = False
        self.preprocess = nn.Sequential(PreEmphasis(), nn.InstanceNorm1d(1, eps=1e-4, affine=True))
        self.conv1 = Encoder(ParamSincFB(C // 4, 251, stride=10))
        self.layer1 = Bottle2neck(C // 4, C, dilation=2, pool_size=5)
        self.layer2 = Bottle2neck(C, C, dilation=3, pool_size=3)
        self.layer3 = Bottle2neck(C, C, dilation=4)
        self.layer4 = nn.Conv1d(3 * C, 1536, 1)
        self.attention = nn.Sequential(
            nn.Conv1d(1536 * 3, 128, 1), nn.ReLU(), nn.BatchNorm1d(128, eps=BN_EPS),
            nn.Conv1d(128, 1536, 1), nn.Softmax(dim=2))
        self.bn5 = nn.BatchNorm1d(3072, eps=BN_EPS)
        self.fc6 = nn.Linear(3072, 1)
        self.bn6 = nn.BatchNorm1d(1, eps=BN_EPS)  # in checkpoints; unused (no output BN)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX model's initialisers, drawn from ``generator``."""
        with torch.no_grad():
            norm = self.preprocess[1]
            norm.weight.fill_(1.0)
            norm.bias.zero_()
            self.conv1.filterbank.reset_parameters()
            for layer in (self.layer1, self.layer2, self.layer3):
                layer.reset_parameters(generator)
            for conv in (self.layer4, self.attention[0], self.attention[3]):
                layers.kaiming_uniform_conv(conv.weight, generator)
                conv.bias.zero_()
            for bn in (self.attention[2], self.bn5, self.bn6):
                bn.reset_parameters()
            layers.kaiming_uniform_linear(self.fc6.weight, generator)
            layers.conv_bias_init(self.fc6.bias, 3072, generator)

    def _encoder(self, x: torch.Tensor) -> torch.Tensor:
        h = self.preprocess[0](x)
        norm = self.preprocess[1]
        mean = h.mean(dim=1, keepdim=True)
        var = h.var(dim=1, keepdim=True, unbiased=False)
        h = (h - mean) / torch.sqrt(var + norm.eps) * norm.weight + norm.bias
        fb = self.conv1.filterbank
        filters = fb.filters() if self.training else fb.filters().detach()
        compute = "bf16" if self.compute_dtype == torch.bfloat16 else "f32"
        h = sinc_conv(h, filters, fb.stride, need_dw=self.training, compute=compute)
        if self.compute_dtype == torch.bfloat16 and h.device.type != "cpu":
            h = h.to(torch.bfloat16)  # the bf16 encoder tail, on the card only
        h = torch.log(h.abs() + 1e-6)
        h = h - h.mean(dim=1, keepdim=True, dtype=torch.float32).to(h.dtype)
        return h if self.compute_dtype is None else h.to(self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2:
            raise ValueError(f"RawNet3 takes raw waves (B, L), got {tuple(x.shape)}")
        dt = self.compute_dtype
        switches = (dt, _switch(self.fused_pool, "ADAA_PALLAS_POOL"),
                    _switch(self.fused_b2n, "ADAA_FUSED_B2N"), self.plain_ops)
        h = self._encoder(x)
        x1 = self.layer1(h, *switches)
        x2 = self.layer2(x1, *switches)
        mp3_x1 = layers.max_pool_1d(x1, 3)
        x3 = self.layer3(mp3_x1 + x2, *switches)

        h = torch.relu(_conv1x1(torch.cat([mp3_x1, x2, x3], dim=-1), self.layer4, dt)).float()
        mu_t = h.mean(dim=1, keepdim=True)
        sg_t = torch.sqrt(torch.clamp(h.var(dim=1, keepdim=True, unbiased=True), 1e-4, 1e4))
        global_x = torch.cat([h, mu_t.expand_as(h), sg_t.expand_as(h)], dim=-1)
        w = torch.relu(_conv1x1(global_x, self.attention[0], None))
        w = _conv1x1(_bn(self.attention[2], w, None), self.attention[3], None)
        w = torch.softmax(w, dim=1)  # over time
        mu = (h * w).sum(dim=1)
        sg = torch.sqrt(torch.clamp((h * h * w).sum(dim=1) - mu * mu, 1e-4, 1e4))
        h = _bn(self.bn5, torch.cat([mu, sg], dim=-1), None)
        return self.fc6(h)
