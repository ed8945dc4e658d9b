"""ECAPA-TDNN timbre encoder (counterpart of after_tpu/models/ecapa.py).

Codec latents (B, T, in_size) -> timbre vector (B, out_dim).  Convs use
'same' reflect padding.  ``regularisation="vae"`` doubles the last layer
into [mean, scale] and samples the vector from the ``noise`` argument
(``models.encoder.reparametrise``).  BatchNorm runs on its running statistics at
inference and on the batch's in a training forward (``train``,
ops/train_mode.py).

Types and roundings follow the JAX module's: each conv and dense layer
computes at the promotion of its input's type and its parameters'
(``utils.precision``).  Below f32 a layer rounds its product and then adds
its bias, as flax's ``Conv`` and ``Dense`` do; the pooling's global
context takes x's type (the JAX package's ``jnp.full`` of a Python number
is weakly typed), and its softmax over time runs the exp, the sum and the
divide as ops of their own, as ``jax.nn.softmax`` does.  Under bf16
parameters the attention, the pooled statistics and the timbre vector are
then bf16, and a bf16 pooling fed the JAX module's inputs gives its bits.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ECAPAConfig
from ..ops.conv import conv1d
from ..ops.norms import BatchNorm
from ..ops.train_mode import TrainMode
from ..utils.precision import at, linear, promote
from .encoder import reparametrise


class ReflectConv(nn.Module):
    """'same' conv over (B, T, C), reflect-padded on time: span // 2 frames
    on the left, the rest on the right."""

    def __init__(self, in_c: int, features: int, kernel_size: int,
                 dilation: int = 1, groups: int = 1):
        super().__init__()
        self.span = dilation * (kernel_size - 1)
        self.Conv_0 = nn.Conv1d(in_c, features, kernel_size,
                                dilation=dilation, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)
        pad = self.span // 2
        if pad > 0:
            h = F.pad(h, (pad, self.span - pad), mode="reflect")
        c = self.Conv_0
        dtype = promote(h, c.weight)
        # below f32 flax's Conv rounds the conv before adding the bias
        split = dtype != torch.float32
        y = conv1d(h.to(dtype), at(c.weight, dtype),
                   None if split else at(c.bias, dtype), dilation=c.dilation,
                   groups=c.groups).transpose(1, 2)
        return y + at(c.bias, dtype) if split else y


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax's ``Dense``: ``linear`` in f32; below it the product is rounded
    before the bias is added."""
    dtype = promote(x, layer.weight)
    if dtype == torch.float32:
        return linear(layer, x)
    return F.linear(x.to(dtype), at(layer.weight, dtype)) + at(layer.bias,
                                                               dtype)


class TDNNBlock(nn.Module):
    """conv -> relu -> BatchNorm."""

    def __init__(self, in_c: int, features: int, kernel_size: int,
                 dilation: int = 1, groups: int = 1):
        super().__init__()
        self.conv = ReflectConv(in_c, features, kernel_size, dilation, groups)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        return self.bn(torch.relu(self.conv(x)), train)


class Res2NetBlock(nn.Module):
    """Split the channels into `scale` chunks; chunk 0 passes through, chunk
    i + 1 goes through tdnn_i after adding the previous chunk's output."""

    def __init__(self, features: int, scale: int = 8, kernel_size: int = 3,
                 dilation: int = 1):
        super().__init__()
        self.scale = scale
        hidden = features // scale
        for i in range(scale - 1):
            self.add_module(f"tdnn_{i}", TDNNBlock(hidden, hidden, kernel_size,
                                                   dilation))

    def forward(self, x: torch.Tensor,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        chunks = x.chunk(self.scale, dim=-1)
        y = [chunks[0]]
        y_i = None
        for i in range(self.scale - 1):
            inp = chunks[i + 1] if i == 0 else chunks[i + 1] + y_i
            y_i = getattr(self, f"tdnn_{i}")(inp, train)
            y.append(y_i)
        return torch.cat(y, dim=-1)


class SEBlock(nn.Module):
    """Squeeze-excitation over the time mean."""

    def __init__(self, in_c: int, se_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Linear(in_c, se_channels)
        self.conv2 = nn.Linear(se_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=1, keepdim=True)
        s = _dense(self.conv2, torch.relu(_dense(self.conv1, s)))
        if s.dtype == torch.float32:
            return torch.sigmoid(s) * x
        # XLA's logistic below f32: 1 / (1 + exp(-s)), each step rounded
        return 1 / (1 + torch.exp(-s)) * x


class SERes2NetBlock(nn.Module):

    def __init__(self, in_c: int, features: int, res2net_scale: int = 8,
                 se_channels: int = 128, kernel_size: int = 1,
                 dilation: int = 1, groups: int = 1):
        super().__init__()
        self.shortcut = (nn.Linear(in_c, features) if in_c != features
                         else None)
        self.tdnn1 = TDNNBlock(in_c, features, 1, 1, groups)
        self.res2net = Res2NetBlock(features, res2net_scale, kernel_size,
                                    dilation)
        self.tdnn2 = TDNNBlock(features, features, 1, 1, groups)
        self.se = SEBlock(features, se_channels, features)

    def forward(self, x: torch.Tensor,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        residual = (_dense(self.shortcut, x) if self.shortcut is not None
                    else x)
        h = self.tdnn2(self.res2net(self.tdnn1(x, train), train), train)
        return self.se(h) + residual


def _stats(m: torch.Tensor, y: torch.Tensor, eps: float = 1e-12):
    mean = (m * y).sum(dim=1)
    var = (m * torch.square(y - mean[:, None])).sum(dim=1)
    return mean, torch.sqrt(var.clamp_min(eps))


def _softmax(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax``: the exp, the sum and the divide each rounded to
    a's type (``torch.softmax`` rounds a bf16 result once)."""
    e = torch.exp(a - a.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


class AttentiveStatisticsPooling(nn.Module):
    """(B, T, C) -> (B, 2C) attention-weighted mean and std, with the global
    mean and std of x appended to the attention input."""

    def __init__(self, channels: int, attention_channels: int = 128,
                 global_context: bool = True):
        super().__init__()
        self.global_context = global_context
        in_c = channels * 3 if global_context else channels
        self.tdnn = TDNNBlock(in_c, attention_channels, 1, 1)
        self.conv = nn.Linear(attention_channels, channels)

    def forward(self, x: torch.Tensor,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        B, T, C = x.shape
        if self.global_context:
            # at x's type: the JAX package's jnp.full of a Python number is
            # weakly typed
            mean, std = _stats(torch.full((B, T, 1), 1.0 / T, dtype=x.dtype,
                                          device=x.device), x)
            attn_in = torch.cat([x, mean[:, None].expand(B, T, C),
                                 std[:, None].expand(B, T, C)], dim=-1)
        else:
            attn_in = x
        a = _dense(self.conv, torch.tanh(self.tdnn(attn_in, train)))
        a = _softmax(a, dim=1)
        mean, std = _stats(a, x)
        return torch.cat([mean, std], dim=-1)


class ECAPAEncoder(nn.Module):
    """Codec latents (B, T, in_size) -> (z, mean, reg) with z (B, out_dim)."""

    def __init__(self, cfg: ECAPAConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.channels
        self.block_0 = TDNNBlock(cfg.in_size, ch[0], cfg.kernel_sizes[0],
                                 cfg.dilations[0], cfg.groups[0])
        for i in range(1, len(ch) - 1):
            self.add_module(f"block_{i}", SERes2NetBlock(
                ch[i - 1], ch[i], cfg.res2net_scale, cfg.se_channels,
                cfg.kernel_sizes[i], cfg.dilations[i], cfg.groups[i]))
        self.n_blocks = len(ch) - 1
        self.mfa = TDNNBlock(sum(ch[1:-1]), ch[-1], cfg.kernel_sizes[-1],
                             cfg.dilations[-1], cfg.groups[-1])
        if cfg.pooling:
            self.asp = AttentiveStatisticsPooling(
                ch[-1], cfg.attention_channels, cfg.global_context)
            self.asp_bn = BatchNorm(2 * ch[-1])
            fc_in = 2 * ch[-1]
        else:
            self.asp = self.asp_bn = None
            fc_in = ch[-1]
        self.fc = nn.Linear(fc_in, cfg.out_dim * (
            2 if cfg.regularisation == "vae" else 1))

    def forward(self, x: torch.Tensor, train: Optional[TrainMode] = None,
                noise: Optional[torch.Tensor] = None):
        """``noise`` is the VAE's sample noise, a (B, out_dim) standard
        normal draw (``regularisation="vae"``; required there)."""
        cfg = self.cfg
        h = self.block_0(x, train)
        feats = []
        for i in range(1, self.n_blocks):
            h = getattr(self, f"block_{i}")(h, train)
            feats.append(h)
        h = self.mfa(torch.cat(feats, dim=-1), train)
        if self.asp is not None:
            h = self.asp_bn(self.asp(h, train), train)
        z = _dense(self.fc, h)
        if cfg.use_tanh:
            z = torch.tanh(z)
        if cfg.spherical_normalisation:
            z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        if cfg.regularisation == "vae":
            return reparametrise(z, noise, "the timbre encoder")
        if cfg.regularisation == "ac":
            reg = torch.relu(z.abs() - 1).mean()
        else:
            reg = torch.zeros((), device=z.device)   # jnp.asarray(0.0): f32
        return z, z, reg
