"""Multiband audio codec, offline and streaming (counterpart of
after_tpu/models/autoencoder.py).

waveform (B, T, 1) --PQMF--> bands (B, T/M, M) --conv encoder--> latents
(B, T/ratio, z) --bottleneck--> z --conv decoder--> bands --inverse PQMF-->
waveform.  Every ConvBlock1d that runs offline convs runs its snake + conv
as the fused snake+conv op (ops/kernels/fused_conv.py): the CUDA kernel on
the card, the plain PyTorch version on the CPU.

``streaming`` takes the JAX package's three values:

- ``False``: offline;
- ``True``: cached causal convs, streaming PQMF, streaming transposed-conv
  tails (a causal codec, norm-free, streams exactly);
- ``"norm"``: GroupNorm streams its statistics over a pad of the previous
  input while convs and PQMF run offline over the window they are given
  (the crossfade path of a non-causal codec, streaming/crossfade.py).

A streaming codec takes the cache (streaming/state.py) as the last argument
of ``encode`` and ``decode``.

``AudioCodec.forward`` is the training forward (counterpart of the JAX
``AudioCodec.__call__``): it returns (y, y_bands, z, reg, x_bands) with the
regularising bottleneck, whose noise is an argument.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..config import AutoEncoderConfig
from ..ops.conv import StreamConv1d, StreamConvTranspose1d
from ..ops.kernels.fused_conv import snake_conv
from ..ops.norms import GroupNorm
from ..ops.pqmf import PQMFAnalysis, PQMFSynthesis
from ..ops.snake import SnakeBeta
from ..streaming.state import Cache, Streaming, name_slots
from ..utils.precision import at, promote

StreamMode = Union[bool, str]


class StreamGroupNorm(nn.Module, Streaming):
    """GroupNorm with min(C, num_groups) groups and eps 1e-5.  Streaming, the
    input is normalised together with the previous call's input (``pad``,
    the shape of the input), which approximates the offline statistics."""

    def __init__(self, num_channels: int, num_groups: int,
                 streaming: bool = False):
        super().__init__()
        self.gn = GroupNorm(num_channels, min(num_channels, num_groups))
        self.streaming = streaming

    def forward(self, x: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        if not self.streaming:
            return self.gn(x)
        pad = self.slot(cache, "pad", lambda: torch.zeros_like(x))
        full = torch.cat([pad, x], dim=1)
        pad.copy_(x)
        return self.gn(full)[:, full.shape[1] - x.shape[1]:]


class ConvBlock1d(nn.Module):
    """[GroupNorm] -> SnakeBeta -> weight-normed stride-1 conv.

    Offline and in ``"norm"`` mode the snake and the conv are fused into one
    op (the kernel on the card).  With ``streaming=True`` the conv is cached
    and runs after the plain snake: the cache holds post-snake frames and
    the kernel has one length for input and output."""

    def __init__(self, in_c: int, out_c: int, kernel_size: int = 3,
                 dilation: int = 1, num_groups: int = 8, use_norm: bool = True,
                 mode: str = "centered", streaming: StreamMode = False):
        super().__init__()
        self.gn = (StreamGroupNorm(in_c, num_groups, bool(streaming))
                   if use_norm else None)
        self.act = SnakeBeta(in_c)
        self.cached = streaming is True
        self.conv = StreamConv1d(in_c, out_c, kernel_size, dilation=dilation,
                                 mode=mode, kernel_layout=not self.cached,
                                 streaming=self.cached)

    def forward(self, x: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        h = self.gn(x, cache) if self.gn is not None else x
        if self.cached:
            return self.conv(self.act(h), cache)
        # the kernel reads (B, T, C) rows; GroupNorm keeps a transposed
        # input's strides and a streaming GroupNorm returns a slice, so make
        # the layout explicit.  The weight comes in the kernel's own layout
        # (kernel_layout), so no call copies it.  The op runs at the
        # promotion of the input's type and the parameters' (an f32 input
        # under bf16 training parameters: the f32 kernel on their widened
        # values)
        act, conv = self.act, self.conv
        dtype = torch.promote_types(promote(h, act.alpha), conv.weight_dtype)
        return snake_conv(h.contiguous().to(dtype), at(act.alpha, dtype),
                          at(act.beta, dtype), *conv.kernel_weights(dtype),
                          at(conv.bias, dtype), conv.dilation, conv.mode)


class ResnetBlock1d(nn.Module):
    """conv(k, d) -> conv(1); residual through a 1x1 conv if channels change."""

    def __init__(self, in_c: int, out_c: int, kernel_size: int = 3,
                 dilation: int = 1, num_groups: int = 8, use_norm: bool = True,
                 use_res: bool = True, mode: str = "centered",
                 streaming: StreamMode = False):
        super().__init__()
        self.block1 = ConvBlock1d(in_c, out_c, kernel_size, dilation,
                                  num_groups, use_norm, mode, streaming)
        self.block2 = ConvBlock1d(out_c, out_c, 1, 1, num_groups, use_norm,
                                  mode, streaming)
        self.use_res = use_res
        self.to_out = (StreamConv1d(in_c, out_c, 1, mode="valid")
                       if use_res and in_c != out_c else None)

    def forward(self, x: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        h = self.block2(self.block1(x, cache), cache)
        if not self.use_res:
            return h
        res = self.to_out(x) if self.to_out is not None else x
        return h + res


class DownsampleBlock1d(nn.Module):
    """N resnet blocks -> snake -> strided downsample conv."""

    def __init__(self, in_c: int, out_c: int, factor: int, num_layers: int,
                 dilations: Sequence[int], kernel_size: int, num_groups: int,
                 use_norm: bool, mode: str, streaming: StreamMode = False):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"res_{i}", ResnetBlock1d(
                in_c, in_c, kernel_size, dilations[i], num_groups, use_norm,
                True, mode, streaming))
        self.num_layers = num_layers
        self.act = SnakeBeta(in_c)
        self.down = StreamConv1d(in_c, out_c, 2 * factor, stride=factor,
                                 mode=mode, streaming=streaming is True)

    def forward(self, x: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"res_{i}")(x, cache)
        return self.down(self.act(x), cache)


class UpsampleBlock1d(nn.Module):
    """snake -> transposed-conv upsample -> N resnet blocks."""

    def __init__(self, in_c: int, out_c: int, factor: int, num_layers: int,
                 dilations: Sequence[int], kernel_size: int, num_groups: int,
                 use_norm: bool, mode: str, streaming: StreamMode = False):
        super().__init__()
        self.act = SnakeBeta(in_c)
        self.up = StreamConvTranspose1d(in_c, out_c, 2 * factor, factor,
                                        streaming=streaming is True)
        for i in range(num_layers):
            self.add_module(f"res_{i}", ResnetBlock1d(
                out_c, out_c, kernel_size, dilations[i], num_groups, use_norm,
                True, mode, streaming))
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        h = self.up(self.act(x), cache)
        for i in range(self.num_layers):
            h = getattr(self, f"res_{i}")(h, cache)
        return h


def _mode(cfg: AutoEncoderConfig) -> str:
    return "causal" if cfg.causal else "centered"


class CodecEncoder(nn.Module):
    """Band signals (B, Tb, M) -> latents (B, Tb / prod(factors), z)."""

    def __init__(self, cfg: AutoEncoderConfig, streaming: StreamMode = False):
        super().__init__()
        mode = _mode(cfg)
        ch = cfg.base_channels
        in_c = cfg.pqmf_bands if cfg.pqmf_bands > 1 else 1
        out_channels = cfg.z_channels * (2 if cfg.bottleneck == "vae" else 1)
        widths = [ch * m for m in cfg.multipliers]
        self.to_in = ResnetBlock1d(in_c, widths[0], cfg.kernel_size, 1,
                                   cfg.resnet_groups, cfg.use_norm, True, mode,
                                   streaming)
        for i, f in enumerate(cfg.factors):
            self.add_module(f"down_{i}", DownsampleBlock1d(
                widths[i], widths[i + 1], f, cfg.num_blocks_per_stage,
                cfg.dilations, cfg.kernel_size, cfg.resnet_groups,
                cfg.use_norm, mode, streaming))
        self.n_down = len(cfg.factors)
        self.act = SnakeBeta(widths[-1])
        self.to_out = StreamConv1d(widths[-1], out_channels, 3, mode=mode,
                                   streaming=streaming is True)

    def forward(self, xb: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        h = self.to_in(xb, cache)
        for i in range(self.n_down):
            h = getattr(self, f"down_{i}")(h, cache)
        return self.to_out(self.act(h), cache)


class CodecDecoder(nn.Module):
    """Latents (B, Tl, z) -> band signals (B, Tl * prod(factors), M)."""

    def __init__(self, cfg: AutoEncoderConfig, streaming: StreamMode = False):
        super().__init__()
        if cfg.use_noise:
            raise NotImplementedError(
                "the port has no NoiseGenerator yet (use_noise=False)")
        mode = _mode(cfg)
        ch = cfg.base_channels
        widths = [ch * int(m * cfg.decoder_ratio)
                  for m in cfg.multipliers[::-1]]
        factors = cfg.factors[::-1]
        out_c = cfg.pqmf_bands if cfg.pqmf_bands > 1 else 1
        self.to_in = StreamConv1d(cfg.z_channels, widths[0], cfg.kernel_size,
                                  mode=mode, streaming=streaming is True)
        for i, f in enumerate(factors):
            self.add_module(f"up_{i}", UpsampleBlock1d(
                widths[i], widths[i + 1], f, cfg.num_blocks_per_stage,
                cfg.dilations, cfg.kernel_size, cfg.resnet_groups,
                cfg.use_norm, mode, streaming))
        self.n_up = len(factors)
        self.use_loudness = cfg.use_loudness
        self.to_out = ResnetBlock1d(
            widths[-1], out_c * 2 if cfg.use_loudness else out_c,
            cfg.kernel_size, 1, cfg.resnet_groups, cfg.use_norm, False, mode,
            streaming)

    def forward(self, z: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        h = self.to_in(z, cache)
        for i in range(self.n_up):
            h = getattr(self, f"up_{i}")(h, cache)
        h = self.to_out(h, cache)
        if self.use_loudness:
            y, amp = h.chunk(2, dim=-1)
            h = y * torch.sigmoid(amp)
        return h


def decoder_band_delay(cfg: AutoEncoderConfig) -> int:
    """Streaming delay (band-rate frames) of the causal decoder against the
    centered offline one: each transposed-conv upsample adds factor // 2
    frames at its output rate; causal convs add none."""
    d = 0
    for f in cfg.factors[::-1]:
        d = d * f + f // 2
    return d


def relu_bottleneck_reg(z: torch.Tensor, scale: float = 3.0) -> torch.Tensor:
    """SimpleLatentReg: ELU(|z| - scale).mean() + 1 (core.py:189-198)."""
    return torch.mean(F.elu(z.abs() - scale)) + 1.0


class AudioCodec(nn.Module):
    """encode: (B, T, 1) waveform -> (B, T / ratio, z); decode: latents ->
    waveform (T + M samples in centered mode, as in the JAX package).  A
    streaming codec (``streaming`` True or ``"norm"``) takes its cache as
    the last argument of both."""

    def __init__(self, cfg: AutoEncoderConfig, streaming: StreamMode = False):
        super().__init__()
        self.cfg = cfg
        self.streaming = streaming
        if cfg.pqmf_bands > 1:
            self.pqmf = PQMFAnalysis(cfg.pqmf_attenuation, cfg.pqmf_bands,
                                     cfg.causal, streaming is True)
            self.pqmf_inv = PQMFSynthesis(
                cfg.pqmf_attenuation, cfg.pqmf_bands, cfg.causal,
                streaming is True, parity=decoder_band_delay(cfg) % 2)
        else:
            self.pqmf = self.pqmf_inv = None
        self.encoder = CodecEncoder(cfg, streaming)
        self.decoder = CodecDecoder(cfg, streaming)
        name_slots(self)

    def bottleneck(self, z: torch.Tensor) -> torch.Tensor:
        """Inference bottleneck: no noise is drawn."""
        kind = self.cfg.bottleneck
        if kind == "relu":
            return z                   # the relu bottleneck only regularises
        if kind == "tanh":
            return self.cfg.bottleneck_scale * torch.tanh(z)
        if kind == "vae":
            return z.chunk(2, dim=-1)[0]
        return z

    def regularise(self, z: torch.Tensor, noise: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training bottleneck: (latents, regularisation loss).  ``noise`` is
        a standard normal draw of shape (B, T / ratio, z_channels): added at
        ``bottleneck_sigma`` to a relu or tanh bottleneck, the VAE's sample
        noise; without it no noise is applied (the VAE returns its mean)."""
        cfg = self.cfg
        kind = cfg.bottleneck
        if kind == "relu":
            reg = relu_bottleneck_reg(z, cfg.bottleneck_scale)
            if noise is not None:
                z = z + cfg.bottleneck_sigma * noise
            return z, reg
        if kind == "tanh":
            z = cfg.bottleneck_scale * torch.tanh(z)
            if noise is not None:
                z = z + cfg.bottleneck_sigma * noise
            return z, z.new_zeros(())
        if kind == "vae":
            mean, scale = z.chunk(2, dim=-1)
            std = F.softplus(scale) + 1e-2
            var = std * std
            z = mean + std * noise if noise is not None else mean
            kl = torch.mean(torch.sum(mean * mean + var - torch.log(var) - 1,
                                      dim=-1))
            return z, kl
        return z, z.new_zeros(())

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None):
        """Training forward of an offline codec: (B, T, 1) waveform ->
        (y, y_bands, z, reg, x_bands), the JAX ``AudioCodec.__call__``."""
        if self.streaming:
            raise ValueError("the training forward runs on an offline codec")
        xb = self.pqmf(x) if self.pqmf is not None else x
        z, reg = self.regularise(self.encoder(xb), noise)
        yb = self.decoder(z)
        y = self.pqmf_inv(yb) if self.pqmf_inv is not None else yb
        return y, yb, z, reg, xb

    def encode(self, x: torch.Tensor,
               cache: Optional[Cache] = None) -> torch.Tensor:
        xb = self.pqmf(x, cache) if self.pqmf is not None else x
        return self.bottleneck(self.encoder(xb, cache))

    def decode(self, z: torch.Tensor,
               cache: Optional[Cache] = None) -> torch.Tensor:
        yb = self.decoder(z, cache)
        return self.pqmf_inv(yb, cache) if self.pqmf_inv is not None else yb
