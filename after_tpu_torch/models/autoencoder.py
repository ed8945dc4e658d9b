"""Multiband audio codec, offline (counterpart of
after_tpu/models/autoencoder.py).

waveform (B, T, 1) --PQMF--> bands (B, T/M, M) --conv encoder--> latents
(B, T/ratio, z) --bottleneck--> z --conv decoder--> bands --inverse PQMF-->
waveform.  Every ConvBlock1d runs its snake + conv as the fused snake+conv
op (ops/kernels/fused_conv.py): the CUDA kernel on the card, the plain
PyTorch version on the CPU.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..config import AutoEncoderConfig
from ..ops.conv import StreamConv1d, StreamConvTranspose1d
from ..ops.kernels.fused_conv import fused_snake_conv
from ..ops.norms import GroupNorm
from ..ops.pqmf import PQMFAnalysis, PQMFSynthesis
from ..ops.snake import SnakeBeta


class StreamGroupNorm(nn.Module):
    """Offline GroupNorm with min(C, num_groups) groups and eps 1e-5 (the
    streaming pad buffer of the JAX module waits for the streaming port)."""

    def __init__(self, num_channels: int, num_groups: int):
        super().__init__()
        self.gn = GroupNorm(num_channels, min(num_channels, num_groups))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gn(x)


class ConvBlock1d(nn.Module):
    """[GroupNorm] -> SnakeBeta -> weight-normed stride-1 conv, with the
    snake and the conv fused into one op."""

    def __init__(self, in_c: int, out_c: int, kernel_size: int = 3,
                 dilation: int = 1, num_groups: int = 8, use_norm: bool = True,
                 mode: str = "centered"):
        super().__init__()
        self.gn = StreamGroupNorm(in_c, num_groups) if use_norm else None
        self.act = SnakeBeta(in_c)
        self.conv = StreamConv1d(in_c, out_c, kernel_size, dilation=dilation,
                                 mode=mode, kernel_layout=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.gn(x) if self.gn is not None else x
        # the kernel reads (B, T, C) rows; GroupNorm keeps a transposed
        # input's strides, so make the layout explicit.  The weight comes in
        # the kernel's own layout (kernel_layout), so no call copies it.
        return fused_snake_conv(h.contiguous(), self.act.alpha, self.act.beta,
                                self.conv.effective_weight(), self.conv.bias,
                                self.conv.dilation, self.conv.mode)


class ResnetBlock1d(nn.Module):
    """conv(k, d) -> conv(1); residual through a 1x1 conv if channels change."""

    def __init__(self, in_c: int, out_c: int, kernel_size: int = 3,
                 dilation: int = 1, num_groups: int = 8, use_norm: bool = True,
                 use_res: bool = True, mode: str = "centered"):
        super().__init__()
        self.block1 = ConvBlock1d(in_c, out_c, kernel_size, dilation,
                                  num_groups, use_norm, mode)
        self.block2 = ConvBlock1d(out_c, out_c, 1, 1, num_groups, use_norm,
                                  mode)
        self.use_res = use_res
        self.to_out = (StreamConv1d(in_c, out_c, 1, mode="valid")
                       if use_res and in_c != out_c else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block2(self.block1(x))
        if not self.use_res:
            return h
        res = self.to_out(x) if self.to_out is not None else x
        return h + res


class DownsampleBlock1d(nn.Module):
    """N resnet blocks -> snake -> strided downsample conv."""

    def __init__(self, in_c: int, out_c: int, factor: int, num_layers: int,
                 dilations: Sequence[int], kernel_size: int, num_groups: int,
                 use_norm: bool, mode: str):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"res_{i}", ResnetBlock1d(
                in_c, in_c, kernel_size, dilations[i], num_groups, use_norm,
                True, mode))
        self.num_layers = num_layers
        self.act = SnakeBeta(in_c)
        self.down = StreamConv1d(in_c, out_c, 2 * factor, stride=factor,
                                 mode=mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"res_{i}")(x)
        return self.down(self.act(x))


class UpsampleBlock1d(nn.Module):
    """snake -> transposed-conv upsample -> N resnet blocks."""

    def __init__(self, in_c: int, out_c: int, factor: int, num_layers: int,
                 dilations: Sequence[int], kernel_size: int, num_groups: int,
                 use_norm: bool, mode: str):
        super().__init__()
        self.act = SnakeBeta(in_c)
        self.up = StreamConvTranspose1d(in_c, out_c, 2 * factor, factor)
        for i in range(num_layers):
            self.add_module(f"res_{i}", ResnetBlock1d(
                out_c, out_c, kernel_size, dilations[i], num_groups, use_norm,
                True, mode))
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.up(self.act(x))
        for i in range(self.num_layers):
            h = getattr(self, f"res_{i}")(h)
        return h


def _mode(cfg: AutoEncoderConfig) -> str:
    return "causal" if cfg.causal else "centered"


class CodecEncoder(nn.Module):
    """Band signals (B, Tb, M) -> latents (B, Tb / prod(factors), z)."""

    def __init__(self, cfg: AutoEncoderConfig):
        super().__init__()
        mode = _mode(cfg)
        ch = cfg.base_channels
        in_c = cfg.pqmf_bands if cfg.pqmf_bands > 1 else 1
        out_channels = cfg.z_channels * (2 if cfg.bottleneck == "vae" else 1)
        widths = [ch * m for m in cfg.multipliers]
        self.to_in = ResnetBlock1d(in_c, widths[0], cfg.kernel_size, 1,
                                   cfg.resnet_groups, cfg.use_norm, True, mode)
        for i, f in enumerate(cfg.factors):
            self.add_module(f"down_{i}", DownsampleBlock1d(
                widths[i], widths[i + 1], f, cfg.num_blocks_per_stage,
                cfg.dilations, cfg.kernel_size, cfg.resnet_groups,
                cfg.use_norm, mode))
        self.n_down = len(cfg.factors)
        self.act = SnakeBeta(widths[-1])
        self.to_out = StreamConv1d(widths[-1], out_channels, 3, mode=mode)

    def forward(self, xb: torch.Tensor) -> torch.Tensor:
        h = self.to_in(xb)
        for i in range(self.n_down):
            h = getattr(self, f"down_{i}")(h)
        return self.to_out(self.act(h))


class CodecDecoder(nn.Module):
    """Latents (B, Tl, z) -> band signals (B, Tl * prod(factors), M)."""

    def __init__(self, cfg: AutoEncoderConfig):
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
                                  mode=mode)
        for i, f in enumerate(factors):
            self.add_module(f"up_{i}", UpsampleBlock1d(
                widths[i], widths[i + 1], f, cfg.num_blocks_per_stage,
                cfg.dilations, cfg.kernel_size, cfg.resnet_groups,
                cfg.use_norm, mode))
        self.n_up = len(factors)
        self.use_loudness = cfg.use_loudness
        self.to_out = ResnetBlock1d(
            widths[-1], out_c * 2 if cfg.use_loudness else out_c,
            cfg.kernel_size, 1, cfg.resnet_groups, cfg.use_norm, False, mode)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.to_in(z)
        for i in range(self.n_up):
            h = getattr(self, f"up_{i}")(h)
        h = self.to_out(h)
        if self.use_loudness:
            y, amp = h.chunk(2, dim=-1)
            h = y * torch.sigmoid(amp)
        return h


class AudioCodec(nn.Module):
    """encode: (B, T, 1) waveform -> (B, T / ratio, z); decode: latents ->
    waveform (T + M samples in centered mode, as in the JAX package)."""

    def __init__(self, cfg: AutoEncoderConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.pqmf_bands > 1:
            self.pqmf = PQMFAnalysis(cfg.pqmf_attenuation, cfg.pqmf_bands,
                                     cfg.causal)
            self.pqmf_inv = PQMFSynthesis(cfg.pqmf_attenuation,
                                          cfg.pqmf_bands, cfg.causal)
        else:
            self.pqmf = self.pqmf_inv = None
        self.encoder = CodecEncoder(cfg)
        self.decoder = CodecDecoder(cfg)

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

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        xb = self.pqmf(x) if self.pqmf is not None else x
        return self.bottleneck(self.encoder(xb))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        yb = self.decoder(z)
        return self.pqmf_inv(yb) if self.pqmf_inv is not None else yb
