"""Structure encoder and adversarial classifier Encoder1D, offline and
streaming (counterpart of after_tpu/models/encoder.py).

A stack of BatchNorm + SiLU + weight-normed causal convs over codec latents
(B, T, in_size) -> codes (B, T / prod(ratios), channels[-1]), then the
``ac`` reparametrisation and optional FSQ.  At inference BatchNorm runs on
its running statistics and dropout is the identity; a training forward
(``train``, ops/train_mode.py) normalises with the batch's statistics,
applies dropout before each block's second conv and FSQ's noise dropout.
With ``streaming`` set every conv but the 1x1 pools is cached (ops/conv.py)
and each call takes the cache.  The adversarial classifier is an Encoder1D
with strided pools (ratios > 1) and ``average_out``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Encoder1DConfig
from ..ops.conv import StreamConv1d
from ..ops.fsq import FSQ, FSQDraws
from ..ops.norms import BatchNorm
from ..ops.train_mode import TrainMode, dropout
from ..streaming.state import Cache, name_slots


class V2ConvBlock1D(nn.Module):
    """BN -> SiLU -> conv -> BN -> SiLU -> dropout -> conv, residual add."""

    def __init__(self, in_c: int, out_c: int, kernel_size: int, mode: str,
                 streaming: bool = False, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.bn1 = BatchNorm(in_c)
        self.conv1 = StreamConv1d(in_c, out_c, kernel_size, mode=mode,
                                  streaming=streaming)
        self.bn2 = BatchNorm(out_c)
        self.conv2 = StreamConv1d(out_c, out_c, kernel_size, mode=mode,
                                  streaming=streaming)

    def forward(self, x: torch.Tensor, cache: Optional[Cache] = None,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.bn1(x, train)), cache)
        h = dropout(F.silu(self.bn2(h, train)), self.dropout, train)
        return self.conv2(h, cache) + x


class V2EncoderBlock1D(nn.Module):
    """Conv block + pool conv: 1x1 ``valid`` at ratio 1, strided otherwise."""

    def __init__(self, in_c: int, out_c: int, kernel_size: int, ratio: int,
                 mode: str, streaming: bool = False, dropout: float = 0.0):
        super().__init__()
        self.conv = V2ConvBlock1D(in_c, in_c, kernel_size, mode, streaming,
                                  dropout)
        if ratio != 1:
            self.pool = StreamConv1d(in_c, out_c, 2 * ratio, stride=ratio,
                                     mode=mode, streaming=streaming)
        else:
            self.pool = StreamConv1d(in_c, out_c, 1, mode="valid")

    def forward(self, x: torch.Tensor, cache: Optional[Cache] = None,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        return self.pool(self.conv(x, cache, train), cache)


class Encoder1D(nn.Module):
    """(B, T, in_size) -> (z, mean, reg) with z (B, T', channels[-1])."""

    def __init__(self, cfg: Encoder1DConfig, streaming: bool = False):
        super().__init__()
        if cfg.upscale_out or cfg.vae_regularisation:
            raise NotImplementedError(
                "the port's Encoder1D has no upscale_out or vae "
                "regularisation yet")
        self.cfg = cfg
        mode = "causal" if cfg.causal else "centered"
        channels = list(cfg.channels)
        ratios = [1] + list(cfg.ratios)
        widths = [cfg.in_size] + channels
        for i in range(len(channels)):
            r = ratios[i] if i < len(ratios) else 1
            self.add_module(f"block_{i}", V2EncoderBlock1D(
                widths[i], channels[i], cfg.kernel_size, r, mode, streaming,
                cfg.dropout))
        self.n_blocks = len(channels)
        self.out_block = V2ConvBlock1D(channels[-1], channels[-1],
                                       cfg.kernel_size, mode, streaming,
                                       cfg.dropout)
        if cfg.quantizer_levels:
            assert len(cfg.quantizer_levels) == channels[-1], \
                (cfg.quantizer_levels, channels[-1])
            self.fsq = FSQ(cfg.quantizer_levels, cfg.quantizer_noise_dropout)
        else:
            self.fsq = None
        name_slots(self)

    def forward(self, x: torch.Tensor, cache: Optional[Cache] = None,
                train: Optional[TrainMode] = None,
                fsq_draws: Optional[FSQDraws] = None):
        """In training (``train``) with an FSQ noise dropout, the dropout's
        draws are ``fsq_draws`` when given, else drawn from
        ``train.generator`` (``FSQ.draw``)."""
        cfg = self.cfg
        h = x
        for i in range(self.n_blocks):
            h = getattr(self, f"block_{i}")(h, cache, train)
        h = self.out_block(h, cache, train)
        if cfg.average_out:
            h = h.mean(dim=1)
        if cfg.spherical_normalization:
            h = h / (torch.linalg.vector_norm(h, dim=-1, keepdim=True) + 1e-5)
        elif cfg.use_tanh:
            h = torch.tanh(h)
        if cfg.ac_regularisation:
            reg = torch.relu(h.abs() - 1).mean()
        else:
            reg = h.new_zeros(())
        if self.fsq is None:
            return h, h, reg
        if train is None or cfg.quantizer_noise_dropout <= 0:
            fsq_draws = None
        elif fsq_draws is None:
            fsq_draws = FSQ.draw(h.shape, train.generator, h.device)
        return self.fsq.quantize(h, fsq_draws), h, reg
