"""Structure encoder and adversarial classifier Encoder1D, offline and
streaming (counterpart of after_tpu/models/encoder.py).

A stack of BatchNorm + SiLU + weight-normed causal convs over codec latents
(B, T, in_size) -> codes (B, T / prod(ratios), channels[-1]), then the
``ac`` or ``vae`` reparametrisation, optional FSQ and the optional
``upscale_out`` chain.  At inference BatchNorm runs on
its running statistics and dropout is the identity; a training forward
(``train``, ops/train_mode.py) normalises with the batch's statistics,
applies dropout before each block's second conv and FSQ's noise dropout.
With ``streaming`` set every conv but the 1x1 pools is cached (ops/conv.py)
and each call takes the cache.  The adversarial classifier is an Encoder1D
with strided pools (ratios > 1) and ``average_out``.  ``LinearEncoder`` is
the JAX package's MLP encoder, which no config reaches.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import Encoder1DConfig
from ..ops.conv import StreamConv1d, StreamConvTranspose1d
from ..ops.fsq import FSQ, FSQDraws
from ..ops.norms import BatchNorm
from ..ops.train_mode import TrainMode, dropout
from ..streaming.state import Cache, name_slots
from ..utils.precision import linear


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


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``; below f32 as XLA expands it, max(x, 0) +
    log1p(exp(-|x|)) with each step rounded (``F.softplus`` rounds once)."""
    if x.dtype == torch.float32:
        return F.softplus(x)
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def reparametrise(h: torch.Tensor, noise: Optional[torch.Tensor],
                  name: str) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The encoders' VAE reparametrisation of h = [mean, scale] on its last
    axis: (z, mean, kl) with std = softplus(scale) + 1e-4, z = mean + std *
    noise and kl the mean over rows of sum(mean^2 + var - log var - 1), at
    h's type (z at the promotion of h's and the noise's, as in JAX).
    ``noise`` is a standard normal draw of the mean's shape.  Without it
    the call raises, as the JAX package's does (flax's ``InvalidRngError``:
    its encoders draw the sample noise from a "sample" rng that no
    inference call gives), so a VAE encoder runs in training only."""
    mean, scale = h.chunk(2, dim=-1)
    if noise is None:
        raise ValueError(
            f"{name} has vae regularisation: it samples its codes, and no "
            "sample noise was given (a standard normal draw of the mean's "
            "shape).  The JAX package refuses this call too (flax "
            "InvalidRngError: needs PRNG for \"sample\"): a VAE encoder "
            "runs in training only, not in transfer, streaming, export or "
            "serving")
    if tuple(noise.shape) != tuple(mean.shape):
        raise ValueError(f"{name}'s sample noise has shape "
                         f"{tuple(noise.shape)}, expected {tuple(mean.shape)}")
    std = _softplus(scale) + 1e-4
    var = std * std
    z = mean + std * noise
    kl = torch.mean(torch.sum(mean * mean + var - torch.log(var) - 1,
                              dim=-1))
    return z, mean, kl


class Encoder1D(nn.Module):
    """(B, T, in_size) -> (z, mean, reg) with z (B, T', channels[-1]).

    ``vae_regularisation`` doubles the last width into [mean, scale] and
    samples the codes (``reparametrise``: the ``noise`` argument of
    ``forward``, of shape ``vae_noise_shape``); ``upscale_out`` quadruples
    the last width, then after the reparametrisation and FSQ runs
    prod([1] + ratios) // 2 pairs of a transposed conv (k 4, stride 2) and
    a conv, and a conv down to a quarter of the width, as the JAX package
    orders them."""

    def __init__(self, cfg: Encoder1DConfig, streaming: bool = False):
        super().__init__()
        self.cfg = cfg
        mode = "causal" if cfg.causal else "centered"
        channels = list(cfg.channels)
        if cfg.upscale_out:
            channels[-1] = channels[-1] * 4
        if cfg.vae_regularisation:
            channels[-1] = channels[-1] * 2
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
        # the codes' width after the reparametrisation
        c = channels[-1] // (2 if cfg.vae_regularisation else 1)
        if cfg.quantizer_levels:
            assert len(cfg.quantizer_levels) == c, (cfg.quantizer_levels, c)
            self.fsq = FSQ(cfg.quantizer_levels, cfg.quantizer_noise_dropout)
        else:
            self.fsq = None
        self.n_upscale = int(np.prod(ratios)) // 2 if cfg.upscale_out else 0
        for i in range(self.n_upscale):
            self.add_module(f"upscale_up_{i}", StreamConvTranspose1d(
                c, c, 4, 2, streaming=streaming))
            self.add_module(f"upscale_conv_{i}", StreamConv1d(
                c, c, cfg.kernel_size, mode=mode, streaming=streaming))
        self.upscale_out = (StreamConv1d(c, c // 4, cfg.kernel_size,
                                         mode=mode, streaming=streaming)
                            if cfg.upscale_out else None)
        self._code_width = c
        name_slots(self)

    def vae_noise_shape(self, batch: int, frames: int) -> Tuple[int, ...]:
        """The sample noise's shape for ``frames`` input frames."""
        cfg = self.cfg
        if cfg.average_out:
            return (batch, self._code_width)
        return (batch, frames // int(np.prod(cfg.ratios)), self._code_width)

    def forward(self, x: torch.Tensor, cache: Optional[Cache] = None,
                train: Optional[TrainMode] = None,
                fsq_draws: Optional[FSQDraws] = None,
                noise: Optional[torch.Tensor] = None):
        """In training (``train``) with an FSQ noise dropout, the dropout's
        draws are ``fsq_draws`` when given, else drawn from
        ``train.generator`` (``FSQ.draw``).  ``noise`` is the VAE's sample
        noise (``vae_regularisation``; required there)."""
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
        if cfg.vae_regularisation:
            z, mean, reg = reparametrise(h, noise, "the structure encoder")
        else:
            z = mean = h
            # no regulariser: an f32 zero, as jnp.asarray(0.0) is
            reg = (torch.relu(h.abs() - 1).mean() if cfg.ac_regularisation
                   else torch.zeros((), device=h.device))
        if self.fsq is not None:
            if train is None or cfg.quantizer_noise_dropout <= 0:
                fsq_draws = None
            elif fsq_draws is None:
                fsq_draws = FSQ.draw(z.shape, train.generator, z.device)
            z = self.fsq.quantize(z, fsq_draws)
        for i in range(self.n_upscale):
            z = getattr(self, f"upscale_up_{i}")(z, cache)
            z = getattr(self, f"upscale_conv_{i}")(z, cache)
        if self.upscale_out is not None:
            z = self.upscale_out(z, cache)
        return z, mean, reg


class LinearEncoder(nn.Module):
    """MLP encoder over pooled features (encoder.py:339-435): Linears
    (flax's ``Dense_i``) with SiLU and dropout between, an optional tanh,
    and the ``vae`` (``reparametrise``, its noise an argument) or ``ac``
    regularisation.  (..., in_size) -> (z, mean, reg)."""

    def __init__(self, in_size: int = 512,
                 channels: Sequence[int] = (512, 1024, 1024, 256, 8),
                 drop_out: float = 0.15, use_tanh: bool = False,
                 regularisation: str = "none"):
        super().__init__()
        channels = list(channels)
        if regularisation == "vae":
            channels[-1] = channels[-1] * 2
        widths = [in_size] + channels
        for i in range(len(channels)):
            self.add_module(f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))
        self.n_layers = len(channels)
        self.drop_out = drop_out
        self.use_tanh = use_tanh
        self.regularisation = regularisation

    def forward(self, x: torch.Tensor, train: Optional[TrainMode] = None,
                noise: Optional[torch.Tensor] = None):
        h = linear(self.Dense_0, x)
        for i in range(1, self.n_layers):
            h = dropout(F.silu(h), self.drop_out, train)
            h = linear(getattr(self, f"Dense_{i}"), h)
        if self.use_tanh:
            h = torch.tanh(h)
        if self.regularisation == "vae":
            return reparametrise(h, noise, "the linear encoder")
        if self.regularisation == "ac":
            return h, h, torch.mean(1 + torch.relu(h.abs() - 1))
        return h, h, torch.zeros((), device=h.device)
