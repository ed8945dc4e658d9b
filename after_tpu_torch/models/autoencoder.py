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
regularising bottleneck, whose noise is an argument, and so is the
decoder's ``NoiseGenerator`` draw (``use_noise``).  Where no decoder noise
is given (inference: transfer, decode, streaming, export) the generator
takes one fixed draw per shape, as the JAX package takes ``PRNGKey(0)``.

``GRU`` is the JAX package's optional recurrent layer over latent frames,
which no config reaches.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import AutoEncoderConfig
from ..ops.conv import StreamConv1d, StreamConvTranspose1d
from ..ops.kernels.fused_conv import snake_conv
from ..ops.norms import GroupNorm
from ..ops.pqmf import PQMFAnalysis, PQMFSynthesis
from ..ops.snake import SnakeBeta
from ..ops.stft import on_device
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


class GRUCell(nn.Module):
    """Flax's ``nn.GRUCell``: the input Linears ``ir``, ``iz``, ``in`` carry
    biases, of the recurrent ones only ``hn`` (torch's ``nn.GRU`` would add
    recurrent biases to the reset and update gates that the JAX cell lacks).
    ``forward(h, x)`` -> the new h."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        for gate in ("r", "z", "n"):
            self.add_module(f"i{gate}", nn.Linear(in_features, features))
        self.hr = nn.Linear(features, features, bias=False)
        self.hz = nn.Linear(features, features, bias=False)
        self.hn = nn.Linear(features, features)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class GRU(nn.Module):
    """Optional recurrent layer (SimpleNetsStream.py:788-816): a stack of
    GRU cells over the frames of (B, T, in_features), then a weight-normed
    centered conv to ``out_size``.  ``forward(x, carry)`` -> (y, carry),
    the carry one (B, hidden_size) state a layer, zeros where not given."""

    def __init__(self, in_features: int, out_size: int,
                 hidden_size: int = 256, num_layers: int = 3):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"gru_{i}", GRUCell(
                in_features if i == 0 else hidden_size, hidden_size))
        self.to_out = StreamConv1d(hidden_size, out_size, 3, mode="centered")

    def forward(self, x: torch.Tensor,
                carry: Optional[Sequence[torch.Tensor]] = None):
        B, T, _ = x.shape
        if carry is None:
            carry = [x.new_zeros((B, self.hidden_size))
                     for _ in range(self.num_layers)]
        carry = list(carry)
        cells = [getattr(self, f"gru_{i}") for i in range(self.num_layers)]
        outs = []
        for t in range(T):
            h = x[:, t]
            for i, cell in enumerate(cells):
                h = carry[i] = cell(carry[i], h)
            outs.append(h)
        return self.to_out(torch.stack(outs, dim=1)), carry


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
    """Latents (B, Tl, z) -> band signals (B, Tl * prod(factors), M).

    With ``use_noise`` the ``NoiseGenerator``'s filtered noise, computed
    from the last stage's output, is added after the loudness gate; its
    uniform draw is the ``noise`` argument, or the generator's fixed draw
    for the shape where none is given (``NoiseGenerator.fixed_noise``)."""

    def __init__(self, cfg: AutoEncoderConfig, streaming: StreamMode = False):
        super().__init__()
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
        self.noise = (NoiseGenerator(widths[-1], out_c, mode=mode,
                                     streaming=streaming is True)
                      if cfg.use_noise else None)

    def forward(self, z: torch.Tensor, cache: Optional[Cache] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.to_in(z, cache)
        for i in range(self.n_up):
            h = getattr(self, f"up_{i}")(h, cache)
        feats = h
        h = self.to_out(h, cache)
        if self.use_loudness:
            y, amp = h.chunk(2, dim=-1)
            h = y * torch.sigmoid(amp)
        if self.noise is not None:
            h = h + self.noise(feats, noise, cache)
        elif noise is not None:
            raise ValueError("decoder noise given to a codec without "
                             "use_noise")
        return h


def decoder_band_delay(cfg: AutoEncoderConfig) -> int:
    """Streaming delay (band-rate frames) of the causal decoder against the
    centered offline one: each transposed-conv upsample adds factor // 2
    frames at its output rate; causal convs add none."""
    d = 0
    for f in cfg.factors[::-1]:
        d = d * f + f // 2
    return d


def mod_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """2 sigmoid(x)^2.3 + 1e-7 (core.py:7)."""
    return 2 * torch.pow(torch.sigmoid(x), 2.3) + 1e-7


@lru_cache(maxsize=8)
def _hanning(n: int) -> np.ndarray:
    # numpy's symmetric window, as jnp.hanning makes it (not the periodic
    # torch.hann_window)
    return np.hanning(n).astype(np.float32)


def amp_to_impulse_response(amp: torch.Tensor, target_size: int
                            ) -> torch.Tensor:
    """Frequency amplitudes -> windowed impulse response on the last axis
    (SimpleNetsStream.py:462-483): the irfft of the amplitudes (n bins give
    2 (n - 1) taps), centred, Hann-windowed, zero-padded to
    ``target_size`` and rolled back by half the filter, in f32."""
    ir = torch.fft.irfft(amp.float().to(torch.complex64), dim=-1)
    filter_size = ir.shape[-1]
    ir = torch.roll(ir, filter_size // 2, dims=-1)
    ir = ir * on_device(ir.device, _hanning, filter_size)
    ir = F.pad(ir, (0, target_size - filter_size))
    return torch.roll(ir, (-filter_size) // 2, dims=-1)


def fft_convolve(signal: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Linear convolution by FFT on the last axis (SimpleNetsStream.py:486):
    the signal padded on the right and the kernel on the left by the
    signal's length, the second half of their circular product kept."""
    n = signal.shape[-1]
    signal = F.pad(signal, (0, n))
    kernel = F.pad(kernel, (n, 0))
    out = torch.fft.irfft(torch.fft.rfft(signal) * torch.fft.rfft(kernel))
    return out[..., out.shape[-1] // 2:]


class NoiseGenerator(nn.Module):
    """Filtered-noise synthesis branch of the decoder
    (SimpleNetsStream.py:499-549): strided convs predict each block's
    noise-band amplitudes, which shape uniform noise through the impulse
    responses they make.  (B, T, in_c) -> (B, T, data_size), T a multiple
    of prod(ratios).

    The noise is uniform in [-1, 1) of shape ``noise_shape(B, T)``, (B, T /
    prod(ratios), data_size, prod(ratios)): the ``noise`` argument, else
    ``fixed_noise``: one draw per shape and device from a generator seeded
    0, made at the first call with that shape and kept, as the JAX package
    takes ``PRNGKey(0)`` wherever no noise rng is given (transfer, decode,
    the streamer, export).  That first call is a warm-up on the card, never
    a CUDA-graph capture, and an export keeps the draw as a constant.  The
    impulse responses and the convolution run in f32 whatever the convs'
    type, as the JAX module's complex64 FFTs do.  With ``streaming`` the
    strided convs are cached (one chunk's frames a multiple of
    prod(ratios))."""

    def __init__(self, in_c: int, data_size: int,
                 ratios: Sequence[int] = (2, 2, 2), noise_bands: int = 5,
                 hidden_size: int = 128, mode: str = "centered",
                 streaming: bool = False):
        super().__init__()
        self.data_size = data_size
        self.noise_bands = noise_bands
        self.target = int(np.prod(ratios))
        channels = [hidden_size] * (len(ratios) - 1) + [
            data_size * noise_bands]
        widths = [in_c] + channels
        for i, r in enumerate(ratios):
            self.add_module(f"conv_{i}", StreamConv1d(
                widths[i], widths[i + 1], 3, stride=r, mode=mode,
                streaming=streaming))
        self.n_convs = len(ratios)
        self.fixed: Dict[Tuple[Tuple[int, ...], str], torch.Tensor] = {}

    def noise_shape(self, batch: int, frames: int) -> Tuple[int, ...]:
        """The noise's shape for ``frames`` band frames."""
        return (batch, frames // self.target, self.data_size, self.target)

    def fixed_noise(self, shape: Sequence[int],
                    device: torch.device) -> torch.Tensor:
        """The kept uniform draw of ``shape`` on ``device`` (f32)."""
        key = (tuple(shape), str(device))
        t = self.fixed.get(key)
        if t is None:
            with torch.inference_mode(False), torch.no_grad():
                gen = torch.Generator(device).manual_seed(0)
                t = torch.rand(shape, generator=gen, device=device) * 2 - 1
            self.fixed[key] = t
        return t

    def keep_noise(self, noise: torch.Tensor) -> None:
        """Keep ``noise`` as the fixed draw of its shape and device (the
        parity tests keep the JAX package's ``PRNGKey(0)`` draw)."""
        self.fixed[(tuple(noise.shape), str(noise.device))] = noise

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None) -> torch.Tensor:
        h = x
        for i in range(self.n_convs):
            h = getattr(self, f"conv_{i}")(h, cache)
            if i != self.n_convs - 1:
                h = F.leaky_relu(h, 0.2)
        amp = mod_sigmoid(h - 5.0)
        B, Tq, _ = amp.shape
        amp = amp.reshape(B, Tq, self.data_size, self.noise_bands)
        ir = amp_to_impulse_response(amp, self.target)
        if noise is None:
            noise = self.fixed_noise(ir.shape, ir.device)
        elif tuple(noise.shape) != tuple(ir.shape):
            raise ValueError(f"decoder noise has shape {tuple(noise.shape)}, "
                             f"expected {tuple(ir.shape)}")
        out = fft_convolve(noise.float(), ir)       # (B, Tq, data, target)
        return out.transpose(2, 3).reshape(B, Tq * self.target,
                                           self.data_size)


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

    def decoder_noise_shape(self, batch: int, frames: int
                            ) -> Optional[Tuple[int, ...]]:
        """The shape of the decoder's noise for ``frames`` latent frames,
        or None for a codec without ``use_noise``."""
        gen = self.decoder.noise
        if gen is None:
            return None
        return gen.noise_shape(batch, frames * int(np.prod(self.cfg.factors)))

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                decoder_noise: Optional[torch.Tensor] = None):
        """Training forward of an offline codec: (B, T, 1) waveform ->
        (y, y_bands, z, reg, x_bands), the JAX ``AudioCodec.__call__``;
        ``decoder_noise`` is the NoiseGenerator's uniform draw
        (``decoder_noise_shape``), its fixed draw where not given."""
        if self.streaming:
            raise ValueError("the training forward runs on an offline codec")
        xb = self.pqmf(x) if self.pqmf is not None else x
        z, reg = self.regularise(self.encoder(xb), noise)
        yb = self.decoder(z, noise=decoder_noise)
        y = self.pqmf_inv(yb) if self.pqmf_inv is not None else yb
        return y, yb, z, reg, xb

    def encode(self, x: torch.Tensor,
               cache: Optional[Cache] = None) -> torch.Tensor:
        xb = self.pqmf(x, cache) if self.pqmf is not None else x
        return self.bottleneck(self.encoder(xb, cache))

    def decode(self, z: torch.Tensor, cache: Optional[Cache] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latents -> waveform; a ``use_noise`` decoder takes ``noise`` as
        its uniform draw, its fixed draw for the shape where not given."""
        yb = self.decoder(z, cache, noise)
        return self.pqmf_inv(yb, cache) if self.pqmf_inv is not None else yb
