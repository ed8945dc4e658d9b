"""Crossfade streaming of a non-causal codec (counterpart of
after_tpu/streaming/crossfade.py).

The base codec has centered convs and GroupNorm, so it cannot stream
exactly through cached convs.  Each buffer is encoded together with the
previous ``n_fade * ratio`` samples of audio, and decoded with the previous
``n_fade`` latent frames, its head cross-faded into the previous buffer's
overlap tail; GroupNorm streams its statistics over a pad of its previous
input (``AudioCodec(streaming="norm")``).  Every conv runs offline over the
window of ``n_fade + chunk_size`` latent frames, so every ConvBlock1d
launches the fused snake+conv kernel on the card.  The decoded output lags
its input by ``n_fade`` latent frames.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..config import AutoEncoderConfig
from ..models.autoencoder import AudioCodec
from .state import Cache, CrossfadeState, init_cache


class CrossfadeDecoder:
    """Buffer-by-buffer encode and decode of a centered (non-causal) codec.

    ``codec`` is its own module, with the GroupNorms in streaming form; load
    or share its weights before streaming."""

    def __init__(self, cfg: AutoEncoderConfig, n_fade: int = 4,
                 chunk_size: int = 8):
        if cfg.causal:
            raise ValueError("a causal codec streams through cached convs")
        self.cfg = cfg
        self.n_fade = n_fade
        self.chunk_size = chunk_size
        self.codec = AudioCodec(cfg, streaming="norm" if cfg.use_norm
                                else False)
        self._alpha = {}

    def _window(self, batch_size: int, channels: int, scale: int = 1
                ) -> torch.Tensor:
        """Zeros of a window on the codec's device, at its dtype (bf16
        under a compute dtype, so that the buffers of a state are too)."""
        p = next(self.codec.parameters())
        return torch.zeros((batch_size, (self.n_fade + self.chunk_size)
                            * scale, channels), device=p.device,
                           dtype=p.dtype)

    def init_state(self, batch_size: int = 1) -> CrossfadeState:
        """Zeroed buffers, and the GroupNorm pads as one pass over a zero
        window leaves them (each layer's response to silence), the
        reference's initial buffer state."""
        r = self.cfg.ratio
        z0 = self._window(batch_size, self.cfg.z_channels)
        return CrossfadeState(
            z_buffer=z0.new_zeros((batch_size, self.n_fade,
                                   self.cfg.z_channels)),
            out_buffer=z0.new_zeros((batch_size, self.n_fade * r, 1)),
            cache=init_cache(lambda c: self.codec.decode(z0, c), zero=False))

    def init_encode_state(self, batch_size: int = 1
                          ) -> Tuple[torch.Tensor, Cache]:
        """(the last n_fade * ratio input samples, GroupNorm pads)."""
        r = self.cfg.ratio
        x0 = self._window(batch_size, 1, r)
        ctx = x0.new_zeros((batch_size, self.n_fade * r, 1))
        return ctx, init_cache(lambda c: self.codec.encode(x0, c), zero=False)

    def decode(self, state: CrossfadeState, z: torch.Tensor) -> torch.Tensor:
        """(B, chunk, z) latents -> (B, chunk * ratio, 1) audio; the state is
        updated in place."""
        r = self.cfg.ratio
        n = self.n_fade * r
        z_full = torch.cat([state.z_buffer, z], dim=1)
        x = self.codec.decode(z_full, state.cache)
        # centered PQMF synthesis returns M extra samples: cut (or pad) the
        # window to its nominal length
        want = z_full.shape[1] * r
        x = F.pad(x, (0, 0, 0, max(want - x.shape[1], 0)))[:, :want]
        alpha = self._alpha.get(x.device)
        if alpha is None:
            alpha = self._alpha[x.device] = torch.linspace(
                0.0, 1.0, n, device=x.device)[None, :, None]
        head = (1 - alpha) * state.out_buffer + alpha * x[:, :n]
        x = torch.cat([head, x[:, n:]], dim=1)
        state.z_buffer.copy_(z_full[:, z_full.shape[1] - self.n_fade:])
        state.out_buffer.copy_(x[:, x.shape[1] - n:])
        return x[:, :x.shape[1] - n]

    def encode(self, state: Tuple[torch.Tensor, Cache], x: torch.Tensor
               ) -> torch.Tensor:
        """(B, chunk * ratio, 1) audio -> (B, chunk, z) latents, encoded
        together with the previous n_fade * ratio samples; the state is
        updated in place."""
        ctx, cache = state
        full = torch.cat([ctx, x], dim=1)
        z = self.codec.encode(full, cache)
        ctx.copy_(full[:, full.shape[1] - ctx.shape[1]:])
        t = x.shape[1] // self.cfg.ratio
        return z[:, z.shape[1] - t:]
