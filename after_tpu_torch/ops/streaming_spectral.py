"""Stream-stateful spectral front ends: mel spectrogram and CQT (counterpart
of after_tpu/ops/streaming_spectral.py).

A streaming module keeps the window's overlap in an audio ring buffer
(``Streaming.slot`` of the cache it is given), so that chunked calls give
the frames of one offline transform over the concatenated audio.  The CQT
is a bank of complex log-spaced Gabor atoms applied as two real products
(real and imaginary parts); ``multirate_cqt`` applies one octave's atoms
over a 2x downsampling pyramid, the basic-pitch front end.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..streaming.state import Cache, Streaming
from . import stft as stft_ops


class StreamableMelSpectrogram(nn.Module, Streaming):
    """(B, chunk, 1) audio -> (B, frames, n_mels) power mel frames (HTK
    scale, no centring)."""

    def __init__(self, sr: int = 44100, n_fft: int = 2048, hop: int = 512,
                 n_mels: int = 80, streaming: bool = False):
        super().__init__()
        self.sr, self.n_fft, self.hop, self.n_mels = sr, n_fft, hop, n_mels
        self.streaming = streaming

    def forward(self, x: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        if self.streaming:
            x = _ring(self, x, self.n_fft - self.hop, cache)
        spec = stft_ops.spectrogram(x[..., 0], self.n_fft, self.hop,
                                    power=2.0, center=False)
        fb = stft_ops.on_device(x.device, stft_ops.mel_filterbank, self.sr,
                                self.n_fft, self.n_mels)
        return spec @ fb.T


def _ring(module: Streaming, x: torch.Tensor, context: int,
          cache: Optional[Cache]) -> torch.Tensor:
    """``x`` after the last ``context`` samples of the stream so far, which
    then become the last ``context`` samples of the result."""
    ring = module.slot(cache, "audio_ring", lambda: x.new_zeros(
        (x.shape[0], context, 1)))
    h = torch.cat([ring, x], dim=1)
    ring.copy_(h[:, h.shape[1] - context:])
    return h


@lru_cache(maxsize=8)
def cqt_kernels(sr: int, fmin: float, n_bins: int, bins_per_octave: int
                ) -> Tuple[np.ndarray, int]:
    """Complex Gabor atom bank (n_bins, kernel_len) and the kernel length
    (a power of two)."""
    Q = 1.0 / (2 ** (1.0 / bins_per_octave) - 1)
    freqs = fmin * 2 ** (np.arange(n_bins) / bins_per_octave)
    lengths = np.ceil(Q * sr / freqs).astype(int)
    max_len = int(2 ** np.ceil(np.log2(lengths.max())))
    kernels = np.zeros((n_bins, max_len), dtype=np.complex64)
    for i, (f, L) in enumerate(zip(freqs, lengths)):
        n = np.arange(L) - L // 2
        atom = np.hanning(L) * np.exp(2j * np.pi * f * n / sr) / L
        start = (max_len - L) // 2
        kernels[i, start:start + L] = atom
    return kernels, max_len


def _kernel_part(kernels_fn, imag: bool, *args) -> np.ndarray:
    k = kernels_fn(*args)[0]
    return np.ascontiguousarray(np.imag(k) if imag else np.real(k))


def _magnitudes(frames: torch.Tensor, *args) -> torch.Tensor:
    """|frames @ atoms^T| for the complex atoms ``cqt_kernels(*args)``, as
    two real products."""
    kr = stft_ops.on_device(frames.device, _kernel_part, cqt_kernels, False,
                            *args)
    ki = stft_ops.on_device(frames.device, _kernel_part, cqt_kernels, True,
                            *args)
    re = frames @ kr.T
    im = frames @ ki.T
    return torch.sqrt(re * re + im * im + 1e-12)


class StreamableCQT(nn.Module, Streaming):
    """(B, chunk, 1) audio -> (B, frames, n_bins) CQT magnitudes."""

    def __init__(self, sr: int = 44100, fmin: float = 32.70,
                 n_bins: int = 84, bins_per_octave: int = 12, hop: int = 512,
                 streaming: bool = False):
        super().__init__()
        self.sr, self.fmin, self.n_bins = sr, fmin, n_bins
        self.bins_per_octave, self.hop = bins_per_octave, hop
        self.streaming = streaming

    def forward(self, x: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        args = (self.sr, self.fmin, self.n_bins, self.bins_per_octave)
        klen = cqt_kernels(*args)[1]
        if self.streaming:
            x = _ring(self, x, klen - self.hop, cache)
        frames = stft_ops.frame_signal(x[..., 0], klen, self.hop)
        return _magnitudes(frames, *args)


# ---------------------------------------------------------------------------
# Multi-rate CQT (CQT2010-style: top-octave kernels over a downsampling
# pyramid), for a low fmin without huge kernels
# ---------------------------------------------------------------------------


@lru_cache(maxsize=4)
def _halfband_filter(taps: int = 64) -> np.ndarray:
    import scipy.signal
    return scipy.signal.firwin(2 * taps + 1, 0.5).astype(np.float32)


def multirate_cqt(x: torch.Tensor, sr: int, fmin: float, n_bins: int,
                  bins_per_octave: int, hop: int) -> torch.Tensor:
    """(B, T) audio -> (B, T // hop, n_bins) CQT magnitudes.

    Short kernels for the top octave, applied to a 2x anti-aliased
    downsampling pyramid for each lower octave; the hop halves a level, so
    every octave shares the frame grid."""
    B, T = x.shape
    n_frames = T // hop
    n_octaves = int(np.ceil(n_bins / bins_per_octave))
    f_top_low = fmin * 2 ** (n_octaves - 1)    # low edge of the top octave
    top_bins = n_bins - (n_octaves - 1) * bins_per_octave
    hb = stft_ops.on_device(x.device, _halfband_filter).reshape(1, 1, -1)

    outs = []
    cur = x
    for g in range(n_octaves):
        # the top octave's atoms (the JAX package's _octave_kernels, which
        # are cqt_kernels' atoms), designed at the full rate, analyse
        # [f_top_low / 2^g, ...) on the 2^g-downsampled signal; the partial
        # top octave keeps its highest top_bins bins
        args = (sr, f_top_low, top_bins if g == 0 else bins_per_octave,
                bins_per_octave)
        klen = cqt_kernels(*args)[1]
        hop_g = hop // (2 ** g)
        if hop_g < 1:
            break
        # frame i centred at i * hop_g, so that the octaves line up
        sig = F.pad(cur, (klen // 2, klen))
        frames = stft_ops.frame_signal(sig, klen, hop_g)[:, :n_frames]
        if frames.shape[1] < n_frames:
            frames = F.pad(frames, (0, 0, 0, n_frames - frames.shape[1]))
        outs.append(_magnitudes(frames, *args))
        # 2x downsample for the next (lower) octave: a cross-correlation
        # with the half-band taps, as lax.conv computes it
        pad = hb.shape[-1] // 2
        cur = F.conv1d(cur[:, None], hb, stride=2, padding=pad)[:, 0]
    # outs[0] is the top octave: stack the bins from low to high
    return torch.cat(list(reversed(outs)), dim=-1)[..., :n_bins]
