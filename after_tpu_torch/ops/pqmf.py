"""Pseudo-QMF multiband analysis and synthesis, offline and streaming
(counterpart of after_tpu/ops/pqmf.py).

The filter design runs once on the host with scipy: a Kaiser-window lowpass
prototype whose cutoff minimises aliasing at M bands, cosine-modulated into
an (M, L) bank and centre-padded to a power of two.  At run time both
directions are one polyphase conv of L/M taps with M channels in and out:

- analysis:  waveform (B, T, 1)  -> bands (B, T/M, M)
- synthesis: bands    (B, T/M, M) -> waveform

The sample alignment, the sign mask and the trims are those of the JAX
package, so a ported codec sees the same band signals.  The causal forms
stream: each keeps its last K - 1 polyphase frames (``carry``) and runs a
valid conv over them and the new chunk, whose band frames must be even so
that the sign mask keeps its phase.  Streamed synthesis applies the mask
with the ``parity`` of the upstream band-frame delay.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import fmin
from scipy.signal import firwin, kaiserord
from torch import nn

from ..streaming.state import Streaming
from .conv import conv1d


def _kaiser_filter(wc: float, atten: float, N: int = None) -> np.ndarray:
    """Kaiser-window lowpass prototype at angular cutoff ``wc``."""
    N_, beta = kaiserord(atten, wc / np.pi)
    N_ = 2 * (N_ // 2) + 1  # make odd
    N = N if N is not None else N_
    return firwin(N, wc, window=("kaiser", beta), scale=False, fs=2 * np.pi)


def _alias_objective(wc: float, atten: float, M: int, N: int) -> float:
    h = _kaiser_filter(wc, atten, N)
    g = np.convolve(h, h[::-1], "full")
    g = np.abs(g[g.shape[-1] // 2::2 * M][1:])
    return float(np.max(g))


@lru_cache(maxsize=16)
def design_prototype(attenuation: float, n_band: int, N: int = None) -> np.ndarray:
    """Optimise the prototype lowpass for minimal aliasing at M bands."""
    wc = fmin(lambda w: _alias_objective(float(np.asarray(w).ravel()[0]),
                                        attenuation, n_band, N),
              1.0 / n_band, disp=0)[0]
    return _kaiser_filter(float(wc), attenuation, N)


def qmf_bank(h: np.ndarray, n_band: int) -> np.ndarray:
    """Cosine-modulate the prototype into an (M, L) analysis bank."""
    k = np.arange(n_band)[:, None]
    N = h.shape[-1]
    t = np.arange(-(N // 2), N // 2 + 1)
    p = (-1.0) ** k * np.pi / 4
    mod = np.cos((2 * k + 1) * np.pi / (2 * n_band) * t + p)
    return 2 * h * mod


def _center_pad_next_pow2(hk: np.ndarray) -> np.ndarray:
    next2 = 2 ** math.ceil(math.log2(hk.shape[-1]))
    pad = next2 - hk.shape[-1]
    return np.pad(hk, [(0, 0), (pad // 2, pad // 2 + pad % 2)])


@lru_cache(maxsize=8)
def pqmf_kernels(attenuation: float, n_band: int):
    """Polyphase conv weights in torch's (O, C, K) layout.

    Returns (analysis (M_band, M_phase, K), synthesis (M_phase, M_band, K),
    sign mask (2, M) indexed by time parity and band)."""
    assert n_band > 1 and math.log2(n_band).is_integer(), \
        "n_band must be a power of 2"
    h = design_prototype(attenuation, n_band)
    hk = _center_pad_next_pow2(qmf_bank(h, n_band)).astype(np.float32)
    M, L = hk.shape
    ana = hk.reshape(M, L // M, M)             # (band, tap, phase)
    ana = np.transpose(ana, (0, 2, 1))         # (out=band, in=phase, tap)
    hki = hk[:, ::-1].reshape(M, L // M, M)    # (band, tap, phase)
    syn = np.transpose(hki, (2, 0, 1))         # (out=phase, in=band, tap)
    # reverse_half sign mask: bands odd at even time steps -> -1
    mask = np.ones((2, M), dtype=np.float32)
    mask[0, 1::2] = -1.0
    return (np.ascontiguousarray(ana), np.ascontiguousarray(syn), mask)


def _apply_mask(x: torch.Tensor, mask: torch.Tensor,
                parity: int = 0) -> torch.Tensor:
    """reverse_half sign mask over (B, T, M); ``parity`` shifts its period-2
    time pattern."""
    T = x.shape[1]
    m = mask.repeat((T + 3) // 2, 1)[parity:parity + T]
    return x * m[None]


def _streaming_pad(module: Streaming, cache, x: torch.Tensor) -> torch.Tensor:
    """(B, M, T) polyphase frames behind the module's K - 1 cached ones; the
    cache keeps the last K - 1 of them."""
    K = module.kernel.shape[-1]
    B, M, T = x.shape
    if T % 2:
        raise ValueError(f"streaming PQMF needs even chunk frames, got {T}")
    carry = module.slot(cache, "carry", lambda: x.new_zeros((B, K - 1, M)))
    full = torch.cat([carry, x.transpose(1, 2)], dim=1)
    carry.copy_(full[:, full.shape[1] - (K - 1):])
    return full.transpose(1, 2)


class PQMFAnalysis(nn.Module, Streaming):
    """Waveform (B, T, 1) -> bands (B, T/M, M); centered (offline parity with
    the reference PQMF) or causal, which may stream."""

    def __init__(self, attenuation: float = 100, n_band: int = 16,
                 causal: bool = False, streaming: bool = False):
        super().__init__()
        if streaming and not causal:
            raise ValueError("streaming PQMF analysis requires causal=True")
        self.n_band = n_band
        self.causal = causal
        self.streaming = streaming
        ana, _, mask = pqmf_kernels(attenuation, n_band)
        self.register_buffer("kernel", torch.from_numpy(ana), persistent=False)
        self.register_buffer("mask", torch.from_numpy(mask), persistent=False)

    def forward(self, x: torch.Tensor, cache=None) -> torch.Tensor:
        B, T, _ = x.shape
        M = self.n_band
        # the filters at the input's type, as the JAX package makes them
        kernel, mask = self.kernel.to(x.dtype), self.mask.to(x.dtype)
        K = kernel.shape[-1]
        xp = x.reshape(B, T // M, M).transpose(1, 2)
        if self.streaming:
            y = conv1d(_streaming_pad(self, cache, xp), kernel)
        elif self.causal:
            y = conv1d(F.pad(xp, (K - 1, 0)), kernel)
        else:
            p = K // 2
            y = conv1d(F.pad(xp, (p, p)), kernel)[:, :, :-1]
        return _apply_mask(y.transpose(1, 2), mask)


class PQMFSynthesis(nn.Module, Streaming):
    """Bands (B, T/M, M) -> waveform (B, T', 1).  Centered mode keeps the
    reference's alignment (T' = T + M); causal mode returns T samples and
    may stream, with the sign mask shifted by ``parity``."""

    def __init__(self, attenuation: float = 100, n_band: int = 16,
                 causal: bool = False, streaming: bool = False,
                 parity: int = 0):
        super().__init__()
        if streaming and not causal:
            raise ValueError("streaming PQMF synthesis requires causal=True")
        self.n_band = n_band
        self.causal = causal
        self.streaming = streaming
        self.parity = parity if streaming else 0
        _, syn, mask = pqmf_kernels(attenuation, n_band)
        self.register_buffer("kernel", torch.from_numpy(syn), persistent=False)
        self.register_buffer("mask", torch.from_numpy(mask), persistent=False)

    def forward(self, xb: torch.Tensor, cache=None) -> torch.Tensor:
        B = xb.shape[0]
        M = self.n_band
        kernel, mask = self.kernel.to(xb.dtype), self.mask.to(xb.dtype)
        K = kernel.shape[-1]
        x = _apply_mask(xb, mask, self.parity).transpose(1, 2)
        if self.streaming:
            y = conv1d(_streaming_pad(self, cache, x), kernel) * M
        elif self.causal:
            y = conv1d(F.pad(x, (K - 1, 0)), kernel) * M
        else:
            pad = K // 2 + 1
            y = conv1d(F.pad(x, (pad, pad)), kernel)[:, :, :-1] * M
        # (B, phase, T) -> phases in reverse order, interleaved in time
        wav = y.flip(1).transpose(1, 2).reshape(B, -1, 1)
        return wav if self.causal else wav[:, M:]
