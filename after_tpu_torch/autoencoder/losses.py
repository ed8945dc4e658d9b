"""Codec reconstruction losses: multi-resolution STFT with perceptual
A-weighting, spectral and waveform distances (counterpart of
after_tpu/autoencoder/losses.py)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..config import AETrainConfig
from ..ops import stft as stft_ops


def stft_magnitude(x: torch.Tensor, n_fft: int, hop: int, win: int,
                   eps: float = 1e-8, center: bool = True,
                   dft_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, T) -> (B, frames, bins) magnitudes (torch.stft conventions)."""
    z = stft_ops.stft(x, n_fft, hop, win, center=center, dft_dtype=dft_dtype)
    return torch.sqrt(torch.clamp_min(z.real ** 2 + z.imag ** 2, eps))


def stft_loss(x: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int,
              win: int, w_sc: float = 1.0, w_log_mag: float = 1.0,
              w_lin_mag: float = 0.0, center: bool = True,
              dft_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Single-scale loss: spectral convergence + log/linear magnitude L1
    (core.py:671-720).  x, y: (B, T) pre-filtered waveforms."""
    x_mag = stft_magnitude(x, n_fft, hop, win, center=center,
                           dft_dtype=dft_dtype)
    y_mag = stft_magnitude(y, n_fft, hop, win, center=center,
                           dft_dtype=dft_dtype)
    loss = 0.0
    if w_sc:
        sc = (torch.linalg.vector_norm(y_mag - x_mag, dim=(-2, -1))
              / torch.clamp_min(torch.linalg.vector_norm(y_mag, dim=(-2, -1)),
                                1e-12))
        loss = loss + w_sc * sc.mean()
    if w_log_mag:
        loss = loss + w_log_mag * torch.mean(
            torch.abs(torch.log(x_mag) - torch.log(y_mag)))
    if w_lin_mag:
        loss = loss + w_lin_mag * torch.mean(torch.abs(x_mag - y_mag))
    return loss


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor,
                               cfg: AETrainConfig,
                               sr: int = 44100) -> torch.Tensor:
    """MR-STFT loss over cfg's scales with the optional A-weighting
    prefilter (core.py:723-813; baseAE.gin:87-100).  x, y: (B, T, 1).
    ``cfg.stft_bf16_dft`` takes each scale's DFT with bf16 operands and f32
    sums (``stft_ops.stft``'s ``dft_dtype``); the rest stays f32."""
    xw, yw = x[..., 0], y[..., 0]
    if cfg.perceptual_weighting:
        taps = stft_ops.on_device(x.device, stft_ops.a_weighting_fir, sr)
        xw = stft_ops.fir_prefilter(xw, taps)
        yw = stft_ops.fir_prefilter(yw, taps)
    # one shared reflect pad, out of which each scale slices its centered
    # window (the same values as center=True per scale), as the JAX package
    # does: the backward pays one pad instead of one per scale
    T = xw.shape[-1]
    P = max(cfg.stft_fft_sizes) // 2
    xp = F.pad(xw[:, None], (P, P), mode="reflect")[:, 0]
    yp = F.pad(yw[:, None], (P, P), mode="reflect")[:, 0]
    dft_dtype = torch.bfloat16 if cfg.stft_bf16_dft else None
    total = 0.0
    for n_fft, hop, win in zip(cfg.stft_fft_sizes, cfg.stft_hop_sizes,
                               cfg.stft_win_lengths):
        off = P - n_fft // 2
        total = total + stft_loss(
            xp[..., off:off + T + n_fft], yp[..., off:off + T + n_fft],
            n_fft, hop, win, cfg.stft_w_sc, cfg.stft_w_log_mag,
            cfg.stft_w_lin_mag, center=False, dft_dtype=dft_dtype)
    return total / len(cfg.stft_fft_sizes)


def waveform_distance(x: torch.Tensor, y: torch.Tensor,
                      norm: str = "L1") -> torch.Tensor:
    """core.py:56-75 (rave mode)."""
    d = y - x
    return torch.mean(torch.abs(d)) if norm == "L1" else torch.mean(d * d)


def spectral_distance(x: torch.Tensor, y: torch.Tensor, sr: int,
                      scales: Sequence[int],
                      mel_bands: Optional[Sequence[int]]) -> torch.Tensor:
    """Multi-scale (mel-)spectrogram lin+log L1 distance (core.py:78-175).
    x, y: (B, T, 1)."""
    xw, yw = x[..., 0], y[..., 0]
    total = 0.0
    mel_bands = mel_bands or [None] * len(scales)
    for n_fft, mel in zip(scales, mel_bands):
        hop = n_fft // 4
        if mel:
            sx = stft_ops.mel_spectrogram(xw, sr, n_fft, hop, mel)
            sy = stft_ops.mel_spectrogram(yw, sr, n_fft, hop, mel)
        else:
            sx = stft_ops.spectrogram(xw, n_fft, hop, normalized=True,
                                      center=False)
            sy = stft_ops.spectrogram(yw, n_fft, hop, normalized=True,
                                      center=False)
        total = total + torch.mean(torch.abs(sx - sy))
        total = total + torch.mean(torch.abs(torch.log1p(sx)
                                             - torch.log1p(sy)))
    return total
