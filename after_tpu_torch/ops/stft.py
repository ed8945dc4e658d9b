"""Spectral ops: STFT, mel filterbanks, A-weighting (counterpart of
after_tpu/ops/stft.py).

The JAX package computes small DFTs as windowed-DFT matmuls at full f32
precision; the port takes the real FFT of the windowed frames
(``torch.fft.rfft``, cuFFT on the card), the same transform in f32.  Windows,
filterbanks and FIR taps are designed on the host with numpy and scipy, as
in the JAX package, and cached per device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F


@lru_cache(maxsize=64)
def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann, matching torch.hann_window."""
    n = np.arange(win_length)
    return (0.5 * (1 - np.cos(2 * np.pi * n / win_length))).astype(np.float32)


@lru_cache(maxsize=256)
def _constant(array_key, device: torch.device) -> torch.Tensor:
    fn, args = array_key
    return torch.from_numpy(np.ascontiguousarray(fn(*args))).to(device)


def on_device(device: torch.device, fn, *args) -> torch.Tensor:
    """``fn(*args)`` (a host-designed numpy constant) as a tensor on device,
    made once per device."""
    return _constant((fn, args), torch.device(device))


def _padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Hann window of win_length zero-padded to n_fft in the middle."""
    window = hann_window(win_length)
    lpad = (n_fft - win_length) // 2
    return np.pad(window, (lpad, n_fft - win_length - lpad))


def frame_signal(x: torch.Tensor, frame_length: int, hop: int
                 ) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_length), n_frames = 1 + (T -
    frame_length) // hop: a strided view of x."""
    return x.unfold(-1, frame_length, hop)


def stft(x: torch.Tensor, n_fft: int, hop: int,
         win_length: Optional[int] = None, center: bool = True
         ) -> torch.Tensor:
    """Complex STFT of (..., T) -> (..., n_frames, n_fft//2+1), Hann window.

    Matches torch.stft conventions (center=True reflect padding; window
    zero-padded to n_fft when win_length < n_fft)."""
    win_length = win_length or n_fft
    if center:
        pad = n_fft // 2
        shape = x.shape
        x = F.pad(x.reshape(-1, 1, shape[-1]), (pad, pad), mode="reflect")
        x = x.reshape(shape[:-1] + (x.shape[-1],))
    window = on_device(x.device, _padded_window, win_length, n_fft)
    return torch.fft.rfft(frame_signal(x, n_fft, hop) * window, dim=-1)


def spectrogram(x: torch.Tensor, n_fft: int, hop: int,
                win_length: Optional[int] = None,
                power: Optional[float] = 1.0, normalized: bool = False,
                center: bool = True) -> torch.Tensor:
    """Magnitude (power=1) / power (power=2) / complex (power=None)
    spectrogram.

    ``normalized=True`` divides by the window's L2 norm (torchaudio
    convention, used by the Encodec discriminator)."""
    win_length = win_length or n_fft
    z = stft(x, n_fft, hop, win_length, center=center)
    if normalized:
        z = z / float(np.linalg.norm(hann_window(win_length)))
    if power is None:
        return z
    mag2 = z.real ** 2 + z.imag ** 2
    if power == 2.0:
        return mag2
    return torch.sqrt(mag2) if power == 1.0 else mag2 ** (power / 2.0)


# ---------------------------------------------------------------------------
# Mel filterbanks (HTK / torchaudio and Slaney / librosa conventions)
# ---------------------------------------------------------------------------


def _hz_to_mel(f, htk: bool):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, logarithmic above
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep, f / f_sp)


def _mel_to_hz(m, htk: bool):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


@lru_cache(maxsize=64)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, htk: bool = True,
                   slaney_norm: bool = False) -> np.ndarray:
    """(n_mels, n_fft//2+1) triangular filterbank from ``fmin`` to ``fmax``
    (sr / 2 by default) on the HTK mel scale, or Slaney's with ``htk=False``;
    ``slaney_norm`` scales each filter to unit area."""
    fmax = fmax or sr / 2
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin, htk),
                                    _hz_to_mel(fmax, htk), n_mels + 2), htk)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lower, center, upper = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lower) / max(center - lower, 1e-10)
        down = (upper - fft_freqs) / max(upper - center, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    if slaney_norm:
        fb *= (2.0 / (hz_pts[2:] - hz_pts[:-2]))[:, None]
    return fb.astype(np.float32)


def mel_spectrogram(x: torch.Tensor, sr: int, n_fft: int, hop: int,
                    n_mels: int, power: float = 1.0, normalized: bool = True,
                    center: bool = False) -> torch.Tensor:
    """torchaudio-convention mel spectrogram of (..., T)."""
    spec = spectrogram(x, n_fft, hop, power=power, normalized=normalized,
                       center=center)
    fb = on_device(x.device, mel_filterbank, sr, n_fft, n_mels)
    return spec @ fb.to(spec.dtype).T


# ---------------------------------------------------------------------------
# A-weighting FIR (perceptual prefilter for the MR-STFT loss)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def a_weighting_fir(fs: int = 44100, ntaps: int = 101) -> np.ndarray:
    """Least-squares FIR fit of the IEC-1672 analog A-weighting curve:
    analog prototype -> bilinear transform -> frequency response -> firls
    fit, as the reference FIRFilter('aw') (core.py:390-423)."""
    f1, f2, f3, f4 = 20.598997, 107.65265, 737.86223, 12194.217
    A1000 = 1.9997
    NUMs = [(2 * np.pi * f4) ** 2 * (10 ** (A1000 / 20)), 0, 0, 0, 0]
    DENs = np.polymul([1, 4 * np.pi * f4, (2 * np.pi * f4) ** 2],
                      [1, 4 * np.pi * f1, (2 * np.pi * f1) ** 2])
    DENs = np.polymul(np.polymul(DENs, [1, 2 * np.pi * f3]),
                      [1, 2 * np.pi * f2])
    b, a = scipy.signal.bilinear(NUMs, DENs, fs=fs)
    w_iir, h_iir = scipy.signal.freqz(b, a, worN=512, fs=fs)
    taps = scipy.signal.firls(ntaps, w_iir, abs(h_iir), fs=fs)
    return taps.astype(np.float32)


def fir_prefilter(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Apply an odd-length FIR to (..., T) with same-length output (zero
    padding, correlation order as lax.conv)."""
    shape = x.shape
    pad = taps.shape[-1] // 2
    y = F.conv1d(x.reshape(-1, 1, shape[-1]),
                 taps.to(x.dtype).reshape(1, 1, -1), padding=pad)
    return y.reshape(shape)
