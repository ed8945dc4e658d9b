"""Host-side audio transforms: the port's copy of after_tpu/dataset/transforms.py
(numpy and scipy only, so each function gives the JAX package's bits).

Pitch shift and time stretch (a phase vocoder and a polyphase resample),
the codec collate's waveform augmentations, random silences, spectral
descriptors at the latent frame rate, and an onset-autocorrelation beat
tracker with its "beat clock" sawtooth.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.signal

from .audio import resample


# ---------------------------------------------------------------------------
# time-stretch / pitch-shift (PSTS)
# ---------------------------------------------------------------------------


def phase_vocoder_stretch(x: np.ndarray, rate: float, n_fft: int = 2048,
                          hop: int = 512) -> np.ndarray:
    """Classic phase-vocoder time stretch: rate > 1 speeds up."""
    if abs(rate - 1.0) < 1e-6:
        return x.copy()
    window = np.hanning(n_fft)
    pad = n_fft
    xp = np.pad(x, (pad, pad))
    n_frames = 1 + (len(xp) - n_fft) // hop
    frames = np.lib.stride_tricks.sliding_window_view(xp, n_fft)[::hop]
    frames = frames[:n_frames]
    stft = np.fft.rfft(frames * window, axis=-1)

    t_out = np.arange(0, n_frames - 1, rate)
    phase_adv = np.linspace(0, np.pi * hop, stft.shape[1])
    mags = np.abs(stft)
    phases = np.angle(stft)

    out = np.zeros((len(t_out), stft.shape[1]), dtype=np.complex128)
    phase_acc = phases[0].copy()
    for i, t in enumerate(t_out):
        i0 = int(np.floor(t))
        frac = t - i0
        mag = (1 - frac) * mags[i0] + frac * mags[min(i0 + 1, n_frames - 1)]
        out[i] = mag * np.exp(1j * phase_acc)
        dphase = phases[min(i0 + 1, n_frames - 1)] - phases[i0] - phase_adv
        dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
        phase_acc += phase_adv + dphase

    # overlap-add inverse
    y = np.zeros(len(t_out) * hop + n_fft)
    wsum = np.zeros_like(y)
    inv = np.fft.irfft(out, n=n_fft, axis=-1) * window
    for i in range(len(t_out)):
        y[i * hop:i * hop + n_fft] += inv[i]
        wsum[i * hop:i * hop + n_fft] += window ** 2
    y = y / np.maximum(wsum, 1e-8)
    return y[pad:pad + int(len(x) / rate)].astype(np.float32)


def pitch_shift_time_stretch(x: np.ndarray, sr: int, semitones: float,
                             stretch: float = 1.0) -> np.ndarray:
    """Shift pitch by ``semitones`` and stretch the duration by
    ``stretch``."""
    factor = 2.0 ** (semitones / 12.0)
    # stretch so that after resampling, duration scales by `stretch`
    y = phase_vocoder_stretch(x, rate=1.0 / (stretch * factor))
    y = resample(y, int(round(sr * factor)), sr)
    return y.astype(np.float32)


# ---------------------------------------------------------------------------
# randomised waveform augmentations (the codec collate)
# ---------------------------------------------------------------------------


def random_phase_mangle(x: np.ndarray, min_f: float = 20.0,
                        max_f: float = 2000.0, amp: float = 0.99,
                        sr: int = 44100,
                        rng: Optional[np.random.RandomState] = None
                        ) -> np.ndarray:
    """A second-order allpass whose pole pair sits at radius ``amp`` and a
    break frequency drawn log-uniformly in [min_f, max_f]."""
    rng = rng or np.random.RandomState()
    f = np.exp(rng.uniform(np.log(min_f), np.log(max_f)))
    w0 = 2 * np.pi * f / sr
    z0 = amp * np.exp(1j * w0)
    b = [np.abs(z0) ** 2, -2 * np.real(z0), 1]
    a = b[::-1]
    return scipy.signal.lfilter(b, a, x).astype(np.float32)


def random_gain(x: np.ndarray, low_db: float = -12.0, high_db: float = 0.0,
                rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """``x`` scaled by a gain drawn uniformly in [low_db, high_db] dB."""
    rng = rng or np.random.RandomState()
    g = 10 ** (rng.uniform(low_db, high_db) / 20)
    return (x * g).astype(np.float32)


def random_silence(x: np.ndarray, p: float = 0.1, max_frac: float = 0.5,
                   rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """With probability ``p``, zero a random contiguous span of at most
    ``max_frac`` of the signal."""
    rng = rng or np.random.RandomState()
    if rng.rand() > p:
        return x
    n = len(x)
    span = int(rng.uniform(0, max_frac) * n)
    start = rng.randint(0, max(n - span, 1))
    y = x.copy()
    y[start:start + span] = 0
    return y


# ---------------------------------------------------------------------------
# audio descriptors
# ---------------------------------------------------------------------------


def audio_descriptors(x: np.ndarray, sr: int, n_latent: int,
                      n_fft: int = 2048, hop: int = 512) -> dict:
    """Spectral centroid/bandwidth/rolloff/flatness + RMS, linearly
    interpolated to the latent frame rate."""
    f, t, S = scipy.signal.stft(x, fs=sr, nperseg=n_fft, noverlap=n_fft - hop,
                                padded=True)
    mag = np.abs(S) + 1e-10
    power = mag ** 2
    total = power.sum(axis=0)
    centroid = (f[:, None] * power).sum(axis=0) / total
    bandwidth = np.sqrt(((f[:, None] - centroid[None]) ** 2 * power
                         ).sum(axis=0) / total)
    cum = np.cumsum(power, axis=0)
    rolloff_idx = np.argmax(cum >= 0.85 * total[None], axis=0)
    rolloff = f[rolloff_idx]
    flatness = np.exp(np.mean(np.log(mag), axis=0)) / np.mean(mag, axis=0)
    rms = np.sqrt(np.mean(power, axis=0))

    def to_latent(v):
        src = np.linspace(0, 1, len(v))
        dst = np.linspace(0, 1, n_latent)
        return np.interp(dst, src, v).astype(np.float32)

    return {"centroid": to_latent(centroid),
            "bandwidth": to_latent(bandwidth),
            "rolloff": to_latent(rolloff),
            "flatness": to_latent(flatness),
            "rms": to_latent(rms)}


# ---------------------------------------------------------------------------
# beat clock
# ---------------------------------------------------------------------------


def estimate_beats(x: np.ndarray, sr: int,
                   hop: int = 512) -> Tuple[float, np.ndarray]:
    """Energy-flux onset autocorrelation tempo + beat grid estimate.

    The estimator used without a Beat This checkpoint: returns (bpm,
    beat_times)."""
    f, t, S = scipy.signal.stft(x, fs=sr, nperseg=2048,
                                noverlap=2048 - hop)
    env = np.abs(S).sum(axis=0)
    flux = np.maximum(np.diff(env, prepend=env[0]), 0)
    flux = flux - flux.mean()
    if np.allclose(flux, 0):
        return 120.0, np.array([])
    ac = np.correlate(flux, flux, "full")[len(flux) - 1:]
    fps = sr / hop
    lags = np.arange(len(ac)) / fps
    valid = (lags > 60 / 200) & (lags < 60 / 50)   # 50..200 bpm
    if not valid.any():
        return 120.0, np.array([])
    period = lags[valid][np.argmax(ac[valid])]
    # tempo-octave disambiguation: if half the period is nearly as strong,
    # prefer it (autocorrelation always peaks at integer multiples)
    fps_lag = ac[np.argmin(np.abs(lags - period))]
    half_idx = np.argmin(np.abs(lags - period / 2))
    if (period / 2) >= 60 / 220 and ac[half_idx] >= 0.5 * fps_lag:
        period = period / 2
    bpm = 60.0 / period
    # phase: maximise onset energy at beat positions
    phases = np.arange(0, period, 1 / fps)
    scores = [flux[(np.arange(p * fps, len(flux), period * fps)).astype(int)
                   ].sum() for p in phases]
    phase = phases[int(np.argmax(scores))]
    beats = np.arange(phase, len(x) / sr, period)
    return bpm, beats


def estimate_downbeats(x: np.ndarray, sr: int, beats: np.ndarray,
                       beats_per_bar: int = 4,
                       hop: int = 512) -> np.ndarray:
    """Pick the bar phase (assumed 4/4) whose downbeat positions carry the
    most onset energy; returns downbeat times (every `beats_per_bar`-th
    beat).  The estimator used without a Beat This checkpoint."""
    if len(beats) < beats_per_bar + 1:
        return beats[:1]
    f, t, S = scipy.signal.stft(x, fs=sr, nperseg=2048, noverlap=2048 - hop)
    env = np.abs(S).sum(axis=0)
    flux = np.maximum(np.diff(env, prepend=env[0]), 0)
    fps = sr / hop
    idx = np.clip((beats * fps).astype(int), 0, len(flux) - 1)
    strengths = flux[idx]
    scores = [strengths[off::beats_per_bar].mean()
              for off in range(beats_per_bar)]
    off = int(np.argmax(scores))
    return beats[off::beats_per_bar]


def get_beat_signal(beats: np.ndarray, duration: float,
                    n_frames: int) -> np.ndarray:
    """Beat times -> per-frame phase ramp in [0, 1) (the "beat clock"
    sawtooth)."""
    t = np.linspace(0, duration, n_frames, endpoint=False)
    sig = np.zeros(n_frames, dtype=np.float32)
    if len(beats) < 2:
        return sig
    for i in range(len(beats) - 1):
        mask = (t >= beats[i]) & (t < beats[i + 1])
        sig[mask] = (t[mask] - beats[i]) / (beats[i + 1] - beats[i])
    return sig
