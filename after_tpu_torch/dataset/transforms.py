"""Waveform augmentations of the codec's training collate (the port's copy
of ``random_phase_mangle`` and ``random_gain`` of
after_tpu/dataset/transforms.py, numpy and scipy only)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.signal


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
