"""Host-side audio IO (the port's copy of after_tpu/dataset/audio.py): wav
read and write, polyphase resampling, peak normalisation.  WAV only (PCM
8/16/32 and float), through scipy.
"""

from __future__ import annotations

import fractions
from typing import Optional, Tuple

import numpy as np
import scipy.io.wavfile
import scipy.signal


def load_wav(path: str, sr: Optional[int] = None,
             mono: bool = True) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (float32 array in [-1, 1] of shape (T,) or
    (T, C), sr)."""
    file_sr, data = scipy.io.wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if mono and data.ndim > 1:
        data = data.mean(axis=1)
    if sr is not None and sr != file_sr:
        data = resample(data, file_sr, sr)
        file_sr = sr
    return data, file_sr


def save_wav(path: str, data: np.ndarray, sr: int) -> None:
    data = np.clip(np.asarray(data, dtype=np.float32), -1.0, 1.0)
    scipy.io.wavfile.write(path, sr, (data * 32767).astype(np.int16))


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return x
    frac = fractions.Fraction(target_sr, orig_sr).limit_denominator(1000)
    return scipy.signal.resample_poly(x, frac.numerator, frac.denominator,
                                      axis=0).astype(np.float32)


def normalize_signal(x: np.ndarray, max_gain_db: float = 30.0) -> np.ndarray:
    """Peak-normalise with the gain capped at ``max_gain_db``."""
    peak = np.max(np.abs(x)) + 1e-9
    gain = min(1.0 / peak, 10 ** (max_gain_db / 20.0))
    return (x * gain).astype(np.float32)
