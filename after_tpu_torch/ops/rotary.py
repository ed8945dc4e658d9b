"""Rotary position embeddings, offline (counterpart of after_tpu/ops/rotary.py).

Only the first `rot_dim` features of each head are rotated; pairs are
interleaved (x0, x1), (x2, x3), ...  Angles are computed in float64 on the
host and stored in float32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=32)
def _freqs(rot_dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, rot_dim, 2, dtype=np.float64) / rot_dim))


def rotary_angles(positions: np.ndarray, rot_dim: int,
                  theta: float = 10000.0) -> np.ndarray:
    """(T,) positions -> (T, rot_dim) angles, each freq repeated per pair."""
    f = _freqs(rot_dim, theta)
    ang = positions[:, None] * f[None, :]
    return np.repeat(ang, 2, axis=-1).astype(np.float32)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Interleaved pair rotation: (x0, x1) -> (-x1, x0)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate (..., T, head_dim) by (T, rot_dim) angles; features beyond
    rot_dim pass through.  The f32 angles' cosines and sines are applied at
    x's dtype (a bf16 x stays bf16, as in the JAX package)."""
    rot_dim = angles.shape[-1]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if cos.dtype != x.dtype:
        cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    x_rot = x_rot * cos + _rotate_half(x_rot) * sin
    return torch.cat([x_rot, x_pass], dim=-1)
