"""Static attention masks for the chunk-wise causal denoiser (a copy of
after_tpu/ops/masks.py).

- full attention *within* each `chunk_size` block of frames;
- causal attention to previous frames, limited to a sliding window of
  `window_size` frames ending at the query's position.

Masks are boolean with True = ATTEND; ``mask_bias`` turns them into the
additive bias (0 attend, -1e9 masked).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

NEG_INF = -1e9


@lru_cache(maxsize=64)
def chunkwise_causal_mask(seq_len: int, chunk_size: int) -> np.ndarray:
    """(seq_len, seq_len) bool; True where query may attend key."""
    q = np.arange(seq_len)[:, None]
    k = np.arange(seq_len)[None, :]
    return (k // chunk_size) <= (q // chunk_size)


@lru_cache(maxsize=64)
def sliding_chunkwise_mask(seq_len: int, chunk_size: int,
                           window_size: int) -> np.ndarray:
    """Chunk-wise causal mask with a sliding window on past frames: same
    chunk always; previous chunks only for keys > query - window_size."""
    if window_size is None or window_size < 0:
        return chunkwise_causal_mask(seq_len, chunk_size)
    q = np.arange(seq_len)[:, None]
    k = np.arange(seq_len)[None, :]
    same_chunk = (k // chunk_size) == (q // chunk_size)
    past = (k // chunk_size) < (q // chunk_size)
    in_window = k >= (q - window_size + 1)
    return same_chunk | (past & in_window)


def mask_bias(mask: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Boolean mask -> additive attention bias (0 attend / -1e9 masked)."""
    return np.where(mask, np.array(0.0, dtype), np.array(NEG_INF, dtype))


@lru_cache(maxsize=64)
def streaming_mask(q_len: int, k_len: int, chunk_size: int,
                   window_size: int) -> np.ndarray:
    """Mask of a streaming step: q_len new frames attending over
    (k_len - q_len) cached frames followed by themselves; the trailing q_len
    rows of the full mask over k_len positions."""
    return sliding_chunkwise_mask(k_len, chunk_size, window_size)[-q_len:]
