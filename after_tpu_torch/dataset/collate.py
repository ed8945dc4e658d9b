"""Batch collation for diffusion training (the port's copy of
after_tpu/dataset/collate.py, numpy only).

Random latent crops for the target and timbre streams, optional
pitch/stretch-augmented timbre copies, ``timbre_limit`` windowing and MIDI
piano-roll structure; the batches feed ``DiffusionTrainer.fit``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import midi as midi_io


def thread_rng_factory(seed: int = 0):
    """Per-thread RandomState streams for a collate fn shared by loaders
    whose threads run at once (RandomState is not thread-safe).  Streams are
    numbered by arrival order, not by thread ident, which the system reuses
    and which would replay streams irreproducibly."""
    local = threading.local()
    counter_lock = threading.Lock()
    counter = [0]

    def get_rng() -> np.random.RandomState:
        rng = getattr(local, "rng", None)
        if rng is None:
            with counter_lock:
                stream_id = counter[0]
                counter[0] += 1
            rng = np.random.RandomState(
                np.random.SeedSequence([seed, stream_id]).generate_state(1))
            local.rng = rng
        return rng

    return get_rng


def make_collate_fn(n_signal: int, structure_type: str = "audio",
                    ae_ratio: int = 2048, sr: int = 44100,
                    timbre_limit: Optional[float] = None,
                    timbre_augmentation_keys: Sequence[str] = (),
                    seed: int = 0):
    """collate(items) -> {"x", "x_cond", "x_time_cond"} of (B, n_signal, C)
    float32 arrays from records holding "z" (C, T) latents.  For audio the
    structure is x itself (the same array object, so it is uploaded once);
    for midi a piano roll from the record's "midi" (an object with
    ``get_piano_roll``, or its pickled bytes as the record store keeps
    them, read by ``midi.loads``)."""
    get_rng = thread_rng_factory(seed)

    def collate(batch: List[Dict]) -> Dict[str, np.ndarray]:
        rng = get_rng()
        zs = [np.asarray(b["z"], dtype=np.float32) for b in batch]
        B = len(zs)
        # per-item lengths: stores prepared with another num_signal may be
        # merged
        totals = np.array([z.shape[-1] for z in zs])
        i0 = np.array([rng.randint(0, max(t - n_signal, 1))
                       for t in totals])
        x = np.stack([z[..., i: i + n_signal] for z, i in zip(zs, i0)])

        if timbre_augmentation_keys:
            x_timbre = []
            which = rng.randint(0, len(timbre_augmentation_keys), B)
            for bi in range(B):
                key = timbre_augmentation_keys[which[bi]]
                zt = np.asarray(batch[bi].get(key, zs[bi]), dtype=np.float32)
                if zt.shape[-1] < n_signal + 1:
                    zt = zs[bi]
                i1 = rng.randint(0, max(zt.shape[-1] - n_signal, 1))
                x_timbre.append(zt[..., i1:i1 + n_signal])
            x_timbre = np.stack(x_timbre)
        else:
            if timbre_limit is None:
                i1 = np.array([rng.randint(0, max(t - n_signal, 1))
                               for t in totals])
            else:
                nmax = int(n_signal * timbre_limit)
                d = rng.randint(-nmax, nmax, B)
                i1 = np.clip(i0 + d, 0,
                             np.maximum(totals - n_signal, 0))
            x_timbre = np.stack([z[..., i: i + n_signal]
                                 for z, i in zip(zs, i1)])

        if structure_type == "midi":
            rolls = []
            for bi, b in enumerate(batch):
                # endpoint=True, the reference's grid (it stretches the
                # timestamps by total / (total - 1) against the latents)
                times = np.linspace(0, totals[bi] * ae_ratio / sr,
                                    totals[bi])
                midi = b.get("midi", b.get("midi_bytes"))
                if isinstance(midi, np.ndarray):
                    midi = midi.tobytes()
                if isinstance(midi, (bytes, bytearray)):
                    midi = midi_io.loads(midi)
                roll = midi.get_piano_roll(times=times) / 127.0
                rolls.append(roll[..., i0[bi]:i0[bi] + n_signal])
            time_cond = np.stack(rolls).astype(np.float32)
        else:
            time_cond = x

        # (B, C, T) -> (B, T, C)
        def btc(a):
            return np.ascontiguousarray(np.swapaxes(a, -1, -2))

        xb = btc(x)
        return {"x": xb, "x_cond": btc(x_timbre),
                "x_time_cond": xb if time_cond is x else btc(time_cond)}

    return collate
