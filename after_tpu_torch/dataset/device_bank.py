"""Device-resident latent bank (counterpart of
after_tpu/dataset/device_bank.py): the latent records live on the card and
each training batch is drawn there, with no host traffic per step.

- The records are stacked into one (1 + n_aug, N, T_max, C) bank: slot 0
  holds "z", slots 1.. the pitch/stretch-augmented copies; ragged lengths
  are zero-padded and kept per slot and record, and an augment that is
  missing or shorter than n_signal + 1 has length 0 and falls back to z, as
  the host collate does.
- Each batch draws record indices (weighted), crop offsets and augment
  choices from a ``torch.Generator`` on the bank's device, with the
  distributions of ``make_collate_fn``'s audio path (the streams differ).

MIDI structure (piano rolls) stays on the host collate.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from ..utils.device import resolve_device


class DeviceLatentBank:
    """Latent store on the device with its batch sampler.

    dataset: indexable of items holding "z" (C, T) plus optional augment
        buffers; n_signal: crop length in latent frames; aug_keys: the
        augment buffers' names (the collate's timbre_augmentation_keys);
    weights: per-record sampling weights (uniform when None); timbre_limit:
        window factor of the timbre crop without augments; device: the card
        unless ``"cpu"``."""

    def __init__(self, dataset, n_signal: int, aug_keys: Sequence[str] = (),
                 weights: Optional[np.ndarray] = None,
                 timbre_limit: Optional[float] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.n_signal = int(n_signal)
        self.aug_keys = tuple(aug_keys)
        self.timbre_limit = timbre_limit
        self.device = resolve_device(device)
        n = len(dataset)
        if n == 0:
            raise ValueError("empty dataset")

        slots = 1 + len(self.aug_keys)
        zs, augs = [], [[] for _ in self.aug_keys]
        for i in range(n):
            item = dataset[i]
            z = np.asarray(item["z"], np.float32)
            if z.ndim != 2:
                raise ValueError(f"record {i}: the bank expects (C, T) "
                                 f"latents, got {z.shape}")
            zs.append(z)
            for k, key in enumerate(self.aug_keys):
                a = item.get(key)
                augs[k].append(None if a is None
                               else np.asarray(a, np.float32))
        c = zs[0].shape[0]
        t_max = max(z.shape[1] for z in zs)
        for rows in augs:
            t_max = max([t_max] + [a.shape[1] for a in rows if a is not None])

        bank = np.zeros((slots, n, t_max, c), np.float32)
        lens = np.zeros((slots, n), np.int64)
        for i, z in enumerate(zs):
            bank[0, i, :z.shape[1]] = z.T
            lens[0, i] = z.shape[1]
        for k, rows in enumerate(augs):
            for i, a in enumerate(rows):
                if a is None or a.shape[1] < self.n_signal + 1:
                    continue
                bank[k + 1, i, :a.shape[1]] = a.T
                lens[k + 1, i] = a.shape[1]
        w = (np.full(n, 1.0 / n) if weights is None
             else np.asarray(weights, np.float64) / np.sum(weights))

        self.nbytes = bank.nbytes
        self._bank = torch.from_numpy(bank).to(self.device)
        self._lens = torch.from_numpy(lens).to(self.device)
        self._weights = torch.from_numpy(w.astype(np.float32)).to(self.device)
        self._frames = torch.arange(self.n_signal, device=self.device)

    def _uniform_start(self, length: torch.Tensor,
                       gen: torch.Generator) -> torch.Tensor:
        """randint(0, max(length - n_signal, 1)) per row."""
        maxn = torch.clamp_min(length - self.n_signal, 1)
        u = torch.rand(length.shape, generator=gen, device=self.device)
        return torch.minimum((u * maxn).long(), maxn - 1)

    def _crop(self, slot: torch.Tensor, idx: torch.Tensor,
              start: torch.Tensor) -> torch.Tensor:
        """(B, n_signal, C) crops of records idx in bank slots slot."""
        return self._bank[slot[:, None], idx[:, None],
                          start[:, None] + self._frames]

    def sample(self, batch_size: int,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One training batch {x, x_cond, x_time_cond} of (B, n_signal, C),
        x_time_cond being x itself."""
        gen = generator
        idx = torch.multinomial(self._weights, batch_size, replacement=True,
                                generator=gen)
        z_len = self._lens[0, idx]
        zero = torch.zeros_like(idx)
        i0 = self._uniform_start(z_len, gen)
        x = self._crop(zero, idx, i0)
        if self.aug_keys:
            which = torch.randint(1, 1 + len(self.aug_keys), (batch_size,),
                                  generator=gen, device=self.device)
            a_len = self._lens[which, idx]
            valid = a_len >= self.n_signal + 1
            src = torch.where(valid, which, zero)
            i1 = self._uniform_start(torch.where(valid, a_len, z_len), gen)
            x_cond = self._crop(src, idx, i1)
        else:
            if self.timbre_limit is None:
                i1 = self._uniform_start(z_len, gen)
            else:
                nmax = int(self.n_signal * self.timbre_limit)
                d = torch.randint(-nmax, nmax, (batch_size,), generator=gen,
                                  device=self.device)
                i1 = torch.minimum(torch.clamp_min(i0 + d, 0),
                                   torch.clamp_min(z_len - self.n_signal, 0))
            x_cond = self._crop(zero, idx, i1)
        return {"x": x, "x_cond": x_cond, "x_time_cond": x}

    def batches(self, batch_size: int, seed: int = 0
                ) -> Iterator[Dict[str, torch.Tensor]]:
        """Endless batches on the device (feeds ``DiffusionTrainer.fit``,
        whose upload leaves device tensors as they are)."""
        gen = torch.Generator(self.device).manual_seed(seed)
        while True:
            yield self.sample(batch_size, gen)
