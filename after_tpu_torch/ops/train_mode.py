"""The training form of a forward pass: batch statistics and dropout.

A module's forward takes ``train``: ``None`` for inference (BatchNorm on its
running statistics, dropout the identity), or a :class:`TrainMode`.  In
training, BatchNorm normalises with the batch's statistics and records them
in ``train.batch_stats`` without touching its running values; the caller
decides whether they count (``commit``), as the JAX trainer keeps or throws
away each pass's ``batch_stats`` updates.  Dropout draws its masks from
``train.generator``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


class TrainMode:
    """One training pass's BatchNorm statistics, pending, and the generator
    of its random draws (``None``: torch's default generator)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.generator = generator
        # BatchNorm module -> (batch mean, batch variance), detached
        self.batch_stats: Dict[torch.nn.Module,
                               Tuple[torch.Tensor, torch.Tensor]] = {}

    def commit(self, ok: Optional[torch.Tensor] = None) -> None:
        """Fold the recorded batch statistics into the running ones; with
        ``ok`` (a 0-dim device bool) only where it is true, selected on the
        device as the JAX trainers select them (``jnp.where(grads_ok, new,
        old)``), so that no value is read back to the host."""
        for bn, (mean, var) in self.batch_stats.items():
            bn.update_running(mean, var, ok)


def dropout(x: torch.Tensor, rate: float,
            train: Optional[TrainMode]) -> torch.Tensor:
    """flax ``nn.Dropout``: in training each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate); the identity at
    inference or at rate 0."""
    if train is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=train.generator,
                      device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
