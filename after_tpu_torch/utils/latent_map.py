"""2-D timbre-latent map projector for XY-pad control surfaces, the model
only (counterpart of SmallAutoencoder in after_tpu/utils/latent_map.py; its
training stays with the JAX package).  Its weights load from the JAX
projector's params with ``utils.from_jax.load_module``."""

from __future__ import annotations

import torch
from torch import nn


class SmallAutoencoder(nn.Module):
    """z_timbre (B, D) <-> 2-D map."""

    def __init__(self, in_dim: int = 6, hidden: int = 64):
        super().__init__()
        self.enc1 = nn.Linear(in_dim, hidden)
        self.enc2 = nn.Linear(hidden, hidden)
        self.enc3 = nn.Linear(hidden, 2)
        self.dec1 = nn.Linear(2, hidden)
        self.dec2 = nn.Linear(hidden, hidden)
        self.dec3 = nn.Linear(hidden, in_dim)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.enc1(x))
        h = torch.relu(self.enc2(h))
        return torch.tanh(self.enc3(h))

    def decode(self, m: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.dec1(m))
        h = torch.relu(self.dec2(h))
        return self.dec3(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))
