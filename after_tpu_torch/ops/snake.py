"""Snake-beta activation over (B, T, C) (counterpart of after_tpu/ops/snake.py).

snake_beta(x) = x + sin(alpha * x)^2 / (beta + 1e-9), per channel.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.precision import at, promote


def snake_beta(x: torch.Tensor, alpha: torch.Tensor,
               beta: torch.Tensor) -> torch.Tensor:
    return x + (1.0 / (beta + 1e-9)) * torch.square(torch.sin(x * alpha))


class SnakeBeta(nn.Module):
    """Per-channel trainable snake-beta; alpha and beta start at 1.

    The fused snake+conv op (ops/kernels/fused_conv.py) reads ``alpha`` and
    ``beta`` directly and recomputes the activation inside the conv."""

    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # at the promotion of x's type and the parameters' (jnp's)
        dtype = promote(x, self.alpha, self.beta)
        return snake_beta(x.to(dtype), at(self.alpha, dtype),
                          at(self.beta, dtype))
