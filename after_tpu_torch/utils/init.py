"""Port-native random weights with the JAX package's init distributions.

- StreamConv1d / StreamConvTranspose1d: kernel and bias uniform in
  +-1/sqrt(fan_in) with fan_in = k * C_in, weight-norm ``g`` = the kernel's
  norm (so the effective weight starts equal to the kernel);
- Dense (nn.Linear) and flax nn.Conv (ECAPA's nn.Conv1d, the
  discriminators' weight-normed WNConv1d and WNConv2d): lecun-normal kernel
  (truncated normal, std sqrt(1/fan_in) / .8796, fan_in of one group),
  zero bias, weight-norm scale 1;
- snake alpha and beta 1, norm scales 1 and biases 0, BatchNorm running
  mean 0 and var 1, learnable positions N(0, 1).

Weights are drawn on the CPU from one ``torch.Generator``, so a seed gives
the same weights whatever device the model then moves to.  The modules are
visited in registration order, so a module registered last (the diffusion
model's adversarial classifier, whose strided pools are StreamConv1d too)
leaves the draws of those before it unchanged.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..models.descript_discriminator import WNConv1d
from ..models.discriminator import WNConv2d
from ..ops.conv import StreamConv1d, StreamConvTranspose1d
from ..ops.norms import BatchNorm, GroupNorm
from ..ops.snake import SnakeBeta

# std of a unit normal truncated to [-2, 2] (flax's lecun_normal divisor)
_TRUNC_STD = 0.87962566103423978


def _uniform(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)


def _lecun_normal(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    v = torch.randn(t.shape, generator=gen)
    # resample the tails until every value lies within two units
    bad = v.abs() > 2
    while bad.any():
        v[bad] = torch.randn(int(bad.sum()), generator=gen)
        bad = v.abs() > 2
    t.copy_(v * std)


@torch.no_grad()
def init_weights(module: nn.Module, seed: int) -> None:
    """Initialise every parameter and statistic of ``module`` in place."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (StreamConv1d, StreamConvTranspose1d)):
            fan_in = m.kernel_size * m.in_features
            bound = 1.0 / math.sqrt(fan_in)
            w = torch.empty(m.weight.shape)
            _uniform(w, bound, gen)
            m.weight.copy_(w)
            m.g.copy_(torch.linalg.vector_norm(w.flatten(1), dim=1))
            b = torch.empty(m.bias.shape)
            _uniform(b, bound, gen)
            m.bias.copy_(b)
        elif isinstance(m, (nn.Linear, nn.Conv1d, WNConv1d, WNConv2d)):
            w = torch.empty(m.weight.shape)
            _lecun_normal(w, m.weight[0].numel(), gen)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
            if isinstance(m, (WNConv1d, WNConv2d)):
                m.scale.fill_(1.0)
        elif isinstance(m, SnakeBeta):
            m.alpha.fill_(1.0)
            m.beta.fill_(1.0)
        elif isinstance(m, (GroupNorm, nn.LayerNorm, BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        if hasattr(m, "pos_embed"):
            m.pos_embed.copy_(torch.randn(m.pos_embed.shape, generator=gen))
