"""Normalisations over the channels of (B, T, C) tensors, with the JAX
package's epsilons (flax GroupNorm at 1e-5 as the codec sets it, flax
BatchNorm's default 1e-5).  A bf16 input is normalised in f32, statistics
and all, and the result returned at the promotion of the input's type and
the parameters' (bf16 for bf16 both; f32 for an f32 input under bf16
parameters), as flax computes them; running statistics stay f32."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.precision import at, promote
from .train_mode import TrainMode


class GroupNorm(nn.Module):
    """GroupNorm over (B, T, C); statistics over (T, C / groups) per group."""

    def __init__(self, num_channels: int, num_groups: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        h = x.float().reshape(B, T, self.num_groups, C // self.num_groups)
        var, mean = torch.var_mean(h, dim=(1, 3), unbiased=False, keepdim=True)
        h = (h - mean) * torch.rsqrt(var + self.eps)
        f32 = torch.float32
        y = h.reshape(B, T, C) * at(self.weight, f32) + at(self.bias, f32)
        return y.to(promote(x, self.weight, self.bias))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9)`` over the last axis.

    Without ``train`` it normalises with the running statistics.  With a
    ``TrainMode`` it normalises with the batch's, over every axis but the
    last (the biased variance, E[x^2] - E[x]^2 clamped at 0, as flax computes
    it), and records them in ``train``; the running statistics move only
    when the caller commits them (``update_running``: 0.9 * old + 0.1 *
    batch)."""

    momentum = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        dtype = promote(x, self.weight, self.bias)
        x = x.float()
        if train is None:
            mean, var = self.running_mean.float(), self.running_var.float()
        else:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(axes)
            var = torch.clamp_min((x * x).mean(axes) - mean * mean, 0.0)
            train.batch_stats[self] = (mean.detach(), var.detach())
        f32 = torch.float32
        mul = torch.rsqrt(var + self.eps) * at(self.weight, f32)
        return ((x - mean) * mul + at(self.bias, f32)).to(dtype)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor,
                       ok: Optional[torch.Tensor] = None) -> None:
        """0.9 * old + 0.1 * batch, written in place (the buffers keep their
        addresses); with ``ok`` (a 0-dim bool tensor) the old values stay
        where it is false."""
        m = self.momentum
        for run, batch in ((self.running_mean, mean), (self.running_var, var)):
            new = m * run + (1 - m) * batch
            run.copy_(new if ok is None else torch.where(ok, new, run))
