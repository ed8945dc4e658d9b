"""Offline 1-D convolutions over (B, T, C) with weight norm
(counterpart of after_tpu/ops/conv.py, offline half).

Padding rule, as in the JAX package:
    total = (kernel - 1) * dilation + 1 - stride
    causal   -> (total, 0)
    centered -> (ceil, floor)
    valid    -> (0, 0)

Weights are kept in torch's layouts: (O, C, k) for a conv and
(C_in, C_out, k) for a transposed conv.  Every conv has a bias and weight
norm, which keeps the direction ``weight`` and the magnitude ``g`` as
separate parameters, as torch.nn.utils.weight_norm(dim=0) does.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def get_padding(kernel_size: int, stride: int = 1, dilation: int = 1,
                mode: str = "centered") -> Tuple[int, int]:
    """Left/right padding that keeps out_len = in_len // stride."""
    total = max((kernel_size - 1) * dilation + 1 - stride, 0)
    if mode == "causal":
        return (total, 0)
    if mode == "centered":
        left = (total + 1) // 2
        return (left, total - left)
    raise ValueError(f"unknown padding mode {mode!r}")


def weight_norm(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """w * g / ||w|| per slice of the first axis (output channels of a conv,
    input channels of a transposed conv), the norm clamped at 1e-12."""
    norm = torch.linalg.vector_norm(w.flatten(1), dim=1)
    return w * (g / norm.clamp_min(1e-12))[:, None, None]


class _WeightNormed(nn.Module):
    """``effective_weight`` of a module with ``weight`` and ``g``.

    With gradients off (inference) the result is a constant, so it is kept
    until either parameter is moved or written in place (``init_weights``,
    ``load_jax`` and ``load_state_dict`` all write in place, which bumps the
    tensor's version).  A module with ``kernel_layout`` set keeps it as the
    fused snake+conv kernel reads it: storage in (k, O, C) order behind an
    (O, C, k) view, with its low tf32 half beside it as ``kernel_lo``
    (ops/kernels/fused_conv.py: ``kernel_weight``)."""

    _wn = None
    _wn_key = None
    kernel_layout = False

    def effective_weight(self) -> torch.Tensor:
        w, g = self.weight, self.g
        if torch.is_grad_enabled() or w.is_inference() or g.is_inference():
            return weight_norm(w, g)
        key = (w.data_ptr(), w._version, g.data_ptr(), g._version)
        if key != self._wn_key:
            wn = weight_norm(w, g)
            if self.kernel_layout:
                # imported here: ops/kernels/fused_conv.py imports this module
                from .kernels.fused_conv import weight_low
                wk = wn.permute(2, 0, 1).contiguous()
                wn = wk.permute(1, 2, 0)
                wn.kernel_lo = weight_low(wk)
            self._wn = wn
            self._wn_key = key
        return self._wn


class StreamConv1d(_WeightNormed):
    """Weight-normed 1-D conv over (B, T, C), offline.

    Weight norm is per output channel: the norm runs over (C_in, k).
    ``kernel_layout`` keeps the inference weight in the fused snake+conv
    kernel's layout (see ``_WeightNormed``)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, mode: str = "causal",
                 kernel_layout: bool = False):
        super().__init__()
        self.kernel_layout = kernel_layout
        self.in_features = in_features
        self.features = features
        self.kernel_size = kernel_size
        self.stride = stride
        self.dilation = dilation
        self.mode = mode
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel_size))
        self.g = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)
        if self.mode != "valid":
            h = F.pad(h, get_padding(self.kernel_size, self.stride,
                                     self.dilation, self.mode))
        y = F.conv1d(h, self.effective_weight(), self.bias,
                     stride=self.stride, dilation=self.dilation)
        return y.transpose(1, 2)


class StreamConvTranspose1d(_WeightNormed):
    """Weight-normed transposed 1-D conv (upsampler) over (B, T, C), offline.

    Matches the JAX package's centered form: out_len = in_len * stride, the
    un-trimmed output cut by stride // 2 frames on the left.  Weight norm is
    per input channel (torch weight_norm(dim=0) on the (C_in, C_out, k)
    weight)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int):
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.kernel_size = kernel_size
        self.stride = stride
        self.weight = nn.Parameter(
            torch.empty(in_features, features, kernel_size))
        self.g = nn.Parameter(torch.empty(in_features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[1]
        f = self.stride
        y = F.conv_transpose1d(x.transpose(1, 2), self.effective_weight(),
                               self.bias, stride=f, padding=f // 2)
        return y[:, :, :T * f].transpose(1, 2)
