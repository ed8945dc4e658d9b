"""Finite Scalar Quantization (counterpart of after_tpu/ops/fsq.py), with
the training-time noise dropout."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

FSQDraws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class FSQ:

    def __init__(self, levels: Sequence[int], noise_dropout: float = 0.0):
        self.levels = tuple(int(v) for v in levels)
        self.noise_dropout = noise_dropout
        self.dim = len(self.levels)
        self._levels: Dict[Tuple[torch.dtype, torch.device],
                           torch.Tensor] = {}

    def _levels_on(self, z: torch.Tensor) -> torch.Tensor:
        """The levels as a tensor of z's type on z's device, made once per
        device (no copy from the host on every call)."""
        key = (z.dtype, z.device)
        if key not in self._levels:
            with torch.inference_mode(False):
                self._levels[key] = torch.tensor(self.levels, dtype=z.dtype,
                                                 device=z.device)
        return self._levels[key]

    def _bound(self, z: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
        """Tanh-bound each channel into its quantization range."""
        levels = self._levels_on(z)
        half_l = (levels - 1) * (1 - eps) / 2
        offset = torch.where(levels % 2 == 0, 0.5, 0.0).to(z.dtype)
        shift = torch.atanh(offset / half_l)
        return torch.tanh(z + shift) * half_l - offset

    @staticmethod
    def draw(shape, generator: Optional[torch.Generator],
             device: torch.device) -> FSQDraws:
        """The noise dropout's uniform draws for codes of ``shape``: the
        per-sample masks (B, 1, ...) that substitute the raw input and the
        noisy input, and the noise (``shape``)."""
        mshape = (shape[0],) + (1,) * (len(shape) - 1)
        return tuple(torch.rand(s, generator=generator, device=device)
                     for s in (mshape, mshape, shape))

    def quantize(self, z: torch.Tensor,
                 draws: Optional[FSQDraws] = None) -> torch.Tensor:
        """(..., dim) -> (..., dim) quantized codes, normalised to [-1, 1],
        with straight-through gradients.

        With ``draws`` (``draw``) the reference's two-stage per-sample noise
        dropout follows: where the first mask's draw is below
        ``noise_dropout`` the code is the raw z, where the second's is, z +
        (noise - 0.5) / half_width."""
        bounded = self._bound(z)
        levels = self._levels_on(z)
        half_width = torch.floor(levels / 2)
        # the straight-through sum of the JAX package, kept for its rounding
        quantized = (bounded + (torch.round(bounded) - bounded).detach()
                     ) / half_width
        if draws is not None:
            u_raw, u_noisy, noise = draws
            p = self.noise_dropout
            quantized = torch.where(u_raw < p, z, quantized)
            quantized = torch.where(u_noisy < p,
                                    z + (noise - 0.5) / half_width, quantized)
        return quantized
