"""The 1-D conv UNet denoiser, an offline-only alternative backbone
(counterpart of after_tpu/models/unet1d.py).

Layout (B, T, C).  Every conv pads as flax's ``padding="SAME"``: a strided
conv pads ``(ceil(T / s) - 1) * s + k - T`` frames, the smaller half on the
left (1 left and 2 right at k = 5, stride 2, over an even length), which
torch's symmetric ``padding`` cannot say.  A ``ConvBlock1D`` normalises
with GroupNorm only where its input width splits into groups (its group
counts follow the widths), at flax's default epsilon of 1e-6.  The upsampling
repeats each frame (``jnp.repeat``), and the pyramid of the structure codes
lags the pooling by one level so that it matches each block's length.
Each layer computes at the promotion of its input's type and its
parameters', as flax does: under bf16 weights the f32 time embedding
makes each block's FiLM, and all after it, f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv1d
from ..ops.norms import GroupNorm
from ..utils.precision import at, linear, promote

GN_EPS = 1e-6

_SPE: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def _spe_freqs(dim: int, max_positions: float,
               device: torch.device) -> torch.Tensor:
    """(dim // 2,) frequencies (1 / max_positions)^(2 i / dim), made once
    per device (a CUDA graph cannot copy them from the host)."""
    key = (dim, max_positions, device)
    if key not in _SPE:
        with torch.inference_mode(False), torch.no_grad():
            exponent = 2 * torch.arange(dim // 2, device=device) / dim
            _SPE[key] = torch.pow(torch.tensor(
                1.0 / max_positions, dtype=torch.float32, device=device),
                exponent.to(torch.float32))
    return _SPE[key]


def spe(t: torch.Tensor, dim: int, max_positions: float = 10000.0,
        scale: float = 32.0) -> torch.Tensor:
    """Sinusoidal time embedding: (B,) -> (B, dim) [sin | cos]."""
    t = t.reshape(-1) * scale
    ang = t[:, None] * _spe_freqs(dim, max_positions, t.device)[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class SameConv1d(nn.Conv1d):
    """A conv over (B, T, C) padded as flax's ``padding="SAME"``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        T = x.shape[1]
        pad = max((-(-T // s) - 1) * s + k - T, 0)
        dtype = promote(x, self.weight)
        h = F.pad(x.to(dtype).transpose(1, 2), (pad // 2, pad - pad // 2))
        return conv1d(h, at(self.weight, dtype), at(self.bias, dtype),
                      stride=s).transpose(1, 2)


def _group_norm(width: int) -> Optional[GroupNorm]:
    groups = min(16, width // 4)
    if groups > 0 and width % groups == 0:
        return GroupNorm(width, groups, eps=GN_EPS)
    return None


class ConvBlock1D(nn.Module):
    """GN -> SiLU -> conv -> FiLM(time) -> FiLM(cond) -> GN -> SiLU -> conv,
    with a residual.  ``in_c`` is the width of its input after the skip and
    the structure codes are concatenated to it, ``res_c`` the width of the
    input alone (the residual; a 1x1 conv ``to_out`` maps it where a skip
    comes in)."""

    def __init__(self, in_c: int, res_c: int, out_c: int, kernel_size: int,
                 time_channels: int, cond_in: int = 0, res: bool = True,
                 skip: bool = False):
        super().__init__()
        self.gn1 = _group_norm(in_c)
        self.conv1 = SameConv1d(in_c, out_c, kernel_size)
        self.time_mlp1 = nn.Linear(time_channels, 128)
        self.time_mlp2 = nn.Linear(128, 2 * out_c)
        self.use_cond = cond_in > 0
        if self.use_cond:
            self.cond_mlp1 = nn.Linear(cond_in, 128)
            self.cond_mlp2 = nn.Linear(128, 2 * out_c)
        self.gn2 = _group_norm(out_c)
        self.conv2 = SameConv1d(out_c, out_c, kernel_size)
        self.to_out = SameConv1d(res_c, out_c, 1) if res and skip else None
        self.add_res = res and (skip or res_c == out_c)

    def forward(self, x: torch.Tensor, time_emb: torch.Tensor,
                skip: Optional[torch.Tensor] = None,
                cond: Optional[torch.Tensor] = None,
                time_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        res = x
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        if time_cond is not None:
            x = torch.cat([x, time_cond], dim=-1)
        if self.gn1 is not None:
            x = self.gn1(x)
        x = self.conv1(F.silu(x))
        mult, add = linear(self.time_mlp2, F.silu(linear(
            self.time_mlp1, time_emb))).chunk(2, dim=-1)
        x = x * mult[:, None] + add[:, None]
        if self.use_cond and cond is not None:
            mult, add = linear(self.cond_mlp2, F.silu(linear(
                self.cond_mlp1, cond))).chunk(2, dim=-1)
            x = x * mult[:, None] + add[:, None]
        if self.gn2 is not None:
            x = self.gn2(x)
        x = self.conv2(F.silu(x))
        if self.add_res:
            if self.to_out is not None:
                res = self.to_out(res)
            x = x + res
        return x


@dataclasses.dataclass(frozen=True)
class UNet1DConfig:
    in_size: int = 64
    out_size: Optional[int] = None
    channels: Tuple[int, ...] = (128, 128, 256, 256)
    ratios: Tuple[int, ...] = (2, 2, 2, 2)
    kernel_size: int = 5
    time_channels: int = 64
    time_cond_in_channels: int = 12
    time_cond_channels: int = 64
    cond_channels: int = 6


class UNet1D(nn.Module):
    """The conv UNet v(x_t, t, timbre, structure), offline only.  ``cond_in``
    and ``tcond_in`` are the widths of the timbre vector and of the
    structure codes (``cond_channels`` and ``time_cond_in_channels`` by
    default); with ``cond_channels`` 0 the blocks take no timbre, with
    ``time_cond_channels`` 0 no structure."""

    def __init__(self, cfg: UNet1DConfig, cond_in: Optional[int] = None,
                 tcond_in: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        k, n = cfg.kernel_size, len(cfg.channels)
        cond_in = cfg.cond_channels if cond_in is None else cond_in
        cond_in = cond_in if cfg.cond_channels > 0 else 0
        tcond_in = cfg.time_cond_in_channels if tcond_in is None else tcond_in
        tcc = cfg.time_cond_channels
        self.ratios = [1] + list(cfg.ratios)
        out_size = cfg.out_size or cfg.in_size
        tw = cfg.time_channels
        if tcc:
            self.tcond_in = SameConv1d(tcond_in, tcc, k)
        h = cfg.in_size
        skips = []
        for i in range(n):
            if tcc and i > 0:
                self.add_module(f"tcond_{i}", SameConv1d(
                    tcc, tcc, k, stride=self.ratios[i - 1]))
            self.add_module(f"down_conv_{i}", ConvBlock1D(
                h + tcc, h, h, k, tw, cond_in))
            skips.append(h)
            self.add_module(f"down_pool_{i}", SameConv1d(
                h, cfg.channels[i], k, stride=self.ratios[i]))
            h = cfg.channels[i]
        if tcc:
            self.tcond_mid = SameConv1d(tcc, tcc, k,
                                        stride=self.ratios[n - 1])
        self.middle = ConvBlock1D(h + tcc, h, cfg.channels[-1], k, tw,
                                  cond_in)
        h = cfg.channels[-1]
        for i in reversed(range(n)):
            out_c = cfg.channels[i - 1] if i > 0 else out_size
            self.add_module(f"up_conv_{i}", SameConv1d(h, out_c, 3))
            self.add_module(f"up_block_{i}", ConvBlock1D(
                out_c + skips[i] + tcc, out_c, out_c, k, tw, cond_in,
                res=i > 0, skip=True))
            h = out_c

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                cond: Optional[torch.Tensor] = None,
                time_cond: Optional[torch.Tensor] = None,
                cache=None, cache_index=0, train=None) -> torch.Tensor:
        """``cache``, ``cache_index`` and ``train`` are taken for the
        denoiser slot's interface: the UNet has no streaming form and no
        dropout."""
        if cache is not None:
            raise ValueError("UNet1D has no streaming form")
        cfg = self.cfg
        n = len(cfg.channels)
        time_emb = spe(time, cfg.time_channels)
        tc = None
        if cfg.time_cond_channels and time_cond is not None:
            tc = F.silu(self.tcond_in(time_cond))
        tcs, skips, h = [], [], x
        for i in range(n):
            if tc is not None and i > 0:
                tc = F.silu(getattr(self, f"tcond_{i}")(tc))
            skip = getattr(self, f"down_conv_{i}")(h, time_emb, cond=cond,
                                                   time_cond=tc)
            tcs.append(tc)
            skips.append(skip)
            h = getattr(self, f"down_pool_{i}")(skip)
        if tc is not None:
            tc = F.silu(self.tcond_mid(tc))
        h = self.middle(h, time_emb, cond=cond, time_cond=tc)
        for i in reversed(range(n)):
            r = self.ratios[i]
            if r > 1:
                h = torch.repeat_interleave(h, r, dim=1)
            h = getattr(self, f"up_conv_{i}")(h)
            h = getattr(self, f"up_block_{i}")(
                h, time_emb, skip=skips[i], cond=cond, time_cond=tcs[i])
        return h
