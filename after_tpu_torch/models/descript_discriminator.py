"""Descript-audio-codec-style discriminator (counterpart of
after_tpu/models/descript_discriminator.py): multi-period (MPD),
multi-scale (MSD) and multi-band multi-resolution STFT (MRD)
sub-discriminators, every conv weight-normed as flax's ``nn.WeightNorm``
norms it, LeakyReLU 0.1, hinge GAN and L1 feature-matching losses.

The JAX package runs NHWC (MPD over (B, T/p, p, 1), MRD over (B, frames,
bins, [re, im])) and NWC (MSD); the port runs ``F.conv2d`` over NCHW and
``F.conv1d`` over NCW with the same explicit symmetric padding.  Feature
maps are kept in the port's layout: the losses are means over them.

Each sub-discriminator registers its convs in the order they run, under
the JAX wrapper's names (``conv_0``, ``band0_conv_0``, ``conv_post``), so
that ``utils.from_jax.load_discriminator`` finds flax's ``Conv_j`` of the
j-th child.

Under bf16 training parameters (``utils.precision.cast_call``) each conv
computes at the promotion of its input's type and its weight's, as flax
promotes them: the real waveform in bf16 meets bf16 weights in MPD and
MSD, the spectrogram's f32 channels (MRD) and the codec's f32 output widen
them.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import stft as stft_ops
from ..ops.conv import conv1d
from ..ops.pqmf import _kaiser_filter
from ..utils.precision import at, promote
from .discriminator import WNConv2d

BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))
# MSD's (features, kernel, stride, groups) before conv_post
MSD_SPECS = ((16, 15, 1, 1), (64, 41, 4, 4), (256, 41, 4, 16),
             (1024, 41, 4, 64), (1024, 41, 4, 256), (1024, 5, 1, 1))
# MRD's ((kernel), (stride)) of each band's convs
MRD_SPECS = (((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)),
             ((3, 9), (1, 2)), ((3, 3), (1, 1)))


class WNConv1d(nn.Module):
    """Grouped 1-D conv over (B, C, T) with flax's ``nn.WeightNorm``: the
    weight is ``scale * v * rsqrt(sum(v^2 over in, k) + 1e-12)`` per output
    channel, the bias not normalised; padding (k - 1) // 2 on both sides.
    ``weight`` is (O, I / groups, k)."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, groups: int = 1):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.padding = (kernel - 1) // 2
        self.weight = nn.Parameter(
            torch.empty(features, in_features // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        self.scale = nn.Parameter(torch.ones(features))

    def effective_weight(self, dtype=None) -> torch.Tensor:
        v, scale = self.weight, self.scale
        if dtype is not None:
            v, scale = at(v, dtype), at(scale, dtype)
        inv = torch.rsqrt(v.square().sum(dim=(1, 2), keepdim=True) + 1e-12)
        return v * inv * scale[:, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = promote(x, self.weight)
        return conv1d(x.to(dtype), self.effective_weight(dtype),
                      at(self.bias, dtype), stride=self.stride,
                      padding=self.padding, groups=self.groups)


def _act(h: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(h, 0.1)


class MPD(nn.Module):
    """Multi-period discriminator: time folded into (T / p, p), reflection
    padded to a multiple of the period, then (5, 1) convs over NCHW."""

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        widths = (1, 32, 128, 256, 512)
        for i in range(4):
            self.add_module(f"conv_{i}", WNConv2d(widths[i], widths[i + 1],
                                                  (5, 1), (3, 1)))
        self.conv_4 = WNConv2d(512, 512, (5, 1))
        self.conv_post = WNConv2d(512, 1, (3, 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, T, 1) -> feature maps, the logits last."""
        B, T, C = x.shape
        rem = (-T) % self.period
        h = x.transpose(1, 2)                        # (B, 1, T)
        if rem:
            h = F.pad(h, (0, rem), mode="reflect")
        h = h.reshape(B, C, -1, self.period)         # (B, 1, T / p, p)
        fmap = []
        *body, post = self.children()
        for conv in body:
            h = _act(conv(h))
            fmap.append(h)
        fmap.append(post(h))
        return fmap


class MSD(nn.Module):
    """Multi-scale discriminator over the waveform, Kaiser-lowpassed and
    decimated by ``scale`` first where it is not 1."""

    def __init__(self, scale: int = 1):
        super().__init__()
        self.scale = scale
        if scale != 1:
            filt = _kaiser_filter(np.pi / scale, 140).astype(np.float32)
            if not len(filt) % 2:
                filt = np.pad(filt, (1, 0))
            self.register_buffer("filt", torch.from_numpy(filt)[None, None],
                                 persistent=False)
        width = 1
        for i, (feat, k, s, g) in enumerate(MSD_SPECS):
            self.add_module(f"conv_{i}", WNConv1d(width, feat, k, s,
                                                  min(g, width)))
            width = feat
        self.conv_post = WNConv1d(width, 1, 3)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = x.transpose(1, 2)                        # (B, 1, T)
        if self.scale != 1:
            filt = self.filt
            dtype = promote(h, filt)
            pad = filt.shape[-1] // 2
            h = conv1d(h.to(dtype), filt.to(dtype), stride=self.scale,
                       padding=pad)
        fmap = []
        *body, post = self.children()
        for conv in body:
            h = _act(conv(h))
            fmap.append(h)
        fmap.append(post(h))
        return fmap


class MRD(nn.Module):
    """Multi-band multi-resolution STFT discriminator: the complex STFT as
    [re, im] channels, cut into frequency bands (``int(lo * bins)``), each
    through five (3, 9) / (3, 3) convs, the bands joined along frequency
    for ``conv_post``."""

    def __init__(self, window_length: int, hop_factor: float = 0.25,
                 bands: Sequence[Tuple[float, float]] = BANDS):
        super().__init__()
        self.window_length = window_length
        self.hop = int(hop_factor * window_length)
        bins = window_length // 2 + 1
        self.bands = [(int(lo * bins), int(hi * bins)) for lo, hi in bands]
        for bi in range(len(bands)):
            width = 2
            for i, (k, s) in enumerate(MRD_SPECS):
                self.add_module(f"band{bi}_conv_{i}",
                                WNConv2d(width, 32, k, s))
                width = 32
        self.conv_post = WNConv2d(32, 1, (3, 3))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        z = stft_ops.stft(x[..., 0], self.window_length, self.hop)
        h = torch.stack([z.real, z.imag], dim=1)     # (B, 2, frames, bins)
        convs = list(self.children())
        n = len(MRD_SPECS)
        fmap, outs = [], []
        for bi, (lo, hi) in enumerate(self.bands):
            band = h[..., lo:hi]
            for conv in convs[bi * n:(bi + 1) * n]:
                band = _act(conv(band))
                fmap.append(band)
            outs.append(band)
        fmap.append(self.conv_post(torch.cat(outs, dim=3)))
        return fmap


class DescriptDiscriminator(nn.Module):
    """MPD for each period, MSD for each rate, MRD for each FFT size, and
    their losses: ``forward(x, y)`` -> (loss_gen, loss_dis, metrics), x
    real and y generated, (B, T, 1)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 rates: Sequence[int] = (),
                 fft_sizes: Sequence[int] = (2048, 1024, 512),
                 weight_feature_matching: float = 15.0,
                 weight_adversarial: float = 1.0,
                 num_skipped_features: int = 0):
        super().__init__()
        self.weight_feature_matching = weight_feature_matching
        self.weight_adversarial = weight_adversarial
        self.num_skipped_features = num_skipped_features
        for p in periods:
            self.add_module(f"mpd_{p}", MPD(p))
        for r in rates:
            self.add_module(f"msd_{r}", MSD(r))
        for f in fft_sizes:
            self.add_module(f"mrd_{f}", MRD(f))

    @staticmethod
    def _preprocess(y: torch.Tensor) -> torch.Tensor:
        """Mean removed and scaled to a peak of 0.8, per example."""
        y = y - torch.mean(y, dim=1, keepdim=True)
        return 0.8 * y / (torch.amax(y.abs(), dim=1, keepdim=True) + 1e-9)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                batched: bool = False):
        """``batched`` runs each sub-discriminator once over [x, y] (the
        discriminator step); the split form keeps the generator step's
        backward to the y chain."""
        B = x.shape[0]
        x, y = self._preprocess(x), self._preprocess(y)
        if batched:
            t = min(x.shape[1], y.shape[1])
            xy = torch.cat([x[:, :t], y[:, :t]], dim=0)
        fm = dis_loss = adv_loss = pred_real = pred_fake = 0.0
        ns = self.num_skipped_features
        for d in self.children():
            if batched:
                both = d(xy)
                fr = [f[:B] for f in both]
                ff = [f[B:] for f in both]
            else:
                fr, ff = d(x), d(y)
            pairs = list(zip(fr[ns:], ff[ns:]))
            fm = fm + sum(torch.mean(torch.abs(a - b))
                          for a, b in pairs) / len(pairs)
            score_r, score_f = fr[-1], ff[-1]
            dis_loss = dis_loss + (torch.mean(F.relu(1 - score_r))
                                   + torch.mean(F.relu(1 + score_f)))
            adv_loss = adv_loss - torch.mean(score_f)
            pred_real = pred_real + torch.mean(score_r)
            pred_fake = pred_fake + torch.mean(score_f)
        loss_gen = (adv_loss * self.weight_adversarial
                    + fm * self.weight_feature_matching)
        metrics = {"discriminator": dis_loss, "adversarial": adv_loss,
                   "feature_matching": fm, "pred_real": pred_real,
                   "pred_fake": pred_fake}
        return loss_gen, dis_loss, metrics
