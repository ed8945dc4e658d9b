"""Encodec-style multi-scale complex-STFT discriminator (counterpart of
after_tpu/models/discriminator.py).

Each scale: complex spectrogram (normalized, center=False) -> optional
|z|^p magnitude pre-scaling -> [real, imag] channels -> weight-normed 2-D
convs (LeakyReLU 0.2) over (time, freq) -> 1-channel logits.  Losses: hinge
GAN and normalized feature matching.

The JAX package runs NHWC over (B, frames, bins, [re, im]); the port runs
NCHW ``F.conv2d`` over (B, [re, im], frames, bins), with the same explicit
symmetric padding and flax's weight norm.

Under bf16 training parameters (``utils.precision.cast_call``) it computes
what the JAX module computes there: the spectrogram of a bf16 waveform is
f32 (its DFT is taken on the widened values), the weight is normed in bf16
and every conv runs in f32 on it widened, so the logits, feature maps and
losses are f32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DiscriminatorConfig
from ..ops import stft as stft_ops
from ..utils.precision import at, promote


def _pad2d(k: Tuple[int, int], d: Tuple[int, int]) -> Tuple[int, int]:
    return ((k[0] - 1) * d[0]) // 2, ((k[1] - 1) * d[1]) // 2


class WNConv2d(nn.Module):
    """2-D conv with flax's ``nn.WeightNorm``: the weight is ``scale * v *
    rsqrt(sum(v^2 over in, kh, kw) + 1e-12)`` per output channel; the bias
    is not normalised.  ``weight`` is (O, I, kh, kw)."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], stride: Tuple[int, int] = (1, 1),
                 dilation: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.stride = stride
        self.dilation = dilation
        self.padding = _pad2d(kernel, dilation)
        self.weight = nn.Parameter(torch.empty(features, in_features, *kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        self.scale = nn.Parameter(torch.ones(features))

    def effective_weight(self, dtype=None) -> torch.Tensor:
        """The normed weight, at ``dtype`` from the parameters brought to
        it (``at``) where given."""
        v, scale = self.weight, self.scale
        if dtype is not None:
            v, scale = at(v, dtype), at(scale, dtype)
        inv = torch.rsqrt(v.square().sum(dim=(1, 2, 3), keepdim=True) + 1e-12)
        return v * inv * scale[:, None, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax promotes the input and the (normed) parameters to one type:
        # bf16 training parameters meet the spectrogram's f32 channels in f32
        dtype = promote(x, self.weight)
        return F.conv2d(x.to(dtype), self.effective_weight(dtype),
                        at(self.bias, dtype), self.stride, self.padding,
                        self.dilation)


class DiscriminatorSTFT(nn.Module):
    """One STFT scale: (B, T, 1) waveform -> (logits, feature maps), NCHW.

    (3, 9) convs over (time, frequency), the dilated ones with stride 2 on
    frequency and dilations 1, 2, 4 on time, then a (3, 3) conv and the
    (3, 3) conv to one logit channel; the children are registered in the
    order they run (flax's Conv_0, Conv_1, ... of the scale)."""

    def __init__(self, filters: int, n_fft: int, hop_length: int,
                 win_length: int, spec_scale_pow: float = 0.0):
        super().__init__()
        self.n_fft, self.hop_length, self.win_length = (n_fft, hop_length,
                                                        win_length)
        self.spec_scale_pow = spec_scale_pow
        filters = min(filters, 1024)
        self.conv_in = WNConv2d(2, filters, (3, 9))
        for i, d in enumerate((1, 2, 4)):
            self.add_module(f"conv_{i}", WNConv2d(filters, filters, (3, 9),
                                                  (1, 2), (d, 1)))
        self.conv_mid = WNConv2d(filters, filters, (3, 3))
        self.conv_post = WNConv2d(filters, 1, (3, 3))

    def forward(self, x: torch.Tensor):
        z = stft_ops.spectrogram(x[..., 0], self.n_fft, self.hop_length,
                                 self.win_length, power=None, normalized=True,
                                 center=False)
        if self.spec_scale_pow != 0.0:
            z = z * torch.pow(z.abs() + 1e-6, self.spec_scale_pow)
        h = torch.stack([z.real, z.imag], dim=1)      # (B, 2, frames, bins)
        fmap = []
        *body, post = self.children()
        for conv in body:
            h = F.leaky_relu(conv(h), 0.2)
            fmap.append(h)
        return post(h), fmap


class EncodecDiscriminator(nn.Module):
    """Multi-scale discriminator and its GAN losses: ``forward(x, y)`` ->
    (loss_gen, loss_dis, metrics), x real and y generated, (B, T, 1)."""

    def __init__(self, cfg: DiscriminatorConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(len(cfg.n_ffts)):
            self.add_module(f"disc_{i}", DiscriminatorSTFT(
                cfg.filters, cfg.n_ffts[i], cfg.hop_lengths[i],
                cfg.win_lengths[i], cfg.spec_scale_pow))

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                batched: bool = False):
        """``batched`` runs each scale once over [x, y] (the discriminator
        step, whose backward needs both chains); the split form keeps the
        generator step's backward to the y chain."""
        cfg = self.cfg
        dis_loss = adv_loss = fm_loss = pred_true = pred_fake = 0.0
        B = x.shape[0]
        t = min(x.shape[1], y.shape[1])
        if batched:
            xy = torch.cat([x[:, :t], y[:, :t]], dim=0)
        for disc in self.children():
            if batched:
                logits, fmaps = disc(xy)
                logit_t, logit_f = logits[:B], logits[B:]
                fmap_t = [f[:B] for f in fmaps]
                fmap_f = [f[B:] for f in fmaps]
            else:
                logit_t, fmap_t = disc(x)
                logit_f, fmap_f = disc(y)

            # hinge GAN (encodec_discriminator.py:24)
            dis_loss = dis_loss + torch.mean(F.relu(1 - logit_t)
                                             + F.relu(1 + logit_f))
            adv_loss = adv_loss - torch.mean(logit_f)
            pred_true = pred_true + torch.mean(logit_t)
            pred_fake = pred_fake + torch.mean(logit_f)

            # normalized feature matching
            fm = 0.0
            for ft, ff in zip(fmap_t, fmap_f):
                d = torch.mean(torch.abs(ft - ff))
                if cfg.normalize_losses:
                    d = d / torch.mean(torch.abs(ft))
                fm = fm + d
            fm_loss = fm_loss + fm / len(fmap_t)

        n = len(cfg.n_ffts)
        dis_loss, adv_loss, fm_loss = dis_loss / n, adv_loss / n, fm_loss / n
        loss_gen = (adv_loss * cfg.weight_adversarial
                    + fm_loss * cfg.weight_feature_matching)
        metrics = {"discriminator": dis_loss, "adversarial": adv_loss,
                   "feature_matching": fm_loss, "pred_real": pred_true,
                   "pred_fake": pred_fake}
        return loss_gen, dis_loss, metrics
