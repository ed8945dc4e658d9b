"""Models of the port: codec, structure and timbre encoders, denoisers,
discriminators (exported as the JAX package's ``models`` exports them,
with ``GRU`` and the descript discriminator beside)."""

from __future__ import annotations

from typing import Optional

from torch import nn

from .autoencoder import GRU, AudioCodec, CodecDecoder, CodecEncoder
from .denoiser import Denoiser, fourier_features
from .denoiser_v1 import DenoiserV1, DenoiserV1Config
from .descript_discriminator import DescriptDiscriminator
from .discriminator import EncodecDiscriminator
from .ecapa import ECAPAEncoder
from .encoder import Encoder1D, LinearEncoder
from .unet1d import UNet1D, UNet1DConfig


def make_denoiser(dcfg, streaming: bool = False,
                  cond_in: Optional[int] = None,
                  tcond_in: Optional[int] = None) -> Optional[nn.Module]:
    """The configured denoiser backbone (counterpart of
    after_tpu/models/__init__.py:make_denoiser): DenoiserV2 (``arch="v2"``),
    Denoiser v1 or the conv UNet, fed a ``cond_in``-wide timbre vector and
    ``tcond_in``-wide structure codes.  None for a streaming ``unet1d``,
    which has no streaming form."""
    if dcfg.arch == "v2":
        return Denoiser(dcfg, cond_in=cond_in, tcond_in=tcond_in,
                        streaming=streaming)
    if dcfg.arch == "v1":
        v1 = DenoiserV1Config(
            base=dcfg, tcond_mode=dcfg.v1_tcond_mode,
            temporal_noise=dcfg.v1_temporal_noise, mlp_type=dcfg.v1_mlp_type,
            cross_attn_causal=dcfg.v1_cross_attn_causal)
        return DenoiserV1(v1, cond_in=cond_in, tcond_in=tcond_in,
                          streaming=streaming)
    if dcfg.arch == "unet1d":
        if streaming:
            return None
        return UNet1D(UNet1DConfig(
            in_size=dcfg.n_channels, channels=tuple(dcfg.unet_channels),
            ratios=tuple(dcfg.unet_ratios),
            kernel_size=dcfg.unet_kernel_size,
            time_channels=dcfg.noise_embed_dims,
            time_cond_in_channels=dcfg.tcond_dim,
            time_cond_channels=dcfg.unet_time_cond_channels,
            cond_channels=dcfg.cond_dim), cond_in=cond_in, tcond_in=tcond_in)
    raise ValueError(f"unknown denoiser arch {dcfg.arch!r} "
                     "(expected 'v2' | 'v1' | 'unet1d')")
