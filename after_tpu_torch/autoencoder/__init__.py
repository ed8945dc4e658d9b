"""Codec training: reconstruction losses and the GAN trainer (counterpart
of after_tpu/autoencoder)."""

from .losses import (multi_resolution_stft_loss, spectral_distance,  # noqa: F401
                     stft_loss, waveform_distance)
from .trainer import AdamW, AutoencoderTrainer  # noqa: F401
