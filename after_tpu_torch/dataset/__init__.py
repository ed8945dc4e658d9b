"""Diffusion training data: the host collate and the device latent bank."""

from .collate import make_collate_fn, thread_rng_factory  # noqa: F401
from .device_bank import DeviceLatentBank  # noqa: F401
