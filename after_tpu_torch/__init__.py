"""after_tpu_torch: the PyTorch / CUDA port of after_tpu for one NVIDIA H100.

Offline audio-to-audio timbre transfer (``TransferPipeline.transfer``) and
buffer-by-buffer streaming (``after_tpu_torch.streaming.Streamer``), with
the codec's fused snake+conv as a hand-written CUDA kernel.  The package
imports torch, numpy and scipy only; it never imports JAX or after_tpu.
Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from .config import AfterConfig, get_config, with_overrides  # noqa: F401
from .diffusion.pipeline import TransferPipeline  # noqa: F401
