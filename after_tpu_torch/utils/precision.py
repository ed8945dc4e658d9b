"""Reduced-precision compute (counterpart of after_tpu/utils/precision.py).

``compute_dtype`` (``TransferPipeline``, ``Streamer``, the ``export``
commands) runs the codec, the encoders and the denoiser at bf16, with the
weights cast once; the Euler state, attention logits and softmax, the
timestep features, GroupNorm statistics and the audio and latent inputs
and outputs stay f32, as in the JAX package.  bf16 GEMMs sum in f32 as
XLA's do (``utils.device.strict_f32``).
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch import nn

_ALIASES = {"bf16": "bfloat16", "f32": "float32", "fp32": "float32"}


def resolve_dtype(name: Union[None, str, torch.dtype]
                  ) -> Optional[torch.dtype]:
    """'bfloat16' / 'bf16' / 'float32' / 'f32' / 'fp32' / None (or a torch
    dtype) -> the torch dtype, or None for none given."""
    if name is None or name == "":
        return None
    if isinstance(name, torch.dtype):
        return name
    name = _ALIASES.get(name, name)
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute dtype {name!r}")
    return dtype


def compute_dtype(name: Union[None, str, torch.dtype]
                  ) -> Optional[torch.dtype]:
    """The ``compute_dtype`` of a pipeline or a streamer: None for f32 (the
    models as they are, no cast anywhere), else the resolved dtype."""
    dtype = resolve_dtype(name)
    return None if dtype == torch.float32 else dtype


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """``tree`` with every floating-point tensor cast to ``dtype``: a module
    (its parameters and buffers, in place, returned) or a nested dict, list
    or tuple of tensors (a new tree); integer and bool tensors, and anything
    that is not a tensor, stay as they are."""
    if isinstance(tree, nn.Module):
        return tree.to(dtype)
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree


def to_compute(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``t`` at the compute dtype, or ``t`` itself without one."""
    return t if dtype is None else t.to(dtype)


def to_f32(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A compute-dtype output back in f32, or ``t`` itself without a
    compute dtype."""
    return t if dtype is None else t.float()
