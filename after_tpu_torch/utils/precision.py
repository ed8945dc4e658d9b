"""Reduced-precision compute (counterpart of after_tpu/utils/precision.py).

``compute_dtype`` (``TransferPipeline``, ``Streamer``, the ``export``
commands) runs the codec, the encoders and the denoiser at bf16, with the
weights cast once; the Euler state, attention logits and softmax, the
timestep features, GroupNorm statistics and the audio and latent inputs
and outputs stay f32, as in the JAX package.  bf16 GEMMs sum in f32 as
XLA's do (``utils.device.strict_f32``).

Training at a compute dtype (``AETrainConfig.compute_dtype``,
``train.compute_dtype``) keeps f32 master parameters and casts them inside
each differentiated forward (``cast_call``), as the JAX trainers cast their
params inside the loss: the gradients come back through the cast in f32.
A module then computes at the promotion of its input's type and its
parameters' (``promote``), as flax and jnp promote them.  Where a module
computes in f32 on a parameter's compute-dtype copy (the decoder behind the
bottleneck's f32 noise, the discriminator's convs over an f32 spectrogram,
GroupNorm's f32 statistics), the cast and the widening cancel, as XLA
cancels them (``xla_allow_excess_precision``, on by default): ``at`` hands
the f32 parameter itself.  BatchNorm (``ops.norms``) widens the bf16 copy
instead: the JAX encoders' BatchNorm uses its cast scale and bias rounded
(XLA's CPU keeps that pair of converts; tests/test_torch_ecapa_bf16.py).
"""

from __future__ import annotations

import contextvars
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

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


# id of a parameter's compute-dtype copy -> the parameter, inside cast_call
_MASTERS: contextvars.ContextVar[Optional[Dict[int, torch.Tensor]]] = (
    contextvars.ContextVar("after_tpu_torch_masters", default=None))


def cast_call(module: nn.Module, dtype: Optional[torch.dtype], *args,
              **kwargs) -> Any:
    """``module(*args, **kwargs)`` with its floating-point parameters cast
    to ``dtype`` for this call (``torch.func.functional_call``): a
    differentiable cast, so each parameter's gradient comes back to the
    parameter itself, in its own type; the buffers (BatchNorm statistics)
    are the module's own.  Without ``dtype``, the module as it is."""
    if dtype is None:
        return module(*args, **kwargs)
    params, masters = {}, {}
    for name, p in module.named_parameters():
        params[name] = p.to(dtype) if p.is_floating_point() else p
        masters[id(params[name])] = p
    token = _MASTERS.set(masters)
    try:
        return functional_call(module, params, args, kwargs)
    finally:
        _MASTERS.reset(token)


def at(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` at ``dtype``: inside ``cast_call`` a parameter's compute-dtype
    copy asked for in its parameter's own type is the parameter itself (the
    cast and the widening cancel, as under XLA); anything else is cast."""
    if t.dtype == dtype:
        return t
    masters = _MASTERS.get()
    master = masters.get(id(t)) if masters else None
    return master if master is not None and master.dtype == dtype \
        else t.to(dtype)


def promote(x: torch.Tensor, *params: torch.Tensor) -> torch.dtype:
    """The type a module computes in: the promotion of its input's type and
    its parameters' (bf16 input and parameters: bf16; an f32 input meeting
    bf16 parameters: f32, the parameters widened), as jnp promotes them."""
    dtype = x.dtype
    for p in params:
        dtype = torch.promote_types(dtype, p.dtype)
    return dtype


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` at the promotion of x's type and the layer's (flax's
    Dense promotes them), its parameters brought there by ``at``."""
    dtype = promote(x, layer.weight)
    bias = None if layer.bias is None else at(layer.bias, dtype)
    return F.linear(x.to(dtype), at(layer.weight, dtype), bias)
