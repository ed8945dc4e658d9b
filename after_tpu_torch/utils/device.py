"""Device choice, numeric mode and host-to-card copies of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch


_CPU_WARM = False


def warm_cpu_math() -> None:
    """One call each of torch.sin, cos, exp and tanh on 65,536 values, once
    a process.  PyTorch's first vectorised call of such an op in a CPU
    process may compute one thread's share of a large tensor about 1.5e-4
    off float64 (``python scripts/torch_cpu_first_call.py``); after one
    call on another tensor it is exact to f32."""
    global _CPU_WARM
    if not _CPU_WARM:
        x = torch.linspace(-4.0, 4.0, 1 << 16)
        for op in (torch.sin, torch.cos, torch.exp, torch.tanh):
            op(x)
        _CPU_WARM = True


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Without a CUDA device and without an explicit ``device`` this
    raises instead of carrying on on the CPU.  On the CPU it warms up the
    math ops first (``warm_cpu_math``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port's plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for device={str(device)!r}: pass device='cpu' "
            "to run the port's plain PyTorch versions on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cpu":
        warm_cpu_math()
    return device


def strict_f32() -> None:
    """Full-f32 matmuls and convolutions on the card.  cuDNN convolutions
    default to TF32, which keeps about three decimal digits and breaks parity
    with the f32 reference; matmuls are set explicitly too.  bf16 matmuls
    (``compute_dtype``) sum in f32 and round once, as XLA's do, where cuBLAS
    may otherwise reduce in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def copy_from_host(dst: torch.Tensor, src) -> torch.Tensor:
    """``dst.copy_(src)`` without a host sync: a host array or CPU tensor is
    staged in pinned memory and copied asynchronously.  The caching host
    allocator keeps the pinned block until the copy has run, so the next
    call cannot overwrite it while it is pending."""
    if isinstance(src, torch.Tensor) and src.device.type != "cpu":
        return dst.copy_(src)
    host = torch.as_tensor(src, dtype=dst.dtype)
    if dst.device.type == "cuda":
        host = host.pin_memory()
    return dst.copy_(host, non_blocking=dst.device.type == "cuda")


def to_device(x, device: torch.device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x`` (a tensor or a host array) as a ``dtype`` tensor on ``device``;
    a host array reaches a card without a host sync (``copy_from_host``)."""
    if isinstance(x, torch.Tensor) and x.device == device:
        return x.to(dtype)
    if device.type != "cuda":
        return torch.as_tensor(x, dtype=dtype, device=device)
    host = torch.as_tensor(x, dtype=dtype)
    return copy_from_host(torch.empty(host.shape, dtype=dtype, device=device),
                          host)
