"""The port's CUDA kernels on the card, each against its plain PyTorch version.

These tests need a CUDA card and skip without one.  The machine with the
card has no JAX, so run them there without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerance: max abs error <= 1e-4 * max |y| (3xTF32 on the tensor cores in
another summation order than cuDNN's strict f32, TF32 off in cuDNN).  Against
a float64 plain version the kernel's error may be at most 4x that of
strict-f32 F.conv1d.
"""

import numpy as np
import pytest
import torch

from after_tpu_torch.ops.kernels.fused_conv import (fused_snake_conv,
                                                    kernel_weight,
                                                    snake_conv_reference)
from after_tpu_torch.utils.device import strict_f32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    strict_f32()
    return torch.device("cuda")


def _inputs(seed, B, T, C, O, k, device):
    rng = np.random.RandomState(seed)
    arrays = (rng.randn(B, T, C), rng.rand(C) + 0.5, rng.rand(C) + 0.5,
              0.1 * rng.randn(O, C, k), rng.randn(O))
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["causal", "centered"])
@pytest.mark.parametrize("B,T,C,O,k,d", [
    (2, 512, 64, 64, 3, 1), (2, 512, 64, 128, 3, 9), (1, 1024, 16, 64, 3, 1),
    (1, 100, 20, 40, 3, 3), (3, 37, 130, 70, 1, 1), (1, 5, 8, 8, 3, 9),
    (1, 300, 33, 17, 5, 2),
    # main-path widths of the base codec
    (1, 1024, 768, 768, 3, 9), (1, 8192, 384, 384, 3, 1),
    (1, 1024, 512, 512, 1, 1),
    # O > 256 with T not a multiple of the 128-frame tile, and B = 2
    (2, 700, 96, 300, 3, 3)])
def test_kernel_matches_plain_version(cuda, B, T, C, O, k, d, mode):
    x, alpha, beta, w, b = _inputs(0, B, T, C, O, k, cuda)
    before = fused_snake_conv.launches
    y = fused_snake_conv(x, alpha, beta, w, b, d, mode)
    torch.cuda.synchronize()
    assert fused_snake_conv.launches == before + 1
    ref = snake_conv_reference(x, alpha, beta, w, b, d, mode)
    err = (y - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), err


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, alpha, beta, w, b = _inputs(2, 1, 64, 16, 16, 3, cuda)
    with pytest.raises(TypeError):
        fused_snake_conv(x.double(), alpha, beta, w, b)
    with pytest.raises(ValueError):
        fused_snake_conv(x.transpose(1, 2).contiguous().transpose(1, 2),
                         alpha, beta, w, b)
    with pytest.raises(ValueError):
        fused_snake_conv(x, alpha, beta, w, b.cpu())
    with pytest.raises(RuntimeError, match="no backward"):
        fused_snake_conv(x, alpha, beta, w.requires_grad_(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,O,k,d", [
    (1, 1024, 768, 768, 3, 9), (1, 2048, 384, 384, 3, 1),
    (1, 1024, 512, 512, 1, 1), (1, 2048, 64, 64, 3, 9),
    (1, 2048, 16, 64, 3, 1)])
def test_kernel_error_against_float64(cuda, B, T, C, O, k, d):
    """3xTF32 keeps f32 accuracy: against float64, at most 4x the error of
    strict-f32 F.conv1d on the same inputs."""
    x, alpha, beta, w, b = _inputs(3, B, T, C, O, k, cuda)
    w = w / (C * k) ** 0.5
    ref = snake_conv_reference(*(t.double() for t in (x, alpha, beta, w, b)),
                               d, "centered")
    y = fused_snake_conv(x, alpha, beta, w, b, d, "centered")
    strict = snake_conv_reference(x, alpha, beta, w, b, d, "centered")
    err = (y.double() - ref).abs().max().item()
    err_conv1d = (strict.double() - ref).abs().max().item()
    assert err <= 4 * err_conv1d, (err, err_conv1d)


@pytest.mark.cuda
def test_kept_weight_is_passed_as_it_is(cuda):
    """A weight in the kernel's layout with its low half (as StreamConv1d
    keeps it) reaches the kernel without a copy, and gives the result of
    the same weight in torch's layout (within the rounding of the order of
    the sums)."""
    x, alpha, beta, w, b = _inputs(4, 1, 300, 64, 96, 3, cuda)
    hi, lo = kernel_weight(w)
    kept = hi.permute(1, 2, 0)
    kept.kernel_lo = lo
    hi2, lo2 = kernel_weight(kept)
    assert hi2.data_ptr() == hi.data_ptr() and lo2.data_ptr() == lo.data_ptr()
    y = fused_snake_conv(x, alpha, beta, kept, b, 3, "centered")
    y_plain_layout = fused_snake_conv(x, alpha, beta, w, b, 3, "centered")
    # a split channel sum adds with atomics, in an order that varies
    err = (y - y_plain_layout).abs().max().item()
    assert err <= 1e-6 * y.abs().max().item(), err
