"""The port's fused snake+conv against the JAX Pallas kernel.

On the CPU the port's wrapper runs its plain version (snake_beta + F.conv1d);
it is held to the JAX Pallas kernel in interpret mode, at the shapes of
tests/test_pallas.py, and to the JAX lax reference on ragged shapes.
Tolerance: atol 2e-4, as tests/test_pallas.py holds the Pallas kernel.
Gradients for x, alpha, beta, w and b are held to ``jax.grad`` through the
Pallas kernel's custom VJP at rtol 1e-4 and atol 1e-3, as
tests/test_pallas.py holds that VJP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu.ops.pallas import fused_snake_causal_conv, reference_snake_conv
from after_tpu_torch.ops.conv import get_padding
from after_tpu_torch.ops.kernels.fused_conv import (fused_snake_conv,
                                                    snake_conv_reference,
                                                    sum_splits)

ATOL = 2e-4


def _inputs(seed, B, T, C, O, k):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    alpha = (rng.rand(C) + 0.5).astype(np.float32)
    beta = (rng.rand(C) + 0.5).astype(np.float32)
    w = (0.1 * rng.randn(k, C, O)).astype(np.float32)   # JAX (k, C, O)
    b = rng.randn(O).astype(np.float32)
    return x, alpha, beta, w, b


def _port(x, alpha, beta, w, b, d, mode):
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)))
    y = fused_snake_conv(torch.from_numpy(x), torch.from_numpy(alpha),
                         torch.from_numpy(beta), wt, torch.from_numpy(b),
                         dilation=d, mode=mode)
    return y.numpy()


@pytest.mark.parametrize("mode", ["causal", "centered"])
@pytest.mark.parametrize("k,d,C,O", [(3, 1, 64, 64), (3, 9, 64, 128),
                                     (1, 1, 128, 128)])
def test_plain_version_matches_pallas_kernel(k, d, C, O, mode):
    x, alpha, beta, w, b = _inputs(0, 2, 512, C, O, k)
    y_pallas = fused_snake_causal_conv(
        jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(w),
        jnp.asarray(b), dilation=d, t_tile=256, mode=mode, interpret=True)
    y = _port(x, alpha, beta, w, b, d, mode)
    assert y.shape == (2, 512, O)
    np.testing.assert_allclose(y, np.asarray(y_pallas), atol=ATOL)


@pytest.mark.parametrize("mode", ["causal", "centered"])
@pytest.mark.parametrize("T,k,d,C,O", [(100, 3, 3, 20, 40), (37, 3, 9, 16, 8),
                                       (5, 3, 9, 8, 8)])
def test_plain_version_matches_lax_reference_ragged(T, k, d, C, O, mode):
    x, alpha, beta, w, b = _inputs(1, 2, T, C, O, k)
    y_ref = reference_snake_conv(jnp.asarray(x), jnp.asarray(alpha),
                                 jnp.asarray(beta), jnp.asarray(w),
                                 jnp.asarray(b), dilation=d, mode=mode)
    y = _port(x, alpha, beta, w, b, d, mode)
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=ATOL)


def test_cpu_tensor_takes_plain_version_without_launch():
    x, alpha, beta, w, b = _inputs(2, 1, 64, 16, 32, 3)
    args = [torch.from_numpy(a) for a in (x, alpha, beta)]
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)))
    before = fused_snake_conv.launches
    y = fused_snake_conv(*args, wt, torch.from_numpy(b), 3, "centered")
    assert fused_snake_conv.launches == before
    ref = snake_conv_reference(*args, wt, torch.from_numpy(b), 3, "centered")
    assert torch.equal(y, ref)


def test_split_sum_plain_version_adds_in_split_order():
    """On the CPU the split sum is its plain version: ws[0] + ws[1] + ...
    in that order (the kernel's order), within f32 rounding of a float64
    sum."""
    ws = torch.randn(4, 2, 16, 8, generator=torch.Generator().manual_seed(0))
    y = sum_splits(ws)
    assert torch.equal(y, ((ws[0] + ws[1]) + ws[2]) + ws[3])
    torch.testing.assert_close(y.double(), ws.double().sum(0), rtol=0,
                               atol=1e-6)


def test_padding_rule_matches_jax():
    from after_tpu.ops.conv import get_padding as jax_get_padding
    for k in (1, 3, 4, 5, 8):
        for s in (1, 2, 4):
            for d in (1, 3, 9):
                for mode in ("causal", "centered"):
                    assert (get_padding(k, s, d, mode)
                            == jax_get_padding(k, s, d, mode))


@pytest.mark.parametrize("C", [33, 64])
def test_kernel_weight_layout_and_split(C):
    """kernel_weight gives the (k, O, Cw) layout the CUDA kernel reads, Cw
    = C rounded up to 4 with zeros past C, and the low tf32 half: rounded
    to tf32 and within 2^-22 |W| of the weight beside the tensor cores' high
    part."""
    from after_tpu_torch.ops.kernels.fused_conv import (kernel_weight,
                                                        tf32_high,
                                                        weight_low)

    rng = np.random.RandomState(C)
    w = torch.from_numpy((rng.randn(17, C, 3) * 10.0 ** rng.uniform(
        -6, 2, (17, C, 3))).astype(np.float32))
    hi, lo = kernel_weight(w)
    Cw = -(-C // 4) * 4
    assert hi.shape == lo.shape == (3, 17, Cw)
    assert hi.is_contiguous() and lo.is_contiguous()
    np.testing.assert_array_equal(hi[:, :, :C].numpy(),
                                  w.permute(2, 0, 1).numpy())
    assert not hi[:, :, C:].any() and not lo[:, :, C:].any()
    assert not (tf32_high(hi).view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = (tf32_high(hi).double() + lo.double() - hi.double()).abs()
    assert (err <= 2.0 ** -22 * hi.double().abs()).all()
    np.testing.assert_array_equal(weight_low(hi).numpy(), lo.numpy())
    # a copy of w: the high half carries w's gradient, the low half none
    wg = w.clone().requires_grad_()
    hi2, lo2 = kernel_weight(wg)
    assert hi2.requires_grad and not lo2.requires_grad
    assert hi2.data_ptr() != wg.data_ptr()
    np.testing.assert_array_equal(lo2.numpy(), lo.numpy())


def _grads_jax(x, alpha, beta, w, b, d, mode, gy):
    def loss(*args):
        y = fused_snake_causal_conv(*args, dilation=d, t_tile=32, mode=mode,
                                    interpret=True)
        return jnp.sum(y * gy)
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, alpha, beta, w, b)))


def _grads_port(fn, x, alpha, beta, w, b, d, mode, gy):
    args = [torch.from_numpy(a).requires_grad_() for a in
            (x, alpha, beta, np.ascontiguousarray(w.transpose(2, 1, 0)), b)]
    y = fn(*args, d, mode)
    grads = torch.autograd.grad(y, args, torch.from_numpy(gy))
    # w's gradient in torch's (O, C, k) shape -> JAX's (k, C, O)
    return [g.numpy() for g in grads[:3]] + [
        grads[3].numpy().transpose(2, 1, 0), grads[4].numpy()]


@pytest.mark.parametrize("mode", ["causal", "centered"])
@pytest.mark.parametrize("d", [1, 3])
def test_gradients_match_the_pallas_kernels_vjp(d, mode):
    """On the CPU the port's op differentiates through its plain version;
    its gradients for all five inputs against jax.grad through the Pallas
    kernel (interpret mode) and its custom VJP."""
    x, alpha, beta, w, b = _inputs(3, 2, 64, 16, 16, 3)
    gy = np.random.RandomState(4).randn(2, 64, 16).astype(np.float32)
    theirs = _grads_jax(x, alpha, beta, w, b, d, mode, gy)
    ours = _grads_port(fused_snake_conv, x, alpha, beta, w, b, d, mode, gy)
    for name, a, t in zip("x alpha beta w b".split(), ours, theirs):
        np.testing.assert_allclose(a, np.asarray(t), rtol=1e-4, atol=1e-3,
                                   err_msg=name)


def test_function_backward_is_the_plain_versions_vjp():
    """The registered op's gradient on the CPU (on the card the backward's
    kernels compute it): its backward returns the plain version's VJP for
    each input that needs one, bit for bit, and None for the others."""
    x, alpha, beta, w, b = _inputs(5, 2, 40, 12, 20, 3)
    gy = np.random.RandomState(6).randn(2, 40, 20).astype(np.float32)
    for mode in ("causal", "centered"):
        ours = _grads_port(fused_snake_conv, x, alpha, beta, w, b, 3, mode,
                           gy)
        plain = _grads_port(snake_conv_reference, x, alpha, beta, w, b, 3,
                            mode, gy)
        for a, p in zip(ours, plain):
            np.testing.assert_array_equal(a, p)
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)))
    wt.requires_grad_()
    y = fused_snake_conv(xt, torch.from_numpy(alpha), torch.from_numpy(beta),
                         wt, torch.from_numpy(b), 1, "causal")
    assert "snake_conv" in type(y.grad_fn).__name__
    y.sum().backward()
    assert wt.grad is not None and wt.grad.shape == wt.shape
    assert xt.grad is None
