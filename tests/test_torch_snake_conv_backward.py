"""The snake+conv op's backward, ``after_tpu_torch::snake_conv_backward``, on
the CPU, where it is its plain version (the VJP of the plain forward).

The same inputs, made from numpy seeds, go through the port's op and through
``jax.grad`` of the JAX package's Pallas kernel (interpret mode), whose
custom VJP is the reference.  Tolerance: rtol 1e-4 and atol 1e-3 for all
five gradients, as tests/test_torch_fused_conv.py holds the op's autograd.
On the card the op launches the two kernels of csrc/snake_conv_backward.cu
(tests/test_torch_cuda_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from after_tpu.ops.pallas import fused_snake_causal_conv
from after_tpu_torch.ops.kernels.fused_conv import (backward_weight,
                                                    fused_snake_conv,
                                                    kernel_weight,
                                                    snake_conv_backward)

RTOL, ATOL = 1e-4, 1e-3
ALL = [True] * 5


def _inputs(seed, B, T, C, O, k):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    alpha = (rng.rand(C) + 0.5).astype(np.float32)
    beta = (rng.rand(C) + 0.5).astype(np.float32)
    w = (0.3 * rng.randn(k, C, O)).astype(np.float32)   # JAX (k, C, O)
    b = rng.randn(O).astype(np.float32)
    g = rng.randn(B, T, O).astype(np.float32)
    return x, alpha, beta, w, b, g


def _op_args(x, alpha, beta, w, b, g):
    """The op's inputs: torch tensors, the weight in the kernel's (k, O, Cw)
    layout."""
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)))
    w_k = kernel_weight(wt)[0]
    return (torch.from_numpy(g), torch.from_numpy(x), torch.from_numpy(alpha),
            torch.from_numpy(beta), w_k, torch.from_numpy(b))


@pytest.mark.parametrize("mode", ["causal", "centered"])
@pytest.mark.parametrize("k,d,C,O", [(3, 1, 16, 16), (3, 3, 16, 24),
                                     (3, 9, 8, 16), (1, 1, 16, 8),
                                     (3, 3, 10, 12)])
def test_backward_op_matches_jax_grad_through_pallas(k, d, C, O, mode):
    """gx, galpha, gbeta, gw and gb of the op against jax.grad of sum(y * g)
    through the Pallas kernel; C = 10 is not a multiple of 4, so the
    weight's (k, O, Cw) layout carries 2 padded columns."""
    x, alpha, beta, w, b, g = _inputs(k * 100 + d, 2, 64, C, O, k)

    def loss(*args):
        y = fused_snake_causal_conv(*args, dilation=d, t_tile=32, mode=mode,
                                    interpret=True)
        return jnp.sum(y * g)
    theirs = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, alpha, beta, w, b)))
    gx, galpha, gbeta, gw_k, gb = snake_conv_backward(
        *_op_args(x, alpha, beta, w, b, g), d, mode, ALL)
    assert gw_k.shape == (k, O, -(-C // 4) * 4)
    # (k, O, Cw) -> JAX's (k, C, O)
    gw = gw_k[:, :, :C].numpy().transpose(0, 2, 1)
    ours = [gx.numpy(), galpha.numpy(), gbeta.numpy(), gw, gb.numpy()]
    for name, a, t in zip("x alpha beta w b".split(), ours, theirs):
        np.testing.assert_allclose(a, np.asarray(t), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("needs", [
    [True, False, False, False, False], [False, True, True, False, False],
    [False, False, False, True, False], [False, False, False, False, True],
    [True, False, False, True, True]])
def test_needs_mask_leaves_out_exactly_what_is_not_asked(needs):
    """The op returns an empty tensor for each input not asked for and the
    full gradient, as when all are asked, for the others; through autograd
    the inputs that need no gradient get None."""
    x, alpha, beta, w, b, g = _inputs(7, 2, 40, 12, 20, 3)
    args = _op_args(x, alpha, beta, w, b, g)
    full = snake_conv_backward(*args, 3, "centered", ALL)
    some = snake_conv_backward(*args, 3, "centered", needs)
    for n, f, s in zip(needs, full, some):
        if n:
            assert torch.equal(s, f)
        else:
            assert s.numel() == 0
    inputs = [t.clone().requires_grad_(n)
              for t, n in zip(args[1:4] + (torch.from_numpy(
                  np.ascontiguousarray(w.transpose(2, 1, 0))), args[5]),
                  needs)]
    y = fused_snake_conv(*inputs, 3, "centered")
    y.backward(args[0])
    for t, n in zip(inputs, needs):
        assert (t.grad is not None) == n


def test_fake_gives_the_five_shapes():
    """Traced, the op's fake gives each gradient its input's shape, an empty
    one where not asked."""
    x, alpha, beta, w, b, g = _inputs(8, 2, 40, 10, 20, 3)
    with FakeTensorMode() as mode:
        args = [mode.from_tensor(t) for t in _op_args(x, alpha, beta, w, b,
                                                      g)]
        out = snake_conv_backward(*args, 3, "causal", ALL)
        some = snake_conv_backward(*args, 3, "causal",
                                   [True, False, True, False, True])
    shapes = [tuple(t.shape) for t in args[1:]]
    assert [tuple(t.shape) for t in out] == shapes
    assert [tuple(t.shape) for t in some] == [shapes[0], (0,), shapes[2],
                                              (0,), shapes[4]]


def test_weight_gradient_padded_columns_are_zero():
    """C = 10 in a (k, O, 12) weight: the weight's gradient has zeros in the
    two padded columns, as the kernel writes them."""
    x, alpha, beta, w, b, g = _inputs(9, 2, 64, 10, 16, 3)
    gw_k = snake_conv_backward(*_op_args(x, alpha, beta, w, b, g), 3,
                               "centered", ALL)[3]
    assert gw_k.shape == (3, 16, 12)
    assert not gw_k[:, :, 10:].any() and gw_k[:, :, :10].abs().max() > 0


def test_dgrad_weight_layout():
    """``backward_weight`` gives the (k, C, Ow) layout dgrad reads: each tap
    transposed, Ow = O rounded up to 4 with zeros past O."""
    w_k = kernel_weight(torch.randn(18, 10, 3))[0]        # (3, 18, 12)
    wt = backward_weight(w_k, 10)
    assert wt.shape == (3, 10, 20) and wt.is_contiguous()
    for j in range(3):
        np.testing.assert_array_equal(wt[j, :, :18].numpy(),
                                      w_k[j, :, :10].T.numpy())
    assert not wt[:, :, 18:].any()
