"""The port's conv UNet (after_tpu_torch/models/unet1d.py) against the JAX
package's, on the CPU, at the JAX test's own size (channels (16, 16),
ratios (2, 2), k = 5 over 32 frames of 8 latents, 12-wide structure codes
and a 6-wide timbre vector), its parameters the JAX ``init`` tree carried
across by ``from_jax``:

- the forward, whose strided convs pad as flax's ``SAME`` (1 frame left, 2
  right at k = 5, stride 2), whose GroupNorms exist only where the input
  width splits into groups (the first block's 72 channels do not), and
  whose structure pyramid lags the pooling by one level;
- ``SameConv1d`` against flax's ``nn.Conv`` at strides 1 and 2 over odd and
  even lengths;
- the same forward at bf16 (weights and inputs), under the bf16 rule of
  tests/test_torch_precision.py: flax promotes each layer to its input's
  and parameters' type, so the f32 time embedding turns the blocks f32;
- ``make_denoiser`` gives no streaming form and the streamer refuses the
  model, as the JAX ones do;
- the wiring: a micro transfer against JAX's ``TransferPipeline``.

Tolerances: the v2 denoiser's atol 1e-5 on a forward
(tests/test_torch_denoiser.py); the bf16 rule; the transfer's atol 1e-3
(tests/torch_models_common.py).
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu.models import UNet1D as JaxUNet
from after_tpu.models import UNet1DConfig as JaxUNetConfig
from after_tpu.utils.precision import cast_floating
from after_tpu_torch import config as port_config
from after_tpu_torch.models import make_denoiser
from after_tpu_torch.models.unet1d import SameConv1d, UNet1D, UNet1DConfig
from after_tpu_torch.utils.from_jax import load_module
from tests.test_torch_precision import bf16_close
from tests.torch_models_common import check_transfer

TOL = dict(atol=1e-5)
SIZE = dict(in_size=8, channels=(16, 16), ratios=(2, 2),
            time_cond_in_channels=12, cond_channels=6)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def unet():
    """The JAX UNet, its perturbed init variables, the inputs, and the
    port's UNet with those variables."""
    jnet = JaxUNet(JaxUNetConfig(**SIZE))
    rng = np.random.RandomState(0)
    inputs = (rng.randn(2, 32, 8).astype(np.float32),
              rng.rand(2).astype(np.float32),
              rng.randn(2, 6).astype(np.float32),
              rng.randn(2, 32, 12).astype(np.float32))
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(0), *inputs)
    prng = np.random.RandomState(1)

    def f(v):
        v = np.asarray(v, dtype=np.float32)
        return (v * (1 + 0.2 * prng.uniform(-1, 1, v.shape))
                + 0.02 * prng.randn(*v.shape)).astype(np.float32)
    variables = jax.tree_util.tree_map(f, variables)
    net = UNet1D(UNet1DConfig(**SIZE)).eval()
    load_module(net, variables, "net")
    return jnet, variables, inputs, net


def test_forward_matches_jax(unet):
    jnet, variables, inputs, net = unet
    y = jax.jit(jnet.apply)(variables, *inputs)
    assert net.down_conv_0.gn1 is None and net.down_conv_1.gn1 is not None
    with torch.no_grad():
        py = net(*_t(*inputs))
    assert py.shape == (2, 32, 8)
    np.testing.assert_allclose(py.numpy(), np.asarray(y), **TOL)


def test_bf16_forward_matches_jax(unet):
    jnet, variables, inputs, net = unet
    apply = jax.jit(jnet.apply)
    y32 = apply(variables, *inputs)
    y16 = apply(cast_floating(variables, jnp.bfloat16),
                *(jnp.asarray(a, jnp.bfloat16) for a in inputs))
    net16 = copy.deepcopy(net).to(torch.bfloat16)
    with torch.no_grad():
        py = net16(*(a.to(torch.bfloat16) for a in _t(*inputs)))
    assert py.dtype == torch.float32 and y16.dtype == jnp.float32
    bf16_close("UNet1D", py.numpy(), np.asarray(y16), np.asarray(y32))


@pytest.mark.parametrize("stride,length", [(1, 9), (2, 8), (2, 9), (3, 10)])
def test_same_conv_pads_as_flax(stride, length):
    conv = fnn.Conv(4, (5,), strides=(stride,), padding="SAME")
    x = np.random.RandomState(stride).randn(1, length, 3).astype(np.float32)
    variables = conv.init(jax.random.PRNGKey(0), x)
    y = conv.apply(variables, x)
    ours = SameConv1d(3, 4, 5, stride=stride)
    load_module(ours, variables, "conv")
    with torch.no_grad():
        py = ours(*_t(x))
    assert py.shape == y.shape
    np.testing.assert_allclose(py.numpy(), np.asarray(y), **TOL)


def test_no_streaming_form():
    from after_tpu_torch.streaming.streamer import Streamer
    cfg = port_config.with_overrides(port_config.get_config("tiny"),
                                     {"denoiser.arch": "unet1d"})
    assert make_denoiser(cfg.denoiser, streaming=True) is None
    assert isinstance(make_denoiser(cfg.denoiser), UNet1D)
    with pytest.raises(ValueError, match="offline-only"):
        Streamer(cfg, device="cpu")


def test_transfer_matches_jax():
    check_transfer({"denoiser.arch": "unet1d",
                    "denoiser.unet_channels": (16, 16),
                    "denoiser.unet_ratios": (2, 2)})
