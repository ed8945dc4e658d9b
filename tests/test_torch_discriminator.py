"""The port's Encodec discriminator against the JAX module on carried
weights.

Two scales (n_fft 206 and 334, 4 filters) over 4096-sample signals at
batch 2; the JAX variables are perturbed so that every kernel, bias and
weight-norm scale is non-trivial, then loaded with
utils.from_jax.load_discriminator.  Tolerances: losses and metrics rtol
1e-4; each parameter's gradient within 1e-4 x max |g| of its tensor plus
1e-5 x the largest gradient of the model (f32 on both sides, FFT against
DFT matrices; a conv bias whose gradients from the real and the generated
chain cancel comes out 0 in JAX and 3e-8 here, against a largest gradient
of 5e-3); batched and split forms within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu.config import DiscriminatorConfig as JaxDiscConfig
from after_tpu.models.discriminator import EncodecDiscriminator as JaxDisc
from after_tpu_torch.config import DiscriminatorConfig
from after_tpu_torch.models.discriminator import EncodecDiscriminator
from after_tpu_torch.utils.from_jax import load_discriminator

DC = dict(filters=4, n_ffts=(206, 334), hop_lengths=(103, 167),
          win_lengths=(206, 334), weight_adversarial=0.5)
T = 4096


def _perturbed_numpy(variables, seed):
    rng = np.random.RandomState(seed)

    def f(v):
        v = np.asarray(v, dtype=np.float32)
        return (v * (1 + 0.2 * rng.uniform(-1, 1, v.shape))
                + 0.02 * rng.randn(*v.shape)).astype(np.float32)
    return jax.tree_util.tree_map(f, variables)


@pytest.fixture(scope="module")
def pair():
    jdisc = JaxDisc(JaxDiscConfig(**DC))
    z = jnp.zeros((1, T, 1))
    variables = _perturbed_numpy(jdisc.init(jax.random.PRNGKey(0), z, z), 1)
    disc = EncodecDiscriminator(DiscriminatorConfig(**DC))
    load_discriminator(disc, variables)
    rng = np.random.RandomState(2)
    x = (0.1 * rng.randn(2, T, 1)).astype(np.float32)
    y = (0.1 * rng.randn(2, T, 1)).astype(np.float32)
    return jdisc, variables, disc, x, y


def test_losses_metrics_and_gradients_match_jax(pair):
    jdisc, variables, disc, x, y = pair

    def jax_loss(params, which):
        out = jdisc.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
        return out[which], out[2]

    for which in (0, 1):              # loss_gen, loss_dis
        (jl, jm), jg = jax.value_and_grad(jax_loss, has_aux=True)(
            variables["params"], which)
        out = disc(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(out[which].item(), float(jl), rtol=1e-4)
        assert set(out[2]) == set(jm)
        for k, v in jm.items():
            np.testing.assert_allclose(out[2][k].item(), float(v), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        grads = torch.autograd.grad(out[which], list(disc.parameters()))
        theirs = EncodecDiscriminator(disc.cfg)
        load_discriminator(theirs, {"params": jax.tree_util.tree_map(
            np.asarray, jg)})
        named = [(n, t.detach().numpy()) for n, t in
                 theirs.named_parameters()]
        floor = 1e-5 * max(np.abs(t).max() for _, t in named)
        for (name, t), g in zip(named, grads):
            err = np.abs(g.numpy() - t).max()
            assert err <= 1e-4 * np.abs(t).max() + floor, (which, name, err)


def test_batched_equals_split(pair):
    _, _, disc, x, y = pair
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    split = disc(xt, yt)
    batched = disc(xt, yt, batched=True)
    for a, b in zip(split[:2], batched[:2]):
        np.testing.assert_allclose(a.item(), b.item(), rtol=1e-6)
    for k in split[2]:
        np.testing.assert_allclose(split[2][k].item(), batched[2][k].item(),
                                   rtol=1e-6, atol=1e-8, err_msg=k)


def test_loader_uses_every_variable_and_checks_shapes(pair):
    _, variables, disc, _, _ = pair
    bad = jax.tree_util.tree_map(lambda v: v, variables)
    bad["params"]["disc_0"]["conv_mid"]["extra"] = np.zeros(1)
    with pytest.raises(ValueError, match="no place in the port"):
        load_discriminator(disc, bad)
    bad = jax.tree_util.tree_map(lambda v: v, variables)
    bad["params"]["disc_2"] = bad["params"]["disc_0"]
    with pytest.raises(ValueError, match="no place in the port"):
        load_discriminator(disc, bad)
    bad = jax.tree_util.tree_map(lambda v: v, variables)
    del bad["params"]["disc_1"]["Conv_5"]
    with pytest.raises(KeyError):
        load_discriminator(disc, bad)
    other = EncodecDiscriminator(dataclasses.replace(
        DiscriminatorConfig(**DC), filters=8))
    with pytest.raises(ValueError, match="shape"):
        load_discriminator(other, variables)
    # every port tensor was set from the JAX tree: a port-native init
    # differs from it everywhere
    from after_tpu_torch.utils.init import init_weights
    fresh = EncodecDiscriminator(disc.cfg)
    init_weights(fresh, 0)
    load_discriminator(fresh, variables)
    for a, b in zip(fresh.parameters(), disc.parameters()):
        assert torch.equal(a, b)


def test_port_native_init_is_lecun_normal_with_unit_scale():
    from after_tpu_torch.utils.init import init_weights
    disc = EncodecDiscriminator(DiscriminatorConfig())
    init_weights(disc, 3)
    conv = disc.disc_0.conv_0
    assert torch.equal(conv.scale, torch.ones_like(conv.scale))
    assert not conv.bias.any()
    fan_in = conv.weight[0].numel()
    assert abs(conv.weight.std().item() - fan_in ** -0.5) < 0.1 * fan_in ** -0.5
