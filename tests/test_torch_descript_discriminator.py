"""The port's descript discriminator (MPD, MSD, MRD and their losses)
against the JAX modules on carried weights.

Each module's JAX variables are drawn from a numpy seed so that every
kernel, bias and weight-norm scale is non-trivial, then loaded with
utils.from_jax.load_discriminator.  Inputs come from a numpy seed: 2
signals of 4096 samples; MRD at window 128 (hop 32), the whole
discriminator at period 3, MSD rate 2 and FFT size 64.

Tolerances: every feature map within 1e-4 x its max |value| (the port's
NCHW and NCW against JAX's NHWC and NWC, transposed); losses and metrics
rtol 1e-4; each parameter's gradient within 1e-4 x max |g| of its tensor
plus 1e-5 x the largest gradient of the model (the floor of
tests/test_torch_discriminator.py: f32 on both sides, FFT against DFT
matrices); batched and split forms within 1e-6.

The LeakyReLUs and the feature-matching |a - b| make a gradient jump
where an f32 value lands on the other side of zero from the exact one: of
weight draws 0-11, five put one package's f32 gradients or both past the
tolerance of the port's float64 ones, by 2.9-274x.  So each package's f32
gradients are held, on draws 0-5, against the port's float64 gradients
taken through the kinks on the sides that package's own f32 run took
them; the sides where that run and the exact float64 one part must be
rounding-level values.  The direct comparison of the two packages runs
on draw 7, where neither package crosses a kink.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from after_tpu.models import descript_discriminator as jdd
from after_tpu_torch.autoencoder.trainer import make_discriminator
from after_tpu_torch.config import DiscriminatorConfig
from after_tpu_torch.models import descript_discriminator as dd
from after_tpu_torch.utils.from_jax import load_discriminator
from tests import torch_threads_common  # noqa: F401  (xdist workers' threads)

T = 4096
FMAP_TOL = 1e-4
KW = dict(periods=(3,), rates=(2,), fft_sizes=(64,),
          weight_feature_matching=15.0, weight_adversarial=0.7)


def _random_variables(module, seed, *inputs):
    """Variables of ``module``'s shapes (``eval_shape``: no compile) drawn
    from ``seed``: kernels normal over sqrt(fan in), biases 0.02 normal,
    weight-norm scales uniform in [0.8, 1.2]."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            *(jnp.asarray(a) for a in inputs))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name, shape = path[-1].key, tuple(s.shape)
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "bias":
            v = 0.02 * rng.randn(*shape)
        else:
            v = rng.uniform(0.8, 1.2, shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _signals(seed):
    rng = np.random.RandomState(seed)
    x = (0.1 * rng.randn(2, T, 1)).astype(np.float32)
    y = (0.1 * rng.randn(2, T, 1) + 0.02).astype(np.float32)
    return x, y


def _wrap(name, module):
    """A port sub-discriminator as the only child of a container named as
    in the JAX discriminator, for the loader."""
    box = torch.nn.Module()
    box.add_module(name, module)
    return box


@pytest.mark.parametrize("kind", ["mpd_3", "msd_1", "msd_2", "mrd_128"])
def test_sub_discriminator_feature_maps_match_jax(kind):
    name, arg = kind.split("_")
    arg = int(arg)
    jmod = {"mpd": jdd.MPD, "msd": jdd.MSD, "mrd": jdd.MRD}[name](arg)
    ours = {"mpd": dd.MPD, "msd": dd.MSD, "mrd": dd.MRD}[name](arg)
    x, _ = _signals(1)
    variables = _random_variables(jmod, 2, x)
    load_discriminator(_wrap(kind, ours), {"params": {kind: variables[
        "params"]}})
    theirs = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        fmaps = ours(torch.from_numpy(x))
    assert len(fmaps) == len(theirs)
    for i, (a, b) in enumerate(zip(fmaps, theirs)):
        b = np.asarray(b)
        b = b.transpose((0, 3, 1, 2) if b.ndim == 4 else (0, 2, 1))
        assert a.shape == b.shape, (i, a.shape, b.shape)
        err = np.abs(a.numpy() - b).max()
        assert err <= FMAP_TOL * np.abs(b).max(), (kind, i, err)


@pytest.fixture(scope="module")
def pair():
    jdisc = jdd.DescriptDiscriminator(**KW)
    x, y = _signals(3)
    variables = _random_variables(jdisc, 7, x, y)
    disc = dd.DescriptDiscriminator(**KW)
    load_discriminator(disc, variables)
    return jdisc, variables, disc, x, y


def test_losses_metrics_and_gradients_match_jax(pair):
    jdisc, variables, disc, x, y = pair

    def jax_loss(params, which):
        out = jdisc.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
        return out[which], out[2]

    @jax.jit
    def both(params):
        return [jax.value_and_grad(jax_loss, has_aux=True)(params, which)
                for which in (0, 1)]

    for which, ((jl, jm), jg) in enumerate(both(variables["params"])):
        # which: loss_gen, loss_dis
        out = disc(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(out[which].item(), float(jl), rtol=1e-4)
        assert set(out[2]) == set(jm)
        for k, v in jm.items():
            np.testing.assert_allclose(out[2][k].item(), float(v), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        grads = torch.autograd.grad(out[which], list(disc.parameters()))
        theirs = dd.DescriptDiscriminator(**KW)
        load_discriminator(theirs, {"params": jax.tree_util.tree_map(
            np.asarray, jg)})
        named = [(n, t.detach().numpy()) for n, t in
                 theirs.named_parameters()]
        assert len(named) == len(grads)
        floor = 1e-5 * max(np.abs(t).max() for _, t in named)
        for (name, t), g in zip(named, grads):
            err = np.abs(g.numpy() - t).max()
            assert err <= 1e-4 * np.abs(t).max() + floor, (which, name, err)


def _fmaps_ncw(value):
    value = np.asarray(value)
    return np.ascontiguousarray(value.transpose(
        (0, 3, 1, 2) if value.ndim == 4 else (0, 2, 1)))


@pytest.fixture(scope="module")
def jax_kinks():
    """The JAX discriminator of KW on draw 3's signals, and a jitted
    function of the JAX parameters: for loss_gen and loss_dis,
    (loss, (LeakyReLU pre-activations, feature-matching differences)) and
    the gradients, the kinks' inputs read where the JAX module passes them
    to nn.leaky_relu and jnp.abs."""
    jdisc = jdd.DescriptDiscriminator(**KW)
    x, y = _signals(3)

    def loss(params, which):
        acts, diffs = [], []
        leaky_relu, absolute = fnn.leaky_relu, jnp.abs

        def act(h, slope):
            acts.append(h)
            return leaky_relu(h, slope)

        def l1(d):
            diffs.append(d)
            return absolute(d)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jdd.nn, "leaky_relu", act)
            mp.setattr(jdd.jnp, "abs", l1)
            out = jdisc.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(y))
        # the first two |.| are _preprocess's peaks, not kinks of the loss
        return out[which], (acts, diffs[2:])
    return jdisc, jax.jit(lambda params: [jax.value_and_grad(
        loss, has_aux=True)(params, which) for which in (0, 1)])


def _port_kinks(disc, x, y, dtype, sides=None):
    """The port's (loss_gen, loss_dis) at ``dtype`` and the values at its
    kinks (LeakyReLU pre-activations, feature-matching differences); with
    ``sides`` (a boolean tensor a kink, in call order) each kink is taken
    on the side given there instead of on its value's own."""
    acts, diffs = [], []
    given = None if sides is None else (iter(sides[0]), iter(sides[1]))
    absolute = torch.abs

    def act(h):
        acts.append(h.detach())
        return (F.leaky_relu(h, 0.1) if given is None
                else torch.where(next(given[0]), h, 0.1 * h))

    def l1(d):
        diffs.append(d.detach())
        return (absolute(d) if given is None
                else torch.where(next(given[1]), d, -d))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dd, "_act", act)
        mp.setattr(torch, "abs", l1)
        out = disc(torch.from_numpy(x).to(dtype), torch.from_numpy(y).to(dtype))
    return out[:2], (acts, diffs)


def _grads(disc, losses):
    params = list(disc.parameters())
    return [[g.double().numpy() for g in torch.autograd.grad(
        loss, params, retain_graph=True)] for loss in losses]


@pytest.mark.parametrize("draw", range(6))
def test_gradients_against_float64_through_the_same_kinks(jax_kinks, draw):
    jdisc, jax_steps = jax_kinks
    x, y = _signals(3)
    variables = _random_variables(jdisc, draw, x, y)

    def port(dtype):
        disc = dd.DescriptDiscriminator(**KW)
        load_discriminator(disc, variables)
        return disc.to(dtype)
    f32, f64 = port(torch.float32), port(torch.float64)
    names = [n for n, _ in f32.named_parameters()]
    jax_out = jax_steps(variables["params"])
    jax_grads = []
    for _, g in jax_out:
        theirs = dd.DescriptDiscriminator(**KW)
        load_discriminator(theirs, {"params": jax.tree_util.tree_map(
            np.asarray, g)})
        jax_grads.append([t.detach().double().numpy()
                          for t in theirs.parameters()])
    losses, port_values = _port_kinks(f32, x, y, torch.float32)
    port_grads = _grads(f32, losses)
    _, exact = _port_kinks(f64, x, y, torch.float64)
    runs = [("port", which, [[v > 0 for v in values]
                             for values in port_values], port_grads[which])
            for which in (0, 1)]
    runs += [("jax", which, [[torch.from_numpy(_fmaps_ncw(v) > 0)
                              for v in values] for values in kinks],
              jax_grads[which])
             for which, ((_, kinks), _) in enumerate(jax_out)]
    for package, which, sides, grads in runs:
        for kind, given, values in zip(("act", "l1"), sides, exact):
            assert len(given) == len(values), (package, kind)
            for i, (side, v) in enumerate(zip(given, values)):
                parted = (side != (v > 0)) & (v != 0)
                if parted.any():
                    assert (v[parted].abs().max()
                            <= 1e-5 * v.abs().max()), (package, kind, i)
        witness, = _grads(f64, _port_kinks(f64, x, y, torch.float64,
                                           sides)[0][which:which + 1])
        floor = 1e-5 * max(np.abs(t).max() for t in witness)
        for name, g, t in zip(names, grads, witness):
            err = np.abs(g - t).max()
            assert err <= 1e-4 * np.abs(t).max() + floor, (
                    package, which, name, err)


def test_batched_equals_split(pair):
    _, _, disc, x, y = pair
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        split = disc(xt, yt)
        batched = disc(xt, yt, batched=True)
    for a, b in zip(split[:2], batched[:2]):
        np.testing.assert_allclose(a.item(), b.item(), rtol=1e-6)
    for k in split[2]:
        np.testing.assert_allclose(split[2][k].item(), batched[2][k].item(),
                                   rtol=1e-6, atol=1e-8, err_msg=k)


def test_loader_uses_every_variable_and_checks_shapes(pair):
    _, variables, disc, _, _ = pair
    params = variables["params"]
    # flax numbers the wrapped convs across all bands of a scope
    assert "Conv_25/kernel/scale" in params["mrd_64"]["conv_post"]
    assert "Conv_5/kernel/scale" in params["mpd_3"]["conv_post"]
    assert "Conv_6/kernel/scale" in params["msd_2"]["conv_post"]
    bad = jax.tree_util.tree_map(lambda v: v, variables)
    bad["params"]["mrd_64"]["band1_conv_2"]["extra"] = np.zeros(1)
    with pytest.raises(ValueError, match="no place in the port"):
        load_discriminator(disc, bad)
    bad = jax.tree_util.tree_map(lambda v: v, variables)
    del bad["params"]["msd_2"]["Conv_3"]
    with pytest.raises(KeyError):
        load_discriminator(disc, bad)
    bad = jax.tree_util.tree_map(lambda v: v, variables)
    bad["params"]["mpd_5"] = bad["params"]["mpd_3"]
    with pytest.raises(ValueError, match="no place in the port"):
        load_discriminator(disc, bad)
    bad = jax.tree_util.tree_map(lambda v: v, variables)
    bad["params"]["mpd_3"]["Conv_1"]["kernel"] = np.zeros((5, 1, 32, 64))
    with pytest.raises(ValueError, match="shape"):
        load_discriminator(disc, bad)
    from after_tpu_torch.utils.init import init_weights
    fresh = dd.DescriptDiscriminator(**KW)
    init_weights(fresh, 0)
    load_discriminator(fresh, variables)
    for a, b in zip(fresh.parameters(), disc.parameters()):
        assert torch.equal(a, b)


def test_trainer_builds_the_configured_discriminator():
    cfg = DiscriminatorConfig(kind="descript", descript_periods=(2, 5),
                              descript_fft_sizes=(256,),
                              descript_weight_feature_matching=3.0,
                              descript_weight_adversarial=0.5)
    disc = make_discriminator(cfg)
    assert isinstance(disc, dd.DescriptDiscriminator)
    assert [n for n, _ in disc.named_children()] == ["mpd_2", "mpd_5",
                                                     "mrd_256"]
    assert (disc.weight_feature_matching, disc.weight_adversarial) == (3.0,
                                                                       0.5)
    from after_tpu_torch.models.discriminator import EncodecDiscriminator
    assert isinstance(make_discriminator(DiscriminatorConfig()),
                      EncodecDiscriminator)


def test_codec_checkpoint_keeps_the_descript_discriminator():
    """A codec trainer with the descript discriminator saves it in its
    state tree and a fresh trainer restores it, optimizer state with it."""
    from after_tpu_torch.autoencoder import AutoencoderTrainer
    from after_tpu_torch.config import AETrainConfig, AutoEncoderConfig
    ae = AutoEncoderConfig(pqmf_bands=4, z_channels=8, base_channels=8,
                           multipliers=(1, 2, 2), factors=(2, 2),
                           dilations=(1, 3), num_blocks_per_stage=1,
                           use_noise=True)
    tc = AETrainConfig(num_signal=2048, warmup_steps=0,
                       stft_fft_sizes=(256, 64), stft_hop_sizes=(64, 16),
                       stft_win_lengths=(256, 64))
    dc = DiscriminatorConfig(kind="descript", descript_periods=(2,),
                             descript_fft_sizes=(128,))
    tr = AutoencoderTrainer(ae, tc, dc, device="cpu").init(0)
    x = (0.1 * np.random.RandomState(9).randn(1, 2048, 1)).astype(
        np.float32)
    assert all(np.isfinite(float(v)) for v in tr.disc_step(x).values())
    tree = tr.state_tree()
    other = AutoencoderTrainer(ae, tc, dc, device="cpu")
    other.load_state_tree(tree)
    for a, b in zip(tr.disc.parameters(), other.disc.parameters()):
        assert torch.equal(a, b)
    assert int(other.disc_optimizer.count) == 1
