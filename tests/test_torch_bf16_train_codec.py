"""The port's codec trainer at bf16 against the JAX trainer at bf16.

The micro codec, discriminator, batch, weights and bottleneck noise of
tests/test_torch_ae_trainer.py.  The JAX trainer runs each step three ways
from the same f32 weights: in f32, with ``compute_dtype="bfloat16"``, and
with ``compute_dtype="bfloat16"`` and ``stft_bf16_dft=True``; its gradients
are read with identity optimizers and ``optax.apply_updates`` patched, as
there.  The port runs the bf16 steps: a warm-up generator step, a GAN
generator step and a discriminator step at bf16, and a GAN generator step
with ``stft_bf16_dft`` as well.

Tolerance: the bf16 rule of tests/test_torch_precision.py: the port's bf16
result no farther from the JAX f32 one than twice the JAX bf16 result is,
plus 1e-6 of the JAX f32 result's scale; for every metric, and for each
model's gradient taken whole (all its parameters' gradients as one tensor,
its largest gradient as the scale).  Not tensor by tensor: at this size a
bf16 rounding of the input alone moves some tensors' f32 gradients by up to
2.1 x their own max in either package (the conv biases and gains before a
one-channel GroupNorm, whose gradients are zero in exact arithmetic, and
the MR-STFT's log magnitudes of near-silent bins), so tensor by tensor the
rule would compare two draws of rounding noise.  The warm-up step's
gradient is that noise as a whole: the JAX bf16 step's own gradient has a
cosine of 0.17-0.33 with its f32 one (three draws of the weights 1e-6
apart), the port's 0.10-0.32; its metrics are held by the rule, and its
gradients are held to be finite f32 tensors of the GAN step's code path,
which the GAN step holds by the rule.

The masters: after a generator and a discriminator step at bf16 both
models' parameters and both optimizers' states are f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from after_tpu import config as jax_config
from after_tpu.autoencoder import AutoencoderTrainer as JaxTrainer
from after_tpu_torch import config as port_config
from after_tpu_torch.autoencoder import AutoencoderTrainer
from after_tpu_torch.models.autoencoder import AudioCodec
from after_tpu_torch.models.discriminator import EncodecDiscriminator
from after_tpu_torch.utils.from_jax import load_discriminator, load_module
from tests.torch_bf16_train_common import bf16_close

AE = dict(pqmf_bands=4, z_channels=8, base_channels=8, multipliers=(1, 2, 2),
          factors=(2, 2), dilations=(1, 3), num_blocks_per_stage=1)
TC = dict(num_signal=2048, warmup_steps=2, update_discriminator_every=2,
          stft_fft_sizes=(256, 64), stft_hop_sizes=(64, 16),
          stft_win_lengths=(256, 64))
DC = dict(filters=4, n_ffts=(206,), hop_lengths=(103,), win_lengths=(206,))
GAN_STEP = 3
BF16 = dict(compute_dtype="bfloat16")
BF16_DFT = dict(compute_dtype="bfloat16", stft_bf16_dft=True)


def _perturbed_numpy(variables, seed):
    rng = np.random.RandomState(seed)

    def f(v):
        v = np.asarray(v, dtype=np.float32)
        return (v * (1 + 0.2 * rng.uniform(-1, 1, v.shape))
                + 0.02 * rng.randn(*v.shape)).astype(np.float32)
    return jax.tree_util.tree_map(f, variables)


def _configs(package, **train):
    return (package.AutoEncoderConfig(**AE),
            package.AETrainConfig(**TC, **train),
            package.DiscriminatorConfig(**DC))


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX trainer's warm-up, GAN and discriminator steps in f32, at
    bf16 and at bf16 with the bf16 DFT, from the same weights, batch and
    noise: {(mode, kind): (metrics, gradients)}, with the weights, batch,
    noise and the generator steps' loss weights."""
    krng = jax.random.split(jax.random.PRNGKey(0))[1]
    ratio = port_config.AutoEncoderConfig(**AE).ratio
    noise = np.array(jax.random.normal(
        krng, (1, TC["num_signal"] // ratio, AE["z_channels"])))
    x = (0.1 * np.random.RandomState(3).randn(1, TC["num_signal"], 1)
         ).astype(np.float32)
    out, weights = {}, {}
    variables = None
    for mode, train in (("f32", {}), ("bf16", BF16), ("dft", BF16_DFT)):
        jtr = JaxTrainer(*_configs(jax_config, **train))
        identity = optax.apply_if_finite(optax.identity(), 10000)
        jtr.optimizer = jtr.disc_optimizer = identity
        state = jtr.init(jax.random.PRNGKey(0), 1)
        if variables is None:
            variables = (_perturbed_numpy(state.codec_vars, 1),
                         _perturbed_numpy(state.disc_vars, 2))
        codec_vars, disc_vars = variables

        def fresh(opt_state):
            # the steps donate their state: each gets its own copy
            return jax.tree_util.tree_map(
                lambda a: jnp.array(a, copy=True),
                (codec_vars, disc_vars, opt_state))
        kinds = (("warmup", False, 0), ("gan", True, GAN_STEP))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(optax, "apply_updates", lambda params, updates: updates)
            for name, use_gan, step in kinds[1:] if mode == "dft" else kinds:
                w = jtr._recon_weights(step)
                weights[name] = w
                (g, _, _), m = jtr.gen_step(fresh(state.opt_state),
                                            jnp.asarray(x), krng, use_gan, *w)
                out[mode, name] = (m, g["params"])
            if mode != "dft":
                (_, g, _), m = jtr.disc_step(fresh(state.disc_opt_state),
                                             jnp.asarray(x), krng)
                out[mode, "disc"] = (m, g["params"])
    out = jax.tree_util.tree_map(np.asarray, out)
    return variables, x, noise, weights, out


def _port(variables, **train):
    return AutoencoderTrainer(*_configs(port_config, **train),
                              device="cpu").load_jax(*variables)


def _grads(module, load, jax_grads):
    """The JAX gradients loaded into a fresh module of the port's kind
    (the loader's layout changes are linear), by parameter name."""
    load(module, {"params": jax_grads})
    return [(n, p.detach().numpy()) for n, p in module.named_parameters()]


def _check(jax_steps, mode, kind, metrics, grads, whole=True):
    """Metrics by the bf16 rule; the gradients f32 and finite, and with
    ``whole`` the model's gradient by the rule as one tensor."""
    *_, out = jax_steps
    m32, g32 = out["f32", kind]
    m16, g16 = out[mode, kind]
    m16 = dict(m16)
    assert m16.pop("skipped_nonfinite", 0) == 0
    assert set(metrics) == set(m16), (sorted(metrics), sorted(m16))
    for k in m16:
        bf16_close(k, float(metrics[k]), m16[k], m32[k])
    if kind == "disc":
        make, load = (lambda: EncodecDiscriminator(
            port_config.DiscriminatorConfig(**DC))), load_discriminator
    else:
        make, load = (lambda: AudioCodec(port_config.AutoEncoderConfig(
            **AE))), (lambda m, v: load_module(m, v, "codec"))
    named32, named16 = _grads(make(), load, g32), _grads(make(), load, g16)
    assert len(named32) == len(grads)
    for (name, t32), ours in zip(named32, grads):
        assert ours.dtype == torch.float32, name
        assert ours.shape == t32.shape, name
        assert torch.isfinite(ours).all(), name
    if whole:
        bf16_close(f"{kind} gradient",
                   np.concatenate([g.numpy().ravel() for g in grads]),
                   np.concatenate([t.ravel() for _, t in named16]),
                   np.concatenate([t.ravel() for _, t in named32]))


@pytest.mark.parametrize("mode,kind", [("bf16", "warmup"), ("bf16", "gan"),
                                       ("dft", "gan")])
def test_generator_step_matches_jax(jax_steps, mode, kind):
    variables, x, noise, weights, _ = jax_steps
    tr = _port(variables, **(BF16 if mode == "bf16" else BF16_DFT))
    w_wave, w_reg = weights[kind]
    metrics, grads = tr.gen_grads(x, kind == "gan", float(w_wave),
                                  float(w_reg), noise)
    _check(jax_steps, mode, kind, metrics, grads, whole=kind == "gan")


def test_discriminator_step_matches_jax(jax_steps):
    variables, x, noise, _, _ = jax_steps
    metrics, grads = _port(variables, **BF16).disc_grads(x, noise)
    _check(jax_steps, "bf16", "disc", metrics, grads)


def test_masters_and_optimizer_states_stay_f32(jax_steps):
    """A warm-up, a GAN and a discriminator step at bf16 update the f32
    masters in place: every parameter and both optimizers' moments stay
    f32, each step moves the model it trains, and the state tree (the
    checkpoint) holds f32 tensors."""
    variables, x, noise, _, _ = jax_steps
    tr = _port(variables, **BF16)
    for step, kind in ((0, "warmup"), (GAN_STEP, "gan"), (None, "disc")):
        model = tr.disc if kind == "disc" else tr.codec
        before = [p.detach().clone() for p in model.parameters()]
        if kind == "disc":
            metrics = tr.disc_step(x, noise)
        else:
            metrics = tr.gen_step(x, kind == "gan",
                                  *tr._recon_weights(step), noise)
            assert int(metrics["skipped_nonfinite"]) == 0
        assert all(torch.isfinite(v).all() for v in metrics.values())
        assert not all(torch.equal(a, b)
                       for a, b in zip(before, model.parameters())), kind
    for model in (tr.codec, tr.disc):
        assert all(p.dtype == torch.float32 for p in model.parameters())
    for opt in (tr.optimizer, tr.disc_optimizer):
        assert opt._mu.dtype == opt._nu.dtype == torch.float32
    tree = tr.state_tree()
    for key in ("codec_vars", "disc_vars"):
        assert all(v.dtype == torch.float32 for v in tree[key].values()
                   if v.is_floating_point())


@pytest.mark.parametrize("k,d,mode", [(3, 9, "causal"), (1, 1, "centered"),
                                      (3, 3, "centered")])
def test_plain_bf16_backward_is_autograd_with_the_same_roundings(k, d, mode):
    """The op's plain bf16 backward (its CPU kernel) against autograd in
    float64 through the plain bf16 forward with the same roundings (the
    activation rounded to bf16 for the product, its derivative taken
    unrounded), each gradient rounded to bf16 once: within 1 bf16 ulp of
    each gradient's max |g| (f32 against float64 sums may round the other
    way); and the op's registered gradient on bf16 CPU tensors is that
    plain backward, bit for bit."""
    from after_tpu_torch.ops.kernels.fused_conv import (
        _conv, kernel_weight, snake_conv, snake_conv_backward_reference,
        torch_weight)
    from after_tpu_torch.ops.snake import snake_beta

    rng = np.random.RandomState(k + d)
    B, T, C, O = 2, 37, 12, 10
    bf = torch.bfloat16
    x, g = (torch.tensor(rng.randn(*s), dtype=bf) for s in ((B, T, C),
                                                             (B, T, O)))
    alpha, beta = (torch.tensor(rng.rand(C) + 0.5, dtype=bf)
                   for _ in range(2))
    w_k = kernel_weight(torch.tensor(0.3 * rng.randn(O, C, k), dtype=bf))[0]
    b = torch.tensor(rng.randn(O), dtype=bf)
    plain = snake_conv_backward_reference(g, x, alpha, beta, w_k, b, d, mode,
                                          [True] * 5)
    leaves = [t.double().requires_grad_() for t in (x, alpha, beta, w_k, b)]
    a = snake_beta(*leaves[:3])
    a = a + (a.to(bf).double() - a).detach()
    y = _conv(a, torch_weight(leaves[3], C), leaves[4], d, mode)
    want = torch.autograd.grad(y, leaves, g.double())
    for name, ours, r in zip("x alpha beta w b".split(), plain, want):
        assert ours.dtype == bf, name
        r = r.to(bf).double()
        ulp = 2.0 ** (np.floor(np.log2(r.abs().max().item())) - 7)
        assert (ours.double() - r).abs().max().item() <= ulp, name
    inputs = [t.clone().requires_grad_() for t in (x, alpha, beta, w_k, b)]
    out = snake_conv(*inputs[:4], w_k.new_empty(0), inputs[4], d, mode)
    got = torch.autograd.grad(out, inputs, g)
    for name, ours, p in zip("x alpha beta w b".split(), got, plain):
        assert torch.equal(ours, p), name


def test_bf16_dft_stft_matches_jax():
    """``stft(..., dft_dtype=torch.bfloat16)`` against the JAX package's
    ``stft(..., dft_dtype=jnp.bfloat16)``: the same bf16-rounded operands,
    exact products, f32 sums in another order: within 1e-5 of max |z|; a
    transform longer than 4096 takes the FFT in both."""
    from after_tpu.ops import stft as jax_stft
    from after_tpu_torch.ops import stft as port_stft

    x = np.random.RandomState(9).randn(2, 12000).astype(np.float32)
    for n_fft, hop, win in ((256, 64, 256), (64, 16, 48), (8192, 2048, 8192)):
        theirs = np.asarray(jax_stft.stft(jnp.asarray(x), n_fft, hop, win,
                                          center=False,
                                          dft_dtype=jnp.bfloat16))
        ours = port_stft.stft(torch.from_numpy(x), n_fft, hop, win,
                              center=False, dft_dtype=torch.bfloat16).numpy()
        assert ours.shape == theirs.shape
        assert np.abs(ours - theirs).max() <= 1e-5 * np.abs(theirs).max()
