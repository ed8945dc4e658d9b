"""The port's codec trainer against the JAX trainer.

A micro codec (4 PQMF bands, 8 base channels, two stages), MR-STFT at
(256, 64) and one discriminator scale (n_fft 206, 4 filters) on 2048-sample
batches.  The JAX trainer's weights, perturbed so that every weight-norm,
snake, norm and scale parameter is non-trivial, are carried into the port
with utils.from_jax; the bottleneck noise is drawn in JAX as ``fit`` draws
it and handed to the port.

The JAX steps' gradients are read by running them with an identity
optimizer whose "update" replaces the parameters (``optax.apply_updates``
patched for the duration), so they come from the JAX trainer's own loss.

Tolerances: metrics rtol 1e-4; each parameter's gradient within 1e-3 x
max |g| of its tensor, or of 1e-3 x the largest gradient of the model where
that is more (f32 on both sides; the port's STFT is an FFT where the JAX
package multiplies by DFT matrices, and the sums run in other orders; with
8 channels and 8 groups the GroupNorm after a conv makes that conv's bias
and g gradients zero in exact arithmetic, so theirs are rounding noise);
the optimizer's parameters within 1e-6.

The same generator (GAN) and discriminator steps run on a codec with the
decoder's NoiseGenerator (``use_noise``) and the descript discriminator at
one period (3) and one FFT size (128), on 4096-sample batches, at the same
tolerances.  The decoder's uniform draw is the one the JAX steps take from
``fold_in(rng, 1)``, read where the JAX NoiseGenerator makes it.  There
the generator step's metrics are held at the GAN weights, and its
gradients at the GAN weights with the MR-STFT's weight 0 (the
discriminator's terms, the regularisation and the noise branch): with
the MR-STFT's log-magnitude term the f32 gradients of either package are
not resolved to 1e-3 at this size (its 1 / |Y| on the reconstruction's
near-silent bins; test_descript_noise_step_conditioning holds the port's
f32 against its float64 without that term).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from after_tpu import config as jax_config
from after_tpu.autoencoder import AutoencoderTrainer as JaxTrainer
from after_tpu_torch import config as port_config
from after_tpu_torch.autoencoder import AdamW, AutoencoderTrainer
from after_tpu_torch.autoencoder.trainer import make_discriminator
from after_tpu_torch.models.autoencoder import AudioCodec
from after_tpu_torch.utils.from_jax import load_discriminator, load_module

AE = dict(pqmf_bands=4, z_channels=8, base_channels=8, multipliers=(1, 2, 2),
          factors=(2, 2), dilations=(1, 3), num_blocks_per_stage=1)
TC = dict(num_signal=2048, warmup_steps=2, update_discriminator_every=2,
          stft_fft_sizes=(256, 64), stft_hop_sizes=(64, 16),
          stft_win_lengths=(256, 64))
DC = dict(filters=4, n_ffts=(206,), hop_lengths=(103,), win_lengths=(206,))
# the codec with its NoiseGenerator and the descript discriminator
NOISE_AE = dict(AE, use_noise=True)
NOISE_TC = dict(TC, num_signal=4096)
DESCRIPT_DC = dict(kind="descript", descript_periods=(3,),
                   descript_fft_sizes=(128,))
GAN_STEP = 3
METRIC_RTOL = 1e-4
GRAD_TOL = 1e-3


def _perturbed_numpy(variables, seed):
    rng = np.random.RandomState(seed)

    def f(v):
        v = np.asarray(v, dtype=np.float32)
        return (v * (1 + 0.2 * rng.uniform(-1, 1, v.shape))
                + 0.02 * rng.randn(*v.shape)).astype(np.float32)
    return jax.tree_util.tree_map(f, variables)


def _configs(package, ae=AE, tc=TC, dc=DC):
    return (package.AutoEncoderConfig(**ae), package.AETrainConfig(**tc),
            package.DiscriminatorConfig(**dc))


def _jax_steps(configs, kinds):
    """The JAX trainer's steps ``kinds`` (of "warmup", "gan", "disc") from
    the same weights and batch: their metrics and gradients, with the
    weights, batch, bottleneck noise and the decoder's uniform draw (None
    for a codec without use_noise)."""
    ae, tc, _ = configs(jax_config)
    jtr = JaxTrainer(*configs(jax_config))
    identity = optax.apply_if_finite(optax.identity(), 10000)
    jtr.optimizer = jtr.disc_optimizer = identity
    state = jtr.init(jax.random.PRNGKey(0), 1)
    codec_vars = _perturbed_numpy(state.codec_vars, 1)
    disc_vars = _perturbed_numpy(state.disc_vars, 2)
    x = (0.1 * np.random.RandomState(3).randn(1, tc.num_signal, 1)
         ).astype(np.float32)
    # the key of fit's first step
    _, krng = jax.random.split(jax.random.PRNGKey(0))
    noise = np.array(jax.random.normal(
        krng, (1, tc.num_signal // ae.ratio, ae.z_channels)))
    w_wave, w_reg = jtr._recon_weights(GAN_STEP)
    weights = {"warmup": jtr._recon_weights(0), "gan": (w_wave, w_reg),
               "gan_adversarial": (0.0, w_reg)}

    def fresh(opt_state):
        # the steps donate their state: each gets its own copy
        return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                      (codec_vars, disc_vars, opt_state))

    out, draws = {}, []
    uniform = jax.random.uniform

    def recorded(key, shape=(), dtype=float, minval=0.0, maxval=1.0):
        # the only uniform draw of a step: the NoiseGenerator's
        u = uniform(key, shape, dtype, minval, maxval)
        jax.debug.callback(lambda v: draws.append(np.array(v)), u)
        return u
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax, "apply_updates", lambda params, updates: updates)
        mp.setattr(jax.random, "uniform", recorded)
        for kind in kinds:
            if kind == "disc":
                (_, g, _), m = jtr.disc_step(fresh(state.disc_opt_state),
                                             jnp.asarray(x), krng)
                out[kind] = (m, g["params"], None)
                continue
            (g, _, _), m = jtr.gen_step(fresh(state.opt_state),
                                        jnp.asarray(x), krng, kind != "warmup",
                                        *weights[kind])
            out[kind] = (m, g["params"], weights[kind])
    out = jax.tree_util.tree_map(np.asarray, out)
    decoder_noise = None
    if ae.use_noise:
        # every step takes the same draw: its key is fold_in(krng, 1)
        assert len(draws) == len(kinds)
        assert all(np.array_equal(d, draws[0]) for d in draws)
        decoder_noise = draws[0]
    else:
        assert not draws
    return codec_vars, disc_vars, x, noise, decoder_noise, out


@pytest.fixture(scope="module")
def jax_steps():
    """One warm-up generator step, one GAN generator step and one
    discriminator step of the JAX trainer (Encodec, no decoder noise)."""
    return _jax_steps(_configs, ("warmup", "gan", "disc"))


def _descript_configs(package):
    return _configs(package, NOISE_AE, NOISE_TC, DESCRIPT_DC)


@pytest.fixture(scope="module")
def jax_descript_steps():
    """One GAN generator step (at the GAN weights, and with the MR-STFT's
    weight 0) and one discriminator step of the JAX trainer with the
    decoder's NoiseGenerator and the descript discriminator."""
    return _jax_steps(_descript_configs, ("gan", "gan_adversarial", "disc"))


def _port(configs, steps):
    codec_vars, disc_vars, *_ = steps
    return AutoencoderTrainer(*configs(port_config), device="cpu").load_jax(
        codec_vars, disc_vars)


@pytest.fixture(scope="module")
def port_trainer(jax_steps):
    return _port(_configs, jax_steps)


@pytest.fixture(scope="module")
def port_descript_trainer(jax_descript_steps):
    return _port(_descript_configs, jax_descript_steps)


def _check_metrics(ours, theirs):
    assert set(ours) == set(theirs), (sorted(ours), sorted(theirs))
    for k, v in theirs.items():
        np.testing.assert_allclose(float(ours[k]), float(v),
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=k)


def _check_grads(module, grads, jax_grads, load):
    """The JAX gradients, loaded into a fresh module of the port's kind
    (the loader's layout changes are linear), against ours by name."""
    load(module, {"params": jax_grads})
    named = [(n, p.detach().numpy()) for n, p in module.named_parameters()]
    assert len(named) == len(grads)
    floor = GRAD_TOL * max(np.abs(g).max() for _, g in named)
    for (name, theirs), ours in zip(named, grads):
        err = np.abs(ours.numpy() - theirs).max()
        assert err <= GRAD_TOL * max(np.abs(theirs).max(), floor), (name, err)


def _steps(request, descript):
    if descript:
        return (request.getfixturevalue("jax_descript_steps"),
                request.getfixturevalue("port_descript_trainer"))
    return (request.getfixturevalue("jax_steps"),
            request.getfixturevalue("port_trainer"))


@pytest.mark.parametrize("kind", ["warmup", "gan", "descript_noise_gan"])
def test_generator_step_matches_jax(request, kind):
    """The step's metrics and gradients; for the descript discriminator
    and the noise decoder, the metrics at the GAN weights and the
    gradients with the MR-STFT's weight 0 (the module docstring)."""
    descript = kind.startswith("descript")
    (_, _, x, noise, decoder_noise, out), port_trainer = _steps(request,
                                                                descript)
    kind = kind.rsplit("_", 1)[-1]
    for step, check in ((kind, "metrics"), ("gan_adversarial", "grads")
                        ) if descript else ((kind, "both"),):
        jax_metrics, jax_grads, (w_wave, w_reg) = out[step]
        metrics, grads = port_trainer.gen_grads(
            x, step != "warmup", float(w_wave), float(w_reg), noise,
            decoder_noise)
        jax_metrics = dict(jax_metrics)
        assert jax_metrics.pop("skipped_nonfinite") == 0
        if check != "grads":
            _check_metrics(metrics, jax_metrics)
        if check != "metrics":
            _check_grads(AudioCodec(port_trainer.cfg), grads, jax_grads,
                         lambda m, v: load_module(m, v, "codec"))


def test_descript_noise_step_conditioning(jax_descript_steps,
                                          monkeypatch):
    """Why the descript and noise generator step's gradients are held with
    the MR-STFT's weight 0: at the GAN weights but without the MR-STFT's
    log-magnitude term, the port's f32 gradients stand within GRAD_TOL x
    max |g| (with the floor) of its float64 ones, the snake+conv's plain
    version in float64 for the kernel."""
    from after_tpu_torch.models.autoencoder import ConvBlock1d
    from after_tpu_torch.ops.kernels.fused_conv import snake_conv_reference
    _, _, x, noise, decoder_noise, out = jax_descript_steps
    _, _, (w_wave, w_reg) = out["gan"]

    def grads(dtype):
        tr = _port(_descript_configs, jax_descript_steps)
        tr.tc = dataclasses.replace(tr.tc, stft_w_log_mag=0.0)
        if dtype == torch.float64:
            tr.codec.double()
            tr.disc.double()
            monkeypatch.setattr(tr, "_tensor", lambda a: torch.as_tensor(
                a, dtype=torch.float64))
        return [g.double().numpy() for g in tr.gen_grads(
            x, True, float(w_wave), float(w_reg), noise, decoder_noise)[1]]

    ours = grads(torch.float32)

    def plain(self, h, cache=None):
        h = self.gn(h, cache) if self.gn is not None else h
        return snake_conv_reference(
            h.contiguous(), self.act.alpha, self.act.beta,
            self.conv.effective_weight(), self.conv.bias, self.conv.dilation,
            self.conv.mode)
    monkeypatch.setattr(ConvBlock1d, "forward", plain)
    exact = grads(torch.float64)
    floor = GRAD_TOL * max(np.abs(g).max() for g in exact)
    for i, (a, e) in enumerate(zip(ours, exact)):
        err = np.abs(a - e).max()
        assert err <= GRAD_TOL * max(np.abs(e).max(), floor), (i, err)


def _check_discriminator_step(steps, port_trainer):
    _, _, x, noise, decoder_noise, out = steps
    jax_metrics, jax_grads, _ = out["disc"]
    metrics, grads = port_trainer.disc_grads(x, noise, decoder_noise)
    _check_metrics(metrics, jax_metrics)
    _check_grads(make_discriminator(port_trainer.dcfg), grads, jax_grads,
                 load_discriminator)


def test_discriminator_step_matches_jax(jax_steps, port_trainer):
    _check_discriminator_step(jax_steps, port_trainer)


def test_descript_noise_discriminator_step_matches_jax(
        jax_descript_steps, port_descript_trainer):
    """The discriminator step with the decoder's NoiseGenerator and the
    descript discriminator."""
    _check_discriminator_step(jax_descript_steps, port_descript_trainer)


def test_optimizer_update_rule_matches_optax():
    """The same gradients into the port's AdamW and into the JAX trainer's
    optax chains (apply_if_finite(clip + adamw with exponential decay)), at
    a large learning rate and decay so that each term shows: an ordinary
    step, one that clips, one whose gradients are not finite (skipped:
    parameters, moments and schedule kept), and two more."""
    tc = dataclasses.replace(jax_config.AETrainConfig(**TC), lr=1e-2,
                             lr_decay=0.9)
    jtr = JaxTrainer(jax_config.AutoEncoderConfig(**AE), tc,
                     jax_config.DiscriminatorConfig(**DC))
    rng = np.random.RandomState(4)
    shapes = [(3, 4, 2), (5,), (7, 1)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    scales = [0.1, 50.0, np.nan, 0.3, 1.0]      # 50: clipped; nan: skipped
    for jax_opt, (b1, b2, clip) in ((jtr.optimizer, (0.9, 0.999, tc.grad_clip)),
                                    (jtr.disc_optimizer,
                                     (0.8, 0.9, tc.grad_clip_disc))):
        ours = [torch.from_numpy(p.copy()) for p in params]
        opt = AdamW(ours, tc.lr, tc.lr_decay, b1, b2, clip)
        theirs = [jnp.asarray(p) for p in params]
        state = jax_opt.init(theirs)
        for i, scale in enumerate(scales):
            grads = [(scale * rng.randn(*s)).astype(np.float32)
                     for s in shapes]
            updates, state = jax_opt.update([jnp.asarray(g) for g in grads],
                                            state, theirs)
            theirs = optax.apply_updates(theirs, updates)
            applied = opt.step([torch.from_numpy(g) for g in grads])
            assert applied == np.isfinite(scale)
            assert opt.total_notfinite == int(state.total_notfinite)
            for a, b in zip(ours, theirs):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=0, atol=1e-6, err_msg=str(i))
        assert opt.count == len(scales) - 1


def test_fit_runs_the_schedule_of_step_kinds():
    """warmup_steps 2 and a discriminator step every 2: steps 0-2 warm-up
    generator steps, then GAN generator and discriminator steps by turns,
    as the JAX fit branches (step > warmup_steps, step % every == 0)."""
    ae, tc, dc = _configs(port_config)
    tr = AutoencoderTrainer(ae, tc, dc, device="cpu").init(0)
    expected = []
    for step in range(7):
        warm = step > tc.warmup_steps
        expected.append("disc" if warm and step % tc.update_discriminator_every
                        == 0 else "gan" if warm else "warmup")
    assert [tr.step_kind(s) for s in range(7)] == expected
    log = []
    rng = np.random.RandomState(5)
    batches = ((0.1 * rng.randn(1, TC["num_signal"], 1)).astype(np.float32)
               for _ in range(10))
    codec0 = [p.detach().clone() for p in tr.codec.parameters()]
    tr.fit(batches, max_steps=7, callback=lambda t, m: log.append(
        (t.step, {k: float(v) for k, v in m.items()})))
    assert [s for s, _ in log] == list(range(1, 8))
    seen = ["disc" if "discriminator" in m else
            "gan" if "feature_matching" in m else "warmup" for _, m in log]
    assert seen == expected
    for _, m in log:
        assert all(np.isfinite(v) for v in m.values())
        assert m.get("skipped_nonfinite", 0) == 0
    assert tr.optimizer.count == expected.count("warmup") + expected.count(
        "gan")
    assert tr.disc_optimizer.count == expected.count("disc")
    assert not all(torch.equal(a, b) for a, b in zip(
        codec0, tr.codec.parameters()))
    losses, (x, y) = tr.validate(
        [(0.1 * rng.randn(1, TC["num_signal"], 1)).astype(np.float32)])
    assert x.shape == y.shape
    assert set(losses) == {"val_mrstft", "val_regularisation_loss",
                           "val_total_loss"}


def test_step_metrics_keep_their_count_of_skipped_updates():
    """Each generator step's skipped_nonfinite is that step's count: two
    finite steps' metrics still read 0 after a NaN batch is skipped."""
    ae, tc, dc = _configs(port_config)
    tr = AutoencoderTrainer(ae, tc, dc, device="cpu").init(0)
    x = (0.1 * np.random.RandomState(6).randn(1, TC["num_signal"], 1)
         ).astype(np.float32)
    kept = [tr.gen_step(x, False, 1.0, 0.1) for _ in range(2)]
    skipped = tr.gen_step(np.full_like(x, np.nan), False, 1.0, 0.1)
    assert [int(m["skipped_nonfinite"]) for m in kept] == [0, 0]
    assert int(skipped["skipped_nonfinite"]) == 1
    assert int(tr.optimizer.count) == 2


@pytest.mark.parametrize("package_kind", ["ae", "train", "disc"])
def test_codec_configs_share_the_json_form(package_kind):
    import json
    if package_kind == "ae":
        assert (port_config.ae_to_json(port_config.get_ae_config())
                == jax_config.ae_to_json(jax_config.get_ae_config()))
        over = dict(bottleneck="vae", multipliers=(1, 2))
        s = port_config.ae_to_json(port_config.get_ae_config(**over))
        assert s == jax_config.ae_to_json(jax_config.get_ae_config(**over))
        assert port_config.ae_from_json(s) == port_config.get_ae_config(**over)
        return
    cls = {"train": "AETrainConfig", "disc": "DiscriminatorConfig"}[
        package_kind]
    ours = dataclasses.asdict(getattr(port_config, cls)())
    theirs = dataclasses.asdict(getattr(jax_config, cls)())
    assert json.dumps(ours) == json.dumps(theirs)


def test_load_codec_config(tmp_path):
    cfg = port_config.get_ae_config(z_channels=16)
    assert port_config.load_codec_config(str(tmp_path)) == \
        port_config.AutoEncoderConfig()
    (tmp_path / "config.json").write_text(jax_config.ae_to_json(
        jax_config.get_ae_config(z_channels=16)))
    assert port_config.load_codec_config(str(tmp_path)) == cfg


def test_trainer_refuses_what_is_not_ported():
    """The descript discriminator and the decoder's NoiseGenerator, which
    the trainer refused until they were ported, build; decoder noise given
    to a codec without use_noise raises."""
    from after_tpu_torch.models.autoencoder import NoiseGenerator
    from after_tpu_torch.models.descript_discriminator import \
        DescriptDiscriminator
    ae, tc, dc = _configs(port_config)
    tr = AutoencoderTrainer(ae, tc, dataclasses.replace(dc, kind="descript"),
                            device="cpu")
    assert isinstance(tr.disc, DescriptDiscriminator)
    tr = AutoencoderTrainer(dataclasses.replace(ae, use_noise=True), tc, dc,
                            device="cpu")
    assert isinstance(tr.codec.decoder.noise, NoiseGenerator)
    tr = AutoencoderTrainer(ae, tc, dc, device="cpu").init(0)
    x = np.zeros((1, TC["num_signal"], 1), np.float32)
    with pytest.raises(ValueError, match="use_noise"):
        tr.gen_grads(x, False, 1.0, 0.1, decoder_noise=np.zeros((1, 4, 4, 8)))
