"""A JAX training run carried into the port (scripts/convert_jax_checkpoint.py)
continues as the JAX run continues.

The micro diffusion trainer (tests/torch_diffusion_common.py, every dropout
0, phase 2 from step 0, a classifier step every second step) trains 2 steps
(a diffusion step and a classifier step, so that both optimizers' moments
are non-zero), and the micro codec trainer of tests/test_torch_ae_trainer.py
(no warm-up, a discriminator step every second step) trains 3 (a warm-up
and a GAN generator step, a discriminator step); each run is saved with
``after_tpu``'s orbax ``save_checkpoint`` as the JAX CLIs save it, and
converted.  The port's ``load_state_tree`` of the result then runs the next
steps (a diffusion step and a classifier step, which reads the classifier
optimizer's converted moments; a GAN generator step and a discriminator
step) with the draws of the JAX steps, which run from their own restored
state.

Tolerances: metrics rtol 1e-4 (the step tests'); parameters, the EMA and
both optimizers' moments after the step, in units of the learning rate, as
tests/test_torch_diffusion_window.py holds them after its window: within
NET_LR_TOL x lr, except elements whose gradient in this step is rounding
noise (below NOISE_GRAD x the largest of their model, read from the port's
gradient of the same step), where two f32 Adam steps may part by up to
NOISE_LR_TOL x lr; the counts exactly.  The conversion itself is exact:
weights, EMA, moments and counts equal the JAX state's before the step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from after_tpu import config as jax_config
from after_tpu.autoencoder import AutoencoderTrainer as JaxAETrainer
from after_tpu.utils import checkpoint as jax_ckpt
from after_tpu_torch import config as port_config
from after_tpu_torch.autoencoder import AutoencoderTrainer
from after_tpu_torch.diffusion.trainer import DiffusionTrainer
from after_tpu_torch.utils import checkpoint as port_ckpt
from after_tpu_torch.utils.from_jax import (load_denoiser,
                                            load_discriminator, load_module)
from scripts import convert_jax_checkpoint as converter
from tests import torch_diffusion_common as common
from tests.test_diffusion import micro_config

METRIC_RTOL = 1e-4
NET_LR_TOL = 1e-2
NOISE_GRAD = 1e-5
NOISE_LR_TOL = 2.0

DIFF_CFG = common.no_dropout(**{"train.timbre_warmup": 0,
                                "train.update_classifier_every": 2})


def _port_params(module, tree, load):
    holder = copy.deepcopy(module)
    load(holder, tree)
    return [p.detach().numpy().copy() for p in holder.parameters()]


def _noise_masks(grads):
    grads = [np.abs(g.detach().numpy()) for g in grads]
    top = max(g.max() for g in grads)
    return [g <= NOISE_GRAD * top for g in grads]


def _check_lr(label, ours, theirs, masks, lr):
    held = loose = 0.0
    for a, b, m in zip(ours, theirs, masks):
        err = np.abs(np.asarray(a) - np.asarray(b)) / lr
        held = max(held, err[~m].max(initial=0.0))
        loose = max(loose, err[m].max(initial=0.0))
    print(f"{label}: within {held:.3e} x lr (limit {NET_LR_TOL}), noise "
          f"gradients within {loose:.3e} x lr (limit {NOISE_LR_TOL})")
    assert held <= NET_LR_TOL and loose <= NOISE_LR_TOL, (label, held, loose)


def _check_equal(label, ours, theirs):
    assert len(ours) == len(theirs), label
    for i, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{label}[{i}]")


def _adam(state):
    return converter._find(state, {"count", "mu", "nu"})


def _top(state):
    return converter._find(state, {"notfinite_count", "total_notfinite"})


def _check_metrics(ours, theirs):
    assert set(ours) == set(theirs), (sorted(ours), sorted(theirs))
    for k, v in theirs.items():
        np.testing.assert_allclose(float(ours[k]), float(v), rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=k)


def _diffusion_tree(st):
    return {"variables": st.variables, "ema_params": st.ema_params,
            "opt_state": st.opt_state, "cls_opt_state": st.cls_opt_state,
            "step": st.step}


def test_diffusion_run_continues_in_the_port(tmp_path):
    cfg = DIFF_CFG
    jtr = common.JaxTrainer(cfg)
    state = jtr.init(jax.random.PRNGKey(0), common.B)
    batches = [common.batch(40 + i) for i in range(4)]
    state = jtr.fit(state, iter(batches[:2]), max_steps=2,
                    rng=jax.random.PRNGKey(1))
    assert state.step == 2
    jax_run, port_run = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(jax_run, 2, _diffusion_tree(state),
                             config_json=jax_config.to_json(cfg))
    converter.convert(jax_run, port_run)
    assert open(f"{port_run}/config.json").read() == \
        jax_config.to_json(cfg)

    tr = DiffusionTrainer(common.port_cfg(cfg), device="cpu")
    tr.load_state_tree(port_ckpt.restore_checkpoint(port_run))
    assert tr.step == 2 and tr.step_kind(2) == "diffusion"
    restored = jax_ckpt.restore_checkpoint(
        jax_run, target=_diffusion_tree(state))
    variables = jax.tree_util.tree_map(np.asarray, restored["variables"])

    # the conversion is exact
    def net_load(m, t):
        load_denoiser(m, {"params": t})

    def enc_load(name):
        stats = variables[name].get("batch_stats", {})
        return lambda m, t: load_module(
            m, {"params": t, "batch_stats": stats}, name)
    loads = {name: net_load if name == "net" else enc_load(name)
             for name in tr.groups}
    adam = _adam(restored["opt_state"])
    for moment, ours in (("mu", tr.optimizer.mu), ("nu", tr.optimizer.nu)):
        theirs = [p for name, m in tr.groups.items()
                  for p in _port_params(m, adam[moment][name], loads[name])]
        _check_equal(moment, ours, theirs)
    _check_equal("ema", tr.ema, _port_params(
        tr.rf.net, restored["ema_params"], net_load))
    cls_adam = _adam(restored["cls_opt_state"])
    for moment, ours in (("mu", tr.cls_optimizer.mu),
                         ("nu", tr.cls_optimizer.nu)):
        _check_equal(f"classifier {moment}", ours, _port_params(
            tr.rf.classifier, cls_adam[moment], enc_load("classifier")))
    for opt, st in ((tr.optimizer, restored["opt_state"]),
                    (tr.cls_optimizer, restored["cls_opt_state"])):
        assert int(opt.count) == int(_adam(st)["count"]) == 1
        assert int(opt.total_notfinite) == int(_top(st)["total_notfinite"])

    # the next step in both packages, from the same state and draws
    rng = jax.random.PRNGKey(9)
    flags, weights = tr.step_flags(2), tr.schedule_weights(2)
    (jvars, jopt, jema), jm = jtr.train_step(
        (restored["variables"], restored["opt_state"],
         restored["ema_params"]),
        {k: jnp.asarray(v) for k, v in batches[2].items()}, rng, *flags,
        *weights)
    draws = common.jax_draws(cfg, rng)
    # gradients without the update (nothing is committed)
    _, grads, _ = tr.train_grads(batches[2], *flags, *weights, draws=draws)
    ours = tr.train_step(batches[2], *flags, *weights, draws=draws)
    _check_metrics(ours, jax.tree_util.tree_map(np.asarray, jm))

    lr = cfg.train.lr
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    jadam = jax.tree_util.tree_map(np.asarray, _adam(jopt))
    for name, module in tr.groups.items():
        masks = _noise_masks(grads[name])
        tree = jvars[name]["params"]
        _check_lr(name, [p.detach().numpy() for p in module.parameters()],
                  _port_params(module, tree, loads[name]), masks, lr)
    masks = [m for name in tr.groups for m in _noise_masks(grads[name])]
    theirs_mu = [p for name, m in tr.groups.items()
                 for p in _port_params(m, jadam["mu"][name], loads[name])]
    # a moment moves by (1 - b1) x its gradient: its tolerance in units of
    # the gradient's scale is the parameters' in units of lr
    scale = max(float(np.abs(g).max()) for g in theirs_mu)
    _check_lr("mu", tr.optimizer.mu, theirs_mu, masks, scale)
    _check_lr("ema", tr.ema, _port_params(tr.rf.net, jax.tree_util.tree_map(
        np.asarray, jema), net_load), _noise_masks(grads["net"]), lr)
    assert int(tr.optimizer.count) == int(jadam["count"]) == 2

    # then a classifier step, whose update reads the classifier optimizer's
    # converted moments and count
    assert tr.step_kind(3) == "classifier"
    rng = jax.random.PRNGKey(10)
    (jvars, jcls_opt), jcm = jtr.classifier_step(
        (common._fresh(jvars), restored["cls_opt_state"]),
        {k: jnp.asarray(v) for k, v in batches[3].items()}, rng)
    draws = common.jax_classifier_draws(cfg, rng)
    _, cls_grads, _ = tr.classifier_grads(batches[3], draws=draws)
    _check_metrics(tr.classifier_step(batches[3], draws=draws),
                   jax.tree_util.tree_map(np.asarray, jcm))
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    jcls = jax.tree_util.tree_map(np.asarray, _adam(jcls_opt))
    cls_load = enc_load("classifier")
    masks = _noise_masks(cls_grads)
    _check_lr("classifier", [p.detach().numpy()
                             for p in tr.rf.classifier.parameters()],
              _port_params(tr.rf.classifier, jvars["classifier"]["params"],
                           cls_load), masks, lr)
    for moment, ours in (("mu", tr.cls_optimizer.mu),
                         ("nu", tr.cls_optimizer.nu)):
        theirs = _port_params(tr.rf.classifier, jcls[moment], cls_load)
        _check_lr(f"classifier {moment}", ours, theirs, masks,
                  max(float(np.abs(m).max()) for m in theirs))
    assert int(tr.cls_optimizer.count) == int(jcls["count"]) == 2


AE = dict(pqmf_bands=4, z_channels=8, base_channels=8, multipliers=(1, 2, 2),
          factors=(2, 2), dilations=(1, 3), num_blocks_per_stage=1)
TC = dict(num_signal=2048, warmup_steps=0, update_discriminator_every=2,
          stft_fft_sizes=(256, 64), stft_hop_sizes=(64, 16),
          stft_win_lengths=(256, 64))
DC = dict(filters=4, n_ffts=(206,), hop_lengths=(103,), win_lengths=(206,))


def _ae_configs(package):
    return (package.AutoEncoderConfig(**AE), package.AETrainConfig(**TC),
            package.DiscriminatorConfig(**DC))


def _ae_tree(st):
    return {"codec_vars": st.codec_vars, "disc_vars": st.disc_vars,
            "opt_state": st.opt_state, "disc_opt_state": st.disc_opt_state,
            "step": st.step}


def test_codec_run_continues_in_the_port(tmp_path):
    ae, tc, dc = _ae_configs(jax_config)
    jtr = JaxAETrainer(ae, tc, dc)
    state = jtr.init(jax.random.PRNGKey(0), 1)
    rng = np.random.RandomState(7)
    batches = [(0.1 * rng.randn(1, TC["num_signal"], 1)).astype(np.float32)
               for _ in range(4)]
    state = jtr.fit(state, iter(batches[:3]), max_steps=3,
                    rng=jax.random.PRNGKey(2))
    assert state.step == 3
    jax_run, port_run = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(jax_run, 3, _ae_tree(state),
                             config_json=jax_config.ae_to_json(ae))
    converter.convert(jax_run, port_run)

    pae, ptc, pdc = _ae_configs(port_config)
    # one trainer for the generator step and one for the discriminator's
    tr, disc = (AutoencoderTrainer(pae, ptc, pdc, device="cpu")
                for _ in range(2))
    for t in (tr, disc):
        t.load_state_tree(port_ckpt.restore_checkpoint(port_run))
    assert tr.step == 3 and tr.step_kind(3) == "gan"
    restored = jax_ckpt.restore_checkpoint(jax_run, target=_ae_tree(state))

    def codec_load(m, t):
        load_module(m, {"params": t}, "codec")

    def disc_load(m, t):
        load_discriminator(m, {"params": t})
    for opt, st, module, load in (
            (tr.optimizer, restored["opt_state"], tr.codec, codec_load),
            (tr.disc_optimizer, restored["disc_opt_state"], tr.disc,
             disc_load)):
        adam = _adam(st)
        _check_equal("mu", opt.mu, _port_params(module, adam["mu"], load))
        _check_equal("nu", opt.nu, _port_params(module, adam["nu"], load))
        assert int(opt.count) == int(adam["count"]) > 0
        assert int(opt.total_notfinite) == int(_top(st)["total_notfinite"])

    # a GAN generator step and a discriminator step from the restored state
    x = batches[3]
    krng = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(
        krng, (1, TC["num_signal"] // pae.ratio, AE["z_channels"])))
    w_wave, w_reg = jtr._recon_weights(3)
    # the steps donate their state: each gets its own copy
    (jcv, _, jopt), jm = jtr.gen_step(common._fresh(
        (restored["codec_vars"], restored["disc_vars"],
         restored["opt_state"])), jnp.asarray(x), krng, True, w_wave, w_reg)
    (_, jdv, jdopt), jdm = jtr.disc_step(common._fresh(
        (restored["codec_vars"], restored["disc_vars"],
         restored["disc_opt_state"])), jnp.asarray(x), krng)
    _, gen_grads = tr.gen_grads(x, True, float(w_wave), float(w_reg), noise)
    _, disc_grads = tr.disc_grads(x, noise)
    ours = tr.gen_step(x, True, float(w_wave), float(w_reg), noise)
    ours_d = disc.disc_step(x, noise)
    _check_metrics(ours, jax.tree_util.tree_map(np.asarray, jm))
    _check_metrics(ours_d, jax.tree_util.tree_map(np.asarray, jdm))

    lr = ptc.lr * ptc.lr_decay ** int(_adam(restored["opt_state"])["count"])
    jcv = jax.tree_util.tree_map(np.asarray, jcv)
    jdv = jax.tree_util.tree_map(np.asarray, jdv)
    _check_lr("codec", [p.detach().numpy() for p in tr.codec.parameters()],
              _port_params(tr.codec, jcv["params"], codec_load),
              _noise_masks(gen_grads), lr)
    _check_lr("discriminator",
              [p.detach().numpy() for p in disc.disc.parameters()],
              _port_params(disc.disc, jdv["params"], disc_load),
              _noise_masks(disc_grads), lr)
    assert int(tr.optimizer.count) == int(_adam(jopt)["count"])
    assert int(disc.disc_optimizer.count) == int(_adam(jdopt)["count"])


def test_converter_refuses_an_unknown_tree(tmp_path):
    jax_ckpt.save_checkpoint(str(tmp_path), 0, {"other": np.zeros(2)},
                             config_json="{}")
    with pytest.raises(ValueError, match="neither a diffusion run"):
        converter.convert(str(tmp_path), str(tmp_path / "port"))


@pytest.mark.parametrize("n_scales, filters", [(1, 4), (6, 64)])
def test_discriminator_config_is_read_from_the_weights(n_scales, filters):
    cfg = port_config.DiscriminatorConfig(
        filters=filters,
        n_ffts=port_config.DiscriminatorConfig().n_ffts[:n_scales],
        hop_lengths=port_config.DiscriminatorConfig().hop_lengths[:n_scales],
        win_lengths=port_config.DiscriminatorConfig().win_lengths[:n_scales])
    from after_tpu.models.discriminator import EncodecDiscriminator
    disc = EncodecDiscriminator(jax_config.DiscriminatorConfig(
        **{k: getattr(cfg, k) for k in ("filters", "n_ffts", "hop_lengths",
                                        "win_lengths")}))
    x = jnp.zeros((1, 4096, 1))
    shapes = jax.eval_shape(lambda k: disc.init(k, x, x),
                            jax.random.PRNGKey(0))
    assert converter.discriminator_config(shapes) == cfg
