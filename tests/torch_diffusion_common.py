"""Shared pieces of the diffusion-training parity tests
(tests/test_torch_diffusion_*.py): the micro config without dropout, JAX
variables with every parameter and statistic drawn from a seed, the JAX
steps' gradients and draws, and the comparisons.

The JAX steps' gradients are read as tests/test_torch_ae_trainer.py reads
them: the trainer runs with identity optimizers and ``optax.apply_updates``
patched to return the updates, so the "new parameters" it returns are its
masked gradients, and its batch statistics are the ones it commits.  The
draws are taken from the keys the JAX step splits, as it splits them.

Tolerances: metrics rtol 1e-4 (atol 1e-7); each parameter's gradient within
1e-3 x the larger of its tensor's max |g| and 1e-3 x its model's largest
gradient (the floor of tests/test_torch_ae_trainer.py); batch statistics
rtol 1e-4, atol 1e-6.  The weight draws (seeds 4-8) are ones where both
packages' f32 gradients stand well inside that tolerance of the port's
float64 ones.  On some draws one package alone strays past it: with seed 3
the timbre encoder's conv biases before a ReLU and a BatchNorm, whose
gradients sum nearly cancelling terms, reach 1e-3 of their max in each
package; with seed 7 and the cosine cycle loss the JAX step's denoiser
gradients stand 4.6e-3 from float64 while the port's stay within 1.5e-6.
Elsewhere the two agree within 1e-5 on the denoiser and 5e-4 on the
encoders.
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from after_tpu import config as jax_config
from after_tpu.diffusion.trainer import DiffusionTrainer as JaxTrainer
from after_tpu.diffusion.trainer import shuffle_time_chunks
from after_tpu_torch import config as port_config
from after_tpu_torch.diffusion.trainer import DiffusionTrainer
from after_tpu_torch.ops.norms import BatchNorm
from after_tpu_torch.utils.from_jax import load_denoiser, load_module
from tests import torch_threads_common  # noqa: F401  (xdist workers' threads)
from tests.test_diffusion import micro_config

B, T, C = 4, 32, 8
METRIC_RTOL = 1e-4
GRAD_TOL = 1e-3
STATS_RTOL, STATS_ATOL = 1e-4, 1e-6


def no_dropout(**overrides):
    """The micro config of tests/test_diffusion.py with every dropout 0,
    plus ``overrides`` (dotted paths)."""
    return jax_config.with_overrides(micro_config(), {
        "denoiser.dropout": 0.0, "encoder_time.dropout": 0.0,
        "classifier.dropout": 0.0, **overrides})


def port_cfg(cfg):
    return port_config.from_json(jax_config.to_json(cfg))


def variable_shapes(jtr):
    """The JAX model's variables as shapes (eval_shape: no compile)."""
    return jax.eval_shape(lambda k: jtr.rf.init(k, B), jax.random.PRNGKey(0))


def random_variables(shapes, seed):
    """Variables of ``shapes`` with every parameter and BatchNorm statistic
    drawn from ``seed``."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        shape = tuple(s.shape)
        if name == "mean":
            v = 0.1 * rng.randn(*shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("g", "scale", "alpha", "beta"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "bias":
            v = 0.05 * rng.randn(*shape)
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            v = rng.randn(*shape) / np.sqrt(fan_in)
        return np.asarray(v, np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def batch(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    x_cond = rng.randn(B, T, C).astype(np.float32)
    return {"x": x, "x_cond": x_cond, "x_time_cond": x}


def identity_trainer(cfg):
    jtr = JaxTrainer(cfg)
    jtr.optimizer = optax.apply_if_finite(optax.identity(), 10000)
    jtr.cls_optimizer = optax.apply_if_finite(optax.identity(), 10000)
    return jtr


def _fresh(tree):
    # the jitted steps donate their state: each call gets its own copy
    return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), tree)


def jax_train_step(jtr, variables, data, rng, flags, weights):
    """The JAX diffusion step's (metrics, masked gradients by model, new
    variables) from ``variables``."""
    main = jtr._main_params(variables)
    state = (_fresh(variables), jtr.optimizer.init(main),
             _fresh(variables["net"]["params"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax, "apply_updates", lambda params, updates: updates)
        (new, _, _), metrics = jtr.train_step(
            state, {k: jnp.asarray(v) for k, v in data.items()}, rng,
            *flags, *weights)
    new = jax.tree_util.tree_map(np.asarray, new)
    grads = {k: new[k]["params"] for k in main}
    return jax.tree_util.tree_map(np.asarray, metrics), grads, new


def jax_classifier_step(jtr, variables, data, rng):
    state = (_fresh(variables), jtr.cls_optimizer.init(
        variables["classifier"]["params"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax, "apply_updates", lambda params, updates: updates)
        (new, _), metrics = jtr.classifier_step(
            state, {k: jnp.asarray(v) for k, v in data.items()}, rng)
    new = jax.tree_util.tree_map(np.asarray, new)
    return (jax.tree_util.tree_map(np.asarray, metrics),
            new["classifier"]["params"], new)


def _shuffle_map(sizes, key):
    frames = jnp.broadcast_to(
        jnp.arange(T, dtype=jnp.float32)[None, :, None], (B, T, 1))
    return shuffle_time_chunks(key, frames, sizes)[..., 0].astype(jnp.int32)


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _draws(sizes, zt, zs, fsq, edm, rng):
    ks = jax.random.split(rng, 9)
    k_noise, k_t, _ = jax.random.split(ks[6], 3)
    k_perm, _ = jax.random.split(ks[7])
    d = {"shuffle": _shuffle_map(sizes, ks[0]),
         "cond_noise": jax.random.normal(ks[2], (B, zt)),
         "time_cond_noise": jax.random.normal(ks[4], (B, T, zs)),
         "cfg_uniform": jax.random.uniform(ks[5], (B,)),
         "x0": jax.random.normal(k_noise, (B, T, C)),
         "cycle_perm": jax.random.permutation(k_perm, B)}
    # EDM draws the normal of ln sigma where the flow draws its times
    if edm:
        d["sigma_normal"] = jax.random.normal(k_t, (B,))
    else:
        d["t"] = jax.random.uniform(k_t, (B,))
    if fsq:
        k1, k2, k3 = jax.random.split(jax.random.fold_in(ks[3], 1), 3)
        d["fsq"] = tuple(jax.random.uniform(k, s) for k, s in (
            (k1, (B, 1, 1)), (k2, (B, 1, 1)), (k3, (B, T, zs))))
    return d


def _structure_vae_shape(cfg):
    et = cfg.encoder_time
    width = et.channels[-1] * (4 if et.upscale_out else 1)
    return (B, T // int(np.prod(et.ratios)), width)


def jax_draws(cfg, rng, fsq: bool = False):
    """The values the JAX diffusion step draws from ``rng``, by the port's
    names (trainer.DRAWS), drawn in one jitted call; with a VAE encoder its
    sample noise from the key the JAX step gives it (the timbre encoder
    ``ks[1]``, the structure encoder ``ks[3]``, the cycle's re-encode the
    second half of ``ks[7]``)."""
    d = _draws(tuple(cfg.train.shuffle_zsem), cfg.zt_channels,
               cfg.zs_channels, fsq, cfg.diffusion_type == "edm", rng)
    ks = jax.random.split(rng, 9)
    if cfg.encoder.regularisation == "vae":
        zt = (B, cfg.encoder.out_dim)
        d["cond_vae"] = jax.random.normal(ks[1], zt)
        d["cycle_cond_vae"] = jax.random.normal(jax.random.split(ks[7])[1],
                                                zt)
    if cfg.encoder_time is not None and cfg.encoder_time.vae_regularisation:
        d["time_cond_vae"] = jax.random.normal(ks[3],
                                               _structure_vae_shape(cfg))
    return jax.tree_util.tree_map(np.asarray, d)


def jax_classifier_draws(cfg, rng):
    """The JAX classifier step's draws: the shuffle from its first key, a
    VAE timbre encoder's sample noise from its second."""
    keys = jax.random.split(rng, 3)
    d = {"shuffle": np.asarray(jax.jit(_shuffle_map, static_argnums=0)(
        tuple(cfg.train.shuffle_zsem), keys[0]))}
    if cfg.encoder.regularisation == "vae":
        d["cond_vae"] = np.asarray(jax.random.normal(
            keys[1], (B, cfg.encoder.out_dim)))
    return d


def port_trainer(cfg, variables):
    return DiffusionTrainer(port_cfg(cfg), device="cpu").load_jax(variables)


def check_metrics(ours, theirs):
    theirs = dict(theirs)
    assert theirs.pop("skipped_nonfinite", 0) == 0
    assert set(ours) == set(theirs), (sorted(ours), sorted(theirs))
    for k, v in theirs.items():
        np.testing.assert_allclose(float(ours[k]), float(v), rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=k)


def check_grads(module, grads, jax_grads, stats, name):
    """The JAX gradients, loaded into a copy of ``module`` (the loader's
    layout changes are linear), against ours by parameter."""
    fresh = copy.deepcopy(module)
    if name == "net":
        load_denoiser(fresh, {"params": jax_grads})
    else:
        load_module(fresh, {"params": jax_grads, "batch_stats": stats}, name)
    named = [(n, p.detach().numpy()) for n, p in fresh.named_parameters()]
    assert len(named) == len(grads)
    floor = GRAD_TOL * max(np.abs(g).max() for _, g in named)
    for (pname, theirs), ours in zip(named, grads):
        err = np.abs(ours.numpy() - theirs).max()
        assert err <= GRAD_TOL * max(np.abs(theirs).max(), floor), \
            (name, pname, err, np.abs(theirs).max())


def check_stats(module, name, jax_new, params):
    """The running statistics of ``module`` (after our commit) against the
    JAX step's committed ones."""
    theirs = copy.deepcopy(module)
    load_module(theirs, {"params": params,
                         "batch_stats": jax_new[name]["batch_stats"]}, name)
    pairs = [(n, a, b) for (n, a), b in zip(module.named_modules(),
                                            theirs.modules())
             if isinstance(a, BatchNorm)]
    assert pairs
    for n, a, b in pairs:
        for buf in ("running_mean", "running_var"):
            np.testing.assert_allclose(
                getattr(a, buf).numpy(), getattr(b, buf).numpy(),
                rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=f"{name}/{n}/{buf}")


def check_diffusion_step(cfg, jtr, variables, data, rng, flags, weights):
    """One diffusion step of both trainers from the same weights, batch and
    draws: metrics, every gradient and the committed batch statistics."""
    jm, jgrads, jnew = jax_train_step(jtr, variables, data, rng, flags,
                                      weights)
    tr = port_trainer(cfg, variables)
    fsq = bool(cfg.encoder_time.quantizer_levels)
    metrics, grads, kept = tr.train_grads(
        data, *flags, *weights, draws=jax_draws(cfg, rng, fsq))
    check_metrics(metrics, jm)
    for name, module in tr.groups.items():
        stats = variables[name].get("batch_stats", {})
        check_grads(module, grads[name], jgrads[name], stats, name)
    kept.commit()
    phase1 = flags[0]
    for name in ("encoder",) + (() if phase1 else ("encoder_time",)):
        check_stats(tr.groups[name], name, jnew, variables[name]["params"])
    return metrics, grads
