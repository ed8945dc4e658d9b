"""The port's cycle-consistency step against the JAX trainer's: a cycle
step with both encoders trained (the cycle overlay's mse margin 0.05, ramps
scaling, timbre swap), and a cycle step with the timbre encoder frozen (its
gradients zero, its batch statistics still committed; cosine loss,
alternate swap).  Micro config, batch 4, every dropout 0; tolerances and the
choice of weight draws in tests/torch_diffusion_common.py."""

import jax
import pytest

from tests import torch_diffusion_common as common

CYCLE = {"train.cycle_consistency": True, "train.cycle_start_step": 0,
         "train.cycle_weights": (0.15, 0.15)}


@pytest.fixture(scope="module")
def shapes():
    return common.variable_shapes(common.identity_trainer(
        common.no_dropout()))


def test_cycle_step_matches_jax(shapes):
    cfg = common.no_dropout(**CYCLE, **{
        "train.cycle_loss_type": "mse_margin_0.05",
        "train.cycle_scaling": "ramps", "train.cycle_swap_target": "cond"})
    metrics, grads = common.check_diffusion_step(
        cfg, common.identity_trainer(cfg), common.random_variables(shapes, 6),
        common.batch(6), jax.random.PRNGKey(13), (False, True, True, True),
        (0.05, 1.0))
    assert float(metrics["cycle_cond"]) > 0.05
    assert float(metrics["cycle_time_cond"]) > 0.05


def test_frozen_encoder_cycle_step_matches_jax(shapes):
    cfg = common.no_dropout(**CYCLE, **{
        "train.cycle_loss_type": "cosine",
        "train.cycle_swap_target": "alternate"})
    metrics, grads = common.check_diffusion_step(
        cfg, common.identity_trainer(cfg), common.random_variables(shapes, 8),
        common.batch(8), jax.random.PRNGKey(15), (False, False, True, True),
        (0.075, 0.5))
    assert float(metrics["cycle_cond"]) > 0
    assert all(float(g.abs().max()) == 0 for g in grads["encoder"])
    assert any(float(g.abs().max()) > 0 for g in grads["encoder_time"])


def test_cycle_with_fsq_noise_dropout_is_refused_by_both():
    """A cycle step with the structure encoder's FSQ noise dropout: the
    JAX trainer raises flax's InvalidRngError in the cycle's re-encode (it
    passes only a "dropout" rng, the dropout asks for "sample"), while the
    same step without the cycle runs; the port refuses the configuration
    when the trainer is made, naming that failure."""
    import flax

    from after_tpu_torch.diffusion.trainer import DiffusionTrainer

    cfg = common.no_dropout(**CYCLE, **{
        "encoder_time.quantizer_levels": (5,) * 12,
        "encoder_time.quantizer_noise_dropout": 0.5})
    jtr = common.identity_trainer(cfg)
    variables = common.random_variables(common.variable_shapes(jtr), 6)
    step = (common.batch(6), jax.random.PRNGKey(13))
    with pytest.raises(flax.errors.InvalidRngError):
        common.jax_train_step(jtr, variables, *step, (False, True, True, True),
                              (0.05, 1.0))
    metrics, _, _ = common.jax_train_step(
        jtr, variables, *step, (False, True, True, False), (0.05, 1.0))
    assert float(metrics["diffusion_loss"]) > 0
    with pytest.raises(ValueError, match="InvalidRngError"):
        DiffusionTrainer(common.port_cfg(cfg), device="cpu")
