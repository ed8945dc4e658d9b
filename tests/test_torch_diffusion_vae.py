"""The diffusion trainer's steps with VAE encoders against the JAX
trainer's: a diffusion step with both encoders VAEs (ECAPA
``regularisation="vae"``, Encoder1D ``vae_regularisation`` with
``upscale_out``), a cycle step and a classifier step with the timbre
encoder a VAE, and the classifier and cycle steps that a VAE structure
encoder makes the JAX trainer refuse (C11).

Each VAE's sample noise is the JAX step's own draw from the key it gives
that encoder, handed to the port by name (trainer.DRAWS: ``cond_vae``,
``time_cond_vae``, ``cycle_cond_vae``; tests/torch_diffusion_common.py's
``jax_draws``).  The KL of each VAE goes into ``cond_reg`` and
``time_cond_reg`` under the regularisation weight.  Micro config, batch 4,
every dropout 0; tolerances and the choice of weight draws in
tests/torch_diffusion_common.py.  Two JAX trainer-step compiles (the
diffusion and the cycle step); the classifier step's is a third, smaller
one.
"""

import flax
import jax
import pytest

from after_tpu_torch.diffusion.trainer import DRAWS, DiffusionTrainer
from tests import torch_diffusion_common as common

TIMBRE_VAE = {"encoder.regularisation": "vae"}
BOTH_VAE = {**TIMBRE_VAE, "encoder_time.vae_regularisation": True,
            "encoder_time.ac_regularisation": False,
            "encoder_time.upscale_out": True}
CYCLE = {"train.cycle_consistency": True, "train.cycle_start_step": 0,
         "train.cycle_weights": (0.15, 0.15)}


def test_the_vae_draws_are_named():
    assert {"cond_vae", "time_cond_vae", "cycle_cond_vae"} <= set(DRAWS)


def test_diffusion_step_with_vae_encoders_matches_jax():
    cfg = common.no_dropout(**BOTH_VAE)
    jtr = common.identity_trainer(cfg)
    variables = common.random_variables(common.variable_shapes(jtr), 4)
    metrics, grads = common.check_diffusion_step(
        cfg, jtr, variables, common.batch(4), jax.random.PRNGKey(21),
        (False, True, True, False), (0.05, 0.5))
    # both KLs are positive and reach the loss
    assert float(metrics["cond_reg"]) > 0
    assert float(metrics["time_cond_reg"]) > 0


def test_cycle_step_with_a_vae_timbre_encoder_matches_jax():
    cfg = common.no_dropout(**TIMBRE_VAE, **CYCLE, **{
        "train.cycle_loss_type": "mse"})
    jtr = common.identity_trainer(cfg)
    variables = common.random_variables(common.variable_shapes(jtr), 5)
    metrics, _ = common.check_diffusion_step(
        cfg, jtr, variables, common.batch(5), jax.random.PRNGKey(22),
        (False, True, True, True), (0.05, 0.5))
    assert float(metrics["cycle_cond"]) > 0


def test_classifier_step_with_a_vae_timbre_encoder_matches_jax():
    cfg = common.no_dropout(**TIMBRE_VAE, **{"train.timbre_warmup": 0})
    jtr = common.identity_trainer(cfg)
    variables = common.random_variables(common.variable_shapes(jtr), 6)
    data, rng = common.batch(6), jax.random.PRNGKey(23)
    jm, jgrads, _ = common.jax_classifier_step(jtr, variables, data, rng)
    tr = common.port_trainer(cfg, variables)
    draws = common.jax_classifier_draws(cfg, rng)
    assert "cond_vae" in draws
    metrics, grads, _ = tr.classifier_grads(data, draws=draws)
    common.check_metrics(metrics, jm)
    common.check_grads(tr.rf.classifier, grads, jgrads,
                       variables["classifier"]["batch_stats"], "classifier")


@pytest.mark.parametrize("kind", ["classifier", "cycle"])
def test_steps_a_vae_structure_encoder_cannot_run_are_refused_by_both(kind):
    """The JAX classifier step runs the structure encoder with no key and
    its cycle step with a "dropout" key alone: a VAE structure encoder then
    asks for a "sample" rng and flax raises InvalidRngError; the port
    refuses the same steps, naming that failure.  (The diffusion step,
    which gives that encoder its key, runs in both: above.)"""
    cfg = common.no_dropout(**BOTH_VAE, **(CYCLE if kind == "cycle" else {
        "train.timbre_warmup": 0}))
    jtr = common.identity_trainer(cfg)
    variables = common.random_variables(common.variable_shapes(jtr), 7)
    data, rng = common.batch(7), jax.random.PRNGKey(24)
    tr = DiffusionTrainer(common.port_cfg(cfg), device="cpu")
    with pytest.raises(flax.errors.InvalidRngError):
        if kind == "cycle":
            common.jax_train_step(jtr, variables, data, rng,
                                  (False, True, True, True), (0.05, 0.5))
        else:
            common.jax_classifier_step(jtr, variables, data, rng)
    with pytest.raises(ValueError, match="InvalidRngError"):
        if kind == "cycle":
            tr.train_grads(data, False, True, True, True, 0.05, 0.5)
        else:
            tr.classifier_grads(data)
