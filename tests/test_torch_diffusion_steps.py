"""The port's diffusion step against the JAX trainer's: a phase-2 step with
the adversarial term and both encoders trained (the structure encoder with
an FSQ bottleneck and its noise dropout, its draws injected), and a phase-1
step (structure dropped whole).  Micro config, batch 4, every dropout 0;
tolerances and the choice of weight draws in
tests/torch_diffusion_common.py.  The phase is an argument of both steps, so
one config serves both cases."""

import jax
import numpy as np
import pytest

from tests import torch_diffusion_common as common

CFG = common.no_dropout(**{"encoder_time.quantizer_levels": (3,) * 12,
                           "encoder_time.quantizer_noise_dropout": 0.5})


@pytest.fixture(scope="module")
def jax_model():
    jtr = common.identity_trainer(CFG)
    return jtr, common.variable_shapes(jtr)


def test_phase2_adversarial_step_matches_jax(jax_model):
    jtr, shapes = jax_model
    rng = jax.random.PRNGKey(11)
    draws = common.jax_draws(CFG, rng, fsq=True)
    # both of the noise dropout's masks take some rows and leave others
    for mask in draws["fsq"][:2]:
        assert 0 < np.sum(mask < 0.5) < common.B
    metrics, grads = common.check_diffusion_step(
        CFG, jtr, common.random_variables(shapes, 4), common.batch(2), rng,
        (False, True, True, False), (0.075, 1.0))
    assert float(metrics["adversarial_loss"]) > 0
    for name in ("net", "encoder", "encoder_time"):
        assert any(float(g.abs().max()) > 0 for g in grads[name]), name


def test_phase1_step_matches_jax(jax_model):
    jtr, shapes = jax_model
    metrics, grads = common.check_diffusion_step(
        CFG, jtr, common.random_variables(shapes, 5), common.batch(4),
        jax.random.PRNGKey(12), (True, True, True, False), (0.0, 1.0))
    assert float(metrics["adversarial_loss"]) == 0.0
    assert float(metrics["time_cond_reg"]) == 0.0
    # phase 1 trains the net and the timbre encoder only
    assert all(float(g.abs().max()) == 0 for g in grads["encoder_time"])
    assert any(float(g.abs().max()) > 0 for g in grads["encoder"])
