"""The port's diffusion trainer at bf16 against the JAX trainer at bf16: a
phase-2 diffusion step with the adversarial term, and a classifier step.
Setting, JAX reference and tolerances in
tests/torch_bf16_train_common.py; a phase-1 step, a cycle step and a
window in tests/test_torch_bf16_train_diffusion_cycle.py.

The classifier step runs in f32 in both packages (the JAX trainer casts
nothing there): a bf16 trainer's classifier step is held to the JAX one by
the f32 tolerances of tests/torch_diffusion_common.py."""

import jax
import pytest

from tests import torch_bf16_train_common as bf16
from tests import torch_diffusion_common as common


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    return bf16.jax_steps(("phase2", "classifier"),
                          tmp_path_factory.mktemp("bf16_diffusion"))


def test_diffusion_step_matches_jax(jax_steps):
    bf16.check_step(jax_steps, "phase2")


def test_classifier_step_runs_in_f32_as_in_jax(jax_steps):
    shapes, out = jax_steps
    w, b, key = bf16.CLASSIFIER
    variables = common.random_variables(shapes, w)
    jm, jgrads, _ = out["classifier", 0][0]
    tr = common.port_trainer(bf16.CFG16, variables)
    metrics, grads, _ = tr.classifier_grads(
        common.batch(b), draws=common.jax_classifier_draws(
            bf16.CFG, jax.random.PRNGKey(key)))
    common.check_metrics(metrics, jm)
    common.check_grads(tr.rf.classifier, grads, jgrads,
                       variables["classifier"].get("batch_stats", {}),
                       "classifier")
