"""The port's diffusion trainer at bf16 against the JAX trainer at bf16: a
phase-1 step and a cycle step (setting, JAX reference and tolerances in
tests/torch_bf16_train_common.py), and a window of
``train.steps_per_call`` steps, which is the port's own K single steps
(their draws are those of single steps, which the JAX package's windows
split otherwise): held to them bit for bit at bf16.

The masters: after a window of bf16 steps the parameters, both optimizers'
states, the EMA and the BatchNorm running statistics are f32, and so is
the state tree a checkpoint saves."""

import jax
import numpy as np
import pytest
import torch

from after_tpu import config as jax_config
from tests import torch_bf16_train_common as bf16
from tests import torch_diffusion_common as common


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    return bf16.jax_steps(("phase1", "cycle"),
                          tmp_path_factory.mktemp("bf16_diffusion_cycle"))


@pytest.mark.parametrize("kind", ["phase1", "cycle"])
def test_diffusion_step_matches_jax(jax_steps, kind):
    bf16.check_step(jax_steps, kind)


def test_window_is_its_single_steps_and_masters_stay_f32(jax_steps):
    """A window of 3 bf16 steps from step 0 (phase-1 steps) gives the bits
    of the same 3 steps run one by one with the same draws."""
    shapes = jax_steps[0]
    variables = common.random_variables(shapes, 5)
    cfg = jax_config.with_overrides(bf16.CFG16, {"train.steps_per_call": 3})
    batches = [common.batch(s) for s in (4, 5, 6)]
    draws = [common.jax_draws(cfg, jax.random.PRNGKey(20 + i), True)
             for i in range(3)]
    one = common.port_trainer(cfg, variables)
    win = common.port_trainer(cfg, variables)
    singles = [one._single(b, d) for b, d in zip(batches, draws)]
    metrics = win.window(batches, draws)
    assert one.step == win.step == 3
    for k in ("diffusion_loss", "cond_reg", "loss"):
        assert torch.equal(metrics[k],
                           torch.stack([m[k] for m in singles]).mean()), k
    for a, b in zip(one.params, win.params):
        assert torch.equal(a, b)
    for a, b in zip(one.ema, win.ema):
        assert torch.equal(a, b)
    fresh = common.port_trainer(cfg, variables)
    assert not all(np.array_equal(a, b) for a, b in zip(
        bf16.bn_stats(win.rf.encoder), bf16.bn_stats(fresh.rf.encoder)))
    assert all(p.dtype == torch.float32 for p in win.rf.parameters())
    assert all(e.dtype == torch.float32 for e in win.ema)
    assert all(b.dtype == torch.float32 for b in win.rf.buffers()
               if b.is_floating_point())
    for opt in (win.optimizer, win.cls_optimizer):
        assert opt._mu.dtype == opt._nu.dtype == torch.float32
    tree = win.state_tree()
    for model in tree["variables"].values():
        assert all(v.dtype == torch.float32 for v in model.values()
                   if v.is_floating_point())
    assert all(v.dtype == torch.float32 for v in tree["ema_params"].values())
