"""Shared pieces of the bf16 training tests: the bf16 rule
(``bf16_close``, tests/test_torch_bf16_train_*.py) and, for
tests/test_torch_bf16_train_diffusion*.py, the port's diffusion trainer at
bf16 against the JAX trainer at bf16.

The micro config of tests/torch_diffusion_common.py (batch 4, every dropout
0) with the cycle overlay of tests/test_torch_diffusion_cycle.py, weights
and batches drawn from seeds as there, every random value of a step drawn
as the JAX step draws it and handed to the port.  The JAX trainer runs each
step in f32 and with ``train.compute_dtype="bfloat16"`` (identity
optimizers, ``optax.apply_updates`` patched, as in
tests/torch_diffusion_common.py); the port runs it at bf16.

The JAX bf16 steps run in a process of their own with XLA_FLAGS
--xla_allow_excess_precision=false (``jax_steps``): by default XLA may keep
a bf16 value in f32 where it fuses the ops around it, so the JAX bf16 step
rounds at fewer places than its program says (at this size the adversarial
loss's deviation from f32 grows from 3.1e-4 to 4.4e-3 without that
freedom); with the flag every bf16 value of the program is rounded, as the
port rounds it.  The f32 steps run in the test's own process at the same
time.

Tolerances, over SAMPLES draws of the weights, batch and key taken as one
tensor: each model's gradient taken whole (all its parameters' gradients as
one tensor) and each encoder's committed BatchNorm statistics taken whole
by the bf16 rule of tests/test_torch_precision.py (the port's bf16 result
no farther from the JAX f32 one than twice the JAX bf16 result is, plus
1e-6 of the JAX f32 result's scale); each metric by the same rule with
METRIC_FACTOR in place of 2.  A loss is one number a draw, the sum of many
roundings of either package's own placing: the two packages' deviations
from f32 are independent draws of one size (each module's bf16 output lies
as far from f32 in the port as in the JAX package: the denoiser 1.8e-2 to
4.0e-2 of its max against 1.8e-2 to 4.2e-2, the timbre encoder 2.0e-2 to
4.1e-2 against 1.5e-2 to 3.7e-2, over four draws), and over five draws the
ratio of the largest ones reached 2.9 for one loss (the phase-2 step's
cond_reg) and 0.3 for others of the same step.
"""

import copy
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from after_tpu import config as jax_config
from after_tpu_torch.ops.norms import BatchNorm
from tests import torch_diffusion_common as common
from tests import torch_threads_common  # noqa: F401  (xdist workers' threads)

CFG = common.no_dropout(**{
    "train.cycle_consistency": True, "train.cycle_start_step": 0,
    "train.cycle_weights": (0.15, 0.15),
    "train.cycle_loss_type": "mse_margin_0.05", "train.cycle_scaling": "ramps",
    "train.cycle_swap_target": "cond"})
CFG16 = jax_config.with_overrides(CFG, {"train.compute_dtype": "bfloat16"})
# draws of weights, batch and key a step is compared over
SAMPLES = 3
METRIC_FACTOR = 4.0
# (flags (phase1, train_encoder, train_encoder_time, use_cycle), weights
#  (adversarial, regularisation), weight seed, batch seed, key)
STEPS = {"phase1": ((True, True, True, False), (0.0, 1.0), 5, 4, 12),
         "phase2": ((False, True, True, False), (0.075, 1.0), 4, 2, 11),
         "cycle": ((False, True, True, True), (0.05, 1.0), 6, 6, 13)}
CLASSIFIER = (7, 7, 14)    # weight seed, batch seed, key


def bf16_close(label, port16, jax16, jax32, factor=2.0):
    """The bf16 rule of tests/test_torch_precision.py (``factor`` 2)."""
    port16, jax16, jax32 = (np.asarray(a, np.float64)
                            for a in (port16, jax16, jax32))
    assert port16.shape == jax32.shape, (label, port16.shape, jax32.shape)
    err = float(np.abs(port16 - jax32).max())
    limit = (factor * float(np.abs(jax16 - jax32).max())
             + 1e-6 * float(np.abs(jax32).max()))
    assert np.isfinite(port16).all() and err <= limit, (label, err, limit)


def jax_results(kinds, dtype):
    """The JAX steps of ``kinds`` (STEPS names and "classifier") in f32 or
    at bf16 (``dtype``), each diffusion step over the SAMPLES draws:
    (variable shapes, {(kind, draw): (metrics, gradients, new variables)})."""
    jtr = common.identity_trainer(CFG16 if dtype == "bf16" else CFG)
    # the f32 trainer's classifier step is the bf16 one's: it casts nothing
    shapes = common.variable_shapes(jtr)
    out = {}
    for kind in kinds:
        if kind == "classifier":
            w, b, key = CLASSIFIER
            out[kind, 0] = common.jax_classifier_step(
                jtr, common.random_variables(shapes, w), common.batch(b),
                jax.random.PRNGKey(key))
            continue
        flags, weights, w, b, key = STEPS[kind]
        for i in range(SAMPLES):
            out[kind, i] = common.jax_train_step(
                jtr, common.random_variables(shapes, w + 10 * i),
                common.batch(b + 10 * i), jax.random.PRNGKey(key + 10 * i),
                flags, weights)
    return shapes, out


def jax_steps(kinds, tmp_dir):
    """(shapes, {key: (f32 result, bf16 result)}): the f32 steps from this
    process and, at the same time, the bf16 ones from a process of its own
    in which XLA rounds every bf16 value (see the module docstring); a
    classifier step casts nothing, so this process runs it and its result
    stands for both."""
    path = os.path.join(str(tmp_dir), "jax.pkl")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), path]
                            + [k for k in kinds if k != "classifier"],
                            cwd=root, env=env)
    try:
        shapes, out32 = jax_results(kinds, "f32")
    finally:
        assert proc.wait() == 0
    with open(path, "rb") as f:
        out16 = pickle.load(f)
    return shapes, {k: (v, out16.get(k, v)) for k, v in out32.items()}


def flat(tensors):
    return np.concatenate([np.asarray(t, np.float64).ravel()
                           for t in tensors])


def jax_grads(module, name, grads, stats):
    """The JAX gradients in the port's parameter order (loaded into a copy
    of ``module``; the loader's layout changes are linear)."""
    fresh = copy.deepcopy(module)
    if name == "net":
        common.load_denoiser(fresh, {"params": grads})
    else:
        common.load_module(fresh, {"params": grads, "batch_stats": stats},
                           name)
    return [p.detach().numpy() for p in fresh.parameters()]


def bn_stats(module):
    return [getattr(m, buf).numpy() for m in module.modules()
            if isinstance(m, BatchNorm)
            for buf in ("running_mean", "running_var")]


def jax_bn_stats(module, name, jax_new, params):
    theirs = copy.deepcopy(module)
    common.load_module(theirs, {"params": params,
                                "batch_stats": jax_new[name]["batch_stats"]},
                       name)
    return bn_stats(theirs)


def check_step(steps, kind):
    """The port's bf16 step ``kind`` against the JAX steps, over the draws
    (see the module docstring); returns the port trainer of the last."""
    import torch
    shapes, out = steps
    flags, weights, w, b, key = STEPS[kind]
    fsq = bool(CFG.encoder_time.quantizer_levels)
    rows = {}

    def add(label, *values):
        rows.setdefault(label, []).append(values)
    for i in range(SAMPLES):
        variables = common.random_variables(shapes, w + 10 * i)
        data = common.batch(b + 10 * i)
        rng = jax.random.PRNGKey(key + 10 * i)
        (m32, g32, new32), (m16, g16, new16) = out[kind, i]
        tr = common.port_trainer(CFG16, variables)
        assert tr.compute_dtype == torch.bfloat16
        metrics, grads, kept = tr.train_grads(
            data, *flags, *weights, draws=common.jax_draws(CFG, rng, fsq))
        m16 = dict(m16)
        assert m16.pop("skipped_nonfinite") == 0
        assert set(metrics) == set(m16)
        for k in m16:
            add(("metric", k), float(metrics[k]), m16[k], m32[k])
        for name, module in tr.groups.items():
            stats = variables[name].get("batch_stats", {})
            assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
                       for g in grads[name]), name
            add(("tensor", f"{name} gradient"), flat(grads[name]),
                flat(jax_grads(module, name, g16[name], stats)),
                flat(jax_grads(module, name, g32[name], stats)))
        kept.commit()
        for name in ("encoder",) + (() if flags[0] else ("encoder_time",)):
            module, params = tr.groups[name], variables[name]["params"]
            add(("tensor", f"{name} statistics"), flat(bn_stats(module)),
                flat(jax_bn_stats(module, name, new16, params)),
                flat(jax_bn_stats(module, name, new32, params)))
    for (what, label), values in rows.items():
        bf16_close(label, *(np.concatenate([np.ravel(v[j]) for v in values])
                            for j in range(3)),
                   factor=METRIC_FACTOR if what == "metric" else 2.0)
    return tr


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    with open(sys.argv[1], "wb") as f:
        pickle.dump(jax_results(sys.argv[2:], "bf16")[1], f)
