"""The port's classifier step against the JAX trainer's, the optimizers
against the JAX trainer's optax chains, the EMA rule, and ``fit``'s schedule
of step kinds.  Micro config, batch 4, every dropout 0; tolerances in
tests/torch_diffusion_common.py, the optimizers within 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from after_tpu import config as jax_config
from after_tpu.diffusion.trainer import DiffusionTrainer as JaxTrainer
from after_tpu.diffusion.trainer import tree_zeros_like_mask
from after_tpu_torch.ops.norms import BatchNorm
from after_tpu_torch.utils.optim import AdamW
from tests import torch_diffusion_common as common

SCHEDULE = {"train.timbre_warmup": 3, "train.adversarial_warmup": 4,
            "train.update_classifier_every": 3,
            "train.cycle_consistency": True, "train.cycle_start_step": 6,
            "train.cycle_weights": (0.15, 0.15),
            "train.stop_training_encoder_step": 9}
KINDS = (["phase1"] * 3 + ["diffusion", "classifier", "classifier",
                           "diffusion", "classifier", "classifier", "cycle",
                           "classifier", "classifier", "cycle", "classifier",
                           "classifier"])


def test_classifier_step_matches_jax():
    cfg = common.no_dropout(**{"train.timbre_warmup": 0})
    jtr = common.identity_trainer(cfg)
    variables = common.random_variables(common.variable_shapes(jtr), 5)
    data, rng = common.batch(5), jax.random.PRNGKey(16)
    jm, jgrads, jnew = common.jax_classifier_step(jtr, variables, data, rng)
    tr = common.port_trainer(cfg, variables)
    metrics, grads, kept = tr.classifier_grads(
        data, draws=common.jax_classifier_draws(cfg, rng))
    common.check_metrics(metrics, jm)
    common.check_grads(tr.rf.classifier, grads, jgrads,
                       variables["classifier"]["batch_stats"], "classifier")
    kept.commit()
    common.check_stats(tr.rf.classifier, "classifier", jnew,
                       variables["classifier"]["params"])


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("which", ["main", "classifier"])
def test_optimizers_match_optax(which):
    """The same gradients into the port's AdamW and into the JAX trainer's
    optax chains, at lr 1e-2 and clip 1 so that each term shows: the main
    chain (clip + adamw, apply_if_finite) with the encoder frozen around it
    as the JAX step masks it, and the classifier's (adamw alone, no clip).
    Steps: ordinary, one past the clip, one with a NaN in the frozen model
    (masked, so applied), one with a NaN in a trained model (skipped), one
    more."""
    tc = dataclasses.replace(jax_config.DiffusionTrainConfig(), lr=1e-2,
                             grad_clip=1.0)
    jtr = JaxTrainer(dataclasses.replace(common.no_dropout(), train=tc))
    rng = np.random.RandomState(4)
    shapes = {"net": [(3, 4), (5,)], "encoder": [(2, 3, 2)]}
    if which == "main":
        jax_opt, keep, clip = (jtr.optimizer, {"net": True, "encoder": False},
                               tc.grad_clip)
    else:
        jax_opt, keep, clip = (jtr.cls_optimizer,
                               {"net": True, "encoder": True}, None)
    params = {k: [rng.randn(*s).astype(np.float32) for s in v]
              for k, v in shapes.items()}
    ours = AdamW([torch.from_numpy(p.copy()) for k in shapes
                  for p in params[k]], tc.lr, 1.0, 0.9, 0.999, clip)
    flat_keep = [keep[k] for k in shapes for _ in shapes[k]]
    theirs = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax_opt.init(theirs)
    skipped = 0
    for i, (scale, nan_in) in enumerate([(0.1, None), (50.0, None),
                                         (0.3, "encoder"), (0.3, "net"),
                                         (1.0, None)]):
        grads = {k: [(scale * rng.randn(*s)).astype(np.float32) for s in v]
                 for k, v in shapes.items()}
        if nan_in is not None:
            grads[nan_in][0][0] = np.nan
        g = (tree_zeros_like_mask(grads, keep) if which == "main"
             else grads)
        updates, state = jax_opt.update(
            jax.tree_util.tree_map(jnp.asarray, g), state, theirs)
        if which == "main":
            updates = tree_zeros_like_mask(updates, keep)
        theirs = optax.apply_updates(theirs, updates)
        applied = ours.step([torch.from_numpy(g) for k in shapes
                             for g in grads[k]],
                            flat_keep if which == "main" else None)
        masked_nan = nan_in == "encoder" and which == "main"
        assert applied == (nan_in is None or masked_nan), i
        skipped += not applied
        assert ours.total_notfinite == int(state.total_notfinite) == skipped
        flat = [p for k in shapes for p in _numpy_tree(theirs)[k]]
        for a, b in zip(ours.params, flat):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6,
                                       err_msg=str(i))
    assert ours.count == 5 - skipped
    if which == "main":
        for a, p in zip(ours.params[2:], params["encoder"]):
            np.testing.assert_array_equal(a.numpy(), p)


def _micro_trainer(**overrides):
    from after_tpu_torch.diffusion.trainer import DiffusionTrainer
    cfg = common.port_cfg(common.no_dropout(**overrides))
    return DiffusionTrainer(cfg, device="cpu").init(0)


def _flat(module):
    return torch.cat([p.detach().reshape(-1) for p in module.parameters()])


def test_ema_rule_and_the_nonfinite_skip():
    """After a diffusion step the EMA is decay * e + (1 - decay) * p of the
    new weights; a classifier step leaves it; a batch whose gradients are
    not finite changes no parameter, moment or BatchNorm statistic but the
    EMA still moves, and counts in skipped_nonfinite."""
    tr = _micro_trainer(**{"train.timbre_warmup": 0})
    data = common.batch(9)
    decay = tr.tc.ema_decay
    ema0 = [e.clone() for e in tr.ema]
    tr.train_step(data, False, True, True, False, 0.075, 1.0)
    for e, e0, p in zip(tr.ema, ema0, tr.rf.net.parameters()):
        torch.testing.assert_close(e, decay * e0 + (1 - decay) * p.detach(),
                                   rtol=0, atol=1e-7)
    ema1 = [e.clone() for e in tr.ema]
    tr.classifier_step(data)
    assert all(torch.equal(a, b) for a, b in zip(tr.ema, ema1))

    bad = dict(data, x_cond=np.full_like(data["x_cond"], np.nan))
    net0, stats0 = _flat(tr.rf.net), [
        m.running_mean.clone() for m in tr.rf.encoder.modules()
        if isinstance(m, BatchNorm)]
    mu0 = [m.clone() for m in tr.optimizer.mu]
    metrics = tr.train_step(bad, False, True, True, False, 0.075, 1.0)
    assert metrics["skipped_nonfinite"] == 1
    assert torch.equal(_flat(tr.rf.net), net0)
    assert all(torch.equal(a, b) for a, b in zip(tr.optimizer.mu, mu0))
    assert all(torch.equal(m.running_mean, s) for m, s in zip(
        (m for m in tr.rf.encoder.modules() if isinstance(m, BatchNorm)),
        stats0))
    assert not all(torch.equal(a, b) for a, b in zip(tr.ema, ema1))


def test_fit_runs_the_schedule_of_step_kinds():
    """The shortened curriculum of chip_smoke.py's phase 10 at micro size:
    the kinds and weights follow the JAX rules (phase1 = step <
    timbre_warmup; a classifier step after it when step %
    update_classifier_every != 0; cycle after cycle_start_step; the timbre
    encoder frozen after stop_training_encoder_step), each step moves only
    what it trains, and the frozen encoder's BatchNorm statistics still
    move."""
    tr = _micro_trainer(**SCHEDULE)
    jtr = JaxTrainer(common.no_dropout(**SCHEDULE))
    assert [tr.step_kind(s) for s in range(15)] == KINDS
    for s in range(15):
        assert tr.schedule_weights(s) == jtr.schedule_weights(s)
    batches = [common.batch(20 + i) for i in range(15)]
    log = []
    snap = {}

    def take_snapshot(t):
        snap.update(net=_flat(t.rf.net), enc=_flat(t.rf.encoder),
                    enc_t=_flat(t.rf.encoder_time), cls=_flat(t.rf.classifier),
                    ema=torch.cat([e.reshape(-1) for e in t.ema]),
                    enc_stats=torch.cat([
                        m.running_mean for m in t.rf.encoder.modules()
                        if isinstance(m, BatchNorm)]))

    def callback(t, metrics):
        before = dict(snap)
        take_snapshot(t)
        moved = {k: not torch.equal(before[k], snap[k]) for k in snap}
        log.append((t.step - 1, {k: float(v) for k, v in metrics.items()},
                    moved))

    take_snapshot(tr)
    tr.fit(iter(batches), max_steps=15, callback=callback)
    assert [s for s, _, _ in log] == list(range(15))
    for step, metrics, moved in log:
        kind = KINDS[step]
        assert all(np.isfinite(v) for v in metrics.values()), step
        if kind == "classifier":
            assert set(metrics) == {"classifier_loss"}
            assert moved == {"net": False, "enc": False, "enc_t": False,
                             "cls": True, "ema": False, "enc_stats": False}
            continue
        assert metrics["skipped_nonfinite"] == 0
        assert (metrics["cycle_cond"] != 0) == (kind == "cycle"), step
        assert (metrics["adversarial_loss"] != 0) == (kind != "phase1"), step
        assert moved["net"] and moved["ema"] and moved["enc_stats"], step
        assert moved["enc"] == (step <= 9), step
        assert moved["enc_t"] == (kind != "phase1"), step
        assert not moved["cls"], step
    assert tr.optimizer.count == 7 and tr.cls_optimizer.count == 8
