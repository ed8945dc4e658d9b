"""The diffusion trainer's state on the device and its windows of
``train.steps_per_call`` steps, against the JAX package on the CPU.

- the device-state ``AdamW`` against the optax chain it reproduces, update
  for update (parameters within 1e-6, moments within 1e-6 relative, counts
  exact);
- a window of K steps, on the CPU, bitwise equal to K single steps from the
  same generator seed;
- the port's window against the JAX trainer's ``_scan_window`` with the
  same per-step draws: metrics within the step tests' rtol 1e-4 / atol 1e-6,
  parameters within a tolerance in units of the learning rate, looser
  only where the JAX gradient fed to the optimizer is rounding noise
  (below);
- ``fit``'s windows and their boundaries as the JAX ``fit`` places them,
  and an iterator that runs dry inside a window;
- a batch with non-finite gradients inside a window.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from after_tpu.diffusion.trainer import DiffusionTrainer as JaxTrainer
from after_tpu.diffusion.trainer import DiffusionTrainState
from after_tpu_torch.diffusion.trainer import DiffusionTrainer
from after_tpu_torch.ops.norms import BatchNorm
from after_tpu_torch.utils.from_jax import load_denoiser, load_module
from after_tpu_torch.utils.optim import AdamW
from tests import torch_diffusion_common as common
from tests.test_diffusion import micro_config

# Parameters after a window, in units of the learning rate.  Two f32 Adam
# runs whose gradients differ by rounding move a parameter alike
# (NET_LR_TOL x lr), except where its gradient is rounding noise around 0,
# as for a conv's bias before a BatchNorm (zero in exact arithmetic): there
# the update's sign is the noise's and the two runs part by up to 2 lr an
# update (|mu_hat / sqrt(nu_hat)| is 1 at the first update).  Such elements
# are picked by the JAX gradients the window fed its optimizers: those
# that, in one of the window's updates, fell below NOISE_GRAD x the largest
# gradient of their model (about 80 f32 roundings of it; the gradients of
# those biases stand at 1e-10 to 1e-7 of it, the smallest real ones at
# 1e-5 and up).  They stand within NOISE_LR_TOL x lr an update.  A
# BatchNorm after such a bias sees its batch mean shifted by the bias, so
# its running mean may part by (1 - momentum) x that much more.
NET_LR_TOL = 1e-2
NOISE_GRAD = 1e-5
NOISE_LR_TOL = 2.0


def _port(cfg, **overrides):
    from after_tpu import config as jax_config
    return common.port_cfg(jax_config.with_overrides(cfg, overrides))


def _adam_state(state):
    """The ScaleByAdamState (count, mu, nu) inside an optax state."""
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return state
    if isinstance(state, tuple):
        for s in state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def test_adamw_matches_the_optax_chain():
    """Six updates with a frozen group: unclipped, clipped, finite values
    whose global norm overflows to inf (applied, clipped to zero), a NaN in
    the frozen group (masked, applied), a NaN in a trained one (skipped),
    and another NaN past max_consecutive_errors = 1 (applied); the
    learning rate decays 0.9 an applied update."""
    lr, decay, clip = 1e-2, 0.9, 1.0
    chain = optax.apply_if_finite(optax.chain(
        optax.clip_by_global_norm(clip),
        optax.adamw(optax.exponential_decay(lr, 1, decay), b1=0.9, b2=0.999,
                    weight_decay=0.01)), max_consecutive_errors=1)
    rng = np.random.RandomState(3)
    shapes = {"net": [(3, 4), (5,)], "encoder": [(2, 3, 2)]}
    keep = {"net": True, "encoder": False}
    flat_keep = [keep[k] for k in shapes for _ in shapes[k]]
    params = {k: [rng.randn(*s).astype(np.float32) for s in v]
              for k, v in shapes.items()}
    ours = AdamW([torch.from_numpy(p.copy()) for k in shapes
                  for p in params[k]], lr, decay, 0.9, 0.999, clip)
    ours.max_consecutive_errors = 1
    theirs = jax.tree_util.tree_map(jnp.asarray, params)
    state = chain.init(theirs)

    def zeros_where_frozen(tree):
        return {k: (v if keep[k] else jax.tree_util.tree_map(
            jnp.zeros_like, v)) for k, v in tree.items()}

    steps = [(0.1, None), (50.0, None), (3e19, None), (0.3, "encoder"),
             (0.3, "net"), (0.3, "net")]
    for i, (scale, nan_in) in enumerate(steps):
        grads = {k: [(scale * rng.randn(*s)).astype(np.float32) for s in v]
                 for k, v in shapes.items()}
        if nan_in is not None:
            grads[nan_in][0][0] = np.nan
        updates, state = chain.update(
            zeros_where_frozen(jax.tree_util.tree_map(jnp.asarray, grads)),
            state, theirs)
        theirs = optax.apply_updates(theirs, zeros_where_frozen(updates))
        applied = ours.step([torch.from_numpy(g) for k in shapes
                             for g in grads[k]], flat_keep)
        assert bool(applied) == (i != 4), i
        assert bool(ours.finite) == bool(state.last_finite), i
        assert int(ours.notfinite_count) == int(state.notfinite_count), i
        assert int(ours.total_notfinite) == int(state.total_notfinite), i
        adam = _adam_state(state)
        assert int(ours.count) == int(adam.count), i
        flat = [p for k in shapes for p in theirs[k]]
        for a, b in zip(ours.params, flat):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6, err_msg=str(i))
        for ours_m, theirs_m in ((ours.mu, adam.mu), (ours.nu, adam.nu)):
            flat_m = [m for k in shapes for m in theirs_m[k]]
            for a, b in zip(ours_m, flat_m):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-12,
                                           err_msg=str(i))
    # the NaN that max_consecutive_errors let through reached a parameter
    assert not torch.isfinite(ours.params[0]).all()
    for a, p in zip(ours.params[2:], params["encoder"]):
        np.testing.assert_array_equal(a.numpy(), p)


def _state(tr):
    """Everything a step writes: parameters, statistics, EMA, both
    optimizers' moments and counts, the generator's state."""
    out = {f"rf.{k}": v for k, v in tr.rf.state_dict().items()}
    out.update({f"ema.{i}": e for i, e in enumerate(tr.ema)})
    for name, opt in (("opt", tr.optimizer), ("cls", tr.cls_optimizer)):
        for k in ("_mu", "_nu", "count", "notfinite_count",
                  "total_notfinite", "finite"):
            out[f"{name}.{k}"] = getattr(opt, k)
    out["generator"] = tr.generator.get_state()
    return {k: v.clone() for k, v in out.items()}


def _batches(n, seed=20):
    return [common.batch(seed + i) for i in range(n)]


def test_a_window_is_k_single_steps_bitwise():
    """K = 3 with dropout on (the micro config's), from the same weights
    and generator seed: two windows of a diffusion and two classifier
    steps, equal to the same steps run one by one (parameters, statistics,
    EMA, both optimizers, the generator); the windows' metrics are the
    single steps' means."""
    overrides = {"train.timbre_warmup": 0, "train.update_classifier_every": 3,
                 "train.steps_per_call": 3}
    cfg = _port(micro_config(), **overrides)
    windowed = DiffusionTrainer(cfg, device="cpu", seed=5).init(1)
    single = DiffusionTrainer(
        _port(micro_config(), **{**overrides, "train.steps_per_call": 1}),
        device="cpu", seed=5).init(1)
    batches = _batches(6)
    seen, per_step = [], []
    windowed.fit(iter(batches), max_steps=6,
                 callback=lambda t, m: seen.append((t.step, m)))
    single.fit(iter(batches), max_steps=6,
               callback=lambda t, m: per_step.append(m))
    assert [s for s, _ in seen] == [3, 6]
    a, b = _state(windowed), _state(single)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert windowed.step == single.step == 6
    for (_, m), steps in zip(seen, (per_step[:3], per_step[3:])):
        diff = [s for s in steps if "loss" in s]
        cls = [s for s in steps if "classifier_loss" in s]
        for k, v in m.items():
            if k == "skipped_nonfinite":
                assert int(v) == 0
                continue
            rows = cls if k == "classifier_loss" else diff
            want = (float(np.mean([float(s[k]) for s in rows])) if rows
                    else 0.0)
            np.testing.assert_allclose(float(v), want, rtol=1e-6, atol=1e-9,
                                       err_msg=k)


def _recording(opt, name, log):
    """``opt`` with each gradient it is given appended to ``log`` as
    (name, numpy tree)."""
    def update(grads, state, params=None):
        jax.debug.callback(lambda g: log.append(
            (name, jax.tree_util.tree_map(np.asarray, g))), grads,
            ordered=False)
        return opt.update(grads, state, params)
    return optax.GradientTransformation(opt.init, update)


def _noise_masks(module, name, trees, variables):
    """Per parameter of ``module``, where the gradient of some update in
    ``trees`` (JAX gradient trees of the model ``name``) is below
    NOISE_GRAD x that update's largest."""
    masks = [np.zeros(tuple(p.shape), bool) for p in module.parameters()]
    for tree in trees:
        grads = copy.deepcopy(module)
        if name == "net":
            load_denoiser(grads, {"params": tree})
        else:
            load_module(grads, {"params": tree, "batch_stats":
                                variables[name].get("batch_stats", {})}, name)
        g = [np.abs(p.detach().numpy()) for p in grads.parameters()]
        top = max(a.max() for a in g)
        for m, a in zip(masks, g):
            m |= a <= NOISE_GRAD * top
    return masks


def test_window_matches_jax_scan_window():
    """A window of a diffusion, a classifier and a diffusion step from the
    same weights and batches, each step with the draws the JAX window
    gives it (jax.random.split(krng, K)), against ``_scan_window``."""
    K = 3
    cfg = common.no_dropout(**{"train.timbre_warmup": 0,
                               "train.update_classifier_every": 2,
                               "train.steps_per_call": K})
    jtr = JaxTrainer(cfg)
    fed = []
    jtr.optimizer = _recording(jtr.optimizer, "main", fed)
    jtr.cls_optimizer = _recording(jtr.cls_optimizer, "classifier", fed)
    variables = common.random_variables(common.variable_shapes(jtr), 4)
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    state = DiffusionTrainState(
        variables=common._fresh(variables),
        opt_state=jtr.optimizer.init(jtr._main_params(variables)),
        cls_opt_state=jtr.cls_optimizer.init(
            variables["classifier"]["params"]),
        ema_params=common._fresh(variables["net"]["params"]), step=0)
    window = _batches(K, seed=30)
    krng = jax.random.PRNGKey(7)
    new, jm = jtr._scan_window(state, window, krng, None)
    jax.effects_barrier()
    assert sorted(who for who, _ in fed) == ["classifier", "main", "main"]

    numpy_vars = jax.tree_util.tree_map(np.asarray, variables)
    tr = common.port_trainer(cfg, numpy_vars)
    kinds = [tr.step_kind(i) for i in range(K)]
    assert kinds == ["diffusion", "classifier", "diffusion"]
    draws = [common.jax_classifier_draws(cfg, r) if kind == "classifier"
             else common.jax_draws(cfg, r)
             for kind, r in zip(kinds, jax.random.split(krng, K))]
    ours = tr.window(window, draws)
    assert tr.step == K
    assert set(ours) == set(jm)
    assert int(ours["skipped_nonfinite"]) == int(jm["skipped_nonfinite"]) == 0
    for k, v in jm.items():
        np.testing.assert_allclose(float(ours[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)

    new_vars = jax.tree_util.tree_map(np.asarray, new.variables)
    lr = cfg.train.lr
    readings = {}
    for name, module in tr._models().items():
        trees = [g if who == "classifier" else g[name] for who, g in fed
                 if (who == "classifier") == (name == "classifier")]
        noise = _noise_masks(module, name, trees, numpy_vars)
        noise_tol = NOISE_LR_TOL * len(trees)
        theirs = copy.deepcopy(module)
        if name == "net":
            load_denoiser(theirs, {"params": new_vars[name]["params"]})
        else:
            load_module(theirs, new_vars[name], name)
        held = loose = 0.0
        for a, b, m in zip(module.parameters(), theirs.parameters(), noise):
            err = np.abs(a.detach().numpy() - b.detach().numpy()) / lr
            held = max(held, err[~m].max(initial=0.0))
            loose = max(loose, err[m].max(initial=0.0))
        readings[name] = (held, loose, int(sum(m.sum() for m in noise)))
        print(f"{name}: {len(trees)} updates; parameters within "
              f"{held:.3e} x lr (limit {NET_LR_TOL}), those with noise "
              f"gradients ({readings[name][2]}) within {loose:.3e} x lr "
              f"(limit {noise_tol})")
        assert held <= NET_LR_TOL and loose <= noise_tol, \
            (name, readings[name])
        stats = [(a, b) for a, b in zip(module.modules(), theirs.modules())
                 if isinstance(a, BatchNorm)]
        for a, b in stats:
            for buf in ("running_mean", "running_var"):
                np.testing.assert_allclose(
                    getattr(a, buf).numpy(), getattr(b, buf).numpy(),
                    rtol=common.STATS_RTOL, atol=common.STATS_ATOL
                    + (1 - BatchNorm.momentum) * noise_tol * lr,
                    err_msg=f"{name}/{buf}")
    ema = copy.deepcopy(tr.rf.net)
    load_denoiser(ema, {"params": jax.tree_util.tree_map(np.asarray,
                                                         new.ema_params)})
    for e, p in zip(tr.ema, ema.parameters()):
        assert np.abs(e.numpy() - p.detach().numpy()).max() <= \
            NET_LR_TOL * lr


@pytest.mark.parametrize("n_batches, expected", [
    # [0,2) a window; 2, 3 single (the phase boundary at 3 lies inside
    # [2, 4)); [4,6) a window; 6 single (a window would pass max_steps)
    (7, [2, 3, 4, 6, 7]),
    # the iterator runs dry inside the window at 4: its one batch runs as
    # a single step and fit ends
    (5, [2, 3, 4, 5]),
])
def test_fit_windows_and_boundaries(n_batches, expected):
    """tests/test_trainer.py::test_fit_steps_per_call_windows_and_boundaries
    's case (steps_per_call 2, timbre_warmup 3, update_classifier_every 2,
    max_steps 7) and the same run with too few batches."""
    cfg = _port(common.no_dropout(), **{"train.timbre_warmup": 3,
                                        "train.update_classifier_every": 2,
                                        "train.steps_per_call": 2})
    tr = DiffusionTrainer(cfg, device="cpu").init(0)
    seen = []
    tr.fit(iter(_batches(n_batches)), max_steps=7,
           callback=lambda t, m: seen.append((t.step, set(m))))
    assert [s for s, _ in seen] == expected
    assert tr.step == expected[-1]
    window_keys = {"classifier_loss", "skipped_nonfinite",
                   "diffusion_loss", "adversarial_loss", "cond_reg",
                   "time_cond_reg", "cycle_cond", "cycle_time_cond", "loss"}
    # the windows' metrics carry every key, as the JAX window's do
    windows = [keys for step, keys in seen if step in (2, 6)]
    assert windows and all(keys == window_keys for keys in windows)


def test_nonfinite_batch_inside_a_window():
    """A window of three diffusion steps whose second batch has NaN timbre
    latents: that step leaves the parameters, moments, count and BatchNorm
    statistics as they were (the EMA moves), skipped_nonfinite counts 1,
    and the window ends where the same steps run one by one end."""
    overrides = {"train.timbre_warmup": 0, "train.update_classifier_every": 1,
                 "train.steps_per_call": 3}
    cfg = _port(common.no_dropout(), **overrides)
    windowed = DiffusionTrainer(cfg, device="cpu", seed=2).init(3)
    single = DiffusionTrainer(cfg, device="cpu", seed=2).init(3)
    batches = _batches(3, seed=40)
    batches[1] = dict(batches[1], x_cond=np.full_like(batches[1]["x_cond"],
                                                      np.nan))
    metrics = windowed.window(batches)
    assert int(metrics["skipped_nonfinite"]) == 1

    single._single(batches[0])
    before = _state(single)
    m = single._single(batches[1])
    assert int(m["skipped_nonfinite"]) == 1
    after = _state(single)
    for k in before:
        if k.startswith(("rf.", "opt._mu", "opt._nu", "opt.count")):
            assert torch.equal(before[k], after[k]), k
    assert not all(torch.equal(before[f"ema.{i}"], after[f"ema.{i}"])
                   for i in range(len(single.ema)))
    single._single(batches[2])
    a, b = _state(windowed), _state(single)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert all(torch.isfinite(p).all() for p in windowed.rf.parameters())
