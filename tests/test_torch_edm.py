"""The port's EDM (after_tpu_torch/diffusion/edm.py) against the JAX
package's, on the CPU, over the micro denoiser of tests/test_diffusion.py
(a 2-layer DenoiserV2 of width 64 over 32 frames of 8 latents), its
parameters drawn from a seed:

- the preconditioning and the Karras ladder at 1, 2, 8 and 20 steps;
- the loss, its aux and the denoiser's gradients, the JAX draws recomputed
  from its key (``split(rng, 3)``: the unit noise, the normal of ln sigma);
- the offline sampler, Heun and Euler, at 1 and 3 steps and guidances
  (2.0, 0.5);
- the streaming sampler over 2 buffers with the KV cache carried, against
  the JAX ``sample_stream``, and the port's stream over the whole sequence
  against its own offline Euler sampler;
- one bf16 ``denoise`` under the bf16 rule of tests/test_torch_precision.py;
- the wiring: a phase-2 and a cycle step of the port's trainer against
  JAX's ``DiffusionTrainer`` (the JAX draws by the port's names, EDM's
  ``sigma_normal`` in place of the flow's ``t``), a micro transfer against
  JAX's ``TransferPipeline``, an exported EDM artifact on the port's Python
  host against the live streamer at (nb 1; 2.0, 0.5) then (nb 3; 1.0, 1.0),
  and ``train --model edm`` for two steps through the port's command.

Tolerances: the rectified flow's (tests/test_torch_denoiser.py and
tests/test_torch_streaming.py): atol 1e-5 on a forward and the ladder
(rtol 1e-6); on sampled latents 1e-4 of their largest (|x| reaches 68
here, from sigma_max = 80 times the noise, where the flow's reach 1; a
forward parts by 6e-8 between the packages, and Heun's correction from
sigma 2.5 to 0.002 multiplies that by about 1e3); the loss rtol 1e-4 and
the gradients within 1e-3 of their tensor's or model's largest
(tests/torch_diffusion_common.py); the port's stream against its offline
sampler atol 5e-4, the JAX package's own bound for the same invariant
(tests/test_edm.py); the steps' of tests/torch_diffusion_common.py; the
transfer's atol 1e-3 (tests/torch_models_common.py); the artifact within
1e-6 x max|y| of the live streamer (tests/test_torch_export.py).
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu import config as jax_config
from after_tpu.diffusion.edm import EDM as JaxEDM
from after_tpu.models import Denoiser as JaxDenoiser
from after_tpu.streaming.state import init_stream_state
from after_tpu.utils.precision import cast_floating
from after_tpu_torch import config as port_config
from after_tpu_torch.cli import main as cli
from after_tpu_torch.diffusion.edm import EDM, sigma_ladder
from after_tpu_torch.diffusion.factory import make_model
from after_tpu_torch.diffusion.pipeline import TransferPipeline
from after_tpu_torch.ops.train_mode import TrainMode
from after_tpu_torch.streaming.export import ExportedStreamer, export_streamer
from after_tpu_torch.streaming.state import init_cache
from after_tpu_torch.streaming.streamer import Streamer
from after_tpu_torch.utils.checkpoint import restore_checkpoint
from after_tpu_torch.utils.from_jax import load_denoiser
from tests import torch_diffusion_common as common
from tests.test_diffusion import micro_config
from tests.test_torch_cli_train import _diff_args, _z_store
from tests.test_torch_export import LIVE_TOL, crossfade_config
from tests.test_torch_precision import bf16_close
from tests.torch_models_common import check_transfer

B, T, C = 2, 32, 8
FORWARD_TOL = dict(atol=1e-5)
SAMPLE_TOL = 1e-4          # max abs difference <= SAMPLE_TOL * max |y|
STREAM_OFFLINE_TOL = dict(atol=5e-4)


def edm_config(**over):
    return jax_config.with_overrides(micro_config(), {
        "diffusion_type": "edm", "denoiser.dropout": 0.0, **over})


CFG = edm_config()


def _port(cfg, streaming=False):
    return make_model(port_config.from_json(jax_config.to_json(cfg)),
                      streaming=streaming).eval()


@pytest.fixture(scope="module")
def net_params():
    """The micro denoiser's parameters, perturbed from their init."""
    net = JaxDenoiser(CFG.denoiser)
    x, t, c, tc = _inputs(0)
    params = jax.jit(net.init)(jax.random.PRNGKey(1), x, t[:, 0, 0], c, tc)
    rng = np.random.RandomState(1)

    def f(v):
        v = np.asarray(v, dtype=np.float32)
        return (v * (1 + 0.2 * rng.uniform(-1, 1, v.shape))
                + 0.02 * rng.randn(*v.shape)).astype(np.float32)
    return jax.tree_util.tree_map(f, params)


def _inputs(seed, batch=B, frames=T):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, frames, C).astype(np.float32),
            rng.rand(batch, 1, 1).astype(np.float32),
            rng.randn(batch, CFG.zt_channels).astype(np.float32),
            rng.randn(batch, frames, CFG.zs_channels).astype(np.float32))


def _loaded(cfg, params, streaming=False):
    rf = _port(cfg, streaming)
    load_denoiser(rf.net, params)
    return rf


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(label, y, ref):
    err, scale = float(np.abs(y - ref).max()), float(np.abs(ref).max())
    print(f"{label}: max abs difference {err:.3e} ({err / scale:.3e} x "
          f"max|y|; limit {SAMPLE_TOL})")
    assert y.shape == ref.shape and err <= SAMPLE_TOL * scale, label


def test_make_model_builds_edm():
    assert isinstance(_port(CFG), EDM)
    assert not isinstance(_port(micro_config()), EDM)


@pytest.mark.parametrize("nb", [1, 2, 8, 20])
def test_precond_and_sigma_ladder_match_jax(nb):
    jm, rf = JaxEDM(CFG), _port(CFG)
    ours = sigma_ladder(rf.cfg.edm, nb, nb + 1)
    theirs = np.array([float(jm._sigma_at(jnp.float32(i), jnp.float32(nb)))
                       for i in range(nb + 1)], np.float32)
    np.testing.assert_allclose(ours, theirs, rtol=1e-6)
    assert ours[nb] == 0.0 and np.all(np.diff(ours) < 0)
    sigma = np.concatenate([ours[:nb], [1e-6, 0.5]]).astype(np.float32)
    for a, b in zip(rf._precond(torch.from_numpy(sigma)),
                    jm._precond(jnp.asarray(sigma))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   **FORWARD_TOL)


def test_loss_and_gradients_match_jax(net_params):
    jm, rf = JaxEDM(CFG), _loaded(CFG, net_params)
    x1, _, cond, tcond = _inputs(2)
    rng = jax.random.PRNGKey(5)

    def loss_fn(p):
        return jm.diffusion_loss(p, rng, jnp.asarray(x1), jnp.asarray(tcond),
                                 jnp.asarray(cond))
    (jloss, (jx, jc)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(net_params)
    k_noise, k_sigma, _ = jax.random.split(rng, 3)
    noise = np.asarray(jax.random.normal(k_noise, x1.shape))
    normal = np.asarray(jax.random.normal(k_sigma, (B,)))

    loss, (x_noised, c_skip) = rf.diffusion_loss(
        *_t(x1, tcond, cond, noise, normal),
        train=TrainMode(torch.Generator().manual_seed(0)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=common.METRIC_RTOL)
    np.testing.assert_allclose(x_noised.numpy(), np.asarray(jx),
                               **FORWARD_TOL)
    np.testing.assert_allclose(c_skip.numpy(), np.asarray(jc), rtol=1e-6)
    grads = torch.autograd.grad(loss, list(rf.net.parameters()))
    common.check_grads(rf.net, grads, jgrads["params"], {}, "net")


@pytest.mark.parametrize("heun", [True, False])
def test_sample_matches_jax(net_params, heun):
    cfg = edm_config(**{"edm.heun": heun})
    jm, rf = JaxEDM(cfg), _loaded(cfg, net_params)
    x0, _, cond, tcond = _inputs(3)
    for nb in (1, 3):
        y = jm.sample(net_params, jnp.asarray(x0), jnp.asarray(cond),
                      jnp.asarray(tcond), nb, 2.0, 0.5)
        with torch.no_grad():
            py = rf.sample(*_t(x0, cond, tcond), nb, 2.0, 0.5)
        _close(f"heun={heun} nb={nb}", py.numpy(), np.asarray(y))


def test_stream_matches_jax_and_the_offline_euler_sampler(net_params):
    cfg = edm_config(**{"edm.heun": False})
    jm = JaxEDM(cfg)
    rf = _loaded(cfg, net_params, streaming=True)
    chunk = cfg.denoiser.attention_chunk_size
    x0, _, cond, tcond = _inputs(4, batch=1)
    zeros = (np.zeros((3, chunk, C), np.float32), np.zeros(3, np.float32),
             np.zeros((3, cfg.zt_channels), np.float32),
             np.zeros((3, chunk, cfg.zs_channels), np.float32))
    jcache = init_stream_state(jm.net_stream, *map(jnp.asarray, zeros))
    cache = init_cache(lambda c: rf.net(*_t(*zeros), cache=c))
    outs = []
    for i in range(0, T, chunk):
        sl = slice(i, i + chunk)
        with torch.no_grad():
            outs.append(rf.sample_stream(cache, *_t(x0[:, sl], cond,
                                                    tcond[:, sl]),
                                         3, 1.5, 1.0))
        if i < 2 * chunk:       # two buffers against JAX, cache carried
            y, jcache = jm.sample_stream(
                net_params, jcache, jnp.asarray(x0[:, sl]),
                jnp.asarray(cond), jnp.asarray(tcond[:, sl]), 3, 1.5, 1.0)
            _close(f"buffer {i // chunk}", outs[-1].numpy(), np.asarray(y))
    offline = _loaded(cfg, net_params)
    with torch.no_grad():
        y_off = offline.sample(*_t(x0, cond, tcond), 3, 1.5, 1.0)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), y_off.numpy(),
                               **STREAM_OFFLINE_TOL)


def test_bf16_denoise_matches_jax(net_params):
    jm, rf = JaxEDM(CFG), _loaded(CFG, net_params)
    x, _, cond, tcond = _inputs(6)
    x = 3.0 * x
    sigma = np.array([0.3, 7.0], np.float32)
    args = tuple(map(jnp.asarray, (x, sigma, cond, tcond)))
    j32 = jax.jit(jm.denoise)(net_params, *args)
    j16 = jax.jit(lambda p, *a: jm.denoise(p, *a, compute_dtype=jnp.bfloat16))(
        cast_floating(net_params, jnp.bfloat16), *args)
    rf.net.to(torch.bfloat16)
    with torch.no_grad():
        p16 = rf.denoise(*_t(x, sigma, cond, tcond),
                         compute_dtype=torch.bfloat16)
    assert p16.dtype == torch.float32
    bf16_close("EDM denoise", p16.numpy(), np.asarray(j16), np.asarray(j32))


CYCLE = {"train.cycle_consistency": True, "train.cycle_start_step": 0,
         "train.cycle_weights": (0.15, 0.15),
         "train.cycle_loss_type": "mse_margin_0.05",
         "train.cycle_scaling": "ramps", "train.cycle_swap_target": "cond"}


@pytest.mark.parametrize("kind", ["phase2", "cycle"])
def test_trainer_step_matches_jax(kind):
    """A phase-2 step with the adversarial term, and a cycle step (its ramp
    reads c_skip as the flow's t, its estimate inverts it to sigma)."""
    cfg = common.no_dropout(diffusion_type="edm",
                            **(CYCLE if kind == "cycle" else {}))
    jtr = common.identity_trainer(cfg)
    metrics, grads = common.check_diffusion_step(
        cfg, jtr, common.random_variables(common.variable_shapes(jtr), 6),
        common.batch(6), jax.random.PRNGKey(13),
        (False, True, True, kind == "cycle"), (0.05, 1.0))
    if kind == "cycle":
        assert float(metrics["cycle_cond"]) > 0
    assert any(float(g.abs().max()) > 0 for g in grads["net"])


def test_transfer_matches_jax():
    check_transfer({"diffusion_type": "edm"})


def test_artifact_matches_the_live_streamer(tmp_path):
    cfg = dataclasses.replace(crossfade_config(), diffusion_type="edm")
    pipe = TransferPipeline(cfg, device="cpu").init(3)
    streamer = Streamer(cfg, chunk_size=4, device="cpu", pipeline=pipe)
    assert isinstance(streamer.rf, EDM)
    out = export_streamer(streamer, str(tmp_path / "edm"), nb_steps=2)
    host = ExportedStreamer(out, device="cpu")
    assert host.manifest["config"]["diffusion_type"] == "edm"
    state = streamer.init_state(1)
    rng = np.random.RandomState(11)
    for nb, gt, gs in [(1, 2.0, 0.5), (3, 1.0, 1.0)]:
        zs = rng.randn(1, 4, cfg.zs_channels).astype(np.float32)
        zt = rng.randn(1, cfg.zt_channels).astype(np.float32)
        x0 = rng.randn(1, 4, cfg.denoiser.n_channels).astype(np.float32)
        for name, value in (("nb_steps", nb), ("guidance_timbre", gt),
                            ("guidance_structure", gs)):
            host.set_attribute(name, value)
        y = host.call("diffuse", zs, zt, x0=x0)
        ref, state = streamer.diffuse(state, zs, zt, nb, gt, gs, x0=x0)
        err = float((y - ref).abs().max())
        print(f"nb {nb}: max abs difference {err:.3e} of "
              f"{float(ref.abs().max()):.3e}")
        assert err <= LIVE_TOL * float(ref.abs().max()), (nb, gt, gs)


def test_train_cli_trains_edm(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _z_store(tmp_path / "zdb")
    assert cli.main(_diff_args(tmp_path, 2, "--device", "cpu", "--model",
                               "edm")) == 0
    run = tmp_path / "runs" / "r"
    with open(run / "config.json") as f:
        assert json.load(f)["diffusion_type"] == "edm"
    assert restore_checkpoint(str(run))["step"] == 2
    with open(run / "metrics.jsonl") as f:
        entries = [json.loads(line) for line in f]
    losses = [e["val_diffusion_loss"] for e in entries
              if "val_diffusion_loss" in e]
    assert losses and all(np.isfinite(v) for e in entries
                          for v in e.values())
