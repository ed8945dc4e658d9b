"""The port's Denoiser v1 (after_tpu_torch/models/denoiser_v1.py) against
the JAX package's, on the CPU, its parameters the JAX ``init`` tree carried
across by ``from_jax`` (flax's own names for the global embedding and the
separable MLP):

- offline, at a learnable position table: ``cross_attention``, ``adaln``,
  ``cross_attention`` with temporal noise, and the separable-conv MLP;
- streaming, chunk by chunk over 16 frames in chunks of 4 (window 16, 2 KV
  slots, rotary positions), with ``cross_attn_causal`` True and False:
  every chunk's output and both attentions' caches (``name_slots`` paths)
  against the JAX streaming module's;
- the wiring: one diffusion step of the port's trainer against JAX's
  ``DiffusionTrainer`` and a micro transfer against JAX's
  ``TransferPipeline``, each on a v1 config; a v1 artifact, whose state
  holds both attentions' KV caches, on the port's Python host against the
  live streamer.

Tolerances: the v2 denoiser's (tests/test_torch_denoiser.py,
tests/test_torch_streaming.py): atol 1e-5 on a forward and on each
streamed chunk and cache; the step's of tests/torch_diffusion_common.py;
the transfer's atol 1e-3 of tests/test_torch_pipeline.py; the artifact
within 1e-6 x max|y| of the live streamer (tests/test_torch_export.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu.config import DenoiserConfig as JaxDenoiserConfig
from after_tpu.models import DenoiserV1 as JaxV1
from after_tpu.models import DenoiserV1Config as JaxV1Config
from after_tpu.streaming import init_stream_state
from after_tpu_torch import config as port_config
from after_tpu_torch.diffusion.pipeline import TransferPipeline
from after_tpu_torch.models import make_denoiser
from after_tpu_torch.models.denoiser_v1 import DenoiserV1, DenoiserV1Config
from after_tpu_torch.streaming.export import ExportedStreamer, export_streamer
from after_tpu_torch.streaming.state import flatten_state, init_cache
from after_tpu_torch.streaming.streamer import Streamer
from after_tpu_torch.utils.from_jax import load_module
from tests import torch_diffusion_common as common
from tests.test_torch_export import LIVE_TOL, crossfade_config
from tests.torch_models_common import check_transfer

T, C, ZT, ZS = 32, 8, 6, 12
TOL = dict(atol=1e-5)
SMALL = dict(n_channels=C, seq_len=T, embed_dim=32, head_dim=16,
             rotary_dim=8, noise_embed_dims=8, n_layers=2, mlp_multiplier=2,
             cond_dim=ZT, tcond_dim=ZS, attention_chunk_size=4,
             local_attention_size=8, dropout=0.0)
STREAM = dict(SMALL, embed_dim=64, noise_embed_dims=16, causal=True,
              local_attention_size=16, max_diffusion_steps=2,
              pos_emb_type="rotary")


def _perturbed(variables, seed):
    rng = np.random.RandomState(seed)

    def f(v):
        v = np.asarray(v, dtype=np.float32)
        return (v * (1 + 0.2 * rng.uniform(-1, 1, v.shape))
                + 0.02 * rng.randn(*v.shape)).astype(np.float32)
    return jax.tree_util.tree_map(f, variables)


def _inputs(seed, B=2, frames=T):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, frames, C).astype(np.float32),
            rng.rand(B).astype(np.float32),
            rng.randn(B, ZT).astype(np.float32),
            rng.randn(B, frames, ZS).astype(np.float32))


def _port(base, streaming=False, **v1):
    cfg = DenoiserV1Config(base=port_config.DenoiserConfig(**base), **v1)
    return DenoiserV1(cfg, cond_in=ZT, tcond_in=ZS,
                      streaming=streaming).eval()


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("v1", [
    dict(), dict(tcond_mode="adaln"), dict(temporal_noise=True),
    dict(mlp_type="sep_conv")], ids=["cross_attention", "adaln",
                                     "temporal_noise", "sep_conv"])
def test_offline_forward_matches_jax(v1):
    base = dict(SMALL, pos_emb_type="learnable")
    jnet = JaxV1(JaxV1Config(base=JaxDenoiserConfig(**base), **v1))
    x, t, c, tc = _inputs(1)
    variables = _perturbed(jax.jit(jnet.init)(jax.random.PRNGKey(0), x, t, c,
                                              tc), 2)
    y = jax.jit(jnet.apply)(variables, x, t, c, tc)
    net = _port(base, **v1)
    load_module(net, variables, "net")
    with torch.no_grad():
        py = net(*_t(x, t, c, tc))
    assert py.shape == (2, T, C)
    np.testing.assert_allclose(py.numpy(), np.asarray(y), **TOL)


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal_cross", "reference_cross"])
def test_stream_matches_jax_chunk_by_chunk(causal):
    """Both packages' streaming modules over 4 chunks, KV slot 0 then 1
    alternating; the temporal noise feeds per-frame times."""
    v1 = dict(tcond_mode="cross_attention", temporal_noise=causal,
              cross_attn_causal=causal)
    jnet = JaxV1(JaxV1Config(base=JaxDenoiserConfig(**STREAM), **v1),
                 streaming=True)
    chunk = 4
    x, _, c, tc = _inputs(3, B=1, frames=16)
    t = np.array([0.3], np.float32)
    init = jax.jit(jnet.init)(jax.random.PRNGKey(0), x[:, :chunk], t, c,
                              tc[:, :chunk])
    params = _perturbed({"params": init["params"]}, 4)
    jcache = init_stream_state(jnet, *map(jnp.asarray, (
        x[:, :chunk], t, c, tc[:, :chunk])))
    net = _port(STREAM, streaming=True, **v1)
    load_module(net, params, "net")
    cache = init_cache(lambda cc: net(*_t(x[:, :chunk], t, c, tc[:, :chunk]),
                                      cache=cc))
    assert sorted(cache) == sorted(flatten_state(jcache))
    assert "block_1/cross_attn/k" in cache
    step = jax.jit(lambda p, cc, *a, i: jnet.apply(
        {"params": p, "cache": cc}, *a, cache_index=i, mutable=["cache"]),
        static_argnames="i")
    for n in range(4):
        sl = slice(n * chunk, (n + 1) * chunk)
        y, aux = step(params["params"], jcache, x[:, sl], t, c, tc[:, sl],
                      i=n % 2)
        jcache = aux["cache"]
        with torch.no_grad():
            py = net(*_t(x[:, sl], t, c, tc[:, sl]), cache=cache,
                     cache_index=n % 2)
        np.testing.assert_allclose(py.numpy(), np.asarray(y), **TOL,
                                   err_msg=f"chunk {n}")
        theirs = flatten_state(jcache)
        for k, v in cache.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(theirs[k]),
                                       **TOL, err_msg=f"chunk {n} {k}")


def test_make_denoiser_builds_v1():
    cfg = port_config.DenoiserConfig(**dict(STREAM, arch="v1"),
                                     v1_tcond_mode="adaln")
    net = make_denoiser(cfg, streaming=True, cond_in=ZT, tcond_in=ZS)
    assert isinstance(net, DenoiserV1) and net.cfg.tcond_mode == "adaln"
    assert dataclasses.asdict(net.cfg.base) == dataclasses.asdict(cfg)


V1 = {"denoiser.arch": "v1", "denoiser.v1_cross_attn_causal": True}


def test_v1_diffusion_step_matches_jax():
    cfg = common.no_dropout(**V1)
    jtr = common.identity_trainer(cfg)
    metrics, grads = common.check_diffusion_step(
        cfg, jtr, common.random_variables(common.variable_shapes(jtr), 4),
        common.batch(2), jax.random.PRNGKey(11), (False, True, True, False),
        (0.075, 1.0))
    assert any(float(g.abs().max()) > 0 for g in grads["net"])


def test_v1_transfer_matches_jax():
    check_transfer(V1)


def test_v1_artifact_exports_its_cross_attention_caches(tmp_path):
    cfg = port_config.with_overrides(crossfade_config(), V1)
    pipe = TransferPipeline(cfg, device="cpu").init(3)
    streamer = Streamer(cfg, chunk_size=4, device="cpu", pipeline=pipe)
    out = export_streamer(streamer, str(tmp_path / "v1"), nb_steps=2)
    host = ExportedStreamer(out, device="cpu")
    paths = host.manifest["state_paths"]
    for layer in range(cfg.denoiser.n_layers):
        for name in ("k", "v", "filled"):
            assert f"denoiser/block_{layer}/cross_attn/{name}" in paths
            assert f"denoiser/block_{layer}/self_attn/{name}" in paths
    state = streamer.init_state(1)
    rng = np.random.RandomState(12)
    for nb, gt, gs in [(2, 1.5, 1.0), (3, 2.0, 0.5)]:
        zs = rng.randn(1, 4, cfg.zs_channels).astype(np.float32)
        zt = rng.randn(1, cfg.zt_channels).astype(np.float32)
        x0 = rng.randn(1, 4, cfg.denoiser.n_channels).astype(np.float32)
        for name, value in (("nb_steps", nb), ("guidance_timbre", gt),
                            ("guidance_structure", gs)):
            host.set_attribute(name, value)
        y = host.call("diffuse", zs, zt, x0=x0)
        ref, state = streamer.diffuse(state, zs, zt, nb, gt, gs, x0=x0)
        assert float((y - ref).abs().max()) <= LIVE_TOL * float(
            ref.abs().max()), (nb, gt, gs)
