"""The port's Streamer against the JAX package's Streamer, on the CPU: the
crossfade path of the non-causal GroupNorm codec (the base config's path).
tests/test_torch_streamer_causal.py runs the same checks on the causal,
norm-free codec and the MIDI surface.

Micro config of the JAX package's diffusion tests (4-band codec, 2-layer
denoiser of width 64).  Both packages load the same perturbed weights and
stream the same audio at batch 2; the port gets the ``x0`` that the JAX
streamer draws from its key.
Tolerance: atol 1e-3 on the streamed waveform, and on the stream state
after the last buffer (a codec, two encoders and up to 4 sampler steps deep
per buffer, f32 on both sides); equality for integer counters and shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu import config as jax_config
from after_tpu.diffusion import TransferPipeline as JaxPipeline
from after_tpu.streaming.streamer import Streamer as JaxStreamer
from after_tpu.utils.latent_map import SmallAutoencoder as JaxProjector
from after_tpu_torch import config as port_config
from after_tpu_torch.diffusion.pipeline import TransferPipeline
from after_tpu_torch.streaming import Streamer
from after_tpu_torch.streaming.state import flatten_state
from after_tpu_torch.utils.from_jax import load_module, load_stream_state
from after_tpu_torch.utils.latent_map import SmallAutoencoder
from tests.test_diffusion import micro_config

TOL = dict(atol=1e-3)
B = 2
STEPS = [1, 3, 2, 4, 1, 2]


def _perturbed(variables, seed):
    rng = np.random.RandomState(seed)

    def f(path, v):
        v = np.asarray(v, dtype=np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return (v * (1 + 0.2 * rng.uniform(-1, 1, v.shape))
                + 0.02 * rng.randn(*v.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, variables)


def stream_pair(cfg):
    """(JAX variables, JAX streamer, port streamer) on shared weights."""
    jpipe = JaxPipeline(cfg)
    variables = _perturbed(
        jax.jit(jpipe.init, static_argnums=1)(jax.random.PRNGKey(0), 1), 1)
    jstreamer = JaxStreamer(cfg, chunk_size=4)
    pcfg = port_config.from_json(jax_config.to_json(cfg))
    pipe = TransferPipeline(pcfg, device="cpu").load_jax(variables)
    return variables, jstreamer, Streamer(pcfg, chunk_size=4, device="cpu",
                                          pipeline=pipe)


@pytest.fixture(scope="module")
def streamers():
    cfg = jax_config.with_overrides(micro_config(), {
        "autoencoder.causal": False, "autoencoder.use_norm": True})
    return stream_pair(cfg)


def _buffers(seed, streamer, n):
    rng = np.random.RandomState(seed)
    A = streamer.audio_chunk
    return [((0.3 * rng.randn(B, A, 1)).astype(np.float32),
             (0.3 * rng.randn(B, A, 1)).astype(np.float32))
            for _ in range(n)]


def _forward_both(variables, js, jstate, ps, pstate, a, b, nb, key):
    x0 = np.array(jax.random.normal(
        key, (B, js.chunk_size, js.cfg.denoiser.n_channels)))
    y, jstate = js.forward(variables, jstate, jnp.asarray(a), jnp.asarray(b),
                           nb, 2.0, 1.5, rng=key)
    py, pstate = ps.forward(pstate, a, b, nb, 2.0, 1.5, x0=x0)
    assert tuple(py.shape) == y.shape == (B, ps.audio_chunk, 1)
    np.testing.assert_allclose(py.numpy(), np.asarray(y), **TOL)
    return jstate, pstate


def _check_state(pstate, jstate):
    ours = flatten_state(pstate)
    theirs = flatten_state(jax.tree_util.tree_map(np.asarray, jstate))
    assert ours.keys() == theirs.keys()
    for k, t in ours.items():
        assert tuple(t.shape) == theirs[k].shape, k
        np.testing.assert_allclose(t.numpy(), theirs[k], **TOL, err_msg=k)


def check_forward(variables, js, ps):
    """Six buffers with nb_steps changing between them; outputs and the
    whole stream state, whose tensors keep their storage across buffers."""
    jstate = js.init_state(variables, B)
    pstate = ps.init_state(B)
    _check_state(pstate, jstate)
    ptrs = {k: t.data_ptr() for k, t in flatten_state(pstate).items()}
    for i, (a, b) in enumerate(_buffers(3, ps, len(STEPS))):
        jstate, pstate = _forward_both(variables, js, jstate, ps, pstate,
                                       a, b, STEPS[i],
                                       jax.random.PRNGKey(100 + i))
    _check_state(pstate, jstate)
    assert ptrs == {k: t.data_ptr() for k, t in flatten_state(pstate).items()}


def check_carry(variables, js, ps, stack_layers):
    """Three buffers in JAX, the state carried into the port (with
    ``stack_layers``, the denoiser cache as JAX's scan_layers stacks it),
    three more in both."""
    buffers = _buffers(4, ps, 6)
    jstate = js.init_state(variables, B)
    for i, (a, b) in enumerate(buffers[:3]):
        _, jstate = js.forward(variables, jstate, jnp.asarray(a),
                               jnp.asarray(b), 2, 2.0, 1.5,
                               rng=jax.random.PRNGKey(i))
    carried = jax.tree_util.tree_map(np.asarray, jstate)
    if stack_layers:
        blocks = [carried.denoiser[f"block_{i}"] for i in range(2)]
        stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *blocks)
        carried = dataclasses.replace(
            carried, denoiser={"blocks": {"block": stacked}})
    pstate = ps.init_state(B)
    load_stream_state(ps, pstate, carried)
    _check_state(pstate, jstate)
    for i, (a, b) in enumerate(buffers[3:]):
        jstate, pstate = _forward_both(variables, js, jstate, ps, pstate,
                                       a, b, 3, jax.random.PRNGKey(10 + i))
    _check_state(pstate, jstate)


def test_forward_matches_jax(streamers):
    check_forward(*streamers)


def test_state_carried_across(streamers):
    check_carry(*streamers, stack_layers=True)


def test_load_stream_state_rejects_a_foreign_state(streamers):
    variables, js, ps = streamers
    jstate = jax.tree_util.tree_map(np.asarray, js.init_state(variables, B))
    bad = dataclasses.replace(jstate, enc_time={**jstate.enc_time,
                                                "extra": np.zeros(1)})
    with pytest.raises(ValueError, match="no place in the port"):
        load_stream_state(ps, ps.init_state(B), bad)
    with pytest.raises(ValueError, match="shape"):
        load_stream_state(ps, ps.init_state(B + 1), jstate)


def test_surfaces_match_jax(streamers):
    """method_specs, the decode lags, latent2map and map2latent."""
    variables, js, ps = streamers
    assert ps.method_specs() == js.method_specs()
    assert ps.decode_lag_frames == js.decode_lag_frames
    assert ps.decode_lag_samples == js.decode_lag_samples
    proj = JaxProjector(in_dim=js.cfg.zt_channels)
    pv = _perturbed(proj.init(jax.random.PRNGKey(5),
                              jnp.zeros((1, js.cfg.zt_channels))), 5)
    port_proj = SmallAutoencoder(in_dim=js.cfg.zt_channels)
    load_module(port_proj, pv, "projector")
    rng = np.random.RandomState(6)
    zt = rng.randn(B, js.cfg.zt_channels).astype(np.float32)
    xy = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    np.testing.assert_allclose(ps.latent2map(port_proj, zt).numpy(),
                               np.asarray(js.latent2map(pv, jnp.asarray(zt))),
                               atol=1e-5)
    np.testing.assert_allclose(ps.map2latent(port_proj, xy).numpy(),
                               np.asarray(js.map2latent(pv, jnp.asarray(xy))),
                               atol=1e-5)


def test_streamer_without_device_and_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config.from_json(jax_config.to_json(micro_config()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Streamer(cfg)
    # bf16 streams now: a pipeline of its own at the compute dtype, and a
    # pipeline at another dtype refused
    s16 = Streamer(cfg, device="cpu", compute_dtype=torch.bfloat16)
    assert s16.pipeline.compute_dtype == torch.bfloat16
    assert s16.new_state(1).prev_timbre.dtype == torch.bfloat16
    # a given pipeline's compute dtype is the streamer's
    assert Streamer(cfg, pipeline=s16.pipeline).compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute"):
        Streamer(cfg, device="cpu", compute_dtype="bfloat16",
                 pipeline=TransferPipeline(cfg, device="cpu"))
