"""The port's Streamer against the JAX package's Streamer, on the CPU: the
causal, norm-free codec (``get_config(..., "streaming")``), which streams
exactly through cached convs, and the MIDI surface ``diffuse_midi``.
Shared checks and their tolerance: tests/test_torch_streamer.py (atol 1e-3
on the streamed output and on the stream state).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from after_tpu import config as jax_config
from tests.test_diffusion import micro_config
from tests.test_torch_streamer import (B, TOL, check_carry, check_forward,
                                       stream_pair)


@pytest.fixture(scope="module")
def streamers():
    cfg = jax_config.with_overrides(micro_config(), {
        "autoencoder.causal": True, "autoencoder.use_norm": False})
    return stream_pair(cfg)


def test_causal_forward_matches_jax(streamers):
    check_forward(*streamers)


def test_causal_state_carried_across(streamers):
    check_carry(*streamers, stack_layers=False)


def test_diffuse_midi_matches_jax():
    cfg = jax_config.with_overrides(micro_config(), {
        "autoencoder.causal": True, "autoencoder.use_norm": False,
        "zs_channels": 128, "denoiser.tcond_dim": 128,
        "structure_type": "midi"})
    cfg = dataclasses.replace(cfg, encoder_time=None, classifier=None)
    variables, js, ps = stream_pair(cfg)
    assert ps.method_specs() == js.method_specs()
    jstate, pstate = js.init_state(variables, B), ps.init_state(B)
    rng = np.random.RandomState(7)
    zt = rng.randn(B, cfg.zt_channels).astype(np.float32)
    for i in range(2):
        notes = np.zeros((B, 4, 8, 2), np.float32)
        notes[..., 0] = rng.randint(-3, 131, (B, 4, 8))
        notes[..., 1] = rng.randint(0, 128, (B, 4, 8))
        key = jax.random.PRNGKey(i)
        x0 = np.array(jax.random.normal(key, (B, 4, cfg.denoiser.n_channels)))
        z, jstate = js.diffuse_midi(variables, jstate, jnp.asarray(notes),
                                    jnp.asarray(zt), 2, 2.0, 1.0, rng=key)
        pz, pstate = ps.diffuse_midi(pstate, notes, zt, 2, 2.0, 1.0, x0=x0)
        np.testing.assert_allclose(pz.numpy(), np.asarray(z), **TOL)
