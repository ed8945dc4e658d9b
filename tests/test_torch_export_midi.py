"""A MIDI model's artifact, the port's against the JAX package's, both
exported from the same weights, on the CPU: the causal, norm-free micro
codec and the MIDI micro config of tests/test_torch_streamer_causal.py,
batch 2.  8 buffers of ``diffuse_midi`` (note pairs -> latents, its
nb_steps and guidances changing) and ``decode`` of its latents, the port
fed the noise the JAX artifact draws from each key: rtol 1e-4 and
atol 1e-4 x max(1, max|y|), CODEC_TOL with its atol scaled to the tensor:
buffer 6's structure guidance of 0.005 mixes the guided rows with a factor
of 200 (``guidance_mix``), which takes the latents to hundreds, where the
f32 spacing is 6e-5.  The manifest's methods and MIDI keys are the JAX
artifact's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from after_tpu import config as jax_config
from after_tpu_torch.streaming.export import ExportedStreamer
from tests.test_diffusion import micro_config
from tests.test_torch_export_jax import B, JaxArtifact, export_pair
from tests.test_torch_serving import ATTRIBUTES, CODEC_TOL


def assert_close(ours, theirs, label):
    theirs = np.asarray(theirs)
    scale = max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(ours, theirs, rtol=CODEC_TOL["rtol"],
                               atol=CODEC_TOL["atol"] * scale, err_msg=label)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    cfg = jax_config.with_overrides(micro_config(), {
        "autoencoder.causal": True, "autoencoder.use_norm": False,
        "zs_channels": 128, "denoiser.tcond_dim": 128,
        "structure_type": "midi"})
    cfg = dataclasses.replace(cfg, encoder_time=None, classifier=None)
    return export_pair(cfg, tmp_path_factory)


def test_diffuse_midi_and_decode_match_jax(artifacts):
    variables, js, ps, jax_out, port_out = artifacts
    theirs, ours = JaxArtifact(jax_out), ExportedStreamer(port_out, "cpu")
    jm, pm = theirs.host.manifest, ours.manifest
    assert pm["methods"] == jm["methods"]
    assert pm["n_poly"] == jm["n_poly"] == 8
    assert pm["stages"]["diffuse_midi"] == ["piano_roll", "step"]
    assert not ours.has_method("forward")
    rng = np.random.RandomState(7)
    zt = rng.randn(B, ps.cfg.zt_channels).astype(np.float32)
    for i, (nb, gt, gs) in enumerate(ATTRIBUTES):
        for host in (theirs.host, ours):
            host.set_attribute("nb_steps", nb)
            host.set_attribute("guidance_timbre", gt)
            host.set_attribute("guidance_structure", gs)
        notes = np.zeros((B, 4, 8, 2), np.float32)
        notes[..., 0] = rng.randint(-3, 131, (B, 4, 8))
        notes[..., 1] = rng.randint(0, 128, (B, 4, 8))
        key = jax.random.key_data(jax.random.PRNGKey(i))
        x0 = np.array(jax.random.normal(jax.random.wrap_key_data(key), (
            B, 4, ps.cfg.denoiser.n_channels)))
        z = theirs.call("diffuse_midi", jnp.asarray(notes), jnp.asarray(zt),
                        key)
        pz = ours.call("diffuse_midi", notes, zt, x0=x0)
        assert_close(pz.numpy(), z, f"latents, buffer {i}")
        y = theirs.call("decode", z)
        py = ours.call("decode", pz)
        assert_close(py.numpy(), y, f"audio, buffer {i}")
