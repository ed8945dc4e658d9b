"""The port's serving calls, in the stage form its CUDA graphs capture,
against the JAX package's one-call serving, on the CPU (where the same
stages run eagerly).

- ``Streamer.forward`` at batch 2 over 8 buffers in which ``nb_steps`` and
  both guidances change every buffer, against the JAX ``Streamer.forward``
  (one jitted call with traced ``nb_steps`` and guidances) with the same
  ``x0``; ``generate`` and ``generate_timbre`` likewise;
- ``TransferPipeline.transfer`` with non-default guidances against the JAX
  ``transfer`` (one jitted call), the same ``x0``;
- the per-device constants of ``fourier_features`` and FSQ, bit-equal to
  the per-call construction they replace;
- the warm-up that precedes a capture leaves a stream state as it was, at
  the same addresses.

Micro configs of tests/test_diffusion.py and tests/test_torch_pipeline.py.
Tolerance: CODEC_TOL of tests/test_torch_streaming.py, atol 1e-4 and rtol
1e-4 on the waveforms (f32 on both sides, summed in other orders);
equality for the constants and the restored state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu import config as jax_config
from after_tpu.diffusion import TransferPipeline as JaxPipeline
from after_tpu_torch import config as port_config
from after_tpu_torch.diffusion.pipeline import TransferPipeline
from after_tpu_torch.diffusion.rectified_flow import guidance_mix
from after_tpu_torch.models.denoiser import fourier_features
from after_tpu_torch.ops.fsq import FSQ
from after_tpu_torch.streaming.state import flatten_state
from tests.test_diffusion import micro_config
from tests.test_torch_pipeline import N_SIGNAL, OVERRIDES
from tests.test_torch_streamer import _perturbed, stream_pair

CODEC_TOL = dict(atol=1e-4, rtol=1e-4)
B = 2
# (nb_steps, guidance_timbre, guidance_structure) of each buffer
ATTRIBUTES = [(1, 1.7, 0.3), (3, 2.0, 1.5), (2, 1.0, 1.0), (4, 0.5, 2.5),
              (1, 3.0, 0.0), (16, 1.2, 0.8), (2, 2.0, 0.005), (5, 1.7, 0.3)]


@pytest.fixture(scope="module")
def streamers():
    cfg = jax_config.with_overrides(micro_config(), {
        "autoencoder.causal": False, "autoencoder.use_norm": True})
    return stream_pair(cfg)


def _audio(seed, n, A):
    rng = np.random.RandomState(seed)
    return [((0.3 * rng.randn(B, A, 1)).astype(np.float32),
             (0.3 * rng.randn(B, A, 1)).astype(np.float32))
            for _ in range(n)]


def _x0(key, js):
    return np.array(jax.random.normal(
        key, (B, js.chunk_size, js.cfg.denoiser.n_channels)))


def test_forward_with_changing_attributes_matches_jax(streamers):
    variables, js, ps = streamers
    jstate, pstate = js.init_state(variables, B), ps.init_state(B)
    for i, ((a, b), (nb, gt, gs)) in enumerate(zip(
            _audio(7, len(ATTRIBUTES), ps.audio_chunk), ATTRIBUTES)):
        key = jax.random.PRNGKey(200 + i)
        y, jstate = js.forward(variables, jstate, jnp.asarray(a),
                               jnp.asarray(b), nb, gt, gs, rng=key)
        py, pstate = ps.forward(pstate, a, b, nb, gt, gs, x0=_x0(key, js))
        np.testing.assert_allclose(py.numpy(), np.asarray(y), **CODEC_TOL,
                                   err_msg=f"buffer {i}")


def test_generate_and_generate_timbre_match_jax(streamers):
    """The stage pairs that skip an encoder: structure codes and a timbre
    vector given, then structure audio and a timbre vector given."""
    variables, js, ps = streamers
    cfg = js.cfg
    rng = np.random.RandomState(8)
    jstate, pstate = js.init_state(variables, B), ps.init_state(B)
    for i, (nb, gt, gs) in enumerate(ATTRIBUTES[:4]):
        key = jax.random.PRNGKey(300 + i)
        zs = rng.randn(B, js.chunk_size, cfg.zs_channels).astype(np.float32)
        zt = rng.randn(B, cfg.zt_channels).astype(np.float32)
        y, jstate = js.generate(variables, jstate, jnp.asarray(zs),
                                jnp.asarray(zt), nb, gt, gs, rng=key)
        py, pstate = ps.generate(pstate, zs, zt, nb, gt, gs, x0=_x0(key, js))
        np.testing.assert_allclose(py.numpy(), np.asarray(y), **CODEC_TOL)
        a = (0.3 * rng.randn(B, ps.audio_chunk, 1)).astype(np.float32)
        y, jstate = js.generate_timbre(variables, jstate, jnp.asarray(a),
                                       jnp.asarray(zt), nb, gt, gs, rng=key)
        py, pstate = ps.generate_timbre(pstate, a, zt, nb, gt, gs,
                                        x0=_x0(key, js))
        np.testing.assert_allclose(py.numpy(), np.asarray(y), **CODEC_TOL)


def test_transfer_with_guidances_matches_jax():
    cfg = jax_config.get_config("base", **OVERRIDES).resolved(
        in_size=8, n_signal=N_SIGNAL)
    jpipe = JaxPipeline(cfg)
    variables = _perturbed(
        jax.jit(jpipe.init, static_argnums=1)(jax.random.PRNGKey(0), 1), 1)
    pipe = TransferPipeline(port_config.from_json(jax_config.to_json(cfg)),
                            device="cpu").load_jax(variables)
    rng = np.random.RandomState(4)
    n = N_SIGNAL * cfg.autoencoder.ratio
    key = jax.random.PRNGKey(9)
    x0 = np.array(jax.random.normal(key, (1, N_SIGNAL, 8)))
    for gt, gs in [(1.7, 0.3), (0.5, 2.5)]:
        a = (0.3 * rng.randn(1, n, 1)).astype(np.float32)
        b = (0.3 * rng.randn(1, n, 1)).astype(np.float32)
        y = jpipe.transfer(variables, jnp.asarray(a), jnp.asarray(b), 3,
                           gt, gs, rng=key)
        py = pipe.transfer(a, b, nb_steps=3, guidance_timbre=gt,
                           guidance_structure=gs, x0=x0)
        np.testing.assert_allclose(py.numpy(), np.asarray(y), **CODEC_TOL)


@pytest.mark.parametrize("gt,gs", [(2.0, 1.5), (1.7, 0.3), (1.0, 0.0),
                                   (0.3, 1e-3)])
def test_guidance_mix_is_the_f32_mix(gt, gs):
    """The mix's scalars are JAX's f32 ones: 0.5 * (gs + gt) and
    gt / max(gs, 0.01), computed in f32."""
    total, factor = guidance_mix(gt, torch.tensor(gs))
    jt = 0.5 * (jnp.float32(gs) + jnp.float32(gt))
    jf = jnp.float32(gt) / jnp.maximum(jnp.float32(gs), 0.01)
    assert total == np.float32(jt) and factor == np.float32(jf)


@pytest.mark.parametrize("channels", [16, 64, 256])
def test_fourier_features_bit_equal_to_per_call_constant(channels):
    rng = np.random.RandomState(channels)
    t = torch.from_numpy(rng.uniform(0, 1, 6).astype(np.float32))
    half = channels // 2
    freqs = torch.pow(torch.tensor(1.0 / 10_000.0, dtype=torch.float32),
                      torch.arange(half, dtype=torch.float32) / half)
    ang = (t * 100.0)[:, None] * freqs[None, :]
    want = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    for _ in range(2):        # first call builds the constant, then reuses it
        assert torch.equal(fourier_features(t, channels), want)


def test_fsq_bit_equal_to_per_call_levels():
    levels = (5, 4, 7, 8)
    rng = np.random.RandomState(1)
    z = torch.from_numpy(3 * rng.randn(2, 5, 4).astype(np.float32))
    lv = torch.tensor(levels, dtype=torch.float32)
    half_l = (lv - 1) * (1 - 1e-3) / 2
    offset = torch.where(lv % 2 == 0, 0.5, 0.0).to(torch.float32)
    bounded = (torch.tanh(z + torch.atanh(offset / half_l)) * half_l
               - offset)
    want = (bounded + (torch.round(bounded) - bounded)) / torch.floor(lv / 2)
    fsq = FSQ(levels)
    for _ in range(2):
        assert torch.equal(fsq.quantize(z), want)


def test_warm_up_leaves_the_state_as_it_was(streamers):
    """The warm-up before a capture runs every stage (each KV slot's step
    included) on the state, then writes it back in place."""
    _, _, ps = streamers
    state = ps.init_state(B)
    for i, (a, b) in enumerate(_audio(9, 3, ps.audio_chunk)):
        ps.forward(state, a, b, i + 1, 1.7, 0.3)
    before = {k: t.clone() for k, t in flatten_state(state).items()}
    ptrs = {k: t.data_ptr() for k, t in flatten_state(state).items()}
    zs_shape, y_shape = ps.warm_up(state)
    assert zs_shape == (B, ps.chunk_size, ps.cfg.zs_channels)
    assert y_shape == (B, ps.audio_chunk, 1)
    after = flatten_state(state)
    assert {k: t.data_ptr() for k, t in after.items()} == ptrs
    for k, t in after.items():
        assert torch.equal(t, before[k]), k
