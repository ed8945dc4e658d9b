"""The port's spectral ops and reconstruction losses against the JAX package.

Inputs from a numpy seed go through the JAX functions (their matmul-DFT
path at full f32 precision) and the port's (an FFT of the windowed frames).
Tolerances: spectra and filtered signals atol 1e-4 x their largest
magnitude; filter designs (numpy / scipy on both sides) equal to 1e-7;
losses rtol 1e-5.  Loss gradients: within 5e-3 x max |g| of JAX's, and the
port's f32 gradient within 5e-4 x max |g| of the port's own float64 one.
The log magnitudes of near-silent bins (A-weighting all but removes the
lowest bins) amplify the DFT's rounding: on these inputs the JAX package's
DFT-matrix gradient lies 1.7e-3 x max |g| from float64, the port's FFT
1.1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu.autoencoder import losses as jax_losses
from after_tpu.config import AETrainConfig as JaxTrainConfig
from after_tpu.ops import stft as jax_stft
from after_tpu_torch.autoencoder import losses
from after_tpu_torch.config import AETrainConfig
from after_tpu_torch.ops import stft

SCALES = dict(stft_fft_sizes=(256, 64), stft_hop_sizes=(64, 16),
              stft_win_lengths=(256, 64))


def _signal(seed, shape=(2, 2048)):
    rng = np.random.RandomState(seed)
    t = np.arange(shape[-1]) / 44100.0
    tone = np.sin(2 * np.pi * 440.0 * t) * 0.3
    return (tone + 0.1 * rng.randn(*shape)).astype(np.float32)


def _close(ours, theirs, rel=1e-4):
    theirs = np.asarray(theirs)
    ours = ours.detach().numpy()
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs,
                               atol=rel * np.abs(theirs).max(), rtol=0)


@pytest.mark.parametrize("n_fft,hop,win,center", [
    (256, 64, 256, True), (206, 103, 206, False), (128, 32, 100, True),
    (32, 8, 32, False)])
def test_stft_matches_jax(n_fft, hop, win, center):
    x = _signal(0)
    z = jax_stft.stft(jnp.asarray(x), n_fft, hop, win, center=center)
    ours = stft.stft(torch.from_numpy(x), n_fft, hop, win, center=center)
    _close(ours.real, jnp.real(z))
    _close(ours.imag, jnp.imag(z))


@pytest.mark.parametrize("power", [None, 1.0, 2.0])
def test_spectrogram_matches_jax(power):
    x = _signal(1)
    z = jax_stft.spectrogram(jnp.asarray(x), 334, 167, power=power,
                             normalized=True, center=False)
    ours = stft.spectrogram(torch.from_numpy(x), 334, 167, power=power,
                            normalized=True, center=False)
    if power is None:
        _close(ours.real, jnp.real(z))
        _close(ours.imag, jnp.imag(z))
    else:
        _close(ours, z)


def test_mel_spectrogram_and_filterbank_match_jax():
    x = _signal(2)
    np.testing.assert_allclose(stft.mel_filterbank(44100, 512, 40),
                               jax_stft.mel_filterbank(44100, 512, 40),
                               atol=1e-7)
    z = jax_stft.mel_spectrogram(jnp.asarray(x), 44100, 512, 128, 40)
    _close(stft.mel_spectrogram(torch.from_numpy(x), 44100, 512, 128, 40), z)


def test_a_weighting_and_prefilter_match_jax():
    taps = stft.a_weighting_fir(44100)
    np.testing.assert_allclose(taps, jax_stft.a_weighting_fir(44100),
                               atol=1e-7)
    x = _signal(3)
    y = jax_stft.fir_prefilter(jnp.asarray(x), jax_stft.a_weighting_fir(44100))
    _close(stft.fir_prefilter(torch.from_numpy(x), torch.from_numpy(taps)), y)


def _loss_and_grad(jax_fn, port_fn, x, y):
    jl, jg = jax.value_and_grad(jax_fn, argnums=1)(jnp.asarray(x),
                                                   jnp.asarray(y))

    def port(dtype):
        yt = torch.from_numpy(y).to(dtype).requires_grad_()
        loss = port_fn(torch.from_numpy(x).to(dtype), yt)
        return loss.item(), torch.autograd.grad(loss, yt)[0].numpy()

    loss, g = port(torch.float32)
    _, g64 = port(torch.float64)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(g, jg, atol=5e-3 * np.abs(jg).max(), rtol=0)
    np.testing.assert_allclose(g, g64, atol=5e-4 * np.abs(g64).max(), rtol=0)


@pytest.mark.parametrize("perceptual", [True, False])
def test_multi_resolution_stft_loss_and_gradient_match_jax(perceptual):
    x = _signal(4)[..., None]
    y = (x + 0.05 * np.random.RandomState(5).randn(*x.shape)).astype(
        np.float32)
    jcfg = JaxTrainConfig(perceptual_weighting=perceptual, **SCALES)
    pcfg = AETrainConfig(perceptual_weighting=perceptual, **SCALES)
    _loss_and_grad(
        lambda a, b: jax_losses.multi_resolution_stft_loss(a, b, jcfg),
        lambda a, b: losses.multi_resolution_stft_loss(a, b, pcfg), x, y)


@pytest.mark.parametrize("mels", [None, (40, 20)])
def test_spectral_distance_and_gradient_match_jax(mels):
    x = _signal(6)[..., None]
    y = (x + 0.05 * np.random.RandomState(7).randn(*x.shape)).astype(
        np.float32)
    _loss_and_grad(
        lambda a, b: jax_losses.spectral_distance(a, b, 44100, (512, 256),
                                                  mels),
        lambda a, b: losses.spectral_distance(a, b, 44100, (512, 256), mels),
        x, y)


def test_waveform_distance_matches_jax():
    x, y = _signal(8), _signal(9)
    for norm in ("L1", "L2"):
        np.testing.assert_allclose(
            losses.waveform_distance(torch.from_numpy(x), torch.from_numpy(y),
                                     norm).item(),
            float(jax_losses.waveform_distance(jnp.asarray(x), jnp.asarray(y),
                                               norm)), rtol=1e-6)
