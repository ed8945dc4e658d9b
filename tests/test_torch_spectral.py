"""The port's mel filterbanks and spectral front ends against the JAX
package's: ``mel_filterbank`` (numpy on both sides) equal over the HTK /
Slaney scales, area normalisation and band edges; ``multirate_cqt`` (the
basic-pitch front end), ``StreamableCQT`` and ``StreamableMelSpectrogram``,
offline and chunk by chunk with their ring buffers, within 1e-5 x the
largest magnitude."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu.ops import stft as jax_stft
from after_tpu.ops import streaming_spectral as jax_ss
from after_tpu_torch.ops import stft
from after_tpu_torch.ops import streaming_spectral as ss
from after_tpu_torch.streaming.state import name_slots

REL = 1e-5


def _close(ours, theirs):
    theirs = np.asarray(theirs)
    ours = ours.detach().numpy()
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=REL * np.abs(theirs).max())


def _audio(seed, shape):
    rng = np.random.RandomState(seed)
    t = np.arange(shape[-1]) / 22050.0
    return (0.3 * np.sin(2 * np.pi * 440.0 * t * (1 + 0.5 * t))
            + 0.05 * rng.randn(*shape)).astype(np.float32)


@pytest.mark.parametrize("htk,slaney_norm,fmin,fmax", list(itertools.product(
    (True, False), (False, True), (0.0, 30.0), (None, 11000.0))))
def test_mel_filterbank_matches_jax(htk, slaney_norm, fmin, fmax):
    args = (22050, 1024, 64, fmin, fmax, htk, slaney_norm)
    np.testing.assert_array_equal(stft.mel_filterbank(*args),
                                  jax_stft.mel_filterbank(*args))


def test_mel_filterbank_default_is_htk():
    np.testing.assert_array_equal(
        stft.mel_filterbank(44100, 2048, 128),
        jax_stft.mel_filterbank(44100, 2048, 128, htk=True))


@pytest.mark.parametrize("n,hop", [(22050, 256), (10000, 128)])
def test_multirate_cqt_matches_jax(n, hop):
    x = _audio(0, (2, n))
    args = (22050, 27.5, 309, 36, hop)
    _close(ss.multirate_cqt(torch.from_numpy(x), *args),
           jax_ss.multirate_cqt(jnp.asarray(x), *args))


def _jax_chunks(module, x, chunks):
    variables = module.init(jax.random.PRNGKey(0), x[:, :chunks[0]])
    # init leaves the ring holding the first chunk's tail: start at zero
    cache = {"cache": jax.tree_util.tree_map(jnp.zeros_like,
                                             variables["cache"])}
    outs, start = [], 0
    for n in chunks:
        y, mut = module.apply(cache, x[:, start:start + n],
                              mutable=["cache"])
        cache = {"cache": mut["cache"]}
        outs.append(np.asarray(y))
        start += n
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("kind", ["cqt", "mel"])
def test_streamable_front_ends_match_jax(kind):
    x = _audio(1, (2, 8192))[..., None]
    if kind == "cqt":
        kw = dict(sr=22050, fmin=110.0, n_bins=48, hop=256)
        make, jax_make = ss.StreamableCQT, jax_ss.StreamableCQT
    else:
        kw = dict(sr=22050, n_fft=1024, hop=256, n_mels=40)
        make, jax_make = ss.StreamableMelSpectrogram, \
            jax_ss.StreamableMelSpectrogram
    # offline
    y = jax_make(**kw).apply({}, jnp.asarray(x))
    _close(make(**kw)(torch.from_numpy(x)), y)
    # chunk by chunk: the ring buffer carries the overlap
    chunks = [2048, 1024, 3072, 2048]
    theirs = _jax_chunks(jax_make(**kw, streaming=True), jnp.asarray(x),
                         chunks)
    module = make(**kw, streaming=True)
    name_slots(module)
    cache, outs, start = {}, [], 0
    for n in chunks:
        outs.append(module(torch.from_numpy(x[:, start:start + n]), cache))
        start += n
    _close(torch.cat(outs, dim=1), theirs)
    assert list(cache) == ["audio_ring"]
