"""The port's host transforms (after_tpu_torch/dataset/transforms.py)
against the JAX package's: numpy and scipy on both sides, so every output
is bitwise equal, randomness drawn from equal RandomStates included."""

import numpy as np
import pytest

from after_tpu.dataset import transforms as jax_tf
from after_tpu_torch.dataset import transforms as tf

SR = 22050


def _signal(seed, n=SR):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    clicks = (np.sin(2 * np.pi * 2.0 * t) > 0.995).astype(np.float64)
    return (0.3 * np.sin(2 * np.pi * 330.0 * t) + 0.5 * clicks
            + 0.02 * rng.randn(n)).astype(np.float32)


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rate", [0.8, 1.0, 1.3])
def test_phase_vocoder_stretch(rate):
    x = _signal(0)
    _equal(tf.phase_vocoder_stretch(x, rate),
           jax_tf.phase_vocoder_stretch(x, rate))


@pytest.mark.parametrize("semitones,stretch", [(-2.0, 0.9), (1.5, 1.2)])
def test_pitch_shift_time_stretch(semitones, stretch):
    x = _signal(1)
    _equal(tf.pitch_shift_time_stretch(x, SR, semitones, stretch),
           jax_tf.pitch_shift_time_stretch(x, SR, semitones, stretch))


def test_random_silence_draws_as_jax():
    x = _signal(2)
    ours, theirs = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(20):
        _equal(tf.random_silence(x, p=0.5, rng=ours),
               jax_tf.random_silence(x, p=0.5, rng=theirs))


def test_audio_descriptors():
    x = _signal(4)
    _equal(tf.audio_descriptors(x, SR, 37), jax_tf.audio_descriptors(x, SR, 37))


def test_beats_downbeats_and_beat_signal():
    x = _signal(5, 4 * SR)
    bpm, beats = tf.estimate_beats(x, SR)
    _equal((bpm, beats), jax_tf.estimate_beats(x, SR))
    assert len(beats) > 4
    downs = tf.estimate_downbeats(x, SR, beats)
    _equal(downs, jax_tf.estimate_downbeats(x, SR, beats))
    _equal(tf.get_beat_signal(beats, 4.0, 100),
           jax_tf.get_beat_signal(beats, 4.0, 100))
    # silence: no tempo, no beats
    _equal(tf.estimate_beats(np.zeros(SR, np.float32), SR),
           jax_tf.estimate_beats(np.zeros(SR, np.float32), SR))
