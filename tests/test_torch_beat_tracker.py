"""The port's Beat This! tracker (after_tpu_torch/dataset/beat_tracker.py)
against the JAX package's.

- ``BeatThis`` at a narrow width (transformer_dim 64, 2 layers, stem_dim
  16, head_dim 8) within 1e-5 x max of the JAX module, its perturbed
  variables (batch statistics included) carried by
  ``utils.from_jax.load_beat_this``;
- ``log_mel_spect`` within 1e-5 x max; both postprocessors (peak picking,
  the bar-pointer DBN) bitwise equal on the same logits;
- ``Audio2Beats`` end to end at that width, chunks and borders included:
  logits within 1e-5 x max and equal beats;
- ``map_torch_state_dict`` on a synthetic reference state dict with the
  full key set (the full-size model's weights under the reference's names,
  with torch.compile's prefix): the port loads the same tensors as the JAX
  package maps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu.dataset import beat_tracker as jbt
from after_tpu_torch.dataset import beat_tracker as bt
from after_tpu_torch.utils.from_jax import load_beat_this

REL = 1e-5
NARROW = dict(transformer_dim=64, n_layers=2, stem_dim=16, head_dim=8)


def _close(ours, theirs):
    theirs = np.asarray(theirs)
    ours = np.asarray(ours)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=REL * np.abs(theirs).max())


def _narrow_pair(seed=0):
    rng = np.random.RandomState(seed)
    jnet = jbt.BeatThis(**NARROW)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jnet.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, bt.N_MELS))))

    def perturb(tree, positive=False):
        return {k: perturb(v, positive) if isinstance(v, dict) else
                (np.abs(v * (1 + 0.3 * rng.uniform(-1, 1, v.shape))
                        + 0.05 * rng.randn(*v.shape)) if positive else
                 v * (1 + 0.3 * rng.uniform(-1, 1, v.shape))
                 + 0.05 * rng.randn(*v.shape)).astype(np.float32)
                for k, v in tree.items()}
    variables = {"params": perturb(variables["params"]),
                 "batch_stats": perturb(variables["batch_stats"], True)}
    net = bt.BeatThis(**NARROW).eval()
    load_beat_this(net, variables)
    return jnet, variables, net


def _audio(seconds, seed=1):
    rng = np.random.RandomState(seed)
    t = np.arange(int(44100 * seconds)) / 44100.0
    clicks = (np.sin(2 * np.pi * 2.0 * t) > 0.99).astype(np.float64)
    return (0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.6 * clicks
            + 0.02 * rng.randn(len(t))).astype(np.float32)


def test_beat_this_matches_jax_through_load_beat_this():
    jnet, variables, net = _narrow_pair()
    spect = np.random.RandomState(2).randn(2, 64, bt.N_MELS).astype(
        np.float32)
    theirs = jax.jit(jnet.apply)(variables, jnp.asarray(spect))
    with torch.no_grad():
        ours = net(torch.from_numpy(spect))
    for k in ("beat", "downbeat"):
        _close(ours[k].numpy(), theirs[k])


def test_log_mel_spect_matches_jax():
    x = _audio(1.0)[::2].copy()          # 22.05 kHz
    _close(bt.log_mel_spect(torch.from_numpy(x)).numpy(),
           jbt.log_mel_spect(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["minimal", "dbn"])
def test_postprocessors_are_bitwise_jax(kind):
    rng = np.random.RandomState(3)
    T, period = 300, 23
    beat = np.full(T, -5.0) + 0.5 * rng.randn(T)
    down = np.full(T, -6.0) + 0.5 * rng.randn(T)
    beat[7::period] = 4.0
    down[7::4 * period] = 4.0
    ours = bt.Postprocessor(kind)(beat.astype(np.float32),
                                  down.astype(np.float32))
    theirs = jbt.Postprocessor(kind)(beat.astype(np.float32),
                                     down.astype(np.float32))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert len(ours[0]) >= 10


def test_audio2beats_end_to_end_matches_jax():
    jnet, variables, net = _narrow_pair()
    # the JAX tracker at the same narrow width, without its full-size init
    jtrack = jbt.Audio2Beats.__new__(jbt.Audio2Beats)
    jtrack.postprocessor = jbt.Postprocessor("minimal")
    jtrack.net, jtrack.variables = jnet, variables
    captured = {}
    apply = jax.jit(jnet.apply)

    def fwd(v, s):
        out = apply(v, s)
        captured.setdefault("chunks", []).append(
            {k: np.asarray(o) for k, o in out.items()})
        return out
    jtrack._fwd = fwd
    track = bt.Audio2Beats(net=net, device="cpu")
    audio = _audio(31.0)                 # 1551 frames: two chunks
    theirs = jtrack(audio, 44100)
    beat, down = track.logits(audio, 44100)
    assert len(captured["chunks"]) == 2
    ours = track.postprocessor(beat, down)
    assert len(beat) == 1551 and (beat[:bt.Audio2Beats.BORDER] == -1000).all()
    # the same frames as the JAX run, rebuilt from its chunk outputs
    jbeat = np.full(len(beat), -1000.0, np.float32)
    C, Bd = jbt.Audio2Beats.CHUNK, jbt.Audio2Beats.BORDER
    for s, out in zip(range(-Bd, len(beat) - Bd, C - 2 * Bd),
                      captured["chunks"]):
        lo, hi = max(s, 0) + Bd, min(s + C, len(beat))
        jbeat[lo:hi] = out["beat"][0][lo - s:hi - s]
    _close(beat, jbeat)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_map_torch_state_dict_full_key_set():
    torch.manual_seed(4)
    source = bt.BeatThis().eval()
    with torch.no_grad():
        for m in source.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    sd = {"_orig_mod.model." + k: v
          for k, v in bt.reference_state_dict(source).items()}
    assert len(sd) == len(source.state_dict())
    ours = bt.BeatThis().eval()
    ours.load_state_dict(bt.map_torch_state_dict(sd))
    via_jax = bt.BeatThis().eval()
    load_beat_this(via_jax, jax.tree_util.tree_map(
        np.asarray, jbt.map_torch_state_dict(sd)))
    for key, value in source.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        torch.testing.assert_close(ours.state_dict()[key], value, rtol=0,
                                   atol=0)
        torch.testing.assert_close(via_jax.state_dict()[key], value, rtol=0,
                                   atol=0)
