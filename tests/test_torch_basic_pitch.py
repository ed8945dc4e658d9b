"""The port's basic-pitch transcriber (after_tpu_torch/dataset/basic_pitch.py)
against the JAX package's.

- activations (contour, note, onset) within 1e-5 x max, with the JAX
  variables (perturbed, batch statistics and the CQT's scalar batch norm
  included) carried into the port by ``utils.from_jax.load_basic_pitch``;
- ``notes_from_activations`` gives equal notes on the same activations;
- both packages' ``load_torch_weights`` read one synthetic reference
  checkpoint (the port's random weights under the reference's names,
  ``reference_state_dict``) to the same activations and notes;
- without a card and without ``device="cpu"`` the model refuses to build.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from after_tpu.dataset import basic_pitch as jbp
from after_tpu_torch.dataset import basic_pitch as bp
from after_tpu_torch.utils.from_jax import load_basic_pitch

REL = 1e-5


def _audio(seconds=1.0, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(bp.AUDIO_SAMPLE_RATE * seconds)) / bp.AUDIO_SAMPLE_RATE
    x = sum(0.2 * np.sin(2 * np.pi * f * t) * (t > t0)
            for f, t0 in ((220.0, 0.1), (330.0, 0.3), (523.25, 0.5)))
    return (x + 0.01 * rng.randn(len(t))).astype(np.float32)


def _close(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].shape == theirs[k].shape, k
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0,
                                   atol=REL * np.abs(theirs[k]).max(),
                                   err_msg=k)


def _perturbed(variables, seed):
    rng = np.random.RandomState(seed)

    def f(v):
        v = np.asarray(v, dtype=np.float32)
        return (v * (1 + 0.3 * rng.uniform(-1, 1, v.shape))
                + 0.05 * rng.randn(*v.shape)).astype(np.float32)
    out = jax.tree_util.tree_map(f, variables)
    # variances stay positive
    out["net"]["batch_stats"] = jax.tree_util.tree_map(
        np.abs, out["net"]["batch_stats"])
    out["cqt_bn"] = {"mean": np.float32(0.2), "var": np.float32(0.7)}
    return out


def test_activations_match_jax_through_load_basic_pitch():
    jmodel = jbp.BasicPitch()
    variables = _perturbed(jmodel.init(jax.random.PRNGKey(0)), 1)
    jmodel.variables = variables
    model = bp.BasicPitch(device="cpu")
    load_basic_pitch(model, variables)
    audio = _audio()
    theirs = jmodel.activations(audio)
    ours = model.activations(audio)
    _close(ours, theirs)
    assert ours["contour"].shape == (len(audio) // bp.FFT_HOP,
                                     bp.N_FREQ_BINS_CONTOURS)


def test_front_end_pieces_match_jax():
    rng = np.random.RandomState(2)
    spec = np.abs(rng.randn(2, 30, 309)).astype(np.float32)
    log = bp.normalized_log(torch.from_numpy(spec))
    np.testing.assert_allclose(log.numpy(), np.asarray(
        jbp.normalized_log(spec)), rtol=0, atol=1e-6)
    h = bp.harmonic_stacking(log)
    np.testing.assert_array_equal(
        h.permute(0, 2, 3, 1).numpy(),
        np.asarray(jbp.harmonic_stacking(log.numpy())))


def test_notes_from_activations_match_jax():
    rng = np.random.RandomState(3)
    onsets = rng.uniform(0, 0.6, (200, 88)).astype(np.float32)
    frames = np.clip(rng.uniform(0, 0.4, (200, 88)), 0, 1).astype(np.float32)
    frames[20:120, 40] = 0.9
    frames[50:90, 47] = 0.8
    onsets[20, 40] = onsets[50, 47] = 0.95
    ours = bp.notes_from_activations(onsets, frames)
    theirs = jbp.notes_from_activations(onsets, frames)
    assert ([dataclasses.astuple(n) for n in ours.notes]
            == [dataclasses.astuple(n) for n in theirs.notes])
    assert any(n.pitch == 61 for n in ours.notes)
    assert all(type(n.pitch) is int and type(n.start) is float
               for n in ours.notes)


def test_both_load_one_reference_checkpoint(tmp_path):
    torch.manual_seed(0)
    source = bp.BasicPitch(device="cpu")
    with torch.no_grad():
        for m in source.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
        source.cqt_bn_mean.fill_(0.1)
        source.cqt_bn_var.fill_(0.9)
    path = str(tmp_path / "basic_pitch.pth")
    torch.save(bp.reference_state_dict(source), path)
    jmodel = jbp.BasicPitch()
    jmodel.variables = jbp.load_torch_weights(path)
    model = bp.BasicPitch(device="cpu")
    model.load_state_dict(bp.load_torch_weights(path))
    audio = _audio(0.8, seed=4)
    _close(model.activations(audio), jmodel.activations(audio))
    for key, value in source.state_dict().items():
        torch.testing.assert_close(model.state_dict()[key], value, rtol=0,
                                   atol=0)


def test_no_card_refuses(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bp.BasicPitch()
