"""The port's MIDI file (after_tpu_torch/dataset/midi.py) against the JAX
package's, on the CPU: ``duration``, ``slice``, ``get_piano_roll`` and
``get_note_pairs`` (what a MIDI artifact's frontend feeds
``diffuse_midi``) of the same parsed file, equal.
"""

import numpy as np
import pytest

from after_tpu.dataset.midi import MidiFile as JaxMidi
from after_tpu.dataset.midi import Note as JaxNote
from after_tpu_torch.dataset.midi import MidiFile


@pytest.fixture(scope="module")
def midi_bytes(tmp_path_factory):
    rng = np.random.RandomState(0)
    notes = []
    for _ in range(40):
        start = float(rng.uniform(0, 4))
        notes.append(JaxNote(int(rng.randint(20, 100)),
                             int(rng.randint(1, 128)), start,
                             start + float(rng.uniform(0.05, 1.0))))
    path = tmp_path_factory.mktemp("midi") / "x.mid"
    JaxMidi(notes=notes).save(str(path))
    return path.read_bytes()


def _notes(mf):
    return [(n.pitch, n.velocity, n.start, n.end) for n in mf.notes]


def test_duration_and_slice_match_jax(midi_bytes):
    ours, theirs = MidiFile(data=midi_bytes), JaxMidi(data=midi_bytes)
    assert _notes(ours) == _notes(theirs)
    assert ours.duration() == theirs.duration() > 0
    for start, end in ((0.0, 1.0), (0.5, 2.25), (3.9, 10.0), (6.0, 7.0)):
        assert (_notes(ours.slice(start, end))
                == _notes(theirs.slice(start, end)))
    assert MidiFile().duration() == 0.0


@pytest.mark.parametrize("n_poly", [1, 4, 8])
def test_note_pairs_and_roll_match_jax(midi_bytes, n_poly):
    ours, theirs = MidiFile(data=midi_bytes), JaxMidi(data=midi_bytes)
    times = np.arange(200) / 43.06640625
    pairs = ours.get_note_pairs(times, n_poly)
    assert pairs.shape == (200, n_poly, 2) and pairs.dtype == np.float32
    np.testing.assert_array_equal(pairs, theirs.get_note_pairs(times, n_poly))
    np.testing.assert_array_equal(ours.get_piano_roll(times),
                                  theirs.get_piano_roll(times))
