"""The port's record store and loaders against the JAX package's.

- ``AudioExample``: bytes written by either package decode in the other
  (the JAX package through protobuf, the port by hand) to the same arrays,
  dtypes, shapes, sampling rates and metadata, for every precision, the
  int16 rescale, empty and multi-key maps, unknown fields and unpacked
  shapes, and over generated shapes and keys; the bytes are equal for an
  example of one buffer (protobuf writes several map entries in hash
  order);
- stores written by either package read back in the other;
- both packages' ``CombinedDataset`` + ``DataLoader`` + collate yield
  bitwise-equal first batches from the same store and seeds: the diffusion
  collate with audio and with MIDI structure, the codec's wave collate with
  its augmentations;
- a MIDI record pickled from the JAX package's ``MidiFile`` decodes in a
  process where ``after_tpu`` cannot be imported, with the JAX collate's
  piano roll; a pickle naming any other global is refused;
- wav files read, resampled, normalised and written as the JAX package's
  ``dataset/audio.py`` does.
"""

import itertools
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from after_tpu import dataset as jax_dataset
from after_tpu.cli.train_autoencoder import make_wave_collate as jax_wave
from after_tpu.dataset import audio_example_pb2 as pb2
from after_tpu.dataset.collate import make_collate_fn as jax_collate
from after_tpu.dataset.midi import MidiFile as JaxMidi
from after_tpu.dataset.midi import Note as JaxNote
from after_tpu_torch import dataset as port_dataset
from after_tpu_torch.cli.train_autoencoder import make_wave_collate
from after_tpu_torch.dataset import midi as port_midi
from after_tpu_torch.dataset.audio_example import AudioExample

REPO = Path(__file__).resolve().parents[1]
DTYPES = [np.float32, np.int16, np.float16, np.int32, np.uint8]


def _same_example(a, b):
    """Two decoded examples (any package) hold the same buffers."""
    assert sorted(a.get_keys()) == sorted(b.get_keys())
    assert a.get_metadata() == b.get_metadata()
    for k in a.get_keys():
        x, y = a.get(k), b.get(k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
        assert a.get_bytes(k) == b.get_bytes(k), k


def _fields(raw: bytes):
    msg = pb2.AudioExample()
    msg.ParseFromString(raw)
    return ({k: (list(v.shape), v.precision, v.data, v.sampling_rate,
                 v.metadata) for k, v in msg.buffers.items()},
            dict(msg.metadata))


@pytest.mark.parametrize("dtype", DTYPES)
def test_one_buffer_is_the_same_bytes(dtype):
    rng = np.random.RandomState(0)
    a = (rng.randn(3, 7) * 50).astype(dtype)
    ours, theirs = AudioExample(), jax_dataset.AudioExample()
    for e in (ours, theirs):
        e.put_array("z", a, sampling_rate=44100)
    assert ours.serialize() == theirs.serialize()
    back = jax_dataset.AudioExample(ours.serialize())
    _same_example(AudioExample(theirs.serialize()), back)
    assert _fields(ours.serialize())[0]["z"][3] == 44100


def test_int16_rescale_and_metadata_cross_decode():
    rng = np.random.RandomState(1)
    w = rng.uniform(-1.3, 1.3, 5000).astype(np.float32)
    meta = {"name": "rec", "chunk": 3, "tags": ["a", "b"], "": ""}
    z = rng.randn(8, 20).astype(np.float32)
    ours, theirs = AudioExample(), jax_dataset.AudioExample()
    for e in (ours, theirs):
        e.put_array("waveform", w, dtype=np.int16, sampling_rate=22050)
        e.put_array("z", z)
        e.put_buffer("midi_bytes", b"\x00\x01midi", [6])
        e.put_array("empty", np.zeros((0, 4), np.float32))
        e.put_metadata(meta)
    for raw in (ours.serialize(), theirs.serialize()):
        _same_example(AudioExample(raw), jax_dataset.AudioExample(raw))
        assert _fields(raw) == _fields(theirs.serialize())
    back = AudioExample(theirs.serialize())
    assert back.get("waveform").dtype == np.float32
    np.testing.assert_allclose(back.get("waveform"), np.clip(w, -1, 1),
                               atol=1.0 / 32767)
    assert back.get_metadata()["tags"] == '["a", "b"]'
    assert "midi_bytes" in back and "nothing" not in back
    assert back.get("metadata") == back.get_metadata()
    assert set(back.as_dict()) == set(back.get_keys())


def test_empty_example_and_empty_maps():
    assert AudioExample().serialize() == \
        jax_dataset.AudioExample().serialize() == b""
    e = AudioExample(b"")
    assert e.get_keys() == [] and e.get_metadata() == {}
    with pytest.raises(KeyError):
        e.get("z")
    ours, theirs = AudioExample(), jax_dataset.AudioExample()
    for x in (ours, theirs):
        x.put_buffer("", b"", [])
        x.put_metadata({"k": ""})
    assert ours.serialize() == theirs.serialize()


def test_unknown_fields_and_unpacked_shapes_are_read_as_protobuf_reads():
    from after_tpu_torch.dataset.audio_example import (_field, _len_field,
                                                       _varint)
    data = np.arange(6, dtype=np.float32).tobytes()
    unknown = (_field(7, 0) + _varint(300) + _field(8, 1) + b"\x01" * 8
               + _len_field(9, b"skip me") + _field(10, 5) + b"\x02" * 4
               + _field(11, 3) + _field(1, 0) + _varint(5) + _field(11, 4))
    buffer = (_field(1, 0) + _varint(2) + _field(1, 0) + _varint(3)
              + _field(2, 0) + _varint(0) + _len_field(3, data) + unknown)
    entry = _len_field(1, b"z") + _len_field(2, buffer)
    raw = _len_field(1, entry) + unknown + _len_field(
        2, _len_field(1, b"k") + _len_field(2, b"v"))
    theirs = jax_dataset.AudioExample(raw)
    ours = AudioExample(raw)
    _same_example(ours, theirs)
    assert ours.get("z").shape == (2, 3)
    # protobuf leaves a map entry with an unknown field out of the map
    odd = _len_field(1, _len_field(1, b"y") + unknown + _len_field(2, buffer))
    assert AudioExample(raw + odd).get_keys() == \
        jax_dataset.AudioExample(raw + odd).get_keys() == ["z"]
    # a later entry of a key replaces the earlier one, as in protobuf
    twice = raw + _len_field(2, _len_field(1, b"k") + _len_field(2, b"w"))
    assert AudioExample(twice).get_metadata() == \
        jax_dataset.AudioExample(twice).get_metadata() == {"k": "w"}
    with pytest.raises(ValueError):
        AudioExample(raw[:-3])


def test_data_is_read_without_a_copy():
    e = AudioExample()
    e.put_array("z", np.ones((64, 4096), np.float32))
    raw = bytearray(e.serialize())
    z = AudioExample(raw).get("z")
    raw[-4:] = np.float32(7.0).tobytes()
    assert z[-1, -1] == 7.0


@settings(max_examples=40, deadline=None)
@given(st.dictionaries(
    st.text(max_size=6),
    st.tuples(st.lists(st.integers(0, 4), max_size=3),
              st.sampled_from(range(len(DTYPES))),
              st.integers(0, 96000)),
    max_size=4),
    st.dictionaries(st.text(max_size=5), st.text(max_size=5), max_size=3))
def test_generated_examples_cross_decode(buffers, metadata):
    rng = np.random.RandomState(len(buffers))
    ours, theirs = AudioExample(), jax_dataset.AudioExample()
    for key, (shape, d, sr) in buffers.items():
        a = np.asarray(rng.randn(*shape) * 100).astype(DTYPES[d])
        for e in (ours, theirs):
            e.put_array(key, a, sampling_rate=sr)
    for e in (ours, theirs):
        e.put_metadata(metadata)
    for raw in (ours.serialize(), theirs.serialize()):
        _same_example(AudioExample(raw), jax_dataset.AudioExample(raw))
        assert _fields(raw) == _fields(theirs.serialize())
    if len(buffers) == 1 and not metadata:
        assert ours.serialize() == theirs.serialize()


def _write_store(writer_cls, example_cls, path, n=12, midi=False, wave=False,
                 aug=True):
    rng = np.random.RandomState(3)
    with writer_cls(str(path)) as w:
        for i in range(n):
            e = example_cls()
            if wave:
                t = np.arange(6000 + 500 * i) / 44100.0
                x = 0.4 * np.sin(2 * np.pi * (220 + 55 * i) * t)
                e.put_array("waveform", x.astype(np.float32), dtype=np.int16)
            else:
                e.put_array("z", rng.randn(8, 60 + 5 * i).astype(np.float32))
                if aug:
                    e.put_array("z_aug_0",
                                rng.randn(8, 70).astype(np.float32))
            if midi:
                notes = [JaxNote(int(rng.randint(30, 90)), 100,
                                 float(rng.uniform(0, 2)),
                                 float(rng.uniform(2, 4))) for _ in range(5)]
                m = pickle.dumps(JaxMidi(notes=notes))
                e.put_buffer("midi_bytes", m, [len(m)])
            e.put_metadata({"name": f"rec{i}"})
            w.put(f"{i:08d}", e.serialize())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_read_back_in_the_other_package(tmp_path, writer):
    a, b = ((jax_dataset, port_dataset) if writer == "jax"
            else (port_dataset, jax_dataset))
    _write_store(a.RecordWriter, a.AudioExample, tmp_path / "db")
    if writer == "port":
        # records of one buffer are the same bytes in both packages
        # (protobuf writes several buffers in hash order)
        _write_store(a.RecordWriter, a.AudioExample, tmp_path / "one",
                     aug=False)
        _write_store(b.RecordWriter, b.AudioExample, tmp_path / "twin",
                     aug=False)
        for name in ("MANIFEST.json", "index.bin", "data-00000.bin"):
            assert ((tmp_path / "one" / name).read_bytes()
                    == (tmp_path / "twin" / name).read_bytes()), name
    reader = b.RecordReader(str(tmp_path / "db"))
    mine = a.RecordReader(str(tmp_path / "db"))
    assert reader.keys() == mine.keys() and len(reader) == 12
    for (k, raw), (k2, raw2) in zip(reader.items(), mine.items()):
        assert k == k2 and raw == raw2 and k in reader
        _same_example(AudioExample(raw), jax_dataset.AudioExample(raw))


def _batches(package_dataset, collate, path, keys, n=4, seed=0):
    ds = package_dataset.CombinedDataset({"db": str(path)}, keys=keys)
    loader = package_dataset.DataLoader(ds, 4, collate,
                                        weights=ds.example_weights, seed=seed)
    it = iter(loader)
    try:
        return list(itertools.islice(it, n))
    finally:
        it.close()


@pytest.mark.parametrize("structure", ["audio", "audio_aug", "midi"])
def test_diffusion_loaders_yield_the_same_batches(tmp_path, structure):
    from after_tpu_torch.dataset import make_collate_fn
    midi = structure == "midi"
    _write_store(jax_dataset.RecordWriter, jax_dataset.AudioExample,
                 tmp_path / "db", midi=midi)
    keys = (["z", "midi_bytes", "metadata"] if midi
            else ["z", "z_aug_0", "metadata"])
    aug = ("z_aug_0",) if structure == "audio_aug" else ()
    kw = dict(n_signal=32, structure_type="midi" if midi else "audio",
              ae_ratio=2048, sr=44100, timbre_augmentation_keys=aug)
    theirs = _batches(jax_dataset, jax_collate(**kw), tmp_path / "db", keys)
    ours = _batches(port_dataset, make_collate_fn(**kw), tmp_path / "db",
                    keys)
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if midi:
        assert any(np.any(b["x_time_cond"] > 0) for b in ours)


def test_wave_loaders_yield_the_same_batches(tmp_path):
    _write_store(port_dataset.RecordWriter, AudioExample, tmp_path / "db",
                 wave=True)
    theirs = _batches(jax_dataset, jax_wave(4096, True), tmp_path / "db",
                      ["waveform"], seed=5)
    ours = _batches(port_dataset, make_wave_collate(4096, True),
                    tmp_path / "db", ["waveform"], seed=5)
    for a, b in zip(ours, theirs):
        assert a.shape == (4, 4096, 1) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_loader_counts_what_the_training_loop_waits_for(tmp_path):
    _write_store(port_dataset.RecordWriter, AudioExample, tmp_path / "db")
    ds = port_dataset.CombinedDataset({"db": str(tmp_path / "db")},
                                      keys=["z"])
    loader = port_dataset.DataLoader(
        ds, 2, port_dataset.make_collate_fn(32))
    it = iter(loader)
    batches = list(itertools.islice(it, 5))
    it.close()
    assert len(batches) == 5 and loader.batches >= 5
    assert loader.batch_seconds > 0 and 1 <= loader.dry <= 5


def test_jax_midi_record_decodes_without_the_jax_package(tmp_path):
    """The port's collate reads a JAX-prepared MIDI record in a process
    where ``after_tpu`` and protobuf cannot be imported."""
    _write_store(jax_dataset.RecordWriter, jax_dataset.AudioExample,
                 tmp_path / "db", n=4, midi=True)
    reader = jax_dataset.RecordReader(str(tmp_path / "db"))
    raw = reader.get(reader.keys()[0])
    ex = jax_dataset.AudioExample(raw)
    item = {"z": ex.get("z"), "midi_bytes": ex.get("midi_bytes")}
    want = jax_collate(32, "midi")([item])["x_time_cond"]
    np.save(tmp_path / "want.npy", want)
    code = f"""
import sys
sys.modules["after_tpu"] = None
sys.modules["google.protobuf"] = None
import numpy as np
from after_tpu_torch.dataset import RecordReader, AudioExample, make_collate_fn
reader = RecordReader({str(tmp_path / 'db')!r})
ex = AudioExample(reader.get(reader.keys()[0]))
item = {{"z": ex.get("z"), "midi_bytes": ex.get("midi_bytes")}}
got = make_collate_fn(32, "midi")([item])["x_time_cond"]
np.testing.assert_array_equal(got, np.load({str(tmp_path / 'want.npy')!r}))
assert got.max() > 0
bad = [m for m in sys.modules
       if m.startswith(("after_tpu.", "google.protobuf.", "jax"))]
assert not bad, bad
assert sys.modules["after_tpu"] is None
assert sys.modules["google.protobuf"] is None
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stdout + out.stderr


def test_midi_pickles_of_either_package_and_nothing_else():
    notes = [JaxNote(60, 100, 0.0, 0.5), JaxNote(64, 90, 0.25, 1.0)]
    times = np.linspace(0, 1.2, 50)
    want = JaxMidi(notes=notes).get_piano_roll(times)
    for raw in (pickle.dumps(JaxMidi(notes=notes)),
                pickle.dumps(port_midi.MidiFile(
                    notes=[port_midi.Note(60, 100, 0.0, 0.5),
                           port_midi.Note(64, 90, 0.25, 1.0)]))):
        got = port_midi.loads(raw)
        assert type(got) is port_midi.MidiFile
        assert all(type(n) is port_midi.Note for n in got.notes)
        np.testing.assert_array_equal(got.get_piano_roll(times), want)
    # the JAX package's transcriptions carry numpy numbers: read as Python's
    got = port_midi.loads(pickle.dumps(JaxMidi(notes=[JaxNote(
        np.int64(60), np.int32(100), np.float32(0.25), np.float64(1.0))])))
    assert [(type(v), v) for v in vars(got.notes[0]).values()] == [
        (int, 60), (int, 100), (float, 0.25), (float, 1.0)]
    for evil in (pickle.dumps(np.float64(1.0)), pickle.dumps(print),
                 pickle.dumps(np.arange(3)),
                 pickle.dumps(JaxMidi(notes=[JaxNote(np.complex128(60), 100,
                                                     0.0, 1.0)])),
                 pickle.dumps(JaxMidi(notes=[JaxNote(np.str_("C4"), 100,
                                                     0.0, 1.0)]))):
        with pytest.raises(pickle.UnpicklingError):
            port_midi.loads(evil)
    with pytest.raises(pickle.UnpicklingError, match="not a MidiFile"):
        port_midi.loads(pickle.dumps([1, 2]))


def test_port_midi_parses_what_the_jax_package_writes(tmp_path):
    notes = [JaxNote(60, 100, 0.0, 0.5), JaxNote(67, 80, 0.5, 1.5)]
    JaxMidi(notes=notes).save(str(tmp_path / "a.mid"))
    ours = port_midi.MidiFile(str(tmp_path / "a.mid"))
    theirs = JaxMidi(str(tmp_path / "a.mid"))
    times = np.linspace(0, 2, 80)
    np.testing.assert_array_equal(ours.get_piano_roll(times),
                                  theirs.get_piano_roll(times))
    assert [vars(n) for n in ours.notes] == [vars(n) for n in theirs.notes]


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.uint8, np.float32])
@pytest.mark.parametrize("sr", [None, 22050])
def test_wav_files_read_as_in_the_jax_package(tmp_path, dtype, sr):
    """``dataset/audio.py``: a two-channel wav of each sample type read
    (mono and not, resampled or not) to the JAX package's arrays, peak
    normalisation, and the port's ``save_wav`` read back by the JAX
    package."""
    import scipy.io.wavfile
    from after_tpu.dataset import audio as jax_audio
    from after_tpu_torch.dataset import audio as port_audio
    x = np.clip(0.3 * np.random.RandomState(3).randn(4410, 2), -1, 1)
    if dtype == np.float32:
        data = x.astype(np.float32)
    elif dtype == np.uint8:
        data = (x * 127 + 128).astype(np.uint8)
    else:
        data = (x * (np.iinfo(dtype).max // 2)).astype(dtype)
    path = str(tmp_path / "a.wav")
    scipy.io.wavfile.write(path, 44100, data)
    for mono in (True, False):
        ours, ours_sr = port_audio.load_wav(path, sr, mono)
        theirs, theirs_sr = jax_audio.load_wav(path, sr, mono)
        assert ours_sr == theirs_sr == (sr or 44100)
        assert ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(port_audio.normalize_signal(1e-3 * ours),
                                  jax_audio.normalize_signal(1e-3 * ours))
    port_audio.save_wav(str(tmp_path / "b.wav"), 2 * ours, ours_sr)
    jax_audio.save_wav(str(tmp_path / "c.wav"), 2 * ours, ours_sr)
    assert (tmp_path / "b.wav").read_bytes() == \
        (tmp_path / "c.wav").read_bytes()
