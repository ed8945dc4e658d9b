"""The port's reference-LMDB import (after_tpu_torch/dataset/lmdb_import.py,
``after-tpu-torch import_dataset``) against the JAX package's, on the
fixture LMDB that tests/test_lmdb_import.py:write_minimal_lmdb writes.

The reference AudioExamples are written here with a few lines of protobuf
wire format (the reference schema: shape=1 packed, sampling_rate=2,
data=3, precision=4), without the reference's generated module: int16
waveforms large enough for overflow pages, float32 latents, descriptors, a
float64 buffer (narrowed), an int64 one, a RAW one, the JSON metadata
buffer, a pickled PrettyMIDI (rescued without pretty_midi) and one record
that is not a protobuf.  Both packages' stores hold equal records, the MIDI
read back through the port's loader."""

import dataclasses
import pickle

import numpy as np

from after_tpu.dataset import AudioExample as JaxExample
from after_tpu.dataset import RecordReader as JaxReader
from after_tpu.dataset import lmdb_import as jax_li
from after_tpu_torch.cli import main as cli
from after_tpu_torch.dataset import AudioExample, RecordReader
from after_tpu_torch.dataset import lmdb_import as li
from after_tpu_torch.dataset import midi as port_midi
from tests import test_lmdb_import as fixture

# the reference schema's Precision enum
FLOAT32, FLOAT64, INT16, INT64, RAW = 1, 2, 3, 5, 6


def _varint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _field(number, payload):
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _buffer(data, shape, precision, sampling_rate=0):
    packed = b"".join(_varint(d) for d in shape)
    return (_field(1, packed) + _varint(2 << 3) + _varint(sampling_rate)
            + _field(3, data) + _varint(4 << 3) + _varint(precision))


def _example(buffers):
    return b"".join(_field(1, _field(1, k.encode()) + _field(2, v))
                    for k, v in buffers.items())


def _records():
    rng = np.random.RandomState(0)
    out = []
    for i in range(5):
        wav = (rng.randn(20000) * 8000).astype(np.int16)
        z = rng.randn(16, 64).astype(np.float32)
        buffers = {
            "waveform": _buffer(wav.tobytes(), wav.shape, INT16, 44100),
            "z": _buffer(z.tobytes(), z.shape, FLOAT32),
            "centroid": _buffer(rng.rand(300).astype(np.float32).tobytes(),
                                [300], FLOAT32),
            "loudness": _buffer(rng.rand(7).tobytes(), [7], FLOAT64),
            "index": _buffer(np.arange(3, dtype=np.int64).tobytes(), [3],
                             INT64),
            "blob": _buffer(b"opaque", [6], RAW),
            "metadata": _buffer(b'{"path": "file_%d.wav", "dataset": '
                                b'"fixture"}' % i, [], INT16)}
        if i == 0:
            buffers["midi"] = _buffer(fixture._fake_pretty_midi_pickle(), [],
                                      INT16)
        out.append((f"{i:08d}".encode(), _example(buffers)))
    out.append((b"00000009", b"\xff\xff not a protobuf"))
    return out


def _store(path, example_cls, reader_cls):
    out = {}
    for key, raw in reader_cls(path).items():
        ae = example_cls(raw)
        arrays = {k: ae.get(k) for k in ae.get_keys() if k != "midi_bytes"}
        midi = ae.get_bytes("midi_bytes") if "midi_bytes" in ae else None
        out[key] = (arrays, ae.get_metadata(), midi)
    return out


def test_lmdb_reader_matches_jax(tmp_path):
    items = [(b"%08d" % i, bytes([i % 251]) * 1500) for i in range(24)]
    db = str(tmp_path / "branch_db")
    fixture.write_minimal_lmdb(db, items)
    with li.LmdbReader(db) as ours, jax_li.LmdbReader(db) as theirs:
        assert ours.entries == theirs.entries == 24
        assert list(ours.items()) == list(theirs.items()) == items


def test_import_lmdb_matches_jax(tmp_path):
    db = str(tmp_path / "ref_db")
    fixture.write_minimal_lmdb(db, _records())
    logs = []
    assert cli.main(["import_dataset", "--input_path", db, "--output_path",
                     str(tmp_path / "port")]) == 0
    assert jax_li.import_lmdb(db, str(tmp_path / "jax"),
                              log=logs.append) == 5
    assert any("skipping record '00000009'" in line for line in logs)
    ours = _store(str(tmp_path / "port"), AudioExample, RecordReader)
    theirs = _store(str(tmp_path / "jax"), JaxExample, JaxReader)
    assert list(ours) == list(theirs) == [f"{i:08d}" for i in range(5)]
    for key in theirs:
        (a, meta_a, midi_a), (b, meta_b, midi_b) = ours[key], theirs[key]
        assert meta_a == meta_b and meta_a["dataset"] == "fixture"
        assert sorted(a) == sorted(b)
        for name in b:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name])
        assert (midi_a is None) == (midi_b is None)
        if midi_b is not None:
            notes = [dataclasses.astuple(n)
                     for n in port_midi.loads(midi_a).notes]
            assert notes == [dataclasses.astuple(n)
                             for n in pickle.loads(midi_b).notes]
            assert [(p, v) for p, v, _, _ in notes] == [(60, 90), (64, 70)]
    assert ours["00000001"][0]["loudness"].dtype == np.float32
    assert ours["00000001"][0]["index"].dtype == np.int32


def test_import_of_nothing_fails(tmp_path):
    db = str(tmp_path / "empty_db")
    fixture.write_minimal_lmdb(db, [(b"00000000", b"\xff not a protobuf")])
    assert cli.main(["import_dataset", "--input_path", db, "--output_path",
                     str(tmp_path / "out")]) == 1
