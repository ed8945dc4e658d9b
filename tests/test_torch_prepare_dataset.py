"""The port's ``prepare_dataset`` and ``update_dataset`` against the JAX
package's, on one synthetic corpus with a micro codec.

The codec (4 PQMF bands, 8 base channels, two stages, ratio 16) is
initialised in JAX, its parameters perturbed, and saved twice: as a JAX run
(``after_tpu.utils.checkpoint.save_checkpoint``) and, loaded into the port
through ``utils.from_jax``, as a port run, both with the same
``config.json``.  The corpus (44.1 kHz WAV files of 1-3 chunks of 8192
samples, a short file that is tiled, a file with a silent chunk that
``--cut_silences`` drops, a .mid file beside one) goes through both
packages' commands with ``--device cpu`` for the port:

- one augmentation, every descriptor, the energy-flux beat clock,
  waveforms, batch 3 (a padded tail batch);
- ``simple_midi`` with ``--midi`` (the .mid file's slices);
- basic-pitch transcription (a synthetic reference checkpoint: the port's
  random weights under the reference's names) of a file of its own;
- ``update_dataset`` of the first store.

Keys, metadata, waveforms, decoded MIDI and chunk indices are equal; z,
z_aug_0, the beat clocks and the descriptors agree within 1e-5 x max.  Then
the port's ``train`` takes two steps on the port's store.
"""

import dataclasses
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu.cli import main as jax_cli
from after_tpu.config import AutoEncoderConfig as JaxAEConfig
from after_tpu.config import ae_to_json
from after_tpu.dataset import RecordReader as JaxReader
from after_tpu.dataset.audio import save_wav
from after_tpu.models import AudioCodec as JaxCodec
from after_tpu.utils.checkpoint import save_checkpoint as jax_save
from after_tpu_torch.cli import main as cli
from after_tpu_torch.config import AutoEncoderConfig
from after_tpu_torch.dataset import AudioExample, RecordReader
from after_tpu_torch.dataset import midi as port_midi
from after_tpu_torch.dataset.basic_pitch import (BasicPitch,
                                                 reference_state_dict)
from after_tpu_torch.models.autoencoder import AudioCodec
from after_tpu_torch.utils.checkpoint import save_checkpoint
from after_tpu_torch.utils.from_jax import load_module

SR = 44100
N = 8192
TINY = dict(pqmf_bands=4, z_channels=8, base_channels=8, multipliers=(1, 2, 2),
            factors=(2, 2), dilations=(1, 3), num_blocks_per_stage=1)
REL = 1e-5
CLOSE = ("z", "z_aug_0", "beat_clock", "downbeat_clock", "centroid",
         "bandwidth", "rolloff", "flatness", "rms")


def _corpus(root):
    rng = np.random.RandomState(0)
    d = root / "corpus"
    d.mkdir()

    def tone(n, f):
        t = np.arange(n) / SR
        return (0.4 * np.sin(2 * np.pi * f * t) * (1 + np.sin(7 * t))
                + 0.05 * rng.randn(n)).astype(np.float32)

    save_wav(str(d / "a.wav"), tone(int(2.5 * N), 330.0), SR)
    save_wav(str(d / "b.wav"), tone(5000, 523.0), SR)
    c = tone(3 * N, 196.0)
    c[N:2 * N] = 0.0                                     # a silent chunk
    save_wav(str(d / "c.wav"), c, SR)
    save_wav(str(d / "d.wav"), tone(2 * N, 440.0), SR)
    port_midi.MidiFile(notes=[
        port_midi.Note(60, 100, 0.02, 0.15), port_midi.Note(64, 80, 0.1, 0.3),
        port_midi.Note(67, 90, 0.25, 0.36)]).save(str(d / "d.mid"))
    # a corpus of its own for the transcription (one audio length: the JAX
    # package's eager front end compiles again for each)
    (root / "to_transcribe").mkdir()
    save_wav(str(root / "to_transcribe" / "e.wav"), tone(2 * N, 262.0), SR)
    return str(d), str(root / "to_transcribe")


def _perturbed(variables, seed):
    rng = np.random.RandomState(seed)

    def f(v):
        v = np.asarray(v, dtype=np.float32)
        return (v * (1 + 0.2 * rng.uniform(-1, 1, v.shape))
                + 0.02 * rng.randn(*v.shape)).astype(np.float32)
    return jax.tree_util.tree_map(f, variables)


def _codec_runs(root):
    jcfg = JaxAEConfig(**TINY)
    variables = _perturbed(jax.jit(JaxCodec(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1024, 1))), 1)
    jax_run, port_run = str(root / "jax_ae"), str(root / "port_ae")
    jax_save(jax_run, 0, {"codec_vars": variables, "step": 0},
             config_json=ae_to_json(jcfg))
    codec = AudioCodec(AutoEncoderConfig(**TINY)).eval()
    load_module(codec, variables, "codec")
    save_checkpoint(port_run, 0, {"codec_vars": codec.state_dict(),
                                  "step": 0}, config_json=ae_to_json(jcfg))
    return jax_run, port_run


def _records(path, reader):
    out = {}
    for key, raw in reader(path).items():
        ae = AudioExample(raw)
        out[key] = ({k: ae.get(k) for k in ae.get_keys()
                     if k != "midi_bytes"},
                    ae.get_metadata(),
                    ae.get_bytes("midi_bytes") if "midi_bytes" in ae else None)
    return out


def _notes(midi):
    return [dataclasses.astuple(n) for n in midi.notes]


def _same_stores(port_path, jax_path):
    ours, theirs = (_records(port_path, RecordReader),
                    _records(jax_path, JaxReader))
    assert list(ours) == list(theirs) and ours
    for key in theirs:
        (a, meta_a, midi_a), (b, meta_b, midi_b) = ours[key], theirs[key]
        assert sorted(a) == sorted(b), key
        assert meta_a == meta_b, key
        for name in b:
            assert a[name].shape == b[name].shape, (key, name)
            if name in CLOSE:
                np.testing.assert_allclose(
                    a[name], b[name], rtol=0,
                    atol=REL * max(np.abs(b[name]).max(), 1e-30),
                    err_msg=f"{key}/{name}")
            else:
                np.testing.assert_array_equal(a[name], b[name],
                                              err_msg=f"{key}/{name}")
        assert (midi_a is None) == (midi_b is None), key
        if midi_b is not None:
            # the JAX package's bytes, where its notes hold Python numbers
            # (its basic-pitch notes pickle numpy's, which the port writes
            # as Python numbers)
            if not any(isinstance(v, np.generic)
                       for n in pickle.loads(midi_b).notes
                       for v in vars(n).values()):
                assert midi_a == midi_b, key
            # the port's records read back through its loader and a plain
            # pickle.loads (what the JAX collate calls)
            assert (_notes(port_midi.loads(midi_a))
                    == _notes(pickle.loads(midi_a))
                    == _notes(pickle.loads(midi_b))
                    == _notes(port_midi.loads(midi_b))), key
    return ours


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    root = tmp_path_factory.mktemp("prepare")
    corpus, to_transcribe = _corpus(root)
    jax_run, port_run = _codec_runs(root)
    torch.manual_seed(0)
    bp = str(root / "basic_pitch.pth")
    torch.save(reference_state_dict(BasicPitch(device="cpu")), bp)
    common = ["--input_path", corpus, "--num_signal", str(N),
              "--batch_size", "3", "--cut_silences"]
    first = common + ["--augmentations", "1", "--descriptors", "all",
                      "--beat_track", "--save_waveform"]
    midi = common + ["--parser", "simple_midi", "--midi"]
    transcribed = ["--input_path", to_transcribe, "--num_signal", str(N),
                   "--basic_pitch", bp]
    stores = {}
    for name, argv in (("first", first), ("midi", midi),
                       ("transcribed", transcribed)):
        for pkg, main, run, extra in (
                ("jax", jax_cli.main, jax_run, []),
                ("port", cli.main, port_run, ["--device", "cpu"])):
            out = str(root / f"{pkg}_{name}")
            assert main(["prepare_dataset", "--output_path", out,
                         "--emb_model_path", run, *argv, *extra]) == 0
            stores[pkg, name] = out
        up = {}
        if name == "first":
            for pkg, main, run, extra in (
                    ("jax", jax_cli.main, jax_run, []),
                    ("port", cli.main, port_run, ["--device", "cpu"])):
                up[pkg] = str(root / f"{pkg}_updated")
                assert main(["update_dataset", "--dataset_path",
                             stores[pkg, "first"], "--output_path", up[pkg],
                             "--emb_model_path", run, *extra]) == 0
            stores["jax", "updated"], stores["port", "updated"] = (
                up["jax"], up["port"])
    return root, stores, port_run


def test_prepare_dataset_matches_jax(prepared):
    _, stores, _ = prepared
    ours = _same_stores(stores["port", "first"], stores["jax", "first"])
    # a 2.5-chunk file, a tiled short file, a file with its silent chunk
    # dropped, a 2-chunk file
    assert [m["chunk"] for _, m, _ in ours.values()] == [
        "0", "1", "2", "0", "0", "2", "0", "1"]
    arrays, _, _ = ours["00000000"]
    assert arrays["z"].shape == (8, N // 16)
    assert arrays["beat_clock"].shape == (N // 16,)


def test_prepare_dataset_midi_slices_match_jax(prepared):
    _, stores, _ = prepared
    ours = _same_stores(stores["port", "midi"], stores["jax", "midi"])
    notes = [_notes(port_midi.loads(m)) for _, _, m in ours.values()]
    # d.mid's notes re-based to each chunk's start; the second starts at
    # 0.1857 s, inside the second note
    assert [n[0] for n in notes[0]] == [60, 64] and len(notes) == 2
    assert [n[0] for n in notes[1]] == [64, 67] and notes[1][0][2] == 0.0


def test_prepare_dataset_transcribes_as_jax(prepared):
    _, stores, _ = prepared
    ours = _same_stores(stores["port", "transcribed"],
                        stores["jax", "transcribed"])
    assert [m is not None for _, _, m in ours.values()] == [True, True]


def test_the_port_reads_a_jax_transcribed_store(prepared):
    """The JAX package's basic-pitch notes pickle numpy numbers: the port's
    loader reads its store's MIDI as Python numbers, and the port's collate
    makes the JAX collate's piano rolls of it."""
    from after_tpu.dataset.collate import make_collate_fn as jax_collate
    from after_tpu_torch.dataset import make_collate_fn
    _, stores, _ = prepared
    reader = RecordReader(stores["jax", "transcribed"])
    batch = [{"z": ae.get("z"), "midi_bytes": ae.get_bytes("midi_bytes")}
             for ae in (AudioExample(reader.get(k)) for k in reader.keys())]
    raw = [pickle.loads(b["midi_bytes"]) for b in batch]
    assert any(isinstance(v, np.generic) for m in raw for n in m.notes
               for v in vars(n).values())
    ours = [port_midi.loads(b["midi_bytes"]) for b in batch]
    assert [_notes(m) for m in ours] == [_notes(m) for m in raw]
    assert {type(v) for m in ours for n in m.notes
            for v in vars(n).values()} == {int, float}
    args = dict(n_signal=N // 32, structure_type="midi", ae_ratio=16, sr=SR)
    got, want = make_collate_fn(**args)(batch), jax_collate(**args)(batch)
    assert got["x_time_cond"].any()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# the JAX collate over a store the port wrote, in a process where neither
# torch nor the port can be imported
_JAX_COLLATE = """
import sys

class Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "after_tpu_torch"):
            raise ImportError(f"{name} is blocked in this process")

sys.meta_path.insert(0, Blocked())
from after_tpu.dataset import AudioExample, RecordReader
from after_tpu.dataset.collate import make_collate_fn
reader = RecordReader(sys.argv[1])
batch = [{"z": ae.get("z"), "midi_bytes": ae.get_bytes("midi_bytes")}
         for ae in (AudioExample(reader.get(k)) for k in reader.keys())]
out = make_collate_fn(n_signal=int(sys.argv[2]), structure_type="midi",
                      ae_ratio=16, sr=44100)(batch)
assert "torch" not in sys.modules and "after_tpu_torch" not in sys.modules
print(len(batch), int((out["x_time_cond"] != 0).sum()))
"""


@pytest.mark.parametrize("store", ["midi", "transcribed"])
def test_the_jax_collate_reads_the_ports_midi_without_torch(prepared, store):
    """C8: the port's MIDI records name the JAX package's classes, so its
    collate reads them with neither torch nor the port importable, and makes
    the piano rolls it makes of the JAX package's own store."""
    import subprocess
    _, stores, _ = prepared
    rolls = []
    for pkg in ("port", "jax"):
        out = subprocess.run(
            [sys.executable, "-c", _JAX_COLLATE, stores[pkg, store],
             str(N // 32)], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert out.returncode == 0, out.stderr[-3000:]
        rolls.append(out.stdout.split())
    assert rolls[0] == rolls[1] and int(rolls[0][1]) > 0


def test_update_dataset_matches_jax(prepared):
    _, stores, _ = prepared
    ours = _same_stores(stores["port", "updated"], stores["jax", "updated"])
    first = _records(stores["port", "first"], RecordReader)
    for key, (arrays, _, _) in ours.items():
        # the waveform went through int16, so z moved; nothing else did
        for name in set(arrays) - {"z"}:
            np.testing.assert_array_equal(arrays[name], first[key][0][name])


def test_train_takes_two_steps_on_the_ports_store(prepared, monkeypatch):
    root, stores, port_run = prepared
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    micro = ["--override", "denoiser.embed_dim=64",
             "--override", "denoiser.n_layers=1",
             "--override", "denoiser.noise_embed_dims=16",
             "--override", "denoiser.mlp_multiplier=2",
             "--override", "encoder.channels=[8,8,8,16]",
             "--override", "encoder_time.channels=[8,8,8,8,12]",
             "--override", "classifier.channels=[8,8,8,8,6]",
             "--override", "train.n_signal=32",
             "--override", "train.steps_save=2",
             "--override", "train.steps_valid=100"]
    assert cli.main(["train", "--name", "r", "--db_path",
                     stores["port", "first"], "--out_path",
                     str(root / "runs"), "--config", "tiny", "--batch_size",
                     "2", "--max_steps", "2", "--device", "cpu",
                     *micro]) == 0
    assert os.path.isdir(root / "runs" / "r" / "checkpoint_2")


def test_subcommands_run_on_the_card_by_default(monkeypatch, prepared):
    _, stores, port_run = prepared
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["update_dataset", "--dataset_path", stores["port", "first"],
                  "--output_path", "unused", "--emb_model_path", port_run])
