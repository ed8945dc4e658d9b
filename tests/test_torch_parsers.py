"""The port's corpus parsers (after_tpu_torch/dataset/parsers.py) against
the JAX package's on synthetic trees, and its reader of the YAML subset of
Slakh's metadata against ``yaml.safe_load``.  The port's ``slakh`` also
runs in a process where ``import yaml`` fails (the card's machine has no
PyYAML)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from after_tpu.dataset import parsers as jax_parsers
from after_tpu.dataset.audio import save_wav
from after_tpu_torch.dataset import parsers
from after_tpu_torch.dataset.parsers import YamlSubsetError, read_yaml_mapping

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLAKH_META = """\
UUID: 0a1b2c3d4e5f   # the track's id
audio_dir: stems
normalization_factor: -13.0
overall_gain: 0.182
stems:
  S00:
    audio_rendered: true
    inst_class: Guitar
    integrated_loudness: -12.31
    is_drum: false
    midi_program_name: 'Distortion Guitar'
    plugin_name: "elektrik_guitar.nkm"
    program_num: 30
  S01:
    inst_class: Drums
    is_drum: yes
    program_num: 0
  S02:
    inst_class: "Piano"
    program_num: 1
    empty:
  S03:
    inst_class: Sound Effects
target_peak: -1.0
nothing: null
tilde: ~
"""


def _wav(path, n=400):
    save_wav(str(path), 0.1 * np.sin(np.arange(n) / 5.0), 4000)


def _tree(root):
    flat = root / "flat"
    flat.mkdir()
    for name in ("pad_60", "pad_64", "lead"):
        _wav(flat / f"{name}.wav")
    (flat / "pad_60.mid").write_bytes(b"MThd")
    (flat / "skip.mp3").write_bytes(b"")
    slakh = root / "slakh"
    for track in ("Track00001", "Track00002"):
        t = slakh / track
        (t / "stems").mkdir(parents=True)
        (t / "MIDI").mkdir()
        (t / "metadata.yaml").write_text(SLAKH_META)
        for stem in ("S00", "S01", "S02", "S03"):
            _wav(t / "stems" / f"{stem}.wav")
        (t / "MIDI" / "S00.mid").write_bytes(b"MThd")
    (slakh / "Track00003").mkdir()                      # no stems: skipped
    return str(flat), str(slakh)


@pytest.mark.parametrize("name,which", [
    ("simple_audio", 0), ("simple_midi", 0), ("vital", 0), ("slakh", 1)])
def test_parsers_match_jax(tmp_path, name, which):
    path = _tree(tmp_path)[which]
    ours = parsers.get_parser(name)(path)
    theirs = jax_parsers.get_parser(name)(path)
    assert ours == theirs
    assert ours[0]


def test_get_parser_unknown():
    with pytest.raises(KeyError, match="unknown parser"):
        parsers.get_parser("nope")


def test_yaml_subset_reads_as_safe_load(tmp_path):
    p = tmp_path / "m.yaml"
    p.write_text(SLAKH_META)
    assert read_yaml_mapping(str(p)) == yaml.safe_load(SLAKH_META)


@pytest.mark.parametrize("text", [
    "x: [1, 2]", "x: {a: 1}", "- a", "x: &a b", "x: !tag b", "x: |",
    "x: 010", "x: 0x1F", "x: 1:20", "x: 2018-01-02", "x: 1_000", "x: .inf",
    "x: 1e5", "---", "x: 'open", "a:\n  b: 1\n c: 2", "x: y: z"])
def test_yaml_subset_refuses_what_it_does_not_know(tmp_path, text):
    p = tmp_path / "m.yaml"
    p.write_text(text + "\n")
    with pytest.raises(YamlSubsetError):
        read_yaml_mapping(str(p))


def test_slakh_without_yaml(tmp_path):
    _, slakh = _tree(tmp_path)
    code = ("import sys; sys.modules['yaml'] = None; "
            "from after_tpu_torch.dataset.parsers import slakh; "
            f"a, m, meta = slakh({slakh!r}); "
            "print(len(a), sum(x is not None for x in m), "
            "sorted({d['instrument'] for d in meta}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "4 2 ['guitar', 'piano']"
