"""The port's example scripts (examples/torch_audio_to_audio_demo.py and
examples/torch_midi_to_audio_demo.py) on micro runs of the port, with
``--device cpu``: each writes the WAV that a direct call of the port's
``TransferPipeline`` with the same arguments and seed writes (the runs
loaded by ``cli.export.load_run``; a transfer's noise drawn by a generator
seeded 0, the MIDI demo's x0 by one seeded 0).  Both outputs go through
the same PCM16 ``save_wav``; the script runs in a process of its own (JAX
and the JAX package blocked there), so the two may part by one PCM16 step
where f32 rounding crosses one.  The JAX examples and
tests/test_examples.py are unchanged.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from after_tpu import config as jax_config
from after_tpu_torch import config as port_config
from after_tpu_torch.cli.export import load_run
from after_tpu_torch.dataset.audio import load_wav, save_wav
from after_tpu_torch.dataset.midi import MidiFile, Note
from tests.test_examples import MICRO
from tests.test_torch_cli_export import write_runs
from tests import torch_threads_common  # noqa: F401  (xdist workers' threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCM16_STEP = 1.0 / 32768


def _runs(tmp_path, name):
    cfg = jax_config.with_overrides(jax_config.get_config(name), MICRO)
    if name != "midi":
        cfg = jax_config.with_overrides(
            cfg, {"encoder_time.channels": (16, 16, 16, 16, 12)})
    cfg = port_config.from_json(jax_config.to_json(cfg.resolved(
        in_size=8, n_signal=16)))
    run, codec, _ = write_runs(tmp_path, cfg)
    return cfg, run, codec


def _script(name, args):
    """The script run in a process of its own in which JAX, flax and the
    JAX package cannot be imported."""
    path = os.path.join(REPO, "examples", name)
    code = ("import runpy, sys\n"
            "for m in ('jax', 'flax', 'after_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = [{path!r}] + sys.argv[1:]\n"
            f"runpy.run_path({path!r}, run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code, *args, "--device",
                           "cpu"], capture_output=True, text=True,
                          timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _same_wav(path, y, sr, tmp_path):
    ref = str(tmp_path / "direct.wav")
    save_wav(ref, y.cpu().numpy()[0, :, 0], sr)
    got, want = load_wav(path)[0], load_wav(ref)[0]
    assert got.shape == want.shape and len(got) > 0
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    err = float(np.abs(got - want).max())
    print(f"{os.path.basename(path)}: max difference {err:.3e} "
          f"({err / PCM16_STEP:.0f} PCM16 steps)")
    assert err <= PCM16_STEP + 1e-9


def test_audio_to_audio_demo(tmp_path):
    cfg, run, codec = _runs(tmp_path, "tiny")
    sr = cfg.sr
    t = np.arange(sr // 2) / sr
    for name, f in (("s", 220), ("t", 440)):
        save_wav(str(tmp_path / f"{name}.wav"),
                 (0.3 * np.sin(2 * np.pi * f * t)).astype(np.float32), sr)
    out = str(tmp_path / "out.wav")
    assert "wrote" in _script("torch_audio_to_audio_demo.py", [
        "--model_path", run, "--emb_model_path", codec,
        "--structure", str(tmp_path / "s.wav"),
        "--timbre", str(tmp_path / "t.wav"), "--out", out,
        "--nb_steps", "2", "--seconds", "0.4"])
    cfg, pipe = load_run(run, codec, device="cpu")
    ratio = cfg.autoencoder.ratio
    n = (int(0.4 * sr) // ratio) * ratio

    def audio(name):
        x = load_wav(str(tmp_path / f"{name}.wav"), sr=sr)[0]
        return np.tile(x, int(np.ceil(n / len(x))))[:n][None, :, None]
    y = pipe.transfer(audio("s"), audio("t"), 2, 2.0, 1.0,
                      generator=torch.Generator("cpu").manual_seed(0))
    _same_wav(out, y, sr, tmp_path)


def test_midi_to_audio_demo(tmp_path):
    cfg, run, codec = _runs(tmp_path, "midi")
    sr = cfg.sr
    t = np.arange(sr) / sr
    save_wav(str(tmp_path / "t.wav"),
             (0.3 * np.sin(2 * np.pi * 330 * t)).astype(np.float32), sr)
    midi = MidiFile(notes=[Note(60, 100, 0.0, 0.5), Note(64, 100, 0.5, 1.0)])
    midi.save(str(tmp_path / "in.mid"))
    out = str(tmp_path / "out.wav")
    assert "wrote" in _script("torch_midi_to_audio_demo.py", [
        "--model_path", run, "--emb_model_path", codec,
        "--midi", str(tmp_path / "in.mid"), "--timbre",
        str(tmp_path / "t.wav"), "--out", out, "--nb_steps", "2"])
    cfg, pipe = load_run(run, codec, device="cpu")
    midi = MidiFile(str(tmp_path / "in.mid"))
    ratio = cfg.autoencoder.ratio
    frames = int(max(midi.duration(), 1.0) * sr) // ratio
    roll = (midi.get_piano_roll(np.linspace(0, frames * ratio / sr, frames))
            / 127.0).T[None].astype(np.float32)
    prompt = load_wav(str(tmp_path / "t.wav"), sr=sr)[0]
    n = frames * ratio
    prompt = np.tile(prompt, int(np.ceil(n / len(prompt))))[:n]
    cond = pipe.timbre(pipe.encode(prompt[None, :, None]))
    x0 = torch.randn((1, frames, cfg.denoiser.n_channels),
                     generator=torch.Generator("cpu").manual_seed(0))
    y = pipe.decode(pipe.diffuse(x0, cond, roll, 2, 2.0, 1.0))
    _same_wav(out, y, sr, tmp_path)


@pytest.mark.parametrize("name", ["torch_audio_to_audio_demo.py",
                                  "torch_midi_to_audio_demo.py"])
def test_example_flags(name):
    """The JAX demo's flags and ``--device``, without JAX."""
    out = _script(name, ["--help"])
    assert "--model_path" in out and "--nb_steps" in out
    assert "--device" in out
