"""The port's export and serve commands (after_tpu_torch/cli/{export,serve,
main}.py) from run directories of the port (written with
``save_checkpoint``), on the CPU, with the micro configs of
tests/test_diffusion.py and tests/test_frontend.py:

- ``export`` of an a2a run with ``--db_path``: the artifact under the run
  dir, its denoiser the run's EMA weights (its forward equal, bit for bit,
  to a live ``Streamer`` over the EMA weights), a projector and map baked
  in;
- ``export_midi`` of a MIDI run: a MIDI artifact;
- refusals: a codec run without ``config.json``, a codec whose latent size
  is not the denoiser's, ``--compute_dtype``;
- ``serve --artifact`` in its own process (``after_tpu``, ``jax`` and
  ``flax`` refused there) on a free port: ``/api/info`` and a transfer.
"""

import copy
import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from after_tpu import config as jax_config
from after_tpu_torch import config as port_config
from after_tpu_torch.cli import main as cli
from after_tpu_torch.dataset import AudioExample, RecordWriter
from after_tpu_torch.diffusion.pipeline import TransferPipeline
from after_tpu_torch.streaming.export import ExportedStreamer
from after_tpu_torch.streaming.streamer import Streamer
from after_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_diffusion import micro_config
from tests.test_frontend import _micro_midi_config
from tests.test_torch_frontend import _wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_runs(root, cfg, seed=0):
    """A diffusion run (its EMA apart from its weights) and a codec run of
    the port, and the pipeline of their weights with the EMA in the
    denoiser."""
    pipe = TransferPipeline(cfg, device="cpu").init(seed)
    models = {"net": pipe.rf.net, "encoder": pipe.rf.encoder,
              "encoder_time": pipe.rf.encoder_time}
    variables = {k: copy.deepcopy(m.state_dict())
                 for k, m in models.items() if m is not None}
    gen = torch.Generator().manual_seed(seed + 1)
    ema = {n: p.detach() + 0.01 * torch.randn(p.shape, generator=gen)
           for n, p in pipe.rf.net.named_parameters()}
    run, codec = str(root / "diff"), str(root / "ae")
    save_checkpoint(run, 3, {"variables": variables, "ema_params": ema,
                             "step": 3}, config_json=port_config.to_json(cfg))
    save_checkpoint(codec, 2, {"codec_vars": pipe.codec.state_dict(),
                               "step": 2},
                    config_json=port_config.ae_to_json(cfg.autoencoder))
    with torch.no_grad():
        for name, p in pipe.rf.net.named_parameters():
            p.copy_(ema[name])
    return run, codec, pipe


def latent_store(path, cfg, n=6):
    rng = np.random.RandomState(5)
    with RecordWriter(path) as w:
        for i in range(n):
            e = AudioExample()
            e.put_array("z", rng.randn(cfg.autoencoder.z_channels, 32)
                        .astype(np.float32))
            w.put(f"{i:08d}", e.serialize())
    return path


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_export")
    cfg = port_config.from_json(jax_config.to_json(micro_config()))
    run, codec, pipe = write_runs(root, cfg)
    db = latent_store(str(root / "zdb"), cfg)
    assert cli.main(["export", "--model_path", run, "--emb_model_path",
                     codec, "--db_path", db, "--map_samples", "6",
                     "--map_steps", "30", "--nb_steps", "3",
                     "--guidance_timbre", "1.5", "--device", "cpu"]) == 0
    return cfg, run, codec, pipe, os.path.join(run, "after.audio.diff")


def test_export_writes_the_runs_ema_artifact(exported):
    cfg, run, codec, pipe, art = exported
    for name in ("manifest.json", "structure.pt2", "timbre.pt2", "step.pt2",
                 "decode.pt2", "latent2map.pt2", "map2latent.pt2",
                 "projector.npz", "map.png", "state/initial_state.npz",
                 "state/leaf_0.bin"):
        assert os.path.exists(os.path.join(art, name)), name
    with open(os.path.join(art, "manifest.json")) as f:
        m = json.load(f)
    assert m["nb_steps"] == 3 and m["latent_map"] == 1
    assert m["attributes"]["guidance_timbre"]["default"] == 1.5
    assert m["streaming"] == "crossfade"        # the micro codec is centered
    host = ExportedStreamer(art, "cpu")
    streamer = Streamer(cfg, chunk_size=4, device="cpu", pipeline=pipe)
    state = streamer.init_state(1)
    rng = np.random.RandomState(0)
    for _ in range(3):
        a, b = (0.3 * rng.randn(2, 1, streamer.audio_chunk, 1)).astype(
            np.float32)
        x0 = rng.randn(1, 4, cfg.denoiser.n_channels).astype(np.float32)
        y, state = streamer.forward(state, a, b, 3, 1.5, x0=x0)
        assert torch.equal(host.call("forward", a, b, x0=x0), y)


def test_export_midi_writes_a_midi_artifact(tmp_path):
    cfg = port_config.from_json(jax_config.to_json(_micro_midi_config()))
    run, codec, _ = write_runs(tmp_path, cfg, seed=1)
    assert cli.main(["export_midi", "--model_path", run, "--emb_model_path",
                     codec, "--device", "cpu"]) == 0
    host = ExportedStreamer(os.path.join(run, "after.midi.diff"), "cpu")
    assert host.manifest["n_poly"] == 8
    assert host.has_method("diffuse_midi") and not host.has_method("forward")
    notes = np.zeros((1, 4, 8, 2), np.float32)
    notes[0, :, 0] = (60, 100)     # slot 0: pitch 60, velocity 100
    notes[0, :, 1] = (64, 90)
    z = host.call("diffuse_midi", notes, np.zeros((1, cfg.zt_channels),
                                                  np.float32))
    y = host.call("decode", z)
    assert tuple(y.shape) == (1, host.manifest["audio_chunk"], 1)
    assert torch.isfinite(y).all()


def test_export_refuses_a_codec_without_config(tmp_path):
    cfg = port_config.from_json(jax_config.to_json(micro_config()))
    run = tmp_path / "diff_run"
    run.mkdir()
    (run / "config.json").write_text(port_config.to_json(cfg))
    bare = tmp_path / "bare_codec"
    bare.mkdir()
    with pytest.raises(SystemExit, match="config.json"):
        cli.main(["export", "--model_path", str(run), "--emb_model_path",
                  str(bare), "--device", "cpu"])
    with pytest.raises(SystemExit, match="config.json"):
        cli.main(["export_autoencoder", "--model_path", str(bare),
                  "--device", "cpu"])


def test_export_refuses_a_latent_size_mismatch(tmp_path):
    cfg = port_config.from_json(jax_config.to_json(micro_config()))
    run = tmp_path / "diff_run"
    run.mkdir()
    (run / "config.json").write_text(port_config.to_json(cfg))
    codec = tmp_path / "codec"
    codec.mkdir()
    import dataclasses
    (codec / "config.json").write_text(port_config.ae_to_json(
        dataclasses.replace(cfg.autoencoder, z_channels=4)))
    with pytest.raises(SystemExit, match="z_channels=4"):
        cli.main(["export", "--model_path", str(run), "--emb_model_path",
                  str(codec), "--device", "cpu"])


def test_serve_trains_the_projector_from_a_store(exported):
    """``serve --model_path --emb_model_path --store``: the projector
    trained at serve time on the store's timbre vectors; the pad and a
    transfer answer."""
    from after_tpu_torch.cli.serve import build_argparser, load_frontend

    cfg, run, codec, _, _ = exported
    db = os.path.join(os.path.dirname(run), "zdb")
    args = build_argparser().parse_args(
        ["--model_path", run, "--emb_model_path", codec, "--store", db,
         "--map_samples", "6", "--map_steps", "20", "--nb_steps", "2",
         "--max_seconds", "0.1", "--device", "cpu"])
    app = load_frontend(args)
    assert app.info()["has_projector"] and app.info()["nb_steps"] == 2
    assert app.set_xy(0.3, -0.2).shape == (1, cfg.zt_channels)
    assert app.map_png[:8] == b"\x89PNG\r\n\x1a\n"
    out = app.transfer(_wav(cfg.sr), seed=2)
    assert out[:4] == b"RIFF"


@pytest.mark.parametrize("command", ["export", "export_midi",
                                     "export_autoencoder"])
def test_compute_dtype_is_refused(command, tmp_path):
    with pytest.raises(SystemExit, match="A.5"):
        cli.main([command, "--model_path", str(tmp_path),
                  "--compute_dtype", "bfloat16", "--device", "cpu"])


@pytest.mark.parametrize("command", ["export", "export_midi",
                                     "export_autoencoder", "serve"])
def test_export_and_serve_are_ported(command, capsys):
    assert command in cli.PORTED
    with pytest.raises(SystemExit) as e:
        cli.main([command, "--help"])
    assert e.value.code == 0
    assert f"after-tpu-torch {command}" in capsys.readouterr().out


def test_serve_artifact_in_a_process_without_jax(exported):
    cfg, run, codec, pipe, art = exported
    code = f"""
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ('jax', 'flax', 'after_tpu'):
            raise ImportError('refused: ' + name)
sys.meta_path.insert(0, Refuse())
from after_tpu_torch.cli.main import main
sys.exit(main(['serve', '--artifact', {art!r}, '--port', '0',
               '--max_seconds', '0.2', '--device', 'cpu']))
"""
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        line = proc.stdout.readline()
        assert "frontend at http://127.0.0.1:" in line, (
            line + proc.stderr.read() if proc.poll() is not None else line)
        base = line.strip().split(" at ")[1]
        info = json.loads(urllib.request.urlopen(base + "/api/info",
                                                 timeout=60).read())
        assert info["artifact"] == art and info["has_projector"]
        req = urllib.request.Request(base + "/api/transfer?steps=2",
                                     data=_wav(cfg.sr), method="POST")
        r = urllib.request.urlopen(req, timeout=60)
        assert r.status == 200 and r.headers["Content-Type"] == "audio/wav"
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.returncode is not None
