"""The port's web frontend (after_tpu_torch/frontend/server.py) over HTTP on
an ephemeral port, on the CPU, with the micro configs of
tests/test_diffusion.py and tests/test_frontend.py: the cases of
tests/test_frontend.py for ``AfterFrontend`` (checkpoints through
``TransferPipeline``) and those of tests/test_export.py for
``ArtifactFrontend`` (an exported artifact through ``ExportedStreamer``,
its projector and map baked in).  A transfer is held to the same call
made directly: equal bits.
"""

import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from after_tpu import config as jax_config
from after_tpu_torch import config as port_config
from after_tpu_torch.diffusion.pipeline import TransferPipeline
from after_tpu_torch.frontend.server import (ArtifactFrontend, AfterFrontend,
                                             SEED_STRIDE, make_server)
from after_tpu_torch.streaming.export import export_streamer
from after_tpu_torch.streaming.streamer import Streamer
from after_tpu_torch.utils.latent_map import save_projector, train_projector
from tests.test_diffusion import micro_config
from tests.test_frontend import _micro_midi_config


def _port(cfg):
    return port_config.from_json(jax_config.to_json(cfg))


def _wav(sr, seconds=0.05, freq=220.0):
    t = np.arange(int(sr * seconds)) / sr
    x = (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    buf = io.BytesIO()
    scipy.io.wavfile.write(buf, sr, (x * 32767).astype(np.int16))
    return buf.getvalue()


def _post(url, body):
    return urllib.request.urlopen(urllib.request.Request(
        url, data=body, method="POST"))


def _read_wav(body):
    sr, out = scipy.io.wavfile.read(io.BytesIO(body))
    return sr, out


class Server:
    """``app`` served on 127.0.0.1 at a free port, in a thread."""

    def __init__(self, app):
        self.httpd = make_server(app, "127.0.0.1", 0)
        self.base = f"http://127.0.0.1:{self.httpd.server_port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def served():
    cfg = _port(micro_config())
    pipe = TransferPipeline(cfg, device="cpu").init(0)
    emb = np.random.RandomState(0).randn(64, cfg.zt_channels).astype(
        np.float32)
    projector = train_projector(emb, num_steps=50, device="cpu")
    app = AfterFrontend(cfg, pipe, projector=projector, embeddings=emb,
                        nb_steps=2, max_seconds=0.1)
    server = Server(app)
    yield server.base, cfg, app
    server.close()


def test_static_and_info(served):
    base, cfg, _ = served
    html = urllib.request.urlopen(base + "/").read()
    assert b"<canvas" in html and b"/api/transfer" in html
    info = json.loads(urllib.request.urlopen(base + "/api/info").read())
    assert info["sr"] == cfg.sr and info["has_projector"]
    assert not info["is_midi"] and info["nb_steps"] == 2
    png = urllib.request.urlopen(base + "/map.png").read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nowhere")
    assert e.value.code == 404


def test_xy_sets_timbre(served):
    base, cfg, app = served
    r = _post(base + "/api/xy", json.dumps({"x": 0.3, "y": -0.5}).encode())
    z = json.loads(r.read())["zsem"]
    assert len(z) == cfg.zt_channels
    with torch.no_grad():
        want = app.projector.decode(torch.tensor([[0.3, -0.5]]))[0]
    np.testing.assert_array_equal(np.float32(z), want.numpy())
    r = _post(base + "/api/xy", json.dumps({"x": -0.8, "y": 0.8}).encode())
    assert not np.allclose(z, json.loads(r.read())["zsem"])


def test_timbre_from_audio_returns_xy(served):
    base, cfg, app = served
    r = _post(base + "/api/timbre", _wav(cfg.sr))
    xy = json.loads(r.read())["xy"]
    assert len(xy) == 2 and all(-1.0 <= v <= 1.0 for v in xy)
    assert app.zsem.shape == (1, cfg.zt_channels)


def test_transfer_roundtrip(served):
    """The WAV back is the pipeline's generate_timbre of the padded input
    with the generator of the request's seed."""
    base, cfg, app = served
    _post(base + "/api/xy", json.dumps({"x": 0.1, "y": 0.2}).encode())
    r = _post(base + "/api/transfer?steps=3&gt=1.5&gs=0.5&seed=4",
              _wav(cfg.sr))
    assert r.headers["Content-Type"] == "audio/wav"
    sr, out = _read_wav(r.read())
    assert sr == cfg.sr and np.isfinite(out).all()
    assert len(out) >= int(cfg.sr * 0.05)
    y = app.pipe.generate_timbre(
        app._prep_audio(_wav(cfg.sr)), app.zsem, 3, 1.5, 0.5,
        generator=torch.Generator().manual_seed(4))
    want = (np.clip(y[0, :, 0].numpy(), -1, 1) * 32767).astype(np.int16)
    np.testing.assert_array_equal(out, want)


def test_error_is_json_not_crash(served):
    base, _, _ = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/api/transfer", b"this is not a wav")
    assert e.value.code == 400
    assert "error" in json.loads(e.value.read())
    # the server still answers
    assert urllib.request.urlopen(base + "/api/info").status == 200


def test_midi_endpoint_rejected_on_a2a_model(served):
    base, _, _ = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/api/midi", b"MThd")
    assert e.value.code == 400
    assert "not a MIDI model" in json.loads(e.value.read())["error"]


def _midi_bytes(tmp_path):
    from after_tpu.dataset.midi import MidiFile, Note
    mf = MidiFile(notes=[Note(pitch=60, velocity=100, start=0.0, end=0.5),
                         Note(pitch=64, velocity=90, start=0.25, end=0.75)])
    mf.save(str(tmp_path / "x.mid"))
    return (tmp_path / "x.mid").read_bytes()


def test_midi_transfer_endpoint(tmp_path):
    cfg = _port(_micro_midi_config())
    app = AfterFrontend(cfg, TransferPipeline(cfg, device="cpu").init(0),
                        nb_steps=2, max_seconds=2.0)
    server = Server(app)
    try:
        info = json.loads(urllib.request.urlopen(
            server.base + "/api/info").read())
        assert info["is_midi"] and not info["has_projector"]
        r = _post(server.base + "/api/midi?steps=2", _midi_bytes(tmp_path))
        assert r.headers["Content-Type"] == "audio/wav"
        sr, out = _read_wav(r.read())
        assert sr == cfg.sr and len(out) > 0 and np.isfinite(out).all()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.base + "/api/xy", b'{"x": 0, "y": 0}')
        assert "no projector" in json.loads(e.value.read())["error"]
    finally:
        server.close()


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """An artifact of batch 2 with a projector and its map baked in."""
    cfg = _port(jax_config.with_overrides(micro_config(), {
        "autoencoder.causal": True, "autoencoder.use_norm": False}))
    pipe = TransferPipeline(cfg, device="cpu").init(1)
    streamer = Streamer(cfg, chunk_size=4, device="cpu", pipeline=pipe)
    emb = np.random.RandomState(1).randn(64, cfg.zt_channels).astype(
        np.float32)
    projector = train_projector(emb, num_steps=50, device="cpu")
    out = str(tmp_path_factory.mktemp("frontend") / "after.audio.run")
    export_streamer(streamer, out, nb_steps=2, batch_size=2,
                    projector=projector)
    save_projector(out, projector, emb)
    return cfg, out


def test_artifact_frontend_serves_an_export(artifact):
    cfg, art = artifact
    app = ArtifactFrontend(art, nb_steps=1, max_seconds=0.2, device="cpu")
    info = app.info()
    assert info["has_projector"] and not info["is_midi"]
    assert info["nb_steps"] == 1 and info["artifact"] == art
    z1, z2 = app.set_xy(0.2, -0.3), app.set_xy(-0.7, 0.6)
    assert z1.shape == (2, cfg.zt_channels)   # the batched voices
    assert not np.allclose(z1, z2)
    xy = app.set_timbre_audio(_wav(cfg.sr))
    assert len(xy) == 2
    server = Server(app)
    try:
        png = urllib.request.urlopen(server.base + "/map.png").read()
        with open(os.path.join(art, "map.png"), "rb") as f:
            assert png == f.read()
        info = json.loads(urllib.request.urlopen(
            server.base + "/api/info").read())
        assert info["artifact"] == art
        r = _post(server.base + "/api/transfer?steps=2&seed=3",
                  _wav(cfg.sr))
        assert r.headers["Content-Type"] == "audio/wav"
        sr, out = _read_wav(r.read())
    finally:
        server.close()
    assert sr == cfg.sr and np.isfinite(out).all()
    assert len(out) % app.audio_chunk == 0    # whole streamed buffers
    # the same buffers through the host from the same state (the timbre
    # stream that set_timbre_audio moved is not read), the noise of buffer
    # i from seed 3 * SEED_STRIDE + i
    app.st.reset()
    ys = []
    for i, buf in enumerate(app._chunks(_wav(cfg.sr))):
        x0 = torch.randn((2, 4, cfg.denoiser.n_channels),
                         generator=torch.Generator().manual_seed(
                             3 * SEED_STRIDE + i))
        app.st.set_attribute("nb_steps", 2)
        ys.append(app.st.call("generate_timbre", buf, app.zsem,
                              x0=x0)[0, :, 0].numpy())
    want = (np.clip(np.concatenate(ys), -1, 1) * 32767).astype(np.int16)
    assert want.any()
    np.testing.assert_array_equal(out, want)


def test_serve_finds_the_artifact_projector(artifact, tmp_path):
    """``load_frontend`` without --store takes the projector and map of an
    artifact under the run dir."""
    from after_tpu_torch.cli.serve import (build_argparser,
                                           find_artifact_projector,
                                           load_frontend)
    from after_tpu_torch.utils.checkpoint import save_checkpoint

    cfg, art = artifact
    run = os.path.dirname(art)
    projector, found = find_artifact_projector(run, cfg.zt_channels, "cpu")
    assert projector is not None and found == art
    pipe = TransferPipeline(cfg, device="cpu").init(1)
    models = {"net": pipe.rf.net, "encoder": pipe.rf.encoder,
              "encoder_time": pipe.rf.encoder_time}
    save_checkpoint(run, 1, {"variables": {k: m.state_dict()
                                           for k, m in models.items()},
                             "step": 1},
                    config_json=port_config.to_json(cfg))
    codec = str(tmp_path / "codec")
    save_checkpoint(codec, 1, {"codec_vars": pipe.codec.state_dict()},
                    config_json=port_config.ae_to_json(cfg.autoencoder))
    args = build_argparser().parse_args(
        ["--model_path", run, "--emb_model_path", codec, "--nb_steps", "2",
         "--max_seconds", "0.1", "--device", "cpu"])
    app = load_frontend(args)
    assert app.info()["has_projector"]
    with open(os.path.join(art, "map.png"), "rb") as f:
        assert app.map_png == f.read()
    np.testing.assert_array_equal(
        app.set_xy(0.1, 0.2),
        projector.decode(torch.tensor([[0.1, 0.2]])).detach().numpy())
