"""Local web frontend of the port (counterpart of
after_tpu/frontend/server.py): an XY pad over the timbre map, timbre from
the pad or from reference audio, structure audio (or a MIDI file) in and
the transferred WAV out.

Two model halves behind one stdlib HTTP server:

- ``AfterFrontend``: checkpoints through ``TransferPipeline`` (on the card
  each request one CUDA graph, ``generate_timbre`` or ``generate``);
- ``ArtifactFrontend``: an exported artifact through ``ExportedStreamer``,
  buffer by buffer (its stages replayed as CUDA graphs).  The noise of
  buffer i comes from a generator seeded ``seed * 100003 + i``, as the JAX
  frontend seeds its keys.

Routes: ``GET /``, ``/map.png`` and ``/api/info``; ``POST /api/xy`` (JSON
{"x", "y"}), ``/api/timbre`` (WAV body), ``/api/transfer`` (WAV body) and
``/api/midi`` (MIDI body), the last two with ``?steps=&gt=&gs=&seed=``.
Errors come back as JSON.  Model calls are serialized behind one lock.
"""

from __future__ import annotations

import io
import json
import os
import threading
from typing import Optional

import numpy as np
import scipy.io.wavfile
import torch

from ..dataset.audio import normalize_signal, resample
from ..utils.latent_map import generate_map_png, png_bytes

_STATIC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "index.html")
SEED_STRIDE = 100003    # buffer i of a request of seed s: seed s * 100003 + i


def _parse_wav(data: bytes, target_sr: int) -> np.ndarray:
    """WAV bytes -> float32 mono (T,) at target_sr."""
    sr, x = scipy.io.wavfile.read(io.BytesIO(data))
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 32768.0
    elif x.dtype == np.int32:
        x = x.astype(np.float32) / 2147483648.0
    elif x.dtype == np.uint8:
        x = (x.astype(np.float32) - 128.0) / 128.0
    else:
        x = x.astype(np.float32)
    if x.ndim > 1:
        x = x.mean(axis=1)
    if sr != target_sr:
        x = resample(x, sr, target_sr)
    return normalize_signal(x)


def _wav_bytes(x, sr: int) -> bytes:
    buf = io.BytesIO()
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    scipy.io.wavfile.write(buf, sr, (x * 32767).astype(np.int16))
    return buf.getvalue()


def _blank_map() -> bytes:
    return png_bytes(generate_map_png(np.zeros((1, 2), np.float32),
                                      os.devnull))


def _map_png(map_dir: Optional[str]) -> Optional[bytes]:
    """The density PNG an exported artifact carries, or None."""
    if map_dir and os.path.exists(os.path.join(map_dir, "map.png")):
        with open(os.path.join(map_dir, "map.png"), "rb") as f:
            return f.read()
    return None


class AfterFrontend:
    """Model half of the web app over checkpoints: owns the pipeline, the
    current timbre vector and the XY pad's projector."""

    def __init__(self, cfg, pipeline, projector=None,
                 embeddings: Optional[np.ndarray] = None,
                 nb_steps: int = 20, max_seconds: float = 12.0,
                 map_dir: Optional[str] = None):
        self.cfg = cfg
        self.pipe = pipeline
        self.nb_steps = int(nb_steps)
        self.max_samples = int(max_seconds * cfg.sr)
        self.lock = threading.Lock()
        self.zsem = np.zeros((1, cfg.zt_channels), np.float32)
        self.projector = projector
        self.map_png = _map_png(map_dir)
        if self.map_png is None:
            emb2d = np.zeros((1, 2), np.float32)
            if projector is not None and embeddings is not None:
                emb2d = self._project(projector.encode, embeddings)
            self.map_png = png_bytes(generate_map_png(emb2d, os.devnull))

    def _project(self, fn, x) -> np.ndarray:
        p = next(self.projector.parameters())
        with torch.no_grad():
            return fn(torch.as_tensor(np.asarray(x, np.float32),
                                      device=p.device)).cpu().numpy()

    def _prep_audio(self, wav: bytes) -> np.ndarray:
        x = _parse_wav(wav, self.cfg.sr)[: self.max_samples]
        ratio = self.cfg.autoencoder.ratio
        T = max(ratio, (len(x) + ratio - 1) // ratio * ratio)
        return np.pad(x, (0, T - len(x)))[None, :, None]

    def set_xy(self, x: float, y: float) -> np.ndarray:
        """Pad position -> timbre vector (the projector's decode)."""
        if self.projector is None:
            raise ValueError("no projector trained (pass --store to serve)")
        self.zsem = self._project(self.projector.decode,
                                  [[float(x), float(y)]])
        return self.zsem

    def set_timbre_audio(self, wav: bytes):
        """Timbre of reference audio; returns its pad position when a
        projector exists."""
        z = self.pipe.encode(self._prep_audio(wav))
        self.zsem = self.pipe.timbre(z).cpu().numpy()
        if self.projector is not None:
            return self._project(self.projector.encode, self.zsem)[0].tolist()
        return None

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(self.pipe.device).manual_seed(int(seed))

    def transfer(self, wav: bytes, nb_steps: Optional[int] = None,
                 guidance_timbre: float = 1.0, guidance_structure: float = 1.0,
                 seed: int = 0) -> bytes:
        out = self.pipe.generate_timbre(
            self._prep_audio(wav), self.zsem, int(nb_steps or self.nb_steps),
            guidance_timbre, guidance_structure,
            generator=self._generator(seed))
        return _wav_bytes(out[0, :, 0].cpu().numpy(), self.cfg.sr)

    def transfer_midi(self, mid: bytes, nb_steps: Optional[int] = None,
                      guidance_timbre: float = 1.0,
                      guidance_structure: float = 1.0,
                      seed: int = 0) -> bytes:
        """MIDI file -> audio: the 128-bin piano roll at the latent rate is
        the structure codes of a MIDI model (zs_channels 128)."""
        if self.cfg.structure_type != "midi":
            raise ValueError("not a MIDI model (structure_type != 'midi'); "
                             "use /api/transfer with audio instead")
        from ..dataset.midi import MidiFile

        mf = MidiFile(data=mid)
        latent_rate = self.cfg.sr / self.cfg.autoencoder.ratio
        dur = min(max(mf.duration(), 1.0 / latent_rate),
                  self.max_samples / self.cfg.sr)
        T = max(8, int(dur * latent_rate))
        roll = (mf.get_piano_roll(np.arange(T) / latent_rate) / 127.0).T[None]
        out = self.pipe.generate(
            roll.astype(np.float32), self.zsem,
            int(nb_steps or self.nb_steps), guidance_timbre,
            guidance_structure, generator=self._generator(seed))
        return _wav_bytes(out[0, :, 0].cpu().numpy(), self.cfg.sr)

    def info(self) -> dict:
        return {"sr": self.cfg.sr, "zt_channels": self.cfg.zt_channels,
                "nb_steps": self.nb_steps,
                "ratio": self.cfg.autoencoder.ratio,
                "max_seconds": self.max_samples / self.cfg.sr,
                "is_midi": self.cfg.structure_type == "midi",
                "has_projector": self.projector is not None}


class ArtifactFrontend:
    """Model half of the web app over an exported artifact
    (``after-tpu-torch serve --artifact``): streams buffer by buffer
    through ``ExportedStreamer``; the XY pad uses the artifact's baked
    ``map2latent`` / ``latent2map`` and ``map.png`` (exported with
    ``--db_path``), and nb_steps and the guidances are its runtime
    attributes."""

    def __init__(self, path: str, nb_steps: Optional[int] = None,
                 max_seconds: float = 12.0, device=None):
        from ..streaming.export import ExportedStreamer

        self.path = path
        self.st = ExportedStreamer(path, device)
        m = self.st.manifest
        self.sr = int(m["sr"])
        self.audio_chunk = int(m["audio_chunk"])
        self.chunk_size = int(m["chunk_size"])
        self.batch = int(m.get("batch_size", 1))
        self.n_poly = int(m.get("n_poly", 0))
        self.is_midi = self.n_poly > 0
        self.zt_channels = int(m["config"]["zt_channels"])
        self.n_channels = int(m["config"]["denoiser"]["n_channels"])
        if nb_steps is not None:
            self.st.set_attribute("nb_steps", nb_steps)
        self.max_samples = int(max_seconds * self.sr)
        self.lock = threading.Lock()
        self.zsem = np.zeros((self.batch, self.zt_channels), np.float32)
        self.has_projector = bool(m.get("latent_map")) and \
            self.st.has_method("map2latent")
        self.map_png = _map_png(path) or _blank_map()

    def _chunks(self, wav: bytes) -> np.ndarray:
        """WAV bytes -> (N, B, audio_chunk, 1) buffers (voice 0 carries the
        signal; the other batched voices get zeros)."""
        x = _parse_wav(wav, self.sr)[: self.max_samples]
        A = self.audio_chunk
        n = max(A, (len(x) + A - 1) // A * A)
        x = np.pad(x, (0, n - len(x)))
        bufs = np.zeros((n // A, self.batch, A, 1), np.float32)
        bufs[:, 0, :, 0] = x.reshape(n // A, A)
        return bufs

    def _noise(self, seed: int, i: int) -> torch.Tensor:
        gen = torch.Generator(self.st.device).manual_seed(
            seed * SEED_STRIDE + i)
        return torch.randn((self.batch, self.chunk_size, self.n_channels),
                           generator=gen, device=self.st.device)

    def _attributes(self, nb_steps, guidance_timbre, guidance_structure):
        if nb_steps is not None:
            self.st.set_attribute("nb_steps", nb_steps)
        self.st.set_attribute("guidance_timbre", guidance_timbre)
        self.st.set_attribute("guidance_structure", guidance_structure)

    def set_xy(self, x: float, y: float) -> np.ndarray:
        if not self.has_projector:
            raise ValueError("artifact has no latent map (re-export with "
                             "--db_path to bake the XY pad)")
        xy = np.tile(np.asarray([[float(x), float(y)]], np.float32),
                     (self.batch, 1))
        self.zsem = self.st.call("map2latent", xy).cpu().numpy()
        return self.zsem

    def set_timbre_audio(self, wav: bytes):
        """The reference audio streamed through the artifact's ``timbre``
        method (its latent ring fills up); the last buffer's timbre vector
        becomes the current one."""
        zt = None
        for buf in self._chunks(wav):
            zt = self.st.call("timbre", buf)
        self.zsem = zt.cpu().numpy()
        if self.has_projector:
            return self.st.call("latent2map", self.zsem)[0].tolist()
        return None

    def transfer(self, wav: bytes, nb_steps: Optional[int] = None,
                 guidance_timbre: float = 1.0,
                 guidance_structure: float = 1.0, seed: int = 0) -> bytes:
        if self.is_midi:
            raise ValueError("MIDI artifact: use /api/midi with a .mid file")
        self._attributes(nb_steps, guidance_timbre, guidance_structure)
        outs = [self.st.call("generate_timbre", buf, self.zsem,
                             x0=self._noise(seed, i))[0, :, 0].cpu().numpy()
                for i, buf in enumerate(self._chunks(wav))]
        return _wav_bytes(np.concatenate(outs), self.sr)

    def transfer_midi(self, mid: bytes, nb_steps: Optional[int] = None,
                      guidance_timbre: float = 1.0,
                      guidance_structure: float = 1.0,
                      seed: int = 0) -> bytes:
        """MIDI file -> note-pair buffers -> diffuse_midi and decode,
        buffer by buffer."""
        if not self.is_midi:
            raise ValueError("not a MIDI artifact; use /api/transfer")
        from ..dataset.midi import MidiFile

        self._attributes(nb_steps, guidance_timbre, guidance_structure)
        mf = MidiFile(data=mid)
        latent_rate = self.sr / (self.audio_chunk // self.chunk_size)
        dur = min(max(mf.duration(), 1.0 / latent_rate),
                  self.max_samples / self.sr)
        T = int(np.ceil(dur * latent_rate / self.chunk_size)
                ) * self.chunk_size
        pairs = mf.get_note_pairs(np.arange(T) / latent_rate, self.n_poly)
        outs = []
        for i in range(0, T, self.chunk_size):
            notes = np.zeros((self.batch, self.chunk_size, self.n_poly, 2),
                             np.float32)
            notes[0] = pairs[i:i + self.chunk_size]
            z = self.st.call("diffuse_midi", notes, self.zsem,
                             x0=self._noise(seed, i))
            outs.append(self.st.call("decode", z)[0, :, 0].cpu().numpy())
        return _wav_bytes(np.concatenate(outs), self.sr)

    def info(self) -> dict:
        return {"sr": self.sr, "zt_channels": self.zt_channels,
                "nb_steps": self.st.get_attribute("nb_steps"),
                "ratio": self.audio_chunk // self.chunk_size,
                "max_seconds": self.max_samples / self.sr,
                "is_midi": self.is_midi,
                "has_projector": self.has_projector,
                "artifact": self.path}


def make_handler(app):
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                with open(_STATIC, "rb") as f:
                    self._send(200, f.read(), "text/html; charset=utf-8")
            elif self.path == "/map.png":
                self._send(200, app.map_png, "image/png")
            elif self.path == "/api/info":
                self._json(app.info())
            else:
                self._json({"error": "not found"}, 404)

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n)

        def do_POST(self):
            try:
                if self.path == "/api/xy":
                    req = json.loads(self._body())
                    with app.lock:
                        z = app.set_xy(req["x"], req["y"])
                    self._json({"zsem": z[0].tolist()})
                elif self.path == "/api/timbre":
                    with app.lock:
                        xy = app.set_timbre_audio(self._body())
                    self._json({"xy": xy})
                elif self.path.startswith(("/api/transfer", "/api/midi")):
                    q = {k: v[0] for k, v in
                         parse_qs(urlparse(self.path).query).items()}
                    fn = (app.transfer_midi
                          if self.path.startswith("/api/midi")
                          else app.transfer)
                    with app.lock:
                        wav = fn(
                            self._body(),
                            nb_steps=int(q["steps"]) if "steps" in q else None,
                            guidance_timbre=float(q.get("gt", 1.0)),
                            guidance_structure=float(q.get("gs", 1.0)),
                            seed=int(q.get("seed", 0)))
                    self._send(200, wav, "audio/wav")
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # the request fails, the server stays up
                self._json({"error": f"{type(e).__name__}: {e}"}, 400)

    return Handler


def make_server(app, host: str = "127.0.0.1", port: int = 8675):
    """A ``ThreadingHTTPServer`` of ``app`` on (host, port); port 0 takes a
    free one (``server.server_port``)."""
    from http.server import ThreadingHTTPServer
    return ThreadingHTTPServer((host, port), make_handler(app))


def serve(app, host: str = "127.0.0.1", port: int = 8675) -> None:
    """Serves ``app`` until interrupted; prints the address first."""
    server = make_server(app, host, port)
    print(f"[serve] after_tpu_torch frontend at "
          f"http://{host}:{server.server_port}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
