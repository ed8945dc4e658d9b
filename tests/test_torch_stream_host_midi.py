"""The native streaming host on a MIDI model's artifact, on the CPU: the
MIDI micro config of tests/test_torch_export_midi.py (causal, norm-free
codec), batch 2, the port's own seeded weights, exported and packaged for
the CPU.  Note-pair files (n_frames, n_poly, 2) and timbre WAVs, one per
voice, 6 buffers with ``--x0``, against the port's Python host running
``timbre``, ``diffuse_midi`` and ``decode`` on the same buffers within
HOST_TOL x max|y|.
"""

import dataclasses

import numpy as np
import pytest

from after_tpu import config as jax_config
from after_tpu_torch import config as port_config
from after_tpu_torch.diffusion.pipeline import TransferPipeline
from after_tpu_torch.streaming.export import ExportedStreamer, export_streamer
from after_tpu_torch.streaming.streamer import Streamer
from tests.test_diffusion import micro_config
from tests.torch_stream_host_common import (close, packaged, read_wav,
                                            run_host, write_wav)

B, N = 2, 6


@pytest.fixture(scope="module")
def midi_artifact(tmp_path_factory):
    cfg = jax_config.with_overrides(micro_config(), {
        "autoencoder.causal": True, "autoencoder.use_norm": False,
        "zs_channels": 128, "denoiser.tcond_dim": 128,
        "structure_type": "midi"})
    cfg = dataclasses.replace(cfg, encoder_time=None, classifier=None)
    pcfg = port_config.from_json(jax_config.to_json(cfg))
    pipe = TransferPipeline(pcfg, device="cpu").init(4)
    streamer = Streamer(pcfg, chunk_size=4, device="cpu", pipeline=pipe)
    root = tmp_path_factory.mktemp("host_midi")
    art = str(root / "art")
    export_streamer(streamer, art, nb_steps=3, guidance_timbre=1.5,
                    batch_size=B)
    manifest = packaged(art)
    assert manifest["native_stages"] == ["piano_roll", "timbre", "step",
                                         "decode"]
    return art, root, streamer


def test_midi_host_matches_the_python_host(midi_artifact):
    art, root, streamer = midi_artifact
    A, T = streamer.audio_chunk, streamer.chunk_size
    C, P = streamer.cfg.denoiser.n_channels, streamer.n_poly
    rng = np.random.RandomState(11)
    notes = np.zeros((B, N * T, P, 2), np.float32)
    notes[..., 0] = rng.randint(-3, 131, (B, N * T, P))
    notes[..., 1] = rng.randint(0, 128, (B, N * T, P))
    timbre = (0.3 * rng.randn(B, N * A)).astype(np.float32)
    x0 = rng.randn(N, B, T, C).astype(np.float32)
    x0.tofile(root / "x0.f32")
    for v in range(B):
        notes[v].tofile(root / f"notes{v}.f32")
        write_wav(root / f"t{v}.wav", timbre[v])
    lists = [",".join(str(root / f"{n}{v}{ext}") for v in range(B))
             for n, ext in (("notes", ".f32"), ("t", ".wav"),
                            ("out", ".wav"))]
    run_host([art, *lists, N, 3, 1.5, 1.0, "--x0", root / "x0.f32"])
    y = np.stack([read_wav(root / f"out{v}.wav") for v in range(B)])
    host = ExportedStreamer(art, "cpu")
    for i in range(N):
        zt = host.call("timbre", timbre[:, i * A:(i + 1) * A, None])
        z = host.call("diffuse_midi", notes[:, i * T:(i + 1) * T], zt,
                      x0=x0[i])
        ref = host.call("decode", z).numpy()
        close(f"native host vs ExportedStreamer, MIDI buffer {i}",
              y[:, i * A:(i + 1) * A, None], ref)
