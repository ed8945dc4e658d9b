"""The native streaming host's live mode on the CPU: an audio-to-audio
artifact of one voice (``--pcm`` takes batch 1 only) with the causal,
norm-free micro codec (cached convs, not the crossfade path), the port's
own seeded weights, exported and packaged for the CPU.  Interleaved
two-channel f32 through stdin (structure, timbre), mono f32 out of stdout,
with ``--x0``: equal to file mode on the same audio, and to the port's
Python host, within HOST_TOL x max|y| (two runs of the CPU packages part by
rounding, tests/test_torch_stream_host.py); with AFTER_NATIVE_PIPELINE=1
(no readback in flight) as well.
"""

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

N = 6


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    cfg = jax_config.with_overrides(micro_config(), {
        "autoencoder.causal": True, "autoencoder.use_norm": False})
    pcfg = port_config.from_json(jax_config.to_json(cfg))
    pipe = TransferPipeline(pcfg, device="cpu").init(6)
    streamer = Streamer(pcfg, chunk_size=4, device="cpu", pipeline=pipe)
    root = tmp_path_factory.mktemp("host_pcm")
    art = str(root / "art")
    export_streamer(streamer, art, nb_steps=2, guidance_timbre=2.0)
    assert packaged(art)["streaming"] == "cached"
    A, T = streamer.audio_chunk, streamer.chunk_size
    rng = np.random.RandomState(12)
    a, b = (0.3 * rng.randn(2, N * A)).astype(np.float32)
    x0 = rng.randn(N, 1, T, pcfg.denoiser.n_channels).astype(np.float32)
    x0.tofile(root / "x0.f32")
    write_wav(root / "s.wav", a)
    write_wav(root / "t.wav", b)
    run_host([art, root / "s.wav", root / "t.wav", root / "out.wav", N,
              "--x0", root / "x0.f32"])
    return art, root, a, b, x0, A, read_wav(root / "out.wav")


def _pcm(live, env=None):
    art, root, a, b, _, _, _ = live
    frames = np.stack([a, b], axis=1).astype("<f4").tobytes()
    proc = run_host([art, "--pcm", "--x0", root / "x0.f32"], stdin=frames,
                    env=env)
    assert "live PCM mode: 2ch" in proc.stderr.decode()
    return np.frombuffer(proc.stdout, "<f4")


def test_pcm_equals_file_mode(live):
    y = live[-1]
    close("--pcm vs file mode", _pcm(live), y)
    close("--pcm, readback depth 1, vs file mode",
          _pcm(live, {"AFTER_NATIVE_PIPELINE": "1"}), y)


def test_pcm_host_matches_the_python_host(live):
    art, _, a, b, x0, A, _ = live
    y = _pcm(live)
    host = ExportedStreamer(art, "cpu")
    ref = np.concatenate([host.call(
        "forward", a[None, i * A:(i + 1) * A, None],
        b[None, i * A:(i + 1) * A, None], x0=x0[i]).numpy().ravel()
        for i in range(N)])
    close(f"native host (--pcm) vs ExportedStreamer, {N} buffers", y, ref)
