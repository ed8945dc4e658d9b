"""The port's native streaming host (after_tpu_torch/csrc/stream_host.cc) on
a bf16 artifact, on the CPU: the micro crossfade config of
tests/test_torch_stream_host.py with port-native weights (seed 0), streamed
at ``compute_dtype="bfloat16"``, exported, packaged with AOTInductor for the
CPU and played in file mode over 4 buffers at nb_steps 2, with ``--x0`` the
noise the Python hosts are given:

- the host reads the artifact's bf16 state leaves (2 bytes a value in
  ``leaf_<i>.bin``) and runs the op's plain bf16 version from its C++
  library (its calls counted);
- its output against the port's Python host of the same artifact
  (``ExportedStreamer``) by the bf16 rule of tests/test_torch_precision.py,
  both held to the live f32 streamer over the same f32 weights: Inductor's
  generated code computes bf16 elementwise chains in f32 and rounds where
  the program run op by op does not, so the two hosts part by bf16
  rounding, not by HOST_TOL; the host's output also within the stream's
  cosine bound (0.98) of the f32 one.
"""

import json
import os

import numpy as np
import pytest

from after_tpu import config as jax_config
from after_tpu_torch import config as port_config
from after_tpu_torch.diffusion.pipeline import TransferPipeline
from after_tpu_torch.streaming import Streamer
from after_tpu_torch.streaming.export import ExportedStreamer, export_streamer
from tests.test_diffusion import micro_config
from tests.test_torch_precision import bf16_close, cosine
from tests.torch_stream_host_common import (host_line, packaged, read_wav,
                                            run_host, write_wav)

N = 4                 # buffers
NB_STEPS = 2
STREAM_COS = 0.98


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = port_config.from_json(jax_config.to_json(jax_config.with_overrides(
        micro_config(), {"autoencoder.causal": False,
                         "autoencoder.use_norm": True})))
    p32 = TransferPipeline(cfg, device="cpu").init(0)
    p16 = p32.with_compute_dtype("bfloat16")
    s16 = Streamer(cfg, chunk_size=4, device="cpu", pipeline=p16)
    root = tmp_path_factory.mktemp("host_bf16")
    art = str(root / "art16")
    export_streamer(s16, art, nb_steps=NB_STEPS)
    manifest = packaged(art)
    A, T, C = s16.audio_chunk, s16.chunk_size, cfg.denoiser.n_channels
    rng = np.random.RandomState(11)
    a = (0.3 * rng.randn(N * A)).astype(np.float32)
    b = (0.3 * rng.randn(N * A)).astype(np.float32)
    x0 = rng.randn(N, 1, T, C).astype(np.float32)
    write_wav(root / "s.wav", a)
    write_wav(root / "t.wav", b)
    x0.tofile(root / "x0.f32")
    proc = run_host([art, root / "s.wav", root / "t.wav", root / "y.wav", N,
                     NB_STEPS, "--x0", root / "x0.f32"])
    y = read_wav(root / "y.wav")
    return dict(cfg=cfg, p32=p32, art=art, manifest=manifest, A=A, a=a, b=b,
                x0=x0, proc=proc, y=y)


def _python_host(s):
    host = ExportedStreamer(s["art"], "cpu")
    host.set_attribute("nb_steps", NB_STEPS)
    A = s["A"]
    return np.concatenate([
        host.call("forward", s["a"][None, i * A:(i + 1) * A, None],
                  s["b"][None, i * A:(i + 1) * A, None],
                  x0=s["x0"][i]).numpy().ravel() for i in range(N)])


def _live_f32(s):
    streamer = Streamer(s["cfg"], chunk_size=4, device="cpu",
                        pipeline=s["p32"])
    state = streamer.init_state(1)
    A, ys = s["A"], []
    for i in range(N):
        y, state = streamer.forward(
            state, s["a"][None, i * A:(i + 1) * A, None],
            s["b"][None, i * A:(i + 1) * A, None], NB_STEPS, x0=s["x0"][i])
        ys.append(y.numpy().ravel())
    return np.concatenate(ys)


def test_host_reads_bf16_state_and_runs_the_plain_bf16_op(setup):
    s = setup
    m = s["manifest"]
    assert "bfloat16" in m["state_dtypes"]
    i = m["state_dtypes"].index("bfloat16")
    raw = os.path.getsize(os.path.join(s["art"], "state", f"leaf_{i}.bin"))
    assert raw == 2 * int(np.prod(m["state_shapes"][i]))
    with open(os.path.join(s["art"], "manifest.json")) as f:
        assert json.load(f)["state_dtypes"] == m["state_dtypes"]
    calls = int(host_line(s["proc"], "snake_conv plain-version calls on "
                                     "the CPU: ").split()[0])
    assert calls > 0 and calls % N == 0
    assert s["y"].shape == (N * s["A"],) and np.isfinite(s["y"]).all()


def test_host_matches_the_python_host_by_the_bf16_rule(setup):
    s = setup
    py16, f32 = _python_host(s), _live_f32(s)
    bf16_close("native host vs the f32 stream", s["y"], py16, f32)
    cos = cosine(s["y"], f32)
    print(f"native host bf16: cosine to the f32 stream {cos:.5f}")
    assert cos >= STREAM_COS
