"""The port's bf16 streamer and artifacts against the JAX package's, on the
CPU, with tests/test_torch_bf16.py's micro ``base`` config and weights:

- 4 buffers of the port's bf16 ``Streamer`` against the JAX streamer in f32
  and in bf16, held by the bf16 tolerance rule of
  tests/test_torch_precision.py and the JAX package's cosine bound for a
  stream (0.98, tests/test_precision.py); the state's floating leaves
  bf16, the output f32;
- a JAX bf16 artifact (``export_streamer`` of a bf16 JAX streamer): its
  manifest says "bfloat16", and the port's state reader
  (``streaming.export.load_state``, with which ``ExportedStreamer`` loads
  its state) reads its uint16-stored leaves back as bf16, bit for bit the
  JAX streamer's initial state, each leaf matched by path to the port's
  bf16 state in shape and dtype.  (Their values are not compared: the
  crossfade state's GroupNorm pads are one pass over silence, where a
  GroupNorm of nearly constant windows magnifies rounding, so two bf16
  runs that round at other places part by up to 0.18 of a max of 1.9 in
  the micro codec.)

The port's own bf16 artifact against the live bf16 streamer (bit for bit):
tests/test_torch_cli_export.py (``--compute_dtype bfloat16``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from after_tpu.streaming import Streamer as JaxStreamer
from after_tpu.streaming.export import export_streamer as jax_export
from after_tpu_torch.streaming import Streamer
from after_tpu_torch.streaming.export import load_state
from after_tpu_torch.streaming.state import flatten_state
from tests.test_torch_bf16 import pair  # noqa: F401  the shared weights
from tests.test_torch_export_jax import jax_state_paths
from tests.test_torch_precision import bf16_close, cosine

STREAM_COS = 0.98


def test_stream(pair):  # noqa: F811
    """4 buffers at batch 1, nb_steps 2: the port's bf16 streamer against
    the JAX streamer in f32 and in bf16, from the same x0; the state's
    floating leaves bf16, the output f32."""
    j32, j16, v32, v16, p16, _ = pair
    cfg = j32.cfg
    js32 = JaxStreamer(cfg, chunk_size=4)
    js16 = JaxStreamer(cfg, chunk_size=4, compute_dtype="bfloat16")
    w16 = js16.prepare_variables(v32)
    s32, s16 = js32.init_state(v32), js16.init_state(w16)
    ps = Streamer(p16.cfg, chunk_size=4, device="cpu", pipeline=p16)
    state = ps.init_state(1)
    leaves = flatten_state(state).values()
    assert {t.dtype for t in leaves if t.is_floating_point()} == {
        torch.bfloat16}
    assert state.prev_timbre.dtype == torch.bfloat16
    rng = np.random.RandomState(4)
    A = ps.audio_chunk
    ys = {"port": [], "f32": [], "bf16": []}
    for i in range(4):
        a = (0.3 * rng.randn(1, A, 1)).astype(np.float32)
        b = (0.3 * rng.randn(1, A, 1)).astype(np.float32)
        key = jax.random.PRNGKey(100 + i)
        x0 = np.array(jax.random.normal(key, (1, 4, 8)))
        y, s32 = js32.forward(v32, s32, jnp.asarray(a), jnp.asarray(b), 2,
                              rng=key)
        ys["f32"].append(np.asarray(y))
        y, s16 = js16.forward(w16, s16, jnp.asarray(a), jnp.asarray(b), 2,
                              rng=key)
        ys["bf16"].append(np.asarray(y))
        y, state = ps.forward(state, a, b, 2, x0=x0)
        assert y.dtype == torch.float32
        ys["port"].append(y.numpy())
    y = {k: np.concatenate(v, 1) for k, v in ys.items()}
    bf16_close("stream", y["port"], y["bf16"], y["f32"])
    cos = cosine(y["port"], y["f32"])
    print(f"stream: cosine to JAX f32 {cos:.5f}")
    assert cos >= STREAM_COS
    assert js16.init_state(w16).prev_timbre.dtype == jnp.bfloat16


def test_jax_bf16_artifact_state_read_by_the_port(pair, tmp_path):  # noqa: F811
    j32, j16, v32, v16, p16, _ = pair
    cfg = j32.cfg
    js16 = JaxStreamer(cfg, chunk_size=4, compute_dtype="bfloat16")
    w16 = js16.prepare_variables(v32)
    out = str(tmp_path / "jax16")
    jax_export(js16, w16, out, nb_steps=2, batch_size=1)
    with open(os.path.join(out, "manifest.json")) as f:
        m = json.load(f)
    assert "bfloat16" in m["state_dtypes"]
    leaves = load_state(os.path.join(out, "state", "initial_state.npz"),
                        torch.device("cpu"), m["state_dtypes"])
    for t, dtype in zip(leaves, m["state_dtypes"]):
        assert str(t.dtype) == f"torch.{dtype}"
    # the leaves' raw files hold the same 2-byte values
    raw = np.fromfile(os.path.join(out, "state", "leaf_0.bin"), np.uint16)
    assert m["state_dtypes"][0] == "bfloat16"
    assert np.array_equal(raw, leaves[0].view(torch.int16).numpy().view(
        np.uint16).ravel())
    # the leaves read back are the JAX streamer's initial state, bit for bit
    paths = jax_state_paths(js16, w16)
    init = jax.tree_util.tree_leaves(js16.init_state(w16, 1))
    for path, t, a in zip(paths, leaves, init):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            a = a.view(np.uint16)
            t = t.view(torch.int16).numpy().view(np.uint16)
        else:
            t = t.numpy()
        assert t.shape == a.shape and np.array_equal(t, a), path
    # and they are the port's bf16 state leaves, path for path
    ps = Streamer(p16.cfg, chunk_size=4, device="cpu", pipeline=p16)
    ours = flatten_state(ps.new_state(1))
    assert sorted(ours) == sorted(paths)
    theirs = dict(zip(paths, leaves))
    for path, t in ours.items():
        assert (t.shape, t.dtype) == (theirs[path].shape,
                                      theirs[path].dtype), path
