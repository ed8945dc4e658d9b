"""The port's native streaming host (after_tpu_torch/csrc/stream_host.cc) on
the CPU, built with this machine's C++ compiler against the CPU libtorch:
the micro config of tests/test_torch_export_jax.py (crossfade codec with
GroupNorm, batch 2), the port's artifact packaged with AOTInductor for the
CPU (streaming/native.py) and played in file mode, its two voices as
comma-separated file lists:

- over 8 buffers whose nb_steps and guidances change (``@N`` lines of
  AFTER_NATIVE_CTRL), with ``--x0`` set to the JAX normals of keys
  [c + 1, 42] (what the JAX host draws), against the JAX artifact's
  ``forward`` (jitted) within CODEC_TOL, and against the port's Python host
  (``ExportedStreamer``) within HOST_TOL x max|y|;
- an AFTER_NATIVE_CTRL line ``nb_steps 4`` equal to ``nb_steps`` 4 on the
  command line (as scripts/native_ctrl_check.py holds the JAX host), and
  unlike nb_steps 1: equal within HOST_TOL x max|y|, since two runs of the
  same CPU packages are not bitwise equal (the timbre stage's generated
  code parts by 1e-7 x max from process to process, where the program run
  op by op does not; the output then by about 1e-6 x max);
- no card and no ``--device cpu``: a non-zero exit that says so;
- the program links no libpython.
"""

import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from after_tpu import config as jax_config
from after_tpu_torch.ops.kernels.build import native_host
from after_tpu_torch.streaming.export import ExportedStreamer
from tests.test_diffusion import micro_config
from tests.test_torch_export_jax import B, JaxArtifact, export_pair
from tests.test_torch_serving import ATTRIBUTES, CODEC_TOL
from tests.torch_stream_host_common import (close, host_line, packaged,
                                            read_wav, run_host, write_wav)

N = len(ATTRIBUTES)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = jax_config.with_overrides(micro_config(), {
        "autoencoder.causal": False, "autoencoder.use_norm": True})
    variables, js, ps, jax_out, port_out = export_pair(cfg, tmp_path_factory)
    manifest = packaged(port_out)
    io = tmp_path_factory.mktemp("host_io")
    A, T, C = ps.audio_chunk, ps.chunk_size, ps.cfg.denoiser.n_channels
    rng = np.random.RandomState(7)
    a = (0.3 * rng.randn(B, N * A)).astype(np.float32)
    b = (0.3 * rng.randn(B, N * A)).astype(np.float32)
    files = {}
    for name, x in (("s", a), ("t", b)):
        files[name] = ",".join(str(io / f"{name}{v}.wav") for v in range(B))
        for v in range(B):
            write_wav(io / f"{name}{v}.wav", x[v])
    # the JAX host's draw for buffer c: the normals of key data [c + 1, 42]
    keys = [np.array([c + 1, 42], np.uint32) for c in range(N)]
    x0 = np.stack([np.asarray(jax.random.normal(
        jax.random.wrap_key_data(jnp.asarray(k)), (B, T, C))) for k in keys])
    x0.astype(np.float32).tofile(io / "x0.f32")
    return dict(jax_out=jax_out, port_out=port_out, manifest=manifest, io=io,
                a=a, b=b, keys=keys, x0=x0, A=A, files=files)


def _play(s, out, nb_steps, ctrl=None, extra=()):
    """The host over the setup's buffers; its (B, N * A) output."""
    io = s["io"]
    outs = ",".join(str(io / f"{out}{v}.wav") for v in range(B))
    env = None
    if ctrl is not None:
        (io / f"{out}.ctrl").write_text(ctrl)
        env = {"AFTER_NATIVE_CTRL": str(io / f"{out}.ctrl")}
    proc = run_host([s["port_out"], s["files"]["s"], s["files"]["t"], outs,
                     N, nb_steps, "--x0", io / "x0.f32", *extra], env=env)
    y = np.stack([read_wav(io / f"{out}{v}.wav") for v in range(B)])
    return proc, y


@pytest.fixture(scope="module")
def changing(setup):
    """The host over 8 buffers with ATTRIBUTES set buffer by buffer."""
    ctrl = "".join(f"@{i} nb_steps {nb}\n@{i} guidance_timbre {gt}\n"
                   f"@{i} guidance_structure {gs}\n"
                   for i, (nb, gt, gs) in enumerate(ATTRIBUTES))
    return _play(setup, "changing", 1, ctrl)


def _buffers(s, y):
    return [y[:, i * s["A"]:(i + 1) * s["A"], None] for i in range(N)]


def test_host_matches_the_jax_artifact(setup, changing):
    s = setup
    proc, y = changing
    theirs = JaxArtifact(s["jax_out"])
    A = s["A"]
    for i, (nb, gt, gs) in enumerate(ATTRIBUTES):
        theirs.host.set_attribute("nb_steps", nb)
        theirs.host.set_attribute("guidance_timbre", gt)
        theirs.host.set_attribute("guidance_structure", gs)
        sl = slice(i * A, (i + 1) * A)
        ref = theirs.call("forward", jnp.asarray(s["a"][:, sl, None]),
                          jnp.asarray(s["b"][:, sl, None]),
                          jnp.asarray(s["keys"][i]))
        np.testing.assert_allclose(_buffers(s, y)[i], np.asarray(ref),
                                   **CODEC_TOL, err_msg=f"buffer {i}")
    # every buffer ran the op's plain version from the C++ library
    calls = int(host_line(proc, "snake_conv plain-version calls on the "
                                "CPU: ").split()[0])
    assert calls > 0 and calls % N == 0


def test_host_matches_the_python_host(setup, changing):
    s = setup
    _, y = changing
    ours = ExportedStreamer(s["port_out"], "cpu")
    A = s["A"]
    for i, (nb, gt, gs) in enumerate(ATTRIBUTES):
        ours.set_attribute("nb_steps", nb)
        ours.set_attribute("guidance_timbre", gt)
        ours.set_attribute("guidance_structure", gs)
        sl = slice(i * A, (i + 1) * A)
        ref = ours.call("forward", s["a"][:, sl, None], s["b"][:, sl, None],
                        x0=s["x0"][i]).numpy()
        close(f"native host vs ExportedStreamer, buffer {i}",
              _buffers(s, y)[i], ref)


def test_ctrl_nb_steps_equals_the_command_line(setup):
    _, one = _play(setup, "cli1", 1)
    _, four = _play(setup, "cli4", 4)
    proc, ctrl = _play(setup, "ctrl4", 1, ctrl="nb_steps 4\n")
    assert "set nb_steps = 4" in proc.stderr.decode()
    close("ctrl nb_steps 4 vs command-line nb_steps 4", ctrl, four)
    assert np.abs(one - four).max() > 1e-2 * np.abs(four).max()


def test_host_needs_a_card_unless_told_cpu(setup):
    s = setup
    # no card visible to the host, on a machine with one too
    for flags in ([], ["--device", "cuda"]):
        proc = run_host([s["port_out"], "--pcm", *flags], device=None,
                        env={"CUDA_VISIBLE_DEVICES": ""}, check=False)
        assert proc.returncode != 0
        assert "no CUDA device" in proc.stderr.decode()
        assert not proc.stdout


def test_host_runs_without_python():
    ldd = subprocess.run(["ldd", str(native_host())], capture_output=True,
                         text=True, check=True).stdout
    assert "libtorch_cpu" in ldd and "libsnake_conv_op" in ldd
    assert "libpython" not in ldd
    # no usage without an artifact, and nothing of Python in its way
    proc = subprocess.run([str(native_host())], capture_output=True,
                          env={"PATH": os.environ.get("PATH", "")})
    assert proc.returncode == 1 and b"usage: stream_host" in proc.stderr
