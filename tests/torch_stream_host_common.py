"""What the native streaming host's CPU tests share: the host built once
for the CPU (``ops.kernels.build.native_host``), its runs as a subprocess,
f32 WAV files, an artifact packaged for the CPU, and the Python host's
buffers to hold it to."""

import json
import os
import struct
import subprocess

import numpy as np

from after_tpu_torch.ops.kernels.build import native_host
from after_tpu_torch.streaming.native import package_artifact
from tests import torch_threads_common  # noqa: F401  (xdist workers' threads)

# the native host against the port's Python host on the same packages'
# programs: the same ops, fused and ordered otherwise by Inductor, so the
# two part by f32 rounding (about 1e-6 x max|y| over 8 buffers)
HOST_TOL = 1e-5          # max abs difference <= HOST_TOL * max |y|
# EDM's streamed Euler step starts from the unit noise scaled by sigma_max
# (80): its first step takes x (80 x |x0|) to about D by x + (s_1 - s_0) d,
# so one ulp of x there (1.5e-5 at 240), where Inductor's generated code
# (-funsafe-math-optimizations on the CPU) rounds otherwise than the
# program run op by op, stands 2e-5 x max|y| in the output
EDM_HOST_TOL = 1e-4


def write_wav(path, x, sr=44100):
    """A mono 32-bit float WAV of ``x``."""
    data = np.asarray(x, "<f4").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
                + struct.pack("<IHHIIHH", 16, 3, 1, sr, sr * 4, 4, 32)
                + b"data" + struct.pack("<I", len(data)) + data)


def read_wav(path):
    """The samples of a 32-bit float WAV the host wrote."""
    with open(path, "rb") as f:
        raw = f.read()
    assert raw[:4] == b"RIFF" and struct.unpack("<H", raw[20:22])[0] == 3
    return np.frombuffer(raw[44:], "<f4")


def packaged(path):
    """The artifact at ``path`` packaged for the CPU (its manifest)."""
    package_artifact(path, "cpu")
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def run_host(args, env=None, stdin=None, device="cpu", check=True):
    """The host on ``args`` (its positional arguments and flags), on
    ``device`` unless None; returns the finished process."""
    cmd = [str(native_host()), *map(str, args)]
    if device is not None:
        cmd += ["--device", device]
    proc = subprocess.run(cmd, input=stdin, capture_output=True,
                          env=dict(os.environ, **(env or {})), timeout=600)
    if check:
        assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    return proc


def host_line(proc, prefix):
    """The rest of the host's stderr line that starts with ``prefix``."""
    for line in proc.stderr.decode().splitlines():
        if line.startswith("[stream_host] " + prefix):
            return line[len("[stream_host] " + prefix):]
    raise AssertionError(f"no '{prefix}' line in:\n{proc.stderr.decode()}")


def close(label, y, ref, tol=HOST_TOL):
    err = float(np.abs(y - ref).max())
    scale = float(np.abs(ref).max())
    print(f"{label}: max abs difference {err:.3e} ({err / scale:.3e} x "
          f"max|y|; limit {tol})")
    assert y.shape == ref.shape and err <= tol * scale, label


# buffers of an a2a artifact's host run, and the attributes that change
# buffer by buffer in its changing run (nb_steps up to the micro config's
# 16 slots, a structure guidance below the mix's 0.01 floor among them)
N_BUFFERS = 6
CHANGING = [(1, 1.7, 0.3), (4, 2.0, 1.5), (2, 1.0, 1.0), (16, 1.2, 0.8),
            (3, 2.0, 0.005), (1, 3.0, 0.0)]


def a2a_setup(cfg, root, seed=3):
    """The crossfade streamer of ``cfg`` (a pipeline from ``seed``)
    exported under ``root`` at nb_steps 2 and packaged for the CPU, with
    N_BUFFERS buffers of inputs and noise written beside it for the host."""
    from after_tpu_torch.diffusion.pipeline import TransferPipeline
    from after_tpu_torch.streaming.export import export_streamer
    from after_tpu_torch.streaming.streamer import Streamer

    pipe = TransferPipeline(cfg, device="cpu").init(seed)
    streamer = Streamer(cfg, chunk_size=4, device="cpu", pipeline=pipe)
    art = export_streamer(streamer, str(root / "art"), nb_steps=2)
    manifest = packaged(art)
    A, C = streamer.audio_chunk, cfg.denoiser.n_channels
    rng = np.random.RandomState(seed + 10)
    a, b = ((0.3 * rng.randn(N_BUFFERS * A)).astype(np.float32)
            for _ in range(2))
    x0 = rng.randn(N_BUFFERS, 1, 4, C).astype(np.float32)
    write_wav(root / "s.wav", a)
    write_wav(root / "t.wav", b)
    x0.tofile(root / "x0.f32")
    return dict(art=art, manifest=manifest, root=root, a=a, b=b, x0=x0, A=A)


def play_native(s, out, nb_steps=1, guidance_timbre=1.0,
                guidance_structure=1.0, attributes=None):
    """The host over the setup's buffers at fixed attributes, or with
    ``attributes`` [(nb_steps, guidance_timbre, guidance_structure)] set
    buffer by buffer through AFTER_NATIVE_CTRL; (process, output)."""
    root, env = s["root"], None
    if attributes is not None:
        ctrl = root / f"{out}.ctrl"
        ctrl.write_text("".join(
            f"@{i} nb_steps {nb}\n@{i} guidance_timbre {gt}\n"
            f"@{i} guidance_structure {gs}\n"
            for i, (nb, gt, gs) in enumerate(attributes)))
        env = {"AFTER_NATIVE_CTRL": str(ctrl)}
    proc = run_host([s["art"], root / "s.wav", root / "t.wav",
                     root / f"{out}.wav", N_BUFFERS, nb_steps,
                     guidance_timbre, guidance_structure,
                     "--x0", root / "x0.f32"], env=env)
    return proc, read_wav(root / f"{out}.wav")


def play_python(s, attributes):
    """The Python host (``ExportedStreamer`` on the CPU) over the same
    buffers with ``attributes`` set buffer by buffer."""
    from after_tpu_torch.streaming.export import ExportedStreamer

    host = ExportedStreamer(s["art"], "cpu")
    A, ys = s["A"], []
    for i, (nb, gt, gs) in enumerate(attributes):
        host.set_attribute("nb_steps", nb)
        host.set_attribute("guidance_timbre", gt)
        host.set_attribute("guidance_structure", gs)
        sl = slice(i * A, (i + 1) * A)
        ys.append(host.call("forward", s["a"][None, sl, None],
                            s["b"][None, sl, None], x0=s["x0"][i])
                  .numpy().ravel())
    return np.concatenate(ys)


def check_a2a(s, label, tol=HOST_TOL, **kw):
    """The host against the Python host within ``tol`` x max|y|, at fixed
    attributes (``kw`` of ``play_native``) or changing ones; returns the
    host's process."""
    attributes = kw.get("attributes") or [
        (kw.get("nb_steps", 1), kw.get("guidance_timbre", 1.0),
         kw.get("guidance_structure", 1.0))] * N_BUFFERS
    proc, y = play_native(s, label.replace(" ", "_"), **kw)
    assert host_line(proc, "streaming ").startswith(f"{N_BUFFERS} chunks")
    close(f"{label}: native host vs ExportedStreamer, {N_BUFFERS} buffers",
          y, play_python(s, attributes), tol)
    calls = int(host_line(proc, "snake_conv plain-version calls on the "
                                "CPU: ").split()[0])
    assert calls > 0 and calls % N_BUFFERS == 0
    return proc
