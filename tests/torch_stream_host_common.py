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
