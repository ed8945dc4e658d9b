"""Build the port's CUDA sources with nvcc and load them with ctypes; build
the native streaming host (``native_host``).

Each source under ``after_tpu_torch/csrc`` has a plain C interface and is
compiled on first use into its own shared library in
``build/after_tpu_torch_kernels/`` beside the package (``.gitignore`` lists
``build/``).  The library's name carries a hash of the source, the headers
beside it (``*.cuh``) and the flags, so an edited source or header is
rebuilt and a stale library is never loaded.

Nothing here runs at import time: a CPU-only installation without ``nvcc``
imports every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "after_tpu_torch_kernels"

# no --use_fast_math: sinf keeps its f32 accuracy
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit on the machine with the card")


def _headers() -> bytes:
    """The bytes of the headers the sources include (csrc/*.cuh)."""
    return b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))


def _target(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha1(src.read_bytes() + _headers()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def _compile(source: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is None:
            out = _target(source)
            if not out.exists():
                _compile(source, out)
            lib = ctypes.CDLL(str(out))
            _LOADED[source] = lib
        return lib


def load_all(*sources: str):
    """The loaded libraries of several sources, those not yet built compiled
    at once (an nvcc each)."""
    with _LOCK:
        missing = [s for s in sources
                   if s not in _LOADED and not _target(s).exists()]
        if missing:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmps = {s: _target(s).with_suffix(f".{os.getpid()}.tmp")
                    for s in missing}
            _wait(_start(*[[_nvcc(), *NVCC_FLAGS, "-o", str(tmps[s]),
                            str(CSRC / s)] for s in missing]))
            for s in missing:
                os.replace(tmps[s], _target(s))
    return [load(s) for s in sources]


# ---------------------------------------------------------------------------
# the native streaming host: the op library (csrc/snake_conv_op.cc, the op
# after_tpu_torch::snake_conv registered from C++) and the host program
# (csrc/stream_host.cc), built with the C++ compiler against libtorch, with
# the flags torch.utils.cpp_extension gives; with CUDA (and linked to the
# kernel's library) where nvcc is present, for the CPU alone elsewhere
# ---------------------------------------------------------------------------

NATIVE_SOURCES = ("snake_conv_op.cc", "stream_host.cc")
SOURCE_CU = "fused_snake_conv.cu"       # the kernel the op launches


def _cxx() -> str:
    return os.environ.get("CXX") or shutil.which("g++") or "c++"


def _has_nvcc() -> bool:
    try:
        _nvcc()
    except RuntimeError:
        return False
    return True


def _torch_paths(fn, cuda: bool):
    try:
        return fn(device_type="cuda" if cuda else "cpu")
    except TypeError:                       # torch before 2.7
        return fn(cuda=cuda)


def native_flags(cuda: bool):
    """(compile flags, link flags) of a C++ source against this libtorch."""
    import torch
    from torch.utils import cpp_extension

    abi = int(torch.compiled_with_cxx11_abi())
    cflags = ["-std=c++20", "-O2", "-fPIC", f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
              "-Wno-deprecated-declarations"]
    cflags += [f"-I{p}" for p in _torch_paths(cpp_extension.include_paths,
                                              cuda)]
    libdirs = _torch_paths(cpp_extension.library_paths, cuda)
    ldflags = ["-Wl,--no-as-needed"]
    for d in libdirs:
        ldflags += [f"-L{d}", f"-Wl,-rpath,{d}"]
    ldflags += ["-ltorch", "-ltorch_cpu", "-lc10"]
    if cuda:
        cflags.append("-DAFTER_TPU_TORCH_CUDA")
        ldflags += ["-ltorch_cuda", "-lc10_cuda", "-lcudart"]
    return cflags, ldflags


def _wait(procs) -> None:
    """Waits for the started compiles; raises with a failure's output."""
    for cmd, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed (exit {proc.returncode}) on "
                               f"{' '.join(cmd)}:\n{out}")


def _start(*cmds):
    return [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
            for cmd in cmds]


def native_host() -> Path:
    """The native streaming host's executable, built first if needed, with
    CUDA where nvcc is present; the op library it links is built beside
    it.  One process builds at a time (a lock file in the build
    directory); the others wait and find the result."""
    import fcntl

    import torch

    cuda = _has_nvcc()
    cflags, ldflags = native_flags(cuda)
    h = hashlib.sha1(" ".join(cflags + ldflags + [torch.__version__,
                                                  _cxx()]).encode())
    for src in NATIVE_SOURCES + ((SOURCE_CU,) if cuda else ()):
        h.update((CSRC / src).read_bytes())
    if cuda:
        h.update(_headers())
    digest = h.hexdigest()[:12]
    op_lib = BUILD_DIR / f"libsnake_conv_op_{digest}.so"
    host = BUILD_DIR / f"stream_host_{digest}"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if host.exists():
            return host
        objs = {src: BUILD_DIR / f"{Path(src).stem}_{digest}.{os.getpid()}.o"
                for src in NATIVE_SOURCES}
        compiles = _start(*[[_cxx(), *cflags, "-c", str(CSRC / src), "-o",
                             str(o)] for src, o in objs.items()])
        kernel = []
        if cuda:     # the kernel's library, built by nvcc meanwhile
            kernel = [str(_target(SOURCE_CU))]
            if not _target(SOURCE_CU).exists():
                _compile(SOURCE_CU, _target(SOURCE_CU))
        _wait(compiles)
        tmp_lib = op_lib.with_suffix(f".{os.getpid()}.tmp")
        _wait(_start([_cxx(), "-shared", "-o", str(tmp_lib),
                      str(objs["snake_conv_op.cc"]), *kernel, *ldflags]))
        os.replace(tmp_lib, op_lib)
        tmp_host = host.with_suffix(f".{os.getpid()}.tmp")
        _wait(_start([_cxx(), "-o", str(tmp_host), str(objs["stream_host.cc"]),
                      str(op_lib), *ldflags]))
        os.replace(tmp_host, host)
        for o in objs.values():
            o.unlink()
        return host
