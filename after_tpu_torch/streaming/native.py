"""AOTInductor packages of an artifact's stages, for the native streaming
host (csrc/stream_host.cc), which plays them in a process without Python.

``package_artifact(path, device)`` compiles each stage program the host runs
(``<stage>.pt2``) with ``torch._inductor.aoti_compile_and_package`` into
``native/<device>/<stage>.pt2`` and names them in the manifest:

    "native_stages": ["structure", "timbre", "step", "decode"],
    "native_writes": [[...], ...],     state leaves each stage writes
    "native_cuda": ["native/cuda/structure.pt2", ...]   (or "native_cpu")

A package is compiled for one device, so an artifact played on the card and
on the CPU carries both.  The Python hosts ignore the packages.

A stage is packaged in a pure form: (state leaves, inputs) -> (output, new
values of the leaves it writes), the host copying those back into its
state.  The stage programs themselves write the state in place, and
AOTInductor miscompiles that: in the crossfade decode program it read a
GroupNorm pad leaf that the program also writes with the strides of the
value written into it (the conv output, channels first), not its own, and
the package's output stood 0.41 from the program's on its first call (on
the CPU, torch 2.13).  In the pure form no input is written, and the
package matches the program within rounding.

Packaging needs the example inputs the program was traced with, which a
saved program does not keep: they are rebuilt as zeros of its placeholders'
shapes and dtypes, on the device packaged for.  Packaging takes minutes a
stage at full width (Inductor compiles the stage's kernels and a C++
wrapper; PERF.md gives the times), so the stages are packaged at once.
"""

from __future__ import annotations

import fcntl
import json
import os
import time
from typing import Dict, List, Sequence

import torch
from torch import nn

from ..ops.kernels import fused_conv  # noqa: F401  registers the op
from ..utils.device import resolve_device, strict_f32

# the stages the host runs, by kind of artifact
HOST_STAGES = {"a2a": ("structure", "timbre", "step", "decode"),
               "midi": ("piano_roll", "timbre", "step", "decode"),
               "codec": ("forward",)}
STATELESS = ("piano_roll",)
# the directory that holds the package, for the packaging processes
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the pid of the process that started this one, where it asks this one to
# die with it (``die_with_parent``)
PARENT_ENV = "AFTER_NATIVE_PARENT"


def artifact_kind(manifest: dict) -> str:
    if manifest.get("codec_only"):
        return "codec"
    return "midi" if manifest.get("n_poly") else "a2a"


class _Pure(nn.Module):
    """A stage program without input mutation: runs ``program`` on clones of
    the state's leaves and returns (output, the clones of ``writes``)."""

    def __init__(self, program: nn.Module, writes: Sequence[int]):
        super().__init__()
        self.program = program
        self.writes = list(writes)

    def forward(self, state: List[torch.Tensor], *inputs: torch.Tensor):
        state = [t.clone() for t in state]
        y = self.program(state, *inputs)
        return (y, *[state[i] for i in self.writes])


def _exported(path: str, device: torch.device):
    """The saved program on ``device`` (moved there if traced elsewhere)."""
    from torch.export.passes import move_to_device_pass
    program = torch.export.load(path)
    tensors = [*program.state_dict.values(), *program.constants.values()]
    if any(isinstance(t, torch.Tensor) and t.device != device
           for t in tensors):
        program = move_to_device_pass(program, device)
    return program


def _example_inputs(program, device: torch.device):
    """Zeros of the program's user inputs, in its (args, kwargs) form."""
    from torch.export.graph_signature import InputKind
    meta = {n.name: n.meta["val"] for n in program.graph.nodes
            if n.op == "placeholder"}
    flat = [torch.zeros(meta[s.arg.name].shape, dtype=meta[s.arg.name].dtype,
                        device=device)
            for s in program.graph_signature.input_specs
            if s.kind == InputKind.USER_INPUT]
    return torch.utils._pytree.tree_unflatten(flat, program.call_spec.in_spec)


def written_leaves(program) -> List[int]:
    """Indices of the state leaves (the program's first user inputs) that
    the program writes, from its functional form's input mutations."""
    from torch.export.graph_signature import InputKind, OutputKind
    functional = program.run_decompositions({})
    sig = functional.graph_signature
    user = [s.arg.name for s in sig.input_specs
            if s.kind == InputKind.USER_INPUT]
    return sorted(user.index(s.target) for s in sig.output_specs
                  if s.kind == OutputKind.USER_INPUT_MUTATION)


def package_stage(program_path: str, package_path: str,
                  device: torch.device, stateful: bool = True) -> List[int]:
    """Compiles the stage program at ``program_path`` for ``device`` into an
    AOTInductor package at ``package_path``; returns the leaves it writes."""
    program = _exported(program_path, device)
    args, kwargs = _example_inputs(program, device)
    module = program.module()
    writes = written_leaves(program) if stateful else []
    with torch.no_grad():
        pure = torch.export.export(
            _Pure(module, writes) if stateful else module, args, kwargs)
    pure = pure.run_decompositions({})
    pure.example_inputs = (args, kwargs)
    os.makedirs(os.path.dirname(package_path), exist_ok=True)
    torch._inductor.aoti_compile_and_package(pure, package_path=package_path)
    return writes


def package_artifact(path: str, device=None) -> Dict[str, float]:
    """Packages the stages the native host runs (``HOST_STAGES``) of the
    artifact at ``path`` for ``device`` (the card unless "cpu") and names
    them in its manifest; returns the seconds each stage took.  Every stage
    is packaged at once, each by a process of its own
    (``python -m after_tpu_torch.streaming.native --stage``), which keeps
    Inductor's settings out of the caller's process."""
    device = resolve_device(device)
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    cfg = manifest.get("config", {})
    if cfg.get("autoencoder", cfg).get("use_noise"):
        raise ValueError(
            "the native host does not play a noise codec's artifact yet "
            "(autoencoder.use_noise): play it with the Python host "
            "(streaming.export.ExportedStreamer / ExportedCodec)")
    stages = list(HOST_STAGES[artifact_kind(manifest)])
    files = [f"native/{device.type}/{stage}.pt2" for stage in stages]
    done = _in_processes(path, device, stages)
    # read again and written under a lock: the packages of another device
    # may be named in it meanwhile
    with open(mpath, "r+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        manifest = json.load(f)
        manifest["native_stages"] = stages
        manifest["native_writes"] = [done[s_]["writes"] for s_ in stages]
        manifest[f"native_{device.type}"] = files
        f.seek(0)
        json.dump(manifest, f, indent=2)
        f.truncate()
    return {stage: done[stage]["seconds"] for stage in stages}


def _links_openmp(cxx: str) -> bool:
    import subprocess
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [cxx, "-fopenmp", "-x", "c++", "-", "-o",
             os.path.join(tmp, "a.out")], input="int main() { return 0; }",
            capture_output=True, text=True)
    return proc.returncode == 0


def _inductor_cxx() -> None:
    """Inductor compiles and links a package with -fopenmp, which a g++
    installed without its libgomp (no libgomp.spec) cannot link.  There
    Inductor is handed a wrapper of that g++ (``build/native_cxx/g++``) that
    adds a directory holding the spec and a link to torch's own libgomp."""
    import glob
    import shutil
    from torch._inductor import config
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None or _links_openmp(cxx):
        return
    gomp = sorted(glob.glob(os.path.join(os.path.dirname(torch.__file__),
                                         "lib", "libgomp*.so*")))
    if not gomp:
        raise RuntimeError(f"{cxx} cannot link -fopenmp and torch carries "
                           "no libgomp: AOTInductor cannot link a package")
    d = os.path.join(_ROOT, "build", "native_cxx")
    os.makedirs(d, exist_ok=True)
    # each file made under a name of this process's, then moved into place:
    # several packaging processes may get here at once
    tmp = f".{os.getpid()}.tmp"
    with open(os.path.join(d, "libgomp.spec" + tmp), "w") as f:
        f.write("*link_gomp: -lgomp %{static: -ldl }\n")
    os.replace(os.path.join(d, "libgomp.spec" + tmp),
               os.path.join(d, "libgomp.spec"))
    os.symlink(gomp[0], os.path.join(d, "libgomp.so" + tmp))
    os.replace(os.path.join(d, "libgomp.so" + tmp),
               os.path.join(d, "libgomp.so"))
    wrapper = os.path.join(d, "g++")
    with open(wrapper + tmp, "w") as f:
        f.write(f'#!/bin/sh\nexec "{cxx}" -B"{d}/" -L"{d}" "$@"\n')
    os.chmod(wrapper + tmp, 0o755)
    os.replace(wrapper + tmp, wrapper)
    if not _links_openmp(wrapper):
        raise RuntimeError(f"{cxx} cannot link -fopenmp, even with "
                           f"{gomp[0]}: AOTInductor cannot link a package")
    config.cpp.cxx = (None, wrapper)


def _package_one(path: str, device: torch.device, stage: str) -> dict:
    from torch._inductor import config
    _inductor_cxx()
    # compile time: the large C++ wrapper (it only calls the kernels)
    # unoptimised, on either device
    config.aot_inductor.compile_wrapper_opt_level = "O0"
    if device.type == "cuda":
        strict_f32()
        # and one Triton config a pointwise kernel (no benchmarking of
        # several), the kernels tuned while the C++ wrapper is generated
        # (one code generation pass, not a Python wrapper's first)
        config.triton.autotune_pointwise = False
        config.triton.autotune_at_compile_time = True
    t0 = time.perf_counter()
    writes = package_stage(os.path.join(path, f"{stage}.pt2"),
                           os.path.join(path, "native", device.type,
                                        f"{stage}.pt2"),
                           device, stateful=stage not in STATELESS)
    return {"writes": writes, "seconds": time.perf_counter() - t0}


def _in_processes(path: str, device: torch.device, stages: Sequence[str]
                  ) -> Dict[str, dict]:
    """Each stage packaged by a process of its own, all at once, each dying
    with this process (``die_with_parent``).  A stage compiles its kernels
    in its own process (no pool of compile workers, which cost a stage
    more CPU time than they save it wall time when stages run at once)."""
    import subprocess
    import sys
    import tempfile
    env = dict(os.environ, TORCHINDUCTOR_COMPILE_THREADS=os.environ.get(
        "TORCHINDUCTOR_COMPILE_THREADS", "1"))
    env[PARENT_ENV] = str(os.getpid())
    # each stage's output goes to files of its own, never to a pipe: a
    # pipe that this process does not read while it waits on another stage
    # would fill and stop the stage writing to it
    logs = {stage: (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for stage in stages}
    procs = {stage: subprocess.Popen(
        [sys.executable, "-m", "after_tpu_torch.streaming.native",
         os.path.abspath(path), "--device", str(device), "--stage", stage],
        stdout=logs[stage][0], stderr=logs[stage][1], text=True, cwd=_ROOT,
        env=env) for stage in stages}

    def read(f):
        f.seek(0)
        return f.read()
    done = {}
    try:
        for stage, proc in procs.items():
            proc.wait()
            out, err = (read(f) for f in logs[stage])
            if proc.returncode != 0:
                for other in procs.values():
                    other.kill()
                    other.wait()
                raise RuntimeError(
                    f"packaging {path} stage {stage} failed "
                    f"({exit_reason(proc.returncode)}):\n{err[-4000:]}"
                    f"\n{out[-1000:]}")
            done[stage] = json.loads(out.strip().splitlines()[-1])
    finally:
        for f in (f for pair in logs.values() for f in pair):
            f.close()
    return done


def exit_reason(returncode: int) -> str:
    """A process's exit code in words: "exit N", or the signal that killed
    it (a negative ``Popen.returncode``)."""
    import signal
    if returncode >= 0:
        return f"exit {returncode}"
    try:
        name = signal.Signals(-returncode).name
    except ValueError:
        name = f"signal {-returncode}"
    return f"killed by {name}"


def die_with_parent() -> None:
    """Where the process that started this one named itself in
    ``AFTER_NATIVE_PARENT`` (Linux): this process is killed when that one
    dies (PR_SET_PDEATHSIG), however it dies, so that a killed packaging
    leaves no compile running; it exits at once if that one is already
    gone."""
    import ctypes
    import sys
    parent = os.environ.get(PARENT_ENV)
    if parent is None or not sys.platform.startswith("linux"):
        return
    ctypes.CDLL(None, use_errno=True).prctl(1, 9)    # PDEATHSIG, SIGKILL
    if os.getppid() != int(parent):
        # said on stderr: a bare exit code would not tell this from a crash
        sys.stderr.write(f"after_tpu_torch.streaming.native: the process "
                         f"that started this one ({parent}) is gone (parent "
                         f"now {os.getppid()}); exiting\n")
        sys.stderr.flush()
        os._exit(1)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m after_tpu_torch.streaming.native",
        description="Package an artifact's stages for the native host.")
    p.add_argument("path", help="the artifact's directory")
    p.add_argument("--device", default=None,
                   help="'cuda' (default, the card) or 'cpu'")
    p.add_argument("--stage", default=None,
                   help="package this one stage and print its JSON record "
                        "(the manifest is left to the caller)")
    args = p.parse_args(argv)
    die_with_parent()
    device = resolve_device(args.device)
    if args.stage is not None:
        print(json.dumps(_package_one(args.path, device, args.stage)))
        return 0
    seconds = package_artifact(args.path, device)
    print(json.dumps(seconds))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
