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

A noise codec's decode program keeps the decoder's fixed NoiseGenerator
draw as a constant, which its package carries (tests/
test_torch_stream_host_noise*.py).  An artifact that shares a stage's
program with another (the same codec and encoders under another
denoiser) can take that stage's package from it (``share_from``).

Packaging needs the example inputs the program was traced with, which a
saved program does not keep: they are rebuilt as zeros of its placeholders'
shapes and dtypes, on the device packaged for.  Packaging takes minutes a
stage at full width (Inductor compiles the stage's kernels and a C++
wrapper; PERF.md gives the times).
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
# seconds a packaging waits for the artifact it shares stages with
# (``package_artifact(share_from=)``) to name its packages
SHARE_TIMEOUT = 3600.0


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


def same_program(a: str, b: str) -> bool:
    """Whether the stage programs saved at ``a`` and ``b`` are one program:
    the same graph over the same weights and constants (two exports of
    the same modules write the same graph; their files need not be
    byte-equal)."""
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() == fb.read():
            return True
    pa, pb = torch.export.load(a), torch.export.load(b)
    if (str(pa.graph) != str(pb.graph)
            or pa.graph_signature != pb.graph_signature):
        return False
    for da, db in ((pa.state_dict, pb.state_dict),
                   (pa.constants, pb.constants)):
        if set(da) != set(db) or not all(
                isinstance(da[k], torch.Tensor) == isinstance(db[k],
                                                              torch.Tensor)
                and (not isinstance(da[k], torch.Tensor)
                     or (da[k].dtype == db[k].dtype
                         and da[k].shape == db[k].shape
                         and torch.equal(da[k], db[k])))
                for k in da):
            return False
    return True


def _manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _shared(path: str, other: str, stages: Sequence[str]) -> List[str]:
    """The stages of ``stages`` whose programs are ``other``'s: those the
    artifact at ``path`` can take from ``other``'s packages."""
    return [s_ for s_ in stages if os.path.exists(
        os.path.join(other, f"{s_}.pt2")) and same_program(
            os.path.join(path, f"{s_}.pt2"), os.path.join(other, f"{s_}.pt2"))]


def _wait_for_packages(other: str, device: torch.device) -> dict:
    """``other``'s manifest once it names its packages for ``device``."""
    key = f"native_{device.type}"
    t0 = time.perf_counter()
    while True:
        manifest = _manifest(other)
        if key in manifest:
            return manifest
        if time.perf_counter() - t0 > SHARE_TIMEOUT:
            raise RuntimeError(f"{other} has no packages for {device.type} "
                               f"after {SHARE_TIMEOUT:.0f} s")
        time.sleep(1.0)


def package_artifact(path: str, device=None, share_from: str = None
                     ) -> Dict[str, dict]:
    """Packages the stages the native host runs (``HOST_STAGES``) of the
    artifact at ``path`` for ``device`` (the card unless "cpu") and names
    them in its manifest; returns, by stage, the seconds it took and the
    CPU-seconds it spent, and under "total" the CPU-seconds of the whole
    packaging, start-up included.  The stages are packaged one after the
    other by a process of their own (``python -m
    after_tpu_torch.streaming.native --stages``, ``_in_process``), which
    keeps Inductor's settings out of the caller's process.

    With ``share_from``, another artifact, a stage whose program is that
    artifact's (``same_program``: the same codec or encoders, say) is not
    compiled again: its package is copied once that artifact names its
    packages for ``device`` (waited for up to SHARE_TIMEOUT s)."""
    import shutil

    device = resolve_device(device)
    mpath = os.path.join(path, "manifest.json")
    stages = list(HOST_STAGES[artifact_kind(_manifest(path))])
    files = [f"native/{device.type}/{stage}.pt2" for stage in stages]
    shared = _shared(path, share_from, stages) if share_from else []
    done = _in_process(path, device, [s_ for s_ in stages
                                      if s_ not in shared])
    if shared:
        other = _wait_for_packages(share_from, device)
        for stage in shared:
            k = other["native_stages"].index(stage)
            dest = os.path.join(path, files[stages.index(stage)])
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            shutil.copyfile(os.path.join(
                share_from, other[f"native_{device.type}"][k]), dest)
            done[stage] = {"writes": other["native_writes"][k],
                           "seconds": 0.0, "cpu_seconds": 0.0,
                           "shared_from": share_from}
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
    return {stage: {k: v for k, v in done[stage].items() if k != "writes"}
            for stage in [*stages, "total"]}


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


def _package_stages(path: str, device: torch.device, stages: Sequence[str]
                    ) -> None:
    """Packages ``stages`` of the artifact at ``path`` one after the other
    in this process, printing a JSON record a stage: the leaves it writes,
    its seconds and its CPU-seconds (this process's and the compilers'
    it waited for)."""
    import resource

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

    def cpu():
        return sum(r.ru_utime + r.ru_stime for r in (
            resource.getrusage(resource.RUSAGE_SELF),
            resource.getrusage(resource.RUSAGE_CHILDREN)))
    for stage in stages:
        t0, c0 = time.perf_counter(), cpu()
        writes = package_stage(os.path.join(path, f"{stage}.pt2"),
                               os.path.join(path, "native", device.type,
                                            f"{stage}.pt2"),
                               device, stateful=stage not in STATELESS)
        print(json.dumps({"stage": stage, "writes": writes,
                          "seconds": time.perf_counter() - t0,
                          "cpu_seconds": cpu() - c0}), flush=True)


def _in_process(path: str, device: torch.device, stages: Sequence[str]
                ) -> Dict[str, dict]:
    """The stages packaged one after the other by one process of their own,
    which dies with this one (``die_with_parent``) and compiles its kernels
    itself (no pool of compile workers).  One process an artifact, not one
    a stage: the stages share its start-up and what Inductor compiled for
    the stages before (the codec's kernels of the structure, timbre and
    decode stages), and the artifacts packaged at once keep the cores busy.
    Returns each stage's record, and under "total" the process's
    CPU-seconds from start-up to exit."""
    import subprocess
    import sys
    import tempfile
    if not stages:
        return {"total": {"cpu_seconds": 0.0}}
    env = dict(os.environ, TORCHINDUCTOR_COMPILE_THREADS=os.environ.get(
        "TORCHINDUCTOR_COMPILE_THREADS", "1"))
    env[PARENT_ENV] = str(os.getpid())
    # the output goes to files, never to a pipe: a pipe that this process
    # does not read while it waits would fill and stop the writer
    with tempfile.TemporaryFile("w+") as out, \
            tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "after_tpu_torch.streaming.native",
             os.path.abspath(path), "--device", str(device), "--stages",
             ",".join(stages)],
            stdout=out, stderr=err, text=True, cwd=_ROOT, env=env)
        # its CPU time with that of every process it waited for (the
        # compilers it started), as the kernel counts them at its exit
        _, status, usage = os.wait4(proc.pid, 0)
        proc.returncode = os.waitstatus_to_exitcode(status)
        out.seek(0)
        err.seek(0)
        text, errors = out.read(), err.read()
    if proc.returncode != 0:
        raise RuntimeError(
            f"packaging {path} stages {', '.join(stages)} failed "
            f"({exit_reason(proc.returncode)}):\n{errors[-4000:]}"
            f"\n{text[-1000:]}")
    records = [json.loads(line) for line in text.splitlines()
               if line.startswith('{"stage"')]
    done = {r.pop("stage"): r for r in records}
    done["total"] = {"cpu_seconds": usage.ru_utime + usage.ru_stime}
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
    p.add_argument("--stages", default=None,
                   help="package these stages (comma-separated) in this "
                        "process and print a JSON record a stage (the "
                        "manifest is left to the caller)")
    p.add_argument("--share_from", default=None,
                   help="another artifact: take its packages of the stages "
                        "whose programs are its own, once it has them")
    args = p.parse_args(argv)
    die_with_parent()
    device = resolve_device(args.device)
    if args.stages is not None:
        _package_stages(args.path, device, args.stages.split(","))
        return 0
    print(json.dumps(package_artifact(args.path, device, args.share_from)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
