"""What one stage's AOTInductor packaging (``streaming/native.py``) costs in
CPU time under a few settings of the packaging process: the base
config's ``structure`` stage for the card, packaged by three processes at
once (one a setting, each with its own Inductor and Triton caches), each
with its wall seconds, the CPU seconds of the process and its children,
and the cubins it compiled.  The settings: two compile worker processes
(``TORCHINDUCTOR_COMPILE_THREADS=2``, the earlier default), the same with
``torch.use_deterministic_algorithms`` (one config a reduction), and one
compile thread (no worker pool).  On the card's machine (needs the card
to trace and package for it), about 6 minutes with the kernels' build:

    python3 scripts/torch_native_package_cpu.py
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ART = "build/package_cpu_art"
# name: (environment, deterministic algorithms)
SETTINGS = {
    "two_threads": ({"TORCHINDUCTOR_COMPILE_THREADS": "2"}, False),
    "two_threads_deterministic": ({"TORCHINDUCTOR_COMPILE_THREADS": "2"},
                                  True),
    "one_thread": ({"TORCHINDUCTOR_COMPILE_THREADS": "1"}, False),
}
CHILD = ("import sys, torch\n"
         "if sys.argv[1] == '1':\n"
         "    torch.use_deterministic_algorithms(True, warn_only=True)\n"
         "from after_tpu_torch.streaming.native import main\n"
         "sys.exit(main(sys.argv[2:]))")


def main() -> int:
    import torch
    from after_tpu_torch import TransferPipeline, get_config
    from after_tpu_torch.ops.kernels.build import load_all
    from after_tpu_torch.ops.kernels.fused_conv import BACKWARD_SOURCE, SOURCE
    from after_tpu_torch.streaming import Streamer
    from after_tpu_torch.streaming.export import export_streamer
    from after_tpu_torch.utils.device import strict_f32

    t0 = time.perf_counter()
    load_all(SOURCE, BACKWARD_SOURCE)
    strict_f32()
    cfg = get_config("base")
    cfg = cfg.resolved(in_size=cfg.autoencoder.z_channels,
                       n_signal=524288 // cfg.autoencoder.ratio)
    pipe = TransferPipeline(cfg, device="cuda").init(0)
    export_streamer(Streamer(cfg, 4, 4, pipeline=pipe), ART, nb_steps=4)
    del pipe
    torch.cuda.empty_cache()
    print(f"torch {torch.__version__}; set-up {time.perf_counter() - t0:.1f}"
          " s", flush=True)
    procs = {}
    for name, (extra, deterministic) in SETTINGS.items():
        cache = os.path.abspath(f"build/package_cpu_cache/{name}")
        env = dict(os.environ, TORCHINDUCTOR_CACHE_DIR=cache,
                   TRITON_CACHE_DIR=os.path.join(cache, "triton"), **extra)
        proc = subprocess.Popen(
            [sys.executable, "-c", CHILD, "1" if deterministic else "0",
             ART, "--device", "cuda", "--stage", "structure"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs[proc.pid] = (name, proc, time.perf_counter(), cache)
    while procs:
        # the child's resource use, its waited-for children's included
        pid, status, use = os.wait4(-1, 0)
        if pid not in procs:
            continue
        name, proc, t, cache = procs.pop(pid)
        proc.returncode = os.waitstatus_to_exitcode(status)
        out, err = proc.stdout.read(), proc.stderr.read()
        cubins = sum(1 for _, _, files in os.walk(cache) for f in files
                     if f.endswith(".cubin"))
        print(f"{name}: exit {proc.returncode}, wall "
              f"{time.perf_counter() - t:.1f} s, CPU user {use.ru_utime:.1f}"
              f" s and system {use.ru_stime:.1f} s, {cubins} cubins; "
              f"{out.strip()[-200:]}"
              + (f"\n{err[-1500:]}" if proc.returncode else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
