"""What ``chip_smoke.py`` phase 15's AOTInductor packages cost: the
CPU-seconds of each package job with every process it started (as the
kernel counts them when the job is reaped, ``os.wait4``) and, where the
packager reports them, each stage's seconds and CPU-seconds, for two sets
of artifacts exported from the same random base runs (seed 0) and
packaged one set after the other, each set's jobs at once as phase 15
starts them, each set with Inductor's and Triton's caches empty:

- "before": the set phase 15 packaged until it played the alternatives
  (the main artifact, the two-voice one at full depth for the card and
  the CPU, the codec artifact), packaged by another checkout's
  ``streaming/native.py`` (``--parent DIR``, a parent unpacked with ``git
  archive``; without it this checkout's);
- "after": ``chip_smoke.export_artifacts``'s set (the main artifact, the
  two-voice one at NATIVE_CUT's depth for the card and the CPU, the codec
  artifact, EDM sharing the main artifact's structure, timbre and decode,
  v1 at the cut depth, the cut noise codec's artifact), packaged by this
  checkout.

On the card's machine (needs the card to export and package for it; about
25 minutes):

    python3 scripts/torch_native_package_budget.py [--parent DIR]
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from after_tpu_torch import TransferPipeline, get_config  # noqa: E402
from after_tpu_torch.cli.main import main as cli_main  # noqa: E402
from after_tpu_torch.config import ae_to_json, to_json  # noqa: E402
from after_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402


def save_runs(pipe, cfg) -> None:
    """The base runs where phase 12 leaves them under cs.CLI_DIR."""
    runs = os.path.join(cs.CLI_DIR, "runs")
    save_checkpoint(os.path.join(runs, "diff"), 0, {
        "variables": {k: m.state_dict() for k, m in (
            ("net", pipe.rf.net), ("encoder", pipe.rf.encoder),
            ("encoder_time", pipe.rf.encoder_time),
            ("classifier", pipe.rf.classifier)) if m is not None},
        "ema_params": {n: p.detach() for n, p in
                       pipe.rf.net.named_parameters()}, "step": 0},
        config_json=to_json(cfg))
    save_checkpoint(os.path.join(runs, "ae"), 0,
                    {"codec_vars": pipe.codec.state_dict()},
                    config_json=ae_to_json(cfg.autoencoder))


def export_before(on_export) -> None:
    """The set of artifacts phase 15 packaged before the alternatives."""
    runs = os.path.join(cs.CLI_DIR, "runs")
    diff, ae = os.path.join(runs, "diff"), os.path.join(runs, "ae")
    art2 = os.path.join(cs.CLI_DIR, "after.audio.diff.voices2")
    export = ["export", "--model_path", diff, "--emb_model_path", ae,
              "--chunk_size", str(cs.CHUNK), "--nb_steps",
              str(cs.EXPORT_STEPS), "--device", "cuda"]
    for path, argv in (
            (os.path.join(diff, "after.audio.diff"), export),
            (art2, export + ["--batch_size", "2", "--out", art2]),
            (os.path.join(ae, "codec_export"),
             ["export_autoencoder", "--model_path", ae, "--chunk_size",
              str(cs.CHUNK), "--device", "cuda"])):
        if cli_main(argv) != 0:
            cs.fail(f"{argv[0]} failed")
        on_export(path)


def start_job(started, path, dev, root, env, share_from=None) -> None:
    """A package job of ``root``'s packager (``python -m
    after_tpu_torch.streaming.native`` run there), as phase 15 starts
    one."""
    log_path = os.path.join(cs.NATIVE_JOB_LOGS,
                            f"{os.path.basename(path)}.{dev}")
    os.makedirs(cs.NATIVE_JOB_LOGS, exist_ok=True)
    with open(log_path + ".out", "w") as out, \
            open(log_path + ".err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "after_tpu_torch.streaming.native",
             os.path.abspath(path), "--device", dev]
            + (["--share_from", os.path.abspath(share_from)]
               if share_from else []),
            stdout=out, stderr=err, text=True, cwd=root, env=env)
    started["jobs"].append((path, dev))
    started["procs"].append((proc, log_path))


def wait_jobs(started) -> dict:
    """By "artifact (device)": the job's CPU-seconds and its packager's
    record, once done."""
    out = {}
    for (path, dev), (proc, log_path) in zip(started["jobs"],
                                             started["procs"]):
        _, status, usage = os.wait4(proc.pid, 0)
        with open(log_path + ".out") as f:
            text = f.read()
        if os.waitstatus_to_exitcode(status) != 0:
            with open(log_path + ".err") as f:
                cs.fail(f"packaging {path} for {dev} failed:\n"
                        f"{f.read()[-3000:]}")
        out[f"{os.path.basename(path)} ({dev})"] = (
            usage.ru_utime + usage.ru_stime,
            json.loads(text.strip().splitlines()[-1]))
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--parent", default=None,
                   help="a checkout whose packager packages the 'before' "
                        "set")
    args = p.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    from after_tpu_torch.utils.device import strict_f32
    strict_f32()
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__}, "
           f"{os.cpu_count()} CPUs")
    cfg = get_config("base")
    cfg = cfg.resolved(in_size=cfg.autoencoder.z_channels,
                       n_signal=cs.N_SAMPLES // cfg.autoencoder.ratio)
    pipe = TransferPipeline(cfg, device="cuda").init(cs.SEED)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    totals = {}
    for name in ("before", "after"):
        root = os.path.abspath(args.parent) if (
            name == "before" and args.parent) else here
        base = os.path.abspath(f"build/package_budget/{name}")
        cs.CLI_DIR = os.path.join(base, "cli")
        cs.NATIVE_JOB_LOGS = os.path.join(base, "jobs")
        env = dict(os.environ, PYTHONPATH=root,
                   TORCHINDUCTOR_CACHE_DIR=os.path.join(base, "inductor"),
                   TRITON_CACHE_DIR=os.path.join(base, "triton"))
        save_runs(pipe, cfg)
        started = {"jobs": [], "procs": []}
        t0 = time.perf_counter()
        if name == "before":
            devices = {"after.audio.diff": ("cuda",),
                       "after.audio.diff.voices2": ("cuda", "cpu"),
                       "codec_export": ("cuda",)}
            export_before(lambda path: [start_job(
                started, path, dev, root, env)
                for dev in devices[os.path.basename(path)]])
        else:
            main_art = os.path.join(cs.CLI_DIR, "runs", "diff",
                                    "after.audio.diff")
            devices = {"after.audio.diff": ("cuda",),
                       "after.audio.diff.voices2": ("cuda", "cpu"),
                       "codec_export": ("cuda",),
                       "after.audio.diff.edm": ("cuda",),
                       "after.audio.diff.v1": ("cuda",),
                       "codec_export.noise": ("cuda",)}
            cs.export_artifacts(lambda path: [start_job(
                started, path, dev, root, env,
                main_art if path == cs.native_artifacts()["edm"] else None)
                for dev in devices[os.path.basename(path)]])
        jobs = wait_jobs(started)
        wall = time.perf_counter() - t0
        totals[name] = (sum(v[0] for v in jobs.values()), wall)
        for job, (cpu, stages) in jobs.items():
            # a record is a stage's seconds, or (this checkout's) a dict
            cs.log(f"{name}: {job}: {cpu:.1f} CPU-s; " + ", ".join(
                f"{s} {v:.1f} s" if not isinstance(v, dict) else
                f"{s} shared" if "shared_from" in v else
                f"{s} {v['seconds']:.1f} s, {v['cpu_seconds']:.1f} CPU-s"
                for s, v in stages.items() if s != "total"))
        cs.log(f"{name}: {totals[name][0]:.1f} CPU-s in all, {wall:.1f} s "
               "wall from the first export to the last package")
    cs.log(f"card: {cs.card_line()}")
    print(json.dumps({k: {"cpu_seconds": v[0], "wall_seconds": v[1]}
                      for k, v in totals.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
