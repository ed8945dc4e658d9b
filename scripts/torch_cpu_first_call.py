"""Witness of a fault in PyTorch's CPU runtime, outside the port: in a
fresh process, the first call of a vectorised float op (torch.sin, cos,
exp, tanh) on a tensor that is split across threads may compute one
thread's share with errors near 1.5e-4 against float64, while a second
call on the same tensor is exact to float32.

Each trial is a fresh interpreter that imports torch and nothing else;
it prints the largest error of the first call and of the second against
float64.  The script counts the trials whose first call was off.  With
``--warmup`` each trial first calls the port's CPU entry,
``after_tpu_torch.utils.device.resolve_device("cpu")``, which warms the
ops up (``warm_cpu_math``): the evidence for that repair.

    python scripts/torch_cpu_first_call.py [--trials 25] [--op sin]
        [--n 1048576] [--threads 0 (PyTorch's default)] [--warmup]
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRIAL = """
import torch
if {warmup}:
    import sys
    sys.path.insert(0, {repo!r})
    from after_tpu_torch.utils.device import resolve_device
    resolve_device("cpu")
if {threads}:
    torch.set_num_threads({threads})
op = getattr(torch, "{op}")
x = torch.randn({n}, generator=torch.Generator().manual_seed(0)) * 3
first, second = op(x), op(x)
ref = op(x.double())
err = lambda y: float(((y.double() - ref).abs() / ref.abs().clamp(min=1))
                      .max())
print(err(first), err(second), torch.__version__,
      torch.backends.cpu.get_cpu_capability(), torch.get_num_threads())
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trials", type=int, default=25)
    p.add_argument("--op", default="sin")
    p.add_argument("--n", type=int, default=1 << 20)
    p.add_argument("--threads", type=int, default=0)
    p.add_argument("--limit", type=float, default=1e-6,
                   help="an error above this counts as off")
    p.add_argument("--warmup", action="store_true",
                   help="call the port's resolve_device('cpu') first")
    args = p.parse_args(argv)
    code = TRIAL.format(threads=args.threads, op=args.op, n=args.n,
                        warmup=args.warmup, repo=REPO)
    firsts, seconds = [], []
    for _ in range(args.trials):
        out = subprocess.run([sys.executable, "-c", code], check=True,
                             capture_output=True, text=True).stdout.split()
        firsts.append(float(out[0]))
        seconds.append(float(out[1]))
        version, isa, threads = out[2:5]
    off = sum(e > args.limit for e in firsts)
    print(f"torch {version} ({isa}, {threads} threads), "
          f"{'after resolve_device(cpu), ' if args.warmup else ''}"
          f"torch.{args.op} of "
          f"{args.n} float32 values, {args.trials} fresh processes: the "
          f"first call off in {off} (largest error {max(firsts):.3e}), the "
          f"second in {sum(e > args.limit for e in seconds)} (largest "
          f"{max(seconds):.3e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
