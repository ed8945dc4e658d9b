"""Op-by-op serving times of one checkout of the port, for paired runs of
two checkouts in one call to the card.

    python3 scripts/torch_eager_pair.py --root DIR --label NAME [--out FILE]

Imports ``after_tpu_torch`` from ``DIR`` (a checkout, or a ``git archive``
of one unpacked under ``build/``), builds its kernel, and on one CUDA card
runs ``chip_smoke.py``'s phases 4 and 6 op by op: the base config at full
width with port-native weights from seed 0, transfers of 524288 samples
(20 Euler steps, guidance_timbre 2.0; one warm-up, then N_TRANSFERS) with
``eager=True``, and the crossfade ``Streamer`` with ``eager=True`` over 64
buffers of 8192 samples at nb_steps 1 and 4 (two warm-up buffers first);
host ms on the clock around each call ending in a synchronize.  Then the
host us a call of the snake+conv op as ``ConvBlock1d`` calls it (its kept
weight) at a small shape where the launch, not the kernel, sets the pace,
over CALLS calls: through ``snake_conv`` where the checkout has the
registered op (and its launcher ``_launch`` beside it), else through
``fused_snake_conv``.  Prints the card line and one JSON line; ``--out``
appends that line to a file.  Run it for checkouts A and B in the order
A B B A in one call: the hosts' noise moves between calls.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

N_SAMPLES = 524288
NB_STEPS = 20
GUIDANCE_TIMBRE = 2.0
N_TRANSFERS = 5
CHUNK = 4
N_FADE = 4
STREAM_STEPS = (1, 4)
CALLS = 2000


def median(values):
    return sorted(values)[len(values) // 2]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import after_tpu_torch
    if not after_tpu_torch.__file__.startswith(root + os.sep):
        sys.exit(f"imported {after_tpu_torch.__file__}, not from {root}")
    from after_tpu_torch import TransferPipeline, get_config
    from after_tpu_torch.models.autoencoder import ConvBlock1d
    from after_tpu_torch.ops.kernels import fused_conv
    from after_tpu_torch.ops.kernels.build import load
    from after_tpu_torch.streaming import Streamer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    load(fused_conv.SOURCE)
    cfg = get_config("base")
    ratio = cfg.autoencoder.ratio
    cfg = cfg.resolved(in_size=cfg.autoencoder.z_channels,
                       n_signal=N_SAMPLES // ratio)
    pipe = TransferPipeline(cfg, device="cuda").init(0)
    pipe.eager = True
    rng = np.random.RandomState(0)
    a, b = (0.1 * rng.randn(1, N_SAMPLES, 1).astype(np.float32)
            for _ in range(2))
    kw = dict(nb_steps=NB_STEPS, guidance_timbre=GUIDANCE_TIMBRE)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    pipe.transfer(a, b, **kw)                                  # warm-up
    transfer_ms = [timed(lambda: pipe.transfer(
        a, b, **kw, generator=torch.Generator("cuda").manual_seed(i)))[0]
        for i in range(N_TRANSFERS)]

    streamer = Streamer(cfg, chunk_size=CHUNK, n_fade=N_FADE, pipeline=pipe,
                        eager=True)
    A = streamer.audio_chunk

    def stream(nb, n):
        state, times = streamer.init_state(1), []
        for i in range(n):
            s = slice(i * A, (i + 1) * A)
            ms, (y, state) = timed(lambda: streamer.forward(
                state, a[:, s], b[:, s], nb_steps=nb,
                guidance_timbre=GUIDANCE_TIMBRE))
            if not torch.isfinite(y).all():
                sys.exit(f"buffer {i}: non-finite output")
            times.append(ms)
        return times

    stream(STREAM_STEPS[-1], 2)                                # warm-up
    buffers = {nb: stream(nb, N_SAMPLES // A) for nb in STREAM_STEPS}

    # the op's host cost a call, as ConvBlock1d calls it, at a shape whose
    # kernel takes a few us
    block = next(m for m in pipe.codec.modules()
                 if isinstance(m, ConvBlock1d) and not m.cached)
    conv = block.conv
    x = torch.randn((1, 64, conv.in_features), device="cuda")
    alpha, beta = block.act.alpha, block.act.beta
    entries = {}
    with torch.inference_mode():
        if hasattr(fused_conv, "snake_conv"):
            pair = conv.kernel_weights()
            entries["snake_conv"] = lambda: fused_conv.snake_conv(
                x, alpha, beta, *pair, conv.bias, conv.dilation, conv.mode)
            entries["_launch"] = lambda: fused_conv._launch(
                x, alpha, beta, *pair, conv.bias, conv.dilation, conv.mode)
        else:
            w = conv.effective_weight()
            entries["fused_snake_conv"] = lambda: fused_conv.fused_snake_conv(
                x, alpha, beta, w, conv.bias, conv.dilation, conv.mode)
        call_us = {}
        for name, fn in entries.items():
            for _ in range(100):
                fn()
            ms, _ = timed(lambda: [fn() for _ in range(CALLS)])
            call_us[name] = ms * 1e3 / CALLS

    line = {"label": args.label, "root": args.root, "card": card,
            "torch": torch.__version__,
            "transfer_eager_ms": transfer_ms,
            "transfer_eager_ms_median": median(transfer_ms),
            "buffer_eager_ms_median": {nb: median(t)
                                       for nb, t in buffers.items()},
            "buffer_eager_ms_p90": {nb: sorted(t)[int(0.9 * len(t))]
                                    for nb, t in buffers.items()},
            "op_call_host_us": call_us}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
