"""One encoded batch of ``prepare_dataset`` under torch.profiler, in a
process of its own: the snake+conv kernel's share of the batch's device
time, the device's busy time and idle share.

    python3 scripts/torch_profile_encode.py [--batch 8] [--samples 524288]

Builds the kernel and the base codec at full width with port-native
weights from seed 0 (the times do not depend on the weights), encodes one
warm-up batch of seeded noise, then profiles the same batch as
``chip_smoke.py`` phase 14 does (``profile_kept``: up to PROFILE_TRIES
profiles, each kept only if the profiler recorded every launch the device
counted). ``chip_smoke.py`` itself profiles late in a long process, where
the profiler may lose a kernel record; here it profiles first. Prints the
card line and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--samples", type=int, default=524288)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    import chip_smoke as cs
    from after_tpu_torch.config import get_ae_config
    from after_tpu_torch.models.autoencoder import AudioCodec
    from after_tpu_torch.ops.kernels.build import load
    from after_tpu_torch.ops.kernels.fused_conv import SOURCE
    from after_tpu_torch.utils.device import strict_f32
    from after_tpu_torch.utils.init import init_weights

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    strict_f32()
    load(SOURCE)
    codec = AudioCodec(get_ae_config())
    init_weights(codec, 0)
    codec = codec.eval().cuda()
    enc_path, _ = cs.codec_conv_blocks(codec, args.samples)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = 0.1 * torch.randn((args.batch, args.samples, 1), generator=gen,
                          device="cuda")
    with torch.inference_mode():
        codec.encode(x)
        torch.cuda.synchronize()
        # the split sum's launches an encode, as the device counts them
        from after_tpu_torch.ops.kernels.fused_conv import (
            device_launches, reset_device_launches)
        reset_device_launches()
        codec.encode(x)
        sums = device_launches()[1]
        busy, k_ms, sum_ms = cs.profile_kept(
            f"one encoded batch of {args.batch} x {args.samples} samples",
            lambda: codec.encode(x), (len(enc_path), sums))
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    row = {"card": card, "batch": args.batch, "samples": args.samples,
           "launches": len(enc_path), "sum_launches": sums, "busy_ms": busy,
           "kernel_ms": k_ms, "sum_ms": sum_ms,
           "share_of_busy": (k_ms + sum_ms) / busy if busy else None}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
