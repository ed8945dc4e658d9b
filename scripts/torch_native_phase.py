"""``chip_smoke.py``'s phase 15 (the native streaming host) alone, on the
card: base artifacts with port-native random weights (seed 0) exported
where phase 13 leaves its artifacts (the streaming one at batch 1 and 2,
the codec-only one, the codec run's config.json), then
``chip_smoke.native_phase`` on them.  About 9 minutes, most of it the
stages' packaging.

    python3 scripts/torch_native_phase.py
"""

import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from after_tpu_torch import TransferPipeline, get_config  # noqa: E402
from after_tpu_torch.config import ae_to_json  # noqa: E402
from after_tpu_torch.ops.kernels.fused_conv import (  # noqa: E402
    device_launches, reset_device_launches)
from after_tpu_torch.streaming import Streamer  # noqa: E402
from after_tpu_torch.streaming.export import (  # noqa: E402
    ExportedStreamer, export_codec, export_streamer)


def main() -> int:
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    from after_tpu_torch.utils.device import strict_f32
    strict_f32()
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__}")
    cfg = get_config("base")
    cfg = cfg.resolved(in_size=cfg.autoencoder.z_channels,
                       n_signal=cs.N_SAMPLES // cfg.autoencoder.ratio)
    pipe = TransferPipeline(cfg, device="cuda").init(cs.SEED)
    streamer = Streamer(cfg, cs.CHUNK, cs.N_FADE, pipeline=pipe)
    runs = os.path.join(cs.CLI_DIR, "runs")
    art = os.path.join(runs, "diff", "after.audio.diff")
    art2 = os.path.join(cs.CLI_DIR, "after.audio.diff.voices2")
    codec_art = os.path.join(runs, "ae", "codec_export")
    t0 = time.perf_counter()
    export_streamer(streamer, art, nb_steps=cs.EXPORT_STEPS,
                    guidance_timbre=cs.GUIDANCE_TIMBRE)
    export_streamer(streamer, art2, nb_steps=cs.EXPORT_STEPS,
                    guidance_timbre=cs.GUIDANCE_TIMBRE, batch_size=2)
    export_codec(cfg.autoencoder, pipe.codec.state_dict(), codec_art,
                 chunk_size=cs.CHUNK, n_fade=cs.N_FADE, device="cuda")
    with open(os.path.join(runs, "ae", "config.json"), "w") as f:
        f.write(ae_to_json(cfg.autoencoder))
    cs.log(f"exports {time.perf_counter() - t0:.1f} s")
    S = cfg.denoiser.max_diffusion_steps
    del streamer, pipe
    torch.cuda.empty_cache()
    rng = np.random.RandomState(cs.SEED)
    a = (0.1 * rng.randn(1, cs.N_SAMPLES, 1)).astype(np.float32)
    b = (0.1 * rng.randn(1, cs.N_SAMPLES, 1)).astype(np.float32)
    attrs = [(1 + i % S, 1.0 + 0.8 * math.sin(i), 1.2 + math.cos(0.7 * i))
             for i in range(cs.STREAM_CHANGING)]
    # what phases 3 and 6 give phase 15: the launches a buffer and its bound
    host = ExportedStreamer(art, "cuda")
    A = host.manifest["audio_chunk"]
    host.call("forward", a[:, :A], b[:, :A])
    reset_device_launches()
    host.call("forward", a[:, :A], b[:, :A])
    launches, sums = device_launches()
    del host
    from after_tpu_torch.models.autoencoder import AudioCodec
    window = (cs.N_FADE + cs.CHUNK) * cfg.autoencoder.ratio
    enc, dec = cs.codec_conv_blocks(AudioCodec(cfg.autoencoder), window)
    row = {"launches_per_buffer": launches,
           "sum_splits_launches_per_buffer": sums,
           "bound_ms_per_buffer": cs.path_bound(enc + enc + dec)[0]}
    t0 = time.perf_counter()
    started = cs.start_packaging()
    for path, devices in ((art, ("cuda",)), (art2, ("cuda", "cpu")),
                          (codec_art, ("cuda",))):
        cs.package_in_background(started, path, *devices)
    cs.native_phase(row, a, b, attrs, started)
    cs.log(f"phase 15 {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
