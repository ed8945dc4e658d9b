"""``chip_smoke.py``'s phase 15 (the native streaming host) alone, on the
card: base runs with port-native random weights (seed 0) saved where
phase 12 leaves its runs, every artifact of phase 13 and phase 15 exported
from them as phase 13 exports them (``chip_smoke.export_artifacts``: the
main one, the cut two-voice one, the codec one, EDM, v1 and the noise
codec's), their packages started as each is written, then
``chip_smoke.native_phase`` on them.  About 10-15 minutes, most of it the
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
from after_tpu_torch.config import ae_to_json, to_json  # noqa: E402
from after_tpu_torch.ops.kernels.fused_conv import (  # noqa: E402
    device_launches, reset_device_launches)
from after_tpu_torch.streaming.export import ExportedStreamer  # noqa: E402
from after_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402


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
    runs = os.path.join(cs.CLI_DIR, "runs")
    art = os.path.join(runs, "diff", "after.audio.diff")
    # phase 12's runs, from these weights: the diffusion run (its EMA the
    # denoiser) and the codec run
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
    t0 = time.perf_counter()
    started = cs.start_packaging()
    seconds = cs.export_artifacts(cs.native_on_export(started))
    cs.log("exports (s): " + ", ".join(f"{k} {v:.1f}"
                                       for k, v in seconds.items()))
    S = cfg.denoiser.max_diffusion_steps
    del pipe
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
    cs.native_phase(row, a, b, attrs, started)
    cs.log(f"phase 15 {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
