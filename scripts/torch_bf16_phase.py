"""``chip_smoke.py``'s phase 16 (bf16 serving) alone, on the card: the base
pipeline with port-native random weights (seed 0), phase 4's requests and
their f32 outputs, phase 5's clip with its CPU f32 output, and a diffusion
and a codec run of those weights saved where phase 12 leaves its runs, then
``chip_smoke.bf16_phase`` on them.  About 3 minutes.

    python3 scripts/torch_bf16_phase.py
"""

import json
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
from after_tpu_torch.ops.kernels.build import load_all  # noqa: E402
from after_tpu_torch.ops.kernels.fused_conv import (  # noqa: E402
    BACKWARD_SOURCE, SOURCE)
from after_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    cs.phase_time("start")
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__}")
    load_all(SOURCE, BACKWARD_SOURCE)
    cfg = get_config("base")
    cfg = cfg.resolved(in_size=cfg.autoencoder.z_channels,
                       n_signal=cs.N_SAMPLES // cfg.autoencoder.ratio)
    pipe = TransferPipeline(cfg, device="cuda").init(cs.SEED)
    # phase 4's requests and the f32 outputs of their replays
    rng = np.random.RandomState(cs.SEED)
    requests = [(0.1 * rng.randn(1, cs.N_SAMPLES, 1).astype(np.float32),
                 0.1 * rng.randn(1, cs.N_SAMPLES, 1).astype(np.float32))
                for _ in range(cs.N_REQUESTS + 1)]
    kw = dict(nb_steps=cs.NB_STEPS, guidance_timbre=cs.GUIDANCE_TIMBRE)
    pipe.transfer(*requests[0], **kw)
    outs = [pipe.transfer(a, b, **kw,
                          generator=torch.Generator("cuda").manual_seed(i))
            for i, (a, b) in enumerate(requests[1:])]
    # phase 5's clip and the CPU's f32 output of it
    cpu = TransferPipeline(cfg, device="cpu")
    cpu.codec.load_state_dict(pipe.codec.state_dict())
    cpu.rf.load_state_dict(pipe.rf.state_dict())
    rng = np.random.RandomState(cs.SEED + 1)
    a = 0.1 * rng.randn(1, cs.SHORT_SAMPLES, 1).astype(np.float32)
    b = 0.1 * rng.randn(1, cs.SHORT_SAMPLES, 1).astype(np.float32)
    x0 = rng.randn(1, cs.SHORT_SAMPLES // cfg.autoencoder.ratio,
                   cfg.autoencoder.z_channels).astype(np.float32)
    y_cpu = cpu.transfer(a, b, nb_steps=cs.SHORT_STEPS,
                         guidance_timbre=cs.GUIDANCE_TIMBRE, x0=x0)
    del cpu
    # the runs phase 13 exports (the weights above, the EMA equal to them)
    runs = os.path.join(cs.CLI_DIR, "runs")
    rf = pipe.rf
    variables = {k: m.state_dict() for k, m in (
        ("net", rf.net), ("encoder", rf.encoder),
        ("encoder_time", rf.encoder_time)) if m is not None}
    ema = {n: p.detach() for n, p in rf.net.named_parameters()}
    save_checkpoint(os.path.join(runs, "diff"), 1,
                    {"variables": variables, "ema_params": ema, "step": 1},
                    config_json=to_json(cfg))
    save_checkpoint(os.path.join(runs, "ae"), 1,
                    {"codec_vars": pipe.codec.state_dict(), "step": 1},
                    config_json=ae_to_json(cfg.autoencoder))
    cs.phase_time("set-up")
    rows = cs.bf16_phase(cfg, pipe, requests, outs, (a, b, x0, y_cpu))
    cs.phase_time("phase 16 (bf16 serving)")
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    cs.log(f"seconds {time.perf_counter() - t0:.1f}")
    sys.exit(rc)
