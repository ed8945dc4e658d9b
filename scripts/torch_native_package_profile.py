"""Where one stage's AOTInductor packaging (``streaming/native.py``) spends
its time, alone on the machine: the base config's ``structure`` stage for
the card and for the CPU and its ``step`` stage for the card, each under
cProfile (its top 45 entries by cumulative time) with its wall seconds.
On the card's machine (needs the card to trace and package for it):

    python3 scripts/torch_native_package_profile.py
"""

import cProfile
import io
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from after_tpu_torch import TransferPipeline, get_config  # noqa: E402
from after_tpu_torch.streaming import Streamer, native  # noqa: E402
from after_tpu_torch.streaming.export import export_streamer  # noqa: E402
from after_tpu_torch.utils.device import (resolve_device,  # noqa: E402
                                          strict_f32)

ART = "build/package_profile_art"


def main() -> int:
    strict_f32()
    cfg = get_config("base")
    cfg = cfg.resolved(in_size=cfg.autoencoder.z_channels,
                       n_signal=524288 // cfg.autoencoder.ratio)
    pipe = TransferPipeline(cfg, device="cuda").init(0)
    export_streamer(Streamer(cfg, 4, 4, pipeline=pipe), ART, nb_steps=4)
    del pipe
    for dev, stage in (("cuda", "structure"), ("cpu", "structure"),
                       ("cuda", "step")):
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        native._package_one(ART, resolve_device(dev), stage)
        prof.disable()
        print(f"=== {dev} {stage}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(45)
        print("\n".join(line[:200] for line in
                        out.getvalue().splitlines()[:75]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
