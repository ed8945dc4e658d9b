"""``chip_smoke.py``'s phase 17 (bf16 training) alone, on the card: the
kernels built from the checkout, then ``chip_smoke.bf16_train_phase``
(the base codec trained at bf16, the bf16 backward kernels at every shape
of its encoder, a bf16 step card vs CPU, the diffusion model at bf16 as
CUDA graphs and op by op, and both training commands at bf16).  About 3
minutes.

    python3 scripts/torch_bf16_train_phase.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from after_tpu_torch.ops.kernels.build import load_all  # noqa: E402
from after_tpu_torch.ops.kernels.fused_conv import (  # noqa: E402
    BACKWARD_SOURCE, SOURCE)
from after_tpu_torch.utils.device import strict_f32  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    cs.phase_time("start")
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__}")
    load_all(SOURCE, BACKWARD_SOURCE)
    strict_f32()
    cs.phase_time("build")
    row = {}
    rows = cs.bf16_train_phase(row)
    cs.phase_time("phase 17 (bf16 training)")
    print(json.dumps({"kernels": rows, "bf16_training": row[
        "bf16_training"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
