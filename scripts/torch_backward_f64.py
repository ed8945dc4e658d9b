"""The snake+conv backward's kernels against float64, tensor by tensor, on
the card, beside the plain backward in strict f32 (cuDNN's F.conv1d
autograd).

    python3 scripts/torch_backward_f64.py [--bf16]

At eight shapes of a training codec forward (batch 8, the first 256
frames of each row, as ``chip_smoke.py`` phase 8 cuts them), two seeds
each: max |g - g_f64| / max |g_f64| of gx, galpha, gbeta, gw and gb for the
op ``snake_conv_backward`` (the kernels) and for its plain version in f32.
``--bf16``: the bf16 kernels on bf16 inputs against float64 of the same
function (``chip_smoke.py:bf16_grad_f64``: the activation rounded to bf16
for the product), beside bf16 F.conv1d's autograd backward of the bf16
snake + conv, as phase 17 holds them. Prints the card line and a line a
shape and seed.
"""

from __future__ import annotations

import os
import sys

# (k, dilation, C, O, T of the full crop: only the plan depends on it)
SHAPES = [(1, 1, 128, 128, 4096), (3, 1, 128, 128, 4096),
          (1, 1, 768, 768, 256), (3, 9, 768, 768, 256),
          (3, 3, 384, 384, 2048), (1, 1, 512, 512, 256),
          (3, 1, 64, 64, 8192), (3, 1, 16, 64, 8192)]
BATCH, FRAMES = 8, 256


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    import chip_smoke as cs
    from after_tpu_torch.ops.kernels.fused_conv import (
        backward_plan, kernel_weight, snake_conv_backward,
        snake_conv_backward_reference)
    from after_tpu_torch.utils.device import strict_f32

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if "--bf16" in sys.argv[1:]:
        return bf16_errors()
    strict_f32()
    print(f"card: {cs.card_line()}", flush=True)
    every = [True] * 5
    for k, d, C, O, T in SHAPES:
        for seed in (0, 1):
            gen = torch.Generator("cuda").manual_seed(seed)
            x = torch.randn(BATCH, FRAMES, C, device="cuda", generator=gen)
            g = torch.randn(BATCH, FRAMES, O, device="cuda", generator=gen)
            alpha = 0.75 + 0.5 * torch.rand(C, device="cuda", generator=gen)
            beta = 0.75 + 0.5 * torch.rand(C, device="cuda", generator=gen)
            v = torch.randn(O, C, k, device="cuda", generator=gen)
            w_k = kernel_weight(v / v.flatten(1).norm(dim=1)[:, None, None])[0]
            b = torch.zeros(O, device="cuda")
            args = (g, x, alpha, beta, w_k, b, d, "centered")
            r64 = snake_conv_backward_reference(
                *(t.double() if torch.is_tensor(t) else t for t in args),
                every)

            def errors(ts):
                return " ".join(
                    f"{((a.double() - r).abs().max() / r.abs().max()).item():.2e}"
                    for a, r in zip(ts, r64))
            print(f"{(k, d, C, O, T)} seed {seed} plan "
                  f"{backward_plan(BATCH, FRAMES, C, O, k, d)} | kernels "
                  f"{errors(snake_conv_backward(*args, every))} | plain "
                  f"{errors(snake_conv_backward_reference(*args, every))}",
                  flush=True)
    return 0


def bf16_errors() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from after_tpu_torch.ops.conv import get_padding
    from after_tpu_torch.ops.kernels.fused_conv import (backward_plan,
                                                        kernel_weight,
                                                        snake_conv_backward)
    from after_tpu_torch.ops.snake import snake_beta

    bf = torch.bfloat16
    print(f"card: {cs.card_line()}", flush=True)
    every = [True] * 5
    for k, d, C, O, T in SHAPES:
        for seed in (0, 1):
            gen = torch.Generator("cuda").manual_seed(seed)
            x = torch.randn(BATCH, FRAMES, C, device="cuda", generator=gen)
            g = torch.randn(BATCH, FRAMES, O, device="cuda", generator=gen)
            alpha = 0.75 + 0.5 * torch.rand(C, device="cuda", generator=gen)
            beta = 0.75 + 0.5 * torch.rand(C, device="cuda", generator=gen)
            v = torch.randn(O, C, k, device="cuda", generator=gen)
            w = (v / v.flatten(1).norm(dim=1)[:, None, None]).to(bf)
            b = torch.zeros(O, device="cuda", dtype=bf)
            x, g, alpha, beta = (t.to(bf) for t in (x, g, alpha, beta))
            args = (g, x, alpha, beta, kernel_weight(w)[0], b, d, "centered")
            r64 = cs.bf16_grad_f64(args, every)
            left, right = get_padding(k, 1, d, "centered")
            leaves = [t.detach().clone().requires_grad_()
                      for t in (x, alpha, beta, w, b)]
            a = snake_beta(*leaves[:3])
            y = F.conv1d(F.pad(a.transpose(1, 2), (left, right)), leaves[3],
                         leaves[4], dilation=d).transpose(1, 2)
            lib = list(torch.autograd.grad(y, leaves, g))
            lib[3] = kernel_weight(lib[3])[0]

            def errors(ts):
                return " ".join(
                    f"{((a.double() - r).abs().max() / r.abs().max()).item():.2e}"
                    for a, r in zip(ts, r64))
            print(f"{(k, d, C, O, T)} seed {seed} plan "
                  f"{backward_plan(BATCH, FRAMES, C, O, k, d, bf)} | kernels "
                  f"{errors(snake_conv_backward(*args, every))} | bf16 "
                  f"F.conv1d {errors(lib)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
