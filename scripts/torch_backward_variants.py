"""Where the snake+conv backward's kernels spend their time: each kernel
timed as it is and with one piece switched off, on the card.

    python3 scripts/torch_backward_variants.py

Copies ``after_tpu_torch/csrc/snake_conv_backward.cu`` into
``build/backward_variants/`` with one text edit each (dgrad: no epilogue,
the f32 totals folded only at the end, no low tf32 half of the weight, no
MMAs; wgrad: no sine in the activation, no low half of g, the totals
folded only at the end, no MMAs), builds every copy at once with nvcc and
times dgrad and wgrad of each (CUDA events over a CUDA graph of 20 calls,
as ``chip_smoke.py:cuda_ms``) at five shapes of a training codec forward at
batch 8. A variant computes wrong gradients; only its time is read. Prints
the card line and a line a shape: the plan, the 3xTF32 bound of each
kernel and each variant's ms.
"""

from __future__ import annotations

import ctypes
import os
import sys

# text edits of the source, each switching one piece off
VARIANTS = {
    "base": [],
    "dgrad_no_epilogue": [("  if (!p.need_ga) return;\n", "  return;\n")],
    "dgrad_fold_at_end": [
        ("if ((i + 1) % kFoldD == 0 || i + 1 == n) fold(tot, acc);",
         "if (i + 1 == n) fold(tot, acc);")],
    "dgrad_no_low_half": [
        ("for (int e = tid; e < WB / 4; e += kThreads) {",
         "for (int e = tid; e < 0; e += kThreads) {")],
    "dgrad_no_mma": [("    flush_gb(i);\n    mma(i);", "    flush_gb(i);")],
    "wgrad_no_sine": [("const float sn = sinf(xv * al_s[nc]);",
                       "const float sn = xv * al_s[nc];")],
    "wgrad_no_low_half": [("  lo = to_tf32(v - __uint_as_float(hi));",
                           "  lo = 0u;")],
    "wgrad_fold_at_end": [("if ((i + 1) % kFoldW == 0 || i + 1 == n) {",
                           "if (i + 1 == n) {")],
    "wgrad_no_mma": [
        ("    mma(i);\n    issue(i + 2);\n    if (i + 1 < n) {\n"
         "      cp_async_wait_prev();\n      __syncthreads();     // chunk",
         "    issue(i + 2);\n    if (i + 1 < n) {\n"
         "      cp_async_wait_prev();\n      __syncthreads();     // chunk")],
}
# (B, T, C, O, k, dilation) of a training codec forward
SHAPES = [(8, 2048, 384, 384, 3, 3), (8, 256, 768, 768, 3, 9),
          (8, 8192, 64, 64, 3, 1), (8, 2048, 384, 384, 1, 1),
          (8, 4096, 192, 192, 1, 1)]


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from after_tpu_torch.ops.conv import get_padding
    from after_tpu_torch.ops.kernels import build
    from after_tpu_torch.ops.kernels.fused_conv import (backward_plan,
                                                        backward_weight,
                                                        kernel_weight)
    from after_tpu_torch.utils.device import strict_f32

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    strict_f32()
    print(f"card: {cs.card_line()}", flush=True)
    src = (build.CSRC / "snake_conv_backward.cu").read_text()
    out = os.path.join(root, "build", "backward_variants")
    os.makedirs(out, exist_ok=True)
    cmds = []
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer holds "
                                 f"{old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmds.append([build._nvcc(), *build.NVCC_FLAGS, "-o",
                     os.path.join(out, f"lib{name}.so"), cu])
    build._wait(build._start(*cmds))
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(os.path.join(out, f"lib{name}.so"))
        lib.snake_conv_backward_dgrad_f32.argtypes = [P] * 10 + [I] * 8 + [
            P, P]
        lib.snake_conv_backward_wgrad_f32.argtypes = [P] * 6 + [I] * 8 + [
            P, P]
        libs[name] = lib
    for B, T, C, O, k, d in SHAPES:
        gen = torch.Generator("cuda").manual_seed(0)
        x = torch.randn(B, T, C, device="cuda", generator=gen)
        g = torch.randn(B, T, O, device="cuda", generator=gen)
        alpha = torch.rand(C, device="cuda", generator=gen) + 0.5
        beta = torch.rand(C, device="cuda", generator=gen) + 0.5
        w_k = kernel_weight(torch.randn(O, C, k, device="cuda",
                                        generator=gen) / (C * k) ** 0.5)[0]
        left = get_padding(k, 1, d, "centered")[0]
        plan = backward_plan(B, T, C, O, k, d)
        wt = backward_weight(w_k, C)
        gx = torch.empty_like(x)
        sums = [torch.empty(n, device="cuda") for n in (C, C, O)]
        ws = torch.empty(plan[2], 2 * C + O, device="cuda")
        gw = torch.empty_like(w_k)
        ws_w = torch.empty(plan[4], w_k.numel(), device="cuda")
        bound = 1e3 * 3 * 2.0 * k * C * O * T * B / cs.PEAK_TF32_FLOPS
        times = []
        for name, lib in libs.items():
            def dgrad():
                err = lib.snake_conv_backward_dgrad_f32(
                    g.data_ptr(), x.data_ptr(), alpha.data_ptr(),
                    beta.data_ptr(), wt.data_ptr(), gx.data_ptr(),
                    ws.data_ptr(), *(t.data_ptr() for t in sums), B, T, C, O,
                    k, d, left, wt.shape[2], None,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} dgrad: CUDA error {err}")

            def wgrad():
                err = lib.snake_conv_backward_wgrad_f32(
                    x.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
                    g.data_ptr(), gw.data_ptr(), ws_w.data_ptr(), B, T, C, O,
                    k, d, left, w_k.shape[2], None,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} wgrad: CUDA error {err}")
            if not name.startswith("wgrad"):
                times.append(f"{name} dgrad {cs.cuda_ms(dgrad):.4f}")
            if not name.startswith("dgrad"):
                times.append(f"{name} wgrad {cs.cuda_ms(wgrad):.4f}")
        print(f"{(B, T, C, O, k, d)} plan {plan}, bound {bound:.4f} ms "
              f"each; " + "; ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
