"""The f32 kernels and the bf16 forward and dgrad of this tree against
another checkout's, bit for bit, on the card.

    python3 scripts/torch_kernels_same_bits.py --csrc DIR

Builds ``fused_snake_conv.cu`` and ``snake_conv_backward.cu`` of this tree
and of ``DIR`` (say a parent unpacked under ``build/`` with ``git
archive``) with nvcc into ``build/same_bits/``, runs ``fused_snake_conv_f32``,
the f32 dgrad and wgrad, ``fused_snake_conv_bf16`` and the bf16 dgrad of
both on the same inputs at six shapes (a transfer's, a training step's and
ragged ones), each with the workspace its own plan asks for, and prints,
a shape, whether each output (y, gx, galpha, gbeta, gb, gw; bf16 y, gx,
galpha, gbeta, gb) has the same bits. Exits non-zero if any differs. (The
bf16 wgrad is left out: its redesign sums in another order.)
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

SHAPES = [(1, 8192, 384, 384, 3, 9), (1, 1024, 768, 768, 3, 9),
          (2, 700, 96, 300, 3, 3), (3, 37, 130, 70, 1, 1),
          (8, 2048, 256, 256, 3, 3), (8, 8192, 16, 64, 3, 1)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", required=True)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from after_tpu_torch.ops.conv import get_padding
    from after_tpu_torch.ops.kernels import build
    from after_tpu_torch.ops.kernels.fused_conv import (backward_plan,
                                                        backward_weight,
                                                        kernel_weight)

    def plan(lib, name, n, *shape):
        out = (ctypes.c_int * n)()
        if getattr(lib, name)(*shape, ctypes.addressof(out)):
            raise RuntimeError(f"{name}: no plan for {shape}")
        return tuple(out)

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"card: {cs.card_line()}", flush=True)
    out = os.path.join(root, "build", "same_bits")
    os.makedirs(out, exist_ok=True)
    cmds, paths = [], {}
    for tag, csrc in (("tree", str(build.CSRC)), ("other", args.csrc)):
        for src in ("fused_snake_conv.cu", "snake_conv_backward.cu"):
            paths[tag, src] = os.path.join(out, f"{tag}_{src}.so")
            cmds.append([build._nvcc(), *build.NVCC_FLAGS, "-o",
                         paths[tag, src], os.path.join(csrc, src)])
    build._wait(build._start(*cmds))
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {key: ctypes.CDLL(path) for key, path in paths.items()}
    for (tag, src), lib in libs.items():
        if src == "fused_snake_conv.cu":
            lib.fused_snake_conv_f32.argtypes = [P] * 8 + [I] * 8 + [P, P]
            lib.fused_snake_conv_bf16.argtypes = [P] * 7 + [I] * 8 + [P, P]
            lib.fused_snake_conv_plan_bf16.argtypes = [I] * 6 + [P]
        else:
            for name in ("snake_conv_backward_dgrad_f32",
                         "snake_conv_backward_dgrad_bf16"):
                getattr(lib, name).argtypes = [P] * 10 + [I] * 8 + [P, P]
            lib.snake_conv_backward_wgrad_f32.argtypes = (
                [P] * 6 + [I] * 8 + [P, P])
            lib.snake_conv_backward_plan_bf16.argtypes = [I] * 6 + [P]
    differ = 0
    for B, T, C, O, k, d in SHAPES:
        gen = torch.Generator("cuda").manual_seed(1)
        x = torch.randn(B, T, C, device="cuda", generator=gen)
        g = torch.randn(B, T, O, device="cuda", generator=gen)
        al = torch.rand(C, device="cuda", generator=gen) + 0.5
        be = torch.rand(C, device="cuda", generator=gen) + 0.5
        w = torch.randn(O, C, k, device="cuda", generator=gen) / (C * k) ** .5
        b = torch.randn(O, device="cuda", generator=gen)
        w_k, w_lo = kernel_weight(w)
        w16 = kernel_weight(w.to(torch.bfloat16))[0]
        x16, g16, al16, be16, b16 = (t.to(torch.bfloat16)
                                     for t in (x, g, al, be, b))
        wt = backward_weight(w_k, C)
        wt16 = backward_weight(w16, C)
        left = get_padding(k, 1, d, "centered")[0]
        s = torch.cuda.current_stream().cuda_stream
        outs = {}
        for tag in ("tree", "other"):
            fwd = libs[tag, "fused_snake_conv.cu"]
            bwd = libs[tag, "snake_conv_backward.cu"]
            y = torch.empty(B, T, O, device="cuda")
            ws = torch.empty(16, B, T, O, device="cuda")
            gx = torch.empty_like(x)
            sums = [torch.empty(m, device="cuda") for m in (C, C, O)]
            part = torch.empty(B * T // 128 + 8, 2 * C + O, device="cuda")
            gw = torch.empty_like(w_k)
            ws_w = torch.empty(backward_plan(B, T, C, O, k, d)[4],
                               w_k.numel(), device="cuda")
            y16 = torch.empty(B, T, O, device="cuda", dtype=torch.bfloat16)
            ws16 = torch.empty(
                plan(fwd, "fused_snake_conv_plan_bf16", 3, B, T, C, O, k,
                     d)[2], B, T, O, device="cuda")
            gx16 = torch.empty_like(x16)
            sums16 = [torch.empty(m, device="cuda", dtype=torch.bfloat16)
                      for m in (C, C, O)]
            part16 = torch.empty(
                plan(bwd, "snake_conv_backward_plan_bf16", 5, B, T, C, O, k,
                     d)[2], 2 * C + O, device="cuda")
            errs = (
                fwd.fused_snake_conv_f32(
                    x.data_ptr(), al.data_ptr(), be.data_ptr(),
                    w_k.data_ptr(), w_lo.data_ptr(), b.data_ptr(),
                    y.data_ptr(), ws.data_ptr(), B, T, C, O, k, d, left,
                    w_k.shape[2], None, s),
                bwd.snake_conv_backward_dgrad_f32(
                    g.data_ptr(), x.data_ptr(), al.data_ptr(), be.data_ptr(),
                    wt.data_ptr(), gx.data_ptr(), part.data_ptr(),
                    *(t.data_ptr() for t in sums), B, T, C, O, k, d, left,
                    wt.shape[2], None, s),
                bwd.snake_conv_backward_wgrad_f32(
                    x.data_ptr(), al.data_ptr(), be.data_ptr(), g.data_ptr(),
                    gw.data_ptr(), ws_w.data_ptr(), B, T, C, O, k, d, left,
                    w_k.shape[2], None, s),
                fwd.fused_snake_conv_bf16(
                    x16.data_ptr(), al16.data_ptr(), be16.data_ptr(),
                    w16.data_ptr(), b16.data_ptr(), y16.data_ptr(),
                    ws16.data_ptr(), B, T, C, O, k, d, left, w16.shape[2],
                    None, s),
                bwd.snake_conv_backward_dgrad_bf16(
                    g16.data_ptr(), x16.data_ptr(), al16.data_ptr(),
                    be16.data_ptr(), wt16.data_ptr(), gx16.data_ptr(),
                    part16.data_ptr(), *(t.data_ptr() for t in sums16), B,
                    T, C, O, k, d, left, wt16.shape[2], None, s))
            if any(errs):
                raise RuntimeError(f"{tag} {(B, T, C, O, k, d)}: CUDA errors "
                                   f"{errs}")
            torch.cuda.synchronize()
            outs[tag] = (y, gx, *sums, gw, y16, gx16, *sums16)
        same = [torch.equal(a, c) for a, c in zip(outs["tree"],
                                                  outs["other"])]
        differ += not all(same)
        print(f"{(B, T, C, O, k, d)} same bits (y, gx, galpha, gbeta, gb, "
              f"gw; bf16 y, gx, galpha, gbeta, gb): {same}", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
