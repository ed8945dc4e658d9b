"""The bf16 forward and bf16 dgrad kernels' plans against their times with
each tile forced, on the card.

    python3 scripts/torch_bf16_tiles.py

Copies ``fused_snake_conv.cu`` and ``snake_conv_backward.cu`` (with
``snake_conv_bf16.cuh`` inlined) into ``build/bf16_tiles/`` once for each
tile (frames 128 or 64 x columns 64 or 128, the channel sum unsplit) and
once as they are (``auto``, the plan's own choice), builds every copy at
once with nvcc and times each (CUDA events over a CUDA graph of 20 calls,
as ``chip_smoke.py:cuda_ms``) at every shape of one 524288-sample transfer
and of one streamed buffer's crossfade window (the forward, batch 1) and of
the encoder at batch 8 x 131072 samples (dgrad). Prints the card line, a
line a shape with each copy's plan (frames, columns, channels a stage,
ring slots, splits or rows of partials, blocks) and ms, and each copy's
ms summed over the transfer, the buffer and the bf16 generator step.
"""

from __future__ import annotations

import ctypes
import os
import sys

TILES = [(128, 64), (128, 128), (64, 64), (64, 128)]


def variants():
    out = {}
    for m, bn in TILES:
        out[f"m{m}_bn{bn}"] = [
            ("  for (int m = 128; m >= 64; m /= 2) {",
             f"  for (int m = {m}; m >= {m}; m /= 2) {{"),
            ("    for (int bn = 64; bn <= 128; bn *= 2) {\n"
             "      if (bn > 64 && cdiv(N, bn) * bn >= 2 * N) continue;",
             f"    for (int bn = {bn}; bn <= {bn}; bn *= 2) {{"),
            ("      const int most = fwd ? (n_stages / 2 > 1 ? n_stages / 2 : 1)"
             " : 1;", "      const int most = 1;")]
    out["auto"] = []
    return out


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    import chip_smoke as cs
    from _variants_common import build_variants, codec_shapes
    from after_tpu_torch.ops.conv import get_padding
    from after_tpu_torch.ops.kernels import build
    from after_tpu_torch.ops.kernels.fused_conv import (backward_weight,
                                                        kernel_weight)

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"card: {cs.card_line()}", flush=True)
    out = os.path.join(root, "build", "bf16_tiles")
    v = variants()
    flibs = build_variants(str(build.CSRC / "fused_snake_conv.cu"), v,
                           os.path.join(out, "forward"))
    blibs = build_variants(str(build.CSRC / "snake_conv_backward.cu"), v,
                           os.path.join(out, "backward"))
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib in flibs.values():
        lib.fused_snake_conv_bf16.argtypes = [P] * 7 + [I] * 8 + [P, P]
        lib.fused_snake_conv_plan_bf16_tiles.argtypes = [I] * 6 + [P]
    for lib in blibs.values():
        lib.snake_conv_backward_dgrad_bf16.argtypes = [P] * 10 + [I] * 8 + [
            P, P]
        lib.snake_conv_backward_plan_bf16_tiles.argtypes = [I] * 6 + [P]
    bf = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(bf)

    def coef(C):
        return (torch.rand(C, device="cuda", generator=gen) + 0.5).to(bf)

    def timed(libs, plan_name, call_name, B, T, C, O, k, d, args):
        res, times = [], {}
        for name, lib in libs.items():
            tiles = (ctypes.c_int * 6)()
            if getattr(lib, plan_name)(B, T, C, O, k, d,
                                       ctypes.addressof(tiles)):
                res.append(f"{name} -")
                continue

            def call():
                err = getattr(lib, call_name)(
                    *args, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            times[name] = cs.cuda_ms(call)
            res.append(f"{name} {tuple(tiles)} {times[name]:.4f}")
        return res, times

    for label, n_samples in (("transfer", cs.N_SAMPLES),
                             ("buffer", (cs.N_FADE + cs.CHUNK) * 2048)):
        total = dict.fromkeys(v, 0.0)
        for (k, d, C, O, T), n in sorted(codec_shapes(n_samples).items()):
            left = get_padding(k, 1, d, "centered")[0]
            x, al, be = rand(1, T, C), coef(C), coef(C)
            w_k = kernel_weight(rand(O, C, k) / (C * k) ** 0.5)[0]
            b = rand(O)
            y = torch.empty(1, T, O, device="cuda", dtype=bf)
            ws = torch.empty(16, 1, T, O, device="cuda")
            res, times = timed(
                flibs, "fused_snake_conv_plan_bf16_tiles",
                "fused_snake_conv_bf16", 1, T, C, O, k, d,
                (x.data_ptr(), al.data_ptr(), be.data_ptr(), w_k.data_ptr(),
                 b.data_ptr(), y.data_ptr(), ws.data_ptr(), 1, T, C, O, k, d,
                 left, w_k.shape[2], None))
            for name in total:
                total[name] += n * times.get(name, float("inf"))
            print(f"{label} forward {(k, d, C, O, T)} x{n}: "
                  + "; ".join(res), flush=True)
        print(f"{label} forward total: " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in total.items()), flush=True)
    total = dict.fromkeys(v, 0.0)
    B = 8
    for (k, d, C, O, T), n in sorted(codec_shapes(131072, ("enc",)).items()):
        left = get_padding(k, 1, d, "centered")[0]
        x, g, al, be = rand(B, T, C), rand(B, T, O), coef(C), coef(C)
        w_k = kernel_weight(rand(O, C, k) / (C * k) ** 0.5)[0]
        wt = backward_weight(w_k, C)
        gx = torch.empty_like(x)
        sums = [torch.empty(m, device="cuda", dtype=bf) for m in (C, C, O)]
        ws = torch.empty(B * T // 64 + 8, 2 * C + O, device="cuda")
        res, times = timed(
            blibs, "snake_conv_backward_plan_bf16_tiles",
            "snake_conv_backward_dgrad_bf16", B, T, C, O, k, d,
            (g.data_ptr(), x.data_ptr(), al.data_ptr(), be.data_ptr(),
             wt.data_ptr(), gx.data_ptr(), ws.data_ptr(),
             *(t.data_ptr() for t in sums), B, T, C, O, k, d, left,
             wt.shape[2], None))
        for name in total:
            total[name] += n * times.get(name, float("inf"))
        print(f"dgrad {(k, d, C, O, T)} x{n}: " + "; ".join(res), flush=True)
    print("dgrad total: " + ", ".join(
        f"{name} {ms:.4f}" for name, ms in total.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
