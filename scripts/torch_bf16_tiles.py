"""The bf16 kernels' plans against their times with each tile forced, on
the card.

    python3 scripts/torch_bf16_tiles.py [--wgrad-only]

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
ms summed over the transfer, the buffer and the bf16 generator step.  The
bf16 wgrad likewise, at the encoder's shapes at batch 8, with its tile
forced (1 or 2 output boxes a consumer warpgroup where k is not a multiple
of 3; the warpgroups on other output boxes or on alternate chunks), each
copy's split of the frame sum its plan's own, and with the plan's cost
model moved (a chunk's fixed cycles, the partial sums' cost, which set the
splits); ``--wgrad-only`` times the wgrad copies alone.
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


def wgrad_variants():
    """The bf16 wgrad with its tile forced, obw{1,2}_ws{1,2}, and with its
    plan's cost model moved."""
    out = {}
    for obw in (1, 2):
        for wsplit in (1, 2):
            out[f"obw{obw}_ws{wsplit}"] = [
                ("  for (int obw = 1; obw <= (kt == 3 ? 1 : 2); ++obw) {",
                 f"  for (int obw = (kt == 3 ? 1 : {obw}); "
                 f"obw <= (kt == 3 ? 1 : {obw}); ++obw) {{"),
                ("    for (int wsplit = 1; wsplit <= 2; ++wsplit) {\n"
                 "      // the second warpgroup would find no output box "
                 "of its own\n"
                 "      if (wsplit == 1 && oboxes <= obw) continue;",
                 f"    for (int wsplit = {wsplit}; wsplit <= {wsplit}; "
                 "++wsplit) {")]
    # the plan's own tiles with its cost model moved: a chunk's fixed
    # cycles, the partial sums' bytes a cycle (which set the splits)
    for name, old, new in (
            ("fix0", "kChunkCycles = 300.0", "kChunkCycles = 0.0"),
            ("fix900", "kChunkCycles = 300.0", "kChunkCycles = 900.0"),
            ("part1200", "kPartBytes = 3600.0", "kPartBytes = 1200.0"),
            ("part10000", "kPartBytes = 3600.0", "kPartBytes = 10000.0")):
        out[name] = [(old, new)]
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
    wgrad_only = "--wgrad-only" in sys.argv[1:]
    v = {} if wgrad_only else variants()
    flibs = build_variants(str(build.CSRC / "fused_snake_conv.cu"), v,
                           os.path.join(out, "forward")) if v else {}
    blibs = build_variants(str(build.CSRC / "snake_conv_backward.cu"), v,
                           os.path.join(out, "backward")) if v else {}
    wv = wgrad_variants()
    wlibs = build_variants(str(build.CSRC / "snake_conv_backward.cu"), wv,
                           os.path.join(out, "wgrad"))
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib in wlibs.values():
        lib.snake_conv_backward_wgrad_bf16.argtypes = [P] * 6 + [I] * 8 + [
            P, P]
        lib.snake_conv_backward_plan_bf16_wgrad.argtypes = [I] * 6 + [P]
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

    def timed(libs, plan_name, call_name, B, T, C, O, k, d, args, n_out=6):
        res, times = [], {}
        for name, lib in libs.items():
            tiles = (ctypes.c_int * n_out)()
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
        if wgrad_only:
            break
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
    B = 8
    wtotal = dict.fromkeys(wv, 0.0)
    for (k, d, C, O, T), n in sorted(codec_shapes(131072, ("enc",)).items()):
        left = get_padding(k, 1, d, "centered")[0]
        x, g, al, be = rand(B, T, C), rand(B, T, O), coef(C), coef(C)
        w_k = kernel_weight(rand(O, C, k) / (C * k) ** 0.5)[0]
        gw = torch.empty_like(w_k)
        ws = torch.empty(1056, w_k.numel(), device="cuda")
        res, times = timed(
            wlibs, "snake_conv_backward_plan_bf16_wgrad",
            "snake_conv_backward_wgrad_bf16", B, T, C, O, k, d,
            (x.data_ptr(), al.data_ptr(), be.data_ptr(), g.data_ptr(),
             gw.data_ptr(), ws.data_ptr(), B, T, C, O, k, d, left,
             w_k.shape[2], None), n_out=8)
        for name in wtotal:
            wtotal[name] += n * times.get(name, float("inf"))
        print(f"wgrad {(k, d, C, O, T)} x{n}: " + "; ".join(res), flush=True)
    print("wgrad total: " + ", ".join(
        f"{name} {ms:.4f}" for name, ms in wtotal.items()), flush=True)
    if wgrad_only:
        return 0
    total = dict.fromkeys(v, 0.0)
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
