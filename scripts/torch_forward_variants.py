"""Where the snake+conv forward kernels spend their time: the f32 kernel and
its bf16 form timed as they are and with one piece switched off, on the
card.

    python3 scripts/torch_forward_variants.py [--csrc DIR] [--label NAME]

Copies ``fused_snake_conv.cu`` (from ``after_tpu_torch/csrc`` or ``--csrc``,
say a parent checkout unpacked under ``build/``) into
``build/forward_variants/<label>/`` with one text edit each (no sine in
the snake, no activation pass at all, no MMAs), builds every copy at once
with nvcc and times ``fused_snake_conv_f32`` and ``fused_snake_conv_bf16``
of each (CUDA events over a CUDA graph of 20 calls, as
``chip_smoke.py:cuda_ms``, the split sum included where the plan splits)
at every shape of one 524288-sample transfer of the base codec (two
encodes and a decode, batch 1, 96 launches). A variant computes wrong
outputs; only its time is read. Prints the card line, a line a shape (the
plan, each variant's ms) and each variant's ms summed over the transfer
beside the bound (bf16: 989 TFLOP/s or 3.35 TB/s; f32: 3xTF32 at 495
TFLOP/s).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

# text edits of the source, each switching one piece off (see
# _variants_common: an edit applies where its text occurs)
VARIANTS = {
    "base": [],
    # the snake without its sine: x + x^2 alpha^2 / e, the same loads and
    # stores
    "no_sine": [
        ("const float sn = sinf(xv * al);", "const float sn = xv * al;"),
        ("  return (static_cast<int>(j) & 1) ? 1.0f - s2 : s2;",
         "  return y * y;")],
    # the window's activation pass left out: the MMAs read what the buffer
    # holds
    "no_activation": [
        ("  activate(0);\n  __syncthreads();\n  for",
         "  __syncthreads();\n  for"),
        ("      activate(i + 1);\n", ""),
        ("            snake_piece(win + r * 128 + ((q ^ (r & 7)) << 4), al, ib);",
         "            ;")],
    "no_mma": [
        ("    mma(i);\n    issue(i + 2);", "    issue(i + 2);"),
        ("          mma<BN>(acc, frag[jj * 4 + s],\n"
         "                  desc128(wslot + jj * BN * 128 + s * 32));",
         "          ;")],
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", default=None)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    import chip_smoke as cs
    from _variants_common import build_variants, codec_shapes
    from after_tpu_torch.ops.conv import get_padding
    from after_tpu_torch.ops.kernels import build
    from after_tpu_torch.ops.kernels.fused_conv import kernel_weight

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"card: {cs.card_line()}", flush=True)
    csrc = args.csrc or str(build.CSRC)
    libs = build_variants(os.path.join(csrc, "fused_snake_conv.cu"), VARIANTS,
                          os.path.join(root, "build", "forward_variants",
                                       args.label))
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.fused_snake_conv_f32.argtypes = [P] * 8 + [I] * 8 + [P, P]
        lib.fused_snake_conv_bf16.argtypes = [P] * 7 + [I] * 8 + [P, P]
        lib.fused_snake_conv_plan.argtypes = [I] * 6 + [P]
        lib.fused_snake_conv_plan_bf16.argtypes = [I] * 6 + [P]
    shapes = codec_shapes(cs.N_SAMPLES)
    base = libs["base"]
    totals = {(n, dt): 0.0 for n in VARIANTS for dt in ("f32", "bf16")}
    bounds = {"f32": 0.0, "bf16": 0.0}
    print(f"{args.label}: per shape (k d C O T: launches a transfer; per "
          f"type the plan bn/bk/splits and each variant's ms: "
          f"{', '.join(VARIANTS)})", flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    for (k, d, C, O, T), n in sorted(shapes.items()):
        left = get_padding(k, 1, d, "centered")[0]
        x = torch.randn(1, T, C, device="cuda", generator=gen)
        alpha = torch.rand(C, device="cuda", generator=gen) + 0.5
        beta = torch.rand(C, device="cuda", generator=gen) + 0.5
        w = torch.randn(O, C, k, device="cuda", generator=gen) / (C * k) ** .5
        b = torch.randn(O, device="cuda", generator=gen)
        line = []
        for dt in ("f32", "bf16"):
            bf = dt == "bf16"
            cast = (lambda t: t.to(torch.bfloat16)) if bf else (lambda t: t)
            xs, al, be, bs = (cast(t) for t in (x, alpha, beta, b))
            w_k, w_lo = kernel_weight(cast(w))
            out = (ctypes.c_int * 3)()
            plan_fn = (base.fused_snake_conv_plan_bf16 if bf
                       else base.fused_snake_conv_plan)
            if plan_fn(1, T, C, O, k, d, ctypes.addressof(out)):
                raise SystemExit(f"no plan for {(k, d, C, O, T)}")
            plan = tuple(out)
            y = torch.empty(1, T, O, device="cuda", dtype=xs.dtype)
            ws = torch.empty(max(plan[2], 1), 1, T, O, device="cuda")
            flops = 2.0 * k * C * O * T
            elem = 2 if bf else 4
            nbytes = elem * (T * C + 2 * C + O * C * k + O + T * O)
            bounds[dt] += n * 1e3 * max(
                flops / cs.PEAK_BF16_FLOPS if bf
                else 3 * flops / cs.PEAK_TF32_FLOPS, nbytes / cs.PEAK_BYTES)
            times = []
            for name, lib in libs.items():
                def call():
                    s = torch.cuda.current_stream().cuda_stream
                    if bf:
                        err = lib.fused_snake_conv_bf16(
                            xs.data_ptr(), al.data_ptr(), be.data_ptr(),
                            w_k.data_ptr(), bs.data_ptr(), y.data_ptr(),
                            ws.data_ptr(), 1, T, C, O, k, d, left,
                            w_k.shape[2], None, s)
                    else:
                        err = lib.fused_snake_conv_f32(
                            xs.data_ptr(), al.data_ptr(), be.data_ptr(),
                            w_k.data_ptr(), w_lo.data_ptr(), bs.data_ptr(),
                            y.data_ptr(), ws.data_ptr(), 1, T, C, O, k, d,
                            left, w_k.shape[2], None, s)
                    if err:
                        raise RuntimeError(f"{name} {dt}: CUDA error {err}")
                ms = cs.cuda_ms(call)
                totals[name, dt] += n * ms
                times.append(f"{ms:.4f}")
            line.append(f"{dt} {'/'.join(map(str, plan))} "
                        f"{' '.join(times)}")
        print(f"  {k} {d} {C} {O} {T}: {n}; " + "; ".join(line), flush=True)
    for dt in ("f32", "bf16"):
        print(f"{args.label}: {dt} per transfer ({sum(shapes.values())} "
              f"launches), bound {bounds[dt]:.4f} ms: " + ", ".join(
                  f"{name} {totals[name, dt]:.4f}" for name in VARIANTS),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
