"""Where the snake+conv backward's kernels spend their time: each kernel
timed as it is and with one piece switched off, on the card.

    python3 scripts/torch_backward_variants.py [--bf16] [--csrc DIR]
                                               [--label NAME]
                                               [--only dgrad|wgrad]

Copies ``snake_conv_backward.cu`` (from ``after_tpu_torch/csrc`` or
``--csrc``, say a parent checkout unpacked under ``build/``) into
``build/backward_variants/<label>/`` with one text edit each (dgrad: no
epilogue, the f32 totals folded only at the end, no low tf32 half of the
weight, no pass over the staged g window, no MMAs; wgrad: no sine in the
activation, no low half of g, the totals folded only at the end, no MMAs;
the bf16 wgrad: no snake, no g fragments, no partial sums written, no
work at all, no split sum, no loads), builds every copy at once with nvcc
and times dgrad and wgrad of each (``--only``: one of the two)
(CUDA events over a CUDA graph of 20 calls, as ``chip_smoke.py:cuda_ms``,
their sum of partials included). f32: at five shapes of a training codec
forward at batch 8. ``--bf16``: the bf16 kernels at every shape of the
codec's encoder at batch 8 x 131072 samples (the 32 bf16 convs of a bf16
generator step), summed over the step. A variant computes wrong
gradients; only its time is read. Prints the card line and a line a
shape: the plan, the bound of each kernel and each variant's ms.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
from collections import Counter

# text edits of the source, each switching one piece off (see
# _variants_common: an edit applies where its text occurs)
VARIANTS = {
    "base": [],
    "dgrad_no_epilogue": [("  if (!p.need_ga) return;\n", "  return;\n"),
                          ("      if (!p.need_ga) continue;\n",
                           "      continue;\n")],
    "dgrad_fold_at_end": [
        ("if ((i + 1) % kFoldD == 0 || i + 1 == n) fold(tot, acc);",
         "if (i + 1 == n) fold(tot, acc);")],
    "dgrad_no_low_half": [
        ("for (int e = tid; e < WE; e += kThreads) {",
         "for (int e = tid; e < 0; e += kThreads) {")],
    # the pass over the staged g window (f32: its tf32 split; bf16 before
    # the redesign: its columns reordered for the fragments)
    "dgrad_no_window": [
        ("  mbar_wait(full, 0);\n  activate(0);",
         "  mbar_wait(full, 0);"),
        ("      mbar_wait(full + (i + 1) % kRing, ((i + 1) / kRing) & 1);\n"
         "      activate(i + 1);",
         "      mbar_wait(full + (i + 1) % kRing, ((i + 1) / kRing) & 1);")],
    "dgrad_no_mma": [("    flush_gb(i);\n    mma(i);", "    flush_gb(i);"),
                     ("          mma<BN>(acc, frag[jj * 4 + s],\n"
                      "                  desc128(wslot + jj * BN * 128 + s * 32));",
                      "          ;")],
    "wgrad_no_sine": [("const float sn = sinf(xv * al_s[nc]);",
                       "const float sn = xv * al_s[nc];"),
                      # since the redesign: snake_conv_bf16.cuh's snake
                      ("fmaf(ib[2 * e], sin_sq(v0 * al[2 * e]), v0)",
                       "fmaf(ib[2 * e], v0 * al[2 * e], v0)"),
                      ("fmaf(ib[2 * e + 1], sin_sq(v1 * al[2 * e + 1]), v1)",
                       "fmaf(ib[2 * e + 1], v1 * al[2 * e + 1], v1)")],
    "wgrad_no_low_half": [("  lo = to_tf32(v - __uint_as_float(hi));",
                           "  lo = 0u;")],
    "wgrad_fold_at_end": [("if ((i + 1) % kFold == 0 || i + 1 == n) {",
                           "if (i + 1 == n) {")],
    "wgrad_no_mma": [
        ("    mma(i);\n    issue(i + 2);\n    if (i + 1 < n) {\n"
         "      cp_async_wait_prev();\n      __syncthreads();     // chunk",
         "    issue(i + 2);\n    if (i + 1 < n) {\n"
         "      cp_async_wait_prev();\n      __syncthreads();     // chunk"),
        ("            wgmma_bf16_mn(acc[u], frag[u * 4 + s], "
         "desc128_mn(xs + s * 2048));", "            ;")],
    # the bf16 wgrad since its redesign: no snake at all, no fragments of
    # g (ldmatrix), no partial sums written (the split sum still runs)
    "wgrad_no_snake": [("          if (c < p.C) {   // else zero, and stays "
                        "zero", "          if (false) {")],
    "wgrad_no_ldmatrix": [
        ("            ldsm_x4_t(frag[u * 4 + s], base + s * 2048);",
         "            frag[u * 4 + s][0] = frag[u * 4 + s][1] =\n"
         "                frag[u * 4 + s][2] = frag[u * 4 + s][3] = base + s;")],
    "wgrad_no_epilogue": [
        ("    if (p.wsplit == 2) {\n      // the second warpgroup's sums",
         "    continue;\n    if (p.wsplit == 2) {\n      // the second "
         "warpgroup's sums")],
    # its fixed costs: the kernel's launch with no work (its split sum
    # still runs), no split sum, no loads (the ring's slots hold stale
    # data)
    "wgrad_no_work": [
        ("    atomicAdd(p.count, 1ull);\n  if (tid == 0) {\n"
         "    for (int s = 0; s < p.ring; ++s) {\n"
         "      bar_init(full + s, 1);\n"
         "      bar_init(empty + s, kConsumers / 32);",
         "    atomicAdd(p.count, 1ull);\n  return;\n  if (tid == 0) {\n"
         "    for (int s = 0; s < p.ring; ++s) {\n"
         "      bar_init(full + s, 1);\n"
         "      bar_init(empty + s, kConsumers / 32);")],
    "wgrad_no_sum": [("  if (e != 0 || parts == 1) return e;\n",
                      "  return e;\n")],
    "wgrad_no_loads": [
        ("          bar_expect(full + slot, (p.tma_x ? kXBox : 0) +\n"
         "                                      (p.tma_g ? p.gboxes * p.win * "
         "128 : 0));\n          if (p.tma_x) tma_3d(",
         "          bar_expect(full + slot, 0);\n          if (false) tma_3d("),
        ("          if (p.tma_g) {\n            for (int gb = 0;",
         "          if (false) {\n            for (int gb = 0;")],
    # the bf16 wgrad before its redesign: g's fragments gathered by 2-byte
    # loads, the activated tile written transposed
    "wgrad_no_gathers": [
        ("          fa[ks][0] = r0[0] | ((uint32_t)r0[kGStride] << 16);\n"
         "          fa[ks][1] = r0[8] | ((uint32_t)r0[kGStride + 8] << 16);\n"
         "          fa[ks][2] = r8[0] | ((uint32_t)r8[kGStride] << 16);\n"
         "          fa[ks][3] = r8[8] | ((uint32_t)r8[kGStride + 8] << 16);",
         "          fa[ks][0] = fa[ks][1] = fa[ks][2] = fa[ks][3] =\n"
         "              0x3f803f80u + sh + ks;")],
    "wgrad_no_transpose": [("        ah[at] = __float2bfloat16_rn(v);",
                            "        ah[e] = __float2bfloat16_rn(v);")],
}
# the pieces of the f32 kernels only
F32_ONLY = ("dgrad_no_low_half", "wgrad_no_low_half")
# the pieces of the bf16 kernels only
BF16_ONLY = ("dgrad_no_window", "wgrad_no_gathers", "wgrad_no_transpose",
             "wgrad_no_snake", "wgrad_no_ldmatrix", "wgrad_no_epilogue",
             "wgrad_no_work", "wgrad_no_sum", "wgrad_no_loads")
# (B, T, C, O, k, dilation) of a training codec forward
SHAPES = [(8, 2048, 384, 384, 3, 3), (8, 256, 768, 768, 3, 9),
          (8, 8192, 64, 64, 3, 1), (8, 2048, 384, 384, 1, 1),
          (8, 4096, 192, 192, 1, 1)]
BATCH, TRAIN_SAMPLES = 8, 131072


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--csrc", default=None)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--only", choices=("dgrad", "wgrad"), default=None)
    args = ap.parse_args()
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
    from after_tpu_torch.utils.device import strict_f32

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    strict_f32()
    print(f"card: {cs.card_line()}", flush=True)
    skip = F32_ONLY if args.bf16 else BF16_ONLY
    variants = {n: e for n, e in VARIANTS.items() if n not in skip and (
        args.only is None or n == "base" or n.startswith(args.only))}
    csrc = args.csrc or str(build.CSRC)
    libs = build_variants(
        os.path.join(csrc, "snake_conv_backward.cu"), variants,
        os.path.join(root, "build", "backward_variants",
                     args.label + ("_bf16" if args.bf16 else "")))
    P, I = ctypes.c_void_p, ctypes.c_int
    sfx = "bf16" if args.bf16 else "f32"
    for lib in libs.values():
        getattr(lib, f"snake_conv_backward_dgrad_{sfx}").argtypes = (
            [P] * 10 + [I] * 8 + [P, P])
        getattr(lib, f"snake_conv_backward_wgrad_{sfx}").argtypes = (
            [P] * 6 + [I] * 8 + [P, P])
        plan_fn = (lib.snake_conv_backward_plan_bf16 if args.bf16
                   else lib.snake_conv_backward_plan)
        plan_fn.argtypes = [I] * 6 + [P]
    if args.bf16:
        shapes = Counter({(BATCH, T, C, O, k, d): n for (k, d, C, O, T), n
                          in codec_shapes(TRAIN_SAMPLES, ("enc",)).items()})
    else:
        shapes = Counter({s: 1 for s in SHAPES})
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    peak = cs.PEAK_BF16_FLOPS if args.bf16 else cs.PEAK_TF32_FLOPS / 3
    elem = 2 if args.bf16 else 4
    totals = Counter()
    print(f"{args.label} {sfx}: per shape (B T C O k d: launches a step; "
          f"the plan; bound dgrad/wgrad ms; each variant's ms)", flush=True)
    for (B, T, C, O, k, d), n in sorted(shapes.items()):
        gen = torch.Generator("cuda").manual_seed(0)
        x = torch.randn(B, T, C, device="cuda", generator=gen).to(dtype)
        g = torch.randn(B, T, O, device="cuda", generator=gen).to(dtype)
        alpha = (torch.rand(C, device="cuda", generator=gen) + 0.5).to(dtype)
        beta = (torch.rand(C, device="cuda", generator=gen) + 0.5).to(dtype)
        w_k = kernel_weight((torch.randn(O, C, k, device="cuda",
                                         generator=gen)
                             / (C * k) ** 0.5).to(dtype))[0]
        left = get_padding(k, 1, d, "centered")[0]
        out = (ctypes.c_int * 5)()
        plan_fn = (libs["base"].snake_conv_backward_plan_bf16 if args.bf16
                   else libs["base"].snake_conv_backward_plan)
        if plan_fn(B, T, C, O, k, d, ctypes.addressof(out)):
            raise SystemExit(f"no plan for {(B, T, C, O, k, d)}")
        plan = tuple(out)
        wt = backward_weight(w_k, C)
        gx = torch.empty_like(x)
        sums = [torch.empty(m, device="cuda", dtype=dtype) for m in (C, C, O)]
        ws = torch.empty(plan[2], 2 * C + O, device="cuda")
        gw = torch.empty_like(w_k)
        ws_w = torch.empty(plan[4], w_k.numel(), device="cuda")
        flops = 2.0 * k * C * O * T * B
        nbytes = {"dgrad": elem * (2 * B * T * C + B * T * O + k * O * C
                                   + 4 * C + O),
                  "wgrad": elem * (B * T * C + B * T * O + 2 * C
                                   + k * O * w_k.shape[2])}
        bound = {kind: 1e3 * max(flops / peak, nbytes[kind] / cs.PEAK_BYTES)
                 for kind in nbytes}
        times = []
        for name, lib in libs.items():
            dgrad_fn = getattr(lib, f"snake_conv_backward_dgrad_{sfx}")
            wgrad_fn = getattr(lib, f"snake_conv_backward_wgrad_{sfx}")

            def dgrad():
                err = dgrad_fn(
                    g.data_ptr(), x.data_ptr(), alpha.data_ptr(),
                    beta.data_ptr(), wt.data_ptr(), gx.data_ptr(),
                    ws.data_ptr(), *(t.data_ptr() for t in sums), B, T, C, O,
                    k, d, left, wt.shape[2], None,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} dgrad: CUDA error {err}")

            def wgrad():
                err = wgrad_fn(
                    x.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
                    g.data_ptr(), gw.data_ptr(), ws_w.data_ptr(), B, T, C, O,
                    k, d, left, w_k.shape[2], None,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} wgrad: CUDA error {err}")
            for kind, fn in (("dgrad", dgrad), ("wgrad", wgrad)):
                if args.only not in (None, kind):
                    continue
                if name == "base" or name.startswith(kind):
                    ms = cs.cuda_ms(fn)
                    totals[f"{name} {kind}"] += n * ms
                    times.append(f"{name} {kind} {ms:.4f}")
        totals["bound dgrad"] += n * bound["dgrad"]
        totals["bound wgrad"] += n * bound["wgrad"]
        print(f"  {(B, T, C, O, k, d)}: {n}; plan {plan}, bound "
              f"{bound['dgrad']:.4f}/{bound['wgrad']:.4f} ms; "
              + "; ".join(times), flush=True)
    if args.bf16:
        print(f"{args.label} {sfx}: per bf16 generator step "
              f"({sum(shapes.values())} launches each): " + ", ".join(
                  f"{key} {v:.4f}" for key, v in totals.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
