"""Shared by ``torch_forward_variants.py`` and ``torch_backward_variants.py``:
edited copies of a kernel source, each with one piece switched off, built
at once with nvcc under ``build/``, and the codec's snake-conv shapes.

A variant is a list of (old, new) text edits. Each edit whose old text
occurs in the source is applied (every occurrence); an edit that matches
nothing is skipped, so one list can name the same piece in two kernel
bodies of the file (the f32 body and the bf16 one) or in two generations
of a kernel. A variant none of whose edits match is left out, with a
line that says so (the piece is not in this source).
"""

from __future__ import annotations

import ctypes
import os
from collections import Counter


def build_variants(source: str, variants: dict, out: str) -> dict:
    """{name: ctypes.CDLL}: ``source`` (a path) edited by each variant of
    ``variants`` ({name: [(old, new), ...]}), every copy compiled at once
    into ``out``."""
    from after_tpu_torch.ops.kernels import build

    with open(source) as f:
        src = f.read()
    # the headers beside it, inlined, so that an edit can reach them too
    for name in sorted(os.listdir(os.path.dirname(source))):
        if name.endswith(".cuh"):
            with open(os.path.join(os.path.dirname(source), name)) as f:
                src = src.replace(f'#include "{name}"\n', f.read())
    os.makedirs(out, exist_ok=True)
    cmds, libs = [], {}
    for name, edits in variants.items():
        text, hit = src, not edits
        for old, new in edits:
            if old in text:
                text, hit = text.replace(old, new), True
        if not hit:
            print(f"{name}: not in this source (none of its edits match)",
                  flush=True)
            continue
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        libs[name] = os.path.join(out, f"lib{name}.so")
        cmds.append([build._nvcc(), *build.NVCC_FLAGS, "-o", libs[name], cu])
    build._wait(build._start(*cmds))
    return {name: ctypes.CDLL(path) for name, path in libs.items()}


def codec_shapes(n_samples: int, parts=("enc", "enc", "dec")) -> Counter:
    """{(k, dilation, C, O, T): launches} of the base codec's snake convs
    over ``parts`` (a transfer: two encodes and a decode) at
    ``n_samples``."""
    import chip_smoke as cs
    from after_tpu_torch.config import get_ae_config
    from after_tpu_torch.models.autoencoder import AudioCodec

    enc, dec = cs.codec_conv_blocks(AudioCodec(get_ae_config()), n_samples)
    blocks = {"enc": enc, "dec": dec}
    return Counter(cs.block_shape(b, T)[:5] for part in parts
                   for b, T in blocks[part])
