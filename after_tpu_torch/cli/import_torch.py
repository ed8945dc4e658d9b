"""``after-tpu-torch import_torch``: a reference PyTorch checkpoint -> a run
directory of the port (the port of after_tpu/cli/import_torch.py, with its
arguments).

A reference codec (``checkpoint<step>.pt``) becomes a codec run that
``export_autoencoder`` and ``prepare_dataset --emb_model_path`` read; a
reference diffusion model (``checkpoint<step>_EMA.pt``) becomes a diffusion
run at step 0 that ``export`` and ``train --restart`` read.  The
architecture comes from the run's own ``config.gin``; the derived config is
written as the run's ``config.json``, the same text as the JAX command
writes.  Without a ``config.gin`` the geometry flags (or their defaults,
the JAX command's: 5 stages, 3 blocks, GroupNorm on, 6 layers, 4 ECAPA
blocks, res2net scale 8) are applied to the default config
(``get_ae_config()``, ``get_config("base")``), the modules built from it
and the mapped tensors loaded strictly; the run's ``config.json`` is that
config, which the port's loaders read (the JAX command writes none there).
With a ``config.gin`` a flag that disagrees with it is refused by name: it
could only break the strict load.

The reference tensors are mapped onto the JAX package's parameter trees
(``utils/port_torch.py``) and loaded into the port's modules through
``utils/from_jax.py``.
"""

from __future__ import annotations

import argparse
import os
import re


def build_argparser():
    p = argparse.ArgumentParser(prog="after-tpu-torch import_torch")
    p.add_argument("--checkpoint", required=True, help="reference .pt file")
    p.add_argument("--type", choices=["codec", "diffusion"], required=True)
    p.add_argument("--out", required=True, help="output run directory")
    p.add_argument("--config", default=None,
                   help="reference config.gin (default: the config.gin "
                        "next to --checkpoint, the reference run layout)")
    p.add_argument("--n_stages", type=int, default=None,
                   help="codec: number of down/up stages (default: "
                        "len(factors) from config.gin, else 5)")
    p.add_argument("--num_blocks", type=int, default=None,
                   help="codec: resnet blocks per stage (default: "
                        "len(dilations) from config.gin, else 3)")
    p.add_argument("--use_norm", type=lambda s: bool(int(s)), default=None,
                   help="codec: 1 if the reference model used GroupNorm "
                        "(default from config.gin, else 1)")
    p.add_argument("--n_layers", type=int, default=None,
                   help="diffusion: denoiser layers (default from "
                        "config.gin, else 6)")
    p.add_argument("--n_ecapa_blocks", type=int, default=None)
    p.add_argument("--res2net_scale", type=int, default=None)
    return p


# flag -> (the JAX command's default without a config.gin, the value a
# config gives, the config with that value applied)
def _codec_flags():
    import dataclasses

    def stages(c, n):
        if n > len(c.factors):
            raise SystemExit(f"[import_torch] --n_stages {n}: the default "
                             f"codec has {len(c.factors)} stages; give the "
                             "run's config.gin")
        return dataclasses.replace(c, factors=c.factors[:n],
                                   multipliers=c.multipliers[:n + 1])

    def blocks(c, n):
        if n > len(c.dilations):
            raise SystemExit(f"[import_torch] --num_blocks {n}: the default "
                             f"codec has {len(c.dilations)} dilations; give "
                             "the run's config.gin")
        return dataclasses.replace(c, num_blocks_per_stage=n,
                                   dilations=c.dilations[:n])
    return {"n_stages": (5, lambda c: len(c.factors), stages),
            "num_blocks": (3, lambda c: c.num_blocks_per_stage, blocks),
            "use_norm": (True, lambda c: c.use_norm,
                         lambda c, v: dataclasses.replace(c, use_norm=v))}


def _diffusion_flags():
    import dataclasses

    def layers(c, n):
        return dataclasses.replace(c, denoiser=dataclasses.replace(
            c.denoiser, n_layers=n))

    def ecapa(c, n):
        ch = c.encoder.channels
        return dataclasses.replace(c, encoder=dataclasses.replace(
            c.encoder, channels=(ch[0],) * (n - 1) + (ch[-1],)))

    def scale(c, n):
        return dataclasses.replace(c, encoder=dataclasses.replace(
            c.encoder, res2net_scale=n))
    return {"n_layers": (6, lambda c: c.denoiser.n_layers, layers),
            "n_ecapa_blocks": (4, lambda c: len(c.encoder.channels), ecapa),
            "res2net_scale": (8, lambda c: c.encoder.res2net_scale, scale)}


def config_of(kind, args, gin_path):
    """The run's config: from ``gin_path``, where a flag given must agree
    with it, or else the default config with the flags (or their defaults)
    applied."""
    from ..config import get_ae_config, get_config
    from ..utils.gin_import import (codec_config_from_gin,
                                    diffusion_config_from_gin)

    flags = _codec_flags() if kind == "codec" else _diffusion_flags()
    if gin_path:
        cfg = (codec_config_from_gin if kind == "codec"
               else diffusion_config_from_gin)(gin_path)
        for name, (_, read, _) in flags.items():
            given = getattr(args, name)
            if given is not None and given != read(cfg):
                raise SystemExit(
                    f"[import_torch] --{name} {given} disagrees with "
                    f"{gin_path} ({read(cfg)}): drop the flag, the "
                    "architecture comes from the config.gin")
        return cfg
    if kind == "codec":
        cfg = get_ae_config()
    else:
        cfg = get_config("base")
        cfg = cfg.resolved(in_size=cfg.encoder.in_size)
    for name, (default, _, apply) in flags.items():
        given = getattr(args, name)
        cfg = apply(cfg, default if given is None else given)
    return cfg


def count_encoder1d_blocks(sd, prefix: str) -> int:
    """Number of V2EncoderBlock1D stages under ``prefix`` (the final index
    is the out V2ConvBlock1D), read from the state-dict keys."""
    pat = re.compile(re.escape(prefix) + r"net\.(\d+)\.")
    idx = {int(m.group(1)) for k in sd for m in [pat.match(k)] if m}
    return max(idx) if idx else 0


def import_codec(sd, cfg):
    """(checkpoint tree, config JSON) of a reference codec of ``cfg``."""
    from ..config import ae_to_json
    from ..models.autoencoder import AudioCodec
    from ..utils.from_jax import load_module
    from ..utils.port_torch import map_codec

    n_stages, num_blocks = len(cfg.factors), cfg.num_blocks_per_stage
    use_norm = cfg.use_norm
    params = map_codec(sd, n_stages=n_stages, num_blocks=num_blocks,
                       use_norm=use_norm)
    codec = AudioCodec(cfg)
    load_module(codec, {"params": params}, "codec")
    print(f"[import_torch] codec: stages={n_stages} blocks={num_blocks} "
          f"use_norm={use_norm} causal={cfg.causal} z={cfg.z_channels}")
    return {"codec_vars": codec.state_dict(), "step": 0}, ae_to_json(cfg)


def import_diffusion(sd, cfg):
    """(checkpoint tree, config JSON) of a reference diffusion model of
    ``cfg``: the denoiser (also as the EMA), the timbre encoder and, where
    the state dict holds them, the structure encoder and the classifier; a
    model the state dict lacks keeps its seeded port-native weights."""
    from ..config import to_json
    from ..diffusion.trainer import DiffusionTrainer
    from ..utils.from_jax import load_denoiser, load_module
    from ..utils.port_torch import map_denoiser_v2, map_ecapa, map_encoder1d

    n_layers = cfg.denoiser.n_layers
    n_ecapa = len(cfg.encoder.channels)
    res2net = cfg.encoder.res2net_scale
    trainer = DiffusionTrainer(cfg, device="cpu").init(0)
    net = map_denoiser_v2(sd, n_layers)
    load_denoiser(trainer.rf.net, {"params": net})
    load_module(trainer.rf.encoder, map_ecapa(sd, n_ecapa, res2net),
                "encoder")
    for name in ("encoder_time", "classifier"):
        prefix = name + "."
        module = getattr(trainer.rf, name)
        if module is not None and any(k.startswith(prefix) for k in sd):
            n = count_encoder1d_blocks(sd, prefix)
            load_module(module, map_encoder1d(sd, n, prefix=prefix), name)
            print(f"[import_torch] ported {name} ({n} blocks)")
    trainer._new_state()        # the EMA at the loaded denoiser, step 0
    print(f"[import_torch] diffusion: n_layers={n_layers} "
          f"ecapa_blocks={n_ecapa} res2net={res2net}")
    return trainer.state_tree(), to_json(cfg)


def main(argv=None) -> int:
    from ..utils.checkpoint import save_checkpoint
    from ..utils.gin_import import find_gin_config
    from ..utils.port_torch import load_reference_checkpoint

    args = build_argparser().parse_args(argv)
    sd = load_reference_checkpoint(args.checkpoint)
    gin_path = args.config or find_gin_config(args.checkpoint)
    if gin_path:
        print(f"[import_torch] deriving architecture from {gin_path}")
    else:
        print("[import_torch] no config.gin: the default config with the "
              "geometry flags")
    cfg = config_of(args.type, args, gin_path)
    try:
        tree, config_json = (import_codec if args.type == "codec"
                             else import_diffusion)(sd, cfg)
    except (KeyError, ValueError, RuntimeError) as e:
        if gin_path:
            raise
        raise SystemExit(
            f"[import_torch] the checkpoint does not fit the default "
            f"{args.type} config with the geometry flags ({e!r}): give the "
            "run's config.gin (--config) or the flags of its "
            "geometry") from e
    os.makedirs(args.out, exist_ok=True)
    save_checkpoint(args.out, 0, tree, config_json=config_json)
    print(f"[import_torch] wrote {args.out}/checkpoint_0 + config.json")
    return 0
