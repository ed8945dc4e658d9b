"""``after-tpu-torch import_torch``: a reference PyTorch checkpoint -> a run
directory of the port (the port of after_tpu/cli/import_torch.py, with its
arguments).

A reference codec (``checkpoint<step>.pt``) becomes a codec run that
``export_autoencoder`` and ``prepare_dataset --emb_model_path`` read; a
reference diffusion model (``checkpoint<step>_EMA.pt``) becomes a diffusion
run at step 0 that ``export`` and ``train --restart`` read.  The
architecture comes from the run's own ``config.gin``; the derived config is written as the
run's ``config.json``, the same text as the JAX command writes.  The port
builds its modules from that config, so unlike the JAX command it refuses a
checkpoint without a ``config.gin``.

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
    return p


def count_encoder1d_blocks(sd, prefix: str) -> int:
    """Number of V2EncoderBlock1D stages under ``prefix`` (the final index
    is the out V2ConvBlock1D), read from the state-dict keys."""
    pat = re.compile(re.escape(prefix) + r"net\.(\d+)\.")
    idx = {int(m.group(1)) for k in sd for m in [pat.match(k)] if m}
    return max(idx) if idx else 0


def import_codec(sd, gin_path):
    """(checkpoint tree, config JSON) of a reference codec."""
    from ..config import ae_to_json
    from ..models.autoencoder import AudioCodec
    from ..utils.from_jax import load_module
    from ..utils.gin_import import codec_config_from_gin
    from ..utils.port_torch import map_codec

    cfg = codec_config_from_gin(gin_path)
    n_stages, num_blocks = len(cfg.factors), cfg.num_blocks_per_stage
    use_norm = cfg.use_norm
    params = map_codec(sd, n_stages=n_stages, num_blocks=num_blocks,
                       use_norm=use_norm)
    codec = AudioCodec(cfg)
    load_module(codec, {"params": params}, "codec")
    print(f"[import_torch] codec: stages={n_stages} blocks={num_blocks} "
          f"use_norm={use_norm} causal={cfg.causal} z={cfg.z_channels}")
    return {"codec_vars": codec.state_dict(), "step": 0}, ae_to_json(cfg)


def import_diffusion(sd, gin_path):
    """(checkpoint tree, config JSON) of a reference diffusion model: the
    denoiser (also as the EMA), the timbre encoder and, where the state
    dict holds them, the structure encoder and the classifier; a model the
    state dict lacks keeps its seeded port-native weights."""
    from ..config import to_json
    from ..diffusion.trainer import DiffusionTrainer
    from ..utils.from_jax import load_denoiser, load_module
    from ..utils.gin_import import diffusion_config_from_gin
    from ..utils.port_torch import map_denoiser_v2, map_ecapa, map_encoder1d

    cfg = diffusion_config_from_gin(gin_path)
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
    if not gin_path:
        raise SystemExit("[import_torch] no config.gin beside the checkpoint "
                         "and no --config: the port builds its modules from "
                         "the run's config")
    print(f"[import_torch] deriving architecture from {gin_path}")
    tree, config_json = (import_codec if args.type == "codec"
                         else import_diffusion)(sd, gin_path)
    os.makedirs(args.out, exist_ok=True)
    save_checkpoint(args.out, 0, tree, config_json=config_json)
    print(f"[import_torch] wrote {args.out}/checkpoint_0 + config.json")
    return 0
