"""``after-tpu-torch export`` / ``export_midi`` / ``export_autoencoder``: a
trained run packaged as a streaming artifact (the port's counterpart of
after_tpu/cli/export.py, with the same arguments).

    python -m after_tpu_torch.cli.main export --model_path runs/diff \
        --emb_model_path runs/ae [--nb_steps 4] [--db_path zdb/] [--device cpu]
    python -m after_tpu_torch.cli.main export_autoencoder --model_path runs/ae

``export`` reads a run of ``after-tpu-torch train`` (its ``config.json``
and checkpoint, the EMA weights in the denoiser) and a codec run of
``train_autoencoder`` (its ``codec_vars`` and ``config.json``), builds a
``Streamer`` over them and writes the artifact with
``streaming.export.export_streamer`` (by default to
``<model_path>/after.{audio,midi}.<run>``), traced on ``--device`` (the
card by default: export on the device that will serve).  ``--db_path``
trains the XY pad's projector on the store's timbre vectors and bakes its
maps, ``projector.npz`` and ``map.png`` into the artifact.
``export_autoencoder`` writes the codec-only artifact
(``streaming.export.export_codec``).  ``--compute_dtype bfloat16`` exports
the streamer at bf16 (its weights and state; the XY pad's projector is
trained on f32 timbre vectors and stays f32), as the JAX command does;
``export_autoencoder`` takes the flag and exports in f32, as the JAX
command does too.  ``--native`` also packages the stages
the native host plays (``streaming.native.package_artifact``) for
``--device``.
"""

from __future__ import annotations

import argparse
import os


def build_argparser(cmd: str):
    p = argparse.ArgumentParser(prog=f"after-tpu-torch {cmd}")
    p.add_argument("--model_path", required=True,
                   help="run dir with checkpoints + config.json")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--emb_model_path", default=None,
                   help="codec run dir (a2a/midi export)")
    p.add_argument("--chunk_size", type=int, default=4)
    p.add_argument("--nb_steps", type=int, default=1,
                   help="default diffusion step count (a runtime attribute "
                        "of the artifact)")
    p.add_argument("--guidance_timbre", type=float, default=1.0,
                   help="default timbre guidance (runtime attribute)")
    p.add_argument("--guidance_structure", type=float, default=1.0,
                   help="default structure guidance (runtime attribute)")
    p.add_argument("--latent_range", type=float, default=1.0)
    p.add_argument("--batch_size", type=int, default=1,
                   help="voices batched into one program")
    p.add_argument("--db_path", default=None,
                   help="latent store: train the XY pad's 2-D timbre "
                        "projector on its timbre vectors and bake "
                        "latent2map/map2latent + map.png into the artifact")
    p.add_argument("--map_samples", type=int, default=512,
                   help="dataset records to embed for the timbre map")
    p.add_argument("--map_steps", type=int, default=5000,
                   help="projector training steps")
    p.add_argument("--compute_dtype", default=None,
                   help="reduced-precision compute of the streamer, e.g. "
                        "bfloat16 (export_autoencoder: f32 regardless)")
    p.add_argument("--out", default=None)
    p.add_argument("--crossfade", action="store_true",
                   help="export_autoencoder: force the non-causal crossfade "
                        "streaming path (auto when the codec config is "
                        "non-causal)")
    p.add_argument("--n_fade", type=int, default=4,
                   help="crossfade overlap in latent frames")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card; raises without one) or 'cpu': "
                        "the device the artifact is traced on")
    p.add_argument("--native", action="store_true",
                   help="also package the stages the native host "
                        "(csrc/stream_host.cc) plays, for --device, with "
                        "AOTInductor (minutes a stage at full width, one "
                        "after the other in a process of their own)")
    return p


def _package(cmd: str, out: str, device: str) -> None:
    from ..streaming.native import package_artifact
    done = package_artifact(out, device)
    total = done.pop("total")["cpu_seconds"]
    print(f"[{cmd}] packaged for the native host on {device}: " + ", ".join(
        f"{k} {v['seconds']:.1f} s" for k, v in done.items())
        + f" ({total:.1f} CPU-s in all)")


def load_run(model_path: str, emb_model_path: str, step=None, device=None,
             cmd: str = "export"):
    """(config, ``TransferPipeline``) of a diffusion run of the port and
    its codec run: the run's config with the codec run's own architecture
    (refused where the codec run has no ``config.json`` or its latent size
    is not the denoiser's), the codec's weights, and the diffusion models'
    with the EMA weights in the denoiser."""
    import torch

    from ..config import from_json, load_codec_config, with_overrides
    from ..diffusion.pipeline import TransferPipeline
    from ..utils.checkpoint import restore_checkpoint

    with open(os.path.join(model_path, "config.json")) as f:
        cfg = from_json(f.read())
    codec_cfg_path = os.path.join(emb_model_path, "config.json")
    if not os.path.exists(codec_cfg_path):
        raise SystemExit(
            f"[{cmd}] {codec_cfg_path} not found: the codec run must carry "
            "its architecture config (its config.json)")
    codec_cfg = load_codec_config(emb_model_path)
    if not codec_cfg.causal:
        print(f"[{cmd}] non-causal codec: streaming through the crossfade "
              "path")
    if codec_cfg.z_channels != cfg.denoiser.n_channels:
        raise SystemExit(
            f"[{cmd}] codec z_channels={codec_cfg.z_channels} does not "
            f"match the diffusion model's latent size "
            f"{cfg.denoiser.n_channels}")
    cfg = with_overrides(cfg, {"autoencoder": codec_cfg})

    pipe = TransferPipeline(cfg, device)
    tree = restore_checkpoint(model_path, step)
    models = {"net": pipe.rf.net, "encoder": pipe.rf.encoder,
              "encoder_time": pipe.rf.encoder_time,
              "classifier": pipe.rf.classifier}
    for name, module in models.items():
        if module is not None and name in tree["variables"]:
            module.load_state_dict(tree["variables"][name])
    # the EMA weights into the denoiser (what the JAX export serves)
    params = dict(pipe.rf.net.named_parameters())
    with torch.no_grad():
        for name, value in tree.get("ema_params", {}).items():
            params[name].copy_(value)
    codec_tree = restore_checkpoint(emb_model_path)
    pipe.codec.load_state_dict(codec_tree.get("codec_vars", codec_tree))
    return cfg, pipe


def main(cmd: str, argv=None) -> int:
    import torch

    from ..streaming.export import export_streamer
    from ..streaming.streamer import Streamer

    args = build_argparser(cmd).parse_args(argv)
    if cmd == "export_autoencoder":
        return export_autoencoder(args)
    if not args.emb_model_path:
        raise SystemExit("--emb_model_path (codec run) is required")
    cfg, pipe = load_run(args.model_path, args.emb_model_path, args.step,
                         args.device, cmd)

    projector, embeddings = None, None
    if args.db_path:
        from ..utils.latent_map import (store_timbre_embeddings,
                                        train_projector)
        embeddings = store_timbre_embeddings(pipe, args.db_path,
                                             n_samples=args.map_samples)
        print(f"[{cmd}] training 2-D timbre map on {len(embeddings)} "
              f"embeddings ({args.map_steps} steps)")
        projector = train_projector(embeddings, num_steps=args.map_steps,
                                    device=pipe.device)

    # the weights cast once to the compute dtype, after the projector's
    # embeddings were taken in f32 (the JAX command casts after them too)
    if args.compute_dtype is not None:
        pipe = pipe.with_compute_dtype(args.compute_dtype)
    streamer = Streamer(cfg, chunk_size=args.chunk_size,
                        latent_range=args.latent_range, n_fade=args.n_fade,
                        pipeline=pipe)
    out = args.out or os.path.join(
        args.model_path,
        f"after.{'midi' if cmd == 'export_midi' else 'audio'}."
        f"{os.path.basename(args.model_path.rstrip('/'))}")
    with torch.no_grad():
        export_streamer(streamer, out, nb_steps=args.nb_steps,
                        guidance_timbre=args.guidance_timbre,
                        guidance_structure=args.guidance_structure,
                        batch_size=args.batch_size, projector=projector)
    if projector is not None:
        from ..utils.latent_map import save_projector
        save_projector(out, projector, embeddings)
    print(f"[{cmd}] exported -> {out}")
    if args.native:
        _package(cmd, out, args.device)
    return 0


def export_autoencoder(args) -> int:
    """The codec-only artifact of a codec run: through cached convs for a
    causal codec, through the crossfade path for a non-causal one (or with
    ``--crossfade``)."""
    from ..config import load_codec_config
    from ..streaming.export import export_codec
    from ..utils.checkpoint import restore_checkpoint

    cfg_path = os.path.join(args.model_path, "config.json")
    if not os.path.exists(cfg_path):
        raise SystemExit(f"[export_autoencoder] {cfg_path} not found: the "
                         "codec run must carry its architecture config")
    tree = restore_checkpoint(args.model_path, args.step)
    cfg = load_codec_config(args.model_path)
    crossfade = args.crossfade or not cfg.causal
    out = args.out or os.path.join(args.model_path, "codec_export")
    export_codec(cfg, tree.get("codec_vars", tree), out,
                 chunk_size=args.chunk_size, n_fade=args.n_fade,
                 crossfade=crossfade, device=args.device)
    print(f"[export_autoencoder] exported "
          f"({'crossfade' if crossfade else 'cached-conv'}) -> {out}")
    if args.native:
        _package("export_autoencoder", out, args.device)
    return 0
