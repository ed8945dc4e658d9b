"""``after-tpu-torch serve``: the local web frontend (the port's counterpart
of after_tpu/cli/serve.py, with the same arguments), in one of two modes:

- ``--artifact <dir>``: buffer by buffer through an exported artifact
  (``ExportedStreamer``, its stages replayed as CUDA graphs on the card);
  the XY pad uses the artifact's projector and ``map.png`` when it was
  exported with ``--db_path``;
- ``--model_path`` and ``--emb_model_path``: ``TransferPipeline`` over the
  port's checkpoints.  The projector comes from an artifact under the run
  dir that carries one (``find_artifact_projector``), or ``--store`` trains
  it at serve time.

    python -m after_tpu_torch.cli.main serve \
        --artifact runs/diff/after.audio.diff [--host 127.0.0.1] \
        [--port 8675] [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def build_argparser():
    p = argparse.ArgumentParser(prog="after-tpu-torch serve")
    p.add_argument("--artifact", default=None,
                   help="exported artifact dir: serve its programs instead "
                        "of checkpoints")
    p.add_argument("--model_path", default=None,
                   help="diffusion run dir with checkpoints + config.json")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--emb_model_path", default=None,
                   help="codec run dir")
    p.add_argument("--store", default=None,
                   help="latent store: trains the XY pad's timbre map")
    p.add_argument("--map_samples", type=int, default=512)
    p.add_argument("--map_steps", type=int, default=2000)
    p.add_argument("--nb_steps", type=int, default=None)
    p.add_argument("--max_seconds", type=float, default=12.0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8675,
                   help="0 takes a free port (printed at start)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card; raises without one) or 'cpu'")
    return p


def find_artifact_projector(model_path: str, zt_channels: int, device=None):
    """(projector, artifact dir) of the newest artifact under the run dir
    that carries a projector (``projector.npz``, or a JAX artifact's
    ``projector.msgpack``), else (None, None)."""
    from ..utils.latent_map import (JAX_PROJECTOR_FILE, PROJECTOR_FILE,
                                    load_projector)

    candidates = sorted(
        d for d in os.listdir(model_path)
        if d.startswith(("after.audio", "after.midi"))
        and any(os.path.exists(os.path.join(model_path, d, f))
                for f in (PROJECTOR_FILE, JAX_PROJECTOR_FILE))
    ) if os.path.isdir(model_path) else []
    for d in reversed(candidates):
        art = os.path.join(model_path, d)
        projector = load_projector(art, zt_channels, device)
        if projector is not None:
            return projector, art
    return None, None


def load_frontend(args):
    """``AfterFrontend`` over the checkpoints of ``args``."""
    from ..frontend.server import AfterFrontend
    from .export import load_run

    cfg, pipe = load_run(args.model_path, args.emb_model_path, args.step,
                         args.device, "serve")
    projector, embeddings, art = None, None, None
    if args.store:
        from ..utils.latent_map import (store_timbre_embeddings,
                                        train_projector)
        embeddings = store_timbre_embeddings(pipe, args.store,
                                             n_samples=args.map_samples)
        print(f"[serve] training 2-D timbre map on {len(embeddings)} "
              f"embeddings ({args.map_steps} steps)")
        projector = train_projector(embeddings, num_steps=args.map_steps,
                                    device=pipe.device)
    else:
        projector, art = find_artifact_projector(
            args.model_path, cfg.zt_channels, pipe.device)
        if projector is not None:
            print(f"[serve] loaded pre-trained timbre map from {art}")
    return AfterFrontend(cfg, pipe, projector=projector,
                         embeddings=embeddings,
                         nb_steps=args.nb_steps or 20,
                         max_seconds=args.max_seconds, map_dir=art)


def main(argv=None) -> int:
    from ..frontend.server import ArtifactFrontend, serve

    args = build_argparser().parse_args(argv)
    if args.artifact:
        app = ArtifactFrontend(args.artifact, nb_steps=args.nb_steps,
                               max_seconds=args.max_seconds,
                               device=args.device)
    else:
        if not (args.model_path and args.emb_model_path):
            raise SystemExit("serve needs either --artifact <dir> or "
                             "--model_path + --emb_model_path")
        app = load_frontend(args)
    try:
        serve(app, host=args.host, port=args.port)
    except KeyboardInterrupt:
        pass
    return 0
