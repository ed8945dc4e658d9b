"""``after-tpu-torch train``: diffusion training from latent record stores
(the port's counterpart of after_tpu/cli/train.py, with the same
arguments, config.json, checkpoints and logs).

    python -m after_tpu_torch.cli.main train --name run --db_path zdb/ \
        [--config base --config cycle] [--emb_model_path codec_run/] \
        [--device cpu]

``main`` probes the latent geometry from the store's first record, builds
the weighted loader (or, with ``--data_on_device``, a ``DeviceLatentBank``
on the card), draws 8 fixed validation batches (seed 1), restarts from a
checkpoint of the port (``--restart``, ``--load_encoders``), and runs
``DiffusionTrainer.fit`` with checkpoints, metrics and validation every
``steps_save`` / ``steps_valid`` steps.  Its validation:

- ``validate``: the mean diffusion loss over the fixed validation batches;
- ``val_transfer_margin``: how far sampled transfers move toward the
  requested timbre, in latent space and, with the codec, across the decode
  and encode round trip;
- ``sample_validation_audio``: true, reconstructed and transferred audio,
  decoded by the codec of ``--emb_model_path``;
- ``make_codec_coder``: the codec's (decode, encode) pair for both, from a
  codec checkpoint of the port (what ``train_autoencoder`` writes).

The flow's noise is an argument of each function; without it each draws it
from a ``torch.Generator`` seeded as the JAX functions seed their keys.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device

Coder = Tuple[Callable[[Any], torch.Tensor], Callable[[Any], torch.Tensor]]


def _encode_conditions(trainer, batch):
    rf = trainer.rf
    cond = rf.encode_timbre(batch["x_cond"])[0]
    tcond = rf.encode_structure(batch["x_time_cond"])[0]
    return cond, tcond


@torch.no_grad()
def validate(trainer, val_batches: Sequence[Dict[str, Any]],
             draws: Optional[Sequence[Tuple[Any, Any]]] = None) -> float:
    """Mean diffusion loss of ``trainer.rf`` (not the EMA, no dropout) over
    the fixed validation batches.  ``draws[i]`` is batch i's (x0, noise
    level: the flow's t or EDM's normal draw of ln sigma); by default both
    come from a generator seeded i."""
    losses = []
    for i, b in enumerate(val_batches):
        batch = trainer.upload(b)
        cond, tcond = _encode_conditions(trainer, batch)
        x = batch["x"]
        if draws is None:
            gen = torch.Generator(trainer.device).manual_seed(i)
            x0 = torch.randn(x.shape, generator=gen, device=trainer.device)
            t = trainer.rf.draw_level(x.shape[0], gen, trainer.device)
        else:
            x0, t = (torch.as_tensor(np.array(v, np.float32),
                                     device=trainer.device) for v in draws[i])
        loss, _ = trainer.rf.diffusion_loss(x, tcond, cond, x0, t)
        losses.append(float(loss))
    return float(np.mean(losses))


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    num = torch.sum(a * b, dim=1)
    den = (torch.linalg.vector_norm(a, dim=1)
           * torch.linalg.vector_norm(b, dim=1) + 1e-9)
    return num / den


@torch.no_grad()
def val_transfer_margin(trainer, val_batches: Sequence[Dict[str, Any]],
                        nb_steps: int = 20, codec: Optional[Coder] = None,
                        gate_guidance: float = 2.0,
                        x0: Optional[Any] = None) -> Dict[str, float]:
    """Transfer proximity on the first validation batch: sample with the
    EMA weights a transfer whose timbre target is each row's neighbour's
    (rolled by one), re-embed it with the timbre encoder and report
    mean[cos(out, target) - cos(out, source)] (``val_transfer_margin``).

    With ``codec`` (``make_codec_coder``) it also samples the first 16 rows
    at ``gate_guidance``, decodes them to audio, encodes them again and
    reports the same margin (``val_transfer_margin_audio``).  ``x0`` is the
    sampler's noise, by default drawn from a generator seeded 0."""
    rf = trainer.rf
    batch = trainer.upload(val_batches[0])
    cond, tcond = _encode_conditions(trainer, batch)
    x = batch["x"]
    tgt = torch.roll(cond, -1, dims=0)
    if x0 is None:
        x0 = torch.randn(x.shape, device=trainer.device,
                         generator=torch.Generator(trainer.device)
                         .manual_seed(0))
    else:
        x0 = torch.as_tensor(np.array(x0, np.float32), device=trainer.device)
    with trainer.ema_weights():
        x_tr = rf.sample(x0, tgt, tcond, nb_steps)
        if codec is not None:
            n = min(16, x.shape[0])     # bounds the decode on big batches
            x_g = rf.sample(x0[:n], tgt[:n], tcond[:n], nb_steps,
                            gate_guidance)
    e_out = rf.encode_timbre(x_tr)[0]
    out = {"val_transfer_margin": float(torch.mean(
        _cosine(e_out, tgt) - _cosine(e_out, cond)))}
    if codec is not None:
        decode, encode = codec
        e_aud = rf.encode_timbre(encode(decode(x_g)))[0]
        out["val_transfer_margin_audio"] = float(torch.mean(
            _cosine(e_aud, tgt[:n]) - _cosine(e_aud, cond[:n])))
    return out


def make_codec_coder(ckpt_dir: str,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Coder:
    """The codec of a port checkpoint (``checkpoint_<step>/`` with the tree
    {"codec_vars": state dict} or the state dict itself, and the codec's
    ``config.json``) as a (decode, encode) pair of latents -> audio and
    audio -> latents on ``device``, the card unless ``"cpu"``."""
    from ..config import load_codec_config
    from ..models.autoencoder import AudioCodec
    from ..utils.checkpoint import restore_checkpoint

    device = resolve_device(device)
    tree = restore_checkpoint(ckpt_dir)
    codec = AudioCodec(load_codec_config(ckpt_dir)).eval().to(device)
    codec.load_state_dict(tree.get("codec_vars", tree))

    def tensor(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    @torch.inference_mode()
    def decode(z) -> torch.Tensor:
        return codec.decode(tensor(z))

    @torch.inference_mode()
    def encode(audio) -> torch.Tensor:
        return codec.encode(tensor(audio))

    return decode, encode


@torch.no_grad()
def sample_validation_audio(trainer, val_batches: Sequence[Dict[str, Any]],
                            codec_decode: Callable[[Any], torch.Tensor],
                            logger, cfg, n: int = 4) -> None:
    """Log true / reconstruction / transfer audio for the first ``n`` rows
    of the first validation batch: the rows decoded as they are, sampled
    with their own timbre and with their neighbour's (rolled by one), with
    the EMA weights; the sampler's noise from a generator seeded with the
    step."""
    rf = trainer.rf
    first = val_batches[0]
    batch = trainer.upload({k: v[:n] for k, v in first.items()})
    cond, tcond = _encode_conditions(trainer, batch)
    x1 = batch["x"]
    gen = torch.Generator(trainer.device).manual_seed(trainer.step)
    x0 = torch.randn(x1.shape, generator=gen, device=trainer.device)
    with trainer.ema_weights():
        x_rec = rf.sample(x0, cond, tcond, 20)
        x_tr = rf.sample(x0, torch.roll(cond, -1, dims=0), tcond, 20)
    for i in range(x1.shape[0]):
        for name, z in (("true", x1), ("reconstruction", x_rec),
                        ("transfer", x_tr)):
            audio = codec_decode(z[i:i + 1])[0, :, 0].cpu().numpy()
            logger.log_audio(trainer.step, f"{name}/{i}", audio, cfg.sr)


def build_argparser():
    p = argparse.ArgumentParser(prog="after-tpu-torch train")
    p.add_argument("--name", required=True)
    p.add_argument("--db_path", action="append", required=True,
                   help="record store path(s); repeatable")
    p.add_argument("--config", action="append", default=None,
                   help="preset then overlays, e.g. --config base --config "
                        "cycle")
    p.add_argument("--emb_model_path", default=None,
                   help="codec run of train_autoencoder, for the "
                        "validation's audio")
    p.add_argument("--out_path", default="./after_runs")
    p.add_argument("--model", default=None, choices=["rectified", "edm"],
                   help="diffusion formulation (default: the config's "
                        "diffusion_type)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--restart", type=int, default=None)
    p.add_argument("--load_encoders", default="1,1,1",
                   help="restart partial-load mask 'encoder,encoder_time,net'")
    p.add_argument("--ae_ratio", type=int, default=2048)
    p.add_argument("--sr", type=int, default=44100)
    p.add_argument("--augmentation_keys", action="append", default=None,
                   help="timbre augmentation buffers to sample x_cond crops "
                        "from; 'all' takes the store's z_aug_* keys")
    p.add_argument("--timbre_limit", type=float, default=None,
                   help="window timbre crops to +/- n_signal*limit frames "
                        "around the target crop")
    p.add_argument("--compute_dtype", default=None,
                   help="mixed-precision compute dtype (not ported: the "
                        "trainer refuses it)")
    p.add_argument("--rng_impl", default=None,
                   choices=["threefry2x128", "rbg"],
                   help="the JAX trainer's generator, kept in config.json "
                        "(the port draws from torch.Generator)")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="trace the first N steps with torch.profiler to "
                        "<run>/profile")
    p.add_argument("--override", action="append", default=[],
                   help="dotted config override, repeatable: "
                        "--override denoiser.embed_dim=256 (value parsed as "
                        "JSON)")
    p.add_argument("--data_on_device", action="store_true",
                   help="keep the latent store on the card and draw each "
                        "batch there (audio structure only)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card; raises without one) or 'cpu'")
    return p


def parse_override_args(pairs):
    """'a.b=v' strings -> {path: value} with JSON-typed values."""
    out = {}
    for pair in pairs:
        key, sep, raw = pair.partition("=")
        if not sep:
            raise ValueError(f"override {pair!r} is not of the form key=value")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        if isinstance(value, list):
            value = tuple(value)
        out[key] = value
    return out


def _restart(trainer, model_dir: str, args) -> None:
    from ..utils.checkpoint import restore_checkpoint
    load_encoders = tuple(bool(int(v)) for v in args.load_encoders.split(","))
    tree = restore_checkpoint(model_dir, args.restart or None)
    trainer.load_state_tree(tree, load_encoders)
    print(f"[train] restarting from step {trainer.step} "
          f"(load_encoders={load_encoders})")


def main(argv=None) -> int:
    from ..config import from_json, get_config, to_json, with_overrides
    from ..dataset.collate import make_collate_fn
    from ..dataset.dataset import CombinedDataset, DataLoader
    from ..diffusion.trainer import DiffusionTrainer
    from ..utils.checkpoint import save_checkpoint
    from ..utils.logging import MetricsLogger, profile_trace
    from .train_autoencoder import loader_summary, store_paths

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    names = tuple(args.config) if args.config else ("base",)
    cfg = get_config(*names)
    if args.override:
        cfg = with_overrides(cfg, parse_override_args(args.override))

    # the latent geometry, from the store's first record
    path_dict = store_paths(args.db_path)
    base_keys = (["z", "midi_bytes", "metadata"]
                 if cfg.structure_type == "midi" else ["z", "metadata"])
    dataset = CombinedDataset(path_dict, keys=base_keys, config="train")

    # timbre augmentation: x_cond crops from the pitch/stretch-augmented
    # latents the store holds
    aug_keys = list(args.augmentation_keys or [])
    if aug_keys == ["all"]:
        aug_keys = sorted(k for k in dataset.example_keys()
                          if k != "z" and "aug" in k)
    if aug_keys:
        print(f"[train] timbre augmentation keys: {aug_keys}")
        dataset.add_buffer_keys(aug_keys)
    in_size = dataset[0]["z"].shape[0]
    cfg = cfg.resolved(in_size=in_size)
    if args.model:
        cfg = with_overrides(cfg, {"diffusion_type": args.model})
    if args.batch_size:
        cfg = with_overrides(cfg, {"train.batch_size": args.batch_size})
    if args.max_steps:
        cfg = with_overrides(cfg, {"train.max_steps": args.max_steps})
    if args.compute_dtype:
        cfg = with_overrides(cfg, {"train.compute_dtype":
                                   args.compute_dtype})
    if args.rng_impl:
        cfg = with_overrides(cfg, {"train.rng_impl": args.rng_impl})

    model_dir = os.path.join(args.out_path, args.name)
    os.makedirs(model_dir, exist_ok=True)
    logger = MetricsLogger(model_dir)

    collate = make_collate_fn(cfg.train.n_signal, cfg.structure_type,
                              args.ae_ratio, args.sr,
                              timbre_limit=args.timbre_limit,
                              timbre_augmentation_keys=tuple(aug_keys))
    loader = DataLoader(dataset, cfg.train.batch_size, collate,
                        weights=dataset.example_weights)
    bank = None
    if args.data_on_device:
        if cfg.structure_type == "midi":
            raise ValueError("--data_on_device supports audio structure "
                             "only (piano rolls are built on the host)")
        from ..dataset.device_bank import DeviceLatentBank
        bank = DeviceLatentBank(dataset, cfg.train.n_signal,
                                aug_keys=tuple(aug_keys),
                                weights=dataset.example_weights,
                                timbre_limit=args.timbre_limit, device=device)
        print(f"[train] device latent bank: {len(dataset)} records, "
              f"{bank.nbytes / 1e6:.1f} MB on {device}")

    # fixed validation batches with pinned seeds, from a collate of their
    # own so that they never move the training collate's streams
    valset = CombinedDataset(path_dict, keys=["z", "metadata"],
                             config="validation")
    val_batches = []
    if len(valset) > 0:
        val_collate = make_collate_fn(
            cfg.train.n_signal, cfg.structure_type, args.ae_ratio, args.sr,
            timbre_limit=args.timbre_limit,
            timbre_augmentation_keys=tuple(aug_keys), seed=1)
        val_loader = DataLoader(valset, cfg.train.batch_size, val_collate,
                                seed=1)
        it = iter(val_loader)
        try:
            val_batches = list(itertools.islice(it, 8))
        finally:
            it.close()

    # a restart continues under the run's own diffusion objective, whose
    # weights have the same shapes under the other one
    run_cfg_path = os.path.join(model_dir, "config.json")
    if args.restart is not None and os.path.exists(run_cfg_path):
        with open(run_cfg_path) as f:
            run_type = from_json(f.read()).diffusion_type
        if run_type != cfg.diffusion_type:
            if args.model:
                print(f"[train] WARNING: --model {args.model} overrides "
                      f"the run's recorded diffusion_type={run_type}; "
                      "the restored weights were trained under the "
                      "other objective")
            else:
                print(f"[train] restart adopts the run's "
                      f"diffusion_type={run_type} (config.json)")
                cfg = with_overrides(cfg, {"diffusion_type": run_type})

    trainer = DiffusionTrainer(cfg, device=device).init(0)
    if args.restart is not None:
        _restart(trainer, model_dir, args)

    spc = max(int(cfg.train.steps_per_call or 1), 1)
    if spc > 1:
        for knob in ("steps_save", "steps_valid", "steps_display"):
            if getattr(cfg.train, knob) % spc:
                print(f"[train] warning: {knob}={getattr(cfg.train, knob)} "
                      f"is not a multiple of steps_per_call={spc}; that "
                      "cadence will not fire (steps advance in windows)")

    codec_coder = (make_codec_coder(args.emb_model_path, device)
                   if args.emb_model_path else None)

    def callback(tr, metrics):
        logger.log(tr.step, metrics, n_steps=spc)
        if tr.step % cfg.train.steps_save == 0 and tr.step > 0:
            save_checkpoint(model_dir, tr.step, tr.state_tree(),
                            config_json=to_json(cfg))
            print(f"[train] saved checkpoint at {tr.step}")
        if (val_batches and tr.step % cfg.train.steps_valid == 0
                and tr.step > 0):
            vloss = validate(tr, val_batches)
            vm = val_transfer_margin(tr, val_batches, codec=codec_coder)
            logger.log(tr.step, {"val_diffusion_loss": vloss, **vm})
            print(f"[train] step {tr.step} val loss {vloss:.4f} "
                  f"transfer_margin {vm['val_transfer_margin']:+.4f}"
                  + (f" audio {vm['val_transfer_margin_audio']:+.4f}"
                     if "val_transfer_margin_audio" in vm else ""))
            if codec_coder is not None:
                sample_validation_audio(tr, val_batches, codec_coder[0],
                                        logger, cfg)

    def batches():
        return (bank.batches(cfg.train.batch_size) if bank is not None
                else iter(loader))

    print(f"[train] {args.name}: in_size={in_size}, "
          f"batch={cfg.train.batch_size}, steps={cfg.train.max_steps}, "
          f"device={device}")
    if args.profile_steps > 0:
        it = batches()
        try:
            with profile_trace(os.path.join(model_dir, "profile")):
                trainer.fit(it, max_steps=trainer.step + args.profile_steps,
                            callback=callback)
        finally:
            it.close()
    it = batches()
    try:
        trainer.fit(it, callback=callback)
    finally:
        it.close()
    save_checkpoint(model_dir, trainer.step, trainer.state_tree(),
                    config_json=to_json(cfg))
    logger.flush(trainer.step)
    logger.close()
    if bank is None:
        print(loader_summary("train", loader))
    return 0
