"""``after-tpu-torch train_autoencoder``: codec GAN training from a record
store (the port's counterpart of after_tpu/cli/train_autoencoder.py, with
the same arguments, crops, augmentations, checkpoints and logs).

    python -m after_tpu_torch.cli.main train_autoencoder --name ae \\
        --db_path store/ [--device cpu] [--override train.warmup_steps=2]

- random crops of ``num_signal`` samples, with phase mangling (p 0.8) and
  a random gain (p 0.5), from the loader's thread;
- 4 fixed validation batches (seed 1) every ``steps_valid`` steps: the
  validation losses, and the first 4 inputs, 1/3 s of silence and their
  reconstructions as one audio file;
- a checkpoint of the whole train state (``AutoencoderTrainer.state_tree``)
  and the codec's ``config.json`` every ``steps_save`` steps and at the end;
  ``--restart [STEP]`` continues from it (the latest without a step).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(prog="after-tpu-torch train_autoencoder")
    p.add_argument("--name", required=True)
    p.add_argument("--db_path", action="append", required=True)
    p.add_argument("--out_path", default="./after_runs")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_signal", type=int, default=131072)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--restart", type=int, default=None)
    p.add_argument("--streaming", action="store_true",
                   help="causal, norm-free codec for streaming export")
    p.add_argument("--augment", action="store_true", default=True)
    p.add_argument("--override", action="append", default=[],
                   help="dotted config override, repeatable. 'train.*' keys "
                        "set the trainer config (--override "
                        "train.warmup_steps=1000), everything else the "
                        "codec (--override z_channels=16)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card; raises without one) or 'cpu'")
    return p


def make_wave_collate(num_signal: int, augment: bool, seed: int = 0):
    """collate(items) -> (B, num_signal, 1) float32 crops of the items'
    "waveform", zero-padded where shorter, augmented with ``augment``; one
    random stream per loader thread (``thread_rng_factory``)."""
    from ..dataset.collate import thread_rng_factory
    from ..dataset.transforms import random_gain, random_phase_mangle

    get_rng = thread_rng_factory(seed)

    def collate(items):
        rng = get_rng()
        out = []
        for it in items:
            w = np.asarray(it["waveform"], dtype=np.float32).reshape(-1)
            if len(w) <= num_signal:
                w = np.pad(w, (0, num_signal - len(w)))
                i0 = 0
            else:
                i0 = rng.randint(0, len(w) - num_signal)
            w = w[i0:i0 + num_signal]
            if augment:
                if rng.rand() < 0.8:
                    w = random_phase_mangle(w, rng=rng)
                if rng.rand() < 0.5:
                    w = random_gain(w, rng=rng)
            out.append(w)
        return np.stack(out)[..., None]

    return collate


def store_paths(db_paths):
    """{name: path} of the stores, each named by its directory."""
    return {os.path.basename(p.rstrip("/")) or f"db{i}": p
            for i, p in enumerate(db_paths)}


def loader_summary(prog: str, loader) -> str:
    """The loader's line of a run's end: what building batches cost and how
    often the training loop found none ready."""
    ms = 1e3 * loader.batch_seconds / max(loader.batches, 1)
    return (f"[{prog}] loader: {loader.batches} batches built, {ms:.3f} ms "
            f"a batch; the queue was empty at {loader.dry} requests")


def main(argv=None) -> int:
    import torch

    from ..autoencoder import AutoencoderTrainer
    from ..config import AETrainConfig, ae_to_json, get_ae_config
    from ..config import with_overrides
    from ..dataset.dataset import CombinedDataset, DataLoader
    from ..utils.checkpoint import restore_checkpoint, save_checkpoint
    from ..utils.device import resolve_device
    from ..utils.logging import MetricsLogger
    from .train import parse_override_args

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    ae_cfg = get_ae_config(causal=args.streaming,
                           use_norm=not args.streaming)
    tc = AETrainConfig(num_signal=args.num_signal,
                       batch_size=args.batch_size)
    if args.override:
        overrides = parse_override_args(args.override)
        tc_over = {k[len("train."):]: v for k, v in overrides.items()
                   if k.startswith("train.")}
        ae_over = {k: v for k, v in overrides.items()
                   if not k.startswith("train.")}
        if tc_over:
            tc = with_overrides(tc, tc_over)
        if ae_over:
            ae_cfg = with_overrides(ae_cfg, ae_over)
    if args.max_steps:
        tc = dataclasses.replace(tc, max_steps=args.max_steps)

    path_dict = store_paths(args.db_path)
    dataset = CombinedDataset(path_dict, keys=["waveform"], config="train")
    loader = DataLoader(dataset, tc.batch_size,
                        make_wave_collate(tc.num_signal, args.augment),
                        weights=dataset.example_weights)

    # fixed validation batches, drawn once with a pinned seed, so that the
    # validation curve compares across checkpoints
    valset = CombinedDataset(path_dict, keys=["waveform"],
                             config="validation")
    val_batches = []
    if len(valset) > 0:
        val_loader = DataLoader(valset, tc.batch_size,
                                make_wave_collate(tc.num_signal,
                                                  augment=False, seed=1),
                                seed=1)
        it = iter(val_loader)
        try:
            val_batches = list(itertools.islice(it, 4))
        finally:
            it.close()

    model_dir = os.path.join(args.out_path, args.name)
    logger = MetricsLogger(model_dir)
    trainer = AutoencoderTrainer(ae_cfg, tc, device=device).init(0)

    # the codec gives back as many samples as it was given, within a ratio
    with torch.no_grad():
        x = torch.zeros((1, tc.num_signal, 1), device=trainer.device)
        z = torch.zeros((1, tc.num_signal // ae_cfg.ratio, ae_cfg.z_channels),
                        device=trainer.device)
        y = trainer.codec(x, z)[0]
    if abs(y.shape[1] - tc.num_signal) > ae_cfg.ratio:
        raise RuntimeError(f"codec round trip gives {y.shape[1]} samples "
                           f"for {tc.num_signal}")

    if args.restart is not None:
        trainer.load_state_tree(
            restore_checkpoint(model_dir, args.restart or None))
        print(f"[train_autoencoder] restart from {trainer.step}")

    def callback(tr, metrics):
        logger.log(tr.step, metrics)
        if tr.step % tc.steps_save == 0 and tr.step > 0:
            save_checkpoint(model_dir, tr.step, tr.state_tree(),
                            config_json=ae_to_json(ae_cfg))
        if val_batches and tr.step % tc.steps_valid == 0 and tr.step > 0:
            vlosses, (x, y) = tr.validate(val_batches)
            logger.log(tr.step, vlosses)
            logger.flush(tr.step)
            print(f"[train_autoencoder] step {tr.step} "
                  f"val mrstft {vlosses['val_mrstft']:.4f}")
            # true[:4] | 1/3 s of silence | reconstruction[:4], one file
            gap = np.zeros((int(ae_cfg.sr / 3),), np.float32)
            parts = [x[i, :, 0] for i in range(min(4, x.shape[0]))]
            audio = np.concatenate(
                parts + [gap] + [y[i, :, 0]
                                 for i in range(min(4, y.shape[0]))])
            logger.log_audio(tr.step, "validation/audio", audio, ae_cfg.sr)

    print(f"[train_autoencoder] {args.name}: ratio={ae_cfg.ratio}, "
          f"batch={tc.batch_size}, device={trainer.device}")
    batches = iter(loader)
    try:
        trainer.fit(batches, callback=callback)
    finally:
        batches.close()
    save_checkpoint(model_dir, trainer.step, trainer.state_tree(),
                    config_json=ae_to_json(ae_cfg))
    logger.flush(trainer.step)
    logger.close()
    print(loader_summary("train_autoencoder", loader))
    return 0
