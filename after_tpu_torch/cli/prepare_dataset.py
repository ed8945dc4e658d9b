"""``after-tpu-torch prepare_dataset`` and ``update_dataset``: a corpus ->
a record store of codec latents, the port of after_tpu/cli/prepare_dataset.py
with the same arguments and records.

Files are walked by a parser, resampled, normalised, tiled or padded into
``--num_signal`` chunks and silence-gated on the host; the chunks are
encoded with the codec of a port run on the card, batch ``--batch_size``
(the snake+conv kernel on every ``ConvBlock1d`` of the encoder), with
optional pitch/stretch-augmented latents, MIDI slices (from a .mid file or
basic-pitch), descriptors and beat clocks (Beat This or the energy-flux
estimator).  ``--device cpu`` runs the plain PyTorch versions on the CPU.

MIDI slices are stored as the JAX package stores them, ``pickle.dumps`` of
its ``MidiFile`` (written by hand, ``dataset.midi.dumps``), so that the JAX
collate reads the store without torch; ``dataset.midi.loads`` reads them
back onto the port's classes.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Union

import numpy as np
import torch

from ..dataset import AudioExample, RecordReader, RecordWriter
from ..dataset.audio import load_wav, normalize_signal
from ..dataset.midi import MidiFile
from ..dataset.midi import dumps as midi_dumps
from ..dataset.parsers import get_parser
from ..dataset.transforms import (audio_descriptors, estimate_beats,
                                  estimate_downbeats, get_beat_signal,
                                  pitch_shift_time_stretch)
from ..utils.device import resolve_device

KNOWN_DESCRIPTORS = ["centroid", "bandwidth", "rolloff", "flatness", "rms"]


def build_argparser():
    p = argparse.ArgumentParser(prog="after-tpu-torch prepare_dataset")
    p.add_argument("--input_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--parser", default="simple_audio")
    p.add_argument("--emb_model_path", default=None,
                   help="codec run of train_autoencoder (or a JAX run "
                        "converted by scripts/convert_jax_checkpoint.py); "
                        "omit to store waveforms only")
    p.add_argument("--num_signal", type=int, default=524288)
    p.add_argument("--sr", type=int, default=44100)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--normalize", action="store_true", default=True)
    p.add_argument("--cut_silences", action="store_true")
    p.add_argument("--silence_threshold", type=float, default=0.05)
    p.add_argument("--save_waveform", action="store_true")
    p.add_argument("--augmentations", type=int, default=0,
                   help="number of pitch/stretch augmented latent copies")
    p.add_argument("--midi", action="store_true",
                   help="store sliced MIDI per chunk (simple_midi/slakh)")
    p.add_argument("--basic_pitch", default=None,
                   help="path to a basic-pitch torch checkpoint: transcribe "
                        "audio to MIDI when no .mid file exists")
    p.add_argument("--descriptors", action="append", default=None,
                   help="audio descriptors to store per chunk, interpolated "
                        "to the latent frame rate; repeatable, from "
                        "{centroid,bandwidth,rolloff,flatness,rms}, or 'all'")
    p.add_argument("--beat_track", action="store_true",
                   help="store beat_clock/downbeat_clock phase ramps per "
                        "chunk")
    p.add_argument("--beat_this_ckpt", default=None,
                   help="BeatThis torch checkpoint for the RoFormer tracker "
                        "(dataset/beat_tracker.py); omit to use the "
                        "energy-flux estimator")
    p.add_argument("--max_files", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain versions)")
    return p


def _chunk_signal(x: np.ndarray, num_signal: int) -> List[np.ndarray]:
    """Tile short files, pad the tail (dropped when it is a quarter of a
    chunk or less)."""
    if len(x) < num_signal:
        reps = int(np.ceil(num_signal / max(len(x), 1)))
        x = np.tile(x, reps)[:num_signal]
        return [x]
    n = len(x) // num_signal
    chunks = [x[i * num_signal:(i + 1) * num_signal] for i in range(n)]
    rest = x[n * num_signal:]
    if len(rest) > num_signal // 4:
        chunks.append(np.pad(rest, (0, num_signal - len(rest))))
    return chunks


class CodecEncoderFn:
    """The codec of a port run, encoding (B, n) audio batches on ``device``
    to (B, C, T) latents on the host, as the records store them."""

    def __init__(self, ckpt_dir: str,
                 device: Optional[Union[str, torch.device]] = None):
        from ..config import load_codec_config
        from .train import make_codec_coder
        self.cfg = load_codec_config(ckpt_dir)
        self.ratio = self.cfg.ratio
        _, self._encode = make_codec_coder(ckpt_dir, device)

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        z = self._encode(np.asarray(batch, np.float32)[..., None])
        return z.transpose(1, 2).cpu().numpy()


def pitch_stretch_augment(x: np.ndarray, sr: int, rng: np.random.RandomState
                          ) -> np.ndarray:
    """A pitch shift of U(-2, 2) semitones and a time stretch of
    U(0.8, 1.25), drawn from ``rng`` in that order."""
    semitones = rng.uniform(-2, 2)
    stretch = rng.uniform(0.8, 1.25)
    return pitch_shift_time_stretch(x, sr, semitones, stretch)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    descriptor_names = list(args.descriptors or [])
    if descriptor_names == ["all"]:
        descriptor_names = list(KNOWN_DESCRIPTORS)
    unknown = set(descriptor_names) - set(KNOWN_DESCRIPTORS)
    if unknown:  # fail before any audio is loaded or encoded
        raise SystemExit(f"unknown descriptors {sorted(unknown)}; "
                         f"available: {KNOWN_DESCRIPTORS} (or 'all')")
    device = resolve_device(args.device)
    parser = get_parser(args.parser)
    audio_files, midi_files, metadatas = parser(args.input_path)
    if args.max_files:
        audio_files = audio_files[:args.max_files]
        midi_files = midi_files[:args.max_files]
        metadatas = metadatas[:args.max_files]
    print(f"[prepare_dataset] {len(audio_files)} files")

    encoder = (CodecEncoderFn(args.emb_model_path, device)
               if args.emb_model_path else None)
    transcriber = None
    if args.basic_pitch:
        from ..dataset.basic_pitch import BasicPitch, load_torch_weights
        transcriber = BasicPitch(device)
        transcriber.load_state_dict(load_torch_weights(args.basic_pitch))
    beat_tracker = None
    if args.beat_this_ckpt:
        from ..dataset.beat_tracker import Audio2Beats
        beat_tracker = Audio2Beats(args.beat_this_ckpt, device=device)
    z_len = (args.num_signal // encoder.ratio if encoder is not None
             else args.num_signal // 2048)
    duration = args.num_signal / args.sr
    rng = np.random.RandomState(0)

    with RecordWriter(args.output_path) as writer:
        idx = 0
        pending, pending_meta = [], []

        def encode_padded(rows: List[np.ndarray]) -> np.ndarray:
            # the ragged tail is padded with zero rows up to --batch_size,
            # so that every encode has one shape; GroupNorm is per row, so
            # the padding changes no other row
            batch = np.stack(rows)
            if len(rows) < args.batch_size:
                batch = np.concatenate(
                    [batch, np.zeros((args.batch_size - len(rows),)
                                     + batch.shape[1:], np.float32)])
            return encoder(batch)

        def flush():
            nonlocal idx, pending, pending_meta
            if not pending:
                return
            zs = encode_padded(pending) if encoder is not None else None
            # the augmentations of a flush, encoded a slot at a time at the
            # originals' batch shape
            zaugs = []
            if encoder is not None and args.augmentations > 0:
                for _ in range(args.augmentations):
                    augs = []
                    for row in pending:
                        aug = pitch_stretch_augment(row, args.sr, rng)
                        aug = np.pad(aug[:args.num_signal],
                                     (0, max(0, args.num_signal - len(aug))))
                        augs.append(aug.astype(np.float32))
                    zaugs.append(encode_padded(augs))
            for bi in range(len(pending)):
                ae = AudioExample()
                if zs is not None:
                    ae.put_array("z", zs[bi].astype(np.float32))
                if args.save_waveform or encoder is None:
                    ae.put_array("waveform", pending[bi], dtype=np.int16)
                meta, midi = pending_meta[bi]
                ae.put_metadata(meta)
                if midi is not None:
                    ae.put_buffer("midi_bytes", midi, [len(midi)])
                if args.beat_track:
                    if beat_tracker is not None:
                        beats, downs = beat_tracker(pending[bi], args.sr)
                    else:
                        _, beats = estimate_beats(pending[bi], args.sr)
                        downs = estimate_downbeats(pending[bi], args.sr,
                                                   beats)
                    ae.put_array("beat_clock",
                                 get_beat_signal(beats, duration, z_len))
                    ae.put_array("downbeat_clock",
                                 get_beat_signal(downs, duration, z_len))
                if descriptor_names:
                    feats = audio_descriptors(pending[bi], args.sr, z_len)
                    for name in descriptor_names:
                        ae.put_array(name, feats[name])
                for ai, za_batch in enumerate(zaugs):
                    ae.put_array(f"z_aug_{ai}",
                                 np.asarray(za_batch[bi], np.float32))
                writer.put(f"{idx:08d}", ae.serialize())
                idx += 1
            print(f"[prepare_dataset] wrote {idx} examples", flush=True)
            pending, pending_meta = [], []

        for af, mf, meta in zip(audio_files, midi_files, metadatas):
            try:
                x, _ = load_wav(af, sr=args.sr)
            except Exception as e:
                print(f"[prepare_dataset] skip {af}: {e}")
                continue
            if args.normalize:
                x = normalize_signal(x)
            midi = MidiFile(mf) if (args.midi and mf) else None
            if midi is None and transcriber is not None:
                midi = transcriber.transcribe(x, args.sr)
            for ci, chunk in enumerate(_chunk_signal(x, args.num_signal)):
                if (args.cut_silences
                        and np.abs(chunk).max() < args.silence_threshold):
                    continue
                midi_bytes = None
                if midi is not None:
                    t0 = ci * args.num_signal / args.sr
                    midi_bytes = midi_dumps(midi.slice(t0, t0 + duration))
                pending.append(chunk.astype(np.float32))
                pending_meta.append((dict(meta, chunk=str(ci)), midi_bytes))
                if len(pending) >= args.batch_size:
                    flush()
        flush()
    print(f"[prepare_dataset] wrote {idx} examples -> {args.output_path}")
    return 0


def update_main(argv=None) -> int:
    """Re-encode z of every record of a waveform store with a codec run."""
    p = argparse.ArgumentParser(prog="after-tpu-torch update_dataset")
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--emb_model_path", required=True)
    p.add_argument("--sr", type=int, default=44100)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain versions)")
    args = p.parse_args(argv)

    reader = RecordReader(args.dataset_path)
    encoder = CodecEncoderFn(args.emb_model_path,
                             resolve_device(args.device))
    with RecordWriter(args.output_path) as writer:
        for key, raw in reader.items():
            ae = AudioExample(raw)
            z = encoder(ae.get("waveform")[None])[0]
            ae.put_array("z", z.astype(np.float32))
            writer.put(key, ae.serialize())
    print(f"[update_dataset] rewrote {len(reader)} examples")
    return 0
