"""Offline MIDI-to-audio generation demo, on the PyTorch port.

The port's counterpart of examples/midi_to_audio_demo.py, with its flags:
render a 128-bin piano roll from a .mid file, condition a midi-config
diffusion run (of after_tpu_torch) on it plus a timbre vector extracted
from an audio prompt, sample from unit noise drawn with a generator seeded
0 and decode.  It runs on the card unless ``--device cpu`` is given.

    python examples/torch_midi_to_audio_demo.py \
        --model_path runs/midi --emb_model_path runs/ae \
        --midi in.mid --timbre prompt.wav --out out.wav
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--emb_model_path", required=True)
    p.add_argument("--midi", required=True)
    p.add_argument("--timbre", required=True, help="audio prompt (wav)")
    p.add_argument("--out", default="midi_out.wav")
    p.add_argument("--nb_steps", type=int, default=20)
    p.add_argument("--guidance_timbre", type=float, default=2.0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default, the card) or 'cpu'")
    args = p.parse_args()

    import torch

    from after_tpu_torch.cli.export import load_run
    from after_tpu_torch.dataset.audio import load_wav, save_wav
    from after_tpu_torch.dataset.midi import MidiFile

    cfg, pipe = load_run(args.model_path, args.emb_model_path,
                         device=args.device, cmd="demo")
    if cfg.structure_type != "midi":
        raise SystemExit("use a midi-config model")

    midi = MidiFile(args.midi)
    dur = max(midi.duration(), 1.0)
    ratio = cfg.autoencoder.ratio
    n_frames = int(dur * cfg.sr) // ratio

    # the piano-roll structure, (1, T, 128) in [0, 1]
    times = np.linspace(0, n_frames * ratio / cfg.sr, n_frames)
    roll = (midi.get_piano_roll(times) / 127.0).T[None].astype(np.float32)

    # the timbre vector of the audio prompt
    t_audio, _ = load_wav(args.timbre, sr=cfg.sr)
    n = n_frames * ratio
    t_audio = np.tile(t_audio, int(np.ceil(n / max(len(t_audio), 1))))[:n]
    cond = pipe.timbre(pipe.encode(t_audio[None, :, None]))

    x0 = torch.randn((1, n_frames, cfg.denoiser.n_channels),
                     generator=torch.Generator(pipe.device).manual_seed(0),
                     device=pipe.device)
    z = pipe.diffuse(x0, cond, roll, args.nb_steps, args.guidance_timbre,
                     1.0)
    out = pipe.decode(z)
    save_wav(args.out, out.cpu().numpy()[0, :, 0], cfg.sr)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
