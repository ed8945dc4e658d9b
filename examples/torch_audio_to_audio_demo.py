"""Offline audio-to-audio timbre transfer demo, on the PyTorch port.

The port's counterpart of examples/audio_to_audio_demo.py, with its flags:
load a trained diffusion run and its codec run (runs of after_tpu_torch),
encode a structure input and a timbre input, sample the rectified flow
with guidance (timbre 2.0 / structure 1.0 by default), decode, save the
wav.  It runs on the card unless ``--device cpu`` is given.

    python examples/torch_audio_to_audio_demo.py \
        --model_path runs/diff --emb_model_path runs/ae \
        --structure in1.wav --timbre in2.wav --out out.wav \
        --nb_steps 20 --guidance_timbre 2.0
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
    p.add_argument("--structure", required=True)
    p.add_argument("--timbre", required=True)
    p.add_argument("--out", default="transfer_out.wav")
    p.add_argument("--nb_steps", type=int, default=20)
    p.add_argument("--guidance_timbre", type=float, default=2.0)
    p.add_argument("--guidance_structure", type=float, default=1.0)
    p.add_argument("--seconds", type=float, default=11.9)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default, the card) or 'cpu'")
    args = p.parse_args()

    import torch

    from after_tpu_torch.cli.export import load_run
    from after_tpu_torch.dataset.audio import load_wav, save_wav

    cfg, pipe = load_run(args.model_path, args.emb_model_path,
                         device=args.device, cmd="demo")
    ratio = cfg.autoencoder.ratio
    n_samples = (int(args.seconds * cfg.sr) // ratio) * ratio

    def load(path):
        x, _ = load_wav(path, sr=cfg.sr)
        x = np.tile(x, int(np.ceil(n_samples / max(len(x), 1))))[:n_samples]
        return x[None, :, None]

    out = pipe.transfer(load(args.structure), load(args.timbre),
                        args.nb_steps, args.guidance_timbre,
                        args.guidance_structure,
                        generator=torch.Generator(pipe.device).manual_seed(0))
    save_wav(args.out, out.cpu().numpy()[0, :, 0], cfg.sr)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
