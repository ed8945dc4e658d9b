"""How far one codec generator step's f32 gradients stand from float64, on
the card and on the CPU, with and without the MR-STFT's log-magnitude
term: the reading behind chip_smoke.py phase 19's check at trained weights
(``codec_step_witness``).

For the base codec without decoder noise and the Encodec discriminator,
and for the base codec with ``use_noise`` and the descript discriminator
(phase 19's), at the seed's weights and at the weights phase 19(a)'s
training steps leave (CODEC_ALT_WARMUP warm-up generator steps, then
CODEC_ALT_STEPS GAN generator and discriminator steps by turns, at phase
8's batch), it runs one generator step with and without the GAN terms at
batch 1 x TRAIN_VS_CPU_SAMPLES samples, fixed bottleneck and decoder
noise, on the card in f32, on the CPU in f32 and on the card in float64
(the snake+conv by its plain version), and prints each f32 run's distance
from float64 and the card's from the CPU (worst tensor and median, phase
9's measure).

    python scripts/torch_codec_step_conditioning.py
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from after_tpu_torch.autoencoder import AutoencoderTrainer  # noqa: E402
from after_tpu_torch.config import (AETrainConfig, DiscriminatorConfig,  # noqa: E402
                                    get_ae_config)
from after_tpu_torch.models.autoencoder import AudioCodec  # noqa: E402
from after_tpu_torch.ops.kernels.build import load_all  # noqa: E402
from after_tpu_torch.ops.kernels.fused_conv import (  # noqa: E402
    BACKWARD_SOURCE, SOURCE)
from after_tpu_torch.utils.device import strict_f32  # noqa: E402

N = cs.TRAIN_VS_CPU_SAMPLES


def states(ae, dcfg):
    """{"seed": the seed's weights, "trained": phase 19(a)'s steps'}."""
    tc = AETrainConfig(warmup_steps=cs.TRAIN_WARMUP)
    tr = AutoencoderTrainer(ae, tc, dcfg, device="cuda",
                            seed=cs.SEED).init(cs.SEED)

    def snapshot():
        return tuple({k: v.detach().cpu().clone() for k, v in
                      m.state_dict().items()} for m in (tr.codec, tr.disc))
    out = {"seed": snapshot()}
    gen = torch.Generator("cuda").manual_seed(cs.SEED + 19)
    x = cs.synthetic_audio(gen, tc.batch_size, tc.num_signal, ae.sr)
    w_gan = tr._recon_weights(cs.TRAIN_WARMUP + 1)
    for _ in range(cs.CODEC_ALT_WARMUP):
        tr.gen_step(x, False, *tr._recon_weights(0))
    for _ in range(cs.CODEC_ALT_STEPS):
        tr.gen_step(x, True, *w_gan)
        tr.disc_step(x)
    out["trained"] = snapshot()
    return out, w_gan


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    load_all(SOURCE, BACKWARD_SOURCE)
    strict_f32()
    ctc = AETrainConfig(warmup_steps=cs.TRAIN_WARMUP, batch_size=1,
                        num_signal=N)
    for noise, kind in ((False, "encodec"), (True, "descript")):
        ae = get_ae_config(use_noise=noise)
        dcfg = DiscriminatorConfig(kind=kind)
        weights, w_gan = states(ae, dcfg)
        gen = torch.Generator("cuda").manual_seed(cs.SEED + 4)
        xs = cs.synthetic_audio(gen, 1, N, ae.sr).cpu().numpy()
        rng = np.random.RandomState(cs.SEED + 4)
        bn = rng.randn(1, N // ae.ratio, ae.z_channels).astype(np.float32)
        shape = AudioCodec(ae).decoder_noise_shape(1, N // ae.ratio)
        dn = rng.uniform(-1, 1, shape).astype(np.float32) if shape else None
        for label, state in weights.items():
            for use_gan in (False, True):
                for log_mag in (True, False):
                    tc = (ctc if log_mag else
                          dataclasses.replace(ctc, stft_w_log_mag=0.0))
                    args = (ae, dcfg, tc, state)
                    step = (xs, use_gan, w_gan, bn, dn)
                    card = cs.codec_step_grads(*args, "cuda", *step)
                    cpu = cs.codec_step_grads(*args, "cpu", *step)
                    exact = cs.codec_step_grads(*args, "cuda", *step,
                                                double=True)
                    names = card[2]
                    rows = {"card vs f64": (card[1], exact[1]),
                            "cpu vs f64": (cpu[1], exact[1]),
                            "card vs cpu": (card[1], cpu[1])}
                    print(f"{kind} noise {noise}, {label} weights, gan "
                          f"{use_gan}, log-magnitude {log_mag}: " + "; ".join(
                              "{} {:.3e} ({}), median {:.3e}".format(
                                  k, *cs.grad_distance(names, *v))
                              for k, v in rows.items()), flush=True)
    print(f"card: {cs.card_line()}")


if __name__ == "__main__":
    main()
