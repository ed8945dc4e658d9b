"""Hold the port's training gradients to float64: chip_smoke.py phase 9's
GAN generator step and discriminator step (base codec, default
discriminator, batch 1 x 16384 samples, fixed noise, port-native weights
from seed 0) on the card in strict f32, on the CPU in f32, on the CPU in
float64 and on the card with TF32 allowed.  For each step it prints the
tensors farthest from float64 (each error over the larger of the tensor's
max |g| and 1e-3 x the model's largest gradient) and the medians over
tensors, then each loss's difference from float64.

    python scripts/torch_train_grads_f64.py      # on a machine with the card
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from after_tpu_torch.autoencoder import AutoencoderTrainer  # noqa: E402
from after_tpu_torch.config import (AETrainConfig, DiscriminatorConfig,  # noqa: E402
                                    get_ae_config)
from after_tpu_torch.utils.device import strict_f32  # noqa: E402

N = chip_smoke.TRAIN_VS_CPU_SAMPLES
SEED = chip_smoke.SEED


def trainer(device, source=None):
    tc = AETrainConfig(warmup_steps=chip_smoke.TRAIN_WARMUP, batch_size=1,
                       num_signal=N)
    tr = AutoencoderTrainer(get_ae_config(), tc, DiscriminatorConfig(),
                            device=device)
    if source is None:
        return tr.init(SEED)
    tr.codec.load_state_dict(source.codec.state_dict())
    tr.disc.load_state_dict(source.disc.state_dict())
    return tr


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = trainer("cuda")
    cpu = trainer("cpu", card)
    f64 = trainer("cpu", card)
    f64.codec.double()
    f64.disc.double()
    for m in f64.codec.modules():
        # the kept inference weight's tf32 split is for f32 weights only
        if hasattr(m, "kernel_layout"):
            m.kernel_layout = False
    f64._tensor = lambda x: torch.as_tensor(x, device="cpu").double()
    ae = card.cfg
    gen = torch.Generator("cuda").manual_seed(SEED + 4)
    x = chip_smoke.synthetic_audio(gen, 1, N, ae.sr).cpu().numpy()
    noise = np.random.RandomState(SEED + 4).randn(
        1, N // ae.ratio, ae.z_channels).astype(np.float32)
    w = card._recon_weights(chip_smoke.TRAIN_WARMUP + 1)

    def run(tr):
        gm, gg = tr.gen_grads(x, True, *w, noise)
        dm, dg = tr.disc_grads(x, noise)
        return gm, dm, [g.cpu().double() for g in gg], [
            g.cpu().double() for g in dg]

    runs = {"card": run(card), "cpu32": run(cpu), "cpu64": run(f64)}
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    runs["tf32"] = run(card)
    strict_f32()
    kinds = ("card", "cpu32", "tf32")
    for step, module, i in (("generator", card.codec, 2),
                            ("discriminator", card.disc, 3)):
        ref = runs["cpu64"][i]
        top = max(g.abs().max().item() for g in ref)
        rows = []
        for j, (name, _) in enumerate(module.named_parameters()):
            scale = max(ref[j].abs().max().item(), 1e-3 * top)
            rows.append([(runs[k][i][j] - ref[j]).abs().max().item() / scale
                         for k in kinds] + [name])
        for col, label in ((0, "card"), (1, "CPU f32")):
            rows.sort(key=lambda r: -r[col])
            print(f"{step} step, tensors farthest from float64 on the "
                  f"{label} (card, CPU f32, card with TF32):")
            for r in rows[:6]:
                print(f"   {r[0]:.3e} {r[1]:.3e} {r[2]:.3e} {r[3]}")
        print(f"{step} step, medians over tensors: " + ", ".join(
            f"{k} {np.median([r[c] for r in rows]):.3e}"
            for c, k in enumerate(kinds)))
    for k in kinds:
        print(f"losses, {k} - float64: " + ", ".join(
            f"{name} {runs[k][0][name].item() - v.item():.3e}"
            for name, v in runs["cpu64"][0].items()))
    print(f"card: {chip_smoke.card_line()}")


if __name__ == "__main__":
    main()
