"""Hold the port's training gradients to float64, on the card in strict
f32, on the CPU in f32, on the CPU in float64 and on the card with TF32
allowed:

- codec: chip_smoke.py phase 9's GAN generator step and discriminator step
  (base codec, default discriminator, batch 1 x 16384 samples, fixed
  noise, port-native weights from seed 0);
- diffusion: chip_smoke.py phase 11's cycle step (step 9) and a phase-2
  diffusion step without the cycle (step 3) of ``get_config("base",
  "cycle")`` at batch 4, every dropout 0, fixed draws, port-native weights
  from seed 0.

For each step it prints, per model, the tensors farthest from float64
(each error over the larger of the tensor's max |g| and 1e-3 x the model's
largest gradient) and the medians over tensors, then each loss's or
metric's difference from float64.

    python scripts/torch_train_grads_f64.py [--part codec|diffusion|both]
                                            [--seed N]

The diffusion runs add the card with cuDNN off, beside the others.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from after_tpu_torch.autoencoder import AutoencoderTrainer  # noqa: E402
from after_tpu_torch.config import (AETrainConfig, DiscriminatorConfig,  # noqa: E402
                                    get_ae_config)
from after_tpu_torch.dataset import make_collate_fn  # noqa: E402
from after_tpu_torch.diffusion.trainer import (DiffusionTrainer,  # noqa: E402
                                               shuffle_index)
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


def report(step, runs, ref_key, models):
    """Per model (name, parameter names, index of its gradients in a run):
    the tensors farthest from float64 and the medians over tensors, for
    each run but the reference."""
    kinds = tuple(k for k in runs if k != ref_key)
    for model, names, i in models:
        ref = runs[ref_key][i]
        top = max(g.abs().max().item() for g in ref)
        if top == 0:
            continue
        rows = []
        for j, name in enumerate(names):
            scale = max(ref[j].abs().max().item(), 1e-3 * top)
            rows.append([(runs[k][i][j] - ref[j]).abs().max().item() / scale
                         for k in kinds] + [name])
        for col, label in ((0, "card"), (1, "CPU f32")):
            rows.sort(key=lambda r: -r[col])
            print(f"{step}, {model}: tensors farthest from float64 on the "
                  f"{label} ({', '.join(kinds)}):")
            for r in rows[:4]:
                print("   " + " ".join(f"{v:.3e}" for v in r[:-1])
                      + f" {r[-1]}")
        print(f"{step}, {model}: medians over tensors: " + ", ".join(
            f"{k} {np.median([r[c] for r in rows]):.3e}"
            for c, k in enumerate(kinds)))


def diffusion_trainer(device, source=None, seed=SEED):
    cfg = chip_smoke.diffusion_config(**{
        "denoiser.dropout": 0.0, "encoder_time.dropout": 0.0,
        "classifier.dropout": 0.0,
        "train.batch_size": chip_smoke.DIFF_VS_CPU_BATCH})
    tr = DiffusionTrainer(cfg, device=device)
    if source is None:
        return tr.init(seed)
    tr.rf.load_state_dict(source.rf.state_dict())
    return tr


def diffusion_main(seed: int = SEED) -> None:
    """Phase 11's cycle step and a diffusion step without the cycle, with
    the weights of ``seed``."""
    card = diffusion_trainer("cuda", seed=seed)
    cpu = diffusion_trainer("cpu", card)
    f64 = diffusion_trainer("cpu", card)
    f64.rf.double()
    f64.upload = lambda batch: {k: torch.as_tensor(np.asarray(v),
                                                   dtype=torch.float64)
                                for k, v in batch.items()}
    cfg = card.cfg
    B, T = chip_smoke.DIFF_VS_CPU_BATCH, chip_smoke.DIFF_FRAMES
    C = cfg.denoiser.n_channels
    items = [{"z": z} for z in chip_smoke.synthetic_latents(B, C, 512,
                                                            SEED + 5)]
    batch = make_collate_fn(T, seed=SEED + 5)(items)
    rng = np.random.RandomState(SEED + 5)
    shuffle = shuffle_index(B, T, tuple(cfg.train.shuffle_zsem),
                            torch.Generator().manual_seed(SEED + 5),
                            torch.device("cpu")).numpy()
    draws = {"shuffle": shuffle,
             "cond_noise": rng.randn(B, cfg.zt_channels),
             "time_cond_noise": rng.randn(B, T, cfg.zs_channels),
             "cfg_uniform": rng.uniform(size=B),
             "x0": rng.randn(B, T, C), "t": rng.uniform(size=B),
             "cycle_perm": rng.permutation(B)}
    groups = list(card.groups)
    models = [(g, [n for n, _ in card.groups[g].named_parameters()], 1 + k)
              for k, g in enumerate(groups)]
    for step in (chip_smoke.DIFF_SCHEDULE["train.timbre_warmup"],
                 chip_smoke.DIFF_SCHEDULE["train.stop_training_encoder_step"]):
        flags, weights = card.step_flags(step), card.schedule_weights(step)

        def run(tr, double=False):
            old = torch.get_default_dtype()
            if double:
                torch.set_default_dtype(torch.float64)
            try:
                m, g, _ = tr.train_grads(batch, *flags, *weights, draws=draws)
            finally:
                torch.set_default_dtype(old)
            return ({k: float(v) for k, v in m.items()},
                    *([t.cpu().double() for t in g[name]] for name in groups))

        runs = {"card": run(card), "cpu32": run(cpu), "cpu64": run(f64, True)}
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        runs["tf32"] = run(card)
        strict_f32()
        # the card with cuDNN off: its convolutions through PyTorch's own
        # kernels and cuBLAS, to tell cuDNN's f32 algorithms apart
        torch.backends.cudnn.enabled = False
        runs["card_nocudnn"] = run(card)
        torch.backends.cudnn.enabled = True
        label = f"diffusion step {step} ({card.step_kind(step)}, weights " \
                f"seed {seed})"
        report(label, runs, "cpu64", models)
        for k in ("card", "cpu32", "tf32", "card_nocudnn"):
            print(f"{label}, metrics, {k} - float64: " + ", ".join(
                f"{name} {runs[k][0][name] - v:.3e}"
                for name, v in runs["cpu64"][0].items()))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--part", choices=("codec", "diffusion", "both"),
                        default="both")
    parser.add_argument("--seed", type=int, default=SEED,
                        help="seed of the diffusion model's port-native "
                        "weights")
    args = parser.parse_args()
    part = args.part
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    if part in ("codec", "both"):
        codec_main()
    if part in ("diffusion", "both"):
        diffusion_main(args.seed)
    print(f"card: {chip_smoke.card_line()}")


def codec_main() -> None:
    """Phase 9's GAN generator step and discriminator step."""
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


if __name__ == "__main__":
    main()
