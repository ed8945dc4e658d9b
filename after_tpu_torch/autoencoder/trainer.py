"""Codec GAN trainer (counterpart of after_tpu/autoencoder/trainer.py).

- generator step: MR-STFT reconstruction (weight-decayed after the GAN
  warmup) + bottleneck regularisation (warmup-ramped) + the
  discriminator's feature-matching / adversarial terms once the warmup has
  elapsed;
- discriminator step every ``update_discriminator_every`` steps after the
  warmup, hinge loss;
- AdamW (0.9, 0.999) for the codec and (0.8, 0.9) for the discriminator,
  weight decay 0.01, learning rate ``lr * lr_decay ** count``, global-norm
  clip, and no update (moments and count kept) from gradients that are not
  finite: the JAX package's optax chain, update for update
  (``utils/optim.py:AdamW``).

Each step differentiates only what it trains (``torch.autograd.grad`` over
that model's parameters), so no ``.grad`` is kept between steps.  The
bottleneck noise and, with ``use_noise``, the decoder NoiseGenerator's
uniform draw (``decoder_noise``) are arguments of every step; without them
the trainer draws them from its own seeded ``torch.Generator``, fresh at
each step, as the JAX trainer draws them from each step's key.  The
discriminator is the one ``DiscriminatorConfig.kind`` names
(``make_discriminator``).  Everything runs on the
trainer's device, the CUDA card unless the caller passes ``device="cpu"``,
in strict f32.

Mixed precision (``AETrainConfig.compute_dtype="bfloat16"``), as the JAX
trainer runs it: both models' f32 master parameters are cast to bf16
inside each step's forward (``utils.precision.cast_call``), so their
gradients, both optimizers and the checkpoints stay f32; the codec takes
the waveform in bf16, the discriminator the real waveform in bf16 and the
generated one as the codec returns it, and every loss is computed in f32
on the widened outputs.  Each module computes at the promotion of its
input's type and its parameters' (as jnp promotes them): the encoder runs
in bf16 (the snake+conv op's bf16 kernels, forward and backward), while
the bottleneck's f32 noise makes the decoder (its NoiseGenerator too)
and, from there, the discriminator's generated chain compute in f32 with
their bf16 weights widened.
``stft_bf16_dft`` takes the MR-STFT's DFTs with bf16 operands.  The
validation stays f32.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Tuple, Union)

import numpy as np
import torch

from ..config import AETrainConfig, AutoEncoderConfig, DiscriminatorConfig
from ..models.autoencoder import AudioCodec
from ..models.descript_discriminator import DescriptDiscriminator
from ..models.discriminator import EncodecDiscriminator
from ..utils.device import resolve_device, strict_f32
from ..utils.optim import AdamW
from ..utils.precision import cast_call, compute_dtype, to_compute
from .losses import multi_resolution_stft_loss, spectral_distance

ArrayLike = Union[torch.Tensor, np.ndarray]


def make_discriminator(dcfg: DiscriminatorConfig) -> torch.nn.Module:
    """The discriminator ``dcfg.kind`` names: the descript one at its
    periods, FFT sizes and weights, else the Encodec one."""
    if dcfg.kind == "descript":
        return DescriptDiscriminator(
            periods=tuple(dcfg.descript_periods),
            fft_sizes=tuple(dcfg.descript_fft_sizes),
            weight_feature_matching=dcfg.descript_weight_feature_matching,
            weight_adversarial=dcfg.descript_weight_adversarial)
    return EncodecDiscriminator(dcfg)


class AutoencoderTrainer:
    """The codec and its discriminator with their optimizers and the step
    count; ``fit`` alternates generator and discriminator steps as the JAX
    trainer does."""

    def __init__(self, ae_cfg: AutoEncoderConfig,
                 train_cfg: Optional[AETrainConfig] = None,
                 disc_cfg: Optional[DiscriminatorConfig] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        self.cfg = ae_cfg
        self.tc = train_cfg or AETrainConfig()
        self.dcfg = disc_cfg or DiscriminatorConfig()
        # None (f32) or the type both models' forwards run at, their f32
        # masters cast inside each step
        self.compute_dtype = compute_dtype(self.tc.compute_dtype)
        self.device = resolve_device(device)
        strict_f32()
        self.codec = AudioCodec(ae_cfg).to(self.device)
        self.disc = make_discriminator(self.dcfg).to(self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.step = 0
        self._new_optimizers()

    def _new_optimizers(self) -> None:
        tc = self.tc
        self.optimizer = AdamW(self.codec.parameters(), tc.lr, tc.lr_decay,
                               0.9, 0.999, tc.grad_clip)
        self.disc_optimizer = AdamW(self.disc.parameters(), tc.lr,
                                    tc.lr_decay, 0.8, 0.9, tc.grad_clip_disc)

    def init(self, seed: int = 0) -> "AutoencoderTrainer":
        """Port-native random weights from ``seed`` (utils/init.py), fresh
        optimizer states and step 0."""
        from ..utils.init import init_weights
        init_weights(self.codec, seed)
        init_weights(self.disc, seed + 1)
        self._new_optimizers()
        self.step = 0
        return self

    def load_jax(self, codec_vars: Mapping[str, Any],
                 disc_vars: Mapping[str, Any]) -> "AutoencoderTrainer":
        """Weights of the JAX trainer's codec and discriminator, as nested
        dicts of numpy arrays."""
        from ..utils.from_jax import load_discriminator, load_module
        load_module(self.codec, codec_vars, "codec")
        load_discriminator(self.disc, disc_vars)
        return self

    def state_tree(self) -> Dict[str, Any]:
        """The whole train state for ``utils.checkpoint.save_checkpoint``,
        as the JAX CLI saves it: both models' state dicts (``codec_vars``,
        ``disc_vars``), both optimizer states and the step."""
        return {"codec_vars": self.codec.state_dict(),
                "disc_vars": self.disc.state_dict(),
                "opt_state": self.optimizer.state_dict(),
                "disc_opt_state": self.disc_optimizer.state_dict(),
                "step": self.step}

    def load_state_tree(self, tree: Mapping[str, Any]) -> None:
        """Restart from a ``state_tree``: both models' weights, and each
        optimizer state only where it is there and its shapes still fit the
        models, else that optimizer starts fresh."""
        from ..utils.checkpoint import shapes_compatible
        self.codec.load_state_dict(tree["codec_vars"])
        self.disc.load_state_dict(tree["disc_vars"])
        self._new_optimizers()
        for key, opt in (("opt_state", self.optimizer),
                         ("disc_opt_state", self.disc_optimizer)):
            state = tree.get(key)
            if state is None:
                continue
            if shapes_compatible(state, opt.state_dict()):
                opt.load_state_dict(state)
            else:
                print(f"[train_autoencoder] {key} doesn't match the current "
                      "config; optimizer restarts fresh")
        if "opt_state" not in tree:
            print("[train_autoencoder] checkpoint has no optimizer state; "
                  "optimizers restart fresh")
        self.step = int(tree["step"])

    # ------------------------------------------------------------------

    def _tensor(self, x: ArrayLike) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _noise(self, x: torch.Tensor, noise: Optional[ArrayLike],
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The bottleneck's standard normal draw for waveforms x, (B, T /
        ratio, z_channels): ``noise`` when given, else drawn from
        ``generator`` (the trainer's own by default)."""
        shape = (x.shape[0], x.shape[1] // self.cfg.ratio, self.cfg.z_channels)
        if noise is None:
            return torch.randn(shape, generator=generator or self.generator,
                               device=self.device)
        noise = self._tensor(noise)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, "
                             f"expected {shape}")
        return noise

    def _decoder_noise(self, x: torch.Tensor, noise: Optional[ArrayLike],
                       generator: Optional[torch.Generator] = None
                       ) -> Optional[torch.Tensor]:
        """The decoder NoiseGenerator's uniform draw in [-1, 1) for
        waveforms x (``AudioCodec.decoder_noise_shape``): ``noise`` when
        given (the decoder checks it), else drawn from ``generator`` (the
        trainer's own by default); None for a codec without ``use_noise``."""
        if noise is not None:
            return self._tensor(noise)
        shape = self.codec.decoder_noise_shape(
            x.shape[0], x.shape[1] // self.cfg.ratio)
        if shape is None:
            return None
        return torch.rand(shape, generator=generator or self.generator,
                          device=self.device) * 2 - 1

    def _recon_weights(self, step: int) -> Tuple[float, float]:
        tc = self.tc
        w_wave = (1.0 if step < tc.warmup_steps
                  else tc.rec_loss_decay ** (step - tc.warmup_steps))
        w_reg = (min(step / tc.warmup_regularisation_loss, 1.0)
                 * tc.weight_regularisation_loss)
        return w_wave, w_reg

    def _reconstruction(self, x: torch.Tensor, y: torch.Tensor,
                        prefix: str = "") -> Dict[str, torch.Tensor]:
        n = min(x.shape[1], y.shape[1])
        xa, ya = x[:, :n], y[:, :n]
        out = {prefix + "mrstft": multi_resolution_stft_loss(
            xa, ya, self.tc, self.cfg.sr)}
        if self.tc.spectral_distance_weight > 0:
            out[prefix + "spectral_distance"] = spectral_distance(
                xa, ya, self.cfg.sr, self.tc.spectral_scales,
                self.tc.spectral_mels)
        return out

    def gen_grads(self, x: ArrayLike, use_gan: bool, w_wave: float,
                  w_reg: float, noise: Optional[ArrayLike] = None,
                  decoder_noise: Optional[ArrayLike] = None
                  ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """The generator step's metrics and the gradients of its loss for
        each codec parameter (in ``codec.parameters()`` order)."""
        x = self._tensor(x)
        cd = self.compute_dtype
        y, _, _, regloss, _ = cast_call(self.codec, cd, to_compute(x, cd),
                                        self._noise(x, noise),
                                        self._decoder_noise(x, decoder_noise))
        regloss = regloss.float()
        # the loss math in f32, on the widened output
        metrics = self._reconstruction(x, y.float())
        loss = w_wave * metrics["mrstft"] + w_reg * regloss
        metrics["regularisation_loss"] = regloss
        if "spectral_distance" in metrics:
            loss = loss + (w_wave * self.tc.spectral_distance_weight
                           * metrics["spectral_distance"])
        if use_gan:
            n = min(x.shape[1], y.shape[1])
            loss_gen, _, dmetrics = cast_call(
                self.disc, cd, to_compute(x[:, :n], cd), y[:, :n])
            loss = loss + loss_gen.float()
            metrics["feature_matching"] = dmetrics["feature_matching"].float()
            metrics["adversarial"] = dmetrics["adversarial"].float()
        metrics["total_loss"] = loss
        grads = torch.autograd.grad(loss, list(self.codec.parameters()))
        return {k: v.detach() for k, v in metrics.items()}, list(grads)

    def gen_step(self, x: ArrayLike, use_gan: bool, w_wave: float,
                 w_reg: float, noise: Optional[ArrayLike] = None,
                 decoder_noise: Optional[ArrayLike] = None
                 ) -> Dict[str, Any]:
        """One generator update of the codec; its metrics, with the count
        of skipped non-finite updates (``skipped_nonfinite``)."""
        metrics, grads = self.gen_grads(x, use_gan, w_wave, w_reg, noise,
                                        decoder_noise)
        self.optimizer.step(grads)
        # a copy: the optimizer's counter changes in place at its next step
        metrics["skipped_nonfinite"] = self.optimizer.total_notfinite.clone()
        return metrics

    def disc_grads(self, x: ArrayLike, noise: Optional[ArrayLike] = None,
                   decoder_noise: Optional[ArrayLike] = None
                   ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """The discriminator step's metrics and the gradients of its hinge
        loss for each discriminator parameter; the codec runs without
        gradients but draws its bottleneck and decoder noise."""
        x = self._tensor(x)
        cd = self.compute_dtype
        with torch.no_grad():
            y = cast_call(self.codec, cd, to_compute(x, cd),
                          self._noise(x, noise),
                          self._decoder_noise(x, decoder_noise))[0]
        n = min(x.shape[1], y.shape[1])
        _, loss_dis, metrics = cast_call(
            self.disc, cd, to_compute(x[:, :n], cd), y[:, :n],
            batched=self.tc.disc_batched)
        grads = torch.autograd.grad(loss_dis.float(),
                                    list(self.disc.parameters()))
        return {k: v.detach() for k, v in metrics.items()}, list(grads)

    def disc_step(self, x: ArrayLike, noise: Optional[ArrayLike] = None,
                  decoder_noise: Optional[ArrayLike] = None
                  ) -> Dict[str, torch.Tensor]:
        """One update of the discriminator; its metrics."""
        metrics, grads = self.disc_grads(x, noise, decoder_noise)
        self.disc_optimizer.step(grads)
        return metrics

    @torch.no_grad()
    def val_step(self, x: ArrayLike, noise: Optional[ArrayLike] = None,
                 decoder_noise: Optional[ArrayLike] = None
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Reconstruction losses and audio on a validation batch, no GAN
        terms: (metrics, reconstruction cut to the input's length)."""
        x = self._tensor(x)
        y, _, _, regloss, _ = self.codec(x, self._noise(x, noise),
                                         self._decoder_noise(x, decoder_noise))
        metrics = self._reconstruction(x, y, "val_")
        metrics["val_regularisation_loss"] = regloss
        metrics["val_total_loss"] = metrics["val_mrstft"] + regloss
        return metrics, y[:, :x.shape[1]]

    def validate(self, val_batches: Iterable[ArrayLike]):
        """Average ``val_step`` losses over fixed batches, batch i with the
        noise (bottleneck, then decoder) of a generator seeded i; returns
        (losses, (x, y) of the last batch as numpy arrays)."""
        sums: Dict[str, float] = {}
        count = 0
        x = y = None
        for i, batch in enumerate(val_batches):
            x = self._tensor(batch)
            gen = torch.Generator(self.device).manual_seed(i)
            metrics, y = self.val_step(x, self._noise(x, None, gen),
                                       self._decoder_noise(x, None, gen))
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        losses = {k: v / max(count, 1) for k, v in sums.items()}
        return losses, (x.cpu().numpy(), y.cpu().numpy())

    # ------------------------------------------------------------------

    def step_kind(self, step: int) -> str:
        """"disc", "gan" (generator with GAN terms) or "warmup" (generator
        alone): what ``fit`` runs at ``step``."""
        tc = self.tc
        if step > tc.warmup_steps:
            return "disc" if step % tc.update_discriminator_every == 0 \
                else "gan"
        return "warmup"

    def fit(self, batches: Iterable[ArrayLike], max_steps: Optional[int] = None,
            callback: Optional[Callable[["AutoencoderTrainer", Dict], None]]
            = None) -> "AutoencoderTrainer":
        """Train on ``batches`` of (B, num_signal, 1) waveforms until
        ``max_steps`` (``train_cfg.max_steps`` by default); ``callback(self,
        metrics)`` after each step, with the metrics as device tensors."""
        max_steps = max_steps if max_steps is not None else self.tc.max_steps
        for x in batches:
            if self.step >= max_steps:
                break
            kind = self.step_kind(self.step)
            if kind == "disc":
                metrics = self.disc_step(x)
            else:
                w_wave, w_reg = self._recon_weights(self.step)
                metrics = self.gen_step(x, kind == "gan", w_wave, w_reg)
            self.step += 1
            if callback is not None:
                callback(self, metrics)
        return self
