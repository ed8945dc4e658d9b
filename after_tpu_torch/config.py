"""Typed configuration of the PyTorch port.

The same frozen dataclasses, field names, defaults, presets and JSON form as
the JAX package's configuration, so that one ``config.json`` drives both
packages:

- named presets  (``get_config("base")``, ``get_config("tiny")`` ...),
- overlay composition (``get_config("base", "cycle")``),
- dotted-path overrides (``with_overrides(cfg, {"denoiser.embed_dim": 256})``),
- JSON round-trip (``to_json`` / ``from_json``).

The codec's training configs (``DiscriminatorConfig``, ``AETrainConfig``)
drive ``after_tpu_torch.autoencoder.AutoencoderTrainer``, and
``DiffusionTrainConfig`` drives ``after_tpu_torch.diffusion.trainer.
DiffusionTrainer``.  Fields that only the JAX package reads
(``fused_kernels``, ``rng_impl``) are kept so that the JSON form stays
identical; every alternative the JAX package runs runs in the port
(``diffusion_type="edm"``, the ``v1`` and ``unet1d`` denoisers,
``DiscriminatorConfig(kind="descript")``, ``AutoEncoderConfig.use_noise``
and the encoders' vae modes).
bf16 serving is not a config field: ``TransferPipeline``, ``Streamer`` and
the export commands take ``compute_dtype``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Model component configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DenoiserConfig:
    """DiT denoiser (reference: transformerv2.py:461 DenoiserV2 + base.gin:65-79)."""

    n_channels: int = 64          # latent size of the codec (IN_SIZE, probed at runtime)
    seq_len: int = 128            # N_SIGNAL latent frames
    embed_dim: int = 512
    cond_dim: int = 6             # ZT_CHANNELS (timbre vector)
    tcond_dim: int = 12           # ZS_CHANNELS (per-frame structure)
    noise_embed_dims: int = 64
    n_layers: int = 6
    mlp_multiplier: int = 3
    dropout: float = 0.1
    causal: bool = True
    pos_emb_type: str = "rotary"  # "rotary" | "learnable" | "none"
    local_attention_size: int = 8   # LOCAL_ATTENTION_SIZE (sliding window, frames)
    attention_chunk_size: int = 4   # ATTENTION_CHUNK_SIZE (full attn inside chunk)
    head_dim: int = 64              # heads = embed_dim // head_dim (transformerv2.py:320)
    rotary_dim: int = 32            # RotaryEmbedding(32) (transformerv2.py:406)
    drop_value: float = -4.0        # CFG null-condition fill (model.py:29)
    # streaming cache geometry (transformerv2.py:130-131,147-155)
    max_diffusion_steps: int = 16
    max_batch_size: int = 4
    # JAX parameter layout only ("blocks/block" with a leading layer axis);
    # the port's modules are the same either way and utils.from_jax reads
    # both layouts
    scan_layers: bool = False
    # Backbone selection, mirroring the reference's gin-selectable net slot
    # (base.gin binds @DenoiserV2; transformer.py:555 Denoiser v1 and
    # unet1d.py:255 UNET1D are the alternatives). "unet1d" is offline-only
    # (same as the reference — its conv UNet has no streaming caches).
    arch: str = "v2"                # "v2" | "v1" | "unet1d"
    # v1 knobs (transformer.py:452,585,289; see models/denoiser_v1.py)
    v1_tcond_mode: str = "cross_attention"   # "cross_attention" | "adaln"
    v1_temporal_noise: bool = False
    v1_mlp_type: str = "mlp"                  # "mlp" | "sep_conv"
    v1_cross_attn_causal: bool = False
    # unet1d knobs (unet1d.py:255-296)
    unet_channels: Tuple[int, ...] = (128, 128, 256, 256)
    unet_ratios: Tuple[int, ...] = (2, 2, 2, 2)
    unet_kernel_size: int = 5
    unet_time_cond_channels: int = 64


@dataclass(frozen=True)
class ECAPAConfig:
    """Timbre encoder (reference: ecapa_encoder.py:459 ECAPATDNN + base.gin:26-41)."""

    in_size: int = 64
    out_dim: int = 6
    channels: Tuple[int, ...] = (512, 512, 512, 1024)
    kernel_sizes: Tuple[int, ...] = (3, 3, 3, 3)
    dilations: Tuple[int, ...] = (1, 1, 1, 1)
    groups: Tuple[int, ...] = (1, 1, 1, 1)
    res2net_scale: int = 8
    se_channels: int = 128
    attention_channels: int = 128
    global_context: bool = True
    pooling: bool = True
    use_tanh: bool = False
    spherical_normalisation: bool = False
    regularisation: str = "ac"    # "ac" | "vae" | "none"


@dataclass(frozen=True)
class Encoder1DConfig:
    """Structure encoder / adversarial classifier (reference: encoder.py:117 + base.gin:43-63)."""

    in_size: int = 64
    channels: Tuple[int, ...] = (64, 128, 256, 512, 12)
    ratios: Tuple[int, ...] = (1, 1, 1, 1)
    kernel_size: int = 5
    use_tanh: bool = False
    average_out: bool = False
    upscale_out: bool = False
    spherical_normalization: bool = False
    vae_regularisation: bool = False
    ac_regularisation: bool = True
    causal: bool = True           # encoder_time/convs.get_padding.mode='causal' (base.gin:53)
    dropout: float = 0.15         # encoder.py:54
    # optional FSQ bottleneck on the codes (encoder.py:129,289-290:
    # vector_quantizer); len(levels) must equal the output channel count
    quantizer_levels: Optional[Tuple[int, ...]] = None
    quantizer_noise_dropout: float = 0.0


@dataclass(frozen=True)
class AutoEncoderConfig:
    """Streamable codec (reference: SimpleNetsStream.py:832 AutoEncoder + baseAE.gin:13-52)."""

    sr: int = 44100
    pqmf_bands: int = 16
    pqmf_attenuation: int = 100
    z_channels: int = 64
    base_channels: int = 64
    multipliers: Tuple[int, ...] = (1, 2, 4, 4, 8, 8)
    factors: Tuple[int, ...] = (2, 2, 2, 4, 4)
    dilations: Tuple[int, ...] = (1, 3, 9)
    kernel_size: int = 3
    resnet_groups: int = 8
    num_blocks_per_stage: int = 3       # num_blocks = [3]*len(factors) (SimpleNetsStream.py:861)
    decoder_ratio: float = 1.5
    use_norm: bool = True               # GroupNorm; disable for causal streaming models
    use_loudness: bool = True
    use_noise: bool = False
    bottleneck: str = "relu"            # "relu" | "tanh" | "vae" | "none"
    bottleneck_scale: float = 3.0       # ReluBottleneck scale (baseAE.gin:36-38)
    bottleneck_sigma: float = 0.01
    causal: bool = False                # baseAE.gin keeps centered padding (streaming uses crossfade)
    # read by the JAX package only: the port's ConvBlock1d always takes the
    # fused snake+conv op (ops/kernels/fused_conv.py) but on cached convs
    fused_kernels: bool = False

    @property
    def ratio(self) -> int:
        """Total samples-per-latent-frame compression (wave -> latent)."""
        r = self.pqmf_bands if self.pqmf_bands > 1 else 1
        for f in self.factors:
            r *= f
        return r


@dataclass(frozen=True)
class DiscriminatorConfig:
    """Encodec multi-scale STFT discriminator (reference: encodec_discriminator.py:217 + baseAE.gin:56-66).

    kind="descript" selects the DAC-style MPD/MSD/MRD discriminator instead
    (models/descript_discriminator.py)."""

    kind: str = "encodec"           # "encodec" | "descript"
    filters: int = 64
    n_ffts: Tuple[int, ...] = (206, 334, 542, 876, 1418, 2296)
    hop_lengths: Tuple[int, ...] = (103, 167, 271, 438, 709, 1148)
    win_lengths: Tuple[int, ...] = (206, 334, 542, 876, 1418, 2296)
    normalize_losses: bool = True
    spec_scale_pow: float = 0.5
    weight_feature_matching: float = 20.0
    weight_adversarial: float = 0.0
    # kind="descript" knobs, kept for the shared JSON form
    descript_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    descript_fft_sizes: Tuple[int, ...] = (2048, 1024, 512)
    descript_weight_feature_matching: float = 15.0
    descript_weight_adversarial: float = 1.0


# ---------------------------------------------------------------------------
# Training configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DiffusionTrainConfig:
    """Diffusion trainer knobs (reference: Base.fit gin bindings, base.gin:92-127)."""

    max_steps: int = 1_000_000
    lr: float = 1e-4
    batch_size: int = 32
    n_signal: int = 128                 # latent frames per crop (train.py:26-27)
    # curriculum (model.py:179-212)
    timbre_warmup: int = 100_000        # PHASE_1_STEP
    adversarial_warmup: int = 60_000
    adversarial_loss: str = "cosine"
    adversarial_weight: float = 0.075
    update_classifier_every: int = 3
    stop_training_encoder_step: int = 100_000
    stop_training_encoder_time_step: int = 1_000_000
    train_encoder: bool = True
    train_encoder_time: bool = True
    # CFG dropout
    drop_rate: float = 0.2
    drop_targets: Tuple[int, ...] = (0, 1)
    # latent smoothing noise
    zsem_noise_aug: float = 0.03
    time_cond_noise_aug: float = 0.015
    # encoder regularisation
    regularisation_weight: float = 1.0
    regularisation_warmup: int = 1
    # cycle consistency (cycle.gin)
    cycle_consistency: bool = False
    cycle_start_step: int = 600_000
    cycle_weights: Tuple[float, float] = (0.0, 0.0)
    cycle_mode: str = "interpolant"
    cycle_loss_type: str = "cosine"
    cycle_swap_target: str = "cond"
    cycle_scaling: str = "none"
    # timbre chunk shuffling (model.py:288-298)
    shuffle_zsem: Tuple[int, ...] = (4, 8)
    # logging / ckpt
    steps_valid: int = 10_000
    steps_display: int = 100
    steps_save: int = 25_000
    use_ema: bool = True
    ema_decay: float = 0.999
    grad_clip: float = 10.0
    structure_type: str = "audio"       # "audio" | "midi"
    # mixed precision: forward/backward compute at this dtype ("bfloat16"),
    # master params / optimizer / EMA / losses / norm statistics stay f32
    # (norm statistics in f32). None = pure f32.
    compute_dtype: Optional[str] = None
    # the JAX trainer's random generator (the port ignores it) and the
    # steps per call: DiffusionTrainer.fit runs windows of steps_per_call
    # steps, as the JAX trainer's multi_step does
    rng_impl: Optional[str] = None
    steps_per_call: int = 1


@dataclass(frozen=True)
class AETrainConfig:
    """Codec GAN trainer knobs (reference: trainer.py + baseAE.gin:24-105)."""

    max_steps: int = 1_000_000
    warmup_steps: int = 200_000         # GAN warmup
    lr: float = 1e-4
    lr_decay: float = 0.999996          # ExponentialLR gamma (trainer.py:126-134)
    batch_size: int = 8
    num_signal: int = 131072            # waveform samples per crop (train_autoencoder.py:31)
    update_discriminator_every: int = 4
    freeze_encoder_step: int = 1_500_000
    rec_loss_decay: float = 0.99998     # waveform-loss exponential decay (baseAE.gin:103)
    weight_regularisation_loss: float = 0.1
    warmup_regularisation_loss: int = 100_000
    grad_clip: float = 2.0
    grad_clip_disc: float = 2.0
    # disc_step: one [x ‖ y] conv chain per scale instead of two (identical
    # math; the discriminator's gradients need both chains anyway)
    disc_batched: bool = False
    steps_display: int = 100
    steps_valid: int = 10_000
    steps_save: int = 50_000
    # multi-resolution STFT loss (baseAE.gin:87-100)
    stft_fft_sizes: Tuple[int, ...] = (2048, 1024, 512, 256, 128, 64, 32)
    stft_hop_sizes: Tuple[int, ...] = (512, 256, 128, 64, 32, 16, 8)
    stft_win_lengths: Tuple[int, ...] = (2048, 1024, 512, 256, 128, 64, 32)
    stft_w_sc: float = 1.0
    stft_w_log_mag: float = 1.0
    stft_w_lin_mag: float = 0.0
    perceptual_weighting: bool = True
    # optional extra multiscale (mel-)spectrogram distance
    # (reference SpectralDistance, gin-selectable in waveform_losses)
    spectral_distance_weight: float = 0.0
    spectral_scales: Tuple[int, ...] = (2048, 1024, 512, 256)
    spectral_mels: Tuple[int, ...] = (320, 160, 80, 40)
    # bf16 codec / discriminator and bf16 MR-STFT products: not ported yet
    # (the trainer raises NotImplementedError unless None / False)
    compute_dtype: Optional[str] = None
    stft_bf16_dft: bool = False


@dataclass(frozen=True)
class EDMConfig:
    """EDM (Karras) diffusion hyperparameters.

    The reference CLI advertises ``after train --model edm``
    (after_scripts/train.py:91-93) but the class it imports does not exist in
    the package (SURVEY §2.5) — the surface is dead upstream.  Here it works:
    ``AfterConfig.diffusion_type = "edm"`` selects diffusion/edm.py, which
    reuses the ``SIGMA_DATA`` binding the reference's midi.gin declares but
    never reads.
    """

    sigma_data: float = 0.5     # midi.gin SIGMA_DATA
    # training noise-level distribution: log sigma ~ N(p_mean, p_std)
    p_mean: float = -1.2
    p_std: float = 1.2
    # Karras sampling schedule sigma_i = (max^(1/rho) + i/(n-1)*(min^(1/rho)
    # - max^(1/rho)))^rho, i < n; sigma_n = 0
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0
    # offline sampler order: Heun 2nd-order (2 denoiser calls per step except
    # the last) when True, plain Euler when False.  Streaming is always Euler
    # (one KV-cache slot per step).
    heun: bool = True


# ---------------------------------------------------------------------------
# Top-level config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AfterConfig:
    """Full configuration of a diffusion (timbre-transfer) run."""

    name: str = "base"
    sr: int = 44100
    zs_channels: int = 12
    zt_channels: int = 6
    structure_type: str = "audio"       # "audio" | "midi"
    # sub-configs
    denoiser: DenoiserConfig = field(default_factory=DenoiserConfig)
    encoder: ECAPAConfig = field(default_factory=ECAPAConfig)
    encoder_time: Optional[Encoder1DConfig] = field(default_factory=Encoder1DConfig)
    classifier: Optional[Encoder1DConfig] = field(
        default_factory=lambda: Encoder1DConfig(
            in_size=12, channels=(64, 64, 64, 64, 6), ratios=(1, 2, 2, 2, 1),
            ac_regularisation=False, average_out=True))
    autoencoder: AutoEncoderConfig = field(default_factory=AutoEncoderConfig)
    train: DiffusionTrainConfig = field(default_factory=DiffusionTrainConfig)
    drop_value: float = -4.0
    drop_rate: float = 0.2
    # "rectified" (default, reference base.gin) | "edm" (the reference's
    # `--model edm` surface, dead upstream — see EDMConfig)
    diffusion_type: str = "rectified"
    edm: EDMConfig = field(default_factory=EDMConfig)

    def resolved(self, in_size: int, n_signal: Optional[int] = None) -> "AfterConfig":
        """Bind runtime-probed codec geometry into all sub-configs.

        Mirrors the reference's runtime probe-and-bind of IN_SIZE / N_SIGNAL
        (train.py:71-86): the codec latent size flows into the denoiser and
        both encoders.
        """
        n_signal = n_signal if n_signal is not None else self.train.n_signal
        upd: Dict[str, Any] = {
            "denoiser.n_channels": in_size,
            "denoiser.seq_len": n_signal,
            "encoder.in_size": in_size,
            "train.n_signal": n_signal,
        }
        if self.encoder_time is not None:
            upd["encoder_time.in_size"] = in_size
        return with_overrides(self, upd)


# ---------------------------------------------------------------------------
# Override / preset machinery
# ---------------------------------------------------------------------------


def _replace_path(obj: Any, path: List[str], value: Any) -> Any:
    if len(path) == 1:
        return dataclasses.replace(obj, **{path[0]: value})
    child = getattr(obj, path[0])
    new_child = _replace_path(child, path[1:], value)
    return dataclasses.replace(obj, **{path[0]: new_child})


def with_overrides(cfg: Any, overrides: Dict[str, Any]) -> Any:
    """Apply dotted-path overrides, returning a new frozen config."""
    for key, value in overrides.items():
        cfg = _replace_path(cfg, key.split("."), value)
    return cfg


def to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def _build(cls, d):
    """Rebuild nested dataclasses from a dict (inverse of asdict)."""
    if d is None:
        return None
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = f.type if isinstance(f.type, type) else None
        sub = _SUBCONFIG_TYPES.get((cls, f.name))
        if sub is not None:
            kwargs[f.name] = _build(sub, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


_SUBCONFIG_TYPES = {
    (AfterConfig, "denoiser"): DenoiserConfig,
    (AfterConfig, "encoder"): ECAPAConfig,
    (AfterConfig, "encoder_time"): Encoder1DConfig,
    (AfterConfig, "classifier"): Encoder1DConfig,
    (AfterConfig, "autoencoder"): AutoEncoderConfig,
    (AfterConfig, "train"): DiffusionTrainConfig,
    (AfterConfig, "edm"): EDMConfig,
}


def from_json(s: str) -> AfterConfig:
    return _build(AfterConfig, json.loads(s))


# ---------------------------------------------------------------------------
# Presets (mirror the reference gin files)
# ---------------------------------------------------------------------------


def _base() -> AfterConfig:
    """a2a base config (reference: configs/base.gin)."""
    return AfterConfig()


def _tiny() -> AfterConfig:
    """a2a tiny config (reference: configs/tiny.gin — embed 256, smaller encoders)."""
    cfg = _base()
    return with_overrides(cfg, {
        "name": "tiny",
        "denoiser.embed_dim": 256,
        "encoder.channels": (256, 256, 256, 512),
        "encoder_time.channels": (64, 128, 256, 256, 12),
        "train.max_steps": 800_000,
        "train.adversarial_warmup": 30_000,
    })


def _midi() -> AfterConfig:
    """midi-to-audio config (reference: configs/midi.gin — ZS=128 piano roll,
    no structure encoder / classifier, window 16, PHASE_1_STEP=1)."""
    cfg = _base()
    cfg = with_overrides(cfg, {
        "name": "midi",
        "zs_channels": 128,
        "structure_type": "midi",
        "denoiser.tcond_dim": 128,
        "denoiser.local_attention_size": 16,
        "train.structure_type": "midi",
        "train.timbre_warmup": 1,
        "train.adversarial_weight": 0.0,
        "train.zsem_noise_aug": 0.05,
        "train.time_cond_noise_aug": 0.0,
        "train.drop_targets": (1,),
        "train.steps_save": 50_000,
        "train.stop_training_encoder_step": 1_000_000,
    })
    return dataclasses.replace(cfg, encoder_time=None, classifier=None)


def _cycle_overlay(cfg: AfterConfig) -> AfterConfig:
    """Cycle-consistency overlay (reference: configs/cycle.gin)."""
    return with_overrides(cfg, {
        "train.cycle_consistency": True,
        "train.cycle_loss_type": "mse_margin_0.05",
        "train.cycle_mode": "interpolant",
        "train.cycle_scaling": "ramps",
        "train.cycle_start_step": 600_000,
        "train.cycle_swap_target": "cond",
        "train.cycle_weights": (0.15, 0.15),
    })


def _streaming_overlay(cfg: AfterConfig) -> AfterConfig:
    """Causal/streaming codec overlay (export-ready: causal convs, no norm)."""
    return with_overrides(cfg, {
        "autoencoder.causal": True,
        "autoencoder.use_norm": False,
    })


_PRESETS = {"base": _base, "tiny": _tiny, "midi": _midi}
_OVERLAYS = {"cycle": _cycle_overlay, "streaming": _streaming_overlay}


def get_config(*names: str, **overrides: Any) -> AfterConfig:
    """Compose a config from a preset plus overlays, e.g. get_config("base", "cycle").

    Mirrors the reference CLI's composable ``--config`` list (train.py:21,
    README.md:74-102).
    """
    if not names:
        names = ("base",)
    first, rest = names[0], names[1:]
    if first not in _PRESETS:
        raise KeyError(f"unknown preset {first!r}; available: {sorted(_PRESETS)}")
    cfg = _PRESETS[first]()
    for name in rest:
        if name not in _OVERLAYS:
            raise KeyError(f"unknown overlay {name!r}; available: {sorted(_OVERLAYS)}")
        cfg = _OVERLAYS[name](cfg)
    if overrides:
        cfg = with_overrides(cfg, overrides)
    return cfg


def get_ae_config(**overrides: Any) -> AutoEncoderConfig:
    """Codec preset (reference: configs/baseAE.gin)."""
    cfg = AutoEncoderConfig()
    if overrides:
        cfg = with_overrides(cfg, overrides)
    return cfg


def ae_to_json(cfg: AutoEncoderConfig) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def ae_from_json(s: str) -> AutoEncoderConfig:
    return _build(AutoEncoderConfig, json.loads(s))


def load_codec_config(ckpt_dir: str) -> AutoEncoderConfig:
    """Codec architecture config stored next to a codec checkpoint
    (the baseAE preset when there is none)."""
    import os
    path = os.path.join(ckpt_dir, "config.json")
    if os.path.exists(path):
        with open(path) as f:
            return ae_from_json(f.read())
    return AutoEncoderConfig()
