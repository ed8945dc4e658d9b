"""Buffer-by-buffer timbre transfer (counterpart of
after_tpu/streaming/streamer.py).

Every method is a step ``(state, inputs) -> (outputs, state)`` over an
explicit :class:`StreamState` that it updates in place:

    forward    audio chunk x2 (structure, timbre) -> audio chunk
    structure  audio chunk -> per-frame structure codes
    timbre     audio chunk -> timbre vector (over a ring of latents)
    diffuse    (structure codes, timbre vector) -> codec latents (KV-cached)
    decode     codec latents -> audio chunk

A causal codec streams exactly through cached convs; a non-causal one (the
base codec) through the crossfade path (streaming/crossfade.py), whose
output lags by ``n_fade`` latent frames (``decode_lag_samples``).

The streamer's modules are the streaming forms of a ``TransferPipeline``'s
and share its parameters: ``Streamer(cfg, pipeline=pipe)`` streams with
``pipe``'s weights, and without ``pipeline`` the streamer builds one
(``streamer.pipeline.init(seed)`` or ``.load_jax(variables)`` then sets the
weights of both).  It runs on the card unless the caller passes
``device="cpu"``.  The sampler's noise ``x0`` is an argument; without it,
it is drawn from the streamer's own generator on its device
(``streamer.generator``, seeded 0).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import AfterConfig
from ..diffusion.pipeline import TransferPipeline
from ..diffusion.rectified_flow import RectifiedFlow
from ..models.autoencoder import AudioCodec, decoder_band_delay
from ..utils.device import resolve_device
from .state import StreamState, clone_state, init_cache

ArrayLike = Union[torch.Tensor, np.ndarray]


def _share(module: nn.Module, source: nn.Module) -> nn.Module:
    """``module`` with ``source``'s parameters and persistent buffers (the
    same tensors, so a later change of either reaches both)."""
    module.load_state_dict(source.state_dict(keep_vars=True), assign=True)
    return module.eval()


class Streamer:
    """Buffer-by-buffer timbre transfer over a ``StreamState``."""

    def __init__(self, cfg: AfterConfig, chunk_size: int = 4,
                 n_fade: int = 4,
                 device: Optional[Union[str, torch.device]] = None, *,
                 pipeline: Optional[TransferPipeline] = None,
                 latent_range: float = 1.0, compute_dtype=None):
        """n_fade: crossfade overlap in latent frames for non-causal codecs
        (ignored for causal ones)."""
        if compute_dtype is not None:
            raise NotImplementedError(
                "the port streams in f32 only: compute_dtype is not ported")
        if pipeline is None:
            pipeline = TransferPipeline(cfg, device)
        elif device is not None and resolve_device(device) != pipeline.device:
            raise ValueError(f"the pipeline runs on {pipeline.device}, "
                             f"not {device}")
        self.cfg = cfg
        self.pipeline = pipeline
        self.device = pipeline.device
        self.chunk_size = chunk_size
        self.latent_range = latent_range
        self.ratio = cfg.autoencoder.ratio
        self.audio_chunk = chunk_size * self.ratio
        self.n_signal_timbre = cfg.train.n_signal
        # polyphony of the MIDI note-pair surface
        self.n_poly = 8
        self.is_midi = cfg.structure_type == "midi"
        if self.is_midi and cfg.zs_channels != 128:
            raise ValueError(
                "midi models use the 128-bin piano roll as structure "
                f"(zs_channels=128); config has {cfg.zs_channels}")

        if cfg.autoencoder.causal:
            self.crossfade = None
            self.codec = AudioCodec(cfg.autoencoder, streaming=True)
        else:
            from .crossfade import CrossfadeDecoder
            self.crossfade = CrossfadeDecoder(cfg.autoencoder, n_fade=n_fade,
                                              chunk_size=chunk_size)
            self.codec = self.crossfade.codec
        _share(self.codec.to(self.device), pipeline.codec)
        self.rf = _share(RectifiedFlow(cfg, streaming=True).to(self.device),
                         pipeline.rf)
        self.generator = torch.Generator(self.device).manual_seed(0)

    def _tensor(self, x: ArrayLike) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------

    @torch.no_grad()
    def init_state(self, batch_size: int = 1) -> StreamState:
        """Zeroed stream state for ``batch_size`` parallel voices.  Every
        buffer is allocated here once; each step writes into it in place."""
        cfg = self.cfg
        B, A, T = batch_size, self.audio_chunk, self.chunk_size
        z_ch = cfg.autoencoder.z_channels

        def zeros(*shape):
            return torch.zeros(shape, device=self.device)

        if self.crossfade is not None:
            enc = self.crossfade.init_encode_state(B)
            dec = self.crossfade.init_state(B)
        else:
            enc = init_cache(lambda c: self.codec.encode(zeros(B, A, 1), c))
            dec = init_cache(lambda c: self.codec.decode(zeros(B, T, z_ch),
                                                         c))
        et = (init_cache(lambda c: self.rf.encoder_time(zeros(B, T, z_ch), c))
              if self.rf.encoder_time is not None else {})
        dn = init_cache(lambda c: self.rf.net(
            zeros(3 * B, T, cfg.denoiser.n_channels), zeros(3 * B),
            zeros(3 * B, cfg.zt_channels), zeros(3 * B, T, cfg.zs_channels),
            cache=c))
        return StreamState(codec_struct=enc, codec_timbre=clone_state(enc),
                           codec_dec=dec, enc_time=et, denoiser=dn,
                           prev_timbre=zeros(B, self.n_signal_timbre, z_ch))

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _codec_encode(self, cache, audio: torch.Tensor) -> torch.Tensor:
        if self.crossfade is not None:
            return self.crossfade.encode(cache, audio)
        return self.codec.encode(audio, cache)

    @torch.no_grad()
    def structure(self, state: StreamState, audio: ArrayLike
                  ) -> Tuple[torch.Tensor, StreamState]:
        """(B, chunk * ratio, 1) audio -> (B, chunk, zs) structure codes."""
        z = self._codec_encode(state.codec_struct, self._tensor(audio))
        if self.rf.encoder_time is not None:
            z = self.rf.encoder_time(z, state.enc_time)[0]
        return z, state

    @torch.no_grad()
    def timbre(self, state: StreamState, audio: ArrayLike
               ) -> Tuple[torch.Tensor, StreamState]:
        """(B, chunk * ratio, 1) audio -> (B, zt) timbre vector of the last
        n_signal latent frames of the timbre stream."""
        z = self._codec_encode(state.codec_timbre, self._tensor(audio))
        ring = torch.cat([state.prev_timbre, z], dim=1)[:, z.shape[1]:]
        zt = self.rf.encoder(ring)[0] / self.latent_range
        state.prev_timbre.copy_(ring)
        return zt, state

    @torch.no_grad()
    def diffuse(self, state: StreamState, time_cond: ArrayLike,
                zsem: ArrayLike, nb_steps=1, guidance_timbre=1.0,
                guidance_structure=1.0, x0: Optional[ArrayLike] = None
                ) -> Tuple[torch.Tensor, StreamState]:
        """(B, chunk, zs) structure + (B, zt) timbre -> (B, chunk, latents)
        denoised codec latents.  ``nb_steps`` and the guidances may change
        from one buffer to the next."""
        time_cond = self._tensor(time_cond)
        zsem = self._tensor(zsem) * self.latent_range
        B, T = time_cond.shape[:2]
        if x0 is None:
            x0 = torch.randn((B, T, self.cfg.denoiser.n_channels),
                             generator=self.generator, device=self.device)
        x = self.rf.sample_stream(state.denoiser, self._tensor(x0), zsem,
                                  time_cond, nb_steps, guidance_timbre,
                                  guidance_structure)
        return x, state

    @torch.no_grad()
    def decode(self, state: StreamState, z: ArrayLike
               ) -> Tuple[torch.Tensor, StreamState]:
        """(B, chunk, latents) -> (B, chunk * ratio, 1) audio."""
        z = self._tensor(z)
        if self.crossfade is not None:
            return self.crossfade.decode(state.codec_dec, z), state
        return self.codec.decode(z, state.codec_dec), state

    @property
    def decode_lag_frames(self) -> int:
        """Latent frames the streamed decode lags behind its input
        (crossfade overlap; 0 for causal codecs, whose residual lag is the
        sample-level transposed-conv delay below)."""
        return self.crossfade.n_fade if self.crossfade is not None else 0

    @property
    def decode_lag_samples(self) -> int:
        """Total decode latency in samples a host should compensate."""
        cfg = self.cfg.autoencoder
        if self.crossfade is not None:
            return self.crossfade.n_fade * cfg.ratio
        return decoder_band_delay(cfg) * cfg.pqmf_bands

    def forward(self, state: StreamState, audio_structure: ArrayLike,
                audio_timbre: ArrayLike, nb_steps=1, guidance_timbre=1.0,
                guidance_structure=1.0, x0: Optional[ArrayLike] = None
                ) -> Tuple[torch.Tensor, StreamState]:
        """Audio -> audio, one buffer: structure, timbre, diffuse, decode."""
        zs, state = self.structure(state, audio_structure)
        zt, state = self.timbre(state, audio_timbre)
        z, state = self.diffuse(state, zs, zt, nb_steps, guidance_timbre,
                                guidance_structure, x0)
        return self.decode(state, z)

    def generate(self, state: StreamState, time_cond: ArrayLike,
                 zsem: ArrayLike, nb_steps=1, guidance_timbre=1.0,
                 guidance_structure=1.0, x0: Optional[ArrayLike] = None
                 ) -> Tuple[torch.Tensor, StreamState]:
        """(structure codes, timbre vector) -> audio: diffuse + decode."""
        z, state = self.diffuse(state, time_cond, zsem, nb_steps,
                                guidance_timbre, guidance_structure, x0)
        return self.decode(state, z)

    def generate_timbre(self, state: StreamState, audio: ArrayLike,
                        zsem: ArrayLike, nb_steps=1, guidance_timbre=1.0,
                        guidance_structure=1.0,
                        x0: Optional[ArrayLike] = None
                        ) -> Tuple[torch.Tensor, StreamState]:
        """(structure audio, timbre vector) -> audio: the structure of the
        audio, diffused with the given timbre, decoded."""
        zs, state = self.structure(state, audio)
        z, state = self.diffuse(state, zs, zsem, nb_steps, guidance_timbre,
                                guidance_structure, x0)
        return self.decode(state, z)

    # -- XY-pad projector (utils/latent_map.py) ----------------------------

    @torch.no_grad()
    def latent2map(self, projector: nn.Module, zt: ArrayLike) -> torch.Tensor:
        """(B, zt) timbre vector -> (B, 2) map coordinates."""
        return projector.encode(self._tensor(zt) * self.latent_range)

    @torch.no_grad()
    def map2latent(self, projector: nn.Module, xy: ArrayLike) -> torch.Tensor:
        """(B, 2) map coordinates -> (B, zt) timbre vector."""
        return projector.decode(self._tensor(xy)) / self.latent_range

    # -- MIDI-to-audio streaming -------------------------------------------

    @torch.no_grad()
    def diffuse_midi(self, state: StreamState, notes: ArrayLike,
                     zsem: ArrayLike, nb_steps=1, guidance_timbre=1.0,
                     guidance_structure=1.0, x0: Optional[ArrayLike] = None
                     ) -> Tuple[torch.Tensor, StreamState]:
        """Polyphonic MIDI step: ``notes`` (B, chunk, n_poly, 2) holds
        (pitch, velocity) pairs per frame; they become the 128-bin piano
        roll (velocity / 128) that the denoiser takes as structure."""
        notes = self._tensor(notes)
        B, T = notes.shape[:2]
        pitch = notes[..., 0].to(torch.int64).clamp(0, 127)
        vel = notes[..., 1] / 128.0
        roll = torch.zeros((B, T, 128), device=self.device)
        roll.scatter_reduce_(2, pitch, vel, reduce="amax")
        return self.diffuse(state, roll, zsem, nb_steps, guidance_timbre,
                            guidance_structure, x0)

    # ------------------------------------------------------------------

    def method_specs(self) -> Dict[str, Dict]:
        """I/O metadata for host integration: channels and ratios of each
        method, and the runtime attributes of the diffusing ones."""
        cfg = self.cfg
        r = self.ratio
        midi = self.is_midi
        attrs = ("nb_steps", "guidance_timbre", "guidance_structure")
        specs = {
            "forward": dict(in_channels=2, in_ratio=1, out_channels=1,
                            out_ratio=1, attributes=attrs),
            "structure": dict(in_channels=1, in_ratio=1,
                              out_channels=(cfg.autoencoder.z_channels
                                            if midi else cfg.zs_channels),
                              out_ratio=r),
            "timbre": dict(in_channels=1, in_ratio=1,
                           out_channels=cfg.zt_channels, out_ratio=r),
            "diffuse": dict(in_channels=cfg.zs_channels + cfg.zt_channels,
                            in_ratio=r,
                            out_channels=cfg.denoiser.n_channels,
                            out_ratio=r, attributes=attrs),
            "decode": dict(in_channels=cfg.denoiser.n_channels, in_ratio=r,
                           out_channels=1, out_ratio=1),
            "generate": dict(in_channels=cfg.zs_channels + cfg.zt_channels,
                             in_ratio=r, out_channels=1, out_ratio=1,
                             attributes=attrs),
            "generate_timbre": dict(in_channels=1 + cfg.zt_channels,
                                    in_ratio=1, out_channels=1, out_ratio=1,
                                    attributes=attrs),
            "latent2map": dict(in_channels=cfg.zt_channels, in_ratio=1,
                               out_channels=2, out_ratio=1, stateless=True),
            "map2latent": dict(in_channels=2, in_ratio=1,
                               out_channels=cfg.zt_channels, out_ratio=1,
                               stateless=True),
            **({"diffuse_midi": dict(
                in_channels=2 * self.n_poly + cfg.zt_channels, in_ratio=r,
                out_channels=cfg.denoiser.n_channels, out_ratio=r,
                attributes=attrs)}
               if midi else {}),
        }
        if midi:
            del specs["generate_timbre"]
            del specs["forward"]
        return specs
