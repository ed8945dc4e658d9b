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

On the card a buffer runs as CUDA graphs, the counterpart of the JAX
streamer's one jitted call with its state donated: one graph each for the
structure stage, the timbre stage (with its latent ring), one Euler step
per KV slot (``max_diffusion_steps`` of them) and the decode stage, so a
buffer at ``nb_steps`` n replays 3 + n graphs.  The graphs read and write
one state's tensors, so they belong to that state: they are captured when
the state is made (``init_state``) or first used, after a warm-up whose
writes to the state are undone (``warm_up``), and never again for a new
``nb_steps`` or new guidances, which reach the step graphs as device
scalars (the model's ``stream_scalars``).  Each other state gets graphs
of its own.  Each entry point is one sequence of stages over its state's
buffers: inputs are copied into them, ``x0`` (when not given) is drawn
into its buffer outside the graphs, and outputs are copies.  A stage is
replayed from its graph, or, with ``Streamer(..., eager=True)`` (or
``streamer.eager`` set) and always on the CPU, run op by op over the same
buffers.

``compute_dtype="bfloat16"`` streams at bf16, as the JAX streamer's
``compute_dtype`` does: the models run at it (a pipeline of the same
compute dtype shares its cast weights: ``TransferPipeline(...,
compute_dtype=...)`` or ``pipeline.with_compute_dtype``), the caches, ring
buffers and KV slots of a state live at it, and audio, latents, structure
codes and timbre vectors go in and out in f32, the Euler state too.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import AfterConfig
from ..diffusion.pipeline import TransferPipeline
from ..diffusion.factory import make_model
from ..models.autoencoder import AudioCodec, decoder_band_delay
from ..utils.device import copy_from_host, resolve_device, to_device
from ..utils.graphs import Graph, GraphPool, capture_key, restored
from ..utils.precision import compute_dtype as resolve_compute_dtype
from ..utils.precision import to_compute, to_f32
from .state import StreamState, clone_state, flatten_state, init_cache

ArrayLike = Union[torch.Tensor, np.ndarray]


@dataclasses.dataclass
class _Buffers:
    """A buffer's inputs and outputs between the stages, at fixed addresses:
    what one state's stages read and write (its graphs' static buffers)."""

    audio_s: torch.Tensor     # (B, chunk * ratio, 1) structure audio
    audio_t: torch.Tensor     # (B, chunk * ratio, 1) timbre audio
    zs: torch.Tensor          # structure codes: tcond, or the codec latents
                              # where no structure encoder makes tcond's
    tcond: torch.Tensor       # (B, chunk, zs) structure codes, diffused
    cond: torch.Tensor        # (B, zt) timbre vector x latent_range
    zt: torch.Tensor          # (B, zt) timbre vector
    x: torch.Tensor           # (B, chunk, latents) noise in, latents out
    scalars: torch.Tensor     # the model's stream_scalars


@dataclasses.dataclass
class _Stages:
    """One stream state's buffers and, on the card, the CUDA graph of each
    stage (by stage key, ``Streamer._keys``) with what they were captured
    under (``capture_key``)."""

    bufs: _Buffers
    graphs: Optional[Dict[Any, Graph]] = None
    check: Optional[tuple] = None


def _into(buf: torch.Tensor, x) -> None:
    shape = tuple(x.shape) if hasattr(x, "shape") else np.shape(x)
    if shape != tuple(buf.shape):
        raise ValueError(f"this stream state's graphs take {tuple(buf.shape)}"
                         f", got {shape}: a buffer of another length needs a "
                         "Streamer of that chunk_size")
    copy_from_host(buf, x)


def _share(module: nn.Module, source: nn.Module) -> nn.Module:
    """``module`` with ``source``'s parameters and persistent buffers (the
    same tensors, so a later change of either reaches both)."""
    module.load_state_dict(source.state_dict(keep_vars=True), assign=True)
    return module.eval()


def piano_roll(notes: torch.Tensor) -> torch.Tensor:
    """(B, T, n_poly, 2) (pitch, velocity) note pairs -> the (B, T, 128)
    piano roll the MIDI denoiser takes as structure: velocity / 128 at each
    pitch (clipped to 0-127), the loudest where notes share one."""
    pitch = notes[..., 0].to(torch.int64).clamp(0, 127)
    vel = notes[..., 1] / 128.0
    roll = notes.new_zeros(notes.shape[:2] + (128,))
    return roll.scatter_reduce_(2, pitch, vel, reduce="amax")


class StreamStages:
    """The stages of a streamed buffer, each a function of a
    ``StreamState`` and its inputs that returns its output and writes the
    state in place: what a ``Streamer``'s CUDA graphs capture and what
    ``streaming.export`` writes as programs.  A class that mixes it in has
    ``codec``, ``crossfade`` (None for a causal codec), ``rf``,
    ``latent_range`` and ``compute_dtype`` (None for f32).  Each stage takes
    and returns f32 tensors and runs the models at the compute dtype."""

    compute_dtype: Optional[torch.dtype] = None

    def _codec_encode(self, cache, audio: torch.Tensor) -> torch.Tensor:
        audio = to_compute(audio, self.compute_dtype)
        if self.crossfade is not None:
            return self.crossfade.encode(cache, audio)
        return self.codec.encode(audio, cache)

    def _codec_decode(self, cache, z: torch.Tensor) -> torch.Tensor:
        z = to_compute(z, self.compute_dtype)
        if self.crossfade is not None:
            y = self.crossfade.decode(cache, z)
        else:
            y = self.codec.decode(z, cache)
        return to_f32(y, self.compute_dtype)

    def structure_stage(self, state: StreamState, audio: torch.Tensor
                        ) -> torch.Tensor:
        """(B, chunk * ratio, 1) audio -> structure codes (the codec's
        latents where there is no structure encoder)."""
        z = self._codec_encode(state.codec_struct, audio)
        if self.rf.encoder_time is not None:
            z = self.rf.encoder_time(z, state.enc_time)[0]
        return to_f32(z, self.compute_dtype)

    def timbre_stage(self, state: StreamState, audio: torch.Tensor
                     ) -> torch.Tensor:
        """(B, chunk * ratio, 1) audio -> (B, zt) timbre vector of the latent
        ring, which it moves on by one chunk."""
        z = self._codec_encode(state.codec_timbre, audio)
        ring = torch.cat([state.prev_timbre, z], dim=1)[:, z.shape[1]:]
        zt = to_f32(self.rf.encoder(ring)[0], self.compute_dtype)
        state.prev_timbre.copy_(ring)
        return zt / self.latent_range

    def step_stage(self, state: StreamState, slot, x: torch.Tensor,
                   cond: torch.Tensor, tcond: torch.Tensor,
                   scalars: torch.Tensor) -> torch.Tensor:
        """The Euler step on KV slot ``slot`` (an int, or an int64 0-d
        tensor): the model's ``stream_step``."""
        return self.rf.stream_step(state.denoiser, slot, x, cond, tcond,
                                   scalars, self.compute_dtype)

    def decode_stage(self, state: StreamState, z: torch.Tensor
                     ) -> torch.Tensor:
        """(B, chunk, latents) -> (B, chunk * ratio, 1) audio."""
        return self._codec_decode(state.codec_dec, z)


class Streamer(StreamStages):
    """Buffer-by-buffer timbre transfer over a ``StreamState``."""

    def __init__(self, cfg: AfterConfig, chunk_size: int = 4,
                 n_fade: int = 4,
                 device: Optional[Union[str, torch.device]] = None, *,
                 pipeline: Optional[TransferPipeline] = None,
                 latent_range: float = 1.0, compute_dtype=None,
                 eager: bool = False):
        """n_fade: crossfade overlap in latent frames for non-causal codecs
        (ignored for causal ones); compute_dtype: None (f32) or "bfloat16"
        for the pipeline built here, and the given pipeline's by default
        (another one given raises); eager: run op by op on the card instead
        of replaying CUDA graphs."""
        if cfg.denoiser.arch == "unet1d":
            raise ValueError(
                "denoiser arch 'unet1d' is offline-only (no streaming "
                "caches): use TransferPipeline, or arch 'v2'/'v1'")
        if pipeline is None:
            cd = resolve_compute_dtype(compute_dtype)
            pipeline = TransferPipeline(cfg, device, compute_dtype=cd)
        elif device is not None and resolve_device(device) != pipeline.device:
            raise ValueError(f"the pipeline runs on {pipeline.device}, "
                             f"not {device}")
        cd = pipeline.compute_dtype
        if compute_dtype is not None and resolve_compute_dtype(
                compute_dtype) != cd:
            raise ValueError(
                f"the pipeline computes at {cd}, the streamer at "
                f"{compute_dtype}: pass pipeline.with_compute_dtype(...)")
        self.compute_dtype = cd
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
        # at the compute dtype first: the constants that no state dict holds
        # (the PQMF filters) are cast with the weights
        dtype = cd or torch.float32
        _share(self.codec.to(self.device, dtype), pipeline.codec)
        self.rf = _share(
            make_model(cfg, streaming=True).to(self.device, dtype),
            pipeline.rf)
        self.generator = torch.Generator(self.device).manual_seed(0)
        self.eager = eager
        # the CUDA graphs' pool (made at the first capture), and each
        # state's buffers and graphs
        self.graphs: Optional[GraphPool] = None
        self._states: "weakref.WeakKeyDictionary[StreamState, _Stages]" \
            = weakref.WeakKeyDictionary()

    def _tensor(self, x: ArrayLike) -> torch.Tensor:
        return to_device(x, self.device)

    @property
    def graphed(self) -> bool:
        """Whether buffers run as CUDA graphs (on the card, unless
        ``eager``)."""
        return self.device.type == "cuda" and not self.eager

    # ------------------------------------------------------------------

    @torch.no_grad()
    def init_state(self, batch_size: int = 1) -> StreamState:
        """Zeroed stream state for ``batch_size`` parallel voices
        (``new_state``), and on the card its graphs, captured now."""
        state = self.new_state(batch_size)
        if self.graphed:
            self._stages(state)
        return state

    @torch.no_grad()
    def new_state(self, batch_size: int = 1) -> StreamState:
        """Zeroed stream state for ``batch_size`` parallel voices (the
        crossfade path's GroupNorm pads as one pass over silence leaves
        them), with no graphs yet, at the compute dtype.  Every buffer is
        allocated here once; each step writes into it in place."""
        cfg = self.cfg
        B, A, T = batch_size, self.audio_chunk, self.chunk_size
        z_ch = cfg.autoencoder.z_channels

        def zeros(*shape):
            return torch.zeros(shape, device=self.device,
                               dtype=self.compute_dtype or torch.float32)

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
    # stages, run op by op or replayed as CUDA graphs
    # ------------------------------------------------------------------

    def _buffers(self, batch_size: int) -> _Buffers:
        cfg, B, T = self.cfg, batch_size, self.chunk_size

        def zeros(*shape):
            return torch.zeros(shape, device=self.device)
        tcond = zeros(B, T, cfg.zs_channels)
        # without a structure encoder (midi) the structure codes are the
        # codec's latents
        zs = (tcond if self.rf.encoder_time is not None
              else zeros(B, T, cfg.autoencoder.z_channels))
        return _Buffers(
            audio_s=zeros(B, self.audio_chunk, 1),
            audio_t=zeros(B, self.audio_chunk, 1), zs=zs, tcond=tcond,
            cond=zeros(B, cfg.zt_channels), zt=zeros(B, cfg.zt_channels),
            x=zeros(B, T, cfg.denoiser.n_channels),
            scalars=to_device(self.rf.stream_scalars(
                cfg.denoiser.max_diffusion_steps)[1], self.device))

    def _keys(self) -> list:
        """The stages of a buffer in order: structure, timbre, the Euler
        step of each KV slot (by its index), decode."""
        return ["structure", "timbre",
                *range(self.cfg.denoiser.max_diffusion_steps), "decode"]

    def _stage(self, state: StreamState, b: _Buffers, key):
        """Stage ``key`` of a buffer on ``state``, from and into ``b``;
        returns what it wrote (decode: the audio)."""
        if key == "structure":
            return b.zs.copy_(self.structure_stage(state, b.audio_s))
        if key == "timbre":
            zt = self.timbre_stage(state, b.audio_t)
            b.zt.copy_(zt)
            return b.cond.copy_(zt * self.latent_range)
        if key == "decode":
            return self.decode_stage(state, b.x)
        return b.x.copy_(self.step_stage(state, key, b.x, b.cond, b.tcond,
                                         b.scalars))

    @torch.no_grad()
    def warm_up(self, state: StreamState,
                bufs: Optional[_Buffers] = None) -> Tuple[tuple, tuple]:
        """Every stage of a buffer once on ``state`` (structure, timbre, the
        Euler step of every KV slot, decode), over ``bufs`` (zeros when not
        given), which fills every lazily built constant; the state's
        tensors are then written back, in place, to what they held before.
        Returns the shapes of the structure codes and of the audio.  The
        graphs' capture runs it first, on their side stream."""
        b = bufs if bufs is not None else self._buffers(
            state.prev_timbre.shape[0])

        def run():
            for key in self._keys():
                y = self._stage(state, b, key)
            return tuple(b.zs.shape), tuple(y.shape)

        with restored(flatten_state(state).values()):
            return self._pool().warm(run) if self.graphed else run()

    def _pool(self) -> GraphPool:
        if self.graphs is None:
            self.graphs = GraphPool(self.device)
        return self.graphs

    def _stages(self, state: StreamState) -> _Stages:
        """The buffers of ``state`` and, on the card unless ``eager``, its
        graphs: captured now (a warm-up that leaves the state as it was,
        then one capture a stage, which runs nothing) if it has none, or if
        the weights or the TF32 switches changed since their capture."""
        g = self._states.get(state)
        if g is None:
            g = self._states[state] = _Stages(
                self._buffers(state.prev_timbre.shape[0]))
        if self.graphed:
            check = capture_key(self.codec, self.rf)
            if g.graphs is None or g.check != check:
                self.warm_up(state, g.bufs)
                capture = self._pool().capture
                g.graphs = {key: capture(
                    lambda key=key: self._stage(state, g.bufs, key))
                    for key in self._keys()}
                g.check = check
        return g

    def _run(self, state: StreamState, g: _Stages, key):
        """Stage ``key`` of ``state``: its graph replayed, or op by op."""
        if self.graphed:
            return g.graphs[key].replay()
        return self._stage(state, g.bufs, key)

    def _condition(self, g: _Stages, time_cond, zsem) -> None:
        """Given structure codes and timbre vector into the buffers."""
        _into(g.bufs.tcond, time_cond)
        _into(g.bufs.cond, zsem)
        g.bufs.cond.mul_(self.latent_range)

    def _diffuse(self, state: StreamState, g: _Stages, nb_steps,
                 guidance_timbre, guidance_structure, x0) -> None:
        """x0 (or noise from ``generator``) into the latents, the buffer's
        runtime scalars into theirs, then the Euler steps of slots
        0 .. nb - 1."""
        b = g.bufs
        if x0 is None:
            b.x.normal_(generator=self.generator)
        else:
            _into(b.x, x0)
        nb, values = self.rf.stream_scalars(nb_steps, guidance_timbre,
                                            guidance_structure)
        copy_from_host(b.scalars, values)
        for i in range(nb):
            self._run(state, g, i)

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    @torch.no_grad()
    def structure(self, state: StreamState, audio: ArrayLike
                  ) -> Tuple[torch.Tensor, StreamState]:
        """(B, chunk * ratio, 1) audio -> (B, chunk, zs) structure codes."""
        g = self._stages(state)
        _into(g.bufs.audio_s, audio)
        return self._run(state, g, "structure").clone(), state

    @torch.no_grad()
    def timbre(self, state: StreamState, audio: ArrayLike
               ) -> Tuple[torch.Tensor, StreamState]:
        """(B, chunk * ratio, 1) audio -> (B, zt) timbre vector of the last
        n_signal latent frames of the timbre stream."""
        g = self._stages(state)
        _into(g.bufs.audio_t, audio)
        self._run(state, g, "timbre")
        return g.bufs.zt.clone(), state

    @torch.no_grad()
    def diffuse(self, state: StreamState, time_cond: ArrayLike,
                zsem: ArrayLike, nb_steps=1, guidance_timbre=1.0,
                guidance_structure=1.0, x0: Optional[ArrayLike] = None
                ) -> Tuple[torch.Tensor, StreamState]:
        """(B, chunk, zs) structure + (B, zt) timbre -> (B, chunk, latents)
        denoised codec latents.  ``nb_steps`` and the guidances may change
        from one buffer to the next."""
        g = self._stages(state)
        self._condition(g, time_cond, zsem)
        self._diffuse(state, g, nb_steps, guidance_timbre, guidance_structure,
                      x0)
        return g.bufs.x.clone(), state

    @torch.no_grad()
    def decode(self, state: StreamState, z: ArrayLike
               ) -> Tuple[torch.Tensor, StreamState]:
        """(B, chunk, latents) -> (B, chunk * ratio, 1) audio."""
        g = self._stages(state)
        _into(g.bufs.x, z)
        return self._run(state, g, "decode").clone(), state

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

    @torch.no_grad()
    def forward(self, state: StreamState, audio_structure: ArrayLike,
                audio_timbre: ArrayLike, nb_steps=1, guidance_timbre=1.0,
                guidance_structure=1.0, x0: Optional[ArrayLike] = None
                ) -> Tuple[torch.Tensor, StreamState]:
        """Audio -> audio, one buffer: structure, timbre, diffuse, decode;
        on the card 3 + nb_steps graph replays."""
        g = self._stages(state)
        _into(g.bufs.audio_s, audio_structure)
        _into(g.bufs.audio_t, audio_timbre)
        self._run(state, g, "structure")
        self._run(state, g, "timbre")
        if g.bufs.zs is not g.bufs.tcond:
            g.bufs.tcond.copy_(g.bufs.zs)
        self._diffuse(state, g, nb_steps, guidance_timbre, guidance_structure,
                      x0)
        return self._run(state, g, "decode").clone(), state

    @torch.no_grad()
    def generate(self, state: StreamState, time_cond: ArrayLike,
                 zsem: ArrayLike, nb_steps=1, guidance_timbre=1.0,
                 guidance_structure=1.0, x0: Optional[ArrayLike] = None
                 ) -> Tuple[torch.Tensor, StreamState]:
        """(structure codes, timbre vector) -> audio: diffuse + decode."""
        g = self._stages(state)
        self._condition(g, time_cond, zsem)
        self._diffuse(state, g, nb_steps, guidance_timbre, guidance_structure,
                      x0)
        return self._run(state, g, "decode").clone(), state

    @torch.no_grad()
    def generate_timbre(self, state: StreamState, audio: ArrayLike,
                        zsem: ArrayLike, nb_steps=1, guidance_timbre=1.0,
                        guidance_structure=1.0,
                        x0: Optional[ArrayLike] = None
                        ) -> Tuple[torch.Tensor, StreamState]:
        """(structure audio, timbre vector) -> audio: the structure of the
        audio, diffused with the given timbre, decoded."""
        g = self._stages(state)
        _into(g.bufs.audio_s, audio)
        self._run(state, g, "structure")
        self._condition(g, g.bufs.zs, zsem)
        self._diffuse(state, g, nb_steps, guidance_timbre, guidance_structure,
                      x0)
        return self._run(state, g, "decode").clone(), state

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
        # the roll goes into the structure buffer of the steps
        g = self._stages(state)
        roll = g.bufs.tcond
        if tuple(roll.shape) != (B, T, 128):
            raise ValueError(f"notes of shape {tuple(notes.shape)} for a "
                             f"stream of {tuple(roll.shape)} piano rolls")
        roll.copy_(piano_roll(notes))
        _into(g.bufs.cond, zsem)
        g.bufs.cond.mul_(self.latent_range)
        self._diffuse(state, g, nb_steps, guidance_timbre, guidance_structure,
                      x0)
        return g.bufs.x.clone(), state

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
