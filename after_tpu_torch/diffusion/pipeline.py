"""Offline audio-to-audio transfer pipeline (counterpart of
after_tpu/diffusion/pipeline.py).

``transfer = encode (x2) -> structure + timbre encoders -> Euler sampler
with 3-way CFG -> decode``; ``generate`` (structure codes and a timbre
vector) and ``generate_timbre`` (structure audio and a timbre vector) are
the same chain from a given timbre, as the frontend calls it.  Every entry point runs on the pipeline's device,
which is the CUDA card unless the caller passes ``device="cpu"``.  Inputs and
outputs keep the JAX package's (B, T, C) layout.

On the card each entry point runs as a CUDA graph, as the JAX package jits
each of them: keyed by its input shapes (and ``nb_steps`` where it
samples, static as in JAX), captured on the first call with a new
key (utils/graphs.py) and replayed after that, with the inputs copied into
its static buffers and the guidances in static device scalars, so they may
change from call to call.  The sampler's noise, when not given, is drawn
with ``generator`` outside the graph and copied in as an input.  Outputs are
copies, not the graph's buffers.  ``eager=True`` (or setting
``pipeline.eager``) runs the same calls op by op instead; on the CPU they
always run so.

``compute_dtype="bfloat16"`` (or "bf16") runs the codec, both conditioning
encoders and the denoiser at bf16, as the JAX pipeline's ``compute_dtype``
does: the models are cast once when the pipeline is made, so ``init``,
``load_jax`` and ``load_state_dict`` write bf16 weights (rounded from the
f32 values they are given; ``with_compute_dtype`` makes one from an f32
pipeline's weights), inputs are cast to bf16 on the way in and outputs
widened to f32 on the way out, and the sampler keeps its Euler state in
f32.  Every snake+conv then launches the kernel's bf16 instantiation.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from ..config import AfterConfig
from ..models.autoencoder import AudioCodec
from ..utils.device import (copy_from_host, resolve_device, strict_f32,
                            to_device)
from ..utils.graphs import GraphPool, capture_key
from ..utils.precision import compute_dtype as resolve_compute_dtype
from ..utils.precision import to_compute, to_f32
from .factory import make_model
from .rectified_flow import guidance_mix

ArrayLike = Union[torch.Tensor, np.ndarray]


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


class TransferPipeline:
    """Codec + diffusion models for offline timbre transfer."""

    def __init__(self, cfg: AfterConfig,
                 device: Optional[Union[str, torch.device]] = None, *,
                 compute_dtype=None, eager: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.eager = eager
        # None (f32) or the dtype the models run at, their weights cast once
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        # every f32 matmul and convolution in strict f32 (no TF32 on the
        # card), bf16 ones summed in f32
        strict_f32()
        self.codec = AudioCodec(cfg.autoencoder).eval().to(self.device)
        self.rf = make_model(cfg).eval().to(self.device)
        if self.compute_dtype is not None:
            self.codec.to(self.compute_dtype)
            self.rf.to(self.compute_dtype)
        # the CUDA graphs, made at the first capture: {key: (capture key,
        # graph, static inputs)}
        self.graphs: Optional[GraphPool] = None
        self._graphs: Dict[tuple, tuple] = {}

    def init(self, seed: int = 0) -> "TransferPipeline":
        """Port-native random weights from ``seed`` (utils/init.py)."""
        from ..utils.init import init_weights
        init_weights(self.codec, seed)
        init_weights(self.rf, seed + 1)
        return self

    def load_jax(self, variables: Mapping[str, Any]) -> "TransferPipeline":
        """Weights of the JAX pipeline, as nested dicts of numpy arrays
        (cast to the compute dtype, as the JAX ``prepare_variables`` casts
        them)."""
        from ..utils.from_jax import load_pipeline
        load_pipeline(self, variables)
        return self

    def with_compute_dtype(self, compute_dtype) -> "TransferPipeline":
        """A pipeline on the same device whose models run at
        ``compute_dtype``, with this pipeline's weights cast once."""
        other = TransferPipeline(self.cfg, self.device,
                                 compute_dtype=compute_dtype,
                                 eager=self.eager)
        other.codec.load_state_dict(self.codec.state_dict())
        other.rf.load_state_dict(self.rf.state_dict())
        return other

    def _encode(self, audio: torch.Tensor) -> torch.Tensor:
        """The codec's encode at the compute dtype, latents in f32."""
        cd = self.compute_dtype
        return to_f32(self.codec.encode(to_compute(audio, cd)), cd)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        """The codec's decode at the compute dtype, audio in f32."""
        cd = self.compute_dtype
        return to_f32(self.codec.decode(to_compute(z, cd)), cd)

    def _timbre(self, z: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return to_f32(self.rf.encode_timbre(to_compute(z, cd))[0], cd)

    def _structure(self, z: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return to_f32(self.rf.encode_structure(to_compute(z, cd))[0], cd)

    def _sample(self, x0, cond, time_cond, nb_steps, mix) -> torch.Tensor:
        return self.rf.sample(x0, cond, time_cond, nb_steps, mix=mix,
                              compute_dtype=self.compute_dtype)

    def _tensor(self, x: ArrayLike) -> torch.Tensor:
        return to_device(x, self.device)

    @property
    def graphed(self) -> bool:
        """Whether the entry points run as CUDA graphs (on the card, unless
        ``eager``)."""
        return self.device.type == "cuda" and not self.eager

    def _pool(self) -> GraphPool:
        if self.graphs is None:
            self.graphs = GraphPool(self.device)
        return self.graphs

    def _run(self, name: str, fn: Callable[..., torch.Tensor],
             inputs: Sequence[Any], static: tuple = ()) -> torch.Tensor:
        """fn(*inputs) on the pipeline's device: eagerly, or as the graph of
        (name, the inputs' shapes, ``static``) with the inputs copied into
        its static buffers; returns a copy of its output.  The graph is
        captured, after a warm-up, on the first call with its key, and
        again if the weights or the TF32 switches changed since."""
        if not self.graphed:
            return fn(*(self._tensor(x) for x in inputs))
        key = (name, *(_shape(x) for x in inputs), *static)
        check = capture_key(self.codec, self.rf)
        entry = self._graphs.get(key)
        statics = entry[2] if entry is not None else [
            torch.empty(_shape(x), device=self.device) for x in inputs]
        for buf, x in zip(statics, inputs):
            copy_from_host(buf, x)
        if entry is None or entry[0] != check:
            pool = self._pool()
            pool.warm(lambda: fn(*statics))
            entry = self._graphs[key] = (
                check, pool.capture(lambda: fn(*statics)), statics)
        return entry[1].replay().clone()

    # -- codec entry points ------------------------------------------------

    @torch.inference_mode()
    def encode(self, audio: ArrayLike) -> torch.Tensor:
        """(B, T, 1) waveform -> (B, T / ratio, z) codec latents."""
        return self._run("encode", self._encode, [audio])

    @torch.inference_mode()
    def decode(self, z: ArrayLike) -> torch.Tensor:
        """(B, Tl, z) latents -> waveform (B, Tl * ratio (+ M centered), 1)."""
        return self._run("decode", self._decode, [z])

    # -- conditioning entry points ----------------------------------------

    @torch.inference_mode()
    def timbre(self, z: ArrayLike) -> torch.Tensor:
        """Codec latents -> global timbre vector (B, zt)."""
        return self._run("timbre", self._timbre, [z])

    @torch.inference_mode()
    def structure(self, z: ArrayLike) -> torch.Tensor:
        """Codec latents -> per-frame structure codes (B, T, zs)."""
        return self._run("structure", self._structure, [z])

    # -- generation --------------------------------------------------------

    @torch.inference_mode()
    def diffuse(self, x0: ArrayLike, cond: ArrayLike, time_cond: ArrayLike,
                nb_steps: int = 20, guidance_timbre: float = 1.0,
                guidance_structure: float = 1.0) -> torch.Tensor:
        """The Euler sampler from x0; ``nb_steps`` is static (one graph for
        each), the guidances are runtime values."""
        return self._run(
            "diffuse", lambda x, c, tc, mix: self._sample(
                x, c, tc, nb_steps, mix),
            [x0, cond, time_cond,
             guidance_mix(guidance_timbre, guidance_structure)], (nb_steps,))

    def _noise(self, B: int, T: int, generator: Optional[torch.Generator]
               ) -> torch.Tensor:
        """The sampler's normal noise for B x T latent frames, drawn with
        ``generator`` (seeded 0 when absent) on the pipeline's device."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        return torch.randn((B, T, self.cfg.autoencoder.z_channels),
                           generator=generator, device=self.device)

    def _frames(self, audio) -> Tuple[int, int]:
        """(B, latent frames) of a (B, T, 1) waveform."""
        B, T = _shape(audio)[:2]
        ratio = self.cfg.autoencoder.ratio
        if T % ratio:
            raise ValueError(f"{T} samples: a transfer takes a multiple of "
                             f"the codec's ratio {ratio}")
        return B, T // ratio

    def _generate(self, time_cond, cond, x0, mix, nb_steps):
        """Diffuse from x0 under the conditions, then decode."""
        return self._decode(self._sample(x0, cond, time_cond, nb_steps, mix))

    @torch.inference_mode()
    def generate(self, time_cond: ArrayLike, zsem: ArrayLike,
                 nb_steps: int = 20, guidance_timbre: float = 1.0,
                 guidance_structure: float = 1.0,
                 x0: Optional[ArrayLike] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """(B, T, zs) structure codes and a (B, zt) timbre vector -> audio:
        the sampler and the decode (a MIDI model's piano roll is its
        structure codes); one CUDA graph per (input shapes, ``nb_steps``).
        Noise as in ``transfer``."""
        if x0 is None:
            x0 = self._noise(*_shape(time_cond)[:2], generator)
        return self._run(
            "generate", lambda tc, c, noise, mix: self._generate(
                tc, c, noise, mix, nb_steps),
            [time_cond, zsem, x0,
             guidance_mix(guidance_timbre, guidance_structure)], (nb_steps,))

    @torch.inference_mode()
    def generate_timbre(self, audio_structure: ArrayLike, zsem: ArrayLike,
                        nb_steps: int = 20, guidance_timbre: float = 1.0,
                        guidance_structure: float = 1.0,
                        x0: Optional[ArrayLike] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """(B, T, 1) structure audio and a (B, zt) timbre vector -> audio:
        the structure of the audio diffused with the given timbre and
        decoded; one CUDA graph per (input shapes, ``nb_steps``).  Noise as
        in ``transfer``."""
        if x0 is None:
            x0 = self._noise(*self._frames(audio_structure), generator)

        def run(a, c, noise, mix):
            time_cond = self._structure(self._encode(a))
            return self._generate(time_cond, c, noise, mix, nb_steps)
        return self._run(
            "generate_timbre", run,
            [audio_structure, zsem, x0,
             guidance_mix(guidance_timbre, guidance_structure)], (nb_steps,))

    def _transfer(self, audio_structure, audio_timbre, x0, mix, nb_steps):
        """The transfer's chain on device tensors, from the sampler's noise
        ``x0``."""
        z_struct = self._encode(audio_structure)
        z_timbre = self._encode(audio_timbre)
        time_cond = self._structure(z_struct)
        cond = self._timbre(z_timbre)
        z_out = self._sample(x0, cond, time_cond, nb_steps, mix)
        return self._decode(z_out)

    @torch.inference_mode()
    def transfer(self, audio_structure: ArrayLike, audio_timbre: ArrayLike,
                 nb_steps: int = 20, guidance_timbre: float = 1.0,
                 guidance_structure: float = 1.0,
                 x0: Optional[ArrayLike] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Full audio-to-audio timbre transfer.

        ``audio_structure`` supplies the time-varying content, ``audio_timbre``
        the target timbre.  The sampler starts from ``x0`` when given, else
        from normal noise of the structure latents' shape (B, T / ratio, z)
        drawn with ``generator`` (a generator on the pipeline's device;
        seeded 0 when absent).  On the card this is one CUDA graph per
        (input shapes, ``nb_steps``)."""
        if x0 is None:
            x0 = self._noise(*self._frames(audio_structure), generator)
        return self._run(
            "transfer", lambda a, b, noise, mix: self._transfer(
                a, b, noise, mix, nb_steps),
            [audio_structure, audio_timbre, x0,
             guidance_mix(guidance_timbre, guidance_structure)], (nb_steps,))
