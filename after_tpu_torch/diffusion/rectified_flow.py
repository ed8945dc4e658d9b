"""Rectified-flow timbre transfer (counterpart of
after_tpu/diffusion/rectified_flow.py): the two conditioning encoders and the
adversarial classifier, the training loss with its condition dropout, the
3-way classifier-free guidance, the Euler sampler and the streaming sampler.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import AfterConfig
from ..models import make_denoiser
from ..models.denoiser import KVSlot
from ..models.ecapa import ECAPAEncoder
from ..models.encoder import Encoder1D
from ..ops.train_mode import TrainMode
from ..streaming.state import Cache
from ..utils.device import to_device
from ..utils.precision import cast_call, to_compute, to_f32


def _f32(value) -> np.float32:
    """A Python number or a 0-d tensor as an f32 host scalar."""
    return np.float32(float(value))


def guidance_mix(guidance_timbre, guidance_structure) -> np.ndarray:
    """[total, factor] of the 3-way CFG mix as f32 host values, computed in
    f32 as the JAX package computes them on the device: total = (gs + gt) /
    2 and factor = gt / max(gs, 0.01).  The guidances are Python numbers or
    0-d tensors."""
    gt, gs = _f32(guidance_timbre), _f32(guidance_structure)
    total = np.float32(0.5) * (gs + gt)
    factor = gt / np.maximum(gs, np.float32(0.01))
    return np.array([total, factor], dtype=np.float32)


def stream_scalars(max_steps: int, nb_steps=1, guidance_timbre=1.0,
                   guidance_structure=1.0) -> Tuple[int, np.ndarray]:
    """(nb, scalars) of one streaming buffer: ``nb_steps`` clipped to [1,
    max_steps] (the slots the KV cache has), and the f32 vector [t_0 ..
    t_{S-1}, dt, total, factor] that its Euler steps read (S = max_steps):
    t_i = i / nb and dt = 1 / nb in f32, as in the JAX sampler (t_i for i >=
    nb unused), then ``guidance_mix``.  The arguments are Python numbers or
    0-d tensors."""
    nb = min(max(int(nb_steps), 1), max_steps)
    nb_f = np.float32(nb)
    t = np.arange(max_steps, dtype=np.float32) / nb_f
    return nb, np.concatenate([
        t, [np.float32(1.0) / nb_f],
        guidance_mix(guidance_timbre, guidance_structure)]
    ).astype(np.float32)


class RectifiedFlow(nn.Module):
    """``net`` (the denoiser), ``encoder`` (timbre), ``encoder_time``
    (structure, absent for midi configs) and ``classifier`` (the adversarial
    classifier that predicts the timbre vector from the structure codes,
    when ``cfg.classifier`` is set; only training runs it).

    With ``streaming`` set, ``net`` and ``encoder_time`` are their streaming
    forms (the timbre encoder and the classifier always run offline) and the
    sampler is ``sample_stream``; its parameters have the same names as the
    offline model's, so one state dict serves both."""

    # the name of the noise-level draw of a training step (trainer.DRAWS):
    # the flow's times t, uniform in [0, 1)
    LEVEL_DRAW = "t"

    def __init__(self, cfg: AfterConfig, streaming: bool = False):
        super().__init__()
        self.cfg = cfg
        # the configured backbone (v2, v1 or the UNet); a streaming UNet is
        # None: it has no streaming form
        self.net = make_denoiser(cfg.denoiser, streaming,
                                 cond_in=cfg.zt_channels,
                                 tcond_in=cfg.zs_channels)
        self.encoder = ECAPAEncoder(cfg.encoder)
        self.encoder_time = (Encoder1D(cfg.encoder_time, streaming)
                             if cfg.encoder_time is not None else None)
        self.classifier = (Encoder1D(cfg.classifier)
                           if cfg.classifier is not None else None)
        self.drop_value = cfg.drop_value

    def encode_timbre(self, x: torch.Tensor):
        """(B, T, C) latents -> (z, mean, reg) with z (B, zt)."""
        return self.encoder(x)

    def encode_structure(self, x: torch.Tensor):
        """(B, T, C) latents -> (z, mean, reg) with z (B, T, zs)."""
        if self.encoder_time is None:
            return x, x, x.new_zeros(())
        return self.encoder_time(x)

    def cfgdrop(self, datas, drop_targets, drop_rate: float,
                draw: torch.Tensor):
        """Condition dropout for CFG training.  ``draw`` is one uniform
        draw per sample (B,): below ``drop_rate`` every condition is
        replaced by ``drop_value``; condition i in ``drop_targets`` is also
        replaced where the draw lies in (drop_rate * (i + 1), drop_rate *
        (i + 2)).  ``None`` entries stay ``None``."""
        drop_all = draw < drop_rate
        out = []
        for i, d in enumerate(datas):
            if d is None:
                out.append(None)
                continue
            drop_i = (draw > drop_rate * (i + 1)) & (draw < drop_rate * (i + 2))
            drop = (drop_all | drop_i) if i in tuple(drop_targets) else drop_all
            shape = (d.shape[0],) + (1,) * (d.dim() - 1)
            out.append(torch.where(drop.reshape(shape), self.drop_value, d))
        return out

    @staticmethod
    def draw_level(batch: int, generator: Optional[torch.Generator],
                   device: torch.device) -> torch.Tensor:
        """A training step's noise-level draw (``LEVEL_DRAW``): the times
        t (B,), uniform in [0, 1)."""
        return torch.rand((batch,), generator=generator, device=device)

    def diffusion_loss(self, x1, time_cond, cond, x0: torch.Tensor,
                       t: torch.Tensor, train: Optional[TrainMode] = None,
                       compute_dtype: Optional[torch.dtype] = None):
        """Rectified-flow MSE on the velocity field, from the noise ``x0``
        (x1's shape) and the times ``t`` (B,) in [0, 1): returns (loss,
        (interpolant, t as (B, 1, 1))).  The denoiser runs in training form
        (dropout) with ``train``.  With ``compute_dtype`` (mixed-precision
        training) the denoiser runs at that type, its f32 parameters cast
        inside the call (``cast_call``) and its inputs cast; the noise, the
        interpolant, the target and the MSE stay f32, as in the JAX
        package."""
        cd = compute_dtype
        target = x1 - x0
        tb = t[:, None, None]
        interpolant = (1 - tb) * x0 + tb * x1
        out = cast_call(self.net, cd, *(to_compute(a, cd) for a in (
            interpolant, t, cond, time_cond)), train=train)
        return (torch.mean(torch.square(to_f32(out, cd) - target)),
                (interpolant, tb))

    def transfer_estimate(self, interpolant, t, cond, tcond,
                          compute_dtype: Optional[torch.dtype] = None):
        """One-shot estimate of the clean target from a noised batch, for
        the trainer's cycle step: integrate the velocity field from t (the
        (B, 1, 1) times ``diffusion_loss`` returns) straight to 1.  Inputs
        and output f32; with ``compute_dtype`` only the denoiser runs at
        it."""
        cd = compute_dtype
        v = cast_call(self.net, cd, *(to_compute(a, cd) for a in (
            interpolant, t[:, 0, 0], cond, tcond)))
        return interpolant + (1 - t) * to_f32(v, cd)

    def _cfg_inputs(self, x, time, cond, time_cond):
        """Tile (x, time) 3x and build the [full | structure-only |
        unconditional] condition rows of the 3-way CFG batch."""
        full_x = torch.cat([x, x, x], dim=0)
        full_time = torch.cat([time, time, time], dim=0)
        null_c = torch.full_like(cond, self.drop_value)
        full_cond = torch.cat([cond, null_c, null_c], dim=0)
        null_tc = torch.full_like(time_cond, self.drop_value)
        full_tcond = torch.cat([time_cond, time_cond, null_tc], dim=0)
        return full_x, full_time, full_cond, full_tcond

    @staticmethod
    def _cfg_mix(out, total, factor):
        """Linear guidance mix of the 3 CFG rows, with ``total`` and
        ``factor`` of ``guidance_mix`` as 0-d tensors (device scalars that
        a CUDA graph reads at replay) or numbers."""
        o_full, o_tc, o_none = out.chunk(3, dim=0)
        return o_none + total * (o_tc + factor * (o_full - o_tc) - o_none)

    def model_forward(self, x, time, cond, time_cond, mix: torch.Tensor,
                      cache: Cache = None,
                      cache_index: Union[int, torch.Tensor] = 0):
        """3-way CFG velocity in one batched forward of 3B rows, mixed with
        ``mix`` = [total, factor] (``guidance_mix``) on x's device; a
        streaming net takes its KV cache and the Euler step's slot.  A
        compute-dtype velocity is widened to f32 before the mix."""
        dx = self.net(*self._cfg_inputs(x, time, cond, time_cond),
                      cache=cache, cache_index=cache_index)
        if dx.dtype != torch.float32:
            dx = dx.float()
        return self._cfg_mix(dx, mix[0], mix[1])

    def sample(self, x0, cond, time_cond, nb_steps: int,
               guidance_timbre: float = 1.0, guidance_structure: float = 1.0,
               mix: Optional[torch.Tensor] = None,
               compute_dtype: Optional[torch.dtype] = None):
        """Euler integration from noise x0 at t = 0 to t = 1 on the exact
        grid t_i = i / n.  ``nb_steps`` is fixed, as it is static in the JAX
        sampler; the guidances are runtime values: ``mix`` (``guidance_mix``
        on x0's device, a CUDA graph's static input) when given, else made
        from ``guidance_timbre`` and ``guidance_structure``.  With
        ``compute_dtype`` (the net's weights already at it) the net runs at
        that dtype on the state cast to it, while the Euler state stays in
        x0's dtype."""
        if mix is None:
            mix = to_device(guidance_mix(guidance_timbre, guidance_structure),
                            x0.device)
        cd = compute_dtype
        if cd is not None:
            cond, time_cond = cond.to(cd), time_cond.to(cd)
        dt = 1.0 / nb_steps
        t_values = torch.arange(nb_steps, dtype=torch.float32) / nb_steps
        x = x0
        for t in t_values.tolist():
            xi = x if cd is None else x.to(cd)
            time = torch.full((x.shape[0],), t, dtype=xi.dtype,
                              device=x.device)
            dx = self.model_forward(xi, time, cond, time_cond, mix)
            x = x + dx * dt
        return x

    def stream_scalars(self, nb_steps=1, guidance_timbre=1.0,
                       guidance_structure=1.0) -> Tuple[int, np.ndarray]:
        """``stream_scalars`` of this model's max_diffusion_steps."""
        return stream_scalars(self.cfg.denoiser.max_diffusion_steps, nb_steps,
                              guidance_timbre, guidance_structure)

    def stream_step(self, cache: Cache, i: Union[int, torch.Tensor], x, cond,
                    time_cond, scalars: torch.Tensor,
                    compute_dtype: Optional[torch.dtype] = None):
        """Euler step i of a streaming buffer, on KV slot i: x + v * dt, with
        t_i, dt and the guidance mix read from ``scalars``
        (``stream_scalars``, on x's device); the cache is updated in place.
        ``i`` is a Python int or an int64 0-d tensor (``KVSlot``).  A CUDA
        graph of each slot serves every nb_steps.  With ``compute_dtype``
        the net runs at it (x, t and the conditions cast to it, the cache
        already at it); x stays in its own dtype."""
        S = self.cfg.denoiser.max_diffusion_steps
        time = KVSlot(i).read(scalars, 0).expand(x.shape[0])
        xi, cd = x, compute_dtype
        if cd is not None:
            xi, time = x.to(cd), time.to(cd)
            cond, time_cond = cond.to(cd), time_cond.to(cd)
        dx = self.model_forward(xi, time, cond, time_cond, scalars[S + 1:],
                                cache=cache, cache_index=i)
        return x + dx * scalars[S]

    def sample_stream(self, cache: Cache, x0, cond, time_cond, nb_steps=1,
                      guidance_timbre=1.0, guidance_structure=1.0,
                      compute_dtype: Optional[torch.dtype] = None):
        """One streaming buffer: ``nb_steps`` Euler steps over x0's chunk of
        frames, step i on KV slot i (``stream_step``); the cache is updated
        in place.  ``nb_steps`` and the guidances are runtime values (Python
        numbers or 0-d tensors) that may change from one buffer to the
        next (``stream_scalars``).  ``compute_dtype`` as in
        ``stream_step``."""
        nb, values = self.stream_scalars(nb_steps, guidance_timbre,
                                         guidance_structure)
        scalars = to_device(values, x0.device)
        x = x0
        for i in range(nb):
            x = self.stream_step(cache, i, x, cond, time_cond, scalars,
                                 compute_dtype)
        return x
