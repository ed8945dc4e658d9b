"""EDM (Karras et al., "Elucidating the Design Space of Diffusion-Based
Generative Models") timbre transfer (counterpart of
after_tpu/diffusion/edm.py), with the rectified flow's sub-models and
interface, so that the trainer, the pipeline, the streamer and export run
it as they run the flow.

- The denoised estimate D(x; s) = c_skip(s) x + c_out(s) F(c_in(s) x,
  c_noise(s)), its preconditioning and skip in f32, the backbone F alone at
  the compute dtype; F's "time" input is c_noise = ln(max(s, 1e-20)) / 4.
- Training draws ln s ~ N(p_mean, p_std) and minimises the EDM-weighted
  MSE (s^2 + sd^2) / (s sd)^2 ||D - x1||^2; the unit noise and the normal
  draw are arguments (the trainer draws them).
- Sampling integrates the probability-flow ODE down the Karras ladder,
  Heun's second order when ``edm.heun`` (no correction on the last step,
  where sigma = 0) and Euler otherwise; streaming is Euler, step i on KV
  slot i, from unit noise scaled by sigma_0.
- The guidance mixes the three CFG rows' denoised estimates as the flow
  mixes its velocities.

The ladder is computed once on the host in f32 (``sigma_ladder``), and the
offline and streaming samplers read the same values, so that the streamed
Euler sampler gives the offline one's bits.  A streaming buffer's scalars
(``stream_scalars``) hold, for each step, the factor x is scaled by first
(sigma_0 at step 0, 1 after), the ladder, and the guidance mix: the streamer's
graphs and the exported step program read them as device scalars, so a
change of ``nb_steps`` or of the guidances captures nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import EDMConfig
from ..models.denoiser import KVSlot
from ..ops.train_mode import TrainMode
from ..streaming.state import Cache
from ..utils.device import to_device
from ..utils.precision import cast_call
from .rectified_flow import RectifiedFlow, guidance_mix


def sigma_ladder(e: EDMConfig, nb_steps: int, length: int) -> np.ndarray:
    """f32 sigma_0 .. sigma_{length - 1} of the Karras ladder of
    ``nb_steps`` steps, with sigma_i = 0 for i >= nb_steps, computed in f32
    as the JAX sampler computes ``_sigma_at`` (``frac = 0`` at one step)."""
    f32 = np.float32
    r = 1.0 / e.rho
    nb = f32(nb_steps)
    i = np.arange(length, dtype=f32)
    frac = (i / np.maximum(nb - f32(1.0), f32(1.0)) if nb > 1.0
            else np.zeros(length, f32))
    base = f32(e.sigma_max ** r) + frac * f32(e.sigma_min ** r
                                                - e.sigma_max ** r)
    sig = np.power(base, f32(e.rho))
    return np.where(i > nb - f32(0.5), f32(0.0), sig).astype(f32)


def stream_scalars(e: EDMConfig, max_steps: int, nb_steps=1,
                   guidance_timbre=1.0, guidance_structure=1.0
                   ) -> Tuple[int, np.ndarray]:
    """(nb, scalars) of one EDM streaming buffer: ``nb_steps`` clipped to
    [1, max_steps], and the f32 vector [a_0 .. a_{S-1}, sigma_0 .. sigma_S,
    total, factor] (S = max_steps) that its Euler steps read: step i scales
    x by a_i (sigma_0 at step 0, 1 after: the unit noise scaled once), then
    steps from sigma_i to sigma_{i+1}, then ``guidance_mix``."""
    nb = min(max(int(nb_steps), 1), max_steps)
    sig = sigma_ladder(e, nb, max_steps + 1)
    pre = np.ones(max_steps, np.float32)
    pre[0] = sig[0]
    return nb, np.concatenate([
        pre, sig, guidance_mix(guidance_timbre, guidance_structure)]
    ).astype(np.float32)


class EDM(RectifiedFlow):
    """The Karras EDM on the rectified flow's sub-models."""

    # a training step draws ln s ~ N(p_mean, p_std) from a unit normal
    LEVEL_DRAW = "sigma_normal"

    @staticmethod
    def draw_level(batch: int, generator: Optional[torch.Generator],
                   device: torch.device) -> torch.Tensor:
        """A training step's noise-level draw: the unit normal (B,) of
        ln s."""
        return torch.randn((batch,), generator=generator, device=device)

    # -- preconditioning ----------------------------------------------------

    def _precond(self, sigma: torch.Tensor):
        """sigma (B,) f32 -> (c_skip, c_out, c_in, c_noise), each (B,)."""
        sd = self.cfg.edm.sigma_data
        var = sigma * sigma + sd * sd
        c_skip = (sd * sd) / var
        c_out = sigma * sd * torch.rsqrt(var)
        c_in = torch.rsqrt(var)
        c_noise = 0.25 * torch.log(torch.clamp_min(sigma, 1e-20))
        return c_skip, c_out, c_in, c_noise

    def denoise(self, x, sigma, cond, time_cond, cache: Cache = None,
                cache_index: Union[int, torch.Tensor] = 0,
                compute_dtype: Optional[torch.dtype] = None,
                train: Optional[TrainMode] = None, cast: bool = False
                ) -> torch.Tensor:
        """The preconditioned estimate D(x; sigma) in f32, ``sigma`` (B,).
        The backbone runs at ``compute_dtype`` on its inputs cast to it:
        with ``cast`` (training) on its f32 parameters cast inside the call
        (``cast_call``), else on its weights as they are (a pipeline's,
        already at it).  A streaming backbone takes its cache and slot."""
        if self.net is None:
            raise ValueError(
                f"denoiser arch {self.cfg.denoiser.arch!r} has no streaming "
                "form (offline-only backbone)")
        c_skip, c_out, c_in, c_noise = self._precond(sigma.float())
        x32 = x.float()
        f_in = x32 * c_in[:, None, None]
        cd = compute_dtype
        if cd is not None:
            f_in, c_noise = f_in.to(cd), c_noise.to(cd)
            cond, time_cond = cond.to(cd), time_cond.to(cd)
        kw = dict(train=train) if cache is None else dict(
            cache=cache, cache_index=cache_index)
        if cast:
            out = cast_call(self.net, cd, f_in, c_noise, cond, time_cond,
                            **kw)
        else:
            out = self.net(f_in, c_noise, cond, time_cond, **kw)
        return c_skip[:, None, None] * x32 + c_out[:, None, None] * out.float()

    # -- training ---------------------------------------------------------

    def diffusion_loss(self, x1, time_cond, cond, x0: torch.Tensor,
                       t: torch.Tensor, train: Optional[TrainMode] = None,
                       compute_dtype: Optional[torch.dtype] = None):
        """The EDM-weighted denoising MSE from the unit noise ``x0`` (x1's
        shape) and the unit normal draw ``t`` (B,) of ln s: returns (loss,
        (x_noised, c_skip as (B, 1, 1))), the aux the trainer's cycle step
        reads, c_skip playing the flow's t (1 on clean data, toward 0 at
        pure noise)."""
        e = self.cfg.edm
        sigma = torch.exp(e.p_mean + e.p_std * t)
        x_noised = x1 + x0 * sigma[:, None, None]
        D = self.denoise(x_noised, sigma, cond, time_cond,
                         compute_dtype=compute_dtype, train=train, cast=True)
        sd = e.sigma_data
        weight = (sigma * sigma + sd * sd) / torch.square(sigma * sd)
        loss = torch.mean(weight[:, None, None] * torch.square(D - x1))
        c_skip = (sd * sd) / (sigma * sigma + sd * sd)
        return loss, (x_noised, c_skip[:, None, None])

    def transfer_estimate(self, interpolant, t, cond, tcond,
                          compute_dtype: Optional[torch.dtype] = None):
        """The cycle step's one-shot estimate: D at the sigma recovered
        from c_skip (``t``, the (B, 1, 1) aux of ``diffusion_loss``),
        sigma = sd sqrt(1 / c_skip - 1)."""
        sd = self.cfg.edm.sigma_data
        c_skip = torch.clamp(t[:, 0, 0], 1e-6, 1.0)
        sigma = sd * torch.sqrt(torch.clamp_min(1.0 / c_skip - 1.0, 0.0))
        return self.denoise(interpolant, sigma, cond, tcond,
                            compute_dtype=compute_dtype, cast=True)

    # -- inference --------------------------------------------------------

    def model_forward(self, x, sigma, cond, time_cond, mix: torch.Tensor,
                      cache: Cache = None,
                      cache_index: Union[int, torch.Tensor] = 0,
                      compute_dtype: Optional[torch.dtype] = None):
        """3-way CFG denoised estimate in one batched forward of 3B rows,
        mixed with ``mix`` = [total, factor] (``guidance_mix``)."""
        D = self.denoise(*self._cfg_inputs(x, sigma, cond, time_cond),
                         cache=cache, cache_index=cache_index,
                         compute_dtype=compute_dtype)
        return self._cfg_mix(D, mix[0], mix[1])

    def _euler(self, x, sigma_s, sigma_n, cond, time_cond, mix, cache=None,
               i: Union[int, torch.Tensor] = 0, compute_dtype=None):
        """(x, the slope d at sigma_s, the Euler step to sigma_n); the
        sigmas are 0-d f32 tensors."""
        sigma = sigma_s.expand(x.shape[0])
        D = self.model_forward(x, sigma, cond, time_cond, mix, cache=cache,
                               cache_index=i, compute_dtype=compute_dtype)
        d = (x - D) / sigma_s
        return d, x + (sigma_n - sigma_s) * d

    def sample(self, x0, cond, time_cond, nb_steps: int,
               guidance_timbre: float = 1.0, guidance_structure: float = 1.0,
               mix: Optional[torch.Tensor] = None,
               compute_dtype: Optional[torch.dtype] = None):
        """The probability-flow ODE down the Karras ladder of ``nb_steps``
        (static) steps from the unit noise ``x0``, scaled by sigma_0 here:
        Heun's second order when ``edm.heun`` (the correction skipped on the
        last step, where sigma_{i+1} = 0), plain Euler otherwise.  The Euler
        state is f32; the guidances are runtime values (``mix`` as in
        ``RectifiedFlow.sample``)."""
        dev = x0.device
        if mix is None:
            mix = to_device(guidance_mix(guidance_timbre, guidance_structure),
                            dev)
        sig = to_device(sigma_ladder(self.cfg.edm, nb_steps, nb_steps + 1),
                        dev)
        x = x0.float() * sig[0]
        for i in range(nb_steps):
            s, sn = sig[i], sig[i + 1]
            d, x_next = self._euler(x, s, sn, cond, time_cond, mix,
                                    compute_dtype=compute_dtype)
            if self.cfg.edm.heun and i + 1 < nb_steps:
                d2, _ = self._euler(x_next, sn, sn, cond, time_cond, mix,
                                    compute_dtype=compute_dtype)
                x_next = x + (sn - s) * 0.5 * (d + d2)
            x = x_next
        return x.to(x0.dtype)

    def stream_scalars(self, nb_steps=1, guidance_timbre=1.0,
                       guidance_structure=1.0) -> Tuple[int, np.ndarray]:
        """``stream_scalars`` of this model's ladder and KV slots."""
        return stream_scalars(self.cfg.edm,
                              self.cfg.denoiser.max_diffusion_steps,
                              nb_steps, guidance_timbre, guidance_structure)

    def stream_step(self, cache: Cache, i: Union[int, torch.Tensor], x, cond,
                    time_cond, scalars: torch.Tensor,
                    compute_dtype: Optional[torch.dtype] = None):
        """Euler step i of a streaming buffer on KV slot i, with its scale,
        its sigmas and the guidance mix read from ``scalars``
        (``stream_scalars``, on x's device); the cache is updated in place.
        ``i`` is a Python int or an int64 0-d tensor (``KVSlot``)."""
        S = self.cfg.denoiser.max_diffusion_steps
        x = x * KVSlot(i).read(scalars, 0)
        sigma_s = KVSlot(i + S).read(scalars, 0)
        sigma_n = KVSlot(i + S + 1).read(scalars, 0)
        return self._euler(x, sigma_s, sigma_n, cond, time_cond,
                           scalars[2 * S + 1:], cache, i, compute_dtype)[1]
