"""Diffusion trainer (counterpart of after_tpu/diffusion/trainer.py): the
two-phase curriculum, the adversarial classifier, cycle consistency, CFG
dropout, frozen encoders and the EMA of the denoiser.

``fit`` picks each step's kind from the step count (``step_kind``):

- ``phase1`` (step < timbre_warmup): a diffusion step with the structure
  dropped whole (codes at ``drop_value``) and no adversarial term;
- ``classifier`` (after phase 1, step % update_classifier_every != 0): the
  adversarial classifier learns to predict the timbre vector from the
  structure codes of both encoders at inference;
- ``diffusion`` or, after ``cycle_start_step``, ``cycle``: the rectified-flow
  loss minus the weighted classifier loss (its gradient reaches the
  structure encoder through the classifier, whose own parameters get
  none), plus the encoders' regularisation and the cycle losses.

The timbre encoder trains until ``stop_training_encoder_step``, the
structure encoder until ``stop_training_encoder_time_step``; a frozen
encoder runs without gradients, its gradients count as zeros in the
optimizer and its parameters keep still (``AdamW``'s keep mask), while its
BatchNorm statistics still move.  A diffusion step keeps the batch
statistics of its first encoder pass only, and only when its gradients are
finite; the classifier's pass inside it and the cycle pass keep none.  The
EMA of the denoiser follows every diffusion step.

Randomness: each step takes ``draws``, a dict of the values the JAX step
draws from its keys (``DRAWS``); a value left out is drawn from the
trainer's seeded ``torch.Generator`` on its device, and so are dropout
masks.  ``train.rng_impl`` names the JAX trainer's random generator and is
kept for the shared JSON form only.  A VAE encoder's sample noise is one
of those draws (``cond_vae``, ``time_cond_vae``, ``cycle_cond_vae``),
taken wherever the JAX step gives that encoder a key: the timbre encoder
in every step, the structure encoder in a diffusion step only.  The JAX
classifier and cycle steps run the structure encoder with no key, which a
VAE there cannot run (flax's ``InvalidRngError``): the port refuses those
steps with a VAE structure encoder (C11).  Everything runs on the trainer's
device, the CUDA card unless the caller passes ``device="cpu"``, in strict
f32.

Mixed precision (``train.compute_dtype="bfloat16"``), as the JAX trainer
runs it: a diffusion step casts the f32 master parameters of the models it
runs to bf16 inside the differentiated step (``utils.precision.cast_call``)
and their inputs with them, so the gradients, the optimizers, the EMA, the
BatchNorm running statistics (f32 batch statistics) and the checkpoints
stay f32; the conditioning vectors, the noise, the interpolant, the
targets and every loss stay f32 (the models' outputs widened).  The
classifier step runs in f32, as the JAX one does.  On the card the casts
are part of each step's CUDA graph.

On the card each step runs as a CUDA graph, as the JAX package jits each
step (utils/graphs.py): one graph per step signature (kind, phase1,
train_encoder, train_encoder_time, use_cycle; at most 5 over the
curriculum) and batch layout, keyed besides by the addresses of the train
state and the TF32 switches.  The first step of a signature runs op by op
on the graphs' side stream and is captured after it; later steps copy
their batch into the graph's static buffers (a host batch through pinned
memory, without a host sync) and their adversarial and regularisation
weights into device scalars, and replay it.  The generator is registered
with each graph, so a replay draws what the step run op by op would draw
from the same generator state; nothing is read back to the host
(``AdamW`` and the BatchNorm commit select on the device).  A step given
``draws`` (host values) runs op by op, and so does every step with
``eager=True`` or on the CPU.  New train-state tensors (``init``,
``load_jax``, ``load_state_tree``) drop the graphs.

``fit`` runs ``train.steps_per_call = K > 1`` as the JAX package's
windows of K steps (``multi_step``, ``_scan_window``): a window starts at a
step that is a multiple of K when no curriculum boundary falls strictly
inside it and it ends by ``max_steps``; its K steps are queued without a
host sync, their metrics summed on the device, and the callback sees the
window's averages once, with the trainer K steps on.  The port draws each
step from its own generator, so a window is exactly K single steps (JAX's
windows split one key K ways, so their draws differ from its single
steps').
"""

from __future__ import annotations

import contextlib
import copy
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from ..config import AfterConfig
from ..ops.conv import recompute_weights
from ..ops.train_mode import TrainMode
from ..utils.device import copy_from_host, resolve_device, strict_f32, \
    to_device
from ..utils.graphs import GraphPool, state_key
from ..utils.optim import AdamW
from ..utils.precision import cast_call, compute_dtype, to_compute, to_f32
from .factory import make_model

ArrayLike = Union[torch.Tensor, np.ndarray]

# the values a diffusion step draws (a classifier step draws "shuffle"):
# shuffle     (B, T) int: the time-chunk shuffle's frame index map
# cond_noise  (B, zt): normal, the timbre vector's noise augmentation
# time_cond_noise  (B, T, zs): normal, the structure codes' augmentation
# cfg_uniform (B,): uniform, the condition dropout's draw
# x0, t       x's shape normal and (B,) uniform: the flow's noise and times
# sigma_normal  (B,) normal: EDM's draw of ln sigma (in place of t; its x0
#             is the unit noise)
# cycle_perm  (B,) int: the cycle step's permutation of the batch
# fsq         the structure encoder's FSQ noise dropout (FSQ.draw)
# cond_vae    (B, zt) normal: the timbre encoder's VAE sample noise
#             (regularisation="vae"), in a diffusion or a classifier step
# time_cond_vae  normal of Encoder1D.vae_noise_shape: the structure
#             encoder's VAE sample noise (vae_regularisation)
# cycle_cond_vae  (B, zt) normal: the timbre encoder's VAE sample noise in
#             the cycle step's re-encode
DRAWS = ("shuffle", "cond_noise", "time_cond_noise", "cfg_uniform", "x0",
         "t", "sigma_normal", "cycle_perm", "fsq", "cond_vae",
         "time_cond_vae", "cycle_cond_vae")
# the float metrics of a diffusion step (with "skipped_nonfinite", the
# optimizer's running count of skipped updates)
DIFFUSION_METRICS = ("diffusion_loss", "adversarial_loss", "cond_reg",
                     "time_cond_reg", "cycle_cond", "cycle_time_cond", "loss")


def shuffle_index(batch: int, length: int, sizes: Sequence[int],
                  generator: Optional[torch.Generator],
                  device: torch.device) -> torch.Tensor:
    """(batch, length) frame index map of the timbre stream's chunk
    shuffle: each row picks a chunk size from ``sizes`` and permutes its
    time axis in chunks of that size (a tail shorter than a chunk stays)."""
    variants = []
    for s in sizes:
        n = length // s
        perms = torch.argsort(torch.rand((batch, n), generator=generator,
                                         device=device), dim=1)
        idx = (perms[:, :, None] * s
               + torch.arange(s, device=device)).reshape(batch, n * s)
        if n * s < length:
            tail = torch.arange(n * s, length, device=device)
            idx = torch.cat([idx, tail.expand(batch, -1)], dim=1)
        variants.append(idx)
    choice = torch.randint(len(sizes), (batch,), generator=generator,
                           device=device)
    return torch.stack(variants)[choice, torch.arange(batch, device=device)]


def shuffle_time_chunks(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x (B, T, C) gathered along time by an index map (``shuffle_index``)."""
    return x.gather(1, index[:, :, None].expand(-1, -1, x.shape[2]))


def _cos_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    num = torch.sum(a * b, dim=1)
    den = (torch.linalg.vector_norm(a, dim=1)
           * torch.linalg.vector_norm(b, dim=1) + 1e-8)
    return torch.mean(1 - num / den)


class DiffusionTrainer:
    """The diffusion model (``rf``), its optimizers, the EMA of the
    denoiser's parameters (``ema``, in ``rf.net.parameters()`` order) and
    the step count.  On the card the steps run as CUDA graphs;
    ``eager=True`` (or setting ``trainer.eager``) runs them op by op."""

    def __init__(self, cfg: AfterConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0, *, eager: bool = False):
        tc = cfg.train
        et = cfg.encoder_time
        if (tc.cycle_consistency and et is not None and et.quantizer_levels
                and et.quantizer_noise_dropout > 0):
            # the JAX trainer re-encodes the cycle's estimate in training
            # with only a "dropout" rng, and its Encoder1D's FSQ noise
            # dropout then asks for a "sample" rng: flax raises
            # InvalidRngError at the first cycle step
            # (after_tpu/diffusion/trainer.py:313-316,
            # after_tpu/models/encoder.py:141-146)
            raise ValueError(
                "train.cycle_consistency with "
                "encoder_time.quantizer_noise_dropout > 0: the reference "
                "trainer cannot run this (its cycle re-encode raises flax's "
                "InvalidRngError), so the port refuses it")
        self.cfg, self.tc = cfg, tc
        # None (f32) or the type a diffusion step's models run at
        self.compute_dtype = compute_dtype(tc.compute_dtype)
        self.device = resolve_device(device)
        self.eager = eager
        strict_f32()
        self.rf = make_model(cfg).eval().to(self.device)
        # the encoders run without gradients in a classifier step: a weight
        # kept there would outlive the updates in a step's graph
        recompute_weights(self.rf)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        # the models the main optimizer trains, in its parameter order
        self.groups = {"net": self.rf.net, "encoder": self.rf.encoder}
        if self.rf.encoder_time is not None:
            self.groups["encoder_time"] = self.rf.encoder_time
        self._new_state()

    def _new_state(self) -> None:
        tc, rf = self.tc, self.rf
        self.params = [p for m in self.groups.values() for p in m.parameters()]
        self._group_of = [name for name, m in self.groups.items()
                          for _ in m.parameters()]
        self.optimizer = AdamW(self.params, tc.lr, 1.0, 0.9, 0.999,
                               tc.grad_clip)
        self.cls_optimizer = (AdamW(rf.classifier.parameters(), tc.lr, 1.0,
                                    0.9, 0.999, None)
                              if rf.classifier is not None else None)
        self.ema = [p.detach().clone() for p in rf.net.parameters()]
        self.step = 0
        # the steps' CUDA graphs, made at the first capture: {key: (state
        # key, graph, static inputs)}; new state tensors drop them
        self.graphs: Optional[GraphPool] = None
        self._graphs: Dict[tuple, tuple] = {}
        self._weights = torch.zeros(2, device=self.device)
        self._state = list(self._state_tensors())

    def init(self, seed: int = 0) -> "DiffusionTrainer":
        """Port-native random weights from ``seed`` (utils/init.py), fresh
        optimizer states, the EMA at the weights and step 0."""
        from ..utils.init import init_weights
        init_weights(self.rf, seed)
        self._new_state()
        return self

    def load_jax(self, variables: Mapping[str, Any],
                 ema_params: Optional[Mapping[str, Any]] = None
                 ) -> "DiffusionTrainer":
        """Weights of the JAX trainer's ``variables`` (``net``, ``encoder``,
        ``encoder_time``, ``classifier``, with their batch statistics) and
        its EMA tree (``ema_params``, the EMA at the weights when absent),
        as nested dicts of numpy arrays; fresh optimizers and step 0."""
        from ..utils.from_jax import load_denoiser, load_diffusion
        load_diffusion(self.rf, variables)
        self._new_state()
        if ema_params is not None:
            net = copy.deepcopy(self.rf.net)
            load_denoiser(net, {"params": ema_params})
            with torch.no_grad():
                for e, p in zip(self.ema, net.parameters()):
                    e.copy_(p)
        return self

    @contextlib.contextmanager
    def ema_weights(self):
        """Inside the block the denoiser holds the EMA weights (copied in
        and back out, so the tensors stay the same)."""
        params = list(self.rf.net.parameters())
        with torch.no_grad():
            saved = [p.detach().clone() for p in params]
            for p, e in zip(params, self.ema):
                p.copy_(e)
        try:
            yield
        finally:
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)

    # ------------------------------------------------------------------

    def upload(self, batch: Mapping[str, ArrayLike]) -> Dict[str, torch.Tensor]:
        """A batch {"x", "x_cond", "x_time_cond"} of (B, T, C) latents as
        f32 tensors on the device; an array that several keys share (the
        audio collate aliases x_time_cond to x) is uploaded once."""
        memo: Dict[int, torch.Tensor] = {}
        for v in batch.values():
            if id(v) not in memo:
                memo[id(v)] = to_device(v, self.device)
        return {k: memo[id(v)] for k, v in batch.items()}

    def _taker(self, draws: Optional[Mapping[str, Any]]
               ) -> Callable[[str, Callable[[], Any]], Any]:
        """take(name, make): ``draws[name]`` on the device when given, else
        make()."""
        if draws:
            unknown = set(draws) - set(DRAWS)
            if unknown:
                raise KeyError(f"unknown draws {sorted(unknown)}; known: "
                               f"{DRAWS}")

        def convert(v):
            if isinstance(v, (tuple, list)):
                return tuple(convert(u) for u in v)
            if isinstance(v, np.ndarray):
                v = np.array(v)        # a writable copy
            v = torch.as_tensor(v, device=self.device)
            return v.long() if not v.is_floating_point() else v.float()

        def take(name, make):
            if draws is not None and name in draws:
                return convert(draws[name])
            return make()
        return take

    def _timbre_vae(self, batch: int, take, name: str = "cond_vae"):
        """The timbre encoder's VAE sample noise (draw ``name``), or None
        where it has no VAE."""
        if self.cfg.encoder.regularisation != "vae":
            return None
        return take(name, lambda: torch.randn(
            (batch, self.cfg.encoder.out_dim), generator=self.generator,
            device=self.device))

    def _structure_vae(self, x: torch.Tensor, take):
        """The structure encoder's VAE sample noise for its input x, or
        None where it has no VAE."""
        et = self.rf.encoder_time
        if et is None or not et.cfg.vae_regularisation:
            return None
        return take("time_cond_vae", lambda: torch.randn(
            et.vae_noise_shape(x.shape[0], x.shape[1]),
            generator=self.generator, device=self.device))

    def _refuse_structure_vae(self, where: str) -> None:
        et = self.rf.encoder_time
        if et is not None and et.cfg.vae_regularisation:
            # C11: the JAX step runs the structure encoder there without a
            # "sample" rng, and its VAE raises flax's InvalidRngError
            # (after_tpu/diffusion/trainer.py:313-316, :416-417,
            # after_tpu/models/encoder.py:124-125)
            raise ValueError(
                f"the {where} with a vae structure encoder "
                "(encoder_time.vae_regularisation): the reference trainer "
                "cannot run this (it gives that encoder no sample noise and "
                "raises flax's InvalidRngError), so the port refuses it")

    def _shuffled(self, x: torch.Tensor, take) -> torch.Tensor:
        sizes = tuple(self.tc.shuffle_zsem)
        if not sizes:
            return x
        index = take("shuffle", lambda: shuffle_index(
            x.shape[0], x.shape[1], sizes, self.generator, self.device))
        return shuffle_time_chunks(x, index)

    def _adversarial_loss(self, pred: torch.Tensor,
                          target: torch.Tensor) -> torch.Tensor:
        if self.tc.adversarial_loss == "cosine":
            return _cos_loss(pred, target)
        return torch.mean(torch.square(pred - target))

    # ------------------------------------------------------------------
    # the diffusion step
    # ------------------------------------------------------------------

    def _loss(self, batch, take, phase1: bool, train_encoder: bool,
              train_encoder_time: bool, use_cycle: bool,
              adversarial_weight: float, regularisation_weight: float):
        """(loss, metrics, the batch statistics the step keeps)."""
        cfg, tc, rf = self.cfg, self.tc, self.rf
        gen, dev, cd = self.generator, self.device, self.compute_dtype
        x1 = batch["x"]
        x1_time_cond = to_compute(batch["x_time_cond"], cd)
        B = x1.shape[0]
        kept = TrainMode(gen)

        # timbre stream: shuffled chunks -> ECAPA -> noise augmentation (the
        # conditioning vectors and the losses in f32)
        x1_cond = self._shuffled(to_compute(batch["x_cond"], cd), take)
        with torch.set_grad_enabled(train_encoder):
            cond, _, cond_reg = cast_call(rf.encoder, cd, x1_cond,
                                          train=kept,
                                          noise=self._timbre_vae(B, take))
        cond, cond_reg = to_f32(cond, cd), to_f32(cond_reg, cd)
        cond = cond + tc.zsem_noise_aug * take("cond_noise", lambda: (
            torch.randn(cond.shape, generator=gen, device=dev)))

        # structure stream
        if rf.encoder_time is not None and not phase1:
            fsq_draws = take("fsq", lambda: None)
            vae = self._structure_vae(x1_time_cond, take)
            with torch.set_grad_enabled(train_encoder_time):
                time_cond, _, time_cond_reg = cast_call(
                    rf.encoder_time, cd, x1_time_cond, train=kept,
                    fsq_draws=fsq_draws, noise=vae)
            time_cond = to_f32(time_cond, cd)
            time_cond_reg = to_f32(time_cond_reg, cd)
        elif rf.encoder_time is None:
            time_cond, time_cond_reg = x1_time_cond, x1.new_zeros(())
        else:  # phase 1: the structure is dropped whole
            time_cond = x1.new_full((B, x1.shape[1], cfg.zs_channels),
                                    cfg.drop_value)
            time_cond_reg = x1.new_zeros(())
        time_cond = time_cond + tc.time_cond_noise_aug * take(
            "time_cond_noise", lambda: torch.randn(
                time_cond.shape, generator=gen, device=dev))

        # CFG dropout (phase 1 drops no condition on its own)
        targets = () if phase1 else tuple(tc.drop_targets)
        cond_drop, time_cond_drop = rf.cfgdrop(
            [cond, time_cond], targets, cfg.drop_rate,
            take("cfg_uniform", lambda: torch.rand(
                (B,), generator=gen, device=dev)))
        if phase1:
            time_cond_drop = torch.full_like(time_cond_drop, cfg.drop_value)

        # the adversarial term: its gradient reaches encoder_time through
        # the classifier; the classifier's statistics are not kept
        if rf.classifier is not None and not phase1:
            cond_pred = cast_call(rf.classifier, cd, to_compute(time_cond, cd),
                                  train=TrainMode(gen))[0]
            classifier_loss = self._adversarial_loss(to_f32(cond_pred, cd),
                                                     cond.detach())
        else:
            classifier_loss = x1.new_zeros(())

        x0 = take("x0", lambda: torch.randn(x1.shape, generator=gen,
                                            device=dev))
        level = take(rf.LEVEL_DRAW, lambda: rf.draw_level(B, gen, dev))
        diffusion_loss, (interpolant, tb) = rf.diffusion_loss(
            x1, time_cond_drop, cond_drop, x0, level, train=kept,
            compute_dtype=cd)

        if use_cycle:
            cond_cycle, tcond_cycle = self._cycle_losses(
                interpolant, tb, time_cond, cond, take)
        else:
            cond_cycle = tcond_cycle = x1.new_zeros(())

        cw = tuple(tc.cycle_weights) if use_cycle else (0.0, 0.0)
        loss = (diffusion_loss
                - adversarial_weight * classifier_loss
                + cw[0] * cond_cycle + cw[1] * tcond_cycle
                + regularisation_weight * torch.mean(cond_reg)
                + regularisation_weight * torch.mean(time_cond_reg))
        metrics = {
            "diffusion_loss": diffusion_loss,
            "adversarial_loss": classifier_loss,
            "cond_reg": torch.mean(cond_reg),
            "time_cond_reg": torch.mean(time_cond_reg),
            "cycle_cond": cond_cycle,
            "cycle_time_cond": tcond_cycle,
            "loss": loss,
        }
        return loss, metrics, kept

    def _cycle_losses(self, interpolant, t, time_cond, cond, take):
        """Cycle consistency, interpolant mode: a one-shot transfer toward
        swapped conditions, re-encoded by both encoders (training form,
        statistics not kept) against the detached targets."""
        tc, rf, dev = self.tc, self.rf, self.device
        B = cond.shape[0]
        perm = take("cycle_perm", lambda: torch.randperm(
            B, generator=self.generator, device=dev))
        if tc.cycle_swap_target == "cond":
            cond_t, tcond_t = cond[perm], time_cond
        elif tc.cycle_swap_target == "time_cond":
            cond_t, tcond_t = cond, time_cond[perm]
        else:  # alternate
            sel = torch.arange(B, device=dev) < B // 2
            cond_t = torch.where(sel[:, None], cond, cond[perm])
            tcond_t = torch.where(sel[:, None, None], time_cond[perm],
                                  time_cond)
        cond_t, tcond_t = cond_t.detach(), tcond_t.detach()

        cd = self.compute_dtype
        self._refuse_structure_vae("cycle step")
        x_transfer = rf.transfer_estimate(interpolant, t, cond_t, tcond_t,
                                          compute_dtype=cd)
        scratch = TrainMode(self.generator)
        x_in = to_compute(x_transfer, cd)
        cond_rec = to_f32(cast_call(
            rf.encoder, cd, x_in, train=scratch,
            noise=self._timbre_vae(B, take, "cycle_cond_vae"))[0], cd)
        tcond_rec = to_f32(cast_call(rf.encoder_time, cd, x_in,
                                     train=scratch)[0], cd)

        lt = tc.cycle_loss_type
        if lt == "cosine":
            c_loss = _cos_loss(cond_rec, cond_t)
            t_loss = _cos_loss(tcond_rec, tcond_t)
        elif lt.startswith("mse_margin"):
            margin = float(lt.split("_")[-1])
            c_loss = torch.clamp_min(torch.square(cond_rec - cond_t), margin)
            t_loss = torch.clamp_min(torch.square(tcond_rec - tcond_t), margin)
        else:  # mse
            c_loss = torch.square(cond_rec - cond_t)
            t_loss = torch.square(tcond_rec - tcond_t)
        if tc.cycle_scaling == "ramps" and c_loss.dim() > 0:
            scale = 0.5 * (1 + torch.tanh(7 * (0.4 - t[:, 0, 0])))
            c_loss = scale[:, None] * c_loss
        return torch.mean(c_loss), torch.mean(t_loss)

    def _keep(self, phase1: bool, train_encoder: bool,
              train_encoder_time: bool) -> Dict[str, bool]:
        return {"net": True, "encoder": train_encoder,
                "encoder_time": (not phase1) and train_encoder_time}

    def train_grads(self, batch: Mapping[str, ArrayLike], phase1: bool,
                    train_encoder: bool, train_encoder_time: bool,
                    use_cycle: bool, adversarial_weight: float,
                    regularisation_weight: float,
                    draws: Optional[Mapping[str, Any]] = None
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, List[torch.Tensor]], TrainMode]:
        """A diffusion step without its update: (metrics, the gradients of
        each trained model's parameters by model name, in ``parameters()``
        order, zeros for a frozen model, the step's pending batch
        statistics).  Runs op by op."""
        return self._train_grads(
            self.upload(batch), self._taker(draws),
            (phase1, train_encoder, train_encoder_time, use_cycle),
            (adversarial_weight, regularisation_weight))

    def _train_grads(self, batch, take, flags, weights):
        phase1, train_encoder, train_encoder_time, _ = flags
        keep = self._keep(phase1, train_encoder, train_encoder_time)
        loss, metrics, kept = self._loss(batch, take, *flags, *weights)
        wanted = [p for p, g in zip(self.params, self._group_of) if keep[g]]
        got = iter(torch.autograd.grad(loss, wanted, allow_unused=True))
        grads: Dict[str, List[torch.Tensor]] = {}
        for name, module in self.groups.items():
            grads[name] = []
            for p in module.parameters():
                g = next(got) if keep[name] else None
                grads[name].append(torch.zeros_like(p) if g is None else g)
        return {k: v.detach() for k, v in metrics.items()}, grads, kept

    def _train_update(self, batch, take, flags, weights
                      ) -> Dict[str, torch.Tensor]:
        """One diffusion step on a device batch; its metrics."""
        metrics, grads, kept = self._train_grads(batch, take, flags, weights)
        keep = self._keep(*flags[:3])
        self.optimizer.step([g for name in self.groups for g in grads[name]],
                            [keep[g] for g in self._group_of])
        metrics["skipped_nonfinite"] = self.optimizer.total_notfinite.clone()
        kept.commit(self.optimizer.finite)
        decay = self.tc.ema_decay
        with torch.no_grad():
            torch._foreach_mul_(self.ema, decay)
            torch._foreach_add_(self.ema, list(self.rf.net.parameters()),
                                alpha=1 - decay)
        return metrics

    def train_step(self, batch: Mapping[str, ArrayLike], phase1: bool,
                   train_encoder: bool, train_encoder_time: bool,
                   use_cycle: bool, adversarial_weight: float,
                   regularisation_weight: float,
                   draws: Optional[Mapping[str, Any]] = None
                   ) -> Dict[str, Any]:
        """One diffusion step: the update of the trained models, their
        batch statistics when the gradients are finite, the EMA; returns the
        metrics with the count of skipped updates (``skipped_nonfinite``),
        as device tensors of their own."""
        return self._diffusion(
            batch, (phase1, train_encoder, train_encoder_time, use_cycle),
            (adversarial_weight, regularisation_weight), draws)

    def _diffusion(self, batch, flags, weights, draws=None):
        flags = tuple(map(bool, flags))
        return self._run(
            ("diffusion", *flags),
            lambda b, take, w: self._train_update(b, take, flags, w),
            batch, tuple(weights), draws)

    # ------------------------------------------------------------------
    # the classifier step
    # ------------------------------------------------------------------

    def classifier_grads(self, batch: Mapping[str, ArrayLike],
                         draws: Optional[Mapping[str, Any]] = None
                         ) -> Tuple[Dict[str, torch.Tensor],
                                    List[torch.Tensor], TrainMode]:
        """A classifier step without its update: (metrics, the gradients of
        the classifier's parameters, its pending batch statistics).  Both
        encoders run at inference, without gradients.  Runs op by op."""
        if self.rf.classifier is None:
            raise ValueError("the config has no adversarial classifier")
        return self._classifier_grads(self.upload(batch), self._taker(draws))

    def _classifier_grads(self, batch, take):
        rf = self.rf
        self._refuse_structure_vae("classifier step")
        with torch.no_grad():
            x_cond = self._shuffled(batch["x_cond"], take)
            cond = rf.encoder(x_cond, noise=self._timbre_vae(
                x_cond.shape[0], take))[0]
            time_cond = rf.encoder_time(batch["x_time_cond"])[0]
        kept = TrainMode(self.generator)
        pred = rf.classifier(time_cond, train=kept)[0]
        loss = self._adversarial_loss(pred, cond)
        grads = torch.autograd.grad(loss, list(rf.classifier.parameters()))
        return {"classifier_loss": loss.detach()}, list(grads), kept

    def _classifier_update(self, batch, take, weights=None
                           ) -> Dict[str, torch.Tensor]:
        metrics, grads, kept = self._classifier_grads(batch, take)
        self.cls_optimizer.step(grads)
        kept.commit(self.cls_optimizer.finite)
        return metrics

    def classifier_step(self, batch: Mapping[str, ArrayLike],
                        draws: Optional[Mapping[str, Any]] = None
                        ) -> Dict[str, torch.Tensor]:
        """One update of the classifier (and its batch statistics when the
        gradients are finite); its metrics, as device tensors of their
        own."""
        if self.rf.classifier is None:
            raise ValueError("the config has no adversarial classifier")
        return self._classifier(batch, draws)

    def _classifier(self, batch, draws=None):
        return self._run(("classifier",), self._classifier_update, batch,
                         None, draws)

    # ------------------------------------------------------------------
    # the steps as CUDA graphs
    # ------------------------------------------------------------------

    @property
    def graphed(self) -> bool:
        """Whether steps run as CUDA graphs (on the card, unless
        ``eager``)."""
        return self.device.type == "cuda" and not self.eager

    def _state_tensors(self):
        """What a step's graph reads and writes in place besides its static
        inputs: the models' parameters and statistics, both optimizers'
        state and the EMA."""
        yield from self.rf.parameters()
        yield from self.rf.buffers()
        yield from self.ema
        for opt in (self.optimizer, self.cls_optimizer):
            if opt is not None:
                yield from (opt._mu, opt._nu, opt.count, opt.notfinite_count,
                            opt.total_notfinite, opt.finite)

    def _run(self, signature: tuple, update: Callable[..., Dict],
             batch: Mapping[str, ArrayLike], weights: Optional[tuple],
             draws: Optional[Mapping[str, Any]]) -> Dict[str, torch.Tensor]:
        """update(device batch, take, weights), one step: op by op (with
        ``draws``, ``eager`` or on the CPU), or as the graph of
        ``signature`` and the batch's layout and shapes.  Returns its
        metrics (a replay's as copies: the next replay overwrites the
        graph's outputs).

        The graph's inputs are static buffers: one per distinct array of
        the batch (keys that share an array share a buffer) and the weights
        as device scalars.  At the first step with its key the step runs on
        the pool's side stream and is captured after it; the generator is
        registered with the graph."""
        if draws is not None or not self.graphed:
            return update(self.upload(batch), self._taker(draws), weights)
        arrays: List[Any] = []
        slots: Dict[int, int] = {}
        layout = []
        for k, v in batch.items():
            if id(v) not in slots:
                slots[id(v)] = len(arrays)
                arrays.append(v)
            layout.append((k, slots[id(v)]))
        key = (signature, tuple(layout),
               tuple(tuple(np.shape(a)) for a in arrays))
        check = (state_key(self._state), id(self.generator))
        entry = self._graphs.get(key)
        statics = entry[2] if entry is not None else [
            torch.empty(np.shape(a), device=self.device) for a in arrays]
        for buf, a in zip(statics, arrays):
            copy_from_host(buf, a)
        if weights is not None:
            copy_from_host(self._weights, np.asarray(weights, np.float32))
        if entry is not None and entry[0] == check:
            return {k: v.clone() for k, v in entry[1].replay().items()}

        static_batch = {k: statics[i] for k, i in layout}
        w = (self._weights[0], self._weights[1]) if weights is not None \
            else None

        def step():
            return update(static_batch, self._taker(None), w)
        if self.graphs is None:
            self.graphs = GraphPool(self.device)
        metrics = self.graphs.warm(step)
        self._graphs[key] = (check, self.graphs.capture(
            step, generators=(self.generator,)), statics)
        return metrics

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    def schedule_weights(self, step: int) -> Tuple[float, float]:
        """(adversarial, regularisation) weights at ``step``: linear ramps
        after the timbre warm-up and from step 0."""
        tc = self.tc
        adv = min(tc.adversarial_weight * max(step - tc.timbre_warmup, 0)
                  / tc.adversarial_warmup, tc.adversarial_weight)
        reg = min(tc.regularisation_weight * step
                  / max(tc.regularisation_warmup, 1),
                  tc.regularisation_weight)
        return adv, reg

    def step_flags(self, step: int) -> Tuple[bool, bool, bool, bool]:
        """(phase1, train_encoder, train_encoder_time, use_cycle) of a
        diffusion step at ``step``."""
        tc = self.tc
        return (step < tc.timbre_warmup,
                tc.train_encoder and step <= tc.stop_training_encoder_step,
                (tc.train_encoder_time
                 and step <= tc.stop_training_encoder_time_step),
                tc.cycle_consistency and step > tc.cycle_start_step)

    def step_kind(self, step: int) -> str:
        """What ``fit`` runs at ``step``: "phase1", "classifier", "cycle" or
        "diffusion"."""
        phase1, _, _, use_cycle = self.step_flags(step)
        if phase1:
            return "phase1"
        if (self.rf.classifier is not None
                and step % self.tc.update_classifier_every != 0):
            return "classifier"
        return "cycle" if use_cycle else "diffusion"

    def fit(self, batches: Iterable[Mapping[str, ArrayLike]],
            max_steps: Optional[int] = None,
            callback: Optional[Callable[["DiffusionTrainer", Dict], None]]
            = None, mesh=None) -> "DiffusionTrainer":
        """Train on ``batches`` of latent crops {"x", "x_cond",
        "x_time_cond"} until ``max_steps`` (``train.max_steps`` by
        default); ``callback(self, metrics)`` after each step, or after
        each window of ``train.steps_per_call`` steps with the window's
        metrics (``window``), the metrics as device tensors.  Training
        across devices (``mesh``) is not ported."""
        if mesh is not None:
            raise NotImplementedError(
                "the port trains on one device: no mesh or DDP yet")
        tc = self.tc
        max_steps = max_steps if max_steps is not None else tc.max_steps
        K = max(int(tc.steps_per_call or 1), 1)
        # windows take their batches from inside the loop: an iterator, so
        # that a list cannot replay its head
        batches = iter(batches)
        # the curriculum's boundaries, which a window never crosses
        boundaries = sorted({tc.timbre_warmup, tc.cycle_start_step + 1,
                             tc.stop_training_encoder_step + 1,
                             tc.stop_training_encoder_time_step + 1,
                             max_steps})

        def window_clear(step):
            return (step + K <= max_steps
                    and not any(step < b < step + K for b in boundaries))

        def single(batch):
            metrics = self._single(batch)
            if callback is not None:
                callback(self, metrics)

        for batch in batches:
            if self.step >= max_steps:
                break
            if K > 1 and self.step % K == 0 and window_clear(self.step):
                window = [batch]
                for nxt in batches:
                    window.append(nxt)
                    if len(window) == K:
                        break
                if len(window) == K:
                    metrics = self.window(window)
                    if callback is not None:
                        callback(self, metrics)
                    continue
                # the iterator ran dry inside a window: single steps
                for b in window:
                    if self.step >= max_steps:
                        break
                    single(b)
                break
            single(batch)
        return self

    def _single(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """The step ``fit`` runs at ``self.step``, which it then counts."""
        step = self.step
        if self.step_kind(step) == "classifier":
            metrics = self._classifier(batch, draws)
        else:
            metrics = self._diffusion(batch, self.step_flags(step),
                                      self.schedule_weights(step), draws)
        self.step += 1
        return metrics

    def window(self, batches: Sequence[Mapping[str, ArrayLike]],
               draws: Optional[Sequence[Mapping[str, Any]]] = None
               ) -> Dict[str, torch.Tensor]:
        """len(batches) steps from ``self.step``, one a batch, as ``fit``
        runs a window (the caller sees to it that no curriculum boundary
        falls inside it), with the metrics averaged on the device and
        nothing read back: the JAX ``multi_step``'s metrics, the diffusion
        metrics averaged over the window's diffusion steps,
        ``classifier_loss`` over its classifier steps (0 where it has none)
        and ``skipped_nonfinite`` the running count after its last
        diffusion step.  ``draws`` gives each step's draws (the steps then
        run op by op)."""
        draws = draws if draws is not None else [None] * len(batches)
        steps = [self._single(b, d) for b, d in zip(batches, draws)]
        cls = [m for m in steps if "classifier_loss" in m]
        diff = [m for m in steps if "classifier_loss" not in m]

        def mean(rows, key):
            if not rows:
                return torch.zeros((), device=self.device)
            return torch.stack([m[key] for m in rows]).mean()
        out = {k: mean(diff, k) for k in DIFFUSION_METRICS}
        out["classifier_loss"] = mean(cls, "classifier_loss")
        out["skipped_nonfinite"] = (
            diff[-1]["skipped_nonfinite"] if diff
            else torch.zeros((), dtype=torch.int32, device=self.device))
        return out

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def _models(self) -> Dict[str, torch.nn.Module]:
        models = dict(self.groups)
        if self.rf.classifier is not None:
            models["classifier"] = self.rf.classifier
        return models

    def state_tree(self) -> Dict[str, Any]:
        """The whole train state for ``utils.checkpoint.save_checkpoint``:
        the models' state dicts (``variables``), the EMA by parameter name,
        both optimizer states and the step."""
        names = [n for n, _ in self.rf.net.named_parameters()]
        tree = {"variables": {n: m.state_dict()
                              for n, m in self._models().items()},
                "ema_params": dict(zip(names, self.ema)),
                "opt_state": self.optimizer.state_dict(),
                "step": self.step}
        if self.cls_optimizer is not None:
            tree["cls_opt_state"] = self.cls_optimizer.state_dict()
        return tree

    def load_state_tree(self, tree: Mapping[str, Any],
                        load_encoders=(True, True, True)) -> None:
        """Restart from a ``state_tree``, as the JAX CLI restarts: the models
        through ``filter_partial_load`` (``load_encoders`` masks encoder,
        encoder_time, net), the EMA and each optimizer state only where
        they still fit the current models, else fresh."""
        from ..utils.checkpoint import filter_partial_load, shapes_compatible
        models = self._models()
        variables = filter_partial_load(
            tree["variables"], {n: m.state_dict() for n, m in models.items()},
            load_encoders)
        for name, module in models.items():
            module.load_state_dict(variables[name])
        self._new_state()
        ema = tree.get("ema_params")
        if ema is not None and shapes_compatible(ema, self.ema):
            with torch.no_grad():
                for e, v in zip(self.ema, ema.values()):
                    e.copy_(v)
        elif ema is not None:
            print("[train] ema_params in checkpoint don't match the "
                  "current net; EMA restarts from the net params")
        for key, opt in (("opt_state", self.optimizer),
                         ("cls_opt_state", self.cls_optimizer)):
            state = tree.get(key)
            if opt is None or state is None:
                continue
            if shapes_compatible(state, opt.state_dict()):
                opt.load_state_dict(state)
            else:
                print(f"[train] {key} in checkpoint doesn't match the "
                      "current config; optimizer restarts fresh")
        if "opt_state" not in tree:
            print("[train] checkpoint has no ['opt_state']; optimizer "
                  "restarts fresh")
        self.step = int(tree["step"])
