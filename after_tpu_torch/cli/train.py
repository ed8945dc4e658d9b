"""Validation of diffusion training (counterpart of the validation half of
after_tpu/cli/train.py).

- ``validate``: the mean diffusion loss over fixed validation batches;
- ``val_transfer_margin``: how far sampled transfers move toward the
  requested timbre, in latent space and, with the codec, across the decode
  and encode round trip;
- ``make_codec_coder``: the codec's (decode, encode) pair for that round
  trip, from a codec checkpoint of the port.

The flow's noise is an argument of each function; without it each draws it
from a ``torch.Generator`` seeded as the JAX functions seed their keys.  The
command itself (``main``: stores, loaders, restarts) waits for the port of
the dataset store modules, and ``sample_validation_audio`` for the port of
utils/logging.py.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device

Coder = Tuple[Callable[[Any], torch.Tensor], Callable[[Any], torch.Tensor]]


def _encode_conditions(trainer, batch):
    rf = trainer.rf
    cond = rf.encode_timbre(batch["x_cond"])[0]
    tcond = rf.encode_structure(batch["x_time_cond"])[0]
    return cond, tcond


@torch.no_grad()
def validate(trainer, val_batches: Sequence[Dict[str, Any]],
             draws: Optional[Sequence[Tuple[Any, Any]]] = None) -> float:
    """Mean diffusion loss of ``trainer.rf`` (not the EMA, no dropout) over
    the fixed validation batches.  ``draws[i]`` is batch i's (x0, t); by
    default both come from a generator seeded i."""
    losses = []
    for i, b in enumerate(val_batches):
        batch = trainer.upload(b)
        cond, tcond = _encode_conditions(trainer, batch)
        x = batch["x"]
        if draws is None:
            gen = torch.Generator(trainer.device).manual_seed(i)
            x0 = torch.randn(x.shape, generator=gen, device=trainer.device)
            t = torch.rand((x.shape[0],), generator=gen,
                           device=trainer.device)
        else:
            x0, t = (torch.as_tensor(np.array(v, np.float32),
                                     device=trainer.device) for v in draws[i])
        loss, _ = trainer.rf.diffusion_loss(x, tcond, cond, x0, t)
        losses.append(float(loss))
    return float(np.mean(losses))


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    num = torch.sum(a * b, dim=1)
    den = (torch.linalg.vector_norm(a, dim=1)
           * torch.linalg.vector_norm(b, dim=1) + 1e-9)
    return num / den


@torch.no_grad()
def val_transfer_margin(trainer, val_batches: Sequence[Dict[str, Any]],
                        nb_steps: int = 20, codec: Optional[Coder] = None,
                        gate_guidance: float = 2.0,
                        x0: Optional[Any] = None) -> Dict[str, float]:
    """Transfer proximity on the first validation batch: sample with the
    EMA weights a transfer whose timbre target is each row's neighbour's
    (rolled by one), re-embed it with the timbre encoder and report
    mean[cos(out, target) - cos(out, source)] (``val_transfer_margin``).

    With ``codec`` (``make_codec_coder``) it also samples the first 16 rows
    at ``gate_guidance``, decodes them to audio, encodes them again and
    reports the same margin (``val_transfer_margin_audio``).  ``x0`` is the
    sampler's noise, by default drawn from a generator seeded 0."""
    rf = trainer.rf
    batch = trainer.upload(val_batches[0])
    cond, tcond = _encode_conditions(trainer, batch)
    x = batch["x"]
    tgt = torch.roll(cond, -1, dims=0)
    if x0 is None:
        x0 = torch.randn(x.shape, device=trainer.device,
                         generator=torch.Generator(trainer.device)
                         .manual_seed(0))
    else:
        x0 = torch.as_tensor(np.array(x0, np.float32), device=trainer.device)
    with trainer.ema_weights():
        x_tr = rf.sample(x0, tgt, tcond, nb_steps)
        if codec is not None:
            n = min(16, x.shape[0])     # bounds the decode on big batches
            x_g = rf.sample(x0[:n], tgt[:n], tcond[:n], nb_steps,
                            gate_guidance)
    e_out = rf.encode_timbre(x_tr)[0]
    out = {"val_transfer_margin": float(torch.mean(
        _cosine(e_out, tgt) - _cosine(e_out, cond)))}
    if codec is not None:
        decode, encode = codec
        e_aud = rf.encode_timbre(encode(decode(x_g)))[0]
        out["val_transfer_margin_audio"] = float(torch.mean(
            _cosine(e_aud, tgt[:n]) - _cosine(e_aud, cond[:n])))
    return out


def make_codec_coder(ckpt_dir: str,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Coder:
    """The codec of a port checkpoint (``checkpoint_<step>/`` with the tree
    {"codec_vars": state dict} or the state dict itself, and the codec's
    ``config.json``) as a (decode, encode) pair of latents -> audio and
    audio -> latents on ``device``, the card unless ``"cpu"``."""
    from ..config import load_codec_config
    from ..models.autoencoder import AudioCodec
    from ..utils.checkpoint import restore_checkpoint

    device = resolve_device(device)
    tree = restore_checkpoint(ckpt_dir)
    codec = AudioCodec(load_codec_config(ckpt_dir)).eval().to(device)
    codec.load_state_dict(tree.get("codec_vars", tree))

    def tensor(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    @torch.inference_mode()
    def decode(z) -> torch.Tensor:
        return codec.decode(tensor(z))

    @torch.inference_mode()
    def encode(audio) -> torch.Tensor:
        return codec.encode(tensor(audio))

    return decode, encode
