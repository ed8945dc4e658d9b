"""The legacy Denoiser v1, offline and streaming (counterpart of
after_tpu/models/denoiser_v1.py): cross-attention structure conditioning
and per-frame (temporal) noise levels.

Where it differs from DenoiserV2 (models/denoiser.py):

- ``tcond_mode="cross_attention"``: the structure codes are the keys and
  values of a cross-attention in every block, with rotary positions and a
  learnable position table (``pos_embed_ca``) of their own; ``"adaln"``
  modulates each frame from them instead, at their own width;
- ``temporal_noise``: each frame's noise level is Fourier-embedded and
  concatenated to the structure codes, and the global embedding carries the
  timbre vector alone;
- the patchify runs a LayerNorm, and each block normalises without
  condition after its self-attention (``norm2``) before the AdaLN of the
  global embedding;
- an optional depthwise-separable MLP (``mlp_type="sep_conv"``), whose
  depthwise conv has kernel size 1 (a per-channel scale and bias).

Streaming: both attentions keep the per-step KV caches of DenoiserV2's
(``MaskedAttention``); the cross-attention's window is causal only with
``cross_attn_causal``, and ``pos_embed_ca`` indexes the current chunk's
positions, as in the JAX package.  The submodules carry the flax names,
flax's own for the unnamed global embedding (``Dense_0``, ``Dense_1``) and
the separable MLP (``Dense_0``, ``Conv_0``, ``Dense_1``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DenoiserConfig
from ..ops.train_mode import TrainMode, dropout
from ..streaming.state import Cache, name_slots
from .denoiser import LN_EPS, MLP, MaskedAttention, fourier_features


@dataclasses.dataclass(frozen=True)
class DenoiserV1Config:
    base: DenoiserConfig = dataclasses.field(default_factory=DenoiserConfig)
    tcond_mode: str = "cross_attention"       # "cross_attention" | "adaln"
    temporal_noise: bool = False
    mlp_type: str = "mlp"                     # "mlp" | "sep_conv"
    # the chunk-wise causal window on the cross-attention offline too, so
    # that a streamed model sees in training what it sees when streaming
    cross_attn_causal: bool = False


class _Attention(MaskedAttention):
    """v1's attention over given projections: masked by the chunk-wise
    causal window where ``causal_mask`` and the config's ``causal`` both
    say so (offline and streaming alike)."""

    def __init__(self, cfg: DenoiserConfig, causal_mask: bool = True,
                 streaming: bool = False):
        super().__init__(cfg, streaming)
        self.causal_mask = causal_mask

    def _masked(self) -> bool:
        return self.causal_mask and self.cfg.causal

    def forward(self, q, k, v, cache: Optional[Cache] = None,
                cache_index: Union[int, torch.Tensor] = 0,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        return self.attend(q, k, v, cache, cache_index, train)


class SepConvMLP(nn.Module):
    """Dense -> depthwise conv of kernel 1 -> GELU -> Dense -> dropout."""

    def __init__(self, embed_dim: int, mlp_multiplier: int,
                 dropout: float = 0.0):
        super().__init__()
        hid = mlp_multiplier * embed_dim
        self.dropout = dropout
        self.Dense_0 = nn.Linear(embed_dim, hid)
        self.Conv_0 = nn.Conv1d(hid, hid, 1, groups=hid)
        self.Dense_1 = nn.Linear(hid, embed_dim)

    def forward(self, x: torch.Tensor,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        h = self.Dense_0(x)
        h = h * self.Conv_0.weight[:, 0, 0] + self.Conv_0.bias
        return dropout(self.Dense_1(F.gelu(h)), self.dropout, train)


class DecoderBlockV1(nn.Module):
    """[AdaLN(tcond)] -> self-attn + res -> LayerNorm -> AdaLN(cond) ->
    [cross-attn over tcond + res] -> MLP + res.  ``tcond_width`` is the
    width of the structure features it is given (embed_dim for the
    cross-attention)."""

    def __init__(self, cfg: DenoiserV1Config, tcond_width: int,
                 streaming: bool = False):
        super().__init__()
        base = cfg.base
        E = base.embed_dim
        self.use_ca = cfg.tcond_mode == "cross_attention"
        if not self.use_ca:
            self.tcond_linear = nn.Linear(tcond_width, 2 * E)
        self.norm1 = nn.LayerNorm(E, eps=LN_EPS)
        self.qkv = nn.Linear(E, 3 * E, bias=False)
        self.self_attn = _Attention(base, streaming=streaming)
        self.cond_linear = nn.Linear(E, 2 * E)
        if self.use_ca:
            self.norm4 = nn.LayerNorm(E, eps=LN_EPS)
            self.q_linear = nn.Linear(E, E, bias=False)
            self.kv_linear = nn.Linear(E, 2 * E, bias=False)
            self.cross_attn = _Attention(
                base, causal_mask=cfg.cross_attn_causal, streaming=streaming)
        self.norm3 = nn.LayerNorm(E, eps=LN_EPS)
        self.mlp = (SepConvMLP if cfg.mlp_type == "sep_conv" else MLP)(
            E, base.mlp_multiplier, base.dropout)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor],
                tcond: Optional[torch.Tensor], cache: Optional[Cache] = None,
                cache_index: Union[int, torch.Tensor] = 0,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        E = x.shape[-1]
        if tcond is not None and not self.use_ca:
            x = F.layer_norm(x, (E,), eps=LN_EPS)
            alpha, beta = self.tcond_linear(tcond).chunk(2, dim=-1)
            x = x * (1 + alpha) + beta
        q, k, v = self.qkv(self.norm1(x)).chunk(3, dim=-1)
        x = self.self_attn(q, k, v, cache, cache_index, train) + x
        # v1 normalises whether or not a condition follows
        x = F.layer_norm(x, (E,), eps=LN_EPS)
        if cond is not None:
            alpha, beta = self.cond_linear(cond).chunk(2, dim=-1)
            if alpha.dim() == 2:
                alpha, beta = alpha[:, None], beta[:, None]
            x = x * (1 + alpha) + beta
        if tcond is not None and self.use_ca:
            q = self.q_linear(self.norm4(x))
            k, v = self.kv_linear(tcond).chunk(2, dim=-1)
            x = self.cross_attn(q, k, v, cache, cache_index, train) + x
        return self.mlp(self.norm3(x), train) + x


class DenoiserV1(nn.Module):
    """The v1 denoiser v(x_t, t, timbre, structure).  ``cond_in`` and
    ``tcond_in`` are the widths of the timbre vector and of the structure
    codes fed to it (``zt_channels`` and ``zs_channels``); a streaming one
    takes (B, chunk, C) steps with the KV cache and the Euler step's
    ``cache_index``."""

    def __init__(self, cfg: DenoiserV1Config, cond_in: Optional[int] = None,
                 tcond_in: Optional[int] = None, streaming: bool = False):
        super().__init__()
        base = cfg.base
        if streaming and base.pos_emb_type == "learnable":
            raise ValueError("streaming DenoiserV1 requires rotary or no "
                             "positional embedding (learnable restarts "
                             "every chunk)")
        self.cfg = cfg
        E, nd = base.embed_dim, base.noise_embed_dims
        cond_in = base.cond_dim if cond_in is None else cond_in
        tcond_in = base.tcond_dim if tcond_in is None else tcond_in
        # the global embedding (flax's Sequential names its Dense layers
        # in the parent's scope)
        self.Dense_0 = nn.Linear(cond_in if cfg.temporal_noise
                                 else nd + cond_in, E)
        self.Dense_1 = nn.Linear(E, E)
        self.patchify = nn.Linear(base.n_channels, E)
        self.patchify_norm = nn.LayerNorm(E, eps=LN_EPS)
        if base.pos_emb_type == "learnable":
            self.pos_embed = nn.Parameter(torch.zeros(base.seq_len, E))
        d = tcond_in + (nd if cfg.temporal_noise else 0)
        if cfg.tcond_mode == "cross_attention":
            self.tcond_patchify = nn.Linear(d, E)
            self.tcond_norm = nn.LayerNorm(E, eps=LN_EPS)
            self.pos_embed_ca = nn.Parameter(torch.zeros(base.seq_len, E))
            width = E
        else:
            self.tcond_patchify = nn.Linear(d, d)
            self.tcond_norm = nn.LayerNorm(d, eps=LN_EPS)
            width = d
        for i in range(base.n_layers):
            self.add_module(f"block_{i}",
                            DecoderBlockV1(cfg, width, streaming))
        self.out_proj = nn.Linear(E, base.n_channels)
        name_slots(self)

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                cond: Optional[torch.Tensor] = None,
                time_cond: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None,
                cache_index: Union[int, torch.Tensor] = 0,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        cfg, base = self.cfg, self.cfg.base
        B, T, _ = x.shape
        nd = base.noise_embed_dims

        def embed(h):
            return self.Dense_1(F.gelu(self.Dense_0(h)))

        if cfg.temporal_noise:
            if time.dim() == 1 or time.shape[-1] == 1:
                time = time.reshape(B, 1).expand(B, T)
            tnl = fourier_features(time, nd).reshape(B, T, nd)
            features = embed(cond) if cond is not None else None
            tcond_in = (torch.cat([time_cond, tnl], dim=-1)
                        if time_cond is not None else tnl)
        else:
            noise_level = fourier_features(time, nd)
            features = embed(torch.cat([noise_level, cond], dim=-1)
                             if cond is not None else noise_level)
            tcond_in = time_cond
        h = self.patchify_norm(self.patchify(x))
        if base.pos_emb_type == "learnable":
            h = h + self.pos_embed[None, :T]
        tc = None
        if tcond_in is not None:
            tc = self.tcond_norm(self.tcond_patchify(tcond_in))
            if cfg.tcond_mode == "cross_attention":
                tc = tc + self.pos_embed_ca[None, :tc.shape[1]]
        for i in range(base.n_layers):
            h = getattr(self, f"block_{i}")(h, features, tc, cache,
                                            cache_index, train)
        return self.out_proj(h)
