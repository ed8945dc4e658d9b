"""DiT-style chunk-wise causal denoiser DenoiserV2, offline and streaming
(counterpart of after_tpu/models/denoiser.py).

Layout is (B, T, C) throughout.  Attention is a plain masked softmax over
``torch.matmul`` products, as the JAX package leaves it to XLA; it has no
output projection.  LayerNorms use flax's eps of 1e-6 and GELU is exact.
A training forward (``train``, ops/train_mode.py) applies dropout to the
attention probabilities and to the MLP's output; without it there is none.
Below f32 a dense layer rounds its product before adding its bias, as
flax's ``Dense`` does (``Dense``).

Streaming (``streaming=True``): each attention layer keeps one KV slot per
Euler step, ``k`` and ``v`` of shape (B, max_diffusion_steps, heads,
local_attention_size, head_dim), and a per-step count of the slots written
so far, ``filled`` (max_diffusion_steps,), shared across the batch.  A call
with ``cache_index`` i attends over slot i followed by its own frames,
masks the slots not written yet, then rolls its keys into slot i; i is a
Python int or, in a traced program, an int64 0-d tensor (``KVSlot``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import DenoiserConfig
from ..ops.masks import (NEG_INF, mask_bias, sliding_chunkwise_mask,
                         streaming_mask)
from ..ops.rotary import apply_rotary, rotary_angles
from ..ops.train_mode import TrainMode, dropout
from ..streaming.state import Cache, Streaming, name_slots

LN_EPS = 1e-6


_FREQS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def _freqs(half: int, max_positions: float,
           device: torch.device) -> torch.Tensor:
    """(half,) frequencies max_positions^(-i / half), made once per device:
    a copy from the host on every call would stall the card and could not
    be captured in a CUDA graph."""
    key = (half, max_positions, device)
    if key not in _FREQS:
        with torch.inference_mode(False), torch.no_grad():
            exponent = torch.arange(half, dtype=torch.float32,
                                    device=device) / half
            _FREQS[key] = torch.pow(torch.tensor(
                1.0 / max_positions, dtype=torch.float32, device=device),
                exponent)
    return _FREQS[key]


def fourier_features(t: torch.Tensor, num_channels: int,
                     max_positions: float = 10_000.0,
                     factor: float = 100.0) -> torch.Tensor:
    """Noise-level embedding: (B,) times in [0, 1] -> (B, num_channels)
    [cos | sin] features, computed in f32 and returned at t's dtype (bf16
    under a compute dtype), as in the JAX package."""
    dtype = t.dtype
    t = t.reshape(-1).to(torch.float32) * factor
    freqs = _freqs(num_channels // 2, max_positions, t.device)
    ang = t[:, None] * freqs[None, :]
    out = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    return out if dtype == torch.float32 else out.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` as flax's ``Dense``: below f32 the product is rounded,
    then the bias added (F.linear adds it before its one rounding)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32 or self.bias is None:
            return F.linear(x, self.weight, self.bias)
        return F.linear(x, self.weight) + self.bias


class MLP(nn.Module):

    def __init__(self, embed_dim: int, mlp_multiplier: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.Dense_0 = Dense(embed_dim, mlp_multiplier * embed_dim)
        self.Dense_1 = Dense(mlp_multiplier * embed_dim, embed_dim)

    def forward(self, x: torch.Tensor,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        return dropout(self.Dense_1(F.gelu(self.Dense_0(x))), self.dropout,
                       train)


class KVSlot:
    """The KV-cache slot of one Euler step, along an axis of the cache: a
    Python int (a view of the slot, read and written in place; the form a
    CUDA graph of each slot bakes in) or an int64 0-d tensor (read with
    ``index_select`` and written with ``index_copy_``, the form a traced
    program takes as a runtime input: one program serves every slot).  Both
    give the same bits."""

    def __init__(self, index: Union[int, torch.Tensor]):
        self.index = index

    def read(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        if isinstance(self.index, int):
            return t.select(axis, self.index)
        return t.index_select(axis, self.index.reshape(1)).squeeze(axis)

    def write(self, t: torch.Tensor, axis: int, value: torch.Tensor) -> None:
        if isinstance(self.index, int):
            t.select(axis, self.index).copy_(value)
        else:
            t.index_copy_(axis, self.index.reshape(1),
                          value.unsqueeze(axis).to(t.dtype))


class MaskedAttention(nn.Module, Streaming):
    """Multi-head attention over given (B, T, E) projections q, k and v,
    with the chunk-wise causal sliding-window mask where ``_masked`` says
    so and rotary positions on the first ``rotary_dim`` head features;
    streaming, with the per-step KV caches described above (the keys and
    values of this call rolled into the slot)."""

    def __init__(self, cfg: DenoiserConfig, streaming: bool = False):
        super().__init__()
        self.cfg = cfg
        self.streaming = streaming
        self._consts: Dict[Tuple[int, int, torch.device], tuple] = {}

    def _masked(self) -> bool:
        """Whether the chunk-wise causal window masks the keys."""
        return self.streaming or self.cfg.causal

    def _constants(self, q_len: int, k_len: int, device: torch.device):
        """(mask bias (q_len, k_len) or None, query angles, key angles, key
        positions) of q_len queries ending a k_len-long key sequence."""
        key = (q_len, k_len, device)
        if key not in self._consts:
            cfg = self.cfg
            if not self._masked():
                mask = None
            elif self.streaming:
                mask = streaming_mask(q_len, k_len, cfg.attention_chunk_size,
                                      cfg.local_attention_size)
            else:
                mask = sliding_chunkwise_mask(
                    k_len, cfg.attention_chunk_size,
                    cfg.local_attention_size)[k_len - q_len:]
            bias = (torch.from_numpy(mask_bias(mask)).to(device)
                    if mask is not None else None)
            q_ang = k_ang = None
            if cfg.pos_emb_type == "rotary":
                pos = np.arange(k_len, dtype=np.float64)
                k_ang = torch.from_numpy(
                    rotary_angles(pos, cfg.rotary_dim)).to(device)
                q_ang = k_ang[k_len - q_len:]
            self._consts[key] = (bias, q_ang, k_ang,
                                 torch.arange(k_len, device=device))
        return self._consts[key]

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cache: Optional[Cache] = None,
               cache_index: Union[int, torch.Tensor] = 0,
               train: Optional[TrainMode] = None) -> torch.Tensor:
        cfg = self.cfg
        B, Tq, E = q.shape
        T = k.shape[1]
        H, D = E // cfg.head_dim, cfg.head_dim
        q, k, v = (y.reshape(B, -1, H, D).transpose(1, 2) for y in (q, k, v))
        if self.streaming:
            C, S = cfg.local_attention_size, cfg.max_diffusion_steps
            kc = self.slot(cache, "k", lambda: k.new_zeros((B, S, H, C, D)))
            vc = self.slot(cache, "v", lambda: v.new_zeros((B, S, H, C, D)))
            filled = self.slot(cache, "filled", lambda: torch.zeros(
                (S,), dtype=torch.int32, device=k.device))
            slot = KVSlot(cache_index)
            kc_i, vc_i = slot.read(kc, 1), slot.read(vc, 1)    # B H C D
            full_k = torch.cat([kc_i, k], dim=2)
            full_v = torch.cat([vc_i, v], dim=2)
            bias, q_ang, k_ang, key_pos = self._constants(Tq, C + T, k.device)
            # mask the slots of this step not written yet
            n_filled = slot.read(filled, 0)
            bias = torch.where(key_pos >= C - n_filled,
                               0.0 if bias is None else bias, NEG_INF)
            # roll-write: shift this step's slot left by T, append the keys
            slot.write(kc, 1, full_k[:, :, T:] if T < C else k[:, :, T - C:])
            slot.write(vc, 1, full_v[:, :, T:] if T < C else v[:, :, T - C:])
            slot.write(filled, 0, torch.clamp(n_filled + T, max=C))
        else:
            full_k, full_v = k, v
            bias, q_ang, k_ang, _ = self._constants(Tq, T, k.device)
        if k_ang is not None:
            q = apply_rotary(q, q_ang)
            full_k = apply_rotary(full_k, k_ang)
        # the logits and the softmax in f32 (bf16 q and k widened: their
        # products are exact in f32, as preferred_element_type=f32 sums
        # them), the probabilities back at the compute dtype
        logits = torch.matmul(q.float(), full_k.float().transpose(-1, -2)
                              ) * (1.0 / np.sqrt(D))
        if bias is not None:
            logits = logits + bias
        probs = dropout(torch.softmax(logits, dim=-1), cfg.dropout, train)
        out = torch.matmul(probs.to(full_v.dtype), full_v)
        return out.transpose(1, 2).reshape(B, Tq, E)


class ChunkCausalAttention(MaskedAttention):
    """DenoiserV2's self-attention: the qkv projection, then
    ``MaskedAttention`` (always masked when streaming)."""

    def __init__(self, cfg: DenoiserConfig, streaming: bool = False):
        super().__init__(cfg, streaming)
        self.qkv = Dense(cfg.embed_dim, 3 * cfg.embed_dim, bias=False)

    def forward(self, x: torch.Tensor, cache: Optional[Cache] = None,
                cache_index: Union[int, torch.Tensor] = 0,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.attend(q, k, v, cache, cache_index, train)


class DecoderBlock(nn.Module):
    """AdaLN(tcond) -> self-attn + res -> AdaLN(cond) -> MLP + res.  The
    AdaLN modulations replace x rather than adding a residual branch."""

    def __init__(self, cfg: DenoiserConfig, with_cond: bool = True,
                 streaming: bool = False):
        super().__init__()
        E = cfg.embed_dim
        self.tcond_linear = (Dense(cfg.tcond_dim, 2 * E)
                             if cfg.tcond_dim > 0 else None)
        self.norm1 = nn.LayerNorm(E, eps=LN_EPS)
        self.attn = ChunkCausalAttention(cfg, streaming)
        self.cond_linear = Dense(E, 2 * E) if with_cond else None
        self.norm3 = nn.LayerNorm(E, eps=LN_EPS)
        self.mlp = MLP(E, cfg.mlp_multiplier, cfg.dropout)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor],
                tcond: Optional[torch.Tensor], cache: Optional[Cache] = None,
                cache_index: Union[int, torch.Tensor] = 0,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        E = x.shape[-1]
        if self.tcond_linear is not None and tcond is not None:
            x = F.layer_norm(x, (E,), eps=LN_EPS)
            alpha, beta = self.tcond_linear(tcond).chunk(2, dim=-1)
            x = x * (1 + alpha) + beta
        x = self.attn(self.norm1(x), cache, cache_index, train) + x
        if cond is not None:
            x = F.layer_norm(x, (E,), eps=LN_EPS)
            alpha, beta = self.cond_linear(cond).chunk(2, dim=-1)
            x = x * (1 + alpha[:, None]) + beta[:, None]
        return self.mlp(self.norm3(x), train) + x


class Denoiser(nn.Module):
    """Rectified-flow velocity field v(x_t, t, timbre, structure).

    ``cond_in`` and ``tcond_in`` are the widths of the timbre vector and of
    the structure codes fed to it (``zt_channels`` and ``zs_channels`` of the
    run's AfterConfig); they need not equal ``cond_dim`` / ``tcond_dim``.
    A streaming denoiser takes (B, chunk, C) steps with the KV cache and the
    Euler step's ``cache_index``."""

    def __init__(self, cfg: DenoiserConfig, cond_in: Optional[int] = None,
                 tcond_in: Optional[int] = None, streaming: bool = False):
        super().__init__()
        if streaming and cfg.pos_emb_type == "learnable":
            # a chunk would restart at position 0 against keys cached at
            # earlier positions; rotary positions re-phase the cached keys
            raise ValueError("pos_emb_type='learnable' is not streamable; "
                             "use 'rotary' for streaming models")
        self.cfg = cfg
        E = cfg.embed_dim
        cond_in = cfg.cond_dim if cond_in is None else cond_in
        tcond_in = cfg.tcond_dim if tcond_in is None else tcond_in
        self.use_cond = cfg.cond_dim > 0
        if self.use_cond:
            self.emb_dense1 = Dense(cfg.noise_embed_dims + cond_in, E)
            self.emb_dense2 = Dense(E, E)
        self.patchify = Dense(cfg.n_channels, E)
        if cfg.pos_emb_type == "learnable":
            self.pos_embed = nn.Parameter(torch.zeros(cfg.seq_len, E))
        self.tcond_patchify = (Dense(tcond_in, cfg.tcond_dim)
                               if cfg.tcond_dim > 0 else None)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}",
                            DecoderBlock(cfg, self.use_cond, streaming))
        self.out_proj = Dense(E, cfg.n_channels)
        name_slots(self)

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                cond: Optional[torch.Tensor] = None,
                time_cond: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None,
                cache_index: Union[int, torch.Tensor] = 0,
                train: Optional[TrainMode] = None) -> torch.Tensor:
        cfg = self.cfg
        noise_level = fourier_features(time, cfg.noise_embed_dims)
        if self.use_cond and cond is not None:
            features = self.emb_dense1(torch.cat([noise_level, cond], dim=-1))
            features = self.emb_dense2(F.gelu(features))
        else:
            features = None
        h = F.gelu(self.patchify(x))
        if cfg.pos_emb_type == "learnable":
            h = h + self.pos_embed[None, :h.shape[1]]
        if self.tcond_patchify is not None and time_cond is not None:
            tc = F.gelu(self.tcond_patchify(time_cond))
        else:
            tc = None
        for i in range(cfg.n_layers):
            h = getattr(self, f"block_{i}")(h, features, tc, cache,
                                            cache_index, train)
        return self.out_proj(h)
