"""1-D convolutions over (B, T, C) with weight norm, offline and streaming
(counterpart of after_tpu/ops/conv.py).

Padding rule, as in the JAX package:
    total = (kernel - 1) * dilation + 1 - stride
    causal   -> (total, 0)
    centered -> (ceil, floor)
    valid    -> (0, 0)

Streaming (``streaming=True``, a cache passed to each call): a conv keeps the
last ``left + right`` input frames (``carry``) and runs a valid conv over
them and the new chunk, so successive chunks reproduce the offline causal
output (a centered conv streams with a delay of ``right`` frames); a
transposed conv keeps the overlap tail of its un-trimmed output
(``overlap``) and emits causally.

Weights are kept in torch's layouts: (O, C, k) for a conv and
(C_in, C_out, k) for a transposed conv.  Every conv has a bias and weight
norm, which keeps the direction ``weight`` and the magnitude ``g`` as
separate parameters, as torch.nn.utils.weight_norm(dim=0) does.  The weight
is normed in the parameters' type and a conv computes at the promotion of
its input's type and its weight's (``utils.precision.promote``), as the
JAX package's convs do: under bf16 training parameters an f32 input (the
decoder's, after the bottleneck's f32 noise) convolves in f32 with the
bf16-normed weight widened.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..streaming.state import Cache, Streaming
from ..utils.precision import at


def get_padding(kernel_size: int, stride: int = 1, dilation: int = 1,
                mode: str = "centered") -> Tuple[int, int]:
    """Left/right padding that keeps out_len = in_len // stride."""
    total = max((kernel_size - 1) * dilation + 1 - stride, 0)
    if mode == "causal":
        return (total, 0)
    if mode == "centered":
        left = (total + 1) // 2
        return (left, total - left)
    raise ValueError(f"unknown padding mode {mode!r}")


def conv1d(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
    """``F.conv1d``.  A bf16 convolution on the CPU runs on the widened
    values and is rounded once, which is what a bf16 convolution computes
    (sums in f32): PyTorch's oneDNN bf16 conv1d on the CPU returns wrong
    sums at some shapes (a 32-tap kernel over 4 channels, the PQMF's)."""
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return F.conv1d(x.float(), w.float(),
                        None if b is None else b.float(), **kw
                        ).to(torch.bfloat16)
    return F.conv1d(x, w, b, **kw)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
    """``F.conv_transpose1d``, a bf16 one on the CPU as ``conv1d`` runs
    it."""
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return F.conv_transpose1d(x.float(), w.float(),
                                  None if b is None else b.float(), **kw
                                  ).to(torch.bfloat16)
    return F.conv_transpose1d(x, w, b, **kw)


def weight_norm(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """w * g / ||w|| per slice of the first axis (output channels of a conv,
    input channels of a transposed conv), the norm clamped at 1e-12."""
    norm = torch.linalg.vector_norm(w.flatten(1), dim=1)
    return w * (g / norm.clamp_min(1e-12))[:, None, None]


class _WeightNormed(nn.Module):
    """``effective_weight`` of a module with ``weight`` and ``g``.

    With gradients off (inference) the result is a constant, so it is kept
    until either parameter is moved or written in place (``init_weights``,
    ``load_jax`` and ``load_state_dict`` all write in place, which bumps the
    tensor's version), unless ``keep_weight`` is off (``recompute_weights``)
    or the weight is not the module's own parameter (a training step's
    compute-dtype copy, ``utils.precision.cast_call``, made anew at every
    call: a kept copy of it could be served again from a reused address).
    A module with ``kernel_layout`` set keeps, beside it, the pair the fused
    snake+conv kernel reads (``kernel_weights``): the weight in its (k, O,
    Cw) layout and its low tf32 half (ops/kernels/fused_conv.py:
    ``kernel_weight``), the kept weight being a view of the first.

    ``fold_weights`` turns a module into its export form, whose weights are
    plain buffers: ``weight`` (the normed weight), or ``weight_k`` and
    ``weight_lo`` (the kernel's pair) where ``kernel_layout`` is set."""

    _kept = None        # (weight, kernel pair or None), made at _kept_key
    _kept_key = None
    kernel_layout = False
    keep_weight = True
    folded = False

    def _keep(self):
        """(weight, (w_k, w_lo) or None) as kept for inference, made again
        when ``weight`` or ``g`` changed; None where the weight is computed
        at each call."""
        w, g = self.weight, self.g
        if (not self.keep_weight or torch.is_grad_enabled()
                or not isinstance(w, nn.Parameter)
                or not isinstance(g, nn.Parameter)
                or w.is_inference() or g.is_inference()):
            return None
        key = (w.data_ptr(), w._version, g.data_ptr(), g._version)
        if key != self._kept_key:
            wn, pair = weight_norm(w, g), None
            if self.kernel_layout:
                # imported here: ops/kernels/fused_conv.py imports this module
                from .kernels.fused_conv import kernel_weight
                pair = kernel_weight(wn)
                wn = pair[0][:, :, :self.in_features].permute(1, 2, 0)
            self._kept, self._kept_key = (wn, pair), key
        return self._kept

    @property
    def weight_dtype(self) -> torch.dtype:
        """The type of the module's weight (a folded module's kept one)."""
        if self.folded:
            return (self.weight_k if self.kernel_layout else self.weight).dtype
        return self.weight.dtype

    def effective_weight(self, dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
        """The normed weight; with ``dtype`` other than the weight's, normed
        at that type from the parameters brought to it (``at``: under a
        training step's cast, the f32 parameters themselves)."""
        if self.folded:
            if self.kernel_layout:
                w = self.weight_k[:, :, :self.in_features].permute(1, 2, 0)
            else:
                w = self.weight
            return w if dtype is None else w.to(dtype)
        if dtype is not None and dtype != self.weight.dtype:
            return weight_norm(at(self.weight, dtype), at(self.g, dtype))
        kept = self._keep()
        return weight_norm(self.weight, self.g) if kept is None else kept[0]

    def kernel_weights(self, dtype: Optional[torch.dtype] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w_k, w_lo): the weight in the fused kernel's (k, O, Cw) layout
        and its low tf32 half, as the op ``snake_conv`` takes them; the kept
        pair where there is one, else made from ``effective_weight`` (with
        its gradient).  With ``dtype`` other than the weight's, the normed
        weight cast to it first (the widened bf16 weight of an f32 conv)."""
        if dtype is not None and dtype != self.weight_dtype:
            from .kernels.fused_conv import kernel_weight
            return kernel_weight(self.effective_weight(dtype))
        if self.folded and self.kernel_layout:
            return self.weight_k, self.weight_lo
        kept = None if self.folded else self._keep()
        if kept is not None and kept[1] is not None:
            return kept[1]
        from .kernels.fused_conv import kernel_weight
        return kernel_weight(self.effective_weight())


def recompute_weights(module: nn.Module) -> None:
    """Makes every weight-normed conv in ``module`` compute its weight at
    each call, in inference too.  A training step captured in a CUDA graph
    needs this: a kept weight is read at a fixed address and made again
    only by Python, which a replay does not run, so after an update a
    replay would go on reading the weight from before it."""
    for m in module.modules():
        if isinstance(m, _WeightNormed):
            m.keep_weight = False


@torch.no_grad()
def fold_weights(module: nn.Module) -> nn.Module:
    """The export form of ``module``, in place: each weight-normed conv's
    ``weight`` and ``g`` replaced by plain buffers of its effective weight
    (``weight``, or ``weight_k`` and ``weight_lo`` in the fused kernel's
    layout where ``kernel_layout`` is set), the weights a program holds as
    constants.  A kept weight reads tensor addresses and versions, which no
    trace allows; a folded one reads nothing but its buffers.  Apply it to
    an export copy (``copy.deepcopy``), never to a module that trains."""
    from .kernels.fused_conv import kernel_weight
    for m in module.modules():
        if isinstance(m, _WeightNormed) and not m.folded:
            wn = weight_norm(m.weight, m.g)
            del m.weight, m.g
            if m.kernel_layout:
                wk, lo = kernel_weight(wn)
                m.register_buffer("weight_k", wk)
                m.register_buffer("weight_lo", lo)
            else:
                m.register_buffer("weight", wn)
            m._kept = m._kept_key = None
            m.folded = True
    return module


class StreamConv1d(_WeightNormed, Streaming):
    """Weight-normed 1-D conv over (B, T, C).

    Weight norm is per output channel: the norm runs over (C_in, k).
    ``kernel_layout`` keeps the inference weight in the fused snake+conv
    kernel's layout (see ``_WeightNormed``).  With ``streaming`` set, a
    causal or centered conv keeps its left context in the cache
    (``carry``, (B, left + right, C_in)); a valid conv needs none."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, mode: str = "causal",
                 kernel_layout: bool = False, streaming: bool = False):
        super().__init__()
        self.kernel_layout = kernel_layout
        self.streaming = streaming
        self.in_features = in_features
        self.features = features
        self.kernel_size = kernel_size
        self.stride = stride
        self.dilation = dilation
        self.mode = mode
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel_size))
        self.g = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        if self.streaming and self.mode != "valid":
            context = sum(get_padding(self.kernel_size, self.stride,
                                      self.dilation, self.mode))
            carry = self.slot(cache, "carry", lambda: x.new_zeros(
                (x.shape[0], context, x.shape[2])))
            h = torch.cat([carry, x], dim=1)
            carry.copy_(h[:, h.shape[1] - context:])
            h = h.transpose(1, 2)
        else:
            h = x.transpose(1, 2)
            if self.mode != "valid":
                h = F.pad(h, get_padding(self.kernel_size, self.stride,
                                         self.dilation, self.mode))
        dtype = torch.promote_types(h.dtype, self.weight_dtype)
        y = conv1d(h.to(dtype), self.effective_weight(dtype),
                   at(self.bias, dtype), stride=self.stride,
                   dilation=self.dilation)
        return y.transpose(1, 2)


class StreamConvTranspose1d(_WeightNormed, Streaming):
    """Weight-normed transposed 1-D conv (upsampler) over (B, T, C).

    Offline it matches the JAX package's centered form: out_len = in_len *
    stride, the un-trimmed output cut by stride // 2 frames on the left.
    Streaming, the un-trimmed output (length in_len * stride + k - stride,
    without bias) gets the previous call's overlap tail added to its head;
    its last k - stride frames become the new tail (``overlap``) and the
    rest, plus bias, is emitted.  Weight norm is per input channel (torch
    weight_norm(dim=0) on the (C_in, C_out, k) weight)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int, streaming: bool = False):
        super().__init__()
        self.streaming = streaming
        self.in_features = in_features
        self.features = features
        self.kernel_size = kernel_size
        self.stride = stride
        self.weight = nn.Parameter(
            torch.empty(in_features, features, kernel_size))
        self.g = nn.Parameter(torch.empty(in_features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
        T = x.shape[1]
        f = self.stride
        dtype = torch.promote_types(x.dtype, self.weight_dtype)
        x, w, bias = (x.to(dtype), self.effective_weight(dtype),
                      at(self.bias, dtype))
        if not self.streaming:
            y = conv_transpose1d(x.transpose(1, 2), w, bias, stride=f,
                                 padding=f // 2)
            return y[:, :, :T * f].transpose(1, 2)
        tail = self.kernel_size - f
        y = conv_transpose1d(x.transpose(1, 2), w, stride=f).transpose(1, 2)
        overlap = self.slot(cache, "overlap", lambda: x.new_zeros(
            (x.shape[0], tail, self.features)))
        if tail > 0:
            y = torch.cat([y[:, :tail] + overlap, y[:, tail:]], dim=1)
            overlap.copy_(y[:, y.shape[1] - tail:])
            y = y[:, :y.shape[1] - tail]
        return y + bias
