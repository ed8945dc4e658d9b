"""Fused SnakeBeta + dilated 1-D conv: the CUDA kernel, its wrapper and its
plain PyTorch version.

Counterpart of the TPU kernel in after_tpu/ops/pallas/fused_conv.py.  The
kernel (csrc/fused_snake_conv.cu, 3xTF32 on Hopper's tensor cores) computes

    y[b, t, o] = bias[o] + sum_{j<k} sum_c snake(xpad[b, t + j*d, c]) * w[o, c, j]

over (B, T, C) inputs.  It is registered as the op
``after_tpu_torch::snake_conv`` (``snake_conv``), which takes the weight as
the kernel reads it: (k, O, Cw) with its low tf32 half beside it, two
explicit tensors (``kernel_weight``), so that the op survives
``torch.export``, ``save`` and ``load`` and a CUDA graph capture of the
loaded program.  Its CUDA implementation launches the kernel or raises, its
CPU implementation is the plain version (``snake_conv_reference``), and
traced it is one node of the program (``register_fake``); there is no other
choice and no fallback between the two.  Importing this module registers
the op: a process must import it before it loads a program that holds it.

``fused_snake_conv`` takes torch's conv1d weight (O, C, k), rearranges and
splits it (``kernel_weight``) and calls the op; the model's convs call the
op with the pair they keep (``StreamConv1d(..., kernel_layout=True)``,
``kernel_weights``), so that no call of theirs copies it.  Where the kernel's plan splits the channel sum over
blocks, the wrapper hands it a scratch buffer for the partial sums, which
the kernel adds in a fixed order: its output has the same bits from launch
to launch, eager or replayed in a CUDA graph.  That second kernel,
``sum_splits``, is also callable alone (on the card; its plain version
``sum_splits_reference`` on the CPU), to check and time it.

The op also takes bf16 tensors (the pipeline's and the streamer's
``compute_dtype``): x, alpha, beta, b and a single bf16 weight w_k, (k, O,
Cw) with Cw a multiple of 8, its low half an empty tensor.  On the card that
launches the kernel's bf16 instantiation (``snake_conv_bf16``: the snake in
f32, rounded to bf16 once; one bf16 wgmma product, summed in f32 with the
bias; the output rounded once), whose split sums keep f32 partials
(``sum_splits(ws, torch.bfloat16)``); its plain version is
``snake_conv_reference`` on bf16 inputs, with the same roundings.  Any other
type raises.

Two counts of launches: ``fused_snake_conv.launches`` counts the op's
launches on the card (an eager launch, or one recorded by a CUDA graph
capture; a replay runs no Python and adds nothing), and the kernels count
their own launches on the device (``device_launches``,
``reset_device_launches``), replays included.

The op is differentiable, as the JAX package's custom VJP makes its kernel
(``_fused_with_vjp``): its registered gradient calls a second registered op,
``after_tpu_torch::snake_conv_backward`` (``snake_conv_backward``), on the
saved inputs (x, alpha, beta, w_k, b) for the inputs that need a gradient.
On CUDA tensors that op launches two kernels of its own
(csrc/snake_conv_backward.cu, 3xTF32 on the tensor cores: dgrad for x,
alpha, beta and b, wgrad for the weight) and their fixed-order sum of
partials, or raises; on CPU tensors it is the plain version
(``snake_conv_backward_reference``, the VJP of ``snake_conv_reference``,
which the JAX package's custom VJP also is).  The backward kernels count
their launches on the device beside the forward's
(``backward_device_launches``).

The backward takes bf16 tensors too, the gradient of the bf16 forward: on
the card it launches two kernels designed for bf16
(``snake_conv_dgrad_bf16``, ``snake_conv_wgrad_bf16``: TMA rings, bf16
wgmma, f32 sums, each gradient rounded to bf16 once; their plans:
``bf16_tiles(..., backward=True)`` and ``bf16_wgrad_tiles``), counted
apart (``backward_device_launches(dtype=torch.bfloat16)``); its
plain version is ``snake_conv_backward_reference`` on bf16 inputs, with
the same roundings.  Every tensor of a call is f32 or every one bf16;
anything else raises.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..conv import get_padding
from ..snake import snake_beta

SOURCE = "fused_snake_conv.cu"
BACKWARD_SOURCE = "snake_conv_backward.cu"


def snake_conv_reference(x: torch.Tensor, alpha: torch.Tensor,
                         beta: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         dilation: int = 1, mode: str = "causal"
                         ) -> torch.Tensor:
    """Plain version: snake_beta, then F.conv1d with the same zero pad.  On
    bf16 inputs, what the kernel's bf16 instantiation computes: the snake in
    f32 from the widened inputs, rounded to bf16, the conv summed in f32
    with the f32 bias, the output rounded to bf16 once."""
    if x.dtype == torch.bfloat16:
        a = snake_beta(x.float(), alpha.float(), beta.float())
        return _conv(a.to(torch.bfloat16).float(), w.float(), b.float(),
                     dilation, mode).to(torch.bfloat16)
    return _conv(snake_beta(x, alpha, beta), w, b, dilation, mode)


def _conv(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dilation: int,
          mode: str) -> torch.Tensor:
    """F.conv1d over (B, T, C) activations with the length-keeping zero
    pad of ``mode``, (B, T, O) contiguous out."""
    left, right = get_padding(w.shape[-1], 1, dilation, mode)
    y = F.conv1d(F.pad(a.transpose(1, 2), (left, right)), w, b,
                 dilation=dilation)
    return y.transpose(1, 2).contiguous()


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .build import load
        lib = load(SOURCE)
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.fused_snake_conv_f32.argtypes = [p] * 8 + [i] * 8 + [p, p]
        lib.fused_snake_conv_f32.restype = ctypes.c_int
        lib.fused_snake_conv_plan.argtypes = [i] * 6 + [p]
        lib.fused_snake_conv_plan.restype = ctypes.c_int
        lib.fused_snake_conv_sum_splits.argtypes = [p, p, ctypes.c_longlong,
                                                    i, p, p]
        lib.fused_snake_conv_sum_splits.restype = ctypes.c_int
        lib.fused_snake_conv_bf16.argtypes = [p] * 7 + [i] * 8 + [p, p]
        lib.fused_snake_conv_bf16.restype = ctypes.c_int
        lib.fused_snake_conv_plan_bf16.argtypes = [i] * 6 + [p]
        lib.fused_snake_conv_plan_bf16.restype = ctypes.c_int
        lib.fused_snake_conv_plan_bf16_tiles.argtypes = [i] * 6 + [p]
        lib.fused_snake_conv_plan_bf16_tiles.restype = ctypes.c_int
        lib.fused_snake_conv_sum_splits_bf16.argtypes = [
            p, p, ctypes.c_longlong, i, p, p]
        lib.fused_snake_conv_sum_splits_bf16.restype = ctypes.c_int
        _LIB = lib
    return _LIB


_BWD_LIB = None


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        from .build import load
        lib = load(BACKWARD_SOURCE)
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.snake_conv_backward_plan.argtypes = [i] * 6 + [p]
        lib.snake_conv_backward_plan.restype = ctypes.c_int
        lib.snake_conv_backward_dgrad_f32.argtypes = [p] * 10 + [i] * 8 + [
            p, p]
        lib.snake_conv_backward_dgrad_f32.restype = ctypes.c_int
        lib.snake_conv_backward_wgrad_f32.argtypes = [p] * 6 + [i] * 8 + [
            p, p]
        lib.snake_conv_backward_wgrad_f32.restype = ctypes.c_int
        lib.snake_conv_backward_plan_bf16.argtypes = [i] * 6 + [p]
        lib.snake_conv_backward_plan_bf16.restype = ctypes.c_int
        lib.snake_conv_backward_plan_bf16_tiles.argtypes = [i] * 6 + [p]
        lib.snake_conv_backward_plan_bf16_tiles.restype = ctypes.c_int
        lib.snake_conv_backward_plan_bf16_wgrad.argtypes = [i] * 6 + [p]
        lib.snake_conv_backward_plan_bf16_wgrad.restype = ctypes.c_int
        lib.snake_conv_backward_dgrad_bf16.argtypes = [p] * 10 + [i] * 8 + [
            p, p]
        lib.snake_conv_backward_dgrad_bf16.restype = ctypes.c_int
        lib.snake_conv_backward_wgrad_bf16.argtypes = [p] * 6 + [i] * 8 + [
            p, p]
        lib.snake_conv_backward_wgrad_bf16.restype = ctypes.c_int
        _BWD_LIB = lib
    return _BWD_LIB


_PLANS: Dict[Tuple[int, ...], Tuple[int, int, int]] = {}


def kernel_plan(B: int, T: int, C: int, O: int, k: int, dilation: int = 1,
                dtype: torch.dtype = torch.float32) -> Tuple[int, int, int]:
    """(output channels per block, channels per stage, splits of the
    channel sum) that a launch at this shape and type (f32 or bf16) takes;
    builds the kernel if needed."""
    bf16 = dtype == torch.bfloat16
    key = (B, T, C, O, k, dilation, bf16)
    if key not in _PLANS:
        out = (ctypes.c_int * 3)()
        plan = (_lib().fused_snake_conv_plan_bf16 if bf16
                else _lib().fused_snake_conv_plan)
        err = plan(B, T, C, O, k, dilation, ctypes.addressof(out))
        if err != 0:
            raise ValueError(f"no tiling for B={B} T={T} C={C} O={O} k={k} "
                             f"d={dilation} (CUDA error {err})")
        _PLANS[key] = tuple(out)
    return _PLANS[key]


_BWD_PLANS: Dict[Tuple[int, ...], Tuple[int, ...]] = {}


def backward_plan(B: int, T: int, C: int, O: int, k: int, dilation: int = 1,
                  dtype: torch.dtype = torch.float32) -> Tuple[int, ...]:
    """(dgrad's input channels per block, output channels per stage, rows
    of partial sums; wgrad's input channels per block, splits of the frame
    sum) that a backward at this shape and type (f32 or bf16) takes; builds
    the kernels if needed."""
    bf16 = dtype == torch.bfloat16
    key = (B, T, C, O, k, dilation, bf16)
    if key not in _BWD_PLANS:
        out = (ctypes.c_int * 5)()
        plan = (_bwd_lib().snake_conv_backward_plan_bf16 if bf16
                else _bwd_lib().snake_conv_backward_plan)
        err = plan(B, T, C, O, k, dilation, ctypes.addressof(out))
        if err != 0:
            raise ValueError(f"no backward tiling for B={B} T={T} C={C} "
                             f"O={O} k={k} d={dilation} (CUDA error {err})")
        _BWD_PLANS[key] = tuple(out)
    return _BWD_PLANS[key]


def bf16_tiles(B: int, T: int, C: int, O: int, k: int, dilation: int = 1,
               backward: bool = False) -> Tuple[int, ...]:
    """The whole plan of the bf16 forward kernel (or, with ``backward``,
    of the bf16 dgrad) at this shape: (frames a tile, columns a tile,
    channels a stage, slots of the ring, splits of the channel sum (dgrad:
    rows of partial sums), blocks); builds the kernel if needed."""
    out = (ctypes.c_int * 6)()
    plan = (_bwd_lib().snake_conv_backward_plan_bf16_tiles if backward
            else _lib().fused_snake_conv_plan_bf16_tiles)
    err = plan(B, T, C, O, k, dilation, ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"no bf16 tiling for B={B} T={T} C={C} O={O} k={k} "
                         f"d={dilation} (CUDA error {err})")
    return tuple(out)


def bf16_wgrad_tiles(B: int, T: int, C: int, O: int, k: int,
                     dilation: int = 1) -> Tuple[int, ...]:
    """The whole plan of the bf16 wgrad kernel at this shape: (input
    channels a tile, taps a stage, output channels a block, 2 where its
    consumer warpgroups alternate chunks (else 1), slots of the ring, splits
    of the frame sum (slabs of partial sums), work items, blocks); builds
    the kernel if needed."""
    out = (ctypes.c_int * 8)()
    err = _bwd_lib().snake_conv_backward_plan_bf16_wgrad(
        B, T, C, O, k, dilation, ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"no bf16 wgrad tiling for B={B} T={T} C={C} O={O} "
                         f"k={k} d={dilation} (CUDA error {err})")
    return tuple(out)


_COUNTS: Dict[torch.device, torch.Tensor] = {}
# slots of the device counters: the f32 forward kernel's and its split
# sum's (what the kernel of fused_snake_conv.cu writes), then the
# backward's: dgrad, wgrad and their sum of partials, then the bf16
# instantiation's kernel and its split sum, then the bf16 backward's three
_FORWARD_SLOTS = 2
_BACKWARD_SLOTS = 3
_BF16 = _FORWARD_SLOTS + _BACKWARD_SLOTS
_BF16_SLOTS = 2
_BF16_BACKWARD = _BF16 + _BF16_SLOTS
_SLOTS = _BF16_BACKWARD + _BACKWARD_SLOTS


def _device_counts(device: torch.device) -> torch.Tensor:
    """The int64 launch counters on ``device`` that the kernels add to (the
    conv kernel's, the split sum's, the backward kernels' three, then the
    bf16 conv kernel's and its split sum's, then the bf16 backward's three),
    made
    at the first launch; a first launch inside a CUDA graph capture raises,
    since the counters must not come from the graph's pool."""
    device = torch.device("cuda", torch.cuda.current_device()
                          if device.index is None else device.index)
    counts = _COUNTS.get(device)
    if counts is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("fused_snake_conv's launch counters are made "
                               "at its first launch, which must not be "
                               "inside a CUDA graph capture")
        # a normal tensor even under inference mode, so that it can be
        # reset outside it
        with torch.inference_mode(False):
            counts = _COUNTS[device] = torch.zeros(
                _SLOTS, dtype=torch.int64, device=device)
    return counts


def device_launches(device="cuda", dtype: torch.dtype = torch.float32
                    ) -> Tuple[int, int]:
    """(launches of the snake+conv kernel, launches of its split-sum
    kernel) on ``device`` since the last ``reset_device_launches``, as the
    kernels counted them on the device: eager launches and those replayed
    from CUDA graphs alike; those of the f32 kernels, or with ``dtype``
    torch.bfloat16 those of the bf16 instantiation.  Waits for the
    device's work to end."""
    start = _BF16 if dtype == torch.bfloat16 else 0
    return tuple(_device_counts(torch.device(device))[
        start:start + _FORWARD_SLOTS].tolist())


def backward_device_launches(device="cuda",
                             dtype: torch.dtype = torch.float32
                             ) -> Tuple[int, int, int]:
    """(launches of the backward's dgrad kernel, of its wgrad kernel, of
    their sum of partials) on ``device`` since the last
    ``reset_device_launches``, counted on the device as
    ``device_launches`` counts the forward's: the f32 kernels', or with
    ``dtype`` torch.bfloat16 the bf16 instantiations'.  Waits for the
    device."""
    start = _BF16_BACKWARD if dtype == torch.bfloat16 else _FORWARD_SLOTS
    return tuple(_device_counts(torch.device(device))[
        start:start + _BACKWARD_SLOTS].tolist())


def reset_device_launches(device="cuda") -> None:
    """Sets ``device``'s launch counters (forward and backward, f32 and
    bf16) to 0, in stream order."""
    _device_counts(torch.device(device)).zero_()


def tf32_high(w: torch.Tensor) -> torch.Tensor:
    """The tf32 value the tensor cores read from an f32 operand: its top 19
    bits (sign, exponent, 10 mantissa bits)."""
    return (w.view(torch.int32) & -8192).view(torch.float32)


def weight_low(w: torch.Tensor) -> torch.Tensor:
    """w - tf32_high(w), rounded to tf32 (to nearest, ties away from zero, as
    cvt.rna does): tf32_high(w) + weight_low(w) is w within 2^-22 |w|."""
    r = w - tf32_high(w)
    return ((r.view(torch.int32) + 4096) & -8192).view(torch.float32)


def weight_channels(C: int, dtype: torch.dtype = torch.float32) -> int:
    """Cw, the input channels of the kernel's weight layout: C rounded up
    to 16 bytes of the type (4 f32 or 8 bf16 values)."""
    m = 8 if dtype == torch.bfloat16 else 4
    return -(-C // m) * m


def kernel_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (O, C, k) as the kernel reads it: (k, O, Cw) contiguous, Cw = C
    rounded up to 16 bytes (``weight_channels``), zeros past C, and its low
    tf32 half in the same layout: a copy, which carries w's gradient, and
    its split, which carries none.  A bf16 weight has no low half: an empty
    tensor stands in its place."""
    O, C, k = w.shape
    hi = torch.zeros((k, O, weight_channels(C, w.dtype)), dtype=w.dtype,
                     device=w.device)
    hi[:, :, :C] = w.permute(2, 0, 1)
    if w.dtype == torch.bfloat16:
        return hi, w.new_empty(0)
    return hi, weight_low(hi.detach())


def torch_weight(w_k: torch.Tensor, channels: int) -> torch.Tensor:
    """The kernel's (k, O, Cw) weight back in torch's conv1d shape (O, C,
    k), C = ``channels``, contiguous."""
    return w_k[:, :, :channels].permute(1, 2, 0).contiguous()


def _check(name: str, t: torch.Tensor, device: torch.device, shape,
           dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _launch(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
            w_k: torch.Tensor, w_lo: torch.Tensor, b: torch.Tensor,
            dilation: int, mode: str) -> torch.Tensor:
    """Checks the inputs, launches the kernel on x's device (the f32
    kernel, or the bf16 instantiation for bf16 x) and counts the call in
    ``fused_snake_conv.launches`` (the kernel counts its launch on the
    device, ``device_launches``)."""
    if x.dim() != 3 or w_k.dim() != 3:
        raise ValueError(f"x must be (B, T, C) and w_k (k, O, Cw); got "
                         f"{tuple(x.shape)} and {tuple(w_k.shape)}")
    B, T, C = x.shape
    k, O, Cw = w_k.shape
    bf16 = x.dtype == torch.bfloat16
    dtype = torch.bfloat16 if bf16 else torch.float32
    if Cw != weight_channels(C, dtype):
        raise ValueError(f"w_k has {Cw} input channels for x's {C}: the "
                         f"{dtype} kernel reads C rounded up to "
                         f"{weight_channels(C, dtype)}")
    _check("x", x, x.device, (B, T, C), dtype)
    _check("alpha", alpha, x.device, (C,), dtype)
    _check("beta", beta, x.device, (C,), dtype)
    _check("w_k", w_k, x.device, (k, O, Cw), dtype)
    _check("w_lo", w_lo, x.device, (0,) if bf16 else (k, O, Cw), dtype)
    _check("b", b, x.device, (O,), dtype)
    if w_k.data_ptr() % 16 or (not bf16 and w_lo.data_ptr() % 16):
        raise ValueError("the kernel's weight tiles must be 16-byte aligned")
    left, _ = get_padding(k, 1, dilation, mode)
    y = torch.empty((B, T, O), device=x.device, dtype=dtype)
    # the f32 partial sums of a split channel sum, added in split order
    splits = kernel_plan(B, T, C, O, k, dilation, dtype)[2]
    ws = (torch.empty((splits, B, T, O), device=x.device, dtype=torch.float32)
          if splits > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        counts = _device_counts(x.device)
        if bf16:
            err = _lib().fused_snake_conv_bf16(
                x.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
                w_k.data_ptr(), b.data_ptr(), y.data_ptr(),
                None if ws is None else ws.data_ptr(),
                B, T, C, O, k, dilation, left, Cw,
                counts.data_ptr() + 8 * _BF16, stream)
        else:
            err = _lib().fused_snake_conv_f32(
                x.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
                w_k.data_ptr(), w_lo.data_ptr(), b.data_ptr(), y.data_ptr(),
                None if ws is None else ws.data_ptr(),
                B, T, C, O, k, dilation, left, Cw, counts.data_ptr(),
                stream)
    if err != 0:
        raise RuntimeError(f"fused_snake_conv kernel launch failed with CUDA "
                           f"error {err} (B={B} T={T} C={C} O={O} k={k} "
                           f"d={dilation} mode={mode})")
    fused_snake_conv.launches += 1
    return y


@torch.library.custom_op("after_tpu_torch::snake_conv", mutates_args=(),
                         device_types="cuda")
def snake_conv(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
               w_k: torch.Tensor, w_lo: torch.Tensor, b: torch.Tensor,
               dilation: int, mode: str) -> torch.Tensor:
    """The registered op ``after_tpu_torch::snake_conv``: conv(snake_beta(x))
    with the weight in the kernel's layout, w_k (k, O, Cw) and its low tf32
    half w_lo (``kernel_weight``; bf16: an empty w_lo).  On CUDA tensors it
    launches the kernel (``_launch``) or raises; on CPU tensors it is the
    plain version; traced (``torch.export``) it is one node of the
    program."""
    return _launch(x, alpha, beta, w_k, w_lo, b, dilation, mode)


@snake_conv.register_kernel("cpu")
def _snake_conv_cpu(x, alpha, beta, w_k, w_lo, b, dilation, mode):
    return snake_conv_reference(x, alpha, beta, torch_weight(w_k, x.shape[2]),
                                b, dilation, mode)


@snake_conv.register_fake
def _snake_conv_fake(x, alpha, beta, w_k, w_lo, b, dilation, mode):
    return x.new_empty((x.shape[0], x.shape[1], w_k.shape[1]))


@contextlib.contextmanager
def _autograd_inside_op():
    """Grad mode on, and autograd recording even inside a registered op's
    kernel, which the dispatcher runs with the autograd keys excluded: the
    plain backward differentiates the plain version."""
    excluded = torch._C._dispatch_tls_local_exclude_set()
    for key in (torch._C.DispatchKey.AutogradFunctionality,
                torch._C.DispatchKey.AutogradOther,
                torch._C.DispatchKey.AutogradNestedTensor):
        excluded = excluded.remove(key)
    with torch._C._ForceDispatchKeyGuard(
            torch._C._dispatch_tls_local_include_set(), excluded), \
            torch.enable_grad():
        yield


def snake_conv_backward_reference(g: torch.Tensor, x: torch.Tensor,
                                  alpha: torch.Tensor, beta: torch.Tensor,
                                  w_k: torch.Tensor, b: torch.Tensor,
                                  dilation: int, mode: str, needs: List[bool]
                                  ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward: the VJP of ``snake_conv_reference``
    against g, recomputed from the inputs, as the JAX package's custom VJP
    computes it.  Returns (gx, galpha, gbeta, gw_k, gb), gw_k in w_k's
    (k, O, Cw) layout; an output whose ``needs`` entry is false is an empty
    tensor.

    On bf16 inputs, what the kernels' bf16 instantiations compute: the
    inputs widened to f32 and the VJP taken in f32, the weight's gradient
    from the activation rounded to bf16 (the value the bf16 forward
    multiplies), the snake's derivative from the f32 activation, and each
    gradient rounded to bf16 once."""
    bf16 = x.dtype == torch.bfloat16
    saved = [(t.detach().float() if bf16 else t.detach()).requires_grad_(n)
             for t, n in zip((x, alpha, beta, w_k, b), needs)]
    wanted = [t for t in saved if t.requires_grad]
    with _autograd_inside_op():
        x, alpha, beta, w_k, b = saved
        w = torch_weight(w_k, x.shape[2])
        if bf16:
            a = snake_beta(x, alpha, beta)
            # the rounded activation forward, the f32 one's derivative back
            a = a + (a.to(torch.bfloat16).float() - a).detach()
            y = _conv(a, w, b, dilation, mode)
        else:
            y = snake_conv_reference(x, alpha, beta, w, b, dilation, mode)
        grads = iter(torch.autograd.grad(y, wanted, g.float() if bf16
                                         else g) if wanted else ())
    dtype = torch.bfloat16 if bf16 else x.dtype
    return tuple(next(grads).to(dtype) if t.requires_grad
                 else x.new_empty(0, dtype=dtype) for t in saved)


def backward_weight(w_k: torch.Tensor, channels: int) -> torch.Tensor:
    """The weight as the dgrad kernel reads it, a copy made at each
    backward: (k, C, Ow) contiguous, out[j] = w_k[j] transposed, Ow = O
    rounded up to 16 bytes of its type (4 f32 or 8 bf16 values), zeros past
    O (the f32 kernel takes the taps in reverse and makes the low tf32 half
    on chip)."""
    k, O, _ = w_k.shape
    Ow = weight_channels(O, w_k.dtype)
    wt = torch.empty((k, channels, Ow), dtype=w_k.dtype, device=w_k.device)
    wt[:, :, :O] = w_k.detach()[:, :, :channels].transpose(1, 2)
    if Ow > O:
        wt[:, :, O:] = 0
    return wt


def _launch_backward(g, x, alpha, beta, w_k, b, dilation, mode, needs):
    """Checks the inputs and launches the backward's kernels on x's device
    (the f32 kernels, or the bf16 instantiations for bf16 x): dgrad (with
    its sum of partials) for the gradients of x, alpha, beta and b, wgrad
    for w_k's, each only when one of its outputs is wanted."""
    if x.dim() != 3 or w_k.dim() != 3 or len(needs) != 5:
        raise ValueError(f"x must be (B, T, C), w_k (k, O, Cw) and needs 5 "
                         f"flags; got {tuple(x.shape)}, {tuple(w_k.shape)} "
                         f"and {len(needs)}")
    B, T, C = x.shape
    k, O, Cw = w_k.shape
    bf16 = x.dtype == torch.bfloat16
    dtype = torch.bfloat16 if bf16 else torch.float32
    if Cw != weight_channels(C, dtype):
        raise ValueError(f"w_k has {Cw} input channels for x's {C}: the "
                         f"{dtype} kernels read C rounded up to "
                         f"{weight_channels(C, dtype)}")
    _check("x", x, x.device, (B, T, C), dtype)
    _check("g", g, x.device, (B, T, O), dtype)
    _check("alpha", alpha, x.device, (C,), dtype)
    _check("beta", beta, x.device, (C,), dtype)
    _check("w_k", w_k, x.device, (k, O, Cw), dtype)
    _check("b", b, x.device, (O,), dtype)
    need_x, need_alpha, need_beta, need_w, need_b = (bool(n) for n in needs)
    left, _ = get_padding(k, 1, dilation, mode)
    plan = backward_plan(B, T, C, O, k, dilation, dtype)
    dgrad_rows, splits = plan[2], plan[4]

    def out(wanted, shape):
        return (torch.empty(shape, device=x.device, dtype=dtype)
                if wanted else x.new_empty(0))

    def ptr(t):
        return t.data_ptr() if t.numel() else None

    gx, galpha, gbeta = (out(need_x, (B, T, C)), out(need_alpha, (C,)),
                         out(need_beta, (C,)))
    gw, gb = out(need_w, (k, O, Cw)), out(need_b, (O,))
    counts = _device_counts(x.device).data_ptr() + 8 * (
        _BF16_BACKWARD if bf16 else _FORWARD_SLOTS)
    lib = _bwd_lib()
    dgrad = (lib.snake_conv_backward_dgrad_bf16 if bf16
             else lib.snake_conv_backward_dgrad_f32)
    wgrad = (lib.snake_conv_backward_wgrad_bf16 if bf16
             else lib.snake_conv_backward_wgrad_f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if need_x or need_alpha or need_beta or need_b:
            wt = backward_weight(w_k, C)
            sums = need_alpha or need_beta or need_b
            # f32 partial sums in both types, added in a fixed order
            ws = (torch.empty((dgrad_rows, 2 * C + O), device=x.device,
                              dtype=torch.float32) if sums else None)
            err = dgrad(
                g.data_ptr(), x.data_ptr(), alpha.data_ptr(),
                beta.data_ptr(), wt.data_ptr(), ptr(gx),
                None if ws is None else ws.data_ptr(), ptr(galpha),
                ptr(gbeta), ptr(gb), B, T, C, O, k, dilation, left,
                wt.shape[2], counts, stream)
            if err != 0:
                raise RuntimeError(
                    f"snake_conv_backward dgrad launch failed with CUDA "
                    f"error {err} (B={B} T={T} C={C} O={O} k={k} "
                    f"d={dilation} mode={mode} {dtype})")
            snake_conv_backward.launches["dgrad"] += 1
        if need_w:
            ws = (torch.empty((splits, k * O * Cw), device=x.device,
                              dtype=torch.float32) if splits > 1 else None)
            err = wgrad(
                x.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
                g.data_ptr(), gw.data_ptr(),
                None if ws is None else ws.data_ptr(), B, T, C, O, k,
                dilation, left, Cw, counts, stream)
            if err != 0:
                raise RuntimeError(
                    f"snake_conv_backward wgrad launch failed with CUDA "
                    f"error {err} (B={B} T={T} C={C} O={O} k={k} "
                    f"d={dilation} mode={mode} {dtype})")
            snake_conv_backward.launches["wgrad"] += 1
    return gx, galpha, gbeta, gw, gb


@torch.library.custom_op("after_tpu_torch::snake_conv_backward",
                         mutates_args=(), device_types="cuda")
def snake_conv_backward(g: torch.Tensor, x: torch.Tensor, alpha: torch.Tensor,
                        beta: torch.Tensor, w_k: torch.Tensor,
                        b: torch.Tensor, dilation: int, mode: str,
                        needs: List[bool]
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor, torch.Tensor]:
    """The registered op ``after_tpu_torch::snake_conv_backward``: the
    gradients (gx, galpha, gbeta, gw_k, gb) of ``snake_conv`` against g =
    dL/dy, for the inputs whose ``needs`` flag is set (x, alpha, beta, w_k,
    b); the others come back as empty tensors.  On CUDA tensors it launches
    the backward's kernels (``_launch_backward``) or raises; on CPU tensors
    it is the plain version (``snake_conv_backward_reference``)."""
    return _launch_backward(g, x, alpha, beta, w_k, b, dilation, mode, needs)


snake_conv_backward.launches = {"dgrad": 0, "wgrad": 0}


@snake_conv_backward.register_kernel("cpu")
def _snake_conv_backward_cpu(g, x, alpha, beta, w_k, b, dilation, mode,
                             needs):
    return snake_conv_backward_reference(g, x, alpha, beta, w_k, b, dilation,
                                         mode, needs)


@snake_conv_backward.register_fake
def _snake_conv_backward_fake(g, x, alpha, beta, w_k, b, dilation, mode,
                              needs):
    shapes = (x.shape, alpha.shape, beta.shape, w_k.shape, b.shape)
    return tuple(x.new_empty(s if n else (0,)) for s, n in zip(shapes, needs))


def _save_inputs(ctx, inputs, output):
    x, alpha, beta, w_k, _, b, dilation, mode = inputs
    ctx.save_for_backward(x, alpha, beta, w_k, b)
    ctx.dilation, ctx.mode = dilation, mode


def _backward(ctx, g):
    """The op's gradient, the counterpart of ``_fused_with_vjp``'s: the op
    ``snake_conv_backward`` on the saved inputs (x, alpha, beta, w_k, b),
    for the inputs that need one (f32, or bf16 for the bf16 form); none for
    the low half."""
    needs = [ctx.needs_input_grad[i] for i in (0, 1, 2, 3, 5)]
    grads = snake_conv_backward(g.contiguous(), *ctx.saved_tensors,
                                ctx.dilation, ctx.mode, needs)
    gx, galpha, gbeta, gw, gb = (t if n else None
                                 for t, n in zip(grads, needs))
    return gx, galpha, gbeta, gw, None, gb, None, None


snake_conv.register_autograd(_backward, setup_context=_save_inputs)


def fused_snake_conv(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                     w: torch.Tensor, b: torch.Tensor, dilation: int = 1,
                     mode: str = "causal") -> torch.Tensor:
    """conv(snake_beta(x)): x (B, T, C), alpha/beta (C,), w (O, C, k),
    b (O,) -> (B, T, O), through the registered op ``snake_conv``.

    On a CUDA tensor this launches the kernel (and counts the call in
    ``fused_snake_conv.launches``) or raises; on a CPU tensor it is the
    plain version; either way differentiable.  x, alpha, beta and b must be
    contiguous; w is rearranged and split at each call (``kernel_weight``)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_snake_conv runs on cuda or cpu, not {x.device}")
    return snake_conv(x, alpha, beta, *kernel_weight(w), b, dilation, mode)


fused_snake_conv.launches = 0


def sum_splits_reference(ws: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """ws[0] + ws[1] + ... + ws[-1], added in that order, then stored as
    ``dtype`` (the plain version of the split sum)."""
    y = ws[0].clone()
    for part in ws[1:]:
        y += part
    return y.to(dtype)


def sum_splits(ws: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's split sum over the first axis of the f32 ``ws``
    (splits, ...), in split order, stored as ``dtype`` (f32, or bf16 as the
    bf16 instantiation stores it): on a CUDA tensor it launches
    ``sum_splits`` or ``sum_splits_bf16`` (which count themselves in
    ``device_launches(dtype=dtype)[1]``) or raises; on a CPU tensor it is
    the plain version."""
    if ws.device.type == "cpu":
        return sum_splits_reference(ws, dtype)
    if ws.device.type != "cuda":
        raise ValueError(f"sum_splits runs on cuda or cpu, not {ws.device}")
    if ws.dtype != torch.float32 or not ws.is_contiguous() or ws.dim() < 2:
        raise ValueError("sum_splits takes a contiguous f32 (splits, ...) "
                         "tensor")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sum_splits stores f32 or bf16, not {dtype}")
    bf16 = dtype == torch.bfloat16
    y = torch.empty(ws.shape[1:], device=ws.device, dtype=dtype)
    with torch.cuda.device(ws.device):
        launch = (_lib().fused_snake_conv_sum_splits_bf16 if bf16
                  else _lib().fused_snake_conv_sum_splits)
        err = launch(
            ws.data_ptr(), y.data_ptr(), y.numel(), ws.shape[0],
            _device_counts(ws.device).data_ptr() + (8 * _BF16 if bf16
                                                    else 0),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sum_splits launch failed with CUDA error {err} "
                           f"(ws {tuple(ws.shape)})")
    return y
