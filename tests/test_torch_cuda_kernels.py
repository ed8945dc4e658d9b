"""The port's CUDA kernels on the card, each against its plain PyTorch version,
and the streamer on the card against the same stream on the CPU.

These tests need a CUDA card and skip without one.  The machine with the
card has no JAX, so run them there without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerance: max abs error <= 1e-4 * max |y| (3xTF32 on the tensor cores in
another summation order than cuDNN's strict f32, TF32 off in cuDNN).  The
registered op's gradients (the backward's dgrad and wgrad kernels, 3xTF32
too) are within 1e-4 * max |g| of plain autograd's for each input.  Against
a float64 plain version the kernel's error may be at most 4x that of
strict-f32 F.conv1d.  The bf16 kernel is within 2 bf16 ulps of max |y| of
its plain bf16 version, and so is each gradient of the backward's bf16
kernels (dgrad, wgrad) of its plain bf16 version's max |g|.  The streamed waveform on the card is within 1e-4 * max |y| of
the CPU's.
"""

import numpy as np
import pytest
import torch

from after_tpu_torch.ops.kernels.fused_conv import (device_launches,
                                                    fused_snake_conv,
                                                    kernel_weight,
                                                    reset_device_launches,
                                                    snake_conv_reference,
                                                    sum_splits,
                                                    sum_splits_reference)
from after_tpu_torch.utils.device import strict_f32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    strict_f32()
    return torch.device("cuda")


def _inputs(seed, B, T, C, O, k, device):
    rng = np.random.RandomState(seed)
    arrays = (rng.randn(B, T, C), rng.rand(C) + 0.5, rng.rand(C) + 0.5,
              0.1 * rng.randn(O, C, k), rng.randn(O))
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["causal", "centered"])
@pytest.mark.parametrize("B,T,C,O,k,d", [
    (2, 512, 64, 64, 3, 1), (2, 512, 64, 128, 3, 9), (1, 1024, 16, 64, 3, 1),
    (1, 100, 20, 40, 3, 3), (3, 37, 130, 70, 1, 1), (1, 5, 8, 8, 3, 9),
    (1, 300, 33, 17, 5, 2),
    # main-path widths of the base codec
    (1, 1024, 768, 768, 3, 9), (1, 8192, 384, 384, 3, 1),
    (1, 1024, 512, 512, 1, 1),
    # O > 256 with T not a multiple of the 128-frame tile, and B = 2
    (2, 700, 96, 300, 3, 3)])
def test_kernel_matches_plain_version(cuda, B, T, C, O, k, d, mode):
    x, alpha, beta, w, b = _inputs(0, B, T, C, O, k, cuda)
    before = fused_snake_conv.launches
    y = fused_snake_conv(x, alpha, beta, w, b, d, mode)
    torch.cuda.synchronize()
    assert fused_snake_conv.launches == before + 1
    ref = snake_conv_reference(x, alpha, beta, w, b, d, mode)
    err = (y - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["causal", "centered"])
@pytest.mark.parametrize("B,T,C,O,k,d", [
    (2, 512, 64, 64, 3, 1), (1, 100, 20, 40, 3, 3), (3, 37, 130, 70, 1, 1),
    (1, 1024, 768, 768, 3, 9), (1, 8192, 384, 384, 3, 1),
    (2, 700, 96, 300, 3, 3),
    # a streamed buffer's deepest conv, and a 64-frame tile's shape
    (1, 8, 512, 512, 3, 9), (2, 40, 256, 256, 3, 3),
    # C and O without 16-byte rows (the window staged without TMA), k = 5
    (1, 300, 33, 17, 5, 2), (2, 64, 12, 20, 3, 1)])
def test_bf16_kernel_matches_plain_version(cuda, B, T, C, O, k, d, mode):
    """The bf16 kernel against its plain bf16 version (both round an f32
    sum once): within 2 bf16 ulps of max |y|, the bf16 kernels counted on
    the device and the f32 ones not."""
    x, alpha, beta, w, b = (t.to(torch.bfloat16) for t in _inputs(
        0, B, T, C, O, k, cuda))
    reset_device_launches()
    y = fused_snake_conv(x, alpha, beta, w, b, d, mode)
    assert device_launches(dtype=torch.bfloat16)[0] == 1
    assert device_launches() == (0, 0)
    ref = snake_conv_reference(x, alpha, beta, w, b, d, mode)
    assert y.dtype == torch.bfloat16
    scale = ref.float().abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert (y.float() - ref.float()).abs().max().item() <= 2 * ulp


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,O,k,d", [
    (1, 1024, 512, 512, 1, 1), (1, 1024, 768, 768, 3, 9),
    (2, 40, 256, 256, 3, 3), (1, 32768, 64, 64, 3, 9)])
def test_bf16_kernel_gives_the_same_bits_eager_and_in_a_graph(
        cuda, B, T, C, O, k, d):
    """Split channel sums (the first two shapes) are added in split order:
    two launches and a CUDA graph replay give the same bits."""
    from after_tpu_torch.ops.kernels.fused_conv import snake_conv

    x, alpha, beta, w, b = (t.to(torch.bfloat16) for t in _inputs(
        16, B, T, C, O, k, cuda))
    args = (x, alpha, beta, *kernel_weight(w), b, d, "centered")
    first = snake_conv(*args)
    again = snake_conv(*args)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        captured = snake_conv(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, captured)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1, 1024, 768), (5, 1, 37, 96),
                                   (1, 3, 7, 5)])
def test_split_sum_kernel_matches_plain_version(cuda, shape):
    """The split sum launched alone: the plain version's adds in the same
    order, so the same bits, and one launch counted on the device."""
    ws = torch.randn(shape, generator=torch.Generator(cuda).manual_seed(0),
                     device=cuda)
    reset_device_launches()
    assert torch.equal(sum_splits(ws), sum_splits_reference(ws))
    assert device_launches() == (0, 1)
    with pytest.raises(ValueError):
        sum_splits(ws.double())


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, alpha, beta, w, b = _inputs(2, 1, 64, 16, 16, 3, cuda)
    with pytest.raises(TypeError):
        fused_snake_conv(x.double(), alpha, beta, w, b)
    with pytest.raises(ValueError):
        fused_snake_conv(x.transpose(1, 2).contiguous().transpose(1, 2),
                         alpha, beta, w, b)
    with pytest.raises(ValueError):
        fused_snake_conv(x, alpha, beta, w, b.cpu())
    # an input that needs a gradient is taken (SnakeConvFunction) and the
    # same checks hold
    with pytest.raises(TypeError):
        fused_snake_conv(x.double(), alpha, beta, w.requires_grad_(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,O,k,d", [
    (1, 1024, 768, 768, 3, 9), (1, 2048, 384, 384, 3, 1),
    (1, 1024, 512, 512, 1, 1), (1, 2048, 64, 64, 3, 9),
    (1, 2048, 16, 64, 3, 1)])
def test_kernel_error_against_float64(cuda, B, T, C, O, k, d):
    """3xTF32 keeps f32 accuracy: against float64, at most 4x the error of
    strict-f32 F.conv1d on the same inputs."""
    x, alpha, beta, w, b = _inputs(3, B, T, C, O, k, cuda)
    w = w / (C * k) ** 0.5
    ref = snake_conv_reference(*(t.double() for t in (x, alpha, beta, w, b)),
                               d, "centered")
    y = fused_snake_conv(x, alpha, beta, w, b, d, "centered")
    strict = snake_conv_reference(x, alpha, beta, w, b, d, "centered")
    err = (y.double() - ref).abs().max().item()
    err_conv1d = (strict.double() - ref).abs().max().item()
    assert err <= 4 * err_conv1d, (err, err_conv1d)


@pytest.mark.cuda
def test_kept_weight_is_passed_as_it_is(cuda):
    """A conv's kept pair (``StreamConv1d(..., kernel_layout=True)`` at
    inference) is the same two tensors at every call, reaches the kernel
    as they are, and gives the result of the same weight in torch's layout
    (within the rounding of the order of the sums)."""
    from after_tpu_torch.ops.conv import StreamConv1d
    from after_tpu_torch.ops.kernels.fused_conv import snake_conv

    x, alpha, beta, w, b = _inputs(4, 1, 300, 64, 96, 3, cuda)
    conv = StreamConv1d(64, 96, 3, dilation=3, mode="centered",
                        kernel_layout=True).to(cuda)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.g.copy_(torch.linalg.vector_norm(w.flatten(1), dim=1))
        hi, lo = conv.kernel_weights()
        hi2, lo2 = conv.kernel_weights()
        assert hi2 is hi and lo2 is lo
        assert conv.effective_weight().data_ptr() == hi.data_ptr()
        before = fused_snake_conv.launches
        y = snake_conv(x, alpha, beta, hi, lo, b, 3, "centered")
        assert fused_snake_conv.launches == before + 1
        y_plain_layout = fused_snake_conv(x, alpha, beta,
                                          conv.effective_weight(), b, 3,
                                          "centered")
    # a split channel sum adds with atomics, in an order that varies
    err = (y - y_plain_layout).abs().max().item()
    assert err <= 1e-6 * y.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,O,k,d,mode", [
    (1, 512, 64, 64, 3, 9, "centered"), (2, 700, 96, 300, 3, 3, "causal"),
    (8, 1000, 64, 64, 3, 1, "centered"), (8, 256, 512, 512, 1, 1, "centered"),
    (8, 333, 384, 384, 3, 9, "centered"), (2, 37, 130, 70, 1, 1, "causal")])
def test_function_gradients_match_plain_autograd(cuda, B, T, C, O, k, d,
                                                 mode):
    """Inputs that need a gradient launch the kernel once through the
    registered op; its gradients (the op's registered VJP) for x, alpha,
    beta, w and b against
    autograd through the plain version, each within 1e-4 x max |g|."""
    args = _inputs(6, B, T, C, O, k, cuda)
    args[3] = args[3] / (C * k) ** 0.5
    gy = torch.randn((B, T, O), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(0))
    ours = [a.clone().requires_grad_() for a in args]
    before = fused_snake_conv.launches
    y = fused_snake_conv(*ours, d, mode)
    assert fused_snake_conv.launches == before + 1
    g_ours = torch.autograd.grad(y, ours, gy)
    plain = [a.clone().requires_grad_() for a in args]
    g_plain = torch.autograd.grad(
        snake_conv_reference(*plain, d, mode), plain, gy)
    assert fused_snake_conv.launches == before + 1
    for name, a, p in zip("x alpha beta w b".split(), g_ours, g_plain):
        assert a.shape == p.shape, name
        err = (a - p).abs().max().item()
        assert err <= 1e-4 * p.abs().max().item(), (name, err)


# (B, T, C, O, k, d) of the base config's crossfade windows: 16384 samples,
# so T 1024 band frames down to 32 in the encoder and back up in the decoder
STREAMING_SHAPES = [
    (1, 1024, 16, 64, 3, 1), (1, 1024, 64, 64, 3, 9), (1, 512, 128, 128, 3, 3),
    (1, 256, 256, 256, 3, 9), (1, 128, 256, 256, 1, 1),
    (1, 32, 512, 512, 3, 9), (1, 32, 512, 512, 1, 1),
    (1, 32, 768, 768, 3, 1), (1, 32, 768, 768, 3, 9), (1, 32, 768, 768, 1, 1),
    (1, 128, 384, 384, 3, 3), (1, 512, 192, 192, 3, 9),
    (1, 1024, 96, 96, 3, 1), (1, 1024, 96, 32, 3, 1), (1, 1024, 32, 32, 1, 1),
    # two voices
    (2, 32, 768, 768, 3, 9), (2, 1024, 96, 96, 3, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,O,k,d", STREAMING_SHAPES)
def test_kernel_at_streaming_shapes(cuda, B, T, C, O, k, d):
    """The crossfade path's shapes: against the plain version, and against
    float64 at most 4x the error of strict-f32 F.conv1d."""
    x, alpha, beta, w, b = _inputs(5, B, T, C, O, k, cuda)
    w = w / (C * k) ** 0.5
    y = fused_snake_conv(x, alpha, beta, w, b, d, "centered")
    strict = snake_conv_reference(x, alpha, beta, w, b, d, "centered")
    err = (y - strict).abs().max().item()
    assert err <= 1e-4 * strict.abs().max().item(), err
    ref = snake_conv_reference(*(t.double() for t in (x, alpha, beta, w, b)),
                               d, "centered")
    err64 = (y.double() - ref).abs().max().item()
    err_conv1d = (strict.double() - ref).abs().max().item()
    assert err64 <= 4 * err_conv1d, (err64, err_conv1d)


@pytest.mark.cuda
def test_streamer_on_the_card_matches_the_cpu(cuda):
    """Four buffers of two voices through the crossfade path of a small
    codec, on the card (the kernel on every conv window) and on the CPU."""
    from after_tpu_torch import TransferPipeline, get_config
    from after_tpu_torch.streaming import Streamer

    cfg = get_config("base", **{
        "autoencoder.pqmf_bands": 4, "autoencoder.z_channels": 8,
        "autoencoder.base_channels": 8, "autoencoder.multipliers": (1, 2, 2),
        "autoencoder.factors": (2, 2), "autoencoder.dilations": (1, 3),
        "autoencoder.num_blocks_per_stage": 1,
        "encoder.channels": (32, 32, 32, 64), "encoder.se_channels": 8,
        "encoder.attention_channels": 8, "encoder_time.channels": (8, 16, 12),
        "denoiser.embed_dim": 64, "denoiser.n_layers": 2,
        "denoiser.head_dim": 32, "denoiser.rotary_dim": 16,
    }).resolved(in_size=8, n_signal=32)
    cpu = TransferPipeline(cfg, device="cpu").init(0)
    card = TransferPipeline(cfg, device=cuda)
    card.codec.load_state_dict(cpu.codec.state_dict())
    card.rf.load_state_dict(cpu.rf.state_dict())
    streamers = [Streamer(cfg, pipeline=p) for p in (cpu, card)]
    states = [s.init_state(2) for s in streamers]
    rng = np.random.RandomState(7)
    A = streamers[0].audio_chunk
    for i in range(4):
        a, b = (0.3 * rng.randn(2, A, 1)).astype(np.float32), \
            (0.3 * rng.randn(2, A, 1)).astype(np.float32)
        x0 = rng.randn(2, 4, 8).astype(np.float32)
        reset_device_launches()
        y_card, states[1] = streamers[1].forward(states[1], a, b, 2, 2.0,
                                                 x0=x0)
        # 3 resnets of 2 conv blocks in each encode and in the decode, each
        # launch counted by the kernel on the device (the buffer is replayed
        # from CUDA graphs, which run no Python)
        assert device_launches()[0] == 18
        y_cpu, states[0] = streamers[0].forward(states[0], a, b, 2, 2.0,
                                                x0=x0)
        err = (y_card.cpu() - y_cpu).abs().max().item()
        assert err <= 1e-4 * y_cpu.abs().max().item(), (i, err)


@pytest.mark.cuda
def test_registered_op_at_the_buffer_shapes(cuda):
    """``after_tpu_torch::snake_conv`` called by its registered name, the
    weight in the kernel's layout, at every crossfade window shape of a
    streamed buffer: within 1e-4 x max |y| of the plain version, one
    launch each, counted on the device."""
    op = torch.ops.after_tpu_torch.snake_conv.default
    reset_device_launches()
    for B, T, C, O, k, d in STREAMING_SHAPES:
        x, alpha, beta, w, b = _inputs(8, B, T, C, O, k, cuda)
        w = w / (C * k) ** 0.5
        y = op(x, alpha, beta, *kernel_weight(w), b, d, "centered")
        ref = snake_conv_reference(x, alpha, beta, w, b, d, "centered")
        err = (y - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item(), ((B, T, C, O, k), err)
    assert device_launches()[0] == len(STREAMING_SHAPES)


@pytest.mark.cuda
def test_op_in_an_exported_program_under_a_graph_capture(cuda, tmp_path):
    """A codec-only artifact traced on the card, saved and loaded: its
    programs captured as CUDA graphs at load, a replayed buffer launching
    the kernel on each of its ConvBlock1d (counted on the device) and
    within 1e-4 x max |y| of the same artifact moved to the CPU, where the
    op runs the plain version."""
    from after_tpu_torch.config import AutoEncoderConfig
    from after_tpu_torch.models.autoencoder import AudioCodec
    from after_tpu_torch.streaming.export import ExportedCodec, export_codec
    from after_tpu_torch.utils.init import init_weights

    cfg = AutoEncoderConfig(pqmf_bands=4, z_channels=8, base_channels=8,
                            multipliers=(1, 2, 2), factors=(2, 2),
                            dilations=(1, 3), num_blocks_per_stage=1)
    codec = AudioCodec(cfg)
    init_weights(codec, 0)
    export_codec(cfg, codec.state_dict(), str(tmp_path), chunk_size=4,
                 device=cuda)
    card, cpu = (ExportedCodec(str(tmp_path), d) for d in (cuda, "cpu"))
    assert card.graphs is not None and card.graphs.captures == 3
    rng = np.random.RandomState(9)
    for i in range(4):
        x = (0.3 * rng.randn(1, 4 * cfg.ratio, 1)).astype(np.float32)
        reset_device_launches()
        y = card.forward(x)
        # 3 resnets of 2 conv blocks in the encode and in the decode
        assert device_launches()[0] == 12
        ref = cpu.forward(x)
        err = (y.cpu() - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item(), (i, err)
    assert card.graphs.captures == 3 and card.graphs.replays == 4


@pytest.mark.cuda
def test_kernel_at_the_encoders_batch_8_shapes(cuda):
    """``prepare_dataset``'s encode: the base codec's encoder at batch 8 x
    524288 samples.  Each ConvBlock1d's input, as the encode hands it over,
    through the kernel against the plain version, and on the first 256
    frames a row against float64 at most 4x strict-f32 F.conv1d's error."""
    from after_tpu_torch.config import get_ae_config
    from after_tpu_torch.models.autoencoder import AudioCodec, ConvBlock1d
    from after_tpu_torch.ops.kernels.fused_conv import snake_conv
    from after_tpu_torch.utils.init import init_weights

    codec = AudioCodec(get_ae_config()).eval()
    init_weights(codec, 0)
    codec.to(cuda)
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0])))
        for m in codec.encoder.modules() if isinstance(m, ConvBlock1d)]
    x = 0.1 * torch.randn((8, 524288, 1), device=cuda,
                          generator=torch.Generator(cuda).manual_seed(0))
    reset_device_launches()
    with torch.inference_mode():
        codec.encode(x)
        assert device_launches()[0] == len(seen) > 0
        for h in hooks:
            h.remove()
        for block, inp in seen:
            h = block.gn(inp).contiguous()
            args = (h, block.act.alpha, block.act.beta)
            conv = block.conv
            w = conv.effective_weight()
            y = snake_conv(*args, *conv.kernel_weights(), conv.bias,
                           conv.dilation, conv.mode)
            ref = snake_conv_reference(*args, w, conv.bias, conv.dilation,
                                       conv.mode)
            assert y.shape[0] == 8 and y.shape == ref.shape
            err = (y - ref).abs().max().item()
            assert err <= 1e-4 * ref.abs().max().item(), (h.shape, err)
            h = h[:, :256].contiguous()
            args = (h, block.act.alpha, block.act.beta)
            ref64 = snake_conv_reference(
                *(t.double() for t in (*args, w, conv.bias)), conv.dilation,
                conv.mode)
            y = snake_conv(*args, *conv.kernel_weights(), conv.bias,
                           conv.dilation, conv.mode)
            strict = snake_conv_reference(*args, w, conv.bias, conv.dilation,
                                          conv.mode)
            err64 = (y.double() - ref64).abs().max().item()
            err_conv1d = (strict.double() - ref64).abs().max().item()
            assert err64 <= 4 * max(err_conv1d, 1e-30), (h.shape, err64,
                                                         err_conv1d)


KERNEL_TOL = 1e-4


def _training_shapes():
    """(k, d, C, O, T, mode) of every distinct ConvBlock1d of the base
    codec's forward on 131072 samples (a training crop), with its block."""
    from after_tpu_torch.config import get_ae_config
    from after_tpu_torch.models.autoencoder import AudioCodec, ConvBlock1d
    from after_tpu_torch.utils.init import init_weights

    codec = AudioCodec(get_ae_config()).cuda()
    init_weights(codec, 0)
    seen = {}

    def record(mod, args):
        c = mod.conv
        seen.setdefault((c.kernel_size, c.dilation, c.in_features,
                         c.features, args[0].shape[1], c.mode), mod)
    hooks = [m.register_forward_pre_hook(record) for m in codec.modules()
             if isinstance(m, ConvBlock1d)]
    with torch.no_grad():
        codec(torch.zeros((1, 131072, 1), device="cuda"))
    for h in hooks:
        h.remove()
    return seen


@pytest.mark.cuda
def test_backward_kernels_at_the_training_shapes(cuda):
    """dgrad and wgrad against the plain backward (the VJP of the plain
    forward) at every distinct ConvBlock1d shape of a training codec forward
    at batch 8 x 131072 samples, each of the five gradients within
    KERNEL_TOL x its max |g|; each launch counted on the device."""
    from after_tpu_torch.ops.kernels.fused_conv import (
        backward_device_launches, snake_conv_backward,
        snake_conv_backward_reference)

    shapes = _training_shapes()
    assert len(shapes) == 39
    gen = torch.Generator(cuda).manual_seed(0)
    reset_device_launches()
    for (k, d, C, O, T, mode), block in sorted(shapes.items(),
                                                key=lambda kv: str(kv[0])):
        x = torch.randn((8, T, C), device=cuda, generator=gen)
        g = torch.randn((8, T, O), device=cuda, generator=gen)
        with torch.no_grad():
            w_k = block.conv.kernel_weights()[0]
        args = (g, x, block.act.alpha.detach(), block.act.beta.detach(),
                w_k.detach(), block.conv.bias.detach(), d, mode)
        ours = snake_conv_backward(*args, [True] * 5)
        ref = snake_conv_backward_reference(*args, [True] * 5)
        for name, a, r in zip("x alpha beta w b".split(), ours, ref):
            err = (a - r).abs().max().item()
            assert err <= KERNEL_TOL * r.abs().max().item(), (
                (k, d, C, O, T), name, err)
    assert backward_device_launches()[:2] == (len(shapes), len(shapes))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,O,k,d,mode", [
    (8, 256, 768, 768, 3, 9, "centered"), (8, 8192, 64, 64, 3, 1, "centered"),
    (2, 700, 96, 300, 3, 3, "causal"), (2, 37, 130, 70, 1, 1, "causal")])
def test_backward_kernels_give_the_same_bits_eager_and_in_a_graph(
        cuda, B, T, C, O, k, d, mode):
    """Every cross-block sum is added in a fixed order: two launches give
    the same bits, and so does a launch captured in a CUDA graph and
    replayed."""
    from after_tpu_torch.ops.kernels.fused_conv import snake_conv_backward

    x, alpha, beta, w, b = _inputs(11, B, T, C, O, k, cuda)
    g = torch.randn((B, T, O), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    args = (g, x, alpha, beta, kernel_weight(w)[0], b, d, mode, [True] * 5)
    first = snake_conv_backward(*args)
    again = snake_conv_backward(*args)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        captured = snake_conv_backward(*args)
    graph.replay()
    torch.cuda.synchronize()
    for a, b2, c in zip(first, again, captured):
        assert torch.equal(a, b2) and torch.equal(a, c)


@pytest.mark.cuda
def test_backward_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    """Another dtype, a non-contiguous or misplaced tensor, a wrong shape
    and a window longer than the kernels stage raise."""
    from after_tpu_torch.ops.kernels.fused_conv import snake_conv_backward

    x, alpha, beta, w, b = _inputs(12, 1, 64, 16, 24, 3, cuda)
    g = torch.randn((1, 64, 24), device=cuda)
    w_k = kernel_weight(w)[0]
    every = [True] * 5
    with pytest.raises(TypeError):
        snake_conv_backward(g.double(), x, alpha, beta, w_k, b, 1, "causal",
                            every)
    with pytest.raises(ValueError):
        snake_conv_backward(g.transpose(1, 2).contiguous().transpose(1, 2),
                            x, alpha, beta, w_k, b, 1, "causal", every)
    with pytest.raises(ValueError):
        snake_conv_backward(g, x, alpha.cpu(), beta, w_k, b, 1, "causal",
                            every)
    with pytest.raises(ValueError):
        snake_conv_backward(g[:, :32].contiguous(), x, alpha, beta, w_k, b,
                            1, "causal", every)
    with pytest.raises(ValueError):
        snake_conv_backward(g, x, alpha, beta, w_k, b, 100, "causal", every)


def _bf16_ulp(v: float) -> float:
    """The spacing of bf16 values at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


BF16_BACKWARD_SHAPES = [
    (8, 8192, 16, 64, 3, 1, "centered"), (8, 8192, 64, 64, 3, 9, "centered"),
    (8, 1024, 256, 256, 1, 1, "centered"), (2, 1000, 20, 24, 3, 9, "causal"),
    (1, 77, 40, 36, 1, 1, "centered"),
    # the encoder's deepest convs at batch 8 x 131072 samples
    (8, 256, 512, 512, 3, 9, "centered"), (8, 256, 512, 512, 1, 1, "centered"),
    # C and O without 16-byte rows: g staged without TMA, x and gx by
    # elements
    (2, 300, 36, 20, 3, 3, "causal"),
    # wgrad: one signal, its frame sum split over blocks; T not a multiple
    # of the 64-frame chunk at d = 9, centered; more work items than blocks
    # (9 taps in three groups of 768 x 768), so that a persistent block
    # takes several
    (1, 8192, 64, 64, 3, 1, "centered"), (2, 1000, 128, 64, 3, 9, "centered"),
    (1, 200, 768, 768, 9, 1, "centered")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,O,k,d,mode", BF16_BACKWARD_SHAPES)
def test_bf16_backward_kernels_match_plain_version(cuda, B, T, C, O, k, d,
                                                   mode):
    """The bf16 dgrad and wgrad against the plain bf16 backward (f32 math
    on the widened inputs, each gradient rounded once) at training shapes
    of the encoder (k = 1 and 3, d up to 9, its first conv's 16 input
    channels, its widest 512 at k = 3) and ragged ones (T, C and O not
    multiples of the tiles, C and O without 16-byte rows): each of the five
    gradients within 2 bf16 ulps of its max |g|; the launches counted on
    the device apart from the f32 kernels'."""
    from after_tpu_torch.ops.kernels.fused_conv import (
        backward_device_launches, snake_conv_backward,
        snake_conv_backward_reference)

    x, alpha, beta, w, b = (t.to(torch.bfloat16) for t in _inputs(
        13, B, T, C, O, k, cuda))
    g = torch.randn((B, T, O), device=cuda, generator=torch.Generator(
        cuda).manual_seed(2)).to(torch.bfloat16)
    args = (g, x, alpha, beta, kernel_weight(w)[0], b, d, mode, [True] * 5)
    reset_device_launches()
    ours = snake_conv_backward(*args)
    assert backward_device_launches(dtype=torch.bfloat16)[:2] == (1, 1)
    assert backward_device_launches()[:2] == (0, 0)
    ref = snake_conv_backward_reference(*args)
    for name, a, r in zip("x alpha beta w b".split(), ours, ref):
        assert a.dtype == torch.bfloat16, name
        scale = r.float().abs().max().item()
        err = (a.float() - r.float()).abs().max().item()
        assert err <= 2 * _bf16_ulp(scale), (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,O,k,d,mode", BF16_BACKWARD_SHAPES)
def test_bf16_backward_kernels_give_the_same_bits_eager_and_in_a_graph(
        cuda, B, T, C, O, k, d, mode):
    from after_tpu_torch.ops.kernels.fused_conv import snake_conv_backward

    x, alpha, beta, w, b = (t.to(torch.bfloat16) for t in _inputs(
        14, B, T, C, O, k, cuda))
    g = torch.randn((B, T, O), device=cuda).to(torch.bfloat16)
    args = (g, x, alpha, beta, kernel_weight(w)[0], b, d, mode, [True] * 5)
    first = snake_conv_backward(*args)
    again = snake_conv_backward(*args)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        captured = snake_conv_backward(*args)
    graph.replay()
    torch.cuda.synchronize()
    for a, b2, c in zip(first, again, captured):
        assert torch.equal(a, b2) and torch.equal(a, c)


@pytest.mark.cuda
def test_bf16_wgrad_plan_gives_a_block_several_work_items(cuda):
    """The persistent wgrad blocks walk more than one work item at the
    shape that BF16_BACKWARD_SHAPES holds for it, so the ring's phases run
    on across items there."""
    from after_tpu_torch.ops.kernels.fused_conv import bf16_wgrad_tiles

    B, T, C, O, k, d, _ = BF16_BACKWARD_SHAPES[-1]
    bn, kt, outs, wsplit, ring, splits, items, grid = bf16_wgrad_tiles(
        B, T, C, O, k, d)
    assert items == -(-O // outs) * -(-C // bn) * (k // kt) * splits
    assert items > grid


@pytest.mark.cuda
@pytest.mark.parametrize("C,O,k,mode", [(20, 24, 3, "causal"),
                                        (36, 64, 1, "centered"),
                                        (100, 72, 3, "centered")])
def test_bf16_wgrad_writes_zeros_past_C(cuda, C, O, k, mode):
    """gw (k, O, Cw) comes back with zeros in its columns past C (Cw is C
    rounded up to 8), also where the memory it takes held garbage: the
    caching allocator hands the op a block just filled with NaN."""
    from after_tpu_torch.ops.kernels.fused_conv import (
        snake_conv_backward, snake_conv_backward_reference)

    B, T, d = 2, 500, 3
    x, alpha, beta, w, b = (t.to(torch.bfloat16) for t in _inputs(
        16, B, T, C, O, k, cuda))
    g = torch.randn((B, T, O), device=cuda, generator=torch.Generator(
        cuda).manual_seed(3)).to(torch.bfloat16)
    w_k = kernel_weight(w)[0]
    assert w_k.shape[2] > C
    wanted = [False, False, False, True, False]
    args = (g, x, alpha, beta, w_k, b, d, mode, wanted)
    for _ in range(3):
        torch.full(w_k.shape, float("nan"), device=cuda,
                   dtype=torch.bfloat16)
        gw = snake_conv_backward(*args)[3]
        torch.cuda.synchronize()
        assert not gw[:, :, C:].any()
        ref = snake_conv_backward_reference(*args)[3]
        scale = ref.float().abs().max().item()
        err = (gw.float() - ref.float()).abs().max().item()
        assert err <= 2 * _bf16_ulp(scale), (err, scale)


@pytest.mark.cuda
def test_bf16_backward_refuses_an_f32_tensor_in_a_bf16_call(cuda):
    from after_tpu_torch.ops.kernels.fused_conv import snake_conv_backward

    x, alpha, beta, w, b = (t.to(torch.bfloat16) for t in _inputs(
        15, 1, 64, 16, 24, 3, cuda))
    g = torch.randn((1, 64, 24), device=cuda)
    w_k = kernel_weight(w)[0]
    every = [True] * 5
    with pytest.raises(TypeError):
        snake_conv_backward(g, x, alpha, beta, w_k, b, 1, "causal", every)
    with pytest.raises(TypeError):
        snake_conv_backward(g.to(torch.bfloat16), x, alpha.float(), beta,
                            w_k, b, 1, "causal", every)
