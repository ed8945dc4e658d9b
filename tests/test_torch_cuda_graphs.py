"""The port's CUDA graphs on the card: a streamed buffer and a transfer
replayed as graphs against the same calls run op by op (``eager=True``),
and the graphs' rules.

These tests need a CUDA card and skip without one.  The machine with the
card has no JAX, so run them there without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda_graphs.py

A small crossfade config (the base codec's path: GroupNorm, centered
convs, the snake+conv kernel on every conv window) with port-native random
weights.  Tolerance: graph and eager within 1e-6 x max |y| (the same
kernels on the same inputs: equal in practice).
"""

import numpy as np
import pytest
import torch

from after_tpu_torch import config as port_config
from after_tpu_torch.diffusion.pipeline import TransferPipeline
from after_tpu_torch.ops.kernels.fused_conv import (device_launches,
                                                    fused_snake_conv,
                                                    kernel_plan,
                                                    reset_device_launches)
from after_tpu_torch.streaming import Streamer
from after_tpu_torch.streaming.state import flatten_state
from after_tpu_torch.utils.device import strict_f32
from after_tpu_torch.utils.graphs import GraphPool

GRAPH_TOL = 1e-6
B = 2
OVERRIDES = {
    "autoencoder.pqmf_bands": 4, "autoencoder.z_channels": 8,
    "autoencoder.base_channels": 8, "autoencoder.multipliers": (1, 2, 2),
    "autoencoder.factors": (2, 2), "autoencoder.dilations": (1, 3),
    "autoencoder.num_blocks_per_stage": 1,
    "encoder.channels": (32, 32, 32, 64), "encoder.se_channels": 8,
    "encoder.attention_channels": 8,
    "encoder_time.channels": (8, 16, 12),
    "denoiser.embed_dim": 64, "denoiser.n_layers": 2,
    "denoiser.head_dim": 32, "denoiser.rotary_dim": 16,
}
# (nb_steps, guidance_timbre, guidance_structure) of each buffer
ATTRIBUTES = [(1, 1.7, 0.3), (3, 2.0, 1.5), (16, 1.0, 1.0), (4, 0.5, 2.5),
              (2, 3.0, 0.0), (1, 1.2, 0.8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    strict_f32()
    return torch.device("cuda")


def _cfg():
    return port_config.get_config("base", **OVERRIDES).resolved(
        in_size=8, n_signal=32)


@pytest.fixture
def streamers(cuda):
    """A graphed streamer and an eager one on the same weights."""
    pipe = TransferPipeline(_cfg(), device=cuda).init(0)
    return (Streamer(pipe.cfg, chunk_size=4, pipeline=pipe),
            Streamer(pipe.cfg, chunk_size=4, pipeline=pipe, eager=True))


def _buffers(streamer, n, seed):
    rng = np.random.RandomState(seed)
    A, C = streamer.audio_chunk, streamer.cfg.denoiser.n_channels
    return [((0.3 * rng.randn(B, A, 1)).astype(np.float32),
             (0.3 * rng.randn(B, A, 1)).astype(np.float32),
             rng.randn(B, 4, C).astype(np.float32)) for _ in range(n)]


def _close(y, ref):
    err = (y - ref).abs().max().item()
    assert err <= GRAPH_TOL * ref.abs().max().item(), err


@pytest.mark.cuda
def test_stream_graphs_match_eager_with_changing_attributes(streamers):
    graphed, eager = streamers
    s_g, s_e = graphed.init_state(B), eager.init_state(B)
    ptrs = {k: t.data_ptr() for k, t in flatten_state(s_g).items()}
    captures = graphed.graphs.captures
    for (a, b, x0), (nb, gt, gs) in zip(_buffers(graphed, 6, 0), ATTRIBUTES):
        y, s_g = graphed.forward(s_g, a, b, nb, gt, gs, x0=x0)
        ref, s_e = eager.forward(s_e, a, b, nb, gt, gs, x0=x0)
        _close(y, ref)
    assert graphed.graphs.captures == captures
    assert eager.graphs is None
    assert ptrs == {k: t.data_ptr() for k, t in flatten_state(s_g).items()}
    for k, t in flatten_state(s_g).items():
        assert torch.equal(t, flatten_state(s_e)[k]), k


@pytest.mark.cuda
def test_stream_replays_count_the_kernel(streamers):
    """The kernel counts its launches on the device: each replayed buffer
    adds one launch per ConvBlock1d of the crossfade window's two encodes
    and decode, while the wrapper's Python count, which a replay does not
    reach, stays where the capture left it."""
    graphed, eager = streamers
    state, e_state = graphed.init_state(B), eager.init_state(B)
    a, b, x0 = _buffers(graphed, 1, 1)[0]
    reset_device_launches()
    calls = fused_snake_conv.launches
    eager.forward(e_state, a, b, 2, 1.0, 1.0, x0=x0)
    per_buffer = fused_snake_conv.launches - calls
    assert per_buffer > 0
    assert device_launches()[0] == per_buffer
    reset_device_launches()
    calls = fused_snake_conv.launches
    for nb in (2, 5):
        graphed.forward(state, a, b, nb, 1.0, 1.0, x0=x0)
    assert device_launches()[0] == 2 * per_buffer
    assert fused_snake_conv.launches == calls


@pytest.mark.cuda
def test_transfer_replays_count_the_kernel(cuda):
    pipe = TransferPipeline(_cfg(), device=cuda).init(0)
    n = 32 * pipe.cfg.autoencoder.ratio
    a = np.zeros((1, n, 1), np.float32)
    pipe.transfer(a, a, 2)                    # warm-up, capture, one replay
    reset_device_launches()
    calls = fused_snake_conv.launches
    for _ in range(3):
        pipe.transfer(a, a, 2)
    launches = device_launches()[0]
    assert launches > 0 and launches % 3 == 0
    assert fused_snake_conv.launches == calls
    pipe.eager = True
    reset_device_launches()
    pipe.transfer(a, a, 2)
    assert device_launches()[0] == launches // 3
    assert fused_snake_conv.launches == calls + launches // 3


@pytest.mark.cuda
def test_outputs_are_not_the_graphs_buffers(streamers):
    graphed, _ = streamers
    state = graphed.init_state(B)
    (a1, b1, x1), (a2, b2, x2) = _buffers(graphed, 2, 2)
    y1, state = graphed.forward(state, a1, b1, 2, 2.0, 1.0, x0=x1)
    kept = y1.clone()
    y2, state = graphed.forward(state, a2, b2, 2, 2.0, 1.0, x0=x2)
    assert y1.data_ptr() != y2.data_ptr()
    assert torch.equal(y1, kept)
    assert not torch.equal(y1, y2)


@pytest.mark.cuda
def test_each_state_gets_its_own_graphs(streamers):
    graphed, eager = streamers
    first = graphed.init_state(B)
    captures = graphed.graphs.captures
    second = graphed.init_state(B)
    per_state = graphed.graphs.captures - captures
    assert per_state == 3 + graphed.cfg.denoiser.max_diffusion_steps
    assert graphed._states[first].graphs is not graphed._states[second].graphs
    # interleaved streams on the two states match two eager streams
    e1, e2 = eager.init_state(B), eager.init_state(B)
    for (a, b, x0), (nb, gt, gs) in zip(_buffers(graphed, 4, 3), ATTRIBUTES):
        y1, first = graphed.forward(first, a, b, nb, gt, gs, x0=x0)
        y2, second = graphed.forward(second, b, a, nb, gs + 1, gt, x0=-x0)
        _close(y1, eager.forward(e1, a, b, nb, gt, gs, x0=x0)[0])
        _close(y2, eager.forward(e2, b, a, nb, gs + 1, gt, x0=-x0)[0])
    assert graphed.graphs.captures == captures + per_state


@pytest.mark.cuda
def test_transfer_graph_matches_eager(cuda):
    pipe = TransferPipeline(_cfg(), device=cuda).init(0)
    n = 32 * pipe.cfg.autoencoder.ratio
    rng = np.random.RandomState(4)
    a, b = ((0.3 * rng.randn(1, n, 1)).astype(np.float32) for _ in range(2))
    outs = []
    for gt, gs in [(2.0, 1.0), (1.7, 0.3)]:
        y = pipe.transfer(a, b, 3, gt, gs)
        pipe.eager = True
        _close(y, pipe.transfer(a, b, 3, gt, gs))
        pipe.eager = False
        outs.append(y)
    assert pipe.graphs.captures == 1
    assert not torch.equal(outs[0], outs[1])
    # new weights written in place: the graph is captured again
    pipe.init(1)
    y = pipe.transfer(a, b, 3, 2.0, 1.0)
    assert pipe.graphs.captures == 2
    pipe.eager = True
    _close(y, pipe.transfer(a, b, 3, 2.0, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,O,k,d", [(1, 256, 768, 768, 3, 9),
                                         (2, 32, 512, 512, 1, 1)])
def test_split_channel_sums_give_the_same_bits(cuda, B, T, C, O, k, d):
    """A shape whose plan splits the channel sum over blocks: eager launches
    and a graph replay agree bit for bit (the partial sums are added in a
    fixed order, not with atomics)."""
    assert kernel_plan(B, T, C, O, k, d)[2] > 1
    rng = np.random.RandomState(0)
    x, alpha, beta, w, b = (torch.tensor(a, dtype=torch.float32, device=cuda)
                            for a in (rng.randn(B, T, C), rng.rand(C) + 0.5,
                                      rng.rand(C) + 0.5,
                                      0.1 * rng.randn(O, C, k),
                                      rng.randn(O)))
    first = fused_snake_conv(x, alpha, beta, w, b, d, "centered")
    pool = GraphPool(cuda)
    pool.warm(lambda: fused_snake_conv(x, alpha, beta, w, b, d, "centered"))
    graph = pool.capture(lambda: fused_snake_conv(x, alpha, beta, w, b, d,
                                                  "centered"))
    reset_device_launches()
    for _ in range(3):
        assert torch.equal(fused_snake_conv(x, alpha, beta, w, b, d,
                                            "centered"), first)
        assert torch.equal(graph.replay(), first)
    # each launch, eager or replayed, runs the conv kernel and the split sum
    assert device_launches() == (6, 6)


@pytest.mark.cuda
def test_eager_calls_make_no_host_sync(streamers):
    """An eager buffer and a replayed one, with host inputs, under the
    sync debug mode that raises on a host sync."""
    graphed, eager = streamers
    state, s_g = eager.init_state(B), graphed.init_state(B)
    a, b, x0 = _buffers(eager, 1, 5)[0]
    eager.forward(state, a, b, 2, 2.0, 1.0, x0=x0)      # fills the constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager.forward(state, a, b, 3, 1.7, 0.3, x0=x0)
        eager.forward(state, a, b, 3, 1.7, 0.3)
        graphed.forward(s_g, a, b, 3, 1.7, 0.3, x0=x0)
        graphed.forward(s_g, a, b, 3, 1.7, 0.3)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_a_failing_capture_raises(cuda):
    pool = GraphPool(cuda)
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        pool.capture(lambda: torch.cuda.synchronize())
    with pytest.raises(RuntimeError):
        pool.capture(lambda: (x * 2).sum().item())
    assert pool.captures == 0
