"""The port's CUDA graphs on the card: a streamed buffer, a transfer and
the diffusion trainer's steps and windows replayed as graphs against the
same calls run op by op (``eager=True``), and the graphs' rules.

These tests need a CUDA card and skip without one.  The machine with the
card has no JAX, so run them there without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda_graphs.py

A small crossfade config (the base codec's path: GroupNorm, centered
convs, the snake+conv kernel on every conv window) with port-native random
weights.  Tolerance: graph and eager within 1e-6 x max |y| (the same
kernels on the same inputs: equal in practice).

The trainer runs the micro diffusion config of tests/test_diffusion.py with
its dropouts on, and cuDNN's deterministic algorithms: its graphs and its
op-by-op steps then run the same kernels on the same inputs and draws, and
are held to the same bits.
"""

import gc

import numpy as np
import pytest
import torch

from after_tpu_torch import config as port_config
from after_tpu_torch.diffusion.pipeline import TransferPipeline
from after_tpu_torch.diffusion.trainer import DiffusionTrainer
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
# tests/test_diffusion.py's micro_config, whose module imports JAX
DIFFUSION_OVERRIDES = {
    "denoiser.embed_dim": 64, "denoiser.n_layers": 2,
    "denoiser.noise_embed_dims": 16, "denoiser.mlp_multiplier": 2,
    "encoder.channels": (16, 16, 16, 32),
    "encoder_time.channels": (16, 16, 16, 16, 12),
    "classifier.channels": (16, 16, 16, 16, 6), "train.n_signal": 32,
    "autoencoder.pqmf_bands": 4, "autoencoder.z_channels": 8,
    "autoencoder.base_channels": 8, "autoencoder.multipliers": (1, 2, 2),
    "autoencoder.factors": (2, 2), "autoencoder.dilations": (1, 3),
    "autoencoder.num_blocks_per_stage": 1,
    # 9 steps: phase 1 (0-2), then a diffusion and two classifier steps
    "train.timbre_warmup": 3, "train.update_classifier_every": 3,
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


@pytest.mark.cuda
def test_a_collection_cannot_free_a_graph_inside_a_capture(cuda):
    """Garbage that holds another pool's graph in a reference cycle, and a
    capture that allocates enough to start a collection: the collector is
    off while capturing, so the old graph is not destroyed mid-capture."""
    x = torch.ones(4, device=cuda)
    old = GraphPool(cuda)
    cycle = [old.capture(lambda: x * 2)]
    cycle.append(cycle)
    del cycle, old

    def fn():
        assert not gc.isenabled()
        junk = [[] for _ in range(5 * gc.get_threshold()[0])]
        return x * 3 + len(junk) * 0
    graph = GraphPool(cuda).capture(fn)
    assert gc.isenabled()
    torch.testing.assert_close(graph.replay(), x * 3)
    gc.collect()


def _trainers(cuda, **overrides):
    """A graphed diffusion trainer and an eager one, same weights and
    generator seed."""
    cfg = port_config.with_overrides(port_config.get_config(
        "tiny", **DIFFUSION_OVERRIDES).resolved(in_size=8, n_signal=32),
        overrides)
    return (DiffusionTrainer(cfg, device=cuda, seed=1).init(0),
            DiffusionTrainer(cfg, device=cuda, seed=1, eager=True).init(0))


def _latents(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randn(4, 32, 8).astype(np.float32)
        out.append({"x": x, "x_cond": rng.randn(4, 32, 8).astype(np.float32),
                    "x_time_cond": x})
    return out


@pytest.fixture
def deterministic(cuda):
    torch.backends.cudnn.deterministic = True
    yield cuda
    torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
def test_diffusion_fit_graphs_match_eager(deterministic, K):
    """Nine steps of ``fit`` (K = 3: three windows) as CUDA graphs and op
    by op: the same callbacks with the same metrics, and the same weights,
    statistics, EMA and moments after them, also where a replayed
    classifier step follows a replayed diffusion step that moved the
    encoders; one capture for each step signature at its first step (phase
    1, diffusion, classifier) and none after."""
    graphed, eager = _trainers(deterministic, **{"train.steps_per_call": K})
    batches = _latents(9, 0)
    runs = []
    for tr in (graphed, eager):
        seen = []
        tr.fit(iter(batches), max_steps=9, callback=lambda t, m: seen.append(
            (t.step, t.graphs.captures if t.graphs else 0,
             {k: float(v) for k, v in m.items()})))
        runs.append(seen)
    steps = [3, 6, 9] if K == 3 else list(range(1, 10))
    assert [s for s, _, _ in runs[0]] == [s for s, _, _ in runs[1]] == steps
    captures = {s: c for s, c, _ in runs[0]}
    assert captures[3] == 1 and captures[9] == 3
    if K == 1:
        assert captures[4] == 2 and captures[5] == 3
    assert eager.graphs is None
    for (s, _, a), (_, _, b) in zip(*runs):
        assert a == b, s
    for t in (graphed, eager):
        assert int(t.optimizer.count) == 5 and int(t.cls_optimizer.count) == 4
    for a, b in zip(graphed.rf.state_dict().values(),
                    eager.rf.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(graphed.ema + [graphed.optimizer._mu,
                                   graphed.cls_optimizer._nu],
                    eager.ema + [eager.optimizer._mu,
                                 eager.cls_optimizer._nu]):
        assert torch.equal(a, b)
    # graphs of new train-state tensors are made anew
    graphed.init(0)
    assert graphed.graphs is None


@pytest.mark.cuda
def test_diffusion_steps_make_no_host_sync(cuda):
    """Op-by-op and replayed diffusion and classifier steps, with host
    batches, under the sync debug mode that raises on a host sync."""
    graphed, eager = _trainers(cuda, **{"train.timbre_warmup": 0})
    b1, b2 = _latents(2, 1)
    for tr in (graphed, eager):     # fills the constants, captures
        tr.train_step(b1, False, True, True, False, 0.1, 1.0)
        tr.classifier_step(b1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for tr in (graphed, eager):
            tr.train_step(b2, False, True, True, False, 0.2, 1.0)
            tr.classifier_step(b2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert graphed.graphs.captures == 2 and graphed.graphs.replays == 2


@pytest.mark.cuda
def test_artifact_host_eager_matches_its_graphs(streamers, tmp_path):
    """An artifact's host with ``eager`` set runs its stage calls op by op
    (no replay) and gives its graphs' outputs from the same state."""
    from after_tpu_torch.streaming.export import (ExportedStreamer,
                                                  export_streamer)
    export_streamer(streamers[0], str(tmp_path / "art"), nb_steps=4)
    host = ExportedStreamer(str(tmp_path / "art"), "cuda")
    rng = np.random.RandomState(7)
    A, C = host.manifest["audio_chunk"], streamers[0].cfg.denoiser.n_channels
    bufs = [((0.3 * rng.randn(1, A, 1)).astype(np.float32),
             (0.3 * rng.randn(1, A, 1)).astype(np.float32),
             rng.randn(1, 4, C).astype(np.float32)) for _ in range(3)]

    def run():
        host.reset()
        return torch.cat([host.call("forward", a, b, x0=x0)
                          for a, b, x0 in bufs], dim=1)

    y = run()
    replays = host.graphs.replays
    host.eager = True
    y_eager = run()
    assert host.graphs.replays == replays
    _close(y_eager, y)
