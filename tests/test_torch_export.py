"""The port's streaming artifact (after_tpu_torch/streaming/export.py)
against the port's live ``Streamer``, on the CPU, with the micro config of
tests/test_torch_serving.py (the crossfade codec with GroupNorm) at batch
2:

- every method of the artifact, over buffers whose nb_steps and guidances
  change, against the live streamer with the same noise: within 1e-6 x
  max|y| (the reading printed; both run the same ops, so it is 0);
- a loaded program writes the caller's state tensors in place;
- the step program, its KV slot an int64 0-d input, against the
  int-indexed ``Streamer`` step, bit for bit, on several slots;
- each program holds only the weights it reads: one copy of the
  denoiser's, in the step program;
- ``move_to_device_pass`` on a CPU-traced program, to the meta device;
- the artifact loads and plays in a process where ``after_tpu``, ``jax``
  and ``flax`` cannot be imported.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from after_tpu import config as jax_config
from after_tpu_torch import config as port_config
from after_tpu_torch.diffusion.pipeline import TransferPipeline
from after_tpu_torch.ops.conv import fold_weights
from after_tpu_torch.streaming.export import (ExportedStreamer,
                                              export_streamer, load_program)
from after_tpu_torch.streaming.state import flatten_state
from after_tpu_torch.streaming.streamer import Streamer
from after_tpu_torch.utils.latent_map import SmallAutoencoder
from tests.test_diffusion import micro_config
from tests.test_torch_serving import ATTRIBUTES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2
LIVE_TOL = 1e-6          # max abs difference <= LIVE_TOL * max |y|


def crossfade_config():
    cfg = jax_config.with_overrides(micro_config(), {
        "autoencoder.causal": False, "autoencoder.use_norm": True})
    return port_config.from_json(jax_config.to_json(cfg))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = crossfade_config()
    pipe = TransferPipeline(cfg, device="cpu").init(3)
    streamer = Streamer(cfg, chunk_size=4, device="cpu", pipeline=pipe)
    projector = SmallAutoencoder(cfg.zt_channels)
    out = str(tmp_path_factory.mktemp("export") / "artifact")
    export_streamer(streamer, out, nb_steps=2, guidance_timbre=1.5,
                    batch_size=B, projector=projector)
    return streamer, projector, out


@pytest.fixture(scope="module")
def host(artifact):
    """The artifact's host on the CPU, from its initial state."""
    host = ExportedStreamer(artifact[2], device="cpu")
    yield host
    host.reset()


def _buffers(seed, streamer, n):
    rng = np.random.RandomState(seed)
    A, C = streamer.audio_chunk, streamer.cfg.denoiser.n_channels
    return [((0.3 * rng.randn(B, A, 1)).astype(np.float32),
             (0.3 * rng.randn(B, A, 1)).astype(np.float32),
             rng.randn(B, 4, C).astype(np.float32)) for _ in range(n)]


def _close(label, y, ref):
    err = (y - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"{label}: max abs difference {err:.3e} ({err / scale:.3e} x "
          f"max|y|; limit {LIVE_TOL})")
    assert err <= LIVE_TOL * scale, label


def test_forward_matches_the_live_streamer(artifact, host):
    streamer, _, out = artifact
    host.reset()
    assert host.get_attribute("nb_steps") == 2
    assert host.get_attribute("guidance_timbre") == 1.5
    state = streamer.init_state(B)
    for i, ((a, b, x0), (nb, gt, gs)) in enumerate(zip(
            _buffers(1, streamer, len(ATTRIBUTES)), ATTRIBUTES)):
        host.set_attribute("nb_steps", nb)
        host.set_attribute("guidance_timbre", gt)
        host.set_attribute("guidance_structure", gs)
        y, state = streamer.forward(state, a, b, nb, gt, gs, x0=x0)
        _close(f"forward, buffer {i}", host.call("forward", a, b, x0=x0), y)


def test_every_method_matches_the_live_streamer(artifact, host):
    """structure, timbre, diffuse, decode, generate, generate_timbre and the
    projector's maps, each against its live counterpart."""
    streamer, projector, out = artifact
    cfg = streamer.cfg
    host.reset()
    for name, value in (("nb_steps", 3), ("guidance_timbre", 1.5),
                        ("guidance_structure", 1.0)):
        host.set_attribute(name, value)
    state = streamer.init_state(B)
    rng = np.random.RandomState(2)
    for i, (a, b, x0) in enumerate(_buffers(2, streamer, 3)):
        zs = rng.randn(B, 4, cfg.zs_channels).astype(np.float32)
        zt = rng.randn(B, cfg.zt_channels).astype(np.float32)
        z = rng.randn(B, 4, cfg.denoiser.n_channels).astype(np.float32)
        for name, args, live in (
                ("structure", (a,), lambda: streamer.structure(state, a)),
                ("timbre", (b,), lambda: streamer.timbre(state, b)),
                ("diffuse", (zs, zt), lambda: streamer.diffuse(
                    state, zs, zt, 3, 1.5, x0=x0)),
                ("decode", (z,), lambda: streamer.decode(state, z)),
                ("generate", (zs, zt), lambda: streamer.generate(
                    state, zs, zt, 3, 1.5, x0=x0)),
                ("generate_timbre", (a, zt), lambda: streamer.generate_timbre(
                    state, a, zt, 3, 1.5, x0=x0))):
            _close(f"{name}, buffer {i}", host.call(name, *args, x0=x0),
                   live()[0])
    zt = torch.from_numpy(rng.randn(B, cfg.zt_channels).astype(np.float32))
    xy = host.call("latent2map", zt)
    assert torch.equal(xy, streamer.latent2map(projector, zt))
    assert torch.equal(host.call("map2latent", xy),
                       streamer.map2latent(projector, xy))
    assert not host.has_method("diffuse_midi")


def test_reset_restores_the_initial_state(artifact, host):
    streamer, _, out = artifact
    host.reset()
    before = [t.clone() for t in host.state]
    ptrs = [t.data_ptr() for t in host.state]
    a, b, x0 = _buffers(3, streamer, 1)[0]
    host.call("forward", a, b, x0=x0)
    assert any(not torch.equal(t, s) for t, s in zip(host.state, before))
    host.reset()
    assert all(torch.equal(t, s) for t, s in zip(host.state, before))
    assert ptrs == [t.data_ptr() for t in host.state]


def test_a_loaded_program_writes_the_callers_state(artifact):
    """The decode program's writes reach the tensors the caller passed, in
    place, and equal the live streamer's state after the same buffer."""
    streamer, _, out = artifact
    program = load_program(os.path.join(out, "decode.pt2"),
                           torch.device("cpu"))
    live = streamer.init_state(B)
    leaves = [t.clone() for t in flatten_state(live).values()]
    ptrs = [t.data_ptr() for t in leaves]
    z = torch.from_numpy(np.random.RandomState(4).randn(
        B, 4, streamer.cfg.denoiser.n_channels).astype(np.float32))
    y = program(leaves, z)
    y_live, live = streamer.decode(live, z)
    assert torch.equal(y, y_live)
    changed = 0
    for t, p, ref in zip(leaves, ptrs, flatten_state(live).values()):
        assert t.data_ptr() == p and torch.equal(t, ref)
        changed += not torch.equal(t, torch.zeros_like(t))
    assert changed >= 2


def test_step_program_slot_matches_the_int_indexed_streamer(artifact):
    """One step program for every KV slot (its slot an int64 0-d input):
    bit for bit the int-indexed step of the live streamer's graphs, output
    and KV caches, on slots 0, 5 and the last."""
    streamer, _, out = artifact
    cfg = streamer.cfg
    program = load_program(os.path.join(out, "step.pt2"),
                           torch.device("cpu"))
    rng = np.random.RandomState(5)
    live = streamer.init_state(B)
    leaves = [t.clone() for t in flatten_state(live).values()]
    nb, scalars = streamer.rf.stream_scalars(16, 1.7, 0.3)
    scalars = torch.from_numpy(scalars)
    S = cfg.denoiser.max_diffusion_steps
    for slot in (0, 5, S - 1, 5):
        x = torch.from_numpy(rng.randn(
            B, 4, cfg.denoiser.n_channels).astype(np.float32))
        zt = torch.from_numpy(rng.randn(B, cfg.zt_channels).astype(np.float32))
        tc = torch.from_numpy(rng.randn(B, 4, cfg.zs_channels).astype(
            np.float32))
        y = program(leaves, x, zt, tc, scalars,
                    torch.tensor(slot, dtype=torch.int64))
        with torch.no_grad():
            y_live = streamer.step_stage(live, slot, x, zt, tc, scalars)
        assert torch.equal(y, y_live), slot
        for t, ref in zip(leaves, flatten_state(live).values()):
            assert torch.equal(t, ref), slot


def test_each_program_holds_only_the_weights_it_reads(artifact, host):
    """The denoiser's weights once, in the step program; the codec's
    encoder only where audio is encoded, its decoder only in decode."""
    streamer, _, out = artifact
    held = {name: host.programs[name].state_dict()
            for name in ("structure", "timbre", "step", "decode")}
    net = {k for s in held.values() for k in s if ".net." in f".{k}"}
    assert net and net <= set(held["step"])
    n_net = sum(p.numel() for p in streamer.rf.net.parameters())
    assert sum(held["step"][k].numel() for k in net) == n_net
    assert all(".encoder." not in f".{k}" for k in held["step"])
    for name in ("structure", "timbre"):
        assert all(".decoder." not in f".{k}" for k in held[name])
    assert all(".encoder." not in f".{k}" for k in held["decode"])
    assert all(".net." not in f".{k}" for k in held["decode"])


def test_fold_weights_gives_the_same_outputs():
    """The export form of a codec (weights folded into buffers) computes
    what the codec with weight norm computes, bit for bit."""
    from after_tpu_torch.models.autoencoder import AudioCodec
    from after_tpu_torch.utils.init import init_weights
    cfg = crossfade_config().autoencoder
    codec = AudioCodec(cfg).eval()
    init_weights(codec, 0)
    folded = fold_weights(copy.deepcopy(codec))
    names = {n for n, _ in folded.named_parameters()}
    assert not any(n.endswith((".g", ".weight")) and "conv" in n
                   for n in names)
    x = torch.from_numpy((0.3 * np.random.RandomState(6).randn(
        1, 1024, 1)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(folded.encode(x), codec.encode(x))
        z = codec.encode(x)
        assert torch.equal(folded.decode(z), codec.decode(z))


def test_move_to_device_pass_on_a_cpu_traced_program(artifact):
    """A program traced on the CPU holds CPU constants; the pass a host
    runs to load it elsewhere moves every weight, constant and device
    argument of the graph (here to the meta device, where the op's
    registered shape function runs it)."""
    from torch.export.passes import move_to_device_pass
    streamer, _, out = artifact
    program = torch.export.load(os.path.join(out, "decode.pt2"))
    tensors = [*program.state_dict.values(), *program.constants.values()]
    assert all(t.device.type == "cpu" for t in tensors
               if isinstance(t, torch.Tensor))
    moved = move_to_device_pass(program, "meta")
    tensors = [*moved.state_dict.values(), *moved.constants.values()]
    assert all(t.device.type == "meta" for t in tensors
               if isinstance(t, torch.Tensor))
    for node in moved.graph.nodes:
        device = node.kwargs.get("device")
        assert device is None or torch.device(device).type == "meta"
    assert any(node.target is torch.ops.after_tpu_torch.snake_conv.default
               for node in moved.graph.nodes)
    leaves = [torch.empty_like(t, device="meta")
              for t in flatten_state(streamer.new_state(B)).values()]
    z = torch.empty((B, 4, streamer.cfg.denoiser.n_channels), device="meta")
    y = moved.module()(leaves, z)
    assert y.device.type == "meta"
    assert tuple(y.shape) == (B, streamer.audio_chunk, 1)


def test_the_artifact_plays_without_jax_or_the_jax_package(artifact):
    streamer, _, out = artifact
    a, b, x0 = _buffers(7, streamer, 1)[0]
    np.savez(os.path.join(out, "..", "buffer.npz"), a=a, b=b, x0=x0)
    code = f"""
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ('jax', 'flax', 'after_tpu'):
            raise ImportError('refused: ' + name)
sys.meta_path.insert(0, Refuse())
import numpy as np, torch
from after_tpu_torch.streaming.export import ExportedStreamer
z = np.load({os.path.join(out, '..', 'buffer.npz')!r})
host = ExportedStreamer({out!r}, device='cpu')
y = host.call('forward', z['a'], z['b'], x0=z['x0'])
np.save({os.path.join(out, '..', 'y.npy')!r}, y.numpy())
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax',
                                                       'after_tpu')]
print(bad)
sys.exit(1 if bad else 0)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    y = np.load(os.path.join(out, "..", "y.npy"))
    ref, _ = streamer.forward(streamer.init_state(B), a, b, 2, 1.5, x0=x0)
    np.testing.assert_array_equal(y, ref.numpy())
