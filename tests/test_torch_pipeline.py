"""The port's whole transfer against the JAX pipeline, plus the port's
package-level rules (shared config JSON, no JAX import, no silent CPU).

A tiny config (4-band codec, narrow encoders, a 2-layer denoiser) runs
``transfer`` in the port and the JAX pieces encode -> structure -> timbre ->
diffuse(x0) -> decode with the same weights and the same x0.
Tolerance: atol 1e-3 on the output waveform (a codec, two encoders and
3 sampler steps deep, f32 on both sides).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu import config as jax_config
from after_tpu.diffusion import TransferPipeline as JaxPipeline
from after_tpu_torch import config as port_config
from after_tpu_torch.diffusion.pipeline import TransferPipeline

REPO = Path(__file__).resolve().parents[1]
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
N_SIGNAL = 32                 # latent frames; 32 * 16 = 512 samples


def _perturbed_numpy(variables, seed):
    rng = np.random.RandomState(seed)

    def f(path, v):
        v = np.asarray(v, dtype=np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return (v * (1 + 0.2 * rng.uniform(-1, 1, v.shape))
                + 0.02 * rng.randn(*v.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, variables)


def test_transfer_matches_jax_pieces():
    cfg = jax_config.get_config("base", **OVERRIDES).resolved(
        in_size=8, n_signal=N_SIGNAL)
    jpipe = JaxPipeline(cfg)
    variables = _perturbed_numpy(
        jax.jit(jpipe.init, static_argnums=1)(jax.random.PRNGKey(0), 1), 1)
    rng = np.random.RandomState(2)
    n = N_SIGNAL * cfg.autoencoder.ratio
    a = (0.3 * rng.randn(1, n, 1)).astype(np.float32)
    b = (0.3 * rng.randn(1, n, 1)).astype(np.float32)
    x0 = rng.randn(1, N_SIGNAL, 8).astype(np.float32)

    z_s = jpipe.encode(variables, jnp.asarray(a))
    z_t = jpipe.encode(variables, jnp.asarray(b))
    time_cond = jpipe.structure(variables, z_s)
    cond = jpipe.timbre(variables, z_t)
    z_out = jpipe.diffuse(variables, jnp.asarray(x0), cond, time_cond, 3,
                          2.0, 1.5)
    y = np.asarray(jpipe.decode(variables, z_out))

    pcfg = port_config.from_json(jax_config.to_json(cfg))
    pipe = TransferPipeline(pcfg, device="cpu").load_jax(variables)
    py = pipe.transfer(a, b, nb_steps=3, guidance_timbre=2.0,
                       guidance_structure=1.5, x0=x0)
    assert py.device.type == "cpu"
    assert py.shape == y.shape == (1, n + 4, 1)
    assert np.isfinite(py.numpy()).all()
    np.testing.assert_allclose(py.numpy(), y, atol=1e-3)


@pytest.mark.parametrize("names", [("base",), ("tiny",), ("midi",),
                                   ("base", "cycle", "streaming")])
def test_config_json_is_shared(names):
    assert (port_config.to_json(port_config.get_config(*names))
            == jax_config.to_json(jax_config.get_config(*names)))
    cfg = port_config.get_config(*names).resolved(in_size=64, n_signal=256)
    assert port_config.to_json(port_config.from_json(
        port_config.to_json(cfg))) == port_config.to_json(cfg)


def test_import_pulls_in_no_jax():
    code = ("import sys, after_tpu_torch, after_tpu_torch.utils.from_jax, "
            "after_tpu_torch.utils.init, after_tpu_torch.ops.kernels, "
            "after_tpu_torch.streaming.streamer, "
            "after_tpu_torch.streaming.crossfade, "
            "after_tpu_torch.utils.latent_map, "
            "after_tpu_torch.autoencoder.trainer, "
            "after_tpu_torch.models.discriminator, after_tpu_torch.ops.stft, "
            "after_tpu_torch.diffusion.trainer, after_tpu_torch.dataset, "
            "after_tpu_torch.utils.checkpoint, after_tpu_torch.cli.train, "
            "after_tpu_torch.utils.graphs, after_tpu_torch.cli.main, "
            "after_tpu_torch.cli.train_autoencoder, "
            "after_tpu_torch.dataset.audio_example, "
            "after_tpu_torch.dataset.store, after_tpu_torch.dataset.dataset, "
            "after_tpu_torch.dataset.audio, after_tpu_torch.dataset.midi, "
            "after_tpu_torch.dataset.transforms, "
            "after_tpu_torch.utils.logging, "
            "after_tpu_torch.streaming.export, after_tpu_torch.cli.export, "
            "after_tpu_torch.cli.serve, after_tpu_torch.frontend.server, "
            "after_tpu_torch.cli.prepare_dataset, "
            "after_tpu_torch.cli.import_dataset, "
            "after_tpu_torch.cli.import_torch, "
            "after_tpu_torch.dataset.parsers, "
            "after_tpu_torch.dataset.basic_pitch, "
            "after_tpu_torch.dataset.beat_tracker, "
            "after_tpu_torch.dataset.lmdb_import, "
            "after_tpu_torch.ops.streaming_spectral, "
            "after_tpu_torch.utils.port_torch, "
            "after_tpu_torch.utils.gin_import; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'flax' or m == 'after_tpu' or "
            "m.startswith('after_tpu.') or m == 'google.protobuf' or "
            "m.startswith('google.protobuf.') or m == 'yaml' or "
            "m.startswith('yaml.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_device_and_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config.get_config("base", **OVERRIDES).resolved(
        in_size=8, n_signal=N_SIGNAL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransferPipeline(cfg)


def test_port_native_init_is_seeded():
    from after_tpu_torch.ops.conv import StreamConv1d
    cfg = port_config.get_config("base", **OVERRIDES).resolved(
        in_size=8, n_signal=N_SIGNAL)
    a = TransferPipeline(cfg, device="cpu").init(3)
    b = TransferPipeline(cfg, device="cpu").init(3)
    c = TransferPipeline(cfg, device="cpu").init(4)
    sa, sb, sc = (p.codec.state_dict() | {f"rf.{k}": v for k, v in
                                          p.rf.state_dict().items()}
                  for p in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    for m in a.codec.modules():
        if isinstance(m, StreamConv1d):
            # g starts at the kernel's norm: the effective weight is the kernel
            assert torch.allclose(m.effective_weight(), m.weight, atol=1e-6)
            bound = (m.kernel_size * m.in_features) ** -0.5
            assert m.weight.abs().max() <= bound
    q = a.rf.net.block_0.attn.qkv.weight
    assert abs(q.std().item() - 64 ** -0.5) < 0.2 * 64 ** -0.5
