"""The decoder's NoiseGenerator (``AutoEncoderConfig.use_noise``) against
the JAX package's, on the CPU.

Inputs and weights are drawn from numpy seeds over the JAX trees and
carried into the port with utils.from_jax; the uniform noise is the JAX
package's own draw, handed to the port: the key a module is given, and
``PRNGKey(0)`` wherever the JAX codec decodes without a noise rng (decode,
transfer, each streamed chunk), kept by the port's generator as its fixed
draw (``NoiseGenerator.keep_noise``).  Sizes are the micro codec of
tests/test_torch_streaming.py (4 bands, 8 base channels, two stages) and
the micro pipeline of tests/test_torch_pipeline.py.

Tolerances: the helpers and the generator within 1e-5 x max |y| (f32 FFTs
on both sides); the codec's decode rtol 1e-4 with atol 1e-4 x max |y|, a
streamed chunk atol 1e-4 and rtol 1e-4 (tests/test_torch_streaming.py's
codec tolerance); the transfer atol 1e-3 (tests/torch_models_common.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu.config import AutoEncoderConfig as JaxAEConfig
from after_tpu.models import AudioCodec as JaxCodec
from after_tpu.models import autoencoder as jae
from after_tpu_torch.config import AutoEncoderConfig
from after_tpu_torch.models import autoencoder as ae
from after_tpu_torch.utils.from_jax import load_module
from tests import torch_threads_common  # noqa: F401  (xdist workers' threads)
from tests.test_torch_streaming import (CODEC_TOL, TINY, _chunks,
                                        _perturbed, _stream_pair)
from tests.torch_models_common import check_transfer

HELPER_TOL = 1e-5


def _close(ours, theirs, tol):
    theirs = np.asarray(theirs)
    assert tuple(ours.shape) == theirs.shape
    err = np.abs(ours.detach().numpy() - theirs).max()
    assert err <= tol * np.abs(theirs).max(), err


def _uniform(key, shape):
    return np.array(jax.random.uniform(key, shape, minval=-1.0,
                                         maxval=1.0))


def test_noise_helpers_match_jax():
    """mod_sigmoid; the impulse response (numpy's symmetric Hann window, 5
    bins giving 8 taps, rolled by (-n) // 2); the FFT convolution (signal
    padded right, kernel left, the second half kept)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 4, 5).astype(np.float32)
    _close(ae.mod_sigmoid(torch.from_numpy(x)),
           jae.mod_sigmoid(jnp.asarray(x)), HELPER_TOL)
    amp = np.array(jae.mod_sigmoid(jnp.asarray(x) - 1.0))
    for target in (8, 12):
        _close(ae.amp_to_impulse_response(torch.from_numpy(amp), target),
               jae.amp_to_impulse_response(jnp.asarray(amp), target),
               HELPER_TOL)
    sig = rng.uniform(-1, 1, (2, 6, 4, 8)).astype(np.float32)
    ker = rng.randn(2, 6, 4, 8).astype(np.float32)
    _close(ae.fft_convolve(torch.from_numpy(sig), torch.from_numpy(ker)),
           jae.fft_convolve(jnp.asarray(sig), jnp.asarray(ker)), HELPER_TOL)


@pytest.mark.parametrize("mode", ["centered", "causal"])
def test_noise_generator_matches_jax(mode):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 64, 16).astype(np.float32)
    jmod = jae.NoiseGenerator(4, mode=mode)
    key = jax.random.PRNGKey(3)
    variables = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                     key), 2)
    y = jmod.apply(variables, jnp.asarray(x), key)
    mod = ae.NoiseGenerator(16, 4, mode=mode)
    load_module(mod, variables, "noise")
    shape = mod.noise_shape(2, 64)
    assert shape == (2, 8, 4, 8)
    with torch.no_grad():
        py = mod(torch.from_numpy(x), torch.from_numpy(_uniform(key, shape)))
    _close(py, y, HELPER_TOL)


def _noise_codec(**kw):
    jcfg = JaxAEConfig(**TINY, use_noise=True, fused_kernels=False, **kw)
    variables = _perturbed(jax.jit(JaxCodec(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1024, 1))), 4)
    return jcfg, AutoEncoderConfig(**TINY, use_noise=True, **kw), variables


def test_noise_decoder_matches_jax():
    """The offline decode: the JAX codec's noise is PRNGKey(0)'s draw, the
    port's its fixed draw; given as an argument, or kept as the fixed draw,
    it gives the JAX output, and the fixed draw is the same at every call
    for a shape."""
    jcfg, cfg, variables = _noise_codec()
    z = np.random.RandomState(5).randn(2, 8, 8).astype(np.float32)
    y = np.asarray(jax.jit(lambda v, z: JaxCodec(jcfg).apply(
        v, z, method=JaxCodec.decode))(variables, jnp.asarray(z)))
    codec = ae.AudioCodec(cfg).eval()
    load_module(codec, variables, "codec")
    shape = codec.decoder_noise_shape(2, 8)
    assert shape == (2, 4, 4, 8)
    u = torch.from_numpy(_uniform(jax.random.PRNGKey(0), shape))
    tol = dict(rtol=1e-4, atol=1e-4 * np.abs(y).max())
    with torch.no_grad():
        np.testing.assert_allclose(codec.decode(torch.from_numpy(z),
                                                noise=u).numpy(), y, **tol)
        first = codec.decode(torch.from_numpy(z))
        gen = codec.decoder.noise
        fixed = gen.fixed[(shape, "cpu")]
        assert fixed.abs().max() <= 1 and fixed.std() > 0.5
        assert torch.equal(codec.decode(torch.from_numpy(z)), first)
        gen.keep_noise(u)
        np.testing.assert_allclose(codec.decode(torch.from_numpy(z)).numpy(),
                                   y, **tol)
    # the training forward takes the draw as an argument too
    x = (0.3 * np.random.RandomState(6).randn(1, 512, 1)).astype(np.float32)
    y_train = jax.jit(lambda v, x: JaxCodec(jcfg).apply(v, x)[0])(
        variables, jnp.asarray(x))
    with torch.no_grad():
        out = codec(torch.from_numpy(x), decoder_noise=torch.from_numpy(
            _uniform(jax.random.PRNGKey(0),
                     codec.decoder_noise_shape(1, 512 // cfg.ratio))))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(y_train),
                               rtol=1e-4, atol=1e-4 * np.abs(y_train).max())


def test_causal_noise_decoder_streams_like_jax():
    """A causal noise codec decoded chunk by chunk (the NoiseGenerator's
    strided convs cached): each chunk's noise is PRNGKey(0)'s draw of the
    chunk's shape in JAX, the port's kept fixed draw; outputs and caches
    after every chunk."""
    kw = dict(causal=True, use_norm=False)
    _, cfg, variables = _noise_codec(**kw)
    jcodec = JaxCodec(JaxAEConfig(**TINY, use_noise=True, **kw),
                      streaming=True)
    codec = ae.AudioCodec(cfg, streaming=True).eval()
    load_module(codec, variables, "codec")
    chunks = _chunks(9, (2, 4, cfg.z_channels))
    codec.decoder.noise.keep_noise(torch.from_numpy(_uniform(
        jax.random.PRNGKey(0), codec.decoder_noise_shape(2, 4))))
    y = _stream_pair(jcodec, {"params": variables["params"]}, codec, chunks,
                     CODEC_TOL, method=JaxCodec.decode,
                     port_call=lambda x, c: codec.decode(x, c))
    assert np.isfinite(y.numpy()).all()
    assert any(k.startswith("decoder/noise/conv_") for k in
               _cache_keys(codec, chunks[0]))


def _cache_keys(codec, z):
    from after_tpu_torch.streaming.state import init_cache
    return init_cache(lambda c: codec.decode(torch.from_numpy(z), c)).keys()


def test_noise_codec_transfer_matches_jax():
    """A transfer through a noise codec, the port's decode keeping the JAX
    decode's PRNGKey(0) draw."""
    def keep(pipe):
        gen = pipe.codec.decoder.noise
        shape = pipe.codec.decoder_noise_shape(1, 32)
        gen.keep_noise(torch.from_numpy(_uniform(jax.random.PRNGKey(0),
                                                 shape)))
    check_transfer({"autoencoder.use_noise": True}, prepare=keep)


def test_noise_codec_artifact_keeps_the_fixed_draw(tmp_path):
    """A crossfade streamer of a noise codec exported: the decode program
    holds the decoder's fixed draw as a constant, and the Python host's
    decode and forward give the live streamer's (1e-6 x max |y|, both run
    the same ops), buffer after buffer; the decode stage's package for the
    native host gives the program's output within 1e-5 x max |y| (the
    native host's HOST_TOL; tests/test_torch_stream_host_noise.py plays the
    whole artifact)."""
    import dataclasses
    import os

    from after_tpu_torch.diffusion.pipeline import TransferPipeline
    from after_tpu_torch.streaming.export import (ExportedStreamer,
                                                  export_streamer)
    from after_tpu_torch.streaming.streamer import Streamer
    from tests.test_torch_export import LIVE_TOL, crossfade_config

    base = crossfade_config()
    cfg = dataclasses.replace(base, autoencoder=dataclasses.replace(
        base.autoencoder, use_noise=True))
    pipe = TransferPipeline(cfg, device="cpu").init(3)
    streamer = Streamer(cfg, chunk_size=4, device="cpu", pipeline=pipe)
    out = export_streamer(streamer, str(tmp_path / "noise"), nb_steps=2)
    host = ExportedStreamer(out, device="cpu")
    kept = streamer.codec.decoder.noise.fixed
    assert len(kept) == 1
    noise = next(iter(kept.values()))
    program = torch.export.load(os.path.join(out, "decode.pt2"))
    assert any(torch.equal(t, noise) for t in program.constants.values()
               if t.shape == noise.shape)
    # the decode stage's AOTInductor package for the native host carries
    # the draw: the package gives the program's output on the same state
    from after_tpu_torch.streaming.native import package_stage
    pkg_path = str(tmp_path / "decode_cpu.pt2")
    writes = package_stage(os.path.join(out, "decode.pt2"), pkg_path,
                           torch.device("cpu"))
    z = np.random.RandomState(13).randn(1, 4, cfg.denoiser.n_channels)
    z = torch.from_numpy(z.astype(np.float32))
    # contiguous leaves, as the native host reads them (a package assumes
    # the strides it was traced with)
    leaves = [t.contiguous() for t in host.state]
    y_pkg = torch._inductor.aoti_load_package(pkg_path)(
        [t.clone() for t in leaves], z)
    y_prog = host.programs["decode"]([t.clone() for t in leaves], z)
    assert len(y_pkg) == len(writes) + 1
    assert float((y_pkg[0] - y_prog).abs().max()) <= 1e-5 * float(
        y_prog.abs().max())
    state = streamer.init_state(1)
    rng = np.random.RandomState(12)
    for i in range(3):
        z = rng.randn(1, 4, cfg.denoiser.n_channels).astype(np.float32)
        a, b = ((0.3 * rng.randn(1, streamer.audio_chunk, 1)).astype(
            np.float32) for _ in range(2))
        for y, ref in ((host.call("decode", z), streamer.decode(state, z)[0]),
                       (host.call("forward", a, b, x0=z),
                        streamer.forward(state, a, b, 2, x0=z)[0])):
            err = float((y - ref).abs().max())
            assert err <= LIVE_TOL * float(ref.abs().max()), (i, err)
