"""The port's streaming modules against the JAX package's, on the CPU.

Each streaming module of the port runs chunk by chunk beside its JAX
counterpart (flax ``apply(..., mutable=["cache"])``) on shared weights and
inputs made with numpy from a seed, and the outputs and the caches are
compared after every chunk.  Sizes are the micro configs of the JAX
package's streaming and diffusion tests: a 4-band codec with 8 base
channels and two stages, a 2-layer denoiser of width 64.
Tolerance: atol 1e-5 for a single module, atol 1e-4 and rtol 1e-4 for the
codec and the sampler (f32 on both sides, summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu.config import AutoEncoderConfig as JaxAEConfig
from after_tpu.config import Encoder1DConfig as JaxEncoder1DConfig
from after_tpu.config import get_config as jax_get_config
from after_tpu.config import to_json
from after_tpu.diffusion.rectified_flow import RectifiedFlow as JaxRF
from after_tpu.models import AudioCodec as JaxCodec
from after_tpu.models import Denoiser as JaxDenoiser
from after_tpu.models import Encoder1D as JaxEncoder1D
from after_tpu.models.autoencoder import StreamGroupNorm as JaxGroupNorm
from after_tpu.ops.conv import StreamConv1d as JaxConv
from after_tpu.ops.conv import StreamConvTranspose1d as JaxConvT
from after_tpu.ops.pqmf import PQMFAnalysis as JaxPQMFA
from after_tpu.ops.pqmf import PQMFSynthesis as JaxPQMFS
from after_tpu.streaming import init_stream_state
from after_tpu.streaming.crossfade import CrossfadeDecoder as JaxCrossfade
from after_tpu_torch.config import AutoEncoderConfig, Encoder1DConfig
from after_tpu_torch.config import from_json
from after_tpu_torch.diffusion.rectified_flow import RectifiedFlow
from after_tpu_torch.models.autoencoder import AudioCodec, StreamGroupNorm
from after_tpu_torch.models.encoder import Encoder1D
from after_tpu_torch.ops.conv import StreamConv1d, StreamConvTranspose1d
from after_tpu_torch.ops.pqmf import PQMFAnalysis, PQMFSynthesis
from after_tpu_torch.streaming.crossfade import CrossfadeDecoder
from after_tpu_torch.streaming.state import flatten_state, init_cache
from after_tpu_torch.utils.from_jax import load_denoiser, load_module

MODULE_TOL = dict(atol=1e-5)
CODEC_TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(pqmf_bands=4, z_channels=8, base_channels=8, multipliers=(1, 2, 2),
            factors=(2, 2), dilations=(1, 3), num_blocks_per_stage=1)
N_CHUNKS = 8


def _perturbed(variables, seed):
    """Parameters drawn away from their init values; BatchNorm variances in
    [0.5, 1.5]."""
    rng = np.random.RandomState(seed)

    def f(path, v):
        v = np.asarray(v, dtype=np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return (v * (1 + 0.2 * rng.uniform(-1, 1, v.shape))
                + 0.02 * rng.randn(*v.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, variables)


def _check_cache(ours, theirs, tol):
    a, b = flatten_state(ours), flatten_state(theirs)
    assert a.keys() == b.keys()
    for k in a:
        assert tuple(a[k].shape) == np.shape(b[k]), k
        np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), **tol,
                                   err_msg=k)


def _stream_pair(jmod, variables, mod, chunks, tol, *, method=None,
                 port_call=None, jax_out=lambda y: y, port_out=lambda y: y):
    """Run both modules over ``chunks``; compare every output and cache."""
    port_call = port_call or (lambda x, c: mod(x, c))
    jcache = init_stream_state(jmod, jnp.asarray(chunks[0]), method=method)
    step = jax.jit(lambda v, c, x: jmod.apply(
        {**v, "cache": c}, x, method=method, mutable=["cache"]))
    cache = init_cache(lambda c: port_call(torch.from_numpy(chunks[0]), c))
    _check_cache(cache, jcache, tol)
    ys = []
    for x in chunks:
        y, aux = step(variables, jcache, jnp.asarray(x))
        jcache = aux["cache"]
        with torch.no_grad():
            py = port_call(torch.from_numpy(x), cache)
        y, py = jax_out(y), port_out(py)
        assert tuple(py.shape) == y.shape
        np.testing.assert_allclose(py.numpy(), np.asarray(y), **tol)
        _check_cache(cache, jcache, tol)
        ys.append(py)
    return torch.cat(ys, dim=1)


def _chunks(seed, shape, n=N_CHUNKS, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(scale * rng.randn(*shape)).astype(np.float32) for _ in range(n)]


# -- (a) convs -----------------------------------------------------------


@pytest.mark.parametrize("k,stride,dilation,mode", [
    (3, 1, 1, "causal"), (3, 1, 3, "centered"), (4, 2, 1, "causal"),
    (3, 1, 9, "causal"), (1, 1, 1, "causal"), (5, 1, 1, "centered")])
def test_stream_conv(k, stride, dilation, mode):
    chunks = _chunks(k + dilation, (2, 8, 6))
    jmod = JaxConv(5, k, stride=stride, dilation=dilation, mode=mode,
                   streaming=True)
    variables = _perturbed(jmod.init(jax.random.PRNGKey(k),
                                     jnp.asarray(chunks[0])), seed=k)
    variables = {"params": variables["params"]}
    mod = StreamConv1d(6, 5, k, stride=stride, dilation=dilation, mode=mode,
                       streaming=True)
    load_module(mod, variables, "conv")
    y = _stream_pair(jmod, variables, mod, chunks, MODULE_TOL)
    # the streamed conv is the offline causal conv over the whole signal,
    # delayed by its right pad
    offline = StreamConv1d(6, 5, k, stride=stride, dilation=dilation,
                           mode="causal")
    load_module(offline, variables, "conv")
    with torch.no_grad():
        y_off = offline(torch.from_numpy(np.concatenate(chunks, axis=1)))
    np.testing.assert_allclose(y.numpy(), y_off.numpy(), **MODULE_TOL)


@pytest.mark.parametrize("factor", [2, 4])
def test_stream_conv_transpose(factor):
    chunks = _chunks(factor, (2, 4, 6))
    jmod = JaxConvT(5, 2 * factor, factor, streaming=True)
    variables = _perturbed(jmod.init(jax.random.PRNGKey(factor),
                                     jnp.asarray(chunks[0])), seed=factor)
    variables = {"params": variables["params"]}
    mod = StreamConvTranspose1d(6, 5, 2 * factor, factor, streaming=True)
    load_module(mod, variables, "up")
    y = _stream_pair(jmod, variables, mod, chunks, MODULE_TOL)
    # the streamed output is the offline centered output, delayed by
    # factor // 2 frames
    offline = StreamConvTranspose1d(6, 5, 2 * factor, factor)
    load_module(offline, variables, "up")
    with torch.no_grad():
        y_off = offline(torch.from_numpy(np.concatenate(chunks, axis=1)))
    lag = factor // 2
    np.testing.assert_allclose(y[:, lag:].numpy(), y_off[:, :-lag].numpy(),
                               **MODULE_TOL)


# -- (b) PQMF --------------------------------------------------------------


def test_stream_pqmf_analysis():
    chunks = _chunks(5, (2, 64, 1), scale=0.3)
    jmod = JaxPQMFA(100, 4, causal=True, streaming=True)
    mod = PQMFAnalysis(100, 4, causal=True, streaming=True)
    y = _stream_pair(jmod, {}, mod, chunks, MODULE_TOL)
    with torch.no_grad():
        y_off = PQMFAnalysis(100, 4, causal=True)(
            torch.from_numpy(np.concatenate(chunks, axis=1)))
    np.testing.assert_allclose(y.numpy(), y_off.numpy(), **MODULE_TOL)


@pytest.mark.parametrize("parity", [0, 1])
def test_stream_pqmf_synthesis(parity):
    chunks = _chunks(6 + parity, (2, 16, 4))
    jmod = JaxPQMFS(100, 4, causal=True, streaming=True, parity=parity)
    mod = PQMFSynthesis(100, 4, causal=True, streaming=True, parity=parity)
    _stream_pair(jmod, {}, mod, chunks, MODULE_TOL)


def test_stream_pqmf_refuses_odd_chunks():
    mod = PQMFAnalysis(100, 4, causal=True, streaming=True)
    with pytest.raises(ValueError, match="even"):
        mod(torch.zeros(1, 12, 1), {})


# -- (c) GroupNorm with its pad ------------------------------------------


def test_stream_group_norm():
    chunks = _chunks(7, (2, 6, 16))
    jmod = JaxGroupNorm(4, streaming=True)
    variables = _perturbed(jmod.init(jax.random.PRNGKey(0),
                                     jnp.asarray(chunks[0])), seed=7)
    variables = {"params": variables["params"]}
    mod = StreamGroupNorm(16, 4, streaming=True)
    load_module(mod, variables, "gn")
    _stream_pair(jmod, variables, mod, chunks, MODULE_TOL)


# -- (d) the causal codec ------------------------------------------------


def _codec_variables(**kw):
    jcodec = JaxCodec(JaxAEConfig(**TINY, **kw, fused_kernels=False))
    return _perturbed(jax.jit(jcodec.init)(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 1024, 1))), 1)


@pytest.fixture(scope="module")
def causal_codec():
    kw = dict(causal=True, use_norm=False)
    cfg = AutoEncoderConfig(**TINY, **kw)
    variables = _codec_variables(**kw)
    jcodec = JaxCodec(JaxAEConfig(**TINY, **kw), streaming=True)
    offline = AudioCodec(cfg).eval()
    load_module(offline, variables, "codec")
    codec = AudioCodec(cfg, streaming=True).eval()
    load_module(codec, variables, "codec")
    return cfg, jcodec, variables, offline, codec


def test_causal_codec_encode_stream(causal_codec):
    cfg, jcodec, variables, offline, codec = causal_codec
    chunks = _chunks(8, (2, cfg.ratio * 4, 1), scale=0.3)
    z = _stream_pair(jcodec, {"params": variables["params"]}, codec, chunks,
                     CODEC_TOL, method=JaxCodec.encode,
                     port_call=lambda x, c: codec.encode(x, c))
    # stream == offline inside the port
    with torch.no_grad():
        z_off = offline.encode(torch.from_numpy(np.concatenate(chunks, 1)))
    np.testing.assert_allclose(z.numpy(), z_off.numpy(), **CODEC_TOL)


def test_causal_codec_decode_stream(causal_codec):
    from after_tpu_torch.models.autoencoder import decoder_band_delay
    cfg, jcodec, variables, offline, codec = causal_codec
    chunks = _chunks(9, (2, 4, cfg.z_channels))
    y = _stream_pair(jcodec, {"params": variables["params"]}, codec, chunks,
                     CODEC_TOL, method=JaxCodec.decode,
                     port_call=lambda x, c: codec.decode(x, c))
    # stream == offline inside the port, at the transposed convs' lag and
    # past the warm-up transient
    with torch.no_grad():
        y_off = offline.decode(torch.from_numpy(np.concatenate(chunks, 1)))
    lag = decoder_band_delay(cfg) * cfg.pqmf_bands
    skip = 8 * cfg.ratio
    a = y_off[:, skip:y.shape[1] - lag]
    b = y[:, skip + lag:]
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4)


# -- (e) the structure encoder -------------------------------------------


def test_stream_encoder1d():
    cfg = dict(in_size=8, channels=(8, 16, 12), kernel_size=5)
    chunks = _chunks(10, (2, 4, 8))
    jmod = JaxEncoder1D(JaxEncoder1DConfig(**cfg), streaming=True)
    v = jax.jit(JaxEncoder1D(JaxEncoder1DConfig(**cfg)).init)(
        jax.random.PRNGKey(0), jnp.asarray(chunks[0]))
    variables = _perturbed(v, seed=10)
    mod = Encoder1D(Encoder1DConfig(**cfg), streaming=True).eval()
    load_module(mod, variables, "encoder_time")
    z = _stream_pair(jmod, variables, mod, chunks, MODULE_TOL,
                     jax_out=lambda y: y[0], port_out=lambda y: y[0])
    offline = Encoder1D(Encoder1DConfig(**cfg)).eval()
    load_module(offline, variables, "encoder_time")
    with torch.no_grad():
        z_off = offline(torch.from_numpy(np.concatenate(chunks, 1)))[0]
    np.testing.assert_allclose(z.numpy(), z_off.numpy(), **MODULE_TOL)


# -- (f) the streaming denoiser and sampler ------------------------------


def test_sample_stream_with_changing_steps():
    """Six buffers with nb_steps 1, 3, 2, 4, 1, 20 (clipped to 16) and
    guidances given as a float and as a 0-d tensor: the sampled chunks, the
    KV caches and the ``filled`` counters after every buffer."""
    T, C, ZT, ZS, B = 4, 8, 6, 4, 2
    cfg = jax_get_config("base", **{
        "denoiser.embed_dim": 64, "denoiser.n_layers": 2,
        "denoiser.head_dim": 32, "denoiser.rotary_dim": 16,
        "zs_channels": ZS}).resolved(in_size=C, n_signal=16)
    jnet = JaxDenoiser(cfg.denoiser, streaming=True)
    rng = np.random.RandomState(11)
    zeros = (jnp.zeros((3 * B, T, C)), jnp.zeros((3 * B,)),
             jnp.zeros((3 * B, ZT)), jnp.zeros((3 * B, T, ZS)))
    init = jax.jit(jnet.init)(jax.random.PRNGKey(3), *zeros)
    params = _perturbed({"params": init["params"]}, seed=11)
    jcache = jax.tree_util.tree_map(jnp.zeros_like, init["cache"])
    jrf = JaxRF(cfg)

    rf = RectifiedFlow(from_json(to_json(cfg)), streaming=True).eval()
    load_denoiser(rf.net, params)
    cache = init_cache(lambda c: rf.net(
        *(torch.from_numpy(np.array(a)) for a in zeros), cache=c))
    _check_cache(cache, jcache, MODULE_TOL)
    cond = rng.randn(B, ZT).astype(np.float32)
    for i, nb in enumerate([1, 3, 2, 4, 1, 20]):
        x0 = rng.randn(B, T, C).astype(np.float32)
        tc = rng.randn(B, T, ZS).astype(np.float32)
        y, jcache = jrf.sample_stream(params, jcache, jnp.asarray(x0),
                                      jnp.asarray(cond), jnp.asarray(tc), nb,
                                      2.0, 1.5)
        with torch.no_grad():
            py = rf.sample_stream(cache, torch.from_numpy(x0),
                                  torch.from_numpy(cond), torch.from_numpy(tc),
                                  torch.tensor(nb) if i % 2 else nb,
                                  2.0, torch.tensor(1.5))
        np.testing.assert_allclose(py.numpy(), np.asarray(y), **CODEC_TOL)
        _check_cache(cache, jcache, CODEC_TOL)
    filled = cache["block_0/attn/filled"]
    assert filled.dtype == torch.int32
    assert filled.tolist() == [8] * 4 + [4] * 12


# -- (g) the crossfade path of the base codec ----------------------------


@pytest.fixture(scope="module")
def crossfade():
    cfg = AutoEncoderConfig(**TINY)
    variables = _codec_variables()
    jdec = JaxCrossfade(JaxAEConfig(**TINY), n_fade=4, chunk_size=4)
    dec = CrossfadeDecoder(cfg, n_fade=4, chunk_size=4)
    load_module(dec.codec, variables, "codec")
    return cfg, jdec, {"params": variables["params"]}, dec


def test_crossfade_encode_and_decode(crossfade):
    cfg, jdec, variables, dec = crossfade
    B, A = 2, 4 * cfg.ratio
    jenc, jst = jdec.init_encode_state(variables, B), \
        jdec.init_state(variables, B)
    enc, st = dec.init_encode_state(B), dec.init_state(B)
    _check_cache(enc, jenc, CODEC_TOL)
    _check_cache(st, jst, CODEC_TOL)
    rng = np.random.RandomState(12)
    for _ in range(6):
        x = (0.3 * rng.randn(B, A, 1)).astype(np.float32)
        z, jenc = jdec.encode(variables, jenc, jnp.asarray(x))
        y, jst = jdec.decode(variables, jst, z)
        with torch.no_grad():
            pz = dec.encode(enc, torch.from_numpy(x))
            py = dec.decode(st, torch.from_numpy(np.asarray(z)))
        assert tuple(pz.shape) == z.shape == (B, 4, cfg.z_channels)
        np.testing.assert_allclose(pz.numpy(), np.asarray(z), **CODEC_TOL)
        assert tuple(py.shape) == y.shape == (B, A, 1)
        np.testing.assert_allclose(py.numpy(), np.asarray(y), **CODEC_TOL)
        _check_cache(enc, jenc, CODEC_TOL)
        _check_cache(st, jst, CODEC_TOL)


# -- (j) the kernel's inputs on the streaming path -----------------------


def test_crossfade_hands_the_kernel_contiguous_rows(monkeypatch, crossfade):
    """At batch 2 a streaming GroupNorm returns a slice of its window; every
    ConvBlock1d of the crossfade path must still hand the fused op
    contiguous f32 (B, T, C) rows and its weight in the kernel's layout
    (checked on the CPU, where the op does not check them)."""
    import after_tpu_torch.models.autoencoder as ae
    from after_tpu_torch.ops.kernels.fused_conv import (snake_conv_reference,
                                                        torch_weight)

    cfg, _, _, dec = crossfade
    calls, kept = [], {}

    def checked(x, alpha, beta, w_k, w_lo, b, dilation, mode):
        for t in (x, alpha, beta, b):
            assert t.is_contiguous() and t.dtype == torch.float32
        # its conv's kept pair, the same tensors at every call: no copy
        pair = kept.get(id(w_k), (None, None))
        assert pair[0] is w_k and pair[1] is w_lo
        assert w_k.dtype == torch.float32 and w_k.is_contiguous()
        assert w_lo.shape == w_k.shape and w_lo.is_contiguous()
        calls.append(tuple(x.shape))
        return snake_conv_reference(
            x, alpha, beta, torch_weight(w_k, x.shape[2]), b, dilation, mode)

    B, A = 2, 4 * cfg.ratio
    enc, st = dec.init_encode_state(B), dec.init_state(B)
    monkeypatch.setattr(ae, "snake_conv", checked)
    x = torch.from_numpy(
        (0.3 * np.random.RandomState(13).randn(B, A, 1)).astype(np.float32))
    with torch.no_grad():
        for m in dec.codec.modules():
            if isinstance(m, ae.ConvBlock1d) and not m.cached:
                w_k, w_lo = m.conv.kernel_weights()
                kept[id(w_k)] = (w_k, w_lo)
        dec.decode(st, dec.encode(enc, x))
    # 3 resnets per direction, 2 conv blocks each; every window at batch 2
    assert len(calls) == 12 and all(s[0] == B for s in calls)
