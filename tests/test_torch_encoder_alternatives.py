"""The encoders' alternatives against the JAX package's, on the CPU:
Encoder1D's ``upscale_out`` and ``vae_regularisation`` (offline, in
training form and streaming), ECAPA's ``regularisation="vae"``,
``LinearEncoder`` and the codec's ``GRU``.

Parameters and BatchNorm statistics are drawn away from their init values
(tests/test_torch_encoders.py's ``_random_variables``) and carried over by
utils.from_jax; inputs come from a numpy seed.  A VAE's sample noise is the
JAX module's own normal draw from the key it is given, handed to the port
as its ``noise`` argument.  Without noise both packages refuse a VAE
encoder (C11; tests/test_torch_vae_refusal.py).

Tolerances: outputs rtol 1e-4 with atol 1e-5 and a VAE's KL rtol 1e-5
(f32 on both sides, a few small layers deep; ECAPA's sampled vectors reach
4 in size, where its f32 sums part by 1.7e-5); a stream
chunk's codes and caches atol 1e-5 (tests/test_torch_streaming.py's
module tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu.config import ECAPAConfig as JaxECAPAConfig
from after_tpu.config import Encoder1DConfig as JaxEncoder1DConfig
from after_tpu.models import ECAPAEncoder as JaxECAPA
from after_tpu.models import Encoder1D as JaxEncoder1D
from after_tpu.models import LinearEncoder as JaxLinearEncoder
from after_tpu.models.autoencoder import GRU as JaxGRU
from after_tpu_torch.config import ECAPAConfig, Encoder1DConfig
from after_tpu_torch.models import GRU, ECAPAEncoder, Encoder1D, LinearEncoder
from after_tpu_torch.ops.train_mode import TrainMode
from after_tpu_torch.utils.from_jax import load_module
from tests import torch_threads_common  # noqa: F401  (xdist workers' threads)
from tests.test_torch_encoders import _random_variables
from tests.test_torch_streaming import MODULE_TOL, _chunks, _stream_pair

ATOL, RTOL = 1e-5, 1e-4
KEY = jax.random.PRNGKey(7)
# the structure encoder's alternatives: two strided blocks, so that
# upscale_out runs prod(ratios) // 2 = 2 pairs of its transposed convs
UPSCALE = dict(in_size=8, channels=(8, 16, 12), ratios=(2, 2),
               upscale_out=True, dropout=0.0)
VAE = dict(UPSCALE, vae_regularisation=True, ac_regularisation=False)
VAE_FSQ = dict(in_size=8, channels=(8, 16, 4), vae_regularisation=True,
               ac_regularisation=False, quantizer_levels=(5, 5, 5, 5),
               dropout=0.0)


def _normal(shape):
    return np.array(jax.random.normal(KEY, shape))


def _encoder_pair(kw, streaming=False):
    x = np.random.RandomState(1).randn(2, 16, 8).astype(np.float32)
    init = jax.jit(JaxEncoder1D(JaxEncoder1DConfig(**kw)).init)(
        {"params": jax.random.PRNGKey(0), "sample": KEY}, jnp.asarray(x))
    variables = _random_variables(init, 2)
    enc = Encoder1D(Encoder1DConfig(**kw), streaming).eval()
    load_module(enc, variables, "encoder_time")
    return x, variables, enc


def _check(ours, theirs):
    z, mean, reg = ours
    jz, jmean, jreg = theirs
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jmean),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(reg), float(jreg), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["upscale", "vae", "vae_fsq"])
@pytest.mark.parametrize("training", [False, True])
def test_encoder1d_alternatives_match_jax(name, training):
    """Inference (running statistics) and training form (batch
    statistics, committed alike): the codes after the reparametrisation,
    FSQ and the upscaling chain, the mean and the regulariser."""
    kw = {"upscale": UPSCALE, "vae": VAE, "vae_fsq": VAE_FSQ}[name]
    x, variables, enc = _encoder_pair(kw)
    jenc = JaxEncoder1D(JaxEncoder1DConfig(**kw))
    vae = kw.get("vae_regularisation", False)

    def run(v, a):
        return jenc.apply(v, a, training=training,
                          rng=KEY if vae else None,
                          mutable=["batch_stats"] if training else False)
    out = jax.jit(run)(variables, jnp.asarray(x))
    theirs, stats = out if training else (out, None)
    noise = (torch.from_numpy(_normal(enc.vae_noise_shape(2, 16)))
             if vae else None)
    train = TrainMode(torch.Generator()) if training else None
    with torch.no_grad():
        ours = enc(torch.from_numpy(x), train=train, noise=noise)
    assert tuple(ours[0].shape) == np.shape(theirs[0])
    if name != "vae_fsq":
        # upscale_out returns to the input's frame rate at the codes' width
        assert tuple(ours[0].shape) == (2, 16, 12)
    _check(ours, theirs)
    if training:
        train.commit()
        committed = Encoder1D(enc.cfg).eval()
        load_module(committed, {"params": variables["params"],
                                "batch_stats": stats["batch_stats"]},
                    "encoder_time")
        for a, b in zip(enc.buffers(), committed.buffers()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_encoder1d_upscale_streams_like_jax():
    x, variables, enc = _encoder_pair(UPSCALE, streaming=True)
    jenc = JaxEncoder1D(JaxEncoder1DConfig(**UPSCALE), streaming=True)
    chunks = _chunks(3, (2, 4, 8))
    z = _stream_pair(jenc, variables, enc, chunks, MODULE_TOL,
                     jax_out=lambda y: y[0], port_out=lambda y: y[0])
    assert tuple(z.shape) == (2, 4 * len(chunks), 12)


def test_encoder1d_vae_streams_like_jax():
    """Each chunk samples from the same key in JAX (the key given to every
    call); the port takes that draw as each chunk's noise."""
    x, variables, enc = _encoder_pair(VAE, streaming=True)
    jenc = JaxEncoder1D(JaxEncoder1DConfig(**VAE), streaming=True)
    chunks = _chunks(4, (2, 4, 8))
    noise = torch.from_numpy(_normal(enc.vae_noise_shape(2, 4)))
    _stream_pair(jenc, variables, enc, chunks, MODULE_TOL,
                 method=lambda m, a: m(a, rng=KEY),
                 port_call=lambda a, c: enc(a, c, noise=noise),
                 jax_out=lambda y: y[0], port_out=lambda y: y[0])


@pytest.mark.parametrize("training", [False, True])
def test_ecapa_vae_matches_jax(training):
    kw = dict(in_size=8, out_dim=6, channels=(16, 16, 16, 32),
              res2net_scale=4, se_channels=8, attention_channels=8,
              regularisation="vae")
    x = np.random.RandomState(5).randn(2, 16, 8).astype(np.float32)
    jenc = JaxECAPA(JaxECAPAConfig(**kw))
    init = jax.jit(jenc.init)({"params": jax.random.PRNGKey(0),
                               "sample": KEY}, jnp.asarray(x))
    variables = _random_variables(init, 6)
    out = jax.jit(lambda v, a: jenc.apply(
        v, a, training=training, rng=KEY,
        mutable=["batch_stats"] if training else False))(
            variables, jnp.asarray(x))
    theirs = out[0] if training else out
    enc = ECAPAEncoder(ECAPAConfig(**kw)).eval()
    load_module(enc, variables, "encoder")
    assert enc.fc.out_features == 12
    with torch.no_grad():
        ours = enc(torch.from_numpy(x),
                   train=TrainMode(torch.Generator()) if training else None,
                   noise=torch.from_numpy(_normal((2, 6))))
    _check(ours, theirs)


@pytest.mark.parametrize("reg", ["none", "ac", "vae"])
def test_linear_encoder_matches_jax(reg):
    kw = dict(in_size=12, channels=(16, 24, 8, 4), drop_out=0.0,
              use_tanh=reg == "ac", regularisation=reg)
    x = np.random.RandomState(8).randn(3, 12).astype(np.float32)
    jenc = JaxLinearEncoder(**kw)
    init = jax.jit(jenc.init)({"params": jax.random.PRNGKey(0),
                               "sample": KEY}, jnp.asarray(x))
    variables = {"params": _random_variables(
        {"params": init["params"], "batch_stats": {}}, 9)["params"]}
    theirs = jax.jit(lambda v, a: jenc.apply(v, a, rngs={"sample": KEY}))(
        variables, jnp.asarray(x))
    enc = LinearEncoder(**kw)
    load_module(enc, variables, "linear")
    noise = None
    if reg == "vae":
        # the JAX module draws from make_rng("sample"), a key of its own
        # derived from the "sample" stream: take its draw by the shape
        noise = torch.from_numpy(np.array(jax.jit(lambda: jenc.apply(
            variables, jnp.asarray(x), rngs={"sample": KEY},
            method=lambda m, a: jax.random.normal(m.make_rng("sample"),
                                                  (3, 4))))()))
    with torch.no_grad():
        ours = enc(torch.from_numpy(x), noise=noise)
    _check(ours, theirs)
    if reg == "vae":
        with pytest.raises(ValueError, match="vae regularisation"):
            enc(torch.from_numpy(x))


def test_gru_matches_jax():
    """Three flax GRUCells (biases on ir, iz, in and hn only) over the
    frames and the centered conv out, from zeros and from a given carry."""
    x = np.random.RandomState(10).randn(2, 6, 8).astype(np.float32)
    jgru = JaxGRU(5, hidden_size=16, num_layers=3)
    # the JAX GRU's cells run inside a plain lax.scan, where its init
    # makes the cells' parameters as tracers of the scan: draw them over
    # its shapes instead
    shapes = jax.eval_shape(jgru.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    assert set(shapes["gru_0"]) == {"ir", "iz", "in", "hr", "hz", "hn"}
    assert "bias" not in shapes["gru_0"]["hr"]
    rng = np.random.RandomState(11)

    def draw(path, s):
        shape = tuple(s.shape)
        if path[-1].key == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif path[-1].key == "g":
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = 0.1 * rng.randn(*shape)
        return v.astype(np.float32)
    variables = {"params": jax.tree_util.tree_map_with_path(draw, shapes)}
    gru = GRU(8, 5, hidden_size=16, num_layers=3)
    load_module(gru, variables, "gru")
    apply = jax.jit(lambda v, a, c: jgru.apply(v, a, c))
    carry = None
    for _ in range(2):
        y, jcarry = apply(variables, jnp.asarray(x), carry)
        with torch.no_grad():
            py, pcarry = gru(torch.from_numpy(x), None if carry is None else
                             [torch.from_numpy(np.array(c)) for c in carry])
        np.testing.assert_allclose(py.numpy(), np.asarray(y), atol=ATOL)
        for a, b in zip(pcarry, jcarry):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
        carry = jcarry
