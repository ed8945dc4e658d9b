"""The new modules under bf16 training parameters compute at the types the
JAX modules compute at (``utils.precision.cast_call``, the trainers'
``compute_dtype="bfloat16"``): every output's dtype against the JAX
module's with its parameters cast to bf16 (``jax.eval_shape``: nothing is
compiled), and the port's bf16 values finite and near its f32 ones.

- the descript discriminator takes the real waveform in bf16 and the
  generated one as the codec gives it (f32): MPD and MSD over the real one
  run bf16 convs, MRD's spectrogram is f32, the losses f32;
- the decoder's NoiseGenerator: its convs at the decoder's type, its noise
  f32, so a bf16 decoder's output is f32 (and with the bottleneck's f32
  noise the whole decoder is, as in the trainer);
- the VAE encoders: mean, scale and the KL at the type of the encoder's
  last layer, the sample (the mean plus the f32 noise) f32.  Encoder1D's
  last layer is bf16 in both packages; ECAPA's is f32 in the port, bf16
  in JAX (its pooling's weakly-typed global context: ROADMAP C12, open),
  so for ECAPA the sample's type is held to JAX's and the mean and the KL
  are f32 with the port's timbre vector.

Tolerance of the port's bf16 values against its own f32 run in the type
tests: within 0.1 x max |f32| (a few bf16 layers deep).

The value tests hold the port's bf16 outputs to the JAX modules run with
bf16 parameters on the same inputs and weights (the descript
discriminator's sub-discriminators and, over DRAWS weight draws, its
losses and metrics; a noise decoder from bf16 and from f32 codes; both
VAE encoders from bf16 features with the same normal draw), by the bf16
rule of tests/torch_bf16_train_common.py (``bf16_close``: the port's
bf16 result within 2x the JAX bf16 result's distance from the JAX f32
one, plus 1e-6 of its scale; a number a draw, such as a loss, with
METRIC_FACTOR).  The JAX bf16 values come from a process of its own in
which XLA rounds every bf16 value (--xla_allow_excess_precision=false),
as the bf16 training tests run theirs.  ECAPA's mean and KL are compared
by value only: their types part (C12, above).
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu.config import AutoEncoderConfig as JaxAEConfig
from after_tpu.config import ECAPAConfig as JaxECAPAConfig
from after_tpu.config import Encoder1DConfig as JaxEncoder1DConfig
from after_tpu.models import ECAPAEncoder as JaxECAPA
from after_tpu.models import Encoder1D as JaxEncoder1D
from after_tpu.models.autoencoder import CodecDecoder as JaxDecoder
from after_tpu.models import descript_discriminator as jdd
from after_tpu.models.descript_discriminator import \
    DescriptDiscriminator as JaxDescript
from after_tpu_torch.config import (AutoEncoderConfig, ECAPAConfig,
                                    Encoder1DConfig)
from after_tpu_torch.models import ECAPAEncoder, Encoder1D
from after_tpu_torch.models.autoencoder import CodecDecoder
from after_tpu_torch.models.descript_discriminator import \
    DescriptDiscriminator
from after_tpu_torch.utils.from_jax import load_discriminator, load_module
from after_tpu_torch.utils.init import init_weights
from after_tpu_torch.utils.precision import cast_call
from tests import torch_threads_common  # noqa: F401  (xdist workers' threads)
from tests.test_torch_descript_discriminator import \
    _random_variables as _descript_variables
from tests.test_torch_encoders import _random_variables as _encoder_variables
from tests.test_torch_streaming import TINY, _perturbed
from tests.torch_bf16_train_common import METRIC_FACTOR, bf16_close

BF16 = torch.bfloat16
KEY = jax.random.PRNGKey(0)
TOL = 0.1


def _jax_dtypes(module, *args, method=None, rngs=None, **kwargs):
    """The dtypes of ``module``'s outputs with bf16 parameters (its
    statistics f32, as the JAX trainers cast the params alone)."""
    def run(*a):
        variables = module.init({"params": KEY, "sample": KEY}, *a,
                                method=method, **kwargs)
        variables = {**variables, "params": jax.tree_util.tree_map(
            lambda v: v.astype(jnp.bfloat16), variables["params"])}
        return module.apply(variables, *a, method=method, rngs=rngs,
                            **kwargs)
    out = jax.eval_shape(run, *args)
    return [str(o.dtype) for o in jax.tree_util.tree_leaves(out)]


def _port_dtypes(out):
    return [str(t.dtype).replace("torch.", "")
            for t in jax.tree_util.tree_leaves(
                out, is_leaf=lambda t: isinstance(t, torch.Tensor))
            if isinstance(t, torch.Tensor)]


def _near(bf, f32):
    for a, b in zip(bf, f32):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= TOL * b.abs().max() + 1e-6


def test_descript_discriminator_types():
    # MSD at rate 1: the JAX MSD's Kaiser decimation (rate 2) runs
    # lax.conv on a bf16 signal and its f32 filter, which raises there
    kw = dict(periods=(3,), rates=(1,), fft_sizes=(64,))
    rng = np.random.RandomState(0)
    x = (0.1 * rng.randn(1, 1024, 1)).astype(np.float32)
    y = (0.1 * rng.randn(1, 1024, 1)).astype(np.float32)
    theirs = _jax_dtypes(JaxDescript(**kw), jnp.asarray(x, jnp.bfloat16),
                         jnp.asarray(y))
    disc = DescriptDiscriminator(**kw)
    init_weights(disc, 0)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        out = cast_call(disc, BF16, xt.to(BF16), yt)
        ref = disc(xt, yt)
    assert _port_dtypes(out) == theirs
    # the MPD over the real waveform in bf16, MRD's spectrogram in f32
    mpd = cast_call(disc.mpd_3, BF16, xt.to(BF16))
    mrd = cast_call(disc.mrd_64, BF16, xt.to(BF16))
    assert {f.dtype for f in mpd} == {BF16}
    assert {f.dtype for f in mrd} == {torch.float32}
    _near([out[0], out[1]], [ref[0], ref[1]])


def test_noise_decoder_types():
    cfg = AutoEncoderConfig(**TINY, use_noise=True)
    z = np.random.RandomState(1).randn(1, 8, 8).astype(np.float32)
    dec = CodecDecoder(cfg)
    init_weights(dec, 1)
    zt = torch.from_numpy(z)
    for zin in (jnp.asarray(z, jnp.bfloat16), jnp.asarray(z)):
        theirs = _jax_dtypes(JaxDecoder(JaxAEConfig(
            **TINY, use_noise=True, fused_kernels=False)), zin)
        ztin = zt.to(BF16) if zin.dtype == jnp.bfloat16 else zt
        with torch.no_grad():
            out = cast_call(dec, BF16, ztin)
        assert _port_dtypes(out) == theirs == ["float32"]
    with torch.no_grad():
        _near([cast_call(dec, BF16, zt)], [dec(zt)])


def test_vae_encoder_types():
    x = np.random.RandomState(2).randn(2, 16, 8).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x)
    ekw = dict(in_size=8, channels=(8, 16, 12), ratios=(2, 2),
               upscale_out=True, vae_regularisation=True,
               ac_regularisation=False, dropout=0.0)
    ckw = dict(in_size=8, out_dim=6, channels=(16, 16, 16, 32),
               res2net_scale=4, se_channels=8, attention_channels=8,
               regularisation="vae")
    for jmod, mod, shape in (
            (JaxEncoder1D(JaxEncoder1DConfig(**ekw)),
             Encoder1D(Encoder1DConfig(**ekw)).eval(), (2, 4, 48)),
            (JaxECAPA(JaxECAPAConfig(**ckw)),
             ECAPAEncoder(ECAPAConfig(**ckw)).eval(), (2, 6))):
        theirs = _jax_dtypes(jmod, xj, rng=KEY)
        init_weights(mod, 3)
        noise = torch.randn(shape, generator=torch.Generator().manual_seed(4))
        with torch.no_grad():
            out = cast_call(mod, BF16, xt.to(BF16), noise=noise)
            ref = mod(xt, noise=noise)
        if isinstance(mod, ECAPAEncoder):
            assert _port_dtypes(out)[0] == theirs[0] == "float32"
            # the port's timbre vector is f32 (C12), its mean and KL too
            assert out[1].dtype == out[2].dtype == torch.float32
        else:
            assert _port_dtypes(out) == theirs
        _near(out[:2], ref[:2])


# the value cases: real/generated signals and weights of the descript
# discriminator over DRAWS draws, a noise decoder's codes, the VAE
# encoders' features
DRAWS = 3
DESCRIPT = dict(periods=(3,), rates=(1,), fft_sizes=(64,))
EKW = dict(in_size=8, channels=(8, 16, 12), ratios=(2, 2), upscale_out=True,
           vae_regularisation=True, ac_regularisation=False, dropout=0.0)
CKW = dict(in_size=8, out_dim=6, channels=(16, 16, 16, 32), res2net_scale=4,
           se_channels=8, attention_channels=8, regularisation="vae")
NOISE_CFG = dict(**TINY, use_noise=True)


def _signals(draw):
    rng = np.random.RandomState(5 + draw)
    x = (0.1 * rng.randn(2, 2048, 1)).astype(np.float32)
    y = (0.1 * rng.randn(2, 2048, 1) + 0.02).astype(np.float32)
    return x, y


def _descript(draw):
    x, y = _signals(draw)
    return x, y, _descript_variables(JaxDescript(**DESCRIPT), 6 + draw, x, y)


def _decoder():
    z = np.random.RandomState(7).randn(2, 8, 8).astype(np.float32)
    jdec = JaxDecoder(JaxAEConfig(**NOISE_CFG, fused_kernels=False))
    return z, jdec, _perturbed(jax.jit(jdec.init)(KEY, jnp.asarray(z)), 8)


def _encoders():
    x = np.random.RandomState(9).randn(2, 16, 8).astype(np.float32)
    out = []
    for name, jmod in (
            ("encoder_time", JaxEncoder1D(JaxEncoder1DConfig(**EKW))),
            ("encoder", JaxECAPA(JaxECAPAConfig(**CKW)))):
        init = jax.jit(jmod.init)({"params": jax.random.PRNGKey(0),
                                   "sample": KEY}, jnp.asarray(x))
        out.append((name, jmod, _encoder_variables(init, 10)))
    return x, out


def _jax_at(module, variables, dtype, *args, **kwargs):
    """``module``'s outputs as numpy leaves, with its parameters cast to
    ``dtype`` (its statistics kept f32, as the JAX trainers cast the
    params alone) and its inputs given at their types."""
    if dtype is not None:
        variables = {**variables, "params": jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, dtype), variables["params"])}
    out = jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(
        variables, *args)
    return [np.asarray(o, np.float32) for o in jax.tree_util.tree_leaves(out)]


def jax_values(dtype):
    """{case: the JAX outputs} with parameters at ``dtype`` (None: f32)."""
    low = jnp.bfloat16 if dtype == "bf16" else None
    real = low or jnp.float32
    out = {}
    x, y, variables = _descript(0)
    for name in ("mpd_3", "msd_1", "mrd_64"):
        jmod = getattr(jdd, name.split("_")[0].upper())(int(name[4:]))
        out[name] = [f.transpose((0, 3, 1, 2) if f.ndim == 4 else (0, 2, 1))
                     for f in _jax_at(jmod, {"params": variables["params"][
                         name]}, low, jnp.asarray(x, real))]
    for draw in range(DRAWS):
        x, y, variables = _descript(draw)
        out["descript", draw] = _jax_at(
            JaxDescript(**DESCRIPT), variables, low, jnp.asarray(x, real),
            jnp.asarray(y))
    z, jdec, variables = _decoder()
    for codes in ("bf16", "f32"):
        out["decoder", codes] = _jax_at(jdec, variables, low, jnp.asarray(
            z, real if codes == "bf16" else jnp.float32))
    x, encoders = _encoders()
    for name, jmod, variables in encoders:
        out[name] = _jax_at(jmod, variables, low, jnp.asarray(x, real),
                            rng=KEY)
    return out


@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    """{case: (JAX bf16 outputs, JAX f32 outputs)}: the f32 ones from this
    process, the bf16 ones at the same time from a process of its own in
    which XLA rounds every bf16 value (--xla_allow_excess_precision=false,
    as tests/torch_bf16_train_common.py runs the JAX bf16 steps)."""
    path = str(tmp_path_factory.mktemp("alternatives_bf16") / "jax.pkl")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             path], cwd=root, env=env)
    try:
        f32 = jax_values(None)
    finally:
        assert proc.wait() == 0
    with open(path, "rb") as f:
        bf16 = pickle.load(f)
    return {k: (bf16[k], v) for k, v in f32.items()}


def _hold(label, port16, jax16, jax32, factor=2.0):
    """Each output by the bf16 rule; one number a draw (a loss, a metric,
    a KL) by the rule with METRIC_FACTOR, as the training tests hold
    their metrics."""
    for i, (p, j16, j32) in enumerate(zip(port16, jax16, jax32)):
        p = np.asarray(p, np.float32)
        assert p.shape == j32.shape, (label, i, p.shape, j32.shape)
        bf16_close(f"{label} {i}", p, j16, j32,
                   METRIC_FACTOR if p.size <= DRAWS else factor)


def _leaves(out):
    return [t.detach().float().numpy() for t in jax.tree_util.tree_leaves(
        out, is_leaf=lambda t: isinstance(t, torch.Tensor))]


def test_descript_discriminator_matches_jax_bf16(jax_pair):
    """Each sub-discriminator's feature maps over a bf16 real waveform,
    and the whole discriminator's losses and metrics (the real waveform
    bf16, the generated one f32) over DRAWS draws taken as one tensor a
    metric; JAX's parameters and the port's cast to bf16 from the same f32
    draw."""
    ours = {}
    for draw in range(DRAWS):
        x, y, variables = _descript(draw)
        disc = DescriptDiscriminator(**DESCRIPT)
        load_discriminator(disc, variables)
        xt = torch.from_numpy(x).to(BF16)
        with torch.no_grad():
            if draw == 0:
                for name in ("mpd_3", "msd_1", "mrd_64"):
                    _hold(name, _leaves(cast_call(getattr(disc, name), BF16,
                                                  xt)), *jax_pair[name])
            ours[draw] = _leaves(cast_call(disc, BF16, xt,
                                           torch.from_numpy(y)))
    def stacked(runs):
        return [np.stack(v) for v in zip(*runs)]
    _hold("descript", stacked(ours[d] for d in range(DRAWS)),
          *(stacked(jax_pair["descript", d][j] for d in range(DRAWS))
            for j in (0, 1)))


def test_noise_decoder_matches_jax_bf16(jax_pair):
    """A noise decoder's output from bf16 codes and from f32 ones (the
    trainer's case: the bottleneck's f32 noise), with the uniform draw the
    JAX decoder takes without a noise rng (PRNGKey(0))."""
    z, _, variables = _decoder()
    cfg = AutoEncoderConfig(**NOISE_CFG)
    dec = CodecDecoder(cfg)
    load_module(dec, variables, "decoder")
    noise = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(0), dec.noise.noise_shape(
            2, 8 * int(np.prod(cfg.factors))), minval=-1.0, maxval=1.0)))
    zt = torch.from_numpy(z)
    for codes in ("bf16", "f32"):
        with torch.no_grad():
            ours = cast_call(dec, BF16, zt.to(BF16) if codes == "bf16"
                             else zt, noise=noise)
        _hold(f"noise decoder from {codes} codes", _leaves(ours),
              *jax_pair["decoder", codes])


def test_vae_encoders_match_jax_bf16(jax_pair):
    """Encoder1D with the VAE and upscale_out, and ECAPA's VAE, from bf16
    features: the sample, the mean and the KL, with the JAX module's own
    normal draw as the noise.  ECAPA's mean and KL are f32 in the port
    and bf16 in JAX (C12, open; test_vae_encoder_types): their values are
    held here, their types are not."""
    x, encoders = _encoders()
    for (name, _, variables), mod, shape in zip(encoders, (
            Encoder1D(Encoder1DConfig(**EKW)).eval(),
            ECAPAEncoder(ECAPAConfig(**CKW)).eval()), ((2, 4, 48), (2, 6))):
        load_module(mod, variables, name)
        noise = torch.from_numpy(np.array(jax.random.normal(KEY, shape)))
        with torch.no_grad():
            ours = cast_call(mod, BF16, torch.from_numpy(x).to(BF16),
                             noise=noise)
        _hold(name, _leaves(ours), *jax_pair[name])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    with open(sys.argv[1], "wb") as f:
        pickle.dump(jax_values("bf16"), f)
