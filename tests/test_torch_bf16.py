"""The port's bf16 serving (``compute_dtype="bfloat16"``) against the JAX
package's, on the CPU: each module of the offline transfer and a whole
micro transfer (tests/test_torch_bf16_stream.py streams).

The config is tests/test_torch_pipeline.py's micro ``base`` (4-band codec
with GroupNorm, narrow encoders, a 2-layer denoiser); both packages load
the same perturbed f32 weights and cast them once (the JAX package's
``prepare_variables``, the port's ``compute_dtype``).  Every output is held
by the bf16 tolerance rule of tests/test_torch_precision.py: no farther from
the JAX module's f32 output than twice the JAX module's bf16 output, plus
1e-6 of its scale.  The whole transfer also meets the JAX package's cosine
bound (tests/test_precision.py): 0.99 to the JAX f32 output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu import config as jax_config
from after_tpu.diffusion import TransferPipeline as JaxPipeline
from after_tpu_torch import config as port_config
from after_tpu_torch.diffusion.pipeline import TransferPipeline
from tests.test_torch_pipeline import N_SIGNAL, OVERRIDES, _perturbed_numpy
from tests.test_torch_precision import bf16_close, cosine

NB_STEPS = 4
TRANSFER_COS = 0.99


@pytest.fixture(scope="module")
def pair():
    """(JAX f32 pipeline, JAX bf16 pipeline, f32 variables, their bf16
    cast, port bf16 pipeline, inputs)."""
    cfg = jax_config.get_config("base", **OVERRIDES).resolved(
        in_size=8, n_signal=N_SIGNAL)
    j32 = JaxPipeline(cfg)
    j16 = JaxPipeline(cfg, compute_dtype="bfloat16")
    variables = _perturbed_numpy(
        jax.jit(j32.init, static_argnums=1)(jax.random.PRNGKey(0), 1), 1)
    v16 = j16.prepare_variables(variables)
    pcfg = port_config.from_json(jax_config.to_json(cfg))
    p16 = TransferPipeline(pcfg, device="cpu",
                           compute_dtype="bfloat16").load_jax(variables)
    rng = np.random.RandomState(2)
    n = N_SIGNAL * cfg.autoencoder.ratio
    inputs = dict(
        a=(0.3 * rng.randn(1, n, 1)).astype(np.float32),
        b=(0.3 * rng.randn(1, n, 1)).astype(np.float32),
        x0=rng.randn(1, N_SIGNAL, 8).astype(np.float32))
    return j32, j16, variables, v16, p16, inputs


@pytest.fixture(scope="module")
def jax_pieces(pair):
    """The JAX f32 and bf16 transfers, piece by piece, from the same f32
    inputs: {name: (f32 output, bf16 output)}."""
    j32, j16, v32, v16, _, inp = pair
    out = {}
    for name, pipe, v in (("f32", j32, v32), ("bf16", j16, v16)):
        zs = pipe.encode(v, jnp.asarray(inp["a"]))
        zt = pipe.encode(v, jnp.asarray(inp["b"]))
        tc = pipe.structure(v, zs)
        c = pipe.timbre(v, zt)
        z = pipe.diffuse(v, jnp.asarray(inp["x0"]), c, tc, NB_STEPS, 2.0)
        out[name] = dict(zs=zs, tc=tc, c=c, z=z, y=pipe.decode(v, z))
    return out


def test_weights_are_cast_once(pair):
    p16 = pair[4]
    assert p16.compute_dtype == torch.bfloat16
    for module in (p16.codec, p16.rf):
        dtypes = {t.dtype for t in module.state_dict().values()
                  if t.is_floating_point()}
        assert dtypes == {torch.bfloat16}


def test_codec_encode(pair, jax_pieces):
    p16, inp = pair[4], pair[5]
    z = p16.encode(inp["a"])
    assert z.dtype == torch.float32
    bf16_close("encode", z.numpy(), jax_pieces["bf16"]["zs"],
               jax_pieces["f32"]["zs"])


def test_codec_decode(pair, jax_pieces):
    j32, j16, v32, v16, p16, _ = pair
    z = jax_pieces["f32"]["z"]
    y = p16.decode(np.asarray(z))
    assert y.dtype == torch.float32
    bf16_close("decode", y.numpy(), j16.decode(v16, z), j32.decode(v32, z))


def test_structure_encoder_and_fsq(pair, jax_pieces):
    j32, j16, v32, v16, p16, _ = pair
    zs = jax_pieces["f32"]["zs"]
    tc = p16.structure(np.asarray(zs))
    assert tc.dtype == torch.float32
    bf16_close("Encoder1D + FSQ", tc.numpy(), j16.structure(v16, zs),
               j32.structure(v32, zs))


def test_timbre_encoder(pair, jax_pieces):
    j32, j16, v32, v16, p16, _ = pair
    zt = jax_pieces["f32"]["zs"]
    c = p16.timbre(np.asarray(zt))
    assert c.dtype == torch.float32
    bf16_close("ECAPA", c.numpy(), j16.timbre(v16, zt), j32.timbre(v32, zt))


def test_denoiser_forward(pair, jax_pieces):
    j32, j16, v32, v16, p16, inp = pair
    f = jax_pieces["f32"]
    x = np.concatenate([inp["x0"]] * 3)
    t = np.full((3,), 0.25, np.float32)
    c = np.concatenate([np.asarray(f["c"])] * 3)
    tc = np.concatenate([np.asarray(f["tc"])] * 3)
    apply = jax.jit(j32.rf.net.apply)
    y32 = apply(v32["diffusion"]["net"], x, t, c, tc)
    y16 = apply(v16["diffusion"]["net"],
                *(jnp.asarray(a, jnp.bfloat16) for a in (x, t, c, tc)))
    with torch.no_grad():
        y = p16.rf.net(*(torch.from_numpy(a).to(torch.bfloat16)
                         for a in (x, t, c, tc)))
    assert y.dtype == torch.bfloat16
    bf16_close("denoiser", y.float().numpy(), np.asarray(y16, np.float32),
               y32)


def test_sample(pair, jax_pieces):
    p16, inp = pair[4], pair[5]
    f = jax_pieces["f32"]
    args = (inp["x0"], np.asarray(f["c"]), np.asarray(f["tc"]))
    j32, j16, v32, v16 = pair[:4]
    z32 = j32.diffuse(v32, *map(jnp.asarray, args), NB_STEPS, 2.0)
    z16 = j16.diffuse(v16, *map(jnp.asarray, args), NB_STEPS, 2.0)
    z = p16.diffuse(*args, nb_steps=NB_STEPS, guidance_timbre=2.0)
    assert z.dtype == torch.float32 and z16.dtype == jnp.float32
    bf16_close("sample", z.numpy(), z16, z32)


def test_transfer(pair, jax_pieces):
    p16, inp = pair[4], pair[5]
    y = p16.transfer(inp["a"], inp["b"], nb_steps=NB_STEPS,
                     guidance_timbre=2.0, x0=inp["x0"])
    y32 = np.asarray(jax_pieces["f32"]["y"])
    assert y.dtype == torch.float32 and y.shape == y32.shape
    bf16_close("transfer", y.numpy(), jax_pieces["bf16"]["y"], y32)
    cos = cosine(y.numpy(), y32)
    print(f"transfer: cosine to JAX f32 {cos:.5f}")
    assert cos >= TRANSFER_COS
