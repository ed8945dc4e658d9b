"""The port's precision helpers, the snake+conv op's plain bf16 version and
the JAX artifact's projector, on the CPU.

- ``resolve_dtype`` and ``cast_floating``: the cases of
  tests/test_precision.py.
- The op ``snake_conv`` on bf16 CPU tensors (its plain bf16 version: the
  snake in f32 rounded to bf16, the conv summed in f32, the output rounded
  once) against the JAX package's ``reference_snake_conv``, causal and
  centered, k = 1 and 3.
- ``read_msgpack`` against msgpack's own encoder, and a ``projector.msgpack``
  written by the JAX package's ``save_projector`` read by the port's
  ``load_projector`` (and found by ``serve``'s
  ``find_artifact_projector``): the projector's maps within 1e-6 of the
  JAX ones.

The bf16 tolerance rule (here and in tests/test_torch_bf16*.py): bf16
rounds at other places in the two frameworks, so a port module in bf16 is
held to the JAX module's f32 output, no farther from it than twice the JAX
module's own bf16 output, plus 1e-6 of its scale:

    max|port_bf16 - jax_f32| <= 2 max|jax_bf16 - jax_f32| + 1e-6 max|jax_f32|
"""

import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from torch import nn

from after_tpu.ops.pallas import reference_snake_conv
from after_tpu.utils import latent_map as jax_latent_map
from after_tpu_torch.cli.serve import find_artifact_projector
from after_tpu_torch.ops.kernels.fused_conv import (kernel_weight, snake_conv,
                                                    snake_conv_reference,
                                                    weight_channels)
from after_tpu_torch.utils.latent_map import load_projector, read_msgpack
from after_tpu_torch.utils.precision import cast_floating, resolve_dtype

PROJECTOR_TOL = 1e-6


def bf16_close(label, port16, jax16, jax32):
    """The bf16 tolerance rule of this file's docstring; returns the port's
    distance and its limit."""
    port16, jax16, jax32 = (np.asarray(a, np.float64)
                            for a in (port16, jax16, jax32))
    assert port16.shape == jax32.shape, (label, port16.shape, jax32.shape)
    err = float(np.abs(port16 - jax32).max())
    limit = (2 * float(np.abs(jax16 - jax32).max())
             + 1e-6 * float(np.abs(jax32).max()))
    print(f"{label}: bf16 {err:.3e} from the f32 output, limit {limit:.3e}")
    assert np.isfinite(port16).all() and err <= limit, (label, err, limit)
    return err, limit


def cosine(a, b):
    a, b = np.ravel(np.asarray(a, np.float64)), np.ravel(np.asarray(b,
                                                                    np.float64))
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def test_resolve_dtype():
    assert resolve_dtype(None) is None
    assert resolve_dtype("") is None
    assert resolve_dtype("bf16") == torch.bfloat16
    assert resolve_dtype("bfloat16") == torch.bfloat16
    assert resolve_dtype("f32") == torch.float32
    assert resolve_dtype("fp32") == torch.float32
    assert resolve_dtype(torch.bfloat16) == torch.bfloat16
    with pytest.raises(ValueError, match="compute dtype"):
        resolve_dtype("bfloat17")


def test_cast_floating_skips_ints():
    tree = {"a": torch.zeros(2), "b": torch.zeros(2, dtype=torch.int32),
            "c": [torch.ones(1, dtype=torch.float64), 3]}
    out = cast_floating(tree, torch.bfloat16)
    assert out["a"].dtype == torch.bfloat16
    assert out["b"].dtype == torch.int32
    assert out["c"][0].dtype == torch.bfloat16 and out["c"][1] == 3

    m = nn.Linear(2, 2)
    m.register_buffer("steps", torch.zeros((), dtype=torch.int64))
    assert cast_floating(m, torch.bfloat16) is m
    assert m.weight.dtype == torch.bfloat16
    assert m.steps.dtype == torch.int64


def _inputs(seed, B, T, C, O, k):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    alpha = (rng.rand(C) + 0.5).astype(np.float32)
    beta = (rng.rand(C) + 0.5).astype(np.float32)
    w = (rng.randn(k, C, O) / np.sqrt(k * C)).astype(np.float32)   # (k, C, O)
    b = (0.1 * rng.randn(O)).astype(np.float32)
    return x, alpha, beta, w, b


@pytest.mark.parametrize("mode", ["causal", "centered"])
@pytest.mark.parametrize("k,d,C,O", [(3, 3, 36, 20), (1, 1, 20, 12)])
def test_plain_bf16_snake_conv_matches_jax(k, d, C, O, mode):
    x, alpha, beta, w, b = _inputs(0, 2, 96, C, O, k)
    j32 = reference_snake_conv(*map(jnp.asarray, (x, alpha, beta, w, b)),
                               dilation=d, mode=mode)
    j16 = reference_snake_conv(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (x, alpha, beta, w, b)),
                               dilation=d, mode=mode)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, alpha, beta)]
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))
                          ).to(torch.bfloat16)
    w_k, w_lo = kernel_weight(wt)
    assert w_k.shape == (k, O, weight_channels(C, torch.bfloat16))
    assert w_k.shape[2] % 8 == 0 and w_lo.numel() == 0
    bb = torch.from_numpy(b).to(torch.bfloat16)
    y = snake_conv(*t, w_k, w_lo, bb, d, mode)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 96, O)
    # the op's CPU kernel is the plain version, bit for bit
    assert torch.equal(y, snake_conv_reference(*t, wt, bb, d, mode))
    bf16_close(f"snake_conv k={k} d={d} {mode}", y.float().numpy(),
               np.asarray(j16, np.float32), np.asarray(j32))


def test_read_msgpack_decodes_every_type():
    doc = {"nil": None, "t": True, "f": False, "fix": 5, "neg": -17,
           "u8": 200, "u16": 60000, "u32": 70000, "u64": 2 ** 40,
           "i8": -100, "i16": -3000, "i32": -70000, "i64": -2 ** 40,
           "f64": 1.25, "s": "x" * 40, "long": "y" * 300, "b": b"\x00\x01",
           "arr": list(range(20)), "map": {str(i): i for i in range(20)}}
    assert read_msgpack(msgpack.packb(doc, use_bin_type=True)) == doc
    assert read_msgpack(msgpack.packb(1.5, use_single_float=True)) == 1.5
    with pytest.raises(ValueError):
        read_msgpack(msgpack.packb([1, 2])[:-1])


def test_jax_projector_msgpack_read_by_the_port(tmp_path):
    in_dim = 6
    model = jax_latent_map.SmallAutoencoder(in_dim=in_dim)
    rng = np.random.RandomState(3)
    emb = rng.randn(64, in_dim).astype(np.float32)
    params = model.init(jax.random.PRNGKey(5), jnp.asarray(emb[:1]))
    # not an init: every weight of its own scale
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.3),
        params)
    art = tmp_path / "run" / "after.audio.run"
    os.makedirs(art)
    jax_latent_map.save_projector(str(art), params, emb)
    assert (art / "projector.msgpack").exists()
    assert not (art / "projector.npz").exists()
    proj = load_projector(str(art), in_dim, "cpu")
    xy = rng.uniform(-1, 1, (8, 2)).astype(np.float32)
    with torch.no_grad():
        m = proj.encode(torch.from_numpy(emb)).numpy()
        z = proj.decode(torch.from_numpy(xy)).numpy()
    jm = np.asarray(model.apply(params, jnp.asarray(emb),
                                method=jax_latent_map.SmallAutoencoder.encode))
    jz = np.asarray(model.apply(params, jnp.asarray(xy),
                                method=jax_latent_map.SmallAutoencoder.decode))
    np.testing.assert_allclose(m, jm, atol=PROJECTOR_TOL)
    np.testing.assert_allclose(z, jz, atol=PROJECTOR_TOL)
    found, where = find_artifact_projector(str(tmp_path / "run"), in_dim,
                                           "cpu")
    assert where == str(art)
    with torch.no_grad():
        np.testing.assert_array_equal(
            found.encode(torch.from_numpy(emb)).numpy(), m)
