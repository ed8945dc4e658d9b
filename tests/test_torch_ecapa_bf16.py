"""The port's ECAPA under bf16 parameters against the JAX module's, op by
op in the attentive statistics pooling and whole.

The JAX package's pooling takes its global context with ``jnp.full((B, T,
1), 1.0 / T)``, weakly typed, so under bf16 parameters its context, its
attention, its pooled statistics and its timbre vector are bf16.  The
port's pooling computes at those types and rounds where the JAX program
rounds: each dense layer and conv rounds its product before adding its
bias (flax's ``Dense`` and ``Conv``), the softmax over time runs its exp,
its sum and its divide as ops of their own (``jax.nn.softmax``), the SE
gates are 1 / (1 + exp(-s)) with each step rounded, the VAE's softplus
max(x, 0) + log1p(exp(-|x|)) (XLA's expansions of the logistic and of
``logaddexp`` below f32) and BatchNorm widens its bf16 scale and bias.

The JAX values come from a process of its own in which XLA rounds every
bf16 value (--xla_allow_excess_precision=false), as the bf16 training
tests take theirs (tests/torch_bf16_train_common.py).

- Op by op: each op of the port's pooling is fed the JAX op's bf16 input
  and its output held to the JAX op's: the global mean and std, the
  attention's TDNN, its tanh, its dense layer, the softmax over time and
  the attention-weighted mean and std, at T = 16 and at T = 12 (1 / T
  inexact in bf16).
- Whole: the micro ECAPA of tests/test_torch_alternatives_bf16.py, without
  and with the VAE, at inference and in a training forward (BatchNorm on
  the batch's statistics), its parameters cast to bf16 inside the call
  (``cast_call``, as the trainers cast them): z, the mean and the
  regulariser at the JAX module's types, and their values held to the JAX
  module's.

Tolerance: one bf16 ulp of the largest value of each op's output or each
encoder output (2^(e - 7) for a largest |JAX| value in [2^e, 2^(e+1)));
on the CPU every op and the encoders without the VAE give the JAX bits,
the VAE's sample and KL are within that ulp.  The f32 paths are those of
tests/test_torch_encoders.py, unchanged.
"""

import os
import pickle
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu.config import ECAPAConfig as JaxECAPAConfig
from after_tpu.models import ECAPAEncoder as JaxECAPA
from after_tpu.models.ecapa import AttentiveStatisticsPooling as JaxASP
from after_tpu.models.ecapa import TDNNBlock as JaxTDNN
from after_tpu_torch.config import ECAPAConfig
from after_tpu_torch.models.ecapa import (AttentiveStatisticsPooling,
                                          ECAPAEncoder, _dense, _softmax,
                                          _stats)
from after_tpu_torch.ops.train_mode import TrainMode
from after_tpu_torch.utils.from_jax import load_module
from after_tpu_torch.utils.precision import cast_call
from tests import torch_threads_common  # noqa: F401  (xdist workers' threads)

BF16 = torch.bfloat16
B, C, A = 2, 32, 8
FRAMES = (16, 12)
CKW = dict(in_size=8, out_dim=6, channels=(16, 16, 16, 32), res2net_scale=4,
           se_channels=8, attention_channels=8)
ENCODERS = [(reg, training) for reg in ("none", "vae")
            for training in (False, True)]


def _pooling_case(T):
    """x (B, T, C) and the pooling's variables, drawn away from init."""
    rng = np.random.RandomState(T)
    x = rng.randn(B, T, C).astype(np.float32)
    v = JaxASP(A).init(jax.random.PRNGKey(T), jnp.asarray(x))
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.3 * rng.randn(*a.shape), np.float32), v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    return x, v


def _bf16_params(v):
    return {**v, "params": jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), v["params"])}


def _jax_pooling_ops(v, x):
    """The JAX pooling's ops one by one (after_tpu/models/ecapa.py:
    AttentiveStatisticsPooling), each output kept."""
    T = x.shape[1]
    out = {}

    def stats(m, y, tag):
        mean = jnp.sum(m * y, axis=1)
        var = jnp.sum(m * jnp.square(y - mean[:, None]), axis=1)
        out[tag + "mean"], out[tag + "std"] = mean, jnp.sqrt(
            jnp.maximum(var, 1e-12))
        return out[tag + "mean"], out[tag + "std"]
    mean, std = stats(jnp.full((B, T, 1), 1.0 / T), x, "global_")
    attn_in = jnp.concatenate([x, jnp.broadcast_to(mean[:, None], x.shape),
                               jnp.broadcast_to(std[:, None], x.shape)], -1)
    out["tdnn"] = JaxTDNN(A, 1, 1).apply(
        {"params": v["params"]["tdnn"],
         "batch_stats": v["batch_stats"]["tdnn"]}, attn_in)
    out["tanh"] = jnp.tanh(out["tdnn"])
    out["dense"] = fnn.Dense(C).apply({"params": v["params"]["conv"]},
                                      out["tanh"])
    out["softmax"] = jax.nn.softmax(out["dense"], axis=1)
    stats(out["softmax"], x, "attn_")
    out["module"] = JaxASP(A).apply(v, x)
    return out


def _encoder_case(reg, draw=0):
    rng = np.random.RandomState(100 + draw)
    x = rng.randn(2, 16, 8).astype(np.float32)
    jmod = JaxECAPA(JaxECAPAConfig(**CKW, regularisation=reg))
    v = jax.jit(jmod.init)({"params": jax.random.PRNGKey(draw),
                            "sample": jax.random.PRNGKey(1)}, jnp.asarray(x))
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a + 0.2 * rng.randn(*a.shape), np.float32), v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    return x, jmod, v


KEY = jax.random.PRNGKey(7)


def jax_values():
    """{case: JAX bf16 outputs as (f32 numpy array, dtype name)}."""
    out = {}
    for T in FRAMES:
        x, v = _pooling_case(T)
        ops = jax.jit(_jax_pooling_ops)(_bf16_params(v),
                                        jnp.asarray(x, jnp.bfloat16))
        for k, a in ops.items():
            out["pool", T, k] = (np.asarray(a, np.float32), str(a.dtype))
    for reg, training in ENCODERS:
        x, jmod, v = _encoder_case(reg)

        def run(v, x):
            if training:
                return jmod.apply(v, x, training=True, rng=KEY,
                                  mutable=["batch_stats"])[0]
            return jmod.apply(v, x, rng=KEY)
        res = jax.jit(run)(_bf16_params(v), jnp.asarray(x, jnp.bfloat16))
        out["encoder", reg, training] = [(np.asarray(a, np.float32),
                                          str(a.dtype)) for a in res]
    return out


@pytest.fixture(scope="module")
def jax16(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ecapa_bf16") / "jax.pkl")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    subprocess.run([sys.executable, os.path.abspath(__file__), path],
                   cwd=root, env=env, check=True)
    with open(path, "rb") as f:
        return pickle.load(f)


def _hold(label, port, theirs):
    ref, dtype = theirs
    assert str(port.dtype).replace("torch.", "") == dtype, (
        label, port.dtype, dtype)
    p = port.detach().float().numpy()
    assert p.shape == ref.shape, (label, p.shape, ref.shape)
    err = float(np.abs(p - ref).max())
    top = float(np.abs(ref).max())
    limit = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
    print(f"{label}: {int((p != ref).sum())} of {p.size} differ, "
          f"max {err:.3e} (limit {limit:.3e})")
    assert err <= limit, (label, err, limit)


def _bf16_module(module):
    for p in module.parameters():
        p.data = p.data.to(BF16)
    return module


@pytest.mark.parametrize("T", FRAMES)
def test_pooling_op_by_op(jax16, T):
    x, v = _pooling_case(T)
    pool = AttentiveStatisticsPooling(C, A).eval()
    load_module(pool, v, "asp")
    _bf16_module(pool)

    def j(name):
        return torch.from_numpy(jax16["pool", T, name][0]).to(BF16)
    xb = torch.from_numpy(x).to(BF16)
    with torch.no_grad():
        mean, std = _stats(torch.full((B, T, 1), 1.0 / T, dtype=BF16), xb)
        _hold("global mean", mean, jax16["pool", T, "global_mean"])
        _hold("global std", std, jax16["pool", T, "global_std"])
        attn_in = torch.cat([xb, j("global_mean")[:, None].expand(B, T, C),
                             j("global_std")[:, None].expand(B, T, C)], -1)
        _hold("tdnn", pool.tdnn(attn_in), jax16["pool", T, "tdnn"])
        _hold("tanh", torch.tanh(j("tdnn")), jax16["pool", T, "tanh"])
        _hold("dense", _dense(pool.conv, j("tanh")),
              jax16["pool", T, "dense"])
        _hold("softmax", _softmax(j("dense"), 1),
              jax16["pool", T, "softmax"])
        mean, std = _stats(j("softmax"), xb)
        _hold("attention mean", mean, jax16["pool", T, "attn_mean"])
        _hold("attention std", std, jax16["pool", T, "attn_std"])
        _hold("pooling", pool(xb), jax16["pool", T, "module"])


@pytest.mark.parametrize("reg,training", ENCODERS)
def test_encoder_types_and_values(jax16, reg, training):
    x, _, v = _encoder_case(reg)
    mod = ECAPAEncoder(ECAPAConfig(**CKW, regularisation=reg)).eval()
    load_module(mod, v, "encoder")
    kw = {}
    if reg == "vae":
        kw["noise"] = torch.from_numpy(np.array(jax.random.normal(KEY,
                                                                  (2, 6))))
    with torch.no_grad():
        out = cast_call(mod, BF16, torch.from_numpy(x).to(BF16),
                        TrainMode() if training else None, **kw)
    for name, port, theirs in zip(("z", "mean", "reg"), out,
                                  jax16["encoder", reg, training]):
        _hold(f"{reg} training={training} {name}", port, theirs)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    with open(sys.argv[1], "wb") as f:
        pickle.dump(jax_values(), f)
