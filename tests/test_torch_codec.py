"""The port's codec against the JAX codec on shared weights.

A tiny codec (4 PQMF bands, 8 base channels, two stages) is initialised in
JAX (fused_kernels=False, the lax path), its parameters are perturbed so
that every weight-norm magnitude, snake and norm parameter is non-trivial,
and the same variables are loaded into the port with utils.from_jax.
Tolerance: atol 1e-4 and rtol 1e-4 (f32 on both sides; the two frameworks
sum the conv taps in different orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu.config import AutoEncoderConfig as JaxAEConfig
from after_tpu.models import AudioCodec as JaxCodec
from after_tpu.ops.conv import StreamConvTranspose1d as JaxConvT
from after_tpu.ops.pqmf import PQMFAnalysis as JaxPQMFA
from after_tpu.ops.pqmf import PQMFSynthesis as JaxPQMFS
from after_tpu_torch.config import AutoEncoderConfig
from after_tpu_torch.models.autoencoder import AudioCodec
from after_tpu_torch.ops.conv import StreamConvTranspose1d
from after_tpu_torch.ops.pqmf import PQMFAnalysis, PQMFSynthesis
from after_tpu_torch.utils.from_jax import load_module

TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(pqmf_bands=4, z_channels=8, base_channels=8, multipliers=(1, 2, 2),
            factors=(2, 2), dilations=(1, 3), num_blocks_per_stage=1)


def _perturbed_numpy(variables, seed):
    rng = np.random.RandomState(seed)

    def f(v):
        v = np.asarray(v, dtype=np.float32)
        return (v * (1 + 0.2 * rng.uniform(-1, 1, v.shape))
                + 0.02 * rng.randn(*v.shape)).astype(np.float32)
    return jax.tree_util.tree_map(f, variables)


def _codec_pair(**kw):
    kw = {**TINY, **kw}
    jcodec = JaxCodec(JaxAEConfig(**kw, fused_kernels=False))
    x = jnp.zeros((1, 1024, 1))
    variables = _perturbed_numpy(
        jax.jit(jcodec.init)(jax.random.PRNGKey(0), x), seed=1)
    codec = AudioCodec(AutoEncoderConfig(**kw)).eval()
    load_module(codec, variables, "codec")
    return jcodec, variables, codec


@pytest.mark.parametrize("causal", [False, True])
def test_pqmf_analysis_and_synthesis(causal):
    rng = np.random.RandomState(0)
    x = (0.3 * rng.randn(2, 1024, 1)).astype(np.float32)
    yb = JaxPQMFA(100, 4, causal).apply({}, jnp.asarray(x))
    pb = PQMFAnalysis(100, 4, causal)(torch.from_numpy(x))
    np.testing.assert_allclose(pb.numpy(), np.asarray(yb), **TOL)
    y = JaxPQMFS(100, 4, causal).apply({}, yb)
    p = PQMFSynthesis(100, 4, causal)(torch.from_numpy(np.array(yb)))
    assert p.shape == y.shape
    np.testing.assert_allclose(p.numpy(), np.asarray(y), **TOL)


@pytest.mark.parametrize("factor", [2, 4])
def test_transposed_conv(factor):
    rng = np.random.RandomState(factor)
    x = rng.randn(2, 16, 12).astype(np.float32)
    jmod = JaxConvT(10, 2 * factor, factor)
    variables = _perturbed_numpy(
        jmod.init(jax.random.PRNGKey(factor), jnp.asarray(x)), seed=factor)
    y = jmod.apply(variables, jnp.asarray(x))
    mod = StreamConvTranspose1d(12, 10, 2 * factor, factor)
    load_module(mod, variables, "up")
    with torch.no_grad():
        p = mod(torch.from_numpy(x))
    assert p.shape == (2, 16 * factor, 10)
    np.testing.assert_allclose(p.numpy(), np.asarray(y), **TOL)


@pytest.mark.parametrize("kw", [
    dict(),
    # the "streaming" overlay: causal convs, no GroupNorm
    dict(causal=True, use_norm=False),
    dict(use_loudness=False, bottleneck="tanh"),
    dict(pqmf_bands=1, bottleneck="vae"),
])
def test_codec_encode_decode(kw):
    jcodec, variables, codec = _codec_pair(**kw)
    rng = np.random.RandomState(2)
    x = (0.3 * rng.randn(2, 1024, 1)).astype(np.float32)
    z = jax.jit(lambda v, a: jcodec.apply(v, a, method=JaxCodec.encode))(
        variables, jnp.asarray(x))
    y = jax.jit(lambda v, a: jcodec.apply(v, a, method=JaxCodec.decode))(
        variables, z)
    with torch.no_grad():
        pz = codec.encode(torch.from_numpy(x))
        py = codec.decode(torch.from_numpy(np.array(z)))
    assert pz.shape == z.shape
    np.testing.assert_allclose(pz.numpy(), np.asarray(z), **TOL)
    assert py.shape == y.shape
    np.testing.assert_allclose(py.numpy(), np.asarray(y), **TOL)


def test_codec_loader_rejects_mismatched_tree():
    _, variables, codec = _codec_pair()
    bad = jax.tree_util.tree_map(lambda v: v, variables)
    bad["params"]["encoder"]["extra"] = {"kernel": np.zeros((1, 1, 1))}
    with pytest.raises(ValueError, match="no place in the port"):
        load_module(codec, bad, "codec")
    other = AudioCodec(dataclasses.replace(
        AutoEncoderConfig(**TINY), base_channels=4)).eval()
    with pytest.raises(ValueError, match="shape"):
        load_module(other, variables, "codec")


def test_codec_hands_the_kernel_contiguous_rows(monkeypatch):
    """On the card the kernel refuses strided inputs; every ConvBlock1d must
    pass contiguous f32 (B, T, C) tensors and its weight in the kernel's
    layout (checked here on the CPU)."""
    import after_tpu_torch.models.autoencoder as ae
    from after_tpu_torch.ops.kernels.fused_conv import (snake_conv_reference,
                                                        torch_weight)

    calls, kept = [], {}

    def checked(x, alpha, beta, w_k, w_lo, b, dilation, mode):
        for t in (x, alpha, beta, b):
            assert t.is_contiguous() and t.dtype == torch.float32
        # the weight is its conv's kept pair, in the kernel's (k, O, C)
        # layout: the same tensors at every call, so no copy per call
        pair = kept.get(id(w_k), (None, None))
        assert pair[0] is w_k and pair[1] is w_lo
        assert w_k.dtype == torch.float32 and w_k.is_contiguous()
        assert w_lo.shape == w_k.shape and w_lo.is_contiguous()
        calls.append(x.shape)
        return snake_conv_reference(
            x, alpha, beta, torch_weight(w_k, x.shape[2]), b, dilation, mode)

    monkeypatch.setattr(ae, "snake_conv", checked)
    codec = AudioCodec(AutoEncoderConfig(**TINY)).eval()
    with torch.no_grad():
        for m in codec.modules():
            if isinstance(m, ae.ConvBlock1d):
                w_k, w_lo = m.conv.kernel_weights()
                kept[id(w_k)] = (w_k, w_lo)
        z = codec.encode(torch.zeros(1, 1024, 1))
        codec.decode(z)
    # 1 + 2 stages x 1 resnet = 3 resnets per direction, 2 convs each
    assert len(calls) == 12


def test_weight_norm_is_kept_until_the_weights_change():
    """At inference each conv keeps its weight-normed weight; loading new
    weights in place must still reach the output (held against JAX)."""
    jcodec, variables, codec = _codec_pair()
    conv = codec.encoder.to_in.block1.conv
    x = (0.3 * np.random.RandomState(2).randn(1, 1024, 1)).astype(np.float32)
    with torch.inference_mode():
        codec.encode(torch.from_numpy(x))
        kept = conv.effective_weight()
        assert conv.effective_weight() is kept
        other = _perturbed_numpy(variables, seed=5)
        load_module(codec, other, "codec")
        assert conv.effective_weight() is not kept
        pz = codec.encode(torch.from_numpy(x))
    z = jax.jit(lambda v, a: jcodec.apply(v, a, method=JaxCodec.encode))(
        other, jnp.asarray(x))
    np.testing.assert_allclose(pz.numpy(), np.asarray(z), **TOL)
    # with gradients on, the weight is recomputed and carries a graph
    assert conv.effective_weight().requires_grad


def test_kernel_weight_is_split_and_refreshed_after_load_state_dict():
    """A ConvBlock1d conv keeps its inference weight in the fused kernel's
    (k, O, C) layout with its low tf32 half: the tf32 high part the tensor
    cores read plus that low half is the weight within 2^-20 |W|, and loading
    other weights with load_state_dict refreshes both."""
    from after_tpu_torch.ops.kernels.fused_conv import tf32_high
    from after_tpu_torch.ops.conv import weight_norm

    _, variables, codec = _codec_pair()
    _, _, other = _codec_pair()
    load_module(other, _perturbed_numpy(variables, seed=7), "codec")
    conv = codec.decoder.to_out.block1.conv
    assert conv.kernel_layout

    def check(pair):
        wk, lo = pair
        C = conv.in_features
        assert wk.is_contiguous() and lo.shape == wk.shape
        assert not wk[:, :, C:].any() and not lo[:, :, C:].any()
        assert not (lo.view(torch.int32) & 0x1FFF).any()   # tf32 values
        exact = weight_norm(conv.weight, conv.g).permute(2, 0, 1)
        np.testing.assert_array_equal(wk[:, :, :C].numpy(), exact.numpy())
        err = (tf32_high(wk[:, :, :C]) + lo[:, :, :C] - exact).abs()
        assert (err <= 2.0 ** -20 * exact.abs()).all()

    with torch.no_grad():
        kept = conv.kernel_weights()
        check(kept)
        again = conv.kernel_weights()
        assert again[0] is kept[0] and again[1] is kept[1]
        # the kept weight in torch's layout is a view of the pair's first
        assert conv.effective_weight().data_ptr() == kept[0].data_ptr()
        codec.load_state_dict(other.state_dict())
        fresh = conv.kernel_weights()
        assert fresh[0] is not kept[0]
        assert not torch.equal(fresh[1], kept[1])
        check(fresh)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(causal=True, use_norm=False),
    dict(use_loudness=False, bottleneck="tanh"),
    dict(pqmf_bands=1, bottleneck="vae"),
    dict(bottleneck="none"),
])
def test_training_forward_matches_jax(kw):
    """AudioCodec.forward (y, y_bands, z, reg, x_bands) against the JAX
    AudioCodec.__call__ with its rng; the port gets the normal draw JAX's
    bottleneck makes from that rng."""
    jcodec, variables, codec = _codec_pair(**kw)
    rng = np.random.RandomState(3)
    x = (0.3 * rng.randn(2, 1024, 1)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    outs = jax.jit(lambda v, a: jcodec.apply(v, a, rng=key))(
        variables, jnp.asarray(x))
    noise = np.array(jax.random.normal(
        key, (2, 1024 // codec.cfg.ratio, codec.cfg.z_channels)))
    ours = codec(torch.from_numpy(x), torch.from_numpy(noise))
    for name, a, t in zip(("y", "y_bands", "z", "reg", "x_bands"), ours,
                          outs):
        t = np.asarray(t)
        assert tuple(a.shape) == t.shape, name
        np.testing.assert_allclose(a.detach().numpy(), t, err_msg=name, **TOL)
    # without noise: the bottleneck's mean / clean latents
    outs = jax.jit(lambda v, a: jcodec.apply(v, a))(variables, jnp.asarray(x))
    z = codec(torch.from_numpy(x))[2]
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(outs[2]), **TOL)


def test_optimizer_step_reaches_the_kept_inference_weight():
    """A trainer's in-place update bumps each parameter's version, so the
    weight a conv keeps for inference (in the kernel's layout) is made
    anew from the updated parameters."""
    from after_tpu_torch.autoencoder import AdamW
    from after_tpu_torch.ops.conv import weight_norm

    _, _, codec = _codec_pair()
    conv = codec.decoder.to_out.block1.conv
    with torch.no_grad():
        kept = conv.effective_weight()
    params = list(codec.parameters())
    opt = AdamW(params, 1e-2, 1.0, 0.9, 0.999, 2.0)
    x = torch.from_numpy((0.3 * np.random.RandomState(4).randn(
        1, 1024, 1)).astype(np.float32))
    loss = codec(x)[0].square().mean()
    assert opt.step(list(torch.autograd.grad(loss, params)))
    with torch.no_grad():
        fresh = conv.effective_weight()
        assert fresh is not kept
        np.testing.assert_array_equal(
            fresh.numpy(), weight_norm(conv.weight, conv.g).numpy())
        assert not torch.equal(fresh, kept)
        z = codec.encode(x)
    # the inference path sees the new weights: it agrees with the training
    # forward, which recomputes every weight
    np.testing.assert_allclose(z.numpy(), codec(x)[2].detach().numpy(),
                               atol=1e-6)
