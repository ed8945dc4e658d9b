"""The port's codec-only artifact (``after-tpu-torch export_autoencoder``)
against the JAX package's (``after-tpu export_autoencoder``), both written
by their commands from codec runs of the same weights, on the CPU: the
micro codec of tests/test_torch_serving.py with GroupNorm, non-causal (the
crossfade path), and causal without norm (cached convs).  Each of
``encode``, ``decode`` and ``forward`` over 4 buffers, each method with its
own state: atol and rtol 1e-4 (CODEC_TOL, f32 on both sides summed in other
orders).  The manifests: the JAX keys with the same values (the state's
leaves as a multiset of shapes and dtypes), the port adding ``runtime``,
``stages`` and ``state_paths``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu import config as jax_config
from after_tpu.models import AudioCodec as JaxCodec
from after_tpu.streaming.export import ExportedCodec as JaxCodecHost
from after_tpu.utils.checkpoint import save_checkpoint as jax_save
from after_tpu_torch import config as port_config
from after_tpu_torch.cli.main import main as port_main
from after_tpu_torch.models.autoencoder import AudioCodec
from after_tpu_torch.streaming.export import ExportedCodec
from after_tpu_torch.utils.checkpoint import save_checkpoint
from after_tpu_torch.utils.from_jax import load_module
from tests.test_diffusion import micro_config
from tests.test_torch_serving import CODEC_TOL
from tests.test_torch_streamer import _perturbed


def codec_runs(root, causal):
    """A JAX codec run and a port codec run of the same weights."""
    from after_tpu.cli.main import main as jax_main

    cfg = jax_config.with_overrides(micro_config(), {
        "autoencoder.causal": causal,
        "autoencoder.use_norm": not causal}).autoencoder
    variables = _perturbed(jax.jit(JaxCodec(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.ratio * 8, 1))), 2)
    jax_run, port_run = root / "jax_run", root / "port_run"
    jax_save(str(jax_run), 0, {"codec_vars": variables},
             config_json=jax_config.ae_to_json(cfg))
    pcfg = port_config.ae_from_json(jax_config.ae_to_json(cfg))
    codec = AudioCodec(pcfg)
    load_module(codec, variables, "codec")
    save_checkpoint(str(port_run), 0, {"codec_vars": codec.state_dict()},
                    config_json=port_config.ae_to_json(pcfg))
    args = ["export_autoencoder", "--chunk_size", "4"]
    assert jax_main(args + ["--model_path", str(jax_run), "--out",
                            str(root / "jax_art")]) == 0
    assert port_main(args + ["--model_path", str(port_run), "--out",
                             str(root / "port_art"), "--device", "cpu"]) == 0
    return cfg, str(root / "jax_art"), str(root / "port_art")


@pytest.mark.parametrize("causal", [False, True])
def test_codec_artifact_matches_jax(tmp_path, causal):
    cfg, jax_art, port_art = codec_runs(tmp_path, causal)
    theirs, ours = JaxCodecHost(jax_art), ExportedCodec(port_art, "cpu")
    jm, pm = theirs.manifest, ours.manifest
    assert set(pm) - set(jm) == {"runtime", "stages", "state_paths"}
    for key in jm:
        if key not in ("state_shapes", "state_dtypes"):
            assert pm[key] == jm[key], key
    # the same leaves (the JAX manifest names no paths; its leaves come in
    # the order of sorted keys)
    assert (sorted(zip(map(tuple, pm["state_shapes"]), pm["state_dtypes"]))
            == sorted(zip(map(tuple, jm["state_shapes"]),
                          jm["state_dtypes"])))
    assert pm["streaming"] == ("cached" if causal else "crossfade")
    fns = {n: jax.jit(f.call) for n, f in theirs._fns.items()}
    rng = np.random.RandomState(3)
    A, T = 4 * cfg.ratio, 4
    for i in range(4):
        audio = (0.3 * rng.randn(1, A, 1)).astype(np.float32)
        z = rng.randn(1, T, cfg.z_channels).astype(np.float32)
        for name, x in (("encode", audio), ("decode", z),
                        ("forward", audio)):
            y, state = fns[name](theirs._state[name], jnp.asarray(x))
            theirs._state[name] = list(state)
            py = getattr(ours, name)(x)
            np.testing.assert_allclose(py.numpy(), np.asarray(y),
                                       **CODEC_TOL,
                                       err_msg=f"{name}, buffer {i}")
    with open(os.path.join(port_art, "manifest.json")) as f:
        assert json.load(f)["codec_only"] == 1
    ours.reset()
    assert all(torch.equal(t, torch.from_numpy(v)) for t, v in zip(
        ours._states["forward"], np.load(os.path.join(
            port_art, "forward_state.npz")).values()))
