"""The port's streaming artifact against the JAX package's, both exported
from the same weights (the port's through ``load_jax``), on the CPU: the
micro config of tests/test_torch_serving.py with the crossfade codec and
GroupNorm, batch 2.

- ``forward`` over 8 buffers whose nb_steps and both guidances change
  (runtime attributes of both artifacts), the port fed
  ``jax.random.normal(wrap_key_data(key), ...)`` as the noise the JAX
  artifact draws from ``key``: atol and rtol 1e-4 (CODEC_TOL, f32 on both
  sides summed in other orders);
- the manifests: the JAX keys all there with the same ``methods`` and
  scalar keys, the port adding exactly ``runtime``, ``stages`` and
  ``state_paths``; the initial states matched by path, in shape, dtype
  and value (CODEC_TOL).

The JAX artifact's programs are called through ``jax.jit`` of their
deserialized ``call`` (the JAX host calls them unjitted, which traces again
at every buffer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from after_tpu import config as jax_config
from after_tpu.streaming.export import ExportedStreamer as JaxHost
from after_tpu.streaming.export import export_streamer as jax_export
from after_tpu_torch.streaming.export import (ExportedStreamer,
                                              export_streamer)
from tests.test_diffusion import micro_config
from tests.test_torch_serving import ATTRIBUTES, CODEC_TOL
from tests.test_torch_streamer import stream_pair

B = 2


class JaxArtifact:
    """The JAX package's host of an artifact, its programs jitted."""

    def __init__(self, path):
        self.host = JaxHost(path)
        self.fns = {n: jax.jit(m.call) for n, m in self.host._methods.items()}

    def call(self, name, *xs):
        h = self.host
        xs = xs + h._attr_args(name)
        if h.manifest["methods"][name].get("stateless"):
            return self.fns[name](*xs)
        y, state = self.fns[name](h.state, *xs)
        h.state = list(state)
        return y


def jax_state_paths(js, variables):
    """The paths of the JAX artifact's state leaves, in its leaf order."""
    def name(k):
        for attr in ("name", "key", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(k)
    leaves = jax.tree_util.tree_flatten_with_path(
        js.init_state(variables, B))[0]
    return ["/".join(name(k) for k in path) for path, _ in leaves]


def export_pair(cfg, tmp_path_factory, nb_steps=2, guidance_timbre=1.5):
    """(JAX variables, JAX streamer, port streamer, JAX artifact dir, port
    artifact dir) of one set of weights."""
    variables, js, ps = stream_pair(cfg)
    root = tmp_path_factory.mktemp("export_jax")
    jax_out, port_out = str(root / "jax"), str(root / "port")
    jax_export(js, variables, jax_out, nb_steps=nb_steps,
               guidance_timbre=guidance_timbre, batch_size=B)
    export_streamer(ps, port_out, nb_steps=nb_steps,
                    guidance_timbre=guidance_timbre, batch_size=B)
    return variables, js, ps, jax_out, port_out


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    cfg = jax_config.with_overrides(micro_config(), {
        "autoencoder.causal": False, "autoencoder.use_norm": True})
    return export_pair(cfg, tmp_path_factory)


@pytest.fixture(scope="module")
def hosts(artifacts):
    return JaxArtifact(artifacts[3]), ExportedStreamer(artifacts[4], "cpu")


def test_forward_with_changing_attributes_matches_jax(artifacts, hosts):
    variables, js, ps, jax_out, port_out = artifacts
    theirs, ours = hosts
    rng = np.random.RandomState(7)
    A = ps.audio_chunk
    for i, (nb, gt, gs) in enumerate(ATTRIBUTES):
        for host in (theirs.host, ours):
            host.set_attribute("nb_steps", nb)
            host.set_attribute("guidance_timbre", gt)
            host.set_attribute("guidance_structure", gs)
        a = (0.3 * rng.randn(B, A, 1)).astype(np.float32)
        b = (0.3 * rng.randn(B, A, 1)).astype(np.float32)
        key = jax.random.key_data(jax.random.PRNGKey(200 + i))
        x0 = np.array(jax.random.normal(jax.random.wrap_key_data(key), (
            B, ps.chunk_size, ps.cfg.denoiser.n_channels)))
        y = theirs.call("forward", jnp.asarray(a), jnp.asarray(b), key)
        py = ours.call("forward", a, b, x0=x0)
        np.testing.assert_allclose(py.numpy(), np.asarray(y), **CODEC_TOL,
                                   err_msg=f"buffer {i}")


def test_manifest_and_state_match_jax(artifacts, hosts):
    variables, js, ps, jax_out, port_out = artifacts
    theirs, ours = hosts[0].host, hosts[1]
    theirs.reset(jax_out)
    ours.reset()
    jm, pm = theirs.manifest, ours.manifest
    assert set(pm) - set(jm) == {"runtime", "stages", "state_paths"}
    assert set(jm) <= set(pm)
    assert pm["methods"] == jm["methods"]
    assert pm["runtime"] == "torch.export"
    assert set(pm["stages"]) == set(pm["methods"]) - {"latent2map",
                                                       "map2latent"}
    for key in jm:
        if key not in ("methods", "state_shapes", "state_dtypes"):
            assert pm[key] == jm[key], key
    # the state, matched by path
    paths = jax_state_paths(js, variables)
    assert sorted(paths) == sorted(pm["state_paths"])
    jax_leaf = dict(zip(paths, zip(jm["state_shapes"], jm["state_dtypes"],
                                   theirs.state)))
    for path, shape, dtype, t in zip(pm["state_paths"], pm["state_shapes"],
                                     pm["state_dtypes"], ours.state):
        assert (shape, dtype) == tuple(jax_leaf[path][:2]), path
        np.testing.assert_allclose(t.numpy(), np.asarray(jax_leaf[path][2]),
                                   **CODEC_TOL, err_msg=path)
