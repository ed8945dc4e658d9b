"""The port's XY-pad timbre map (after_tpu_torch/utils/latent_map.py)
against the JAX package's, on the CPU:

- ``train_projector`` from the JAX projector's initial weights (PRNGKey
  0) and the same batch indices (``np.random.RandomState(0)``) on 200
  embeddings: after 3 Adam steps the weights and the 2-D maps within atol
  1e-5 and rtol 1e-4 (f32 on both sides; the maps read 2.5e-6 at most);
  after 300 steps the
  reconstruction losses within 2 % of each other and the maps within 0.1.
  Adam divides each update by sqrt(v) + 1e-8, so a weight whose gradient
  is at rounding level (a near-dead ReLU unit) moves by about +-lr in
  either package at random, and the trajectories part after a few steps
  (2.7e-4 in the weights after 10 steps, 0.18 after 300) while the loss
  tracks (0.5165 against 0.5134 after 300);
- ``generate_map_png`` writes the JAX package's bytes from the same 2-D
  points;
- ``save_projector`` / ``load_projector`` round trip under the flax names,
  which are the JAX projector's parameter paths;
- ``store_timbre_embeddings`` over a latent store: the pipeline's timbre
  vectors of the records it picks.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from after_tpu.utils import latent_map as jax_map
from after_tpu_torch.utils import latent_map as port_map
from after_tpu_torch.utils.from_jax import load_module

ATOL, RTOL = 1e-5, 1e-4


def _embeddings(n=200, d=6, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d) * np.linspace(0.5, 2.0, d)).astype(np.float32)


def _jax_projector(d):
    model = jax_map.SmallAutoencoder(in_dim=d)
    return model, model.init(jax.random.PRNGKey(0), jnp.zeros((2, d)))


def _trained_pair(emb, steps):
    """(port, JAX) projectors trained ``steps`` steps from the same
    initial weights and batch indices, the JAX one loaded into the port's
    module."""
    _, trained = jax_map.train_projector(emb, num_steps=steps)
    start = port_map.SmallAutoencoder(emb.shape[1])
    load_module(start, _jax_projector(emb.shape[1])[1])
    ours = port_map.train_projector(emb, num_steps=steps, device="cpu",
                                    projector=start)
    theirs = port_map.SmallAutoencoder(emb.shape[1])
    load_module(theirs, jax.tree_util.tree_map(np.asarray, trained))
    return ours.eval(), theirs.eval()


def test_train_projector_matches_jax():
    emb = _embeddings()
    x = torch.from_numpy(emb)
    ours, theirs = _trained_pair(emb, 3)
    for (name, a), b in zip(ours.state_dict().items(),
                            theirs.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    with torch.no_grad():
        np.testing.assert_allclose(ours.encode(x).numpy(),
                                   theirs.encode(x).numpy(), atol=ATOL,
                                   rtol=RTOL)
    ours, theirs = _trained_pair(emb, 300)
    with torch.no_grad():
        xy, xy_jax = ours.encode(x), theirs.encode(x)
        loss, loss_jax = (torch.mean((m(x) - x) ** 2).item()
                          for m in (ours, theirs))
    print(f"300 steps: reconstruction loss {loss:.6f} (JAX {loss_jax:.6f}), "
          f"maps within {(xy - xy_jax).abs().max().item():.3e}")
    assert abs(loss - loss_jax) <= 0.02 * loss_jax
    assert (xy - xy_jax).abs().max().item() <= 0.1
    assert xy.abs().max().item() <= 1.0


def test_train_projector_reduces_the_reconstruction_error():
    emb = _embeddings(seed=1)
    start = port_map.SmallAutoencoder(emb.shape[1])
    with torch.no_grad():
        before = torch.mean((start(torch.from_numpy(emb))
                             - torch.from_numpy(emb)) ** 2).item()
    trained = port_map.train_projector(emb, num_steps=200, device="cpu")
    with torch.no_grad():
        after = torch.mean((trained(torch.from_numpy(emb))
                            - torch.from_numpy(emb)) ** 2).item()
    assert after < before


def test_generate_map_png_writes_the_jax_bytes(tmp_path):
    rng = np.random.RandomState(2)
    points = np.tanh(rng.randn(300, 2)).astype(np.float32)
    ours = port_map.generate_map_png(points, str(tmp_path / "port.png"),
                                     bins=120, sigma=4.0)
    theirs = jax_map.generate_map_png(points, str(tmp_path / "jax.png"),
                                      bins=120, sigma=4.0)
    np.testing.assert_array_equal(ours, theirs)
    assert ((tmp_path / "port.png").read_bytes()
            == (tmp_path / "jax.png").read_bytes())
    assert port_map.png_bytes(ours) == jax_map.png_bytes(theirs)


def test_save_and_load_projector_round_trip(tmp_path):
    d = 6
    _, params = _jax_projector(d)
    projector = port_map.SmallAutoencoder(d)
    load_module(projector, jax.tree_util.tree_map(np.asarray, params))
    emb = _embeddings(50, d)
    port_map.save_projector(str(tmp_path), projector, emb)
    assert (tmp_path / "map.png").exists()
    # the flax names and layouts of the JAX projector's parameters
    saved = np.load(tmp_path / port_map.PROJECTOR_FILE)
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(saved.files) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(saved[key], value)
    loaded = port_map.load_projector(str(tmp_path), d, device="cpu")
    for a, b in zip(loaded.state_dict().values(),
                    projector.state_dict().values()):
        assert torch.equal(a, b)
    assert port_map.load_projector(str(tmp_path / "none"), d, "cpu") is None


def test_store_timbre_embeddings_are_the_pipelines_timbre(tmp_path):
    from after_tpu import config as jax_config
    from after_tpu_torch import config as port_config
    from after_tpu_torch.dataset import AudioExample, RecordWriter
    from after_tpu_torch.diffusion.pipeline import TransferPipeline
    from tests.test_diffusion import micro_config

    cfg = port_config.from_json(jax_config.to_json(micro_config()))
    pipe = TransferPipeline(cfg, device="cpu").init(0)
    rng = np.random.RandomState(3)
    records = rng.randn(7, cfg.autoencoder.z_channels, 32).astype(np.float32)
    store = str(tmp_path / "zdb")
    with RecordWriter(store) as w:
        for i, z in enumerate(records):
            e = AudioExample()
            e.put_array("z", z)
            w.put(f"{i:08d}", e.serialize())
    emb = port_map.store_timbre_embeddings(pipe, store, n_samples=5,
                                           batch_size=2)
    picked = np.linspace(0, 6, 5).astype(int)
    want = pipe.timbre(records[picked].transpose(0, 2, 1)).numpy()
    assert emb.shape == (5, cfg.zt_channels)
    np.testing.assert_allclose(emb, want, atol=1e-6, rtol=1e-6)
    assert os.path.isdir(store)
