"""The pieces around the port's diffusion trainer: the training forms of
BatchNorm, FSQ and dropout against flax and the JAX FSQ, the collate
against the JAX one, the device latent bank's crops and distributions,
checkpoints and the partial-load mask against the JAX function, and what
the port refuses.  Tolerances: 1e-6 on single layers, exact where the
arithmetic is the same (collate, masks)."""

import dataclasses
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu.dataset.collate import make_collate_fn as jax_collate
from after_tpu.ops.fsq import FSQ as JaxFSQ
from after_tpu.utils.checkpoint import filter_partial_load as jax_filter
from after_tpu_torch import config as port_config
from after_tpu_torch.cli.train import make_codec_coder
from after_tpu_torch.dataset import DeviceLatentBank, make_collate_fn
from after_tpu_torch.diffusion.trainer import DiffusionTrainer
from after_tpu_torch.models.denoiser import Denoiser
from after_tpu_torch.models.encoder import Encoder1D
from after_tpu_torch.ops.fsq import FSQ
from after_tpu_torch.ops.norms import BatchNorm
from after_tpu_torch.ops.train_mode import TrainMode
from after_tpu_torch.utils.checkpoint import (available_steps, checkpoint_keys,
                                              filter_partial_load,
                                              restore_checkpoint,
                                              save_checkpoint,
                                              shapes_compatible)
from tests import torch_diffusion_common as common

N_SIGNAL = 16


def test_batchnorm_training_form_matches_flax():
    """Batch statistics over (B, T), flax's E[x^2] - E[x]^2 variance, the
    output and, once committed, the running values 0.9 old + 0.1 batch."""
    rng = np.random.RandomState(0)
    x = (2.0 + rng.randn(3, 10, 5)).astype(np.float32)
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
                            "bias": rng.randn(5).astype(np.float32)},
                 "batch_stats": {"mean": rng.randn(5).astype(np.float32),
                                 "var": rng.uniform(0.5, 1.5, 5).astype(
                                     np.float32)}}
    y, upd = mod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(
            variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(
            variables["batch_stats"]["var"]))
    before = bn.running_mean.clone()
    train = TrainMode()
    py = bn(torch.from_numpy(x), train)
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(y), atol=1e-6)
    assert torch.equal(bn.running_mean, before)       # nothing written yet
    train.commit()
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, ours).numpy(),
                                   np.asarray(upd["batch_stats"][theirs]),
                                   rtol=0, atol=1e-6)


def test_fsq_noise_dropout_matches_jax():
    """Values and straight-through gradients, the draws taken from the keys
    the JAX FSQ splits."""
    levels, p = (3, 5, 4, 8), 0.5
    rng = np.random.RandomState(1)
    z = (1.5 * rng.randn(6, 7, 4)).astype(np.float32)
    w = rng.randn(6, 7, 4).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jfsq = JaxFSQ(levels, p)
    y, g = jax.value_and_grad(
        lambda a: jnp.sum(jfsq.quantize(a, key) * w))(jnp.asarray(z))
    k1, k2, k3 = jax.random.split(key, 3)
    draws = tuple(torch.from_numpy(np.array(jax.random.uniform(k, s)))
                  for k, s in ((k1, (6, 1, 1)), (k2, (6, 1, 1)), (k3, z.shape)))
    assert 0 < int((draws[0] < p).sum()) < 6
    zt = torch.from_numpy(z).requires_grad_()
    py = torch.sum(FSQ(levels, p).quantize(zt, draws) * torch.from_numpy(w))
    py.backward()
    np.testing.assert_allclose(float(py.detach()), float(y), rtol=1e-6)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(g), atol=1e-6)


def _denoiser_cfg(dropout):
    return port_config.DenoiserConfig(n_channels=4, seq_len=8, embed_dim=32,
                                      head_dim=16, rotary_dim=8,
                                      noise_embed_dims=8, n_layers=1,
                                      mlp_multiplier=2, dropout=dropout)


def test_dropout_in_training_and_not_at_inference():
    """Dropout (denoiser attention and MLP, Encoder1D blocks) changes a
    training forward, draws its masks from the generator it is given, and
    leaves inference alone."""
    torch.manual_seed(0)
    net = Denoiser(_denoiser_cfg(0.5), cond_in=3, tcond_in=12)
    enc = Encoder1D(port_config.Encoder1DConfig(in_size=4, channels=(8, 12),
                                                dropout=0.5))
    from after_tpu_torch.utils.init import init_weights
    init_weights(net, 0)
    init_weights(enc, 1)
    x, t = torch.randn(2, 8, 4), torch.rand(2)
    cond, tcond = torch.randn(2, 3), torch.randn(2, 8, 12)

    def run(train):
        with torch.no_grad():
            return (net(x, t, cond, tcond, train=train),
                    enc(x, train=train)[0])

    def mode(seed):
        return TrainMode(torch.Generator().manual_seed(seed))

    inference = run(None)
    for a, b in zip(inference, run(None)):
        assert torch.equal(a, b)
    first, again, other = run(mode(1)), run(mode(1)), run(mode(2))
    for i in range(2):
        assert torch.equal(first[i], again[i])
        assert not torch.equal(first[i], other[i])
    assert not torch.equal(first[0], inference[0])
    # at rate 0 a training forward of the denoiser is its inference
    net0 = Denoiser(_denoiser_cfg(0.0), cond_in=3, tcond_in=12)
    net0.load_state_dict(net.state_dict())
    with torch.no_grad():
        assert torch.equal(net0(x, t, cond, tcond, train=mode(1)),
                           net0(x, t, cond, tcond))


def _records(n=4, t=64, c=6, aug=None, aug_t=None, seed=0):
    """Channel 0 carries record id * 1000 + frame (negated in augments), so
    a crop's source is recoverable from its values."""
    rng = np.random.RandomState(seed)
    items = []
    for i in range(n):
        ti = t + 7 * i
        z = rng.randn(c, ti).astype(np.float32)
        z[0] = 1000.0 * i + np.arange(ti)
        item = {"z": z}
        if aug is not None:
            ta = ti if aug_t is None else aug_t
            a = rng.randn(c, ta).astype(np.float32)
            a[0] = -(1000.0 * i + np.arange(ta)) - 1
            item[aug] = a
        items.append(item)
    return items


class _Roll:
    """A MIDI stand-in: a piano roll that depends on the times asked."""

    def __init__(self, k):
        self.k = k

    def get_piano_roll(self, times):
        return np.outer(np.arange(128) % (self.k + 2),
                        np.cos(self.k * times)) * 127.0


@pytest.mark.parametrize("kw", [
    {}, {"timbre_limit": 0.5},
    {"timbre_augmentation_keys": ("z_aug_a", "z_aug_b")},
    {"structure_type": "midi"}])
def test_collate_matches_jax(kw):
    items = _records(n=5, aug="z_aug_a")
    if "structure_type" in kw:
        for i, it in enumerate(items):
            it["midi"] = _Roll(i)
    ours, theirs = (f(N_SIGNAL, seed=3, **kw)
                    for f in (make_collate_fn, jax_collate))
    for start in range(3):
        batch = items[start:start + 3]
        a, b = ours(batch), theirs(batch)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert (a["x_time_cond"] is a["x"]) == ("structure_type" not in kw)


def _source(crop):
    """(record, start, slot) of a crop of _records, checking that its
    frames are contiguous."""
    marks = crop[:, 0]
    aug = marks[0] < 0
    v = -marks - 1 if aug else marks
    assert np.array_equal(v, v[0] + np.arange(len(v)))
    return int(v[0] // 1000), int(v[0] % 1000), int(aug)


def test_bank_crops_lie_within_their_records():
    items = _records(n=4, aug="z_aug", aug_t=None)
    items[2]["z_aug"] = items[2]["z_aug"][:, :N_SIGNAL]      # too short
    bank = DeviceLatentBank(items, N_SIGNAL, aug_keys=("z_aug",),
                            device="cpu")
    gen = torch.Generator().manual_seed(0)
    seen_aug = set()
    for _ in range(20):
        b = bank.sample(8, gen)
        assert b["x_time_cond"] is b["x"]
        x, xc = b["x"].numpy(), b["x_cond"].numpy()
        assert x.shape == xc.shape == (8, N_SIGNAL, 6)
        for row, crow in zip(x, xc):
            rec, start, slot = _source(row)
            assert slot == 0 and start + N_SIGNAL <= items[rec]["z"].shape[1]
            crec, cstart, cslot = _source(crow)
            assert crec == rec
            source = items[rec]["z_aug" if cslot else "z"]
            assert cstart + N_SIGNAL <= source.shape[1]
            np.testing.assert_array_equal(crow.T,
                                          source[:, cstart:cstart + N_SIGNAL])
            if cslot:
                seen_aug.add(rec)
    assert 2 not in seen_aug and seen_aug == {0, 1, 3}


def test_bank_distributions():
    """Record choice follows the weights, crop starts are uniform over
    [0, length - n_signal), and timbre_limit windows the x_cond crop."""
    items = _records(n=3, t=48)
    weights = np.array([1.0, 2.0, 5.0])
    bank = DeviceLatentBank(items, N_SIGNAL, weights=weights,
                            timbre_limit=0.5, device="cpu")
    gen = torch.Generator().manual_seed(1)
    recs, starts, gaps = [], {0: [], 1: [], 2: []}, []
    for _ in range(40):
        b = bank.sample(100, gen)
        for row, crow in zip(b["x"].numpy(), b["x_cond"].numpy()):
            rec, start, _ = _source(row)
            crec, cstart, _ = _source(crow)
            assert crec == rec
            recs.append(rec)
            starts[rec].append(start)
            gaps.append(cstart - start)
    freq = np.bincount(recs, minlength=3) / len(recs)
    np.testing.assert_allclose(freq, weights / weights.sum(), atol=0.03)
    for rec, s in starts.items():
        span = items[rec]["z"].shape[1] - N_SIGNAL
        assert min(s) == 0 and max(s) == span - 1
        assert abs(np.mean(s) - (span - 1) / 2) < 0.1 * span
    nmax = int(N_SIGNAL * 0.5)
    assert min(gaps) >= -nmax and max(gaps) < nmax


def _micro_trainer(**overrides):
    cfg = common.port_cfg(common.no_dropout(**overrides))
    return DiffusionTrainer(cfg, device="cpu").init(0)


def _equal_trees(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal_trees, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_checkpoint_round_trip(tmp_path):
    tr = _micro_trainer(**{"train.timbre_warmup": 0})
    tr.fit(iter([common.batch(i) for i in range(3)]), max_steps=3)
    cfg_json = port_config.to_json(tr.cfg)
    save_checkpoint(str(tmp_path), tr.step, tr.state_tree(), cfg_json)
    assert available_steps(str(tmp_path)) == [3]
    assert set(checkpoint_keys(str(tmp_path))) == {
        "variables", "ema_params", "opt_state", "cls_opt_state", "step"}
    assert (tmp_path / "config.json").read_text() == cfg_json
    restored = restore_checkpoint(str(tmp_path))
    assert _equal_trees(restored, tr.state_tree())

    fresh = _micro_trainer(**{"train.timbre_warmup": 0})
    fresh.load_state_tree(restored)
    assert _equal_trees(fresh.state_tree(), tr.state_tree())
    # a restart that keeps the new timbre encoder
    other = DiffusionTrainer(tr.cfg, device="cpu").init(5)
    enc = {k: v.clone() for k, v in other.rf.encoder.state_dict().items()}
    other.load_state_tree(restored, load_encoders=(False, True, True))
    assert _equal_trees(other.rf.encoder.state_dict(), enc)
    assert _equal_trees(other.rf.net.state_dict(), tr.rf.net.state_dict())
    assert other.step == 3


def test_filter_partial_load_matches_jax():
    rng = np.random.RandomState(2)

    def tree(*shapes):
        return {f"p{i}": rng.randn(*s).astype(np.float32)
                for i, s in enumerate(shapes)}

    current = {"net": tree((3, 4), (4,)), "encoder": tree((2, 2)),
               "encoder_time": tree((5,)), "classifier": tree((6, 2))}
    restored = {"net": tree((3, 4), (4,)), "encoder": tree((2, 2)),
                "encoder_time": tree((7,)),       # another config
                "stale": tree((1,))}              # only in the checkpoint
    for mask in ((True, True, True), (False, True, True),
                 (True, False, False)):
        ours = filter_partial_load(restored, current, mask)
        theirs = jax_filter(restored, current, mask)
        assert ours.keys() == theirs.keys() == current.keys()
        for k in ours:
            assert ours[k] is theirs[k], (mask, k)
    assert shapes_compatible(current["net"], restored["net"])
    assert not shapes_compatible(current["encoder_time"],
                                 restored["encoder_time"])


@pytest.mark.parametrize("override", [
    {"encoder_time.vae_regularisation": True},
    {"encoder.regularisation": "vae"}])
def test_what_is_not_ported_raises(override):
    """The encoders' vae modes, which the trainer refused until they were
    ported, build; a VAE encoder run without its sample noise raises (C11:
    the JAX package's raises InvalidRngError there)."""
    cfg = port_config.with_overrides(common.port_cfg(common.no_dropout()),
                                     override)
    tr = DiffusionTrainer(cfg, device="cpu")
    encoder = (tr.rf.encoder_time if "encoder_time.vae_regularisation"
               in override else tr.rf.encoder)
    with pytest.raises(ValueError, match="vae regularisation"):
        encoder(torch.zeros(common.B, common.T, common.C))


def test_the_trainer_builds_edm():
    """diffusion_type="edm", which the trainer refused until EDM was
    ported, builds an EDM model whose training step draws ln sigma."""
    from after_tpu_torch.diffusion.edm import EDM
    cfg = port_config.with_overrides(common.port_cfg(common.no_dropout()),
                                     {"diffusion_type": "edm"})
    tr = DiffusionTrainer(cfg, device="cpu")
    assert isinstance(tr.rf, EDM) and tr.rf.LEVEL_DRAW == "sigma_normal"


def test_fit_refuses_a_mesh_and_no_card_raises(monkeypatch):
    """The trainer, the bank and the codec coder run on the card unless
    given device="cpu", and raise without one."""
    tr = _micro_trainer()
    with pytest.raises(NotImplementedError):
        tr.fit(iter([common.batch(0)]), max_steps=1, mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionTrainer(tr.cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceLatentBank(_records(), N_SIGNAL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_codec_coder("unused")


def test_config_json_of_the_trainer_is_shared():
    from after_tpu import config as jax_config
    for names in (("base",), ("base", "cycle"), ("tiny",)):
        ours = dataclasses.asdict(port_config.get_config(*names).train)
        theirs = dataclasses.asdict(jax_config.get_config(*names).train)
        assert json.dumps(ours) == json.dumps(theirs)
