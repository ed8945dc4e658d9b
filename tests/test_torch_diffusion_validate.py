"""The port's validation of diffusion training against the JAX functions of
after_tpu/cli/train.py: ``validate`` (mean diffusion loss over fixed
batches) and ``val_transfer_margin`` with the codec round trip, the port's
codec coming from a checkpoint through ``make_codec_coder``.  Micro config
and micro codec, batch 4, 2 Euler steps; the noise x0 and times t drawn in
JAX from the keys its functions use.  Tolerances: the loss rtol 1e-4, the
margins atol 1e-5 (differences of cosines of a few 1e-3, each a sampler and
a codec deep in f32; they agree within 1e-7 here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from after_tpu.cli import train as jax_train
from after_tpu.diffusion.trainer import DiffusionTrainState
from after_tpu.models import AudioCodec as JaxCodec
from after_tpu_torch import config as port_config
from after_tpu_torch.cli.train import (make_codec_coder, val_transfer_margin,
                                       validate)
from after_tpu_torch.models.autoencoder import AudioCodec
from after_tpu_torch.utils.checkpoint import save_checkpoint
from after_tpu_torch.utils.from_jax import load_module
from tests import torch_diffusion_common as common

NB_STEPS = 2


@pytest.fixture(scope="module")
def setup():
    cfg = common.no_dropout()
    jtr = common.identity_trainer(cfg)
    shapes = common.variable_shapes(jtr)
    variables = common.random_variables(shapes, 4)
    ema = common.random_variables(shapes, 5)["net"]["params"]
    state = DiffusionTrainState(variables, None, None, ema, 0)
    tr = common.port_trainer(cfg, variables)
    tr.load_jax(variables, ema_params=ema)
    batches = [common.batch(30 + i) for i in range(2)]
    return cfg, jtr, state, tr, batches


def test_validate_matches_jax(setup):
    cfg, jtr, state, tr, batches = setup
    theirs = jax_train.validate(jtr, state, batches)
    draws = []
    for i in range(len(batches)):
        k_noise, k_t, _ = jax.random.split(jax.random.PRNGKey(i), 3)
        draws.append((np.asarray(jax.random.normal(k_noise, (4, 32, 8))),
                      np.asarray(jax.random.uniform(k_t, (4,)))))
    ours = validate(tr, batches, draws)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)


def test_val_transfer_margin_with_the_codec_matches_jax(setup, tmp_path):
    cfg, jtr, state, tr, batches = setup
    ae = cfg.autoencoder
    jcodec = JaxCodec(ae)
    codec_vars = common.random_variables(
        jax.eval_shape(jcodec.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 32 * ae.ratio, 1))), 6)

    dec = jax.jit(lambda z: jcodec.apply(codec_vars, z,
                                         method=JaxCodec.decode))
    enc = jax.jit(lambda a: jcodec.apply(codec_vars, a,
                                         method=JaxCodec.encode))
    theirs = jax_train.val_transfer_margin(jtr, state, batches, NB_STEPS,
                                           codec=(dec, enc))

    pae = port_config.AutoEncoderConfig(**{
        k: v for k, v in vars(ae).items()})
    codec = AudioCodec(pae)
    load_module(codec, codec_vars, "codec")
    save_checkpoint(str(tmp_path), 0, {"codec_vars": codec.state_dict()},
                    port_config.ae_to_json(pae))
    coder = make_codec_coder(str(tmp_path), device="cpu")
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 32, 8)))
    ours = val_transfer_margin(tr, batches, NB_STEPS, codec=coder, x0=x0)
    assert set(ours) == set(theirs) == {"val_transfer_margin",
                                        "val_transfer_margin_audio"}
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-5, err_msg=k)
    # the EMA weights were swapped in for the sampler and back out
    for p, q in zip(tr.rf.net.parameters(), tr.ema):
        assert not bool((p == q).all())
