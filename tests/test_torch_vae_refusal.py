"""C11: VAE encoders at inference, refused by both packages.

A VAE encoder samples its codes.  The JAX package draws that sample from
a "sample" rng which none of its inference calls gives (the pipeline's
``timbre``, ``structure`` and ``transfer``, the streamer, export), so flax
raises ``InvalidRngError`` at the first such call; the port, whose sample
noise is an argument, raises a ValueError that names it at the same calls:
the pipeline's entry points, a streamer's first state and export.  No
mean-only inference is made up.  Micro pipeline of
tests/test_torch_pipeline.py, on the CPU; the JAX calls are traced until
they raise (nothing is compiled).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from after_tpu import config as jax_config
from after_tpu.diffusion import TransferPipeline as JaxPipeline
from after_tpu_torch import config as port_config
from after_tpu_torch.diffusion.pipeline import TransferPipeline
from after_tpu_torch.streaming.export import export_streamer
from after_tpu_torch.streaming.streamer import Streamer
from tests import torch_threads_common  # noqa: F401  (xdist workers' threads)
from tests.test_torch_pipeline import N_SIGNAL, OVERRIDES
from tests.torch_diffusion_common import random_variables

VAE = {"timbre": {"encoder.regularisation": "vae"},
       "structure": {"encoder_time.vae_regularisation": True,
                     "encoder_time.ac_regularisation": False}}
MESSAGE = "vae regularisation"


def _configs(which):
    cfg = jax_config.get_config("base", **OVERRIDES, **VAE[which]).resolved(
        in_size=8, n_signal=N_SIGNAL)
    return cfg, port_config.from_json(jax_config.to_json(cfg))


@pytest.mark.parametrize("which", ["timbre", "structure"])
def test_jax_refuses_vae_inference(which):
    cfg, _ = _configs(which)
    jpipe = JaxPipeline(cfg)
    variables = random_variables(jax.eval_shape(
        lambda k: jpipe.init(k, 1), jax.random.PRNGKey(0)), 1)
    z = jnp.zeros((1, N_SIGNAL, cfg.autoencoder.z_channels))
    call = jpipe.timbre if which == "timbre" else jpipe.structure
    with pytest.raises(flax.errors.InvalidRngError, match="sample"):
        call(variables, z)


@pytest.mark.parametrize("which", ["timbre", "structure"])
def test_port_refuses_vae_inference(which, tmp_path):
    _, cfg = _configs(which)
    pipe = TransferPipeline(cfg, device="cpu").init(0)
    z = np.zeros((1, N_SIGNAL, cfg.autoencoder.z_channels), np.float32)
    call = pipe.timbre if which == "timbre" else pipe.structure
    with pytest.raises(ValueError, match=MESSAGE):
        call(z)
    audio = np.zeros((1, N_SIGNAL * cfg.autoencoder.ratio, 1), np.float32)
    with pytest.raises(ValueError, match=MESSAGE):
        pipe.transfer(audio, audio, nb_steps=1)
    streamer = Streamer(cfg, device="cpu", pipeline=pipe)
    chunk = np.zeros((1, streamer.audio_chunk, 1), np.float32)
    with pytest.raises(ValueError, match=MESSAGE):
        streamer.forward(streamer.init_state(1), chunk, chunk, 1)
    with pytest.raises(ValueError, match=MESSAGE):
        export_streamer(streamer, str(tmp_path / "artifact"))
