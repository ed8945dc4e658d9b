"""What the parity tests of the alternative diffusion models share
(tests/test_torch_{edm,denoiser_v1,unet1d}.py): a micro transfer of the
port's ``TransferPipeline`` against the JAX pipeline's pieces, on a config
of tests/test_torch_pipeline.py with the model's overrides, every JAX
variable drawn from a seed (``random_variables`` of
tests/torch_diffusion_common.py).

Tolerance: atol 1e-3 on the waveform, tests/test_torch_pipeline.py's (a
codec, two encoders and 3 sampler steps deep, f32 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np

from after_tpu import config as jax_config
from after_tpu.diffusion import TransferPipeline as JaxPipeline
from after_tpu_torch import config as port_config
from after_tpu_torch.diffusion.pipeline import TransferPipeline
from tests import torch_threads_common  # noqa: F401  (xdist workers' threads)
from tests.test_torch_pipeline import N_SIGNAL, OVERRIDES
from tests.torch_diffusion_common import random_variables

TRANSFER_TOL = dict(atol=1e-3)


def check_transfer(overrides, nb_steps=3, guidances=(2.0, 1.5),
                   prepare=None):
    """The port's ``transfer`` against JAX's encode -> structure -> timbre
    -> diffuse(x0) -> decode, the same weights and x0; returns the port's
    pipeline and output.  ``prepare(pipe)`` runs on the port's pipeline
    before its transfer (a noise codec keeps the JAX decode's draw)."""
    cfg = jax_config.get_config("base", **OVERRIDES, **overrides).resolved(
        in_size=8, n_signal=N_SIGNAL)
    jpipe = JaxPipeline(cfg)
    # every variable drawn from a seed over the JAX tree (eval_shape: no
    # compile of the pipeline's init)
    variables = random_variables(jax.eval_shape(
        lambda k: jpipe.init(k, 1), jax.random.PRNGKey(0)), 1)
    rng = np.random.RandomState(2)
    n = N_SIGNAL * cfg.autoencoder.ratio
    a = (0.3 * rng.randn(1, n, 1)).astype(np.float32)
    b = (0.3 * rng.randn(1, n, 1)).astype(np.float32)
    x0 = rng.randn(1, N_SIGNAL, 8).astype(np.float32)

    z_s = jpipe.encode(variables, jnp.asarray(a))
    z_t = jpipe.encode(variables, jnp.asarray(b))
    time_cond = jpipe.structure(variables, z_s)
    cond = jpipe.timbre(variables, z_t)
    z_out = jpipe.diffuse(variables, jnp.asarray(x0), cond, time_cond,
                          nb_steps, *guidances)
    y = np.asarray(jpipe.decode(variables, z_out))

    pcfg = port_config.from_json(jax_config.to_json(cfg))
    pipe = TransferPipeline(pcfg, device="cpu").load_jax(variables)
    if prepare is not None:
        prepare(pipe)
    py = pipe.transfer(a, b, nb_steps=nb_steps, guidance_timbre=guidances[0],
                       guidance_structure=guidances[1], x0=x0)
    assert py.shape == y.shape and np.isfinite(py.numpy()).all()
    np.testing.assert_allclose(py.numpy(), y, **TRANSFER_TOL)
    return pipe, py
