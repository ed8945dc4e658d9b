"""The native streaming host on a noise codec's artifact, on the CPU: the
micro crossfade config of tests/test_torch_export.py with
``autoencoder.use_noise`` (the decoder's NoiseGenerator), exported at
nb_steps 2 and packaged for the CPU.  The decode program keeps the
decoder's fixed uniform draw as a constant (tests/test_torch_noise_codec.py)
and its AOTInductor package carries it: the host is held to the port's
Python host (``ExportedStreamer``) within HOST_TOL x max|y| over 6 buffers
at nb_steps 2 and with nb_steps and the guidances changing every buffer.
"""

import dataclasses

import pytest

from tests.test_torch_export import crossfade_config
from tests.torch_stream_host_common import CHANGING, a2a_setup, check_a2a


@pytest.fixture(scope="module")
def noise(tmp_path_factory):
    base = crossfade_config()
    cfg = dataclasses.replace(base, autoencoder=dataclasses.replace(
        base.autoencoder, use_noise=True))
    return a2a_setup(cfg, tmp_path_factory.mktemp("host_noise"))


def test_noise_host_matches_the_python_host(noise):
    assert noise["manifest"]["config"]["autoencoder"]["use_noise"]
    check_a2a(noise, "noise nb_steps 2", nb_steps=2, guidance_timbre=1.5)


def test_noise_host_with_changing_attributes(noise):
    check_a2a(noise, "noise changing", attributes=CHANGING)
