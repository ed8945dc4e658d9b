"""The native streaming host on a Denoiser v1 artifact, on the CPU: the
micro crossfade config of tests/test_torch_export.py with
``denoiser.arch`` "v1" and ``v1_cross_attn_causal`` (the form a v1 model
streams in), exported at nb_steps 2 and packaged for the CPU.  v1 uses the
rectified flow's step scalars; its state holds a self-attention and a
cross-attention KV cache a layer (DenoiserV2 one).  The host is held to
the port's Python host (``ExportedStreamer``) within HOST_TOL x max|y| over
6 buffers at nb_steps 4 and with nb_steps and the guidances changing every
buffer.
"""

import pytest

from after_tpu_torch import config as port_config
from tests.test_torch_export import crossfade_config
from tests.torch_stream_host_common import CHANGING, a2a_setup, check_a2a

V1 = {"denoiser.arch": "v1", "denoiser.v1_cross_attn_causal": True}


@pytest.fixture(scope="module")
def v1(tmp_path_factory):
    cfg = port_config.with_overrides(crossfade_config(), V1)
    return a2a_setup(cfg, tmp_path_factory.mktemp("host_v1"))


def test_v1_manifest(v1):
    paths = v1["manifest"]["state_paths"]
    assert v1["manifest"]["config"]["denoiser"]["arch"] == "v1"
    assert any("/cross_attn/k" in p for p in paths)
    assert any("/self_attn/k" in p for p in paths)


def test_v1_host_matches_the_python_host(v1):
    check_a2a(v1, "v1 nb_steps 4", nb_steps=4, guidance_timbre=2.0,
              guidance_structure=0.5)


def test_v1_host_with_changing_attributes(v1):
    check_a2a(v1, "v1 changing", attributes=CHANGING)
