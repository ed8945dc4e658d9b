"""The native streaming host on an EDM artifact, on the CPU: the micro
crossfade config of tests/test_torch_export.py with ``diffusion_type``
"edm", exported at nb_steps 2 and packaged for the CPU.  The host makes
EDM's step scalars itself (the Karras ladder in f32, the first step's noise
scale, the guidance mix: csrc/stream_host.cc, ``StreamScalars``), so it is
held to the port's Python host (``ExportedStreamer``, whose scalars are
``diffusion/edm.py:stream_scalars``, held to the JAX sampler by
tests/test_torch_edm.py) over 6 buffers, within EDM_HOST_TOL x max|y|
(tests/torch_stream_host_common.py: the first step's cancellation from
sigma_max turns the packages' rounding into 2e-5 x max|y|, where the
rectified flow's stays near 1e-6): at
nb_steps 1 (a one-step ladder, frac 0), at nb_steps 4 with both
guidances set, and with nb_steps and the guidances changing every buffer
(AFTER_NATIVE_CTRL), the ladder made anew at each change.  A
``diffusion_type`` the host does not know exits non-zero naming it.

Package sharing (``streaming.native.package_artifact(share_from=)``): a
rectified flow's artifact with the same codec and encoders (the same
seed) has the EDM artifact's structure, timbre and decode programs and
not its step; packaged with ``share_from`` the EDM artifact, only its step
is compiled, the others copied from the EDM artifact's packages, and the
host plays it against the Python host within HOST_TOL x max|y|.
"""

import dataclasses

import pytest

from after_tpu_torch.diffusion.edm import stream_scalars
from after_tpu_torch.diffusion.pipeline import TransferPipeline
from after_tpu_torch.streaming.export import export_streamer
from after_tpu_torch.streaming.native import (HOST_STAGES, package_artifact,
                                              same_program)
from after_tpu_torch.streaming.streamer import Streamer
from tests.test_torch_export import crossfade_config
from tests.torch_stream_host_common import (CHANGING, EDM_HOST_TOL,
                                            a2a_setup, check_a2a, run_host)


@pytest.fixture(scope="module")
def edm(tmp_path_factory):
    cfg = dataclasses.replace(crossfade_config(), diffusion_type="edm")
    return a2a_setup(cfg, tmp_path_factory.mktemp("host_edm"))


def test_edm_manifest(edm):
    cfg = edm["manifest"]["config"]
    assert cfg["diffusion_type"] == "edm" and cfg["edm"]["rho"] == 7.0
    assert edm["manifest"]["native_cpu"]
    # the vector the host makes: 2S + 3 values
    S = edm["manifest"]["attributes"]["nb_steps"]["max"]
    assert stream_scalars(crossfade_config().edm, S, 4)[1].shape == (
        2 * S + 3,)


@pytest.mark.parametrize("nb_steps,gt,gs", [(1, 1.0, 1.0), (4, 2.0, 0.5)])
def test_edm_host_matches_the_python_host(edm, nb_steps, gt, gs):
    check_a2a(edm, f"edm nb_steps {nb_steps}", EDM_HOST_TOL,
              nb_steps=nb_steps, guidance_timbre=gt, guidance_structure=gs)


def test_edm_host_with_changing_attributes(edm):
    proc = check_a2a(edm, "edm changing", EDM_HOST_TOL, attributes=CHANGING)
    assert "set nb_steps = 16" in proc.stderr.decode()


def test_host_refuses_an_unknown_diffusion_type(tmp_path):
    """An artifact whose manifest's config names a ``diffusion_type`` that
    is neither "rectified" nor "edm": the host exits non-zero naming it
    before it reads anything else."""
    (tmp_path / "manifest.json").write_text(
        '{"format_version": 2, "chunk_size": 4, "config": '
        '{"diffusion_type": "vdiffusion"}}')
    proc = run_host([tmp_path, tmp_path / "s.wav", tmp_path / "t.wav",
                     tmp_path / "o.wav"], check=False)
    err = proc.stderr.decode()
    assert proc.returncode != 0
    assert 'diffusion_type "vdiffusion"' in err, err
    assert '"rectified" and "edm"' in err, err
    assert not (tmp_path / "o.wav").exists()


def test_a_rectified_artifact_shares_the_edm_stages(edm, tmp_path):
    cfg = crossfade_config()
    pipe = TransferPipeline(cfg, device="cpu").init(3)
    art = export_streamer(Streamer(cfg, chunk_size=4, device="cpu",
                                   pipeline=pipe), str(tmp_path / "rf"),
                          nb_steps=2)
    same = {s_: same_program(f"{art}/{s_}.pt2", f"{edm['art']}/{s_}.pt2")
            for s_ in HOST_STAGES["a2a"]}
    assert same == {"structure": True, "timbre": True, "step": False,
                    "decode": True}
    done = package_artifact(art, "cpu", share_from=edm["art"])
    assert [s_ for s_, v in done.items()
            if "shared_from" not in v and s_ != "total"] == ["step"]
    rf = dict(edm, art=art)
    check_a2a(rf, "rectified sharing edm's packages", nb_steps=2)
