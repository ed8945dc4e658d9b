"""The native streaming host on a codec-only artifact, on the CPU: the micro
codec of tests/test_torch_export_codec.py with GroupNorm, non-causal (the
crossfade path), written with ``after-tpu-torch export_autoencoder
--native --device cpu`` (the export and the AOTInductor package of its
``forward``).  In file mode over 8 buffers against the port's Python host
(``ExportedCodec.forward``) within HOST_TOL x max|y|; with ``--pcm`` (mono
f32 through pipes) equal to file mode within HOST_TOL x max|y| (two runs of
the CPU packages part by rounding, tests/test_torch_stream_host.py).
"""

import numpy as np
import pytest

from after_tpu import config as jax_config
from after_tpu_torch import config as port_config
from after_tpu_torch.cli.main import main as port_main
from after_tpu_torch.models.autoencoder import AudioCodec
from after_tpu_torch.streaming.export import ExportedCodec
from after_tpu_torch.utils.checkpoint import save_checkpoint
from after_tpu_torch.utils.init import init_weights
from tests.test_diffusion import micro_config
from tests.torch_stream_host_common import (close, host_line, read_wav,
                                            run_host, write_wav)

N = 8


@pytest.fixture(scope="module")
def codec_artifact(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_codec")
    cfg = port_config.ae_from_json(jax_config.ae_to_json(
        jax_config.with_overrides(micro_config(), {
            "autoencoder.causal": False,
            "autoencoder.use_norm": True}).autoencoder))
    codec = AudioCodec(cfg)
    init_weights(codec, 5)
    save_checkpoint(str(root / "run"), 0, {"codec_vars": codec.state_dict()},
                    config_json=port_config.ae_to_json(cfg))
    art = str(root / "art")
    assert port_main(["export_autoencoder", "--model_path", str(root / "run"),
                      "--out", art, "--chunk_size", "4", "--device", "cpu",
                      "--native"]) == 0
    A = 4 * cfg.ratio
    x = (0.3 * np.random.RandomState(3).randn(N * A)).astype(np.float32)
    write_wav(root / "in.wav", x)
    proc = run_host([art, root / "in.wav", root / "out.wav"])
    return art, root, x, A, proc, read_wav(root / "out.wav")


def test_codec_host_matches_the_python_host(codec_artifact):
    art, _, x, A, proc, y = codec_artifact
    assert host_line(proc, "streaming ").startswith(f"{N} chunks")
    host = ExportedCodec(art, "cpu")
    ref = np.concatenate([host.forward(x[None, i * A:(i + 1) * A, None])
                          .numpy().ravel() for i in range(N)])
    close(f"native host vs ExportedCodec.forward, {N} buffers", y, ref)


def test_codec_pcm_equals_file_mode(codec_artifact):
    art, _, x, A, _, y = codec_artifact
    proc = run_host([art, "--pcm"], stdin=x.astype("<f4").tobytes())
    out = np.frombuffer(proc.stdout, "<f4")
    assert "live PCM mode: 1ch" in proc.stderr.decode()
    close("--pcm vs file mode", out, y)
