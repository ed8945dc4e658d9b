"""The port's training commands on the CPU at micro size
(``after_tpu_torch.cli.main``: ``train_autoencoder`` and ``train``).

- each trains a few steps with ``--device cpu`` from a synthetic store,
  validates, writes checkpoints, ``config.json``, ``metrics.jsonl`` and
  audio, and restarts at the saved step with the weights, optimizer states
  and step it saved;
- ``config.json`` is the text the JAX package's command writes for the same
  arguments;
- the codec command's checkpoint feeds ``make_codec_coder`` and the
  diffusion command's ``--emb_model_path``;
- the metrics logger copies to the host once a flush, never once a step;
- the dispatcher reaches every subcommand of the JAX package's.

The micro overrides are those of tests/test_cli.py; tensorboard, which
imports TensorFlow here, is kept out of the commands' runs.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from after_tpu_torch.cli import main as cli
from after_tpu_torch.dataset import AudioExample, RecordWriter
from after_tpu_torch.utils.checkpoint import (available_steps,
                                              restore_checkpoint)

AE_MICRO = [
    "--override", "pqmf_bands=4", "--override", "z_channels=8",
    "--override", "base_channels=8", "--override", "multipliers=[1,2,2]",
    "--override", "factors=[2,2]", "--override", "dilations=[1,3]",
    "--override", "num_blocks_per_stage=1",
    "--override", "train.steps_valid=2", "--override", "train.steps_save=2",
    "--override", "train.warmup_steps=1",
    "--override", "train.update_discriminator_every=3",
    "--override", "train.stft_fft_sizes=[256,64]",
    "--override", "train.stft_hop_sizes=[64,16]",
    "--override", "train.stft_win_lengths=[256,64]",
]
DIFF_MICRO = [
    "--override", "denoiser.embed_dim=64", "--override", "denoiser.n_layers=1",
    "--override", "denoiser.noise_embed_dims=16",
    "--override", "denoiser.mlp_multiplier=2",
    "--override", "encoder.channels=[8,8,8,16]",
    "--override", "encoder_time.channels=[8,8,8,8,12]",
    "--override", "classifier.channels=[8,8,8,8,6]",
    "--override", "train.n_signal=32",
    "--override", "train.steps_save=2", "--override", "train.steps_valid=2",
    "--override", "train.timbre_warmup=1",
]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _wave_store(path):
    rng = np.random.RandomState(0)
    with RecordWriter(str(path)) as w:
        for i in range(10):
            ae = AudioExample()
            t = np.arange(16384) / 44100.0
            x = 0.4 * np.sin(2 * np.pi * (220 + 55 * i) * t)
            x += 0.01 * rng.randn(len(x))
            ae.put_array("waveform", x.astype(np.float32), dtype=np.int16)
            ae.put_metadata({"name": f"rec{i}"})
            w.put(f"{i:08d}", ae.serialize())


def _z_store(path, channels=8):
    rng = np.random.RandomState(0)
    with RecordWriter(str(path)) as w:
        for i in range(8):
            ae = AudioExample()
            ae.put_array("z", rng.randn(channels, 200).astype(np.float32))
            ae.put_metadata({"name": f"rec{i}"})
            w.put(f"{i:08d}", ae.serialize())


def _ae_args(root, steps, *extra):
    return ["train_autoencoder", "--name", "ae", "--db_path",
            str(root / "wavedb"), "--out_path", str(root / "runs"),
            "--batch_size", "2", "--num_signal", "4096", "--max_steps",
            str(steps), *AE_MICRO, *extra]


def _diff_args(root, steps, *extra):
    return ["train", "--name", "r", "--db_path", str(root / "zdb"),
            "--out_path", str(root / "runs"), "--config", "tiny",
            "--batch_size", "2", "--max_steps", str(steps), *DIFF_MICRO,
            *extra]


def _entries(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def codec_run(tmp_path_factory):
    """A codec run of 3 steps (two warm-up, one GAN generator step; a
    checkpoint and validation at 2) and its restart to 4 (a discriminator
    step)."""
    root = tmp_path_factory.mktemp("cli")
    _wave_store(root / "wavedb")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        assert cli.main(_ae_args(root, 3, "--device", "cpu")) == 0
        run = root / "runs" / "ae"
        saved = restore_checkpoint(str(run), 3)
        # a restart that runs no step saves what it loaded
        assert cli.main(_ae_args(root, 3, "--device", "cpu",
                                 "--restart", "3")) == 0
        resaved = restore_checkpoint(str(run), 3)
        assert cli.main(_ae_args(root, 4, "--device", "cpu",
                                 "--restart", "0")) == 0
    return root, saved, resaved


def test_codec_cli_trains_validates_checkpoints_and_restarts(codec_run,
                                                              capsys):
    root, saved, resaved = codec_run
    run = str(root / "runs" / "ae")
    assert available_steps(run) == [2, 3, 4]
    assert saved["step"] == 3
    assert set(saved) == {"codec_vars", "disc_vars", "opt_state",
                          "disc_opt_state", "step"}
    assert saved["opt_state"]["count"] == 3          # generator updates
    assert saved["disc_opt_state"]["count"] == 0
    _equal_trees(saved, resaved)
    last = restore_checkpoint(run, 4)
    assert last["step"] == 4 and last["disc_opt_state"]["count"] == 1
    assert last["opt_state"]["count"] == 3
    entries = _entries(run)
    assert [e["step"] for e in entries if "val_mrstft" in e] == [2, 4]
    assert all(np.isfinite(v) for e in entries for v in e.values())
    assert any("discriminator" in e for e in entries)
    assert sorted(os.listdir(os.path.join(run, "audio"))) == [
        "validation_audio_2.wav", "validation_audio_4.wav"]


def test_codec_checkpoint_feeds_make_codec_coder(codec_run):
    from after_tpu_torch.cli.train import make_codec_coder
    root, _, _ = codec_run
    decode, encode = make_codec_coder(str(root / "runs" / "ae"), "cpu")
    z = encode(np.zeros((1, 4096, 1), np.float32))
    assert tuple(z.shape) == (1, 4096 // 16, 8)
    assert decode(z).shape[1] >= 4096


def test_diffusion_cli_decodes_through_the_codec_run(codec_run, capsys):
    root, _, _ = codec_run
    _z_store(root / "zdb")
    codec = ["--emb_model_path", str(root / "runs" / "ae")]
    assert cli.main(_diff_args(root, 3, "--device", "cpu", *codec)) == 0
    run = str(root / "runs" / "r")
    saved = restore_checkpoint(run, 3)
    assert set(saved) == {"variables", "ema_params", "opt_state",
                          "cls_opt_state", "step"}
    assert cli.main(_diff_args(root, 3, "--device", "cpu",
                               "--restart", "3")) == 0
    out = capsys.readouterr().out
    assert "restarting from step 3" in out
    _equal_trees(saved, restore_checkpoint(run, 3))
    assert cli.main(_diff_args(root, 4, "--device", "cpu", "--restart", "0",
                               *codec)) == 0
    assert available_steps(run) == [2, 3, 4]
    assert restore_checkpoint(run, 4)["step"] == 4
    entries = _entries(run)
    val = [e for e in entries if "val_diffusion_loss" in e]
    # validated at 2 and 4; as in the JAX command, the diffusion logger
    # writes them at its next flush (the end of each run: 3 and 4)
    assert [e["step"] for e in val] == [3, 4]
    assert all("val_transfer_margin_audio" in e for e in val)
    assert any("classifier_loss" in e for e in entries)
    names = sorted(os.listdir(os.path.join(run, "audio")))
    assert names == sorted(f"{kind}_{i}_{step}.wav" for kind in (
        "true", "reconstruction", "transfer") for i in (0, 1)
        for step in (2, 4))


def _jax_config_json(monkeypatch, tmp_path, argv, trainer_cls):
    """The config.json the JAX package's command writes for ``argv``, its
    training skipped (``fit`` returns the state it is given)."""
    from after_tpu.cli.main import main as jax_main
    monkeypatch.setattr(trainer_cls, "fit",
                        lambda self, state, *a, **k: state)
    assert jax_main(argv) == 0
    name = argv[argv.index("--name") + 1]
    with open(tmp_path / "runs" / name / "config.json") as f:
        return f.read()


@pytest.mark.parametrize("command", ["train", "train_autoencoder"])
def test_config_json_is_the_jax_commands(monkeypatch, tmp_path, command):
    if command == "train":
        _z_store(tmp_path / "zdb")
        argv = _diff_args(tmp_path, 1, "--config", "cycle",
                          "--override", "train.steps_per_call=1")
        from after_tpu.diffusion.trainer import DiffusionTrainer as cls
    else:
        _wave_store(tmp_path / "wavedb")
        argv = _ae_args(tmp_path, 1, "--override", "z_channels=12")
        from after_tpu.autoencoder.trainer import AutoencoderTrainer as cls
    theirs = _jax_config_json(monkeypatch, tmp_path, argv, cls)
    argv[argv.index("--name") + 1] = "port"
    assert cli.main(argv + ["--device", "cpu"]) == 0
    with open(tmp_path / "runs" / "port" / "config.json") as f:
        assert f.read() == theirs


def test_logger_copies_to_the_host_once_a_flush(monkeypatch, tmp_path):
    from after_tpu_torch.utils.logging import FLUSH_EVERY, MetricsLogger
    reads = []
    for name in ("cpu", "item", "tolist", "__float__"):
        method = getattr(torch.Tensor, name)

        def counted(self, *a, _method=method, _name=name, **k):
            reads.append(_name)
            return _method(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    logger = MetricsLogger(str(tmp_path))
    for step in range(1, 2 * FLUSH_EVERY + 1):
        logger.log(step, {"loss": torch.tensor(float(step)),
                          "skipped": torch.tensor(0, dtype=torch.int32),
                          "lr": 1e-4})
        assert len(reads) == (step // FLUSH_EVERY), (step, reads)
    logger.close()
    assert reads == ["cpu", "cpu"]
    entries = _entries(str(tmp_path))
    assert [e["step"] for e in entries] == [FLUSH_EVERY, 2 * FLUSH_EVERY]
    assert entries[0]["loss"] == (FLUSH_EVERY + 1) / 2
    assert entries[1]["loss"] == (3 * FLUSH_EVERY + 1) / 2
    # the mean of FLUSH_EVERY equal floats, summed in f64
    assert entries[1]["skipped"] == 0.0
    assert entries[1]["lr"] == pytest.approx(1e-4, rel=1e-12)


def test_logger_writes_tensorboard_where_it_imports(monkeypatch, tmp_path):
    monkeypatch.delitem(sys.modules, "torch.utils.tensorboard")
    pytest.importorskip("torch.utils.tensorboard")
    from after_tpu_torch.utils.logging import FLUSH_EVERY, MetricsLogger
    logger = MetricsLogger(str(tmp_path))
    logger.log(FLUSH_EVERY, {"loss": torch.tensor(2.0)})
    logger.log_audio(1, "a/b", np.zeros(100, np.float32), 44100)
    logger.close()
    assert os.listdir(tmp_path / "logs")
    assert os.listdir(tmp_path / "audio") == ["a_b_1.wav"]


@pytest.mark.parametrize("command", ["import_dataset", "import_torch",
                                     "prepare_dataset", "update_dataset"])
def test_unported_subcommands_are_refused(command, capsys):
    # the four subcommands the dispatcher refused until dataset preparation
    # and import were ported: each now reaches its own parser
    with pytest.raises(SystemExit) as e:
        cli.main([command, "--help"])
    assert e.value.code == 0
    assert f"after-tpu-torch {command}" in capsys.readouterr().out


@pytest.mark.parametrize("command", ["train", "train_autoencoder"])
def test_usage_and_no_card(monkeypatch, command):
    assert cli.main([]) == 1
    assert cli.main(["bogus"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([command, "--name", "x", "--db_path", "nowhere"])


def test_diffusion_cli_options(tmp_path, capsys):
    """--augmentation_keys all (the store's z_aug_* buffers), a profiled
    first step, steps_per_call windows with a cadence that never fires (the
    JAX command's warning), then --data_on_device (the bank on the CPU)."""
    rng = np.random.RandomState(1)
    with RecordWriter(str(tmp_path / "zdb")) as w:
        for i in range(8):
            ae = AudioExample()
            ae.put_array("z", rng.randn(8, 120).astype(np.float32))
            ae.put_array("z_aug_0", rng.randn(8, 100).astype(np.float32))
            w.put(f"{i:08d}", ae.serialize())
    argv = _diff_args(tmp_path, 4, "--device", "cpu", "--augmentation_keys",
                      "all", "--profile_steps", "1",
                      "--override", "train.steps_per_call=2",
                      "--override", "train.steps_valid=3")
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "timbre augmentation keys: ['z_aug_0']" in out
    assert "steps_valid=3 is not a multiple of steps_per_call=2" in out
    run = tmp_path / "runs" / "r"
    assert os.listdir(run / "profile")
    assert available_steps(str(run)) == [2, 4]
    argv[argv.index("--name") + 1] = "bank"
    assert cli.main(argv + ["--data_on_device"]) == 0
    assert "device latent bank: 7 records" in capsys.readouterr().out
    assert restore_checkpoint(str(tmp_path / "runs" / "bank"))["step"] == 4
