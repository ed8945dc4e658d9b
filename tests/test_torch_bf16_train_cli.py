"""The port's training commands at bf16 on the CPU at micro size: the
micro runs of tests/test_torch_cli_train.py with ``train_autoencoder
--override train.compute_dtype=bfloat16 --override
train.stft_bf16_dft=true`` and ``train --compute_dtype bfloat16``, 2 steps
each, a checkpoint at 2, then a restart that runs a third step.  The runs
write finite metrics (the diffusion run's ``config.json`` names its compute
dtype) and f32 checkpoints: the weights, the optimizer states and the EMA the restart
reads back are the f32 masters."""

import json
import math
import sys

import pytest
import torch

from after_tpu_torch.cli import main as cli
from after_tpu_torch.utils.checkpoint import (available_steps,
                                              restore_checkpoint)
from tests.test_torch_cli_train import (_ae_args, _diff_args, _entries,
                                        _wave_store, _z_store)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _floats(tree, path=""):
    """Every floating-point tensor of a checkpoint tree, by path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _floats(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _floats(v, f"{path}/{i}")
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield path, tree


def _check_run(run):
    saved = restore_checkpoint(str(run), 2)
    floats = list(_floats(saved))
    assert floats and all(t.dtype == torch.float32 for _, t in floats), [
        p for p, t in floats if t.dtype != torch.float32]
    assert available_steps(str(run)) == [2, 3]
    assert restore_checkpoint(str(run), 3)["step"] == 3
    entries = _entries(str(run))
    assert entries
    for e in entries:
        assert all(math.isfinite(v) for v in e.values()
                   if isinstance(v, float)), e


def test_codec_command_trains_at_bf16_and_restarts(tmp_path):
    _wave_store(tmp_path / "wavedb")
    bf16 = ["--override", "train.compute_dtype=bfloat16",
            "--override", "train.stft_bf16_dft=true"]
    assert cli.main(_ae_args(tmp_path, 2, "--device", "cpu", *bf16)) == 0
    assert cli.main(_ae_args(tmp_path, 3, "--device", "cpu", "--restart",
                             "2", *bf16)) == 0
    _check_run(tmp_path / "runs" / "ae")


def test_diffusion_command_trains_at_bf16_and_restarts(tmp_path):
    _z_store(tmp_path / "zdb")
    bf16 = ["--compute_dtype", "bfloat16"]
    assert cli.main(_diff_args(tmp_path, 2, "--device", "cpu", *bf16)) == 0
    assert cli.main(_diff_args(tmp_path, 3, "--device", "cpu", "--restart",
                               "2", *bf16)) == 0
    run = tmp_path / "runs" / "r"
    with open(run / "config.json") as f:
        assert json.load(f)["train"]["compute_dtype"] == "bfloat16"
    _check_run(run)
