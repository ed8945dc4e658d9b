"""``after-tpu-torch import_torch`` without a ``config.gin`` against the
JAX command's: a reference checkpoint mapped from the geometry flags or
their defaults (5 stages, 3 blocks, GroupNorm on; 6 layers, 4 ECAPA
blocks, res2net scale 8), on synthetic reference state dicts made as
tests/test_torch_import_torch.py makes them (the JAX models' variables
drawn from a seed and written under the reference's key names), at the
default config's widths:

- a codec with flags (2 stages, 2 blocks, no GroupNorm) and with the
  defaults; a diffusion model with flags (1 layer, 3 ECAPA blocks, res2net
  scale 4) and with the defaults;
- the port's run holds exactly the tensors of the JAX command's
  ``checkpoint_0`` tree loaded into the port's modules (``utils.from_jax``;
  a codec's GroupNorm moved from the JAX import's ``gn/`` to the codec's
  ``gn/gn/``, ROADMAP C6), and its ``config.json`` is the default config
  with the flags applied, which the port's loaders read (the JAX command
  writes none without a gin);
- with a ``config.gin``, a flag that disagrees with it is refused by name,
  one that agrees is taken.
"""

import jax
import numpy as np
import pytest
import torch

from after_tpu import config as jax_config
from after_tpu.cli import main as jax_cli
from after_tpu.diffusion.trainer import DiffusionTrainer as JaxTrainer
from after_tpu.models import AudioCodec as JaxCodec
from after_tpu.utils.checkpoint import restore_checkpoint as jax_restore
from after_tpu_torch import config as port_config
from after_tpu_torch.cli import main as cli
from after_tpu_torch.cli.import_torch import build_argparser, config_of
from after_tpu_torch.diffusion.trainer import DiffusionTrainer
from after_tpu_torch.models.autoencoder import AudioCodec
from after_tpu_torch.utils.checkpoint import restore_checkpoint
from after_tpu_torch.utils.from_jax import load_module
from tests.test_torch_import_torch import (CODEC_GIN, _reference_codec,
                                           _reference_diffusion, _same_tree)
from tests.torch_diffusion_common import random_variables

CASES = {
    ("codec", "flags"): ["--n_stages", "2", "--num_blocks", "2",
                         "--use_norm", "0"],
    ("codec", "defaults"): [],
    ("diffusion", "flags"): ["--n_layers", "1", "--n_ecapa_blocks", "3",
                             "--res2net_scale", "4"],
    ("diffusion", "defaults"): [],
}


def _args(kind, flags):
    return build_argparser().parse_args(
        ["--checkpoint", "x", "--type", kind, "--out", "y", *flags])


def _group_norm_nested(tree):
    """The JAX import's codec tree with each GroupNorm under ``gn/gn``, where
    the codec holds it (C6)."""
    if not isinstance(tree, dict):
        return tree
    return {k: ({"gn": v} if k == "gn" and "scale" in v
                else _group_norm_nested(v)) for k, v in tree.items()}


def _import_both(tmp_path, kind, flags):
    """The synthetic reference checkpoint of the flags' geometry imported by
    both commands, no config.gin beside it: (port run, JAX run, config)."""
    cfg = config_of(kind, _args(kind, flags), None)
    ckpt = tmp_path / "ref" / "checkpoint.pt"
    ckpt.parent.mkdir()
    if kind == "codec":
        jcfg = jax_config.ae_from_json(port_config.ae_to_json(cfg))
        shapes = jax.eval_shape(JaxCodec(jcfg).init, jax.random.PRNGKey(0),
                                np.zeros((1, 1024, 1), np.float32))
        v = random_variables(shapes, 4)
        torch.save(_reference_codec(v["params"], len(cfg.factors),
                                    cfg.num_blocks_per_stage), str(ckpt))
    else:
        jcfg = jax_config.from_json(port_config.to_json(cfg))
        shapes = jax.eval_shape(lambda k: JaxTrainer(jcfg).rf.init(k, 2),
                                jax.random.PRNGKey(0))
        v = random_variables(shapes, 5)
        torch.save({"model_state": _reference_diffusion(
            v, cfg.denoiser.n_layers, len(cfg.encoder.channels),
            cfg.encoder.res2net_scale)}, str(ckpt))
    runs = []
    for main in (cli.main, jax_cli.main):
        out = tmp_path / ("port" if main is cli.main else "jax")
        assert main(["import_torch", "--checkpoint", str(ckpt), "--type",
                     kind, "--out", str(out), *flags]) == 0
        runs.append(str(out))
    return runs[0], runs[1], cfg, v


@pytest.mark.parametrize("kind,case", list(CASES))
def test_import_without_a_gin_matches_jax(tmp_path, kind, case):
    flags = CASES[kind, case]
    port_run, jax_run, cfg, drawn = _import_both(tmp_path, kind, flags)
    theirs = jax_restore(jax_run)
    got = restore_checkpoint(port_run)
    if kind == "codec":
        assert port_config.ae_to_json(port_config.load_codec_config(
            port_run)) == port_config.ae_to_json(cfg)
        assert len(cfg.factors) == (2 if flags else 5)
        assert cfg.use_norm == (not flags)
        via_jax = AudioCodec(cfg)
        load_module(via_jax, jax.tree_util.tree_map(
            np.asarray, _group_norm_nested(theirs["codec_vars"])), "codec")
        expected = {"codec_vars": via_jax.state_dict()}
    else:
        with open(f"{port_run}/config.json") as f:
            assert f.read() == port_config.to_json(cfg)
        assert cfg.denoiser.n_layers == (1 if flags else 6)
        _same_tree(theirs["variables"], drawn)
        expected = DiffusionTrainer(cfg, device="cpu").load_jax(
            jax.tree_util.tree_map(np.asarray, theirs["variables"]),
            jax.tree_util.tree_map(np.asarray, theirs["ema_params"])
        ).state_tree()
        expected = {"variables": expected["variables"],
                    "ema_params": {"net": expected["ema_params"]}}
        got = {"variables": got["variables"],
               "ema_params": {"net": got["ema_params"]}}
    for group, models in expected.items():
        models = models if kind == "diffusion" else {"codec": models}
        ours = got[group] if kind == "diffusion" else {"codec": got[group]}
        for name, sd in models.items():
            assert set(ours[name]) == set(sd), (group, name)
            for k, t in sd.items():
                torch.testing.assert_close(ours[name][k], t, rtol=0, atol=0)


def test_a_flag_that_disagrees_with_the_gin_is_refused(tmp_path):
    (tmp_path / "config.gin").write_text(CODEC_GIN)
    gin = str(tmp_path / "config.gin")
    assert len(config_of("codec", _args("codec", ["--n_stages", "2"]),
                         gin).factors) == 2
    with pytest.raises(SystemExit, match="--n_stages 3 disagrees"):
        config_of("codec", _args("codec", ["--n_stages", "3"]), gin)
    with pytest.raises(SystemExit, match="--use_norm True disagrees"):
        config_of("codec", _args("codec", ["--use_norm", "1"]), gin)
